"""Shared AST helpers: import-alias resolution and literal extraction.

Rules match calls by *canonical dotted name* (`jax.random.split`,
`metrics.counter`, ...) regardless of how the module spelled the import —
``import jax``, ``import jax.random as jr``, ``from jax import random``
and ``from jax.random import split as sp`` all resolve to the same
canonical names through :func:`import_aliases` + :func:`qualname`.
"""

from __future__ import annotations

import ast
from typing import Optional


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local name -> canonical dotted prefix, from top-level imports."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def qualname(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a Name/Attribute chain, or None.

    Unknown roots keep their spelled name (`self._call` stays
    `self._call`), so suffix matching still works for method calls.
    """
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    root = aliases.get(cur.id, cur.id)
    parts.append(root)
    return ".".join(reversed(parts))


def const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = const_int(node.operand)
        return -inner if inner is not None else None
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_tuple(node: ast.AST) -> Optional[tuple[str, ...]]:
    """A tuple/list of string literals, or None if anything else."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for elt in node.elts:
        s = const_str(elt)
        if s is None:
            return None
        out.append(s)
    return tuple(out)


def int_tuple(node: ast.AST) -> Optional[tuple[int, ...]]:
    """An int literal or tuple/list of int literals, or None."""
    single = const_int(node)
    if single is not None:
        return (single,)
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for elt in node.elts:
        v = const_int(elt)
        if v is None:
            return None
        out.append(v)
    return tuple(out)


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def target_names(target: ast.AST) -> list[str]:
    """Assignment-target ids, flattening tuples; dotted for attributes."""
    out: list[str] = []
    if isinstance(target, ast.Name):
        out.append(target.id)
    elif isinstance(target, ast.Attribute):
        q = _dotted(target)
        if q:
            out.append(q)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out.extend(target_names(elt))
    elif isinstance(target, ast.Starred):
        out.extend(target_names(target.value))
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


def expr_id(node: ast.AST) -> Optional[str]:
    """Stable id for a key expression: names, dotted attributes, and
    constant-index subscripts (`ks[0]`). Dynamic subscripts (`keys[i]`)
    return None — per-iteration indexing is exactly the healthy pattern,
    so they are not tracked."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return _dotted(node)
    if isinstance(node, ast.Subscript):
        base = expr_id(node.value)
        idx = const_int(node.slice)
        if base is not None and idx is not None:
            return f"{base}[{idx}]"
    return None
