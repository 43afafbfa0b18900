"""cache-args-hashable: a cached function's arguments must be hashable and
frozen.

The port keeps its per-shape state in `functools.lru_cache` /
`functools.cache` functions: the loaded kernel libraries, the workspace
sizes a shape takes, the split a decode shape runs with. Every argument of
such a function is hashed into the cache key. A non-frozen dataclass
(`__hash__` is None when `eq=True`), a dict, list or set there raises
`TypeError: unhashable type` at the first call — or worse, a *mutable but
hashable* object keys an entry that goes stale when the object changes
(the counterpart of the reference's jit-static-hashable contract, where
every config in `static_argnums` is a frozen dataclass).

Checked per cached function, using a project-wide index of dataclass
definitions:

  * a parameter annotated with a non-frozen project dataclass;
  * a parameter annotated `dict`/`list`/`set` (incl. `typing.` and
    `Optional[...]` forms);
  * a parameter whose *default value* is a mutable literal.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, Rule

_CACHE_NAMES = {"functools.lru_cache", "lru_cache", "functools.cache",
                "cache"}
_UNHASHABLE_ANNOTATIONS = {
    "dict", "list", "set", "Dict", "List", "Set", "typing.Dict",
    "typing.List", "typing.Set", "defaultdict", "collections.defaultdict",
}
_HINT = ("make the class a frozen dataclass (`@dataclass(frozen=True)`) "
         "or pass its hashable fields instead")


def _annotation_names(node: ast.AST) -> list[str]:
    """Base type names mentioned by an annotation, unwrapping Optional/
    Union subscripts and string annotations."""
    if node is None:
        return []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return []
    if isinstance(node, ast.Subscript):
        outer = _annotation_names(node.value)
        if outer and outer[0].split(".")[-1] in ("Optional", "Union"):
            inner = node.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            out = []
            for e in elts:
                out.extend(_annotation_names(e))
            return out
        return outer
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_names(node.left) + _annotation_names(node.right)
    if isinstance(node, (ast.Name, ast.Attribute)):
        q = astutil.qualname(node, {})
        return [q] if q else []
    return []


def _dataclass_index(modules) -> dict[str, tuple[bool, str, int]]:
    """Class name -> (frozen?, relpath, line) for every @dataclass."""
    index: dict[str, tuple[bool, str, int]] = {}
    for mod in modules:
        aliases = astutil.import_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                call = dec if isinstance(dec, ast.Call) else None
                target = call.func if call else dec
                q = astutil.qualname(target, aliases)
                if q not in ("dataclasses.dataclass", "dataclass"):
                    continue
                frozen = False
                if call is not None:
                    kw = astutil.keyword_arg(call, "frozen")
                    frozen = isinstance(kw, ast.Constant) \
                        and kw.value is True
                index[node.name] = (frozen, mod.relpath, node.lineno)
    return index


def _is_cached(dec: ast.AST, aliases) -> bool:
    """`@lru_cache`, `@lru_cache(maxsize=...)`, `@cache`, by any import
    spelling."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    return astutil.qualname(target, aliases) in _CACHE_NAMES


class CacheArgsHashable(Rule):
    id = "cache-args-hashable"
    summary = ("arguments of functools.lru_cache/cache functions (the "
               "cache key) must be frozen dataclasses or hashable values")

    def check_project(self, modules, _config):
        dc_index = _dataclass_index(modules)
        findings: list[Finding] = []
        for mod in modules:
            aliases = astutil.import_aliases(mod.tree)
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and any(_is_cached(d, aliases)
                                for d in node.decorator_list):
                    findings.extend(self._check_fn(mod, node, dc_index))
        return findings

    def _check_fn(self, mod, fn, dc_index):
        findings = []
        pos_params = fn.args.posonlyargs + fn.args.args
        defaults = dict(zip(
            [a.arg for a in pos_params[len(pos_params)
                                       - len(fn.args.defaults):]],
            fn.args.defaults))
        defaults.update({a.arg: d for a, d in
                         zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                         if d is not None})
        for p in pos_params + fn.args.kwonlyargs:
            for ann in _annotation_names(p.annotation):
                base = ann.split(".")[-1]
                if ann in _UNHASHABLE_ANNOTATIONS:
                    findings.append(Finding(
                        self.id, mod.relpath, p.lineno,
                        f"cached argument '{p.arg}' of `{fn.name}` is "
                        f"annotated {ann}: unhashable, the first call "
                        f"raises (and mutation would poison the cache)",
                        hint="pass a tuple/frozen structure, or take the "
                             "argument out of the cached function"))
                elif base in dc_index and not dc_index[base][0]:
                    _, dc_path, dc_line = dc_index[base]
                    findings.append(Finding(
                        self.id, mod.relpath, p.lineno,
                        f"cached argument '{p.arg}' of `{fn.name}` is "
                        f"annotated {base}, a non-frozen dataclass "
                        f"({dc_path}:{dc_line}): unhashable as a cache key",
                        hint=_HINT))
            default = defaults.get(p.arg)
            if isinstance(default, (ast.Dict, ast.List, ast.Set,
                                    ast.ListComp, ast.DictComp,
                                    ast.SetComp)):
                findings.append(Finding(
                    self.id, mod.relpath, p.lineno,
                    f"cached argument '{p.arg}' of `{fn.name}` defaults to "
                    f"a mutable literal: unhashable as a cache key",
                    hint="use a tuple or None sentinel"))
        return findings
