"""vedalint engine for the port: file walking, suppressions, rule dispatch.

The analyzer is a thin deterministic pass over the port's own sources — no
imports of the analyzed code, no runtime, so it is safe to run on any tree
(including one that would fail at import time; syntax errors become
findings of the pseudo-rule ``parse-error``). It is a host tool: it reads
files and touches no device.

Two kinds of source:

  * Python modules (`Module`), parsed with `ast`;
  * CUDA sources (`CudaSource`, ``*.cu``/``*.cuh``), kept as text with
    their comments and string literals blanked (`CudaSource.code`), which
    the CUDA rules scan; there is no C++ parser here.

Three rule hooks:

  * per-module rules (`Rule.check_module`) see one parsed Python file at a
    time (generator hygiene, the w_bits branch ban);
  * CUDA rules (`Rule.check_cuda`) see one CUDA source at a time (the
    shared-memory budget);
  * project rules (`Rule.check_project`) see every parsed Python module at
    once (protocol conformance, metric declaration consistency, cache-key
    hashability) — the checks that exist precisely because no single file
    can see the contract.

Suppressions are inline comments::

    x = thing()  # vedalint: disable=rule-id -- why this one is fine
    # vedalint: disable=rule-id,other-rule -- standalone form
    x = thing()

and in a CUDA source the same after ``//``::

    kern<<<grid, 256, bytes, st>>>(a);  // vedalint: disable=rule-id -- why
    // vedalint: disable=rule-id -- standalone form
    kern<<<grid, 256, bytes, st>>>(a);

An inline comment suppresses matching findings on its own line (in Python,
its logical line); a standalone comment line suppresses them on the next
line (in Python the next logical line; in CUDA the next statement, up to
the line that holds its ``;`` or ``{``). The justification after ``--`` is
required by convention (CI diffs are the enforcement: a bare disable is
easy to spot in review) but not parsed.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import tokenize
from pathlib import Path
from typing import Iterable, Optional, Sequence, Union

#: Findings of this pseudo-rule cannot be produced by real rules and are
#: never suppressible — a file that does not parse analyzes as nothing.
PARSE_ERROR = "parse-error"

CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, which rule, what, and how to fix it."""

    rule: str
    path: str  # posix relative path, stable across machines
    line: int
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int  # where the comment sits
    rules: tuple[str, ...]  # ("*",) for a blanket disable
    first: int  # first covered source line
    last: int  # last covered source line

    def covers(self, rule: str, line: int) -> bool:
        return self.first <= line <= self.last \
            and ("*" in self.rules or rule in self.rules)


def _disabled_rules(comment: str) -> Optional[tuple[str, ...]]:
    """The rule ids of a `vedalint: disable=` comment body, or None."""
    text = comment.strip()
    if not text.startswith("vedalint:"):
        return None
    directive = text[len("vedalint:"):].strip()
    if not directive.startswith("disable="):
        return None
    spec = directive[len("disable="):].split("--", 1)[0].strip()
    rules = tuple(r.strip() for r in spec.split(",") if r.strip())
    return rules or None


class Module:
    """One parsed Python source file plus its suppression comments."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"
        self.suppressions = _parse_suppressions(source)

    def suppressed(self, rule: str, line: int) -> bool:
        return any(s.covers(rule, line) for s in self.suppressions)


class CudaSource:
    """One CUDA source file: its text, the text with comments and string
    literals blanked to spaces (newlines kept, so offsets and line numbers
    agree), and its ``//`` suppression comments."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.parse_error: Optional[str] = None
        self.code, comments = _blank_cuda(source)
        self.suppressions = _cuda_suppressions(self.code, comments)

    def line_of(self, offset: int) -> int:
        return self.code.count("\n", 0, offset) + 1

    def suppressed(self, rule: str, line: int) -> bool:
        return any(s.covers(rule, line) for s in self.suppressions)


Source = Union[Module, CudaSource]


def _blank_cuda(source: str) -> tuple[str, list[tuple[int, str, bool]]]:
    """Blank comments and string/char literals; returns (code, the line
    comments as (line, body, standalone?))."""
    out = list(source)
    comments: list[tuple[int, str, bool]] = []
    i, n, line = 0, len(source), 1
    line_start = 0
    while i < n:
        c = source[i]
        if c == "\n":
            line += 1
            line_start = i + 1
            i += 1
        elif source.startswith("//", i):
            end = source.find("\n", i)
            end = n if end < 0 else end
            standalone = not source[line_start:i].strip()
            comments.append((line, source[i + 2:end], standalone))
            for j in range(i, end):
                out[j] = " "
            i = end
        elif source.startswith("/*", i):
            end = source.find("*/", i + 2)
            end = n if end < 0 else end + 2
            for j in range(i, end):
                if source[j] == "\n":
                    line += 1
                    line_start = j + 1
                else:
                    out[j] = " "
            i = end
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            for k in range(i + 1, min(j, n)):
                out[k] = " "
            i = j + 1
        else:
            i += 1
    return "".join(out), comments


def _cuda_suppressions(code: str, comments) -> list[Suppression]:
    lines = code.splitlines()
    out = []
    for cline, body, standalone in comments:
        rules = _disabled_rules(body)
        if rules is None:
            continue
        if not standalone:
            out.append(Suppression(cline, rules, cline, cline))
            continue
        first = next((i for i in range(cline + 1, len(lines) + 1)
                      if lines[i - 1].strip()), cline + 1)
        last = next((i for i in range(first, len(lines) + 1)
                     if ";" in lines[i - 1] or "{" in lines[i - 1]), first)
        out.append(Suppression(cline, rules, first, last))
    return out


def _parse_suppressions(source: str) -> list[Suppression]:
    """A suppression comment covers one *logical* line: the one it sits
    on (inline form) or the next one (standalone form) — so a wrapped
    call is covered whichever physical line the finding anchors to, and
    the `--` justification may spill onto following comment lines."""
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return []

    # Logical-line spans: runs of real tokens closed by a NEWLINE token.
    spans: list[tuple[int, int]] = []
    start: Optional[int] = None
    last_line = 1
    skip = (tokenize.COMMENT, tokenize.NL, tokenize.INDENT,
            tokenize.DEDENT, tokenize.ENDMARKER)
    for tok in tokens:
        last_line = max(last_line, tok.end[0])
        if tok.type == tokenize.NEWLINE:
            if start is not None:
                spans.append((start, tok.end[0]))
                start = None
        elif tok.type not in skip and start is None:
            start = tok.start[0]
    if start is not None:
        spans.append((start, last_line))

    out = []
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        rules = _disabled_rules(tok.string.lstrip("#"))
        if rules is None:
            continue
        cline = tok.start[0]
        standalone = lines[cline - 1].lstrip().startswith("#")
        if standalone:
            covered = next(((a, b) for a, b in spans if a > cline),
                           (cline + 1, cline + 1))
        else:
            covered = next(((a, b) for a, b in spans if a <= cline <= b),
                           (cline, cline))
        out.append(Suppression(cline, rules, covered[0], covered[1]))
    return out


@dataclasses.dataclass
class AnalysisConfig:
    """Knobs a CLI flag can turn; rules read, never mutate."""

    #: quant-branch-ban: relpath suffixes where `.w_bits is not None`
    #: dispatch is the point (the codec owns the storage-format branch).
    quant_allowed: tuple[str, ...] = ("core/quant.py", "core/codec.py")
    #: Subset of rule ids to run (None = all registered rules).
    rules: Optional[frozenset[str]] = None
    #: cuda-smem-budget: H100 — dynamic shared memory a block may take
    #: without `cudaFuncAttributeMaxDynamicSharedMemorySize`, and static
    #: `__shared__` bytes a block may declare (48 KB).
    smem_default_bytes: int = 49152
    #: H100: the most a block can opt into (227 KB of the SM's 256 KB).
    smem_optin_bytes: int = 232448
    #: H100: threads a warp; a block's size should be a multiple of it.
    warp_size: int = 32
    #: H100: threads a block at most.
    max_block_threads: int = 1024
    #: Name -> assumed value for `__shared__` dims (or element types) the
    #: scanner cannot resolve (template parameters); anything else takes
    #: `smem_assume_default` (an extent, or 4 bytes for a type).
    smem_assume: dict = dataclasses.field(default_factory=dict)
    smem_assume_default: int = 128


class Rule:
    """Base class; subclasses set `id`, `summary` and override one hook."""

    id: str = ""
    summary: str = ""

    def check_module(self, _module: Module,
                     _config: AnalysisConfig) -> Iterable[Finding]:
        return ()

    def check_cuda(self, _source: CudaSource,
                   _config: AnalysisConfig) -> Iterable[Finding]:
        return ()

    def check_project(self, _modules: Sequence[Module],
                      _config: AnalysisConfig) -> Iterable[Finding]:
        return ()


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    suppressed: list[Finding]
    files_checked: int

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "version": 1,
            "tool": "vedalint",
            "files_checked": self.files_checked,
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }

    def render_text(self) -> str:
        lines = [f.format() for f in self.findings]
        total = len(self.findings)
        lines.append(
            f"vedalint: {total} finding{'s' if total != 1 else ''} "
            f"({len(self.suppressed)} suppressed) "
            f"across {self.files_checked} files")
        return "\n".join(lines)


def collect_files(paths: Sequence[str | Path],
                  root: Optional[Path] = None) -> list[tuple[Path, str]]:
    """Expand files/directories into (abspath, posix relpath) pairs: Python
    files and CUDA sources."""
    root = Path(root) if root is not None else Path.cwd()
    seen: set[Path] = set()
    out: list[tuple[Path, str]] = []
    suffixes = (".py", *CUDA_SUFFIXES)

    def add(p: Path) -> None:
        rp = p.resolve()
        if rp in seen:
            return
        seen.add(rp)
        try:
            rel = rp.relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.as_posix()
        out.append((rp, rel))

    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(f for f in p.rglob("*") if f.suffix in suffixes):
                if "__pycache__" in f.parts:
                    continue
                add(f)
        elif p.suffix in suffixes:
            add(p)
    return out


def load_modules(paths: Sequence[str | Path],
                 root: Optional[Path] = None) -> list[Source]:
    mods: list[Source] = []
    for abspath, rel in collect_files(paths, root=root):
        cls = CudaSource if abspath.suffix in CUDA_SUFFIXES else Module
        try:
            source = abspath.read_text(encoding="utf-8")
        except OSError as e:  # unreadable file: surface, don't crash
            m = cls.__new__(cls)
            m.path, m.relpath, m.source = abspath, rel, ""
            m.tree, m.parse_error, m.suppressions = None, str(e), []
            mods.append(m)
            continue
        mods.append(cls(abspath, rel, source))
    return mods


def analyze(modules: Sequence[Source], rules: Sequence[Rule],
            config: Optional[AnalysisConfig] = None) -> Report:
    config = config or AnalysisConfig()
    active = [r for r in rules
              if config.rules is None or r.id in config.rules]
    raw: list[Finding] = []
    for mod in modules:
        if mod.parse_error is not None:
            raw.append(Finding(PARSE_ERROR, mod.relpath, 1,
                               f"file does not parse: {mod.parse_error}"))
            continue
        for rule in active:
            if isinstance(mod, CudaSource):
                raw.extend(rule.check_cuda(mod, config))
            else:
                raw.extend(rule.check_module(mod, config))
    parsed = [m for m in modules
              if isinstance(m, Module) and m.tree is not None]
    for rule in active:
        raw.extend(rule.check_project(parsed, config))

    by_path = {m.relpath: m for m in modules}
    findings, suppressed = [], []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        mod = by_path.get(f.path)
        if mod is not None and f.rule != PARSE_ERROR \
                and mod.suppressed(f.rule, f.line):
            suppressed.append(f)
        else:
            findings.append(f)
    return Report(findings, suppressed, files_checked=len(modules))


def analyze_paths(paths: Sequence[str | Path],
                  config: Optional[AnalysisConfig] = None,
                  root: Optional[Path] = None,
                  rules: Optional[Sequence[Rule]] = None) -> Report:
    """One-call entry point: walk, parse, run every registered rule."""
    from repro_torch.analysis.rules import all_rules

    return analyze(load_modules(paths, root=root),
                   list(rules) if rules is not None else all_rules(),
                   config)


def write_json(report: Report, path: str | Path) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(report.to_json(), indent=2, sort_keys=True)
                 + "\n", encoding="utf-8")
