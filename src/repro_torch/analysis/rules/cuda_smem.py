"""cuda-smem-budget: a kernel's shared memory must fit the card, and a
block's threads must fill whole warps.

On an H100 a block may take at most 48 KB (49,152 B) of shared memory
unless its kernel was opted in with `cudaFuncSetAttribute(kernel,
cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)`; then up to 227 KB
(232,448 B), and only as dynamic shared memory. A launch that asks for
more than the kernel's limit is refused — it never runs, and only the
`cudaGetLastError()` right after it says so — so a shape that needs more
than 48 KB fails at run time on the first input large enough, however
long the smaller shapes have run. This rule is the analysis-time guard
(the counterpart of the reference's VMEM tile budget), over the text of
the port's `.cu` sources:

  * (a) a `<<<grid, block, smem, stream>>>` launch whose dynamic size is
    not a constant expression of at most 48 KB, when the function around
    it never opts the launched kernel in — directly, or by passing it to a
    helper that calls `cudaFuncSetAttribute` on its parameter (`opt_in`);
  * (b) an opt-in above 232,448 B, which the card refuses;
  * (c) a kernel whose static `__shared__` arrays take more than 48 KB
    (static shared memory cannot be opted in);
  * (d) a constant block size that is not a multiple of the 32-thread warp
    or exceeds 1,024 threads (the counterpart of the lane check).

It is a scanner, not a C++ parser: comments and strings are blanked,
`#define` heads dropped (macro bodies are scanned where they stand),
functions are found by their brace structure, and values resolve from
integer literals, `sizeof` of scalar types and `constexpr`/`const`
integers of file scope or of the function. A static `__shared__` dimension or element
type that does not resolve (a template parameter) takes
`AnalysisConfig.smem_assume` (`--smem-assume NAME=N`), else
`smem_assume_default` (4 bytes for a type); such kernels are marked as
assumed in the message. Launch names resolve through `auto k = kernel<...>;`
aliases, so a launch of `k` is opted in by `opt_in(kernel<...>)` and the
other way round.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

from repro_torch.analysis.engine import AnalysisConfig, CudaSource, Finding, Rule

_INT_TYPES = r"(?:unsigned\s+|signed\s+)?(?:long\s+long|long|int|short|char|size_t|" \
             r"u?int(?:8|16|32|64)_t|unsigned)(?:\s+int)?"
_CONSTEXPR = re.compile(
    r"\b(?:static\s+)?(?:inline\s+)?(?:constexpr|const)\s+(?:const\s+)?" + _INT_TYPES
    + r"\s+([A-Za-z_]\w*)\s*=\s*([^;{}]+);")
_IDENT = re.compile(r"[A-Za-z_]\w*")

#: Bytes of the element types a `__shared__` array or `sizeof` may name.
TYPE_BYTES = {
    "char": 1, "signed char": 1, "unsigned char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1,
    "short": 2, "unsigned short": 2, "int16_t": 2, "uint16_t": 2, "half": 2, "__half": 2,
    "__nv_bfloat16": 2, "nv_bfloat16": 2, "__half2": 4, "__nv_bfloat162": 4,
    "int": 4, "unsigned": 4, "unsigned int": 4, "float": 4, "int32_t": 4, "uint32_t": 4,
    "long": 8, "unsigned long": 8, "long long": 8, "unsigned long long": 8, "double": 8,
    "int64_t": 8, "uint64_t": 8, "size_t": 8, "float2": 8, "int2": 8, "uint2": 8,
    "float4": 16, "int4": 16, "uint4": 16, "double2": 16,
}
_OPT_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize"


def _blank_preprocessor(code: str) -> str:
    """Blank `#include`/`#if`/... lines and `#define NAME(args)` heads (a
    macro's body stays, to be scanned where it stands) and the line
    continuations; every line keeps its length, so offsets agree."""
    lines = code.split("\n")
    i = 0
    while i < len(lines):
        if not lines[i].lstrip().startswith("#"):
            i += 1
            continue
        define = re.match(r"\s*#\s*define\s+[A-Za-z_]\w*(\([^)]*\))?", lines[i])
        j = i
        while True:
            line = lines[j]
            cont = line.rstrip().endswith("\\")
            if define is None:
                line = " " * len(line)
            else:
                if j == i:
                    line = " " * define.end() + line[define.end():]
                if cont:
                    at = line.rstrip().rfind("\\")
                    line = line[:at] + " " + line[at + 1:]
            lines[j] = line
            if not cont or j + 1 == len(lines):
                break
            j += 1
        i = j + 1
    return "\n".join(lines)


def _split_top(text: str) -> list[str]:
    """Split at commas outside (), [] and {}."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [s.strip() for s in out]


def _match_back(text: str, close: int, open_ch: str, close_ch: str) -> int:
    depth = 0
    for i in range(close, -1, -1):
        if text[i] == close_ch:
            depth += 1
        elif text[i] == open_ch:
            depth -= 1
            if depth == 0:
                return i
    return -1


def _match_fwd(text: str, open_: int, open_ch: str, close_ch: str) -> int:
    depth = 0
    for i in range(open_, len(text)):
        if text[i] == open_ch:
            depth += 1
        elif text[i] == close_ch:
            depth -= 1
            if depth == 0:
                return i
    return len(text) - 1


def _strip_templates(text: str) -> str:
    """Remove balanced `<...>` template argument lists."""
    prev = None
    while prev != text:
        prev = text
        text = re.sub(r"<[^<>]*>", "", text)
    return text


def base_name(expr: str) -> Optional[str]:
    """The function a kernel expression names: `kern`,
    `kernel<T, 4>`, `reinterpret_cast<const void*>(&ns::kernel<T>)`."""
    expr = re.sub(r"\b(?:static|reinterpret|const)_cast\b", "", expr)
    expr = re.sub(r"\(\s*(?:const\s+)?void\s*\*\s*\)", "", _strip_templates(expr))
    names = _IDENT.findall(expr.replace("::", " "))
    names = [n for n in names if n not in ("const", "void")]
    return names[-1] if names else None


class _Unresolved(Exception):
    pass


def _c_to_python(expr: str) -> str:
    expr = re.sub(r"\b(?:static|reinterpret)_cast\s*<[^<>]*>", "", expr)
    expr = re.sub(r"\(\s*" + _INT_TYPES + r"\s*\)", "", expr)

    def size_of(m):
        t = " ".join(m.group(1).split())
        if t not in TYPE_BYTES:
            raise _Unresolved(t)
        return str(TYPE_BYTES[t])

    expr = re.sub(r"\bsizeof\s*\(\s*([A-Za-z_][\w\s]*?)\s*\)", size_of, expr)
    expr = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)(?:[uU]?[lL]{0,2}|[lL]{1,2}[uU])\b", r"\1",
                  expr)
    if re.search(r"&&|\|\||[?:!]|\.\d|\d\.", expr):
        raise _Unresolved(expr)
    return expr.replace("/", "//")


_BIN = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
        ast.Mult: lambda a, b: a * b,
        ast.FloorDiv: lambda a, b: abs(a) // abs(b) * (1 if (a >= 0) == (b > 0) else -1),
        ast.Mod: lambda a, b: a % b, ast.LShift: lambda a, b: a << b,
        ast.RShift: lambda a, b: a >> b, ast.BitOr: lambda a, b: a | b,
        ast.BitAnd: lambda a, b: a & b, ast.BitXor: lambda a, b: a ^ b}


def evaluate(expr: str, env: dict, assume: Optional[dict] = None,
             default: Optional[int] = None) -> tuple[Optional[int], list[str]]:
    """(value, the names it assumed) of a C integer expression; value None
    when it does not resolve. Names resolve from `env`, then — when
    `assume`/`default` are given — from `assume`, then `default`."""
    assumed: list[str] = []

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if assume is not None and node.id in assume:
                assumed.append(node.id)
                return assume[node.id]
            if default is not None:
                assumed.append(node.id)
                return default
            raise _Unresolved(node.id)
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN:
            right = ev(node.right)
            if right == 0 and isinstance(node.op, (ast.FloorDiv, ast.Mod)):
                raise _Unresolved("division by zero")
            return _BIN[type(node.op)](ev(node.left), right)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd,
                                                                   ast.Invert)):
            v = ev(node.operand)
            return -v if isinstance(node.op, ast.USub) else (~v if isinstance(
                node.op, ast.Invert) else v)
        raise _Unresolved(type(node).__name__)

    try:
        tree = ast.parse(_c_to_python(expr.strip()), mode="eval")
        return ev(tree), assumed
    except (_Unresolved, SyntaxError, ValueError, RecursionError):
        return None, assumed


def _constants(text: str, env: dict) -> dict:
    """`constexpr`/`const` integers of `text` that resolve over `env`, in
    order (a later one may use an earlier one)."""
    out = dict(env)
    for m in _CONSTEXPR.finditer(text):
        v, _ = evaluate(m.group(2), out)
        if v is not None:
            out[m.group(1)] = v
    return out


@dataclasses.dataclass
class Function:
    name: str
    is_global: bool
    params: list[str]
    name_at: int  # offset of the name
    body: tuple[int, int]  # offsets of `{` and `}`


@dataclasses.dataclass
class Launch:
    kernel: str  # the spelled name (an alias resolves through `aliases`)
    at: int  # offset of `<<<`
    args: list[str]


class Scan:
    """One CUDA source, scanned: its functions, file-scope constants and,
    per function, launches, opt-ins and `auto` kernel aliases."""

    def __init__(self, source: CudaSource):
        self.code = _blank_preprocessor(source.code)
        self.functions = self._functions()
        self.consts = _constants(self._file_scope_text(), {})

    # -- structure ---------------------------------------------------------

    def _functions(self) -> list[Function]:
        code, out = self.code, []
        i = 0
        stack: list[str] = []
        while i < len(code):
            ch = code[i]
            if ch == "{":
                before = code[max(0, i - 400):i].rstrip()
                kind = "block"
                if re.search(r"(\bnamespace(\s+\w+)?|\bextern\s*\"\s*\")$", before):
                    kind = "ns"
                elif all(k == "ns" for k in stack):
                    fn = self._function_at(i)
                    if fn is not None:
                        out.append(fn)
                        i = fn.body[1] + 1
                        continue
                stack.append(kind)
            elif ch == "}" and stack:
                stack.pop()
            i += 1
        return out

    def _function_at(self, brace: int) -> Optional[Function]:
        code = self.code
        close = brace - 1
        while close >= 0:  # back over whitespace and trailing qualifiers
            if code[close].isspace():
                close -= 1
                continue
            word = re.search(r"\b(const|noexcept|override|final)$", code[max(0, close - 9):close + 1])
            if word is None:
                break
            close -= len(word.group(1))
        if close < 0 or code[close] != ")":
            return None
        open_ = _match_back(code, close, "(", ")")
        if open_ < 0:
            return None
        lo = max(0, open_ - 200)
        m = re.search(r"([A-Za-z_]\w*)\s*$", code[lo:open_])
        if m is None or m.group(1) in ("if", "for", "while", "switch", "catch",
                                       "__launch_bounds__", "sizeof"):
            return None
        name_at = lo + m.start(1)
        start = max(code.rfind(c, 0, name_at) for c in ";{}")
        header = code[start + 1:name_at]
        params = []
        for p in _split_top(_strip_templates(code[open_ + 1:close])):
            names = _IDENT.findall(p.split("=")[0])
            if names and names[-1] != "void":
                params.append(names[-1])
        end = _match_fwd(code, brace, "{", "}")
        return Function(m.group(1), "__global__" in header, params, name_at, (brace, end))

    def _file_scope_text(self) -> str:
        chars = list(self.code)
        for fn in self.functions:
            for j in range(fn.body[0], fn.body[1] + 1):
                if chars[j] != "\n":
                    chars[j] = " "
        return "".join(chars)

    # -- per function ------------------------------------------------------

    def body(self, fn: Function) -> str:
        return self.code[fn.body[0]:fn.body[1] + 1]

    def local_consts(self, fn: Function) -> dict:
        return _constants(self.body(fn), self.consts)

    def aliases(self, fn: Function) -> dict[str, str]:
        out = {}
        for m in re.finditer(r"\bauto\s*\*?\s*(?:const\s+)?([A-Za-z_]\w*)\s*=\s*&?\s*"
                             r"([A-Za-z_][\w:]*\s*(?:<[^;]*>)?)\s*;", self.body(fn)):
            base = base_name(m.group(2))
            if base:
                out[m.group(1)] = base
        return out

    def launches(self, fn: Function) -> list[Launch]:
        code, out = self.code, []
        lo, hi = fn.body
        at = code.find("<<<", lo, hi)
        while at >= 0:
            end = code.find(">>>", at, hi)
            if end < 0:
                break
            j = at - 1
            while j > lo and code[j].isspace():
                j -= 1
            if code[j] == ">":
                j = _match_back(code, j, "<", ">") - 1
                while j > lo and code[j].isspace():
                    j -= 1
            m = re.search(r"([A-Za-z_][\w:]*)$", code[max(lo, j - 200):j + 1])
            if m is not None:
                out.append(Launch(m.group(1).split("::")[-1], at,
                                  _split_top(code[at + 3:end])))
            at = code.find("<<<", end, hi)
        return out

    def calls(self, fn: Function, name: str) -> list[tuple[int, list[str]]]:
        """(offset, arguments) of each call `name(...)` in the body."""
        code, out = self.code, []
        lo, hi = fn.body
        for m in re.finditer(r"\b" + re.escape(name) + r"\s*\(", code[lo:hi]):
            open_ = lo + m.end() - 1
            close = _match_fwd(code, open_, "(", ")")
            out.append((lo + m.start(), _split_top(code[open_ + 1:close])))
        return out

    def opt_ins(self, fn: Function) -> list[tuple[int, str, str]]:
        """(offset, target expression, bytes expression) of each direct
        `cudaFuncSetAttribute(target, MaxDynamicSharedMemorySize, bytes)`."""
        return [(at, args[0], args[2]) for at, args in self.calls(fn, "cudaFuncSetAttribute")
                if len(args) >= 3 and _OPT_ATTR in args[1]]

    def helpers(self) -> dict[str, int]:
        """Functions that opt their own parameter in: name -> its index."""
        out = {}
        for fn in self.functions:
            for _, target, _ in self.opt_ins(fn):
                base = base_name(target)
                if base in fn.params:
                    out[fn.name] = fn.params.index(base)
        return out

    def opted(self, fn: Function, helpers: dict[str, int]) -> set[str]:
        """Kernel names the function opts in, aliases resolved."""
        alias = self.aliases(fn)
        names = {base_name(t) for _, t, _ in self.opt_ins(fn)}
        for helper, index in helpers.items():
            names |= {base_name(args[index]) for _, args in self.calls(fn, helper)
                      if len(args) > index}
        names.discard(None)
        return names | {alias[n] for n in names if n in alias}


def static_smem(source: CudaSource, config: Optional[AnalysisConfig] = None,
                scan: Optional[Scan] = None) -> dict[str, dict]:
    """Each `__global__` kernel's static `__shared__` bytes: name ->
    {"bytes", "assumed" (the names that took an assumed value), "line"}."""
    config = config or AnalysisConfig()
    scan = scan or Scan(source)
    out = {}
    for fn in scan.functions:
        if not fn.is_global:
            continue
        env = scan.local_consts(fn)
        total, assumed = 0, []
        body = scan.body(fn)
        for m in re.finditer(r"\b__shared__\b", body):
            stmt_lo = max(body.rfind(c, 0, m.start()) for c in ";{}") + 1
            if "extern" in body[stmt_lo:m.start()]:
                continue
            end = body.find(";", m.end())
            decl = body[m.end():end]
            decl = re.sub(r"\b(__align__|alignas)\s*\([^)]*\)", " ", decl)
            decl = re.sub(r"\b(volatile|static|const)\b", " ", decl)
            parts = _split_top(decl)
            first = re.match(r"\s*(.*?)\s*([A-Za-z_]\w*)\s*((?:\[[^\]]*\]\s*)*)$", parts[0])
            if first is None:
                continue
            type_name = " ".join(first.group(1).split())
            size = TYPE_BYTES.get(type_name)
            if size is None:
                size = config.smem_assume.get(type_name, 4)
                assumed.append(type_name)
            decls = [(first.group(2), first.group(3))]
            for p in parts[1:]:
                d = re.match(r"\s*([A-Za-z_]\w*)\s*((?:\[[^\]]*\]\s*)*)$", p)
                if d:
                    decls.append((d.group(1), d.group(2)))
            for _, dims in decls:
                count = 1
                for dim in re.findall(r"\[([^\]]*)\]", dims):
                    v, names = evaluate(dim, env, config.smem_assume,
                                        config.smem_assume_default)
                    assumed += names
                    count *= v if v is not None else config.smem_assume_default
                total += count * size
        out[fn.name] = {"bytes": total, "assumed": sorted(set(assumed)),
                        "line": source.line_of(fn.name_at)}
    return out


def _block_threads(expr: str, env: dict) -> Optional[int]:
    m = re.match(r"\s*dim3\s*\((.*)\)\s*$", expr, re.S)
    parts = _split_top(m.group(1)) if m else [expr]
    total = 1
    for p in parts:
        v, _ = evaluate(p, env)
        if v is None:
            return None
        total *= v
    return total


class CudaSmemBudget(Rule):
    id = "cuda-smem-budget"
    summary = ("a launch over 48 KB of dynamic shared memory needs its kernel "
               "opted in (at most 227 KB); static shared memory at most 48 KB; "
               "blocks whole warps of at most 1,024 threads")

    def check_cuda(self, source, config):
        scan = Scan(source)
        helpers = scan.helpers()
        limit, optin = config.smem_default_bytes, config.smem_optin_bytes
        findings: list[Finding] = []

        def add(at, message, hint):
            findings.append(Finding(self.id, source.relpath, source.line_of(at), message,
                                    hint=hint))

        for fn in scan.functions:
            env = scan.local_consts(fn)
            for at, target, value in scan.opt_ins(fn):
                v, _ = evaluate(value, env)
                if v is not None and v > optin:
                    add(at, f"`{fn.name}` opts `{base_name(target)}` into {v:,} B of "
                            f"shared memory, above the {optin:,} B a block can have",
                        f"opt in at most {optin:,} B (227 KB)")
            opted = None
            alias = scan.aliases(fn)
            for launch in scan.launches(fn):
                kernel = alias.get(launch.kernel, launch.kernel)
                if len(launch.args) >= 2:
                    threads = _block_threads(launch.args[1], env)
                    if threads is not None and (threads % config.warp_size
                                                or threads > config.max_block_threads):
                        add(launch.at,
                            f"launch of `{kernel}` in `{fn.name}` takes blocks of {threads} "
                            f"threads: not whole {config.warp_size}-thread warps of at "
                            f"most {config.max_block_threads}",
                            f"round the block to a multiple of {config.warp_size}, at most "
                            f"{config.max_block_threads}")
                smem = launch.args[2] if len(launch.args) >= 3 else "0"
                v, _ = evaluate(smem, env)
                if v is not None and v > optin:
                    add(launch.at, f"launch of `{kernel}` in `{fn.name}` asks for {v:,} B "
                                   f"of dynamic shared memory, above the {optin:,} B a "
                                   f"block can have", "split the tile")
                    continue
                if v is not None and v <= limit:
                    continue
                if opted is None:
                    opted = scan.opted(fn, helpers)
                if kernel not in opted and launch.kernel not in opted:
                    size = f"{v:,} B" if v is not None else f"`{smem}` bytes"
                    add(launch.at,
                        f"launch of `{kernel}` in `{fn.name}` asks for {size} of dynamic "
                        f"shared memory, which may pass the {limit:,} B a kernel has "
                        f"without opting in, and `{fn.name}` never opts it in: the "
                        f"launch is refused above {limit:,} B",
                        "opt the kernel in once per instantiation, "
                        "`static const cudaError_t ok = opt_in(kernel);` with "
                        "`cudaFuncSetAttribute(kernel, "
                        "cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)`")
        for name, info in static_smem(source, config, scan).items():
            if info["bytes"] > limit:
                approx = (f" (assumed {', '.join(info['assumed'])})"
                          if info["assumed"] else "")
                findings.append(Finding(
                    self.id, source.relpath, info["line"],
                    f"kernel `{name}` declares {info['bytes']:,} B of static "
                    f"`__shared__` arrays{approx}, over the {limit:,} B a block can "
                    f"have statically",
                    hint="move the arrays into dynamic shared memory "
                         "(`extern __shared__`) and opt the kernel in"))
        return findings
