"""generator-hygiene: every draw names its generator; every Philox key is
consumed at most once.

The port's randomness is explicit: `torch.Generator`s made by the caller,
and on the card Philox (seed, offset) keys under which a kernel draws its
own noise (`ops.philox_key(gen)` reads the generator's seed and offset and
advances the offset, so each key gets fresh counters). The parity story
(kernels bit for bit their plain versions on the same key, batched fits
equal to sequential ones from cloned generators, a stream that replays the
same) only holds when no draw reaches PyTorch's global generator and no key
is used twice. Four hazards:

  * (a) a draw with no `generator=` — `torch.rand/randn/randint/randperm/
    multinomial/bernoulli/normal/poisson`, the in-place `uniform_/normal_/
    exponential_/random_/bernoulli_/geometric_/cauchy_/log_normal_` and
    `Tensor.multinomial` — reads the global generator, which any other
    caller in the process also advances. A `**kw` whose dict (a literal or
    `dict(...)` bound in the same function) holds `generator` passes one;
    a `**kw` that cannot be resolved is not flagged;
  * (b) `torch.manual_seed`, `torch.cuda.manual_seed(_all)` or `torch.seed`
    anywhere in library code: global state that every other caller shares;
  * (c) `.manual_seed(<constant>)` inside a loop body: every iteration's
    generator replays the same stream (the counterpart of
    `PRNGKey(<constant>)` in a loop);
  * (d) a Philox key reused — a name bound from `philox_key(...)`,
    `philox_keys(...)` or a `(seed, offset)` tuple that the function passes
    as `philox=`, then handed to two consumers in straight-line code, or
    bound outside a loop and consumed inside it: both launches draw on the
    same counters, so their noise is identical.

Tracking for (d) follows the reference rule's machinery: straight-line
order, loops (a name rebound in the body is fresh each iteration; one
iterated from a key table is too), comprehensions, and `if` arms scanned
independently (an arm that returns or raises does not carry its use past
the `if`). Parameters are not tracked: a wrapper that hands its `philox`
argument to one launch is the normal shape, and a function that compares
a kernel with its plain version on one key does so on purpose."""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, Rule

_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
          "torch.multinomial", "torch.bernoulli", "torch.normal",
          "torch.poisson"}
#: Method draws (tensor methods, `torch.nn.init`'s in-place fills).
_METHOD_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_",
                 "multinomial"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.random.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all"}
#: Calls whose result is a Philox key (the last dotted component).
_KEY_MAKERS = {"philox_key", "philox_keys"}

#: Callables that inspect without consuming randomness — passing a key
#: to these never marks it used.
_NON_CONSUMING = {
    "len", "isinstance", "issubclass", "type", "repr", "str", "print",
    "id", "hash", "bool", "list", "tuple", "sorted", "reversed",
    "enumerate", "zip", "range", "getattr", "hasattr", "format",
}

_DRAW_HINT = ("pass `generator=` (a `torch.Generator` the caller owns, on "
              "the tensor's device)")
_SEED_HINT = ("make a `torch.Generator(device=...).manual_seed(seed)` and "
              "pass it down")
_REUSE_HINT = ("take a fresh key for each consumer (`ops.philox_key(gen)` "
               "advances the generator's offset)")
_LOOP_HINT = ("take the key inside the loop (`philox_key(gen)` each "
              "iteration) or iterate over a key table")


def _numpy_generators(tree: ast.Module, aliases: dict) -> set[str]:
    """Names bound from `numpy.random.*` calls or annotated as numpy
    generators: their `.multinomial`/`.normal` are numpy's, not draws on a
    torch generator."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            q = astutil.qualname(node.value.func, aliases) or ""
            if q.startswith("numpy.random."):
                for t in node.targets:
                    out.update(astutil.target_names(t))
        elif isinstance(node, ast.arg) and node.annotation is not None:
            q = astutil.qualname(node.annotation, aliases) or ""
            if q.startswith("numpy.random."):
                out.add(node.arg)
    return out


def _dict_has_generator(node: ast.AST) -> Optional[bool]:
    """Whether a dict expression holds a `generator` key; None when it
    cannot be told."""
    if isinstance(node, ast.Dict):
        if any(k is None for k in node.keys):
            return None  # a `**other` inside
        return any(astutil.const_str(k) == "generator" for k in node.keys)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "dict":
        if node.args or any(kw.arg is None for kw in node.keywords):
            return None
        return any(kw.arg == "generator" for kw in node.keywords)
    return None


class _Parents(ast.NodeVisitor):
    def __init__(self, tree):
        self.fn_of: dict[int, ast.AST] = {}
        self._stack: list[ast.AST] = [tree]
        self.visit(tree)

    def generic_visit(self, node):
        self.fn_of[id(node)] = self._stack[-1]
        scope = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        if scope:
            self._stack.append(node)
        super().generic_visit(node)
        if scope:
            self._stack.pop()


class GeneratorHygiene(Rule):
    id = "generator-hygiene"
    summary = ("torch draws must name their generator, library code must "
               "not seed globally, and Philox keys are consumed once")

    def check_module(self, module, _config):
        tree = module.tree
        aliases = astutil.import_aliases(tree)
        numpy_gens = _numpy_generators(tree, aliases)
        parents = _Parents(tree)
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            q = astutil.qualname(node.func, aliases)
            if q in _GLOBAL_SEEDS:
                findings.append(Finding(
                    self.id, module.relpath, node.lineno,
                    f"{q} seeds PyTorch's global generator: state every "
                    f"other caller in the process shares",
                    hint=_SEED_HINT))
                continue
            draw = self._draw_name(node, q, numpy_gens)
            if draw is not None and not self._passes_generator(
                    node, parents.fn_of.get(id(node), tree)):
                findings.append(Finding(
                    self.id, module.relpath, node.lineno,
                    f"{draw} draws with no `generator=`: it reads PyTorch's "
                    f"global generator, which any other caller advances",
                    hint=_DRAW_HINT))

        # Names each scope passes as `philox=`: a (seed, offset) tuple
        # bound to one of them is a key.
        philox_names: dict[int, set[str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.keyword) and node.arg == "philox" \
                    and isinstance(node.value, ast.Name):
                scope = parents.fn_of.get(id(node), tree)
                philox_names.setdefault(id(scope), set()).add(node.value.id)
        scanner = _Scanner(module.relpath, aliases, findings)
        top = [s for s in tree.body
               if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))]
        scanner.scan_scope(top, philox_names.get(id(tree), set()))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scanner.scan_scope(node.body, philox_names.get(id(node), set()))
            elif isinstance(node, ast.Lambda):
                scanner.scan_scope([ast.Expr(value=node.body)],
                                   philox_names.get(id(node), set()))
        return findings

    @staticmethod
    def _draw_name(call: ast.Call, q: Optional[str],
                   numpy_gens: set[str]) -> Optional[str]:
        if q in _DRAWS:
            return q
        if not isinstance(call.func, ast.Attribute) \
                or call.func.attr not in _METHOD_DRAWS:
            return None
        q = q or call.func.attr
        if q.startswith("numpy.") or q.split(".")[0] in numpy_gens:
            return None
        receiver = astutil.expr_id(call.func.value)
        if receiver is not None and receiver in numpy_gens:
            return None
        return q if q.startswith("torch.") else f"Tensor.{call.func.attr}"

    @staticmethod
    def _passes_generator(call: ast.Call, scope: ast.AST) -> bool:
        for kw in call.keywords:
            if kw.arg == "generator":
                return not (isinstance(kw.value, ast.Constant)
                            and kw.value.value is None)
        for kw in call.keywords:
            if kw.arg is not None:
                continue
            has = _dict_has_generator(kw.value)
            if has is None and isinstance(kw.value, ast.Name):
                bound = [n.value for n in ast.walk(scope)
                         if isinstance(n, ast.Assign)
                         and any(isinstance(t, ast.Name)
                                 and t.id == kw.value.id for t in n.targets)]
                seen = [_dict_has_generator(v) for v in bound]
                has = None if not seen or None in seen else all(seen)
            if has is None or has:
                return True  # unresolvable `**kw` is not flagged
        return False


@dataclasses.dataclass
class _Use:
    line: int
    fn: str


@dataclasses.dataclass
class _Event:
    var: str
    kind: str  # "use" | "bind"
    line: int
    fn: str = ""


def _is_key_maker(call: ast.AST, aliases) -> bool:
    if not isinstance(call, ast.Call):
        return False
    q = astutil.qualname(call.func, aliases) or ""
    return q.rsplit(".", 1)[-1] in _KEY_MAKERS


class _Scanner:
    """Order-sensitive abstract interpreter over one function scope: the
    reference rule's, keyed on Philox keys instead of `jax.random` keys."""

    def __init__(self, path: str, aliases: dict, findings: list):
        self.path = path
        self.aliases = aliases
        self.findings = findings
        self.philox_names: set[str] = set()

    # -- scope entry ---------------------------------------------------------

    def scan_scope(self, body: list[ast.stmt], philox_names: set[str]) -> None:
        self.philox_names = philox_names
        self._scan(body, {}, [], in_loop=False)

    # -- statements ----------------------------------------------------------

    def _scan(self, stmts, state, events, in_loop: bool) -> bool:
        """Returns True when the block always terminates (return/raise)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # separate scope, analyzed by check_module
            if isinstance(stmt, (ast.Return, ast.Raise)):
                if getattr(stmt, "value", None) is not None:
                    self._eval(stmt.value, state, events, in_loop)
                if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                    self._eval(stmt.exc, state, events, in_loop)
                return True
            if isinstance(stmt, (ast.Break, ast.Continue)):
                return True
            if isinstance(stmt, ast.Assign):
                self._eval(stmt.value, state, events, in_loop)
                self._bind_targets(stmt.targets, stmt.value, state, events)
            elif isinstance(stmt, ast.AnnAssign):
                if stmt.value is not None:
                    self._eval(stmt.value, state, events, in_loop)
                    self._bind_targets([stmt.target], stmt.value, state,
                                       events)
            elif isinstance(stmt, ast.AugAssign):
                self._eval(stmt.value, state, events, in_loop)
                self._bind_targets([stmt.target], None, state, events)
            elif isinstance(stmt, ast.Expr):
                self._eval(stmt.value, state, events, in_loop)
            elif isinstance(stmt, ast.If):
                self._eval(stmt.test, state, events, in_loop)
                b_state, o_state = dict(state), dict(state)
                b_term = self._scan(stmt.body, b_state, events, in_loop)
                o_term = self._scan(stmt.orelse, o_state, events, in_loop)
                self._merge_if(state, (b_state, b_term), (o_state, o_term))
                if b_term and o_term:
                    return True
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_for(stmt, state, events, in_loop)
            elif isinstance(stmt, ast.While):
                self._eval(stmt.test, state, events, in_loop)
                self._scan_loop_body(stmt.body, set(), state, events)
                self._scan(stmt.orelse, state, events, in_loop)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._eval(item.context_expr, state, events, in_loop)
                if self._scan(stmt.body, state, events, in_loop):
                    return True
            elif isinstance(stmt, ast.Try):
                self._scan(stmt.body, state, events, in_loop)
                for h in stmt.handlers:
                    self._scan(h.body, dict(state), events, in_loop)
                self._scan(stmt.orelse, state, events, in_loop)
                self._scan(stmt.finalbody, state, events, in_loop)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    tid = astutil.expr_id(t)
                    if tid in state:
                        del state[tid]
        return False

    def _merge_if(self, state, *branches) -> None:
        live = [s for s, term in branches if not term]
        if not live:
            return
        for var in {v for s in live for v in s}:
            uses = [s[var] for s in live if s.get(var) is not None]
            state[var] = uses[0] if uses else None

    # -- loops ---------------------------------------------------------------

    def _scan_for(self, stmt, state, events, in_loop: bool) -> None:
        self._eval(stmt.iter, state, events, in_loop)
        loop_targets = set(astutil.target_names(stmt.target))
        for name in loop_targets:
            if name in state:
                state[name] = None
                events.append(_Event(name, "bind", stmt.lineno))
        self._scan_loop_body(stmt.body, loop_targets, state, events)
        self._scan(stmt.orelse, state, events, in_loop)

    def _scan_loop_body(self, body, loop_targets, state, events) -> None:
        pre_tracked = set(state)
        n0 = len(events)
        self._scan(body, state, events, in_loop=True)
        used: dict[str, _Event] = {}
        rebound: set[str] = set()
        for ev in events[n0:]:
            if ev.kind == "bind":
                rebound.add(ev.var)
            elif ev.var not in used:
                used[ev.var] = ev
        for var, ev in used.items():
            if var in pre_tracked and var not in loop_targets \
                    and var not in rebound:
                self.findings.append(Finding(
                    GeneratorHygiene.id, self.path, ev.line,
                    f"Philox key '{var}' is bound outside the loop but "
                    f"consumed by {ev.fn} inside the loop body: every "
                    f"iteration draws on the same counters",
                    hint=_LOOP_HINT))

    # -- expressions ---------------------------------------------------------

    def _eval(self, expr, state, events, in_loop: bool,
              comp_locals: frozenset = frozenset()) -> None:
        if expr is None:
            return
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            self._eval_comp(expr, state, events, in_loop)
            return
        for node in ast.iter_child_nodes(expr):
            if isinstance(node, (ast.Lambda, ast.FunctionDef)):
                continue  # separate scope
            if isinstance(node, (ast.expr, ast.keyword, ast.comprehension)):
                self._eval(node, state, events, in_loop, comp_locals)
        if isinstance(expr, ast.Call):
            self._eval_call(expr, state, events, in_loop, comp_locals)

    def _eval_comp(self, comp, state, events, in_loop: bool) -> None:
        locals_ = set()
        for gen in comp.generators:
            self._eval(gen.iter, state, events, in_loop)
            locals_ |= set(astutil.target_names(gen.target))
        comp_state = {v: u for v, u in state.items() if v not in locals_}
        n0 = len(events)
        parts = [getattr(comp, a, None)
                 for a in ("elt", "key", "value")] + [
            c for gen in comp.generators for c in gen.ifs]
        for part in parts:
            if part is not None:
                self._eval(part, comp_state, events, True,
                           frozenset(locals_))
        for ev in events[n0:]:
            if ev.kind == "use" and ev.var in state \
                    and ev.var not in locals_:
                self.findings.append(Finding(
                    GeneratorHygiene.id, self.path, ev.line,
                    f"Philox key '{ev.var}' from the enclosing scope is "
                    f"consumed by {ev.fn} on every comprehension "
                    f"iteration: the same counters each element",
                    hint=_LOOP_HINT))
                state[ev.var] = _Use(ev.line, ev.fn)
                break

    def _eval_call(self, call, state, events, in_loop: bool,
                   comp_locals: frozenset) -> None:
        q = astutil.qualname(call.func, self.aliases)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "manual_seed" \
                and q not in _GLOBAL_SEEDS:
            if in_loop and call.args and all(
                    isinstance(a, ast.Constant) for a in call.args):
                self.findings.append(Finding(
                    GeneratorHygiene.id, self.path, call.lineno,
                    "manual_seed called with a constant seed inside a "
                    "loop: every iteration's generator replays the same "
                    "stream",
                    hint=("derive the seed from the loop variable, or seed "
                          "one generator outside the loop and draw on")))
            return
        if q in _NON_CONSUMING or _is_key_maker(call, self.aliases):
            return
        # A tracked key passed as any argument is handed to a launch, a
        # sampler or a noise draw — that consumes it.
        fn = q or "a call"
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)):
                self._consume(arg, fn, state, events, comp_locals)

    def _consume(self, key_expr, fn: str, state, events,
                 comp_locals: frozenset) -> None:
        kid = astutil.expr_id(key_expr)
        if kid is None or kid in comp_locals or kid not in state:
            return
        prior = state[kid]
        line = getattr(key_expr, "lineno", 0)
        if prior is not None:
            self.findings.append(Finding(
                GeneratorHygiene.id, self.path, line,
                f"Philox key '{kid}' passed to {fn} was already consumed "
                f"by {prior.fn} at line {prior.line}: both draw on the "
                f"same counters, so their noise is identical",
                hint=_REUSE_HINT))
        state[kid] = _Use(line, fn)
        events.append(_Event(kid, "use", line, fn))

    def _bind_targets(self, targets, value, state, events) -> None:
        made = _is_key_maker(value, self.aliases)
        pair = isinstance(value, ast.Tuple) and len(value.elts) == 2
        for t in targets:
            whole = isinstance(t, (ast.Name, ast.Attribute, ast.Subscript))
            for name in astutil.target_names(t):
                if whole and (made or (pair and name in self.philox_names)):
                    state[name] = None
                elif name in state:
                    del state[name]  # rebound to something else: untracked
                else:
                    continue
                events.append(_Event(name, "bind", getattr(t, "lineno", 0)))
