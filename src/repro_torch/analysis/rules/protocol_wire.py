"""protocol-conformance: KINDS ↔ server dispatch ↔ client methods.

A wire verb lives in three places: the `KINDS` tuple in the protocol
module (what envelopes may carry), a `_handle_<verb>` method on a
`*Server` class (`handle_raw` routes with
`getattr(self, f"_handle_{kind}")`), and a `*Client` method that sends
it (`self._call("<verb>")` / `protocol.make_request("<verb>")`). Adding
a verb to fewer than all three is a half-wired protocol: the server
500s on a legal kind, or a client method can never get an answer, or a
reachable handler serves a verb the envelope validator rejects. This
rule cross-checks the three sets so a verb can never be half-wired —
what used to be discovered by an integration test at runtime.

Conventions (how the three surfaces are found, so fixtures and future
tiers are checked by the same rule):

  * kinds: a module-level `KINDS = ("...", ...)` tuple of str literals;
  * handlers: methods named `_handle_<verb>` on classes whose name ends
    with `Server`. Every `_handle_*` suffix is reachable through the
    dispatch `getattr`, so helpers must not squat the prefix;
  * client verbs: str-literal first arguments of `._call(...)` or
    `make_request(...)` calls inside classes whose name ends `Client`.

The rule is silent unless at least a KINDS tuple is present among the
analyzed modules (so it only fires on trees that define a protocol).
"""

from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, Rule

_HANDLER_PREFIX = "_handle_"


def _find_kinds(modules):
    """(module, line, tuple-of-verbs) for each top-level KINDS constant."""
    out = []
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "KINDS"
                            for t in node.targets):
                verbs = astutil.str_tuple(node.value)
                if verbs is not None:
                    out.append((mod, node.lineno, verbs))
    return out


def _server_handlers(modules):
    """verb -> (module, line) from `_handle_*` methods on *Server classes."""
    out = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name.endswith("Server")):
                continue
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and item.name.startswith(_HANDLER_PREFIX):
                    verb = item.name[len(_HANDLER_PREFIX):]
                    out.setdefault(verb, (mod, item.lineno))
    return out


def _client_verbs(modules):
    """verb -> (module, line) from str-literal `_call`/`make_request`s."""
    out = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name.endswith("Client")):
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call) or not call.args:
                    continue
                q = astutil.qualname(call.func, {}) or ""
                if not (q.endswith("._call") or q.endswith("make_request")
                        or q == "make_request"):
                    continue
                verb = astutil.const_str(call.args[0])
                if verb is not None:
                    out.setdefault(verb, (mod, call.lineno))
    return out


class ProtocolConformance(Rule):
    id = "protocol-conformance"
    summary = ("every wire verb must exist in KINDS, the server "
               "dispatch table, and the client — no half-wired verbs")

    def check_project(self, modules, _config):
        kinds_defs = _find_kinds(modules)
        if not kinds_defs:
            return []
        handlers = _server_handlers(modules)
        client = _client_verbs(modules)
        kinds: set[str] = set()
        findings: list[Finding] = []

        for mod, line, verbs in kinds_defs:
            kinds |= set(verbs)
            for verb in verbs:
                if handlers and verb not in handlers:
                    findings.append(Finding(
                        self.id, mod.relpath, line,
                        f"wire verb {verb!r} is declared in KINDS but no "
                        f"*Server class defines `_handle_{verb}`: the "
                        f"server answers `internal` error on a legal kind",
                        hint=f"add `_handle_{verb}` to the server or drop "
                             f"the verb from KINDS"))
                if client and verb not in client:
                    findings.append(Finding(
                        self.id, mod.relpath, line,
                        f"wire verb {verb!r} is declared in KINDS but no "
                        f"*Client method sends it: the verb is "
                        f"unreachable from the client surface",
                        hint="add a client method (or an explicit "
                             "suppression naming the server-only reason)"))

        for verb, (mod, line) in sorted(handlers.items()):
            if verb not in kinds:
                findings.append(Finding(
                    self.id, mod.relpath, line,
                    f"`_handle_{verb}` squats the dispatch prefix but "
                    f"{verb!r} is not in KINDS: either a dead verb or a "
                    f"helper reachable through `getattr` dispatch",
                    hint="add the verb to KINDS, or rename the helper "
                         "off the `_handle_` prefix"))
        for verb, (mod, line) in sorted(client.items()):
            if verb not in kinds:
                findings.append(Finding(
                    self.id, mod.relpath, line,
                    f"client sends verb {verb!r} which is not in KINDS: "
                    f"`make_request` raises before the wire",
                    hint="add the verb to KINDS (and a server handler)"))
        return findings
