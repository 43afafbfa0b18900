"""obs-metric-consistency: one (type, labels) per metric name, repo-wide.

`repro_torch.obs.metrics` declarations are get-or-create: re-declaring a name
with a different instrument type or label set raises — *at runtime*, at
whichever import happens to lose the race. This rule lifts that check
to analysis time: every `metrics.counter/gauge/histogram("name", ...,
labels=(...))` call site with a literal name is indexed project-wide,
and sites that disagree with the first declaration on instrument type
or label tuple are flagged where they stand.

Sites whose labels are not a literal tuple/list of strings still
participate in the type check but are skipped for label comparison.
"""

from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, Rule

_KINDS = ("counter", "gauge", "histogram")


def _declaration(call: ast.Call, aliases) -> Optional[tuple]:
    q = astutil.qualname(call.func, aliases) or ""
    kind = q.rsplit(".", 1)[-1]
    if kind not in _KINDS:
        return None
    if not (q in _KINDS or q.endswith(".metrics." + kind)
            or q == "metrics." + kind
            or q.startswith("repro_torch.obs.metrics.")):
        return None
    if not call.args:
        return None
    name = astutil.const_str(call.args[0])
    if name is None:
        return None
    labels_node = astutil.keyword_arg(call, "labels")
    if labels_node is None and len(call.args) >= 3:
        labels_node = call.args[2]
    labels = astutil.str_tuple(labels_node) \
        if labels_node is not None else ()
    return name, kind, labels


class ObsMetricConsistency(Rule):
    id = "obs-metric-consistency"
    summary = ("a metric name must declare the same instrument type and "
               "label set at every call site")

    def check_project(self, modules, _config):
        first: dict[str, tuple] = {}  # name -> (kind, labels, path, line)
        findings: list[Finding] = []
        for mod in modules:
            aliases = astutil.import_aliases(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                decl = _declaration(node, aliases)
                if decl is None:
                    continue
                name, kind, labels = decl
                prev = first.get(name)
                if prev is None:
                    first[name] = (kind, labels, mod.relpath, node.lineno)
                    continue
                pkind, plabels, ppath, pline = prev
                if kind != pkind:
                    findings.append(Finding(
                        self.id, mod.relpath, node.lineno,
                        f"metric {name!r} declared as {kind} here but as "
                        f"{pkind} at {ppath}:{pline}: the second import "
                        f"raises at runtime",
                        hint="pick one instrument type per name"))
                elif labels is not None and plabels is not None \
                        and labels != plabels:
                    findings.append(Finding(
                        self.id, mod.relpath, node.lineno,
                        f"metric {name!r} declared with labels "
                        f"{labels} here but {plabels} at {ppath}:{pline}: "
                        f"the second import raises at runtime",
                        hint="unify the label set (or split the metric "
                             "into two names)"))
        return findings
