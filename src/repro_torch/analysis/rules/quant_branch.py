"""quant-branch-ban: storage-format dispatch belongs to the codec.

The QuantSpec redesign centralised every storage-format branch in
`core/quant.py` + `core/codec.py`; a new ``<x>.w_bits is (not) None``
test anywhere else reintroduces the ad-hoc per-call-site codec forks
that redesign removed. This is the AST port of the old CI grep — unlike
the grep it understands comments, strings, and line wrapping, and it
allows bare-name `w_bits` parameters (the kernels legitimately branch on
an already-resolved `w_bits: int | None` argument; only *attribute*
access reaches back into a config).

Allowed files come from `AnalysisConfig.quant_allowed` (relpath
suffixes). Tests are expected to branch on both formats explicitly —
run the analyzer on `src benchmarks`, not on `tests`.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, Rule


class QuantBranchBan(Rule):
    id = "quant-branch-ban"
    summary = ("`.w_bits is (not) None` dispatch outside core/quant.py + "
               "core/codec.py reintroduces per-call-site codec forks")

    def check_module(self, module, config):
        if module.relpath.endswith(config.quant_allowed):
            return []
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            has_attr = any(isinstance(o, ast.Attribute)
                           and o.attr == "w_bits" for o in operands)
            has_none = any(isinstance(o, ast.Constant) and o.value is None
                           for o in operands)
            is_identity = any(isinstance(op, (ast.Is, ast.IsNot, ast.Eq,
                                              ast.NotEq))
                              for op in node.ops)
            if has_attr and has_none and is_identity:
                findings.append(Finding(
                    self.id, module.relpath, node.lineno,
                    "storage-format branch on `.w_bits` outside the "
                    "codec: resolve a QuantSpec instead",
                    hint="use `cfg.quant_spec` / `codec_for(cfg)` — "
                         "core/quant.py owns the format dispatch"))
        return findings
