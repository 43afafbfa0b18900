"""repro_torch.analysis — vedalint for the port: static analysis of its
Python modules and CUDA sources.

Run `python -m repro_torch.analysis` (default paths `src/repro_torch tools
chip_smoke.py`; exit 0 = clean). The rules encode the cross-file
conventions the port rests on: explicit generators and single-use Philox
keys, hashable cache keys, wire-protocol conformance, the kernels' shared
memory within the card's limits, the codec's storage-format-branch
monopoly, and metric declaration consistency. See README "Static analysis
of the port" for the rule table and suppression syntax.

It is a host tool: it imports only the standard library (not `torch`, not
the analyzed code) and touches no device, so the port's "card by default"
rule for entry points does not apply to it.
"""

from repro_torch.analysis.engine import (
    AnalysisConfig,
    CudaSource,
    Finding,
    Module,
    Report,
    Rule,
    analyze,
    analyze_paths,
    load_modules,
    write_json,
)
from repro_torch.analysis.rules import all_rules, rule_ids

__all__ = [
    "AnalysisConfig",
    "CudaSource",
    "Finding",
    "Module",
    "Report",
    "Rule",
    "all_rules",
    "analyze",
    "analyze_paths",
    "load_modules",
    "rule_ids",
    "write_json",
]
