"""vedalint rule registry for the port.

Each rule module defines one `Rule` subclass; `all_rules()` returns one
instance of each, in stable id order. Adding a rule = adding a module
here + an entry in `_RULE_CLASSES` (+ a fixture test in
tests/test_torch_analysis.py and a row in the README rule table).
"""

from __future__ import annotations

from repro_torch.analysis.rules.cache_args import CacheArgsHashable
from repro_torch.analysis.rules.cuda_smem import CudaSmemBudget
from repro_torch.analysis.rules.generator import GeneratorHygiene
from repro_torch.analysis.rules.obs_metrics import ObsMetricConsistency
from repro_torch.analysis.rules.protocol_wire import ProtocolConformance
from repro_torch.analysis.rules.quant_branch import QuantBranchBan

_RULE_CLASSES = (
    CacheArgsHashable,
    CudaSmemBudget,
    GeneratorHygiene,
    ObsMetricConsistency,
    ProtocolConformance,
    QuantBranchBan,
)


def all_rules():
    return sorted((cls() for cls in _RULE_CLASSES), key=lambda r: r.id)


def rule_ids() -> tuple[str, ...]:
    return tuple(r.id for r in all_rules())
