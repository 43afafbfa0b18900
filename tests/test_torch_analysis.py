"""vedalint for the port (`repro_torch.analysis`): parity with the
reference's analyzer, the port's own rules both ways, the CLI, the live
trees, and its import boundary.

Parity: the reference's fixtures of its three framework-neutral rules
(protocol conformance, the w_bits branch ban, metric declaration
consistency), its suppression fixtures and its parse-error fixture go
through `repro.analysis.analyze` and `repro_torch.analysis.analyze`; the
findings must be equal as (rule, relpath, line, message), suppressed ones
included. The suppression fixtures run the reference's own
`prng-key-hygiene` rule through both engines, so what is compared is the
engines' suppression handling.

The port's three rules (`generator-hygiene`, `cache-args-hashable`,
`cuda-smem-budget`) mirror the reference's `prng-key-hygiene`,
`jit-static-hashable` and `pallas-tile-budget` case lists: fixtures that
must fire and near-misses that must stay silent.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import analyze as ref_analyze
from repro.analysis import engine as ref_engine
from repro.analysis.rules import all_rules as ref_all_rules
from repro.analysis.rules.obs_metrics import ObsMetricConsistency as RefObs
from repro.analysis.rules.prng import PrngKeyHygiene as RefPrng
from repro.analysis.rules.protocol_wire import ProtocolConformance as RefProtocol
from repro.analysis.rules.quant_branch import QuantBranchBan as RefQuant
from repro_torch.analysis import AnalysisConfig, analyze, engine
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.rules import all_rules, rule_ids
from repro_torch.analysis.rules.cache_args import CacheArgsHashable
from repro_torch.analysis.rules.cuda_smem import CudaSmemBudget, static_smem
from repro_torch.analysis.rules.generator import GeneratorHygiene
from repro_torch.analysis.rules.obs_metrics import ObsMetricConsistency
from repro_torch.analysis.rules.protocol_wire import ProtocolConformance
from repro_torch.analysis.rules.quant_branch import QuantBranchBan

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "src" / "repro_torch" / "analysis"


def run_source(source, rules=None, relpath="fixture.py", config=None):
    cls = engine.CudaSource if relpath.endswith((".cu", ".cuh")) else engine.Module
    mod = cls(Path(relpath), relpath, textwrap.dedent(source))
    assert mod.parse_error is None, mod.parse_error
    return analyze([mod], list(rules) if rules else all_rules(), config)


def rule_hits(report, rule_id):
    return [f for f in report.findings if f.rule == rule_id]


# ---------------------------------------------------------------------------
# parity with the reference: its fixtures of the neutral rules, its
# suppression fixtures and its parse-error fixture, through both engines
# ---------------------------------------------------------------------------

_REUSE = """
    import jax

    def f(key):
        a = jax.random.normal(key, (3,))
        b = jax.random.gumbel(key, (3,))  # vedalint: disable=prng-key-hygiene -- fixture
        return a, b
"""

# case: (source, relpath, rule kind, findings, suppressed)
PARITY = {
    "protocol_fully_wired": ("""
        KINDS = ("ping", "fit")

        class ToyServer:
            def _handle_ping(self, payload):
                return {}

            def _handle_fit(self, payload):
                return {}

        class ToyClient:
            def ping(self):
                return self._call("ping")

            def fit(self):
                return self._call("fit")
    """, "fixture.py", "protocol", 0, 0),
    "protocol_missing_handler_and_sender": ("""
        KINDS = ("ping", "fit", "stats")

        class ToyServer:
            def _handle_ping(self, payload):
                return {}

        class ToyClient:
            def ping(self):
                return self._call("ping")
    """, "fixture.py", "protocol", 4, 0),
    "protocol_prefix_squatter": ("""
        KINDS = ("ping",)

        class ToyServer:
            def _handle_ping(self, payload):
                return {}

            def _handle_of(self, session, name):
                return session[name]

        class ToyClient:
            def ping(self):
                return self._call("ping")
    """, "fixture.py", "protocol", 1, 0),
    "protocol_client_unknown_verb": ("""
        KINDS = ("ping",)

        class ToyServer:
            def _handle_ping(self, payload):
                return {}

        class ToyClient:
            def ping(self):
                return self._call("ping")

            def typo(self):
                return self._call("pingg")
    """, "fixture.py", "protocol", 1, 0),
    "protocol_silent_without_kinds": ("""
        class ToyServer:
            def _handle_whatever(self, payload):
                return {}
    """, "fixture.py", "protocol", 0, 0),
    "quant_attribute_branch_fires_even_wrapped": ("""
        def f(cfg, x):
            if (cfg.w_bits
                    is not None):
                return x * 2
            return x
    """, "src/repro/serving/thing.py", "quant", 1, 0),
    "quant_port_attribute_branch": ("""
        def f(cfg, x):
            return x * 2 if cfg.w_bits is not None else x
    """, "src/repro_torch/serving/thing.py", "quant", 1, 0),
    **{f"quant_codec_files_are_allowed[{rel}]": ("""
        def f(cfg, x):
            return x * 2 if cfg.w_bits is not None else x
    """, rel, "quant", 0, 0) for rel in ("src/repro/core/quant.py", "src/repro/core/codec.py",
                                          "src/repro_torch/core/quant.py",
                                          "src/repro_torch/core/codec.py")},
    "quant_bare_name_and_strings": ('''
        def kernel(x, w_bits):
            if w_bits is None:
                return x
            return x * w_bits

        DOC = "dispatch on cfg.w_bits is not None happens in the codec"
    ''', "src/repro/kernels/k.py", "quant", 0, 0),
    "obs_conflicting_kind": ("""
        from repro.obs import metrics

        A = metrics.counter("repro_things_total", "Things.")
        B = metrics.gauge("repro_things_total", "Things.")
    """, "fixture.py", "obs", 1, 0),
    "obs_conflicting_labels": ("""
        from repro.obs import metrics

        A = metrics.counter("repro_rpc_total", "RPCs.", labels=("verb",))
        B = metrics.counter("repro_rpc_total", "RPCs.",
                            labels=("verb", "status"))
    """, "fixture.py", "obs", 1, 0),
    "obs_consistent_redeclaration": ("""
        from repro.obs import metrics

        A = metrics.counter("repro_rpc_total", "RPCs.", labels=("verb",))
        B = metrics.counter("repro_rpc_total", "RPCs.", labels=("verb",))
        C = metrics.histogram("repro_latency_s", "Latency.")
    """, "fixture.py", "obs", 0, 0),
    "obs_port_metrics_module": ("""
        from repro_torch.obs import metrics

        A = metrics.counter("vedalia_dup_total", "Dup.")
        B = metrics.gauge("vedalia_dup_total", "Dup.")
    """, "fixture.py", "obs", 1, 0),
    "inline_suppression_moves_finding_to_suppressed": (_REUSE, "fixture.py", "prng", 0, 1),
    "standalone_suppression_covers_next_logical_line": ("""
        import jax

        def f(key):
            a = jax.random.normal(key, (3,))
            # vedalint: disable=prng-key-hygiene -- fixture justification
            # that wraps onto a second comment line before the code
            b = jax.random.gumbel(
                key, (3,))
            return a, b
    """, "fixture.py", "prng", 0, 1),
    "suppression_wrong_rule_does_not_cover": ("""
        import jax

        def f(key):
            a = jax.random.normal(key, (3,))
            b = jax.random.gumbel(key, (3,))  # vedalint: disable=pallas-tile-budget -- wrong id
            return a, b
    """, "fixture.py", "prng", 1, 0),
    "suppression_does_not_leak_past_its_line": ("""
        import jax

        def f(key):
            a = jax.random.normal(key, (3,))
            # vedalint: disable=prng-key-hygiene -- covers only the next line
            b = jax.random.gumbel(key, (3,))
            c = jax.random.normal(key, (3,))
            return a, b, c
    """, "fixture.py", "prng", 1, 1),
    "blanket_suppression": ("""
        import jax

        def f(key):
            a = jax.random.normal(key, (3,))
            b = jax.random.gumbel(key, (3,))  # vedalint: disable=* -- fixture
            return a, b
    """, "fixture.py", "prng", 0, 1),
    "parse_error_is_a_finding_and_unsuppressible": (
        "# vedalint: disable=parse-error -- nope\ndef f(:\n", "bad.py", "all", 1, 0),
}

_RULES = {
    "protocol": ([RefProtocol()], [ProtocolConformance()]),
    "quant": ([RefQuant()], [QuantBranchBan()]),
    "obs": ([RefObs()], [ObsMetricConsistency()]),
    # The suppression engine, compared on the reference's own rule.
    "prng": ([RefPrng()], [RefPrng()]),
    "all": (ref_all_rules(), all_rules()),
}


def _key(report):
    return ([(f.rule, f.path, f.line, f.message) for f in report.findings],
            [(f.rule, f.path, f.line, f.message) for f in report.suppressed])


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_with_the_reference(case):
    source, relpath, kind, n_found, n_suppressed = PARITY[case]
    source = textwrap.dedent(source)
    ref_rules, port_rules = _RULES[kind]
    ref = ref_analyze([ref_engine.Module(Path(relpath), relpath, source)], ref_rules)
    port = analyze([engine.Module(Path(relpath), relpath, source)], port_rules)
    assert _key(port) == _key(ref)
    assert (len(port.findings), len(port.suppressed)) == (n_found, n_suppressed)
    assert port.files_checked == ref.files_checked == 1


# ---------------------------------------------------------------------------
# the live trees
# ---------------------------------------------------------------------------

def test_live_port_neutral_rules_equal_the_reference():
    paths = [REPO / "src" / "repro_torch"]
    ref = ref_engine.analyze_paths(paths, root=REPO,
                                   rules=[RefProtocol(), RefQuant(), RefObs()])
    port = engine.analyze_paths(paths, root=REPO, rules=[ProtocolConformance(),
                                                         QuantBranchBan(),
                                                         ObsMetricConsistency()])
    assert _key(port) == _key(ref)
    assert port.clean, "\n" + port.render_text()
    assert ref.files_checked > 100


def test_live_port_is_clean_on_the_default_paths():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--format", "json"],
                         cwd=REPO, capture_output=True, text=True, env=env, timeout=300,
                         check=False)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["files_checked"] > 100 and not report["findings"]


def test_collect_files_takes_cuda_sources():
    files = [rel for _, rel in engine.collect_files(
        [REPO / "src" / "repro_torch" / "kernels"], root=REPO)]
    assert "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu" in files
    assert "src/repro_torch/kernels/lda_gibbs/ops.py" in files


# ---------------------------------------------------------------------------
# generator-hygiene: the counterparts of the reference's prng cases, plus
# the draw and global-seed hazards
# ---------------------------------------------------------------------------

_G = [GeneratorHygiene()]


def test_gen_straight_line_reuse_fires():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gen):
            key = ops.philox_key(gen)
            a = ops.resample(*args, None, philox=key)
            b = ops.resample(*args, None, philox=key)
            return a, b
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 1
    assert "already consumed" in hits[0].message
    assert hits[0].line == 7


def test_gen_fresh_key_rebind_is_clean():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gen):
            key = ops.philox_key(gen)
            a = ops.resample(*args, None, philox=key)
            key = ops.philox_key(gen)
            b = ops.resample(*args, None, philox=key)
            return a, b
    """, rules=_G)
    assert not report.findings


def test_gen_alias_import_still_tracked():
    report = run_source("""
        import torch as th
        from repro_torch.kernels.lda_gibbs.ops import philox_key as pk

        def f(run, gen):
            k = pk(gen)
            run(k)
            run(k)
            return th.rand(3)
    """, rules=_G)
    msgs = [f.message for f in rule_hits(report, "generator-hygiene")]
    assert len(msgs) == 2
    assert any("already consumed" in m for m in msgs)
    assert any("torch.rand draws" in m for m in msgs)


def test_gen_loop_carried_reuse_fires():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gen, n):
            key = ops.philox_key(gen)
            out = []
            for _ in range(n):
                out.append(ops.resample(*args, None, philox=key))
            return out
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 1
    assert "inside the loop" in hits[0].message


def test_gen_loop_over_key_table_is_clean():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gens, dev):
            return [ops.resample(*args, None, philox=k)
                    for k in ops.philox_keys(gens, dev)]

        def g(args, gens):
            out = []
            for i, k in enumerate(map(ops.philox_key, gens)):
                out.append(ops.resample(*args, None, philox=k))
            return out
    """, rules=_G)
    assert not report.findings


def test_gen_key_per_iteration_is_clean():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gen, n):
            return [ops.resample(*args, None, philox=ops.philox_key(gen))
                    for _ in range(n)]
    """, rules=_G)
    assert not report.findings


def test_gen_seed_from_the_loop_index_is_clean():
    report = run_source("""
        import torch

        def f(m):
            return [torch.Generator(device="cuda").manual_seed(123 + i)
                    for i in range(m)]
    """, rules=_G)
    assert not report.findings


def test_gen_tuple_rebound_in_loop_is_clean():
    report = run_source("""
        def f(launch, n, seed):
            out = []
            for i in range(n):
                key = (seed, 4 * i)
                out.append(launch(philox=key))
            return out
    """, rules=_G)
    assert not report.findings


def test_gen_constant_seed_in_loop_fires():
    report = run_source("""
        import torch

        def f(run, n):
            out = []
            for _ in range(n):
                out.append(run(torch.Generator().manual_seed(0)))
            return out
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 1
    assert "constant seed" in hits[0].message


def test_gen_dynamic_index_is_clean():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gens, dev, n):
            table = ops.philox_keys(gens, dev)
            return [ops.resample(*args, None, philox=table[i]) for i in range(n)]
    """, rules=_G)
    assert not report.findings


def test_gen_comprehension_outer_key_fires():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(blocks, gen):
            key = ops.philox_key(gen)
            return [ops.resample(*b, None, philox=key) for b in blocks]
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 1
    assert "comprehension" in hits[0].message


def test_gen_terminating_branches_are_exclusive():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gen, flag):
            key = ops.philox_key(gen)
            if flag:
                return ops.resample(*args, None, philox=key)
            return ops.resample_many(*args, None, philox=key)
    """, rules=_G)
    assert not report.findings


def test_gen_tuple_key_passed_to_two_samplers_fires():
    report = run_source("""
        def f(cfg, corpus, run_a, run_b):
            key = (2 ** 64 - 5, 8)
            st1 = run_a(cfg, corpus, philox=key)
            st2 = run_b(cfg, corpus, philox=key)
            return st1, st2
    """, rules=_G)
    assert len(rule_hits(report, "generator-hygiene")) == 1


def test_gen_len_and_checks_do_not_consume():
    report = run_source("""
        from repro_torch.kernels.lda_gibbs import ops

        def f(args, gens, dev):
            keys = ops.philox_keys(gens, dev)
            if not (len(gens) == len(keys)) or not isinstance(keys, object):
                raise ValueError("align")
            return ops.resample_many(*args, None, philox=keys)
    """, rules=_G)
    assert not report.findings


def test_gen_draws_without_a_generator_fire():
    report = run_source("""
        import torch

        def f(x, p, n):
            a = torch.rand(n)
            b = torch.randn(n, device="cuda")
            c = torch.randint(0, 5, (n,))
            d = torch.randperm(n)
            e = torch.multinomial(p, 1)
            g = p.multinomial(1)
            x.uniform_()
            x.normal_(0.0, 1.0)
            x.exponential_()
            h = torch.normal(0.0, 1.0, (n,))
            k = torch.rand(n, generator=None)
            torch.nn.init.normal_(x)
            return a, b, c, d, e, g, h, k
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 12
    assert all("no `generator=`" in f.message for f in hits)


def test_gen_draws_with_a_generator_are_clean():
    report = run_source("""
        import numpy as np
        import torch

        def f(x, p, n, gen):
            a = torch.rand(n, generator=gen)
            b = p.multinomial(1, generator=gen)
            x.uniform_(-1.0, 1.0, generator=gen)
            rng = np.random.default_rng(0)
            c = rng.normal(size=3)
            d = rng.multinomial(5, [0.5, 0.5])
            return a, b, c, d

        def g(rng: np.random.Generator):
            return rng.multinomial(3, [1.0])
    """, rules=_G)
    assert not report.findings


def test_gen_kw_dict_holding_generator_is_clean():
    # The `models/model.py` `real_batch` idiom, and a dict literal.
    report = run_source("""
        import torch

        def f(gen, b, s):
            kw = dict(generator=gen, device=gen.device)
            toks = torch.randint(0, 9, (b, s), dtype=torch.int32, **kw)
            extra = {"generator": gen}
            return toks, torch.randn((b, s), **extra), torch.rand(3, **{"generator": gen})
    """, rules=_G)
    assert not report.findings


def test_gen_kw_dict_without_generator_fires():
    report = run_source("""
        import torch

        def f(b):
            kw = dict(device="cpu", dtype=torch.float32)
            return torch.rand(b, **kw)
    """, rules=_G)
    assert len(rule_hits(report, "generator-hygiene")) == 1


def test_gen_unresolvable_kw_is_not_flagged():
    report = run_source("""
        import torch

        def f(b, **kw):
            return torch.rand(b, **kw)

        def g(b, opts):
            return torch.rand(b, **opts)
    """, rules=_G)
    assert not report.findings


def test_gen_global_seeding_fires():
    report = run_source("""
        import torch

        def setup(seed):
            torch.manual_seed(seed)
            torch.cuda.manual_seed_all(seed)
            return torch.seed()

        def fine(seed):
            return torch.Generator().manual_seed(seed)
    """, rules=_G)
    hits = rule_hits(report, "generator-hygiene")
    assert len(hits) == 3
    assert all("global generator" in f.message for f in hits)


# ---------------------------------------------------------------------------
# cache-args-hashable: the counterparts of the reference's jit cases
# ---------------------------------------------------------------------------

_CACHE_PRELUDE = """
    import dataclasses
    import functools

    @dataclasses.dataclass
    class MutableCfg:
        a: int = 0

    @dataclasses.dataclass(frozen=True)
    class FrozenCfg:
        a: int = 0
"""

_C = [CacheArgsHashable()]


def test_cache_nonfrozen_dataclass_fires():
    report = run_source(_CACHE_PRELUDE + """
    @functools.lru_cache(maxsize=None)
    def bad(cfg: MutableCfg, x):
        return x * cfg.a
    """, rules=_C)
    hits = rule_hits(report, "cache-args-hashable")
    assert len(hits) == 1
    assert "non-frozen dataclass" in hits[0].message


def test_cache_frozen_dataclass_is_clean():
    report = run_source(_CACHE_PRELUDE + """
    @functools.cache
    def good(cfg: FrozenCfg, x, flag: bool = False):
        return x * cfg.a if flag else x
    """, rules=_C)
    assert not report.findings


def test_cache_dict_annotation_and_mutable_default_fire():
    report = run_source(_CACHE_PRELUDE + """
    @functools.lru_cache(maxsize=256)
    def bad(x, *, opts: dict, extras=[]):
        return x
    """, rules=_C)
    msgs = [f.message for f in rule_hits(report, "cache-args-hashable")]
    assert any("annotated dict" in m for m in msgs)
    assert any("mutable literal" in m for m in msgs)


def test_cache_every_decorator_spelling_is_checked():
    report = run_source(_CACHE_PRELUDE + """
    from functools import cache, lru_cache
    from functools import lru_cache as memo

    @lru_cache
    def a(x: list):
        return x

    @lru_cache()
    def b(x: list):
        return x

    @cache
    def c(x: list):
        return x

    @memo(maxsize=8)
    def d(x: list):
        return x

    def not_cached(x: list):
        return x
    """, rules=_C)
    assert len(rule_hits(report, "cache-args-hashable")) == 4


def test_cache_optional_annotations():
    report = run_source(_CACHE_PRELUDE + """
    from typing import Optional

    @functools.lru_cache(maxsize=None)
    def good(cfg: Optional[FrozenCfg], x: "int | None" = None):
        return x

    @functools.lru_cache(maxsize=None)
    def bad(cfg: Optional[MutableCfg], rows: "list | None" = None):
        return rows
    """, rules=_C)
    hits = rule_hits(report, "cache-args-hashable")
    assert len(hits) == 2 and all("`bad`" in f.message for f in hits)


def test_cache_dataclass_index_is_project_wide():
    defs = engine.Module(Path("cfgs.py"), "cfgs.py", textwrap.dedent("""
        import dataclasses

        @dataclasses.dataclass
        class Plan:
            n: int = 0
    """))
    use = engine.Module(Path("use.py"), "use.py", textwrap.dedent("""
        import functools
        from cfgs import Plan

        @functools.lru_cache(maxsize=None)
        def size(plan: Plan) -> int:
            return plan.n
    """))
    report = analyze([defs, use], _C)
    assert [(f.path, f.line) for f in report.findings] == [("use.py", 6)]


# ---------------------------------------------------------------------------
# cuda-smem-budget: the counterparts of the reference's tile-budget cases
# ---------------------------------------------------------------------------

_S = [CudaSmemBudget()]

_CU_PRELUDE = """
    #include <cuda_runtime.h>

    namespace {

    constexpr int kThreads = 256;
    constexpr int kMaxSmem = 232448;  // bytes a block can opt into

    __global__ void __launch_bounds__(kThreads) body(float* out, int k) {
      extern __shared__ float smem[];
      out[threadIdx.x] = smem[threadIdx.x % k];
    }
"""

# The parent's K > 32 launch (`lda_gibbs.cu:605-611` before the opt-in),
# verbatim inside its function.
_LDA_PARENT = """
    template <typename T, bool kBatched, bool kPhilox, int kCodeBits>
    __global__ void __launch_bounds__(kThreads)
    resample_warp_kernel(const int32_t* __restrict__ docs_, int n, int k) {
      extern __shared__ float smem[];  // (K,) totals, then (K,) their logs
    }

    constexpr int kWarpTokens = 4;

    template <typename T, bool kBatched, bool kPhilox, int kCodeBits>
    cudaError_t launch_body(const int32_t* docs, int32_t* z_out, int m, int n, int d, int v,
                            int k, cudaStream_t stream) {
      if (k <= 32) {
        return cudaSuccess;
      } else {
        const long long per = static_cast<long long>(kThreads / 32) * kWarpTokens;
        const dim3 grid(static_cast<unsigned>((n + per - 1) / per), static_cast<unsigned>(m));
        const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float);
        resample_warp_kernel<T, kBatched, kPhilox, kCodeBits><<<grid, kThreads, smem, stream>>>(
            docs, words, z, weights, dt, wt, codes, w_scales, tt, noise, keys, seed, offset, z_out,
            n, d, v, k, alpha, beta, beta_bar, scale, vec);
      }
      return cudaGetLastError();
    }
"""


def _cu(body: str) -> str:
    return _CU_PRELUDE + textwrap.dedent(body) + "\n}  // namespace\n"


def test_smem_over_default_without_opt_in_fires():
    report = run_source(_cu("""
        cudaError_t run(float* out, int k, size_t bytes, cudaStream_t st) {
          body<<<1, kThreads, 65536, st>>>(out, k);
          body<<<1, kThreads, bytes, st>>>(out, k);
          body<<<1, kThreads, 48 * 1024, st>>>(out, k);
          body<<<1, kThreads>>>(out, k);
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    hits = rule_hits(report, "cuda-smem-budget")
    assert len(hits) == 2
    assert "65,536 B" in hits[0].message and "never opts it in" in hits[0].message
    assert "`bytes` bytes" in hits[1].message


def test_smem_direct_opt_in_is_clean():
    report = run_source(_cu("""
        cudaError_t run(float* out, int k, size_t bytes, cudaStream_t st) {
          static const cudaError_t ok =
              cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
          if (ok != cudaSuccess) return ok;
          body<<<1, kThreads, bytes, st>>>(out, k);
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    assert not report.findings


def test_smem_opt_in_through_a_helper_and_an_alias_is_clean():
    report = run_source(_cu("""
        template <typename K>
        cudaError_t opt_in(K kern) {
          return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        }

        cudaError_t run(float* out, int k, size_t bytes, cudaStream_t st) {
          auto kern = body;
          static const cudaError_t ok = opt_in(kern);
          if (ok != cudaSuccess) return ok;
          kern<<<1, kThreads, bytes, st>>>(out, k);
          body<<<1, kThreads, bytes, st>>>(out, k);
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    assert not report.findings


def test_smem_opt_in_above_the_card_fires():
    report = run_source(_cu("""
        cudaError_t run(float* out, int k, size_t bytes, cudaStream_t st) {
          cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, 256 * 1024);
          body<<<1, kThreads, bytes, st>>>(out, k);
          body<<<1, kThreads, 240 * 1024, st>>>(out, k);
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    msgs = [f.message for f in rule_hits(report, "cuda-smem-budget")]
    assert len(msgs) == 2
    assert any("opts `body` into 262,144 B" in m for m in msgs)
    assert any("asks for 245,760 B" in m for m in msgs)


def test_smem_static_arrays_over_budget_fire():
    source = _cu("""
        constexpr int kRows = 8192;

        __global__ void big(float* out) {
          __shared__ float a[kRows];
          __shared__ __align__(16) float b[kRows / 2], c[kRows / 2];
          out[threadIdx.x] = a[threadIdx.x] + b[0] + c[0];
        }

        __global__ void fits(float* out) {
          __shared__ float a[kRows - 4], b[4096];
          __shared__ double d[2];  // 48 KB exactly
          out[threadIdx.x] = a[0] + b[0] + d[0];
        }

        template <int TILE>
        __global__ void tiled(float* out) {
          __shared__ float t[TILE][TILE + 1];
          out[0] = t[0][0];
        }
    """)
    report = run_source(source, rules=_S, relpath="k.cu")
    msgs = [f.message for f in rule_hits(report, "cuda-smem-budget")]
    assert len(msgs) == 2
    assert any("`big` declares 65,536 B" in m for m in msgs)
    assert any("`tiled`" in m and "(assumed TILE)" in m for m in msgs)
    cfg = AnalysisConfig(smem_assume={"TILE": 32})
    report = run_source(source, rules=_S, relpath="k.cu", config=cfg)
    assert [f.message.split(" declares")[0] for f in report.findings] == ["kernel `big`"]
    mod = engine.CudaSource(Path("k.cu"), "k.cu", textwrap.dedent(source))
    sizes = static_smem(mod, cfg)
    assert sizes["fits"] == {"bytes": 49152, "assumed": [], "line": sizes["fits"]["line"]}
    assert sizes["tiled"]["bytes"] == 32 * 33 * 4 and sizes["tiled"]["assumed"] == ["TILE"]
    assert sizes["body"]["bytes"] == 0  # dynamic shared memory is not static


def test_smem_block_of_whole_warps():
    report = run_source(_cu("""
        constexpr int kOdd = 100;

        cudaError_t run(float* out, int k, int threads, cudaStream_t st) {
          body<<<1, 96, 0, st>>>(out, k);
          body<<<dim3(4, 2), dim3(32, 4), 0, st>>>(out, k);
          body<<<1, threads, 0, st>>>(out, k);
          body<<<1, kOdd, 0, st>>>(out, k);
          body<<<1, 2048, 0, st>>>(out, k);
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    msgs = [f.message for f in rule_hits(report, "cuda-smem-budget")]
    assert len(msgs) == 2
    assert any("blocks of 100 threads" in m for m in msgs)
    assert any("blocks of 2048 threads" in m for m in msgs)


def test_smem_fires_on_the_parents_lda_gibbs_launch():
    source = _cu(_LDA_PARENT)
    report = run_source(source, rules=_S, relpath="lda_gibbs.cu")
    hits = rule_hits(report, "cuda-smem-budget")
    assert len(hits) == 1
    line = textwrap.dedent(source).splitlines()[hits[0].line - 1]
    assert "resample_warp_kernel<T, kBatched, kPhilox, kCodeBits><<<" in line
    assert "`resample_warp_kernel` in `launch_body`" in hits[0].message


def test_smem_is_silent_on_the_repaired_sources():
    report = engine.analyze_paths([REPO / "src" / "repro_torch" / "kernels"], root=REPO,
                                  rules=_S)
    assert report.files_checked >= 5 and report.clean, report.render_text()
    assert not report.suppressed


def test_smem_macro_launches_and_cuda_suppressions():
    report = run_source(_cu("""
        cudaError_t run(float* out, int k, size_t bytes, cudaStream_t st) {
        #define LAUNCH(B)                                  \\
          do {                                             \\
            body<<<1, kThreads, (B), st>>>(out, k);        \\
          } while (0)
          LAUNCH(bytes);
        #undef LAUNCH
          body<<<1, kThreads, bytes, st>>>(out, k);  // vedalint: disable=cuda-smem-budget -- fixture
          // vedalint: disable=cuda-smem-budget -- fixture, a standalone
          // form whose statement wraps
          body<<<1, kThreads,
                 bytes, st>>>(out, k);
          body<<<1, kThreads, bytes, st>>>(out, k);  // not covered
          return cudaGetLastError();
        }
    """), rules=_S, relpath="k.cu")
    assert len(report.suppressed) == 2
    assert [f.line for f in report.findings] == sorted(f.line for f in report.findings)
    assert len(report.findings) == 2  # the macro's launch and the uncovered one


# ---------------------------------------------------------------------------
# CLI: exit codes, JSON report, per-rule fixture violations
# ---------------------------------------------------------------------------

_CLI_FIXTURES = {
    "generator-hygiene": ("fixture.py", """
        import torch

        def f(n):
            return torch.rand(n)
    """),
    "cache-args-hashable": ("fixture.py", _CACHE_PRELUDE + """
    @functools.lru_cache(maxsize=None)
    def bad(cfg: MutableCfg, x):
        return x
    """),
    "protocol-conformance": ("fixture.py", """
        KINDS = ("ping", "fit")

        class ToyServer:
            def _handle_ping(self, payload):
                return {}

        class ToyClient:
            def ping(self):
                return self._call("ping")
    """),
    "cuda-smem-budget": ("fixture.cu", _cu(_LDA_PARENT)),
    "quant-branch-ban": ("fixture.py", """
        def f(cfg, x):
            return x * 2 if cfg.w_bits is not None else x
    """),
    "obs-metric-consistency": ("fixture.py", """
        from repro_torch.obs import metrics

        A = metrics.counter("vedalia_dup_total", "Dup.")
        B = metrics.gauge("vedalia_dup_total", "Dup.")
    """),
}


def test_cli_fixture_map_covers_every_rule():
    assert sorted(_CLI_FIXTURES) == sorted(rule_ids())
    assert rule_ids() == ("cache-args-hashable", "cuda-smem-budget", "generator-hygiene",
                          "obs-metric-consistency", "protocol-conformance",
                          "quant-branch-ban")


@pytest.mark.parametrize("rule_id", sorted(_CLI_FIXTURES))
def test_cli_exits_nonzero_on_violation(rule_id, tmp_path, capsys):
    name, source = _CLI_FIXTURES[rule_id]
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    rc = cli_main([str(p), "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert list(out["counts"]) == [rule_id], out["counts"]


def test_cli_clean_file_exits_zero(tmp_path, capsys):
    p = tmp_path / "clean.py"
    p.write_text("def f(x):\n    return x + 1\n")
    q = tmp_path / "clean.cu"
    q.write_text("__global__ void k(float* x) { x[threadIdx.x] = 0.0f; }\n")
    assert cli_main([str(tmp_path)]) == 0
    assert "0 findings" in capsys.readouterr().out


def test_cli_json_output_file(tmp_path, capsys):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(_CLI_FIXTURES["quant-branch-ban"][1]))
    report_path = tmp_path / "out" / "report.json"
    rc = cli_main([str(p), "--format", "json", "--output", str(report_path)])
    capsys.readouterr()
    assert rc == 1
    data = json.loads(report_path.read_text())
    assert data["version"] == 1 and data["tool"] == "vedalint"
    assert data["files_checked"] == 1
    f = data["findings"][0]
    assert set(f) == {"rule", "path", "line", "message", "hint"}


def test_cli_rules_filter(tmp_path, capsys):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(_CLI_FIXTURES["quant-branch-ban"][1]))
    assert cli_main([str(p), "--rules", "generator-hygiene"]) == 0
    assert cli_main([str(p), "--rules", "quant-branch-ban,cuda-smem-budget"]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli_main([str(p), "--rules", "prng-key-hygiene"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_smem_assume(tmp_path, capsys):
    p = tmp_path / "tiled.cu"
    p.write_text("template <int TILE>\n__global__ void k(float* o) {\n"
                 "  __shared__ float t[TILE][TILE];\n  o[0] = t[0][0];\n}\n")
    assert cli_main([str(p)]) == 1  # TILE assumed 128: 64 KB
    assert "assumed TILE" in capsys.readouterr().out
    assert cli_main([str(p), "--smem-assume", "TILE=64"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli_main([str(p), "--smem-assume", "TILE"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in rule_ids():
        assert rid in out


# ---------------------------------------------------------------------------
# imports: the standard library only
# ---------------------------------------------------------------------------

def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: relative import"
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_package_imports_only_the_standard_library(path):
    bad = {m for m in _imported(path)
           if m.split(".")[0] not in sys.stdlib_module_names
           and not m.startswith("repro_torch.analysis")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_package_loads_no_framework():
    code = ("import sys\nimport repro_torch.analysis, repro_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'numpy', 'repro'))\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
