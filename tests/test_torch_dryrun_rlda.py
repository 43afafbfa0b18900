"""The port's production RLDA sweep (`launch.dryrun_rlda`) on the CPU.

The reference module sets `XLA_FLAGS` when imported (512 placeholder
devices); it is imported here with that variable restored at once, before
any JAX backend starts, so no other test sees it. The port's config and
abstract builds equal the reference's field for field; `run_one` at a
small size (a few thousand tokens, K 16) gives, bit for bit, the sweeps
`core.gibbs.sweep` and `core.distributed.make_client_server_sweep` give
from the same generator; the invariants hold and catch a broken count.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import codec, distributed, gibbs  # noqa: E402
from repro_torch.core.types import LDAConfig, init_state  # noqa: E402
from repro_torch.launch import dryrun_rlda as R  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.pserver import comm as comm_lib  # noqa: E402

SMALL = LDAConfig(num_topics=16, vocab_size=400 * 5, num_docs=64, w_bits=8)
TOKENS, BLOCK = 4096, 1024


@pytest.fixture(scope="module")
def ref_rlda():
    prev = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun_rlda")
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in ("num_topics", "vocab_size", "num_docs", "alpha",
                                         "beta", "w_bits", "quant", "beta_bar")}


@pytest.mark.parametrize("w_bits", [8, None, 4])
def test_production_config_equals_the_reference(ref_rlda, w_bits):
    got, want = R.production_lda_config(w_bits), ref_rlda.production_lda_config(w_bits)
    assert _fields(got) == _fields(want)
    assert (got.quant_spec.live_fixed, got.quant_spec.w_bits) == (
        want.quant_spec.live_fixed, want.quant_spec.w_bits)
    assert (got.num_topics, got.vocab_size, got.num_docs) == (256, 250_000, 200_000)


def _shape_dtypes(obj) -> dict:
    return {f.name: (tuple(getattr(obj, f.name).shape),
                     str(getattr(obj, f.name).dtype).replace("torch.", ""))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("w_bits", [8, None])
@pytest.mark.parametrize("num_tokens", [16_777_216, 4096])
def test_abstract_builds_equal_the_reference(ref_rlda, w_bits, num_tokens):
    cfg, ref_cfg = R.production_lda_config(w_bits), ref_rlda.production_lda_config(w_bits)
    corpus, state = R.abstract_corpus(cfg, num_tokens), R.abstract_state(cfg, num_tokens)
    assert all(t.device.type == "meta" for t in (*vars(corpus).values(), *vars(state).values()))
    assert _shape_dtypes(corpus) == _shape_dtypes(ref_rlda.abstract_corpus(ref_cfg, num_tokens))
    assert _shape_dtypes(state) == _shape_dtypes(ref_rlda.abstract_state(ref_cfg, num_tokens))
    counts = "int32" if w_bits else "float32"
    assert _shape_dtypes(state)["n_wt"] == ((250_000, 256), counts)


def test_synthetic_corpus_layout():
    gen = torch.Generator().manual_seed(3)
    corpus = R.synthetic_corpus(SMALL, 20_000, gen)
    docs, words, w = (t.numpy() for t in (corpus.docs, corpus.words, corpus.weights))
    assert docs.dtype == np.int32 and words.dtype == np.int32 and w.dtype == np.float32
    assert np.all(np.diff(docs) >= 0)  # reviews laid out contiguously
    assert docs.min() >= 0 and docs.max() < SMALL.num_docs
    assert words.min() >= 0 and words.max() < SMALL.vocab_size
    # one tier and one weight a review
    for d in np.unique(docs)[:10]:
        sel = docs == d
        assert len(np.unique(words[sel] % 5)) == 1 and len(np.unique(w[sel])) == 1
    assert np.all((w > 0) & (w <= 1))
    # Zipf: the most common base word is id 0, at about 1 / H(400) of tokens
    base = np.bincount(words // 5, minlength=400)
    assert base.argmax() == 0
    assert abs(base[0] / len(words) - 1 / np.sum(1.0 / np.arange(1, 401))) < 0.02


def _replay(seed=0):
    gen = torch.Generator().manual_seed(seed)
    corpus = R.synthetic_corpus(SMALL, TOKENS, gen)
    state = codec.encode_state(SMALL, init_state(SMALL, corpus, gen))
    return gen, corpus, state


def test_token_parallel_run_is_core_gibbs_sweep_bit_for_bit(tmp_path):
    rec = R.run_one(False, num_tokens=TOKENS, block=BLOCK, device="cpu", cfg=SMALL,
                    outdir=str(tmp_path))
    gen, corpus, state = _replay()
    for _ in range(4):  # the warm-up and three timed sweeps
        state = gibbs.sweep(SMALL, state, corpus, gen, BLOCK)
    got = rec["result"]
    for name in ("z", "n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(got, name), getattr(state, name)), name
    assert rec["invariants"]["ok"]
    assert rec["mode"] == "token_parallel" and rec["launches_per_sweep"] == 0  # no card
    saved = json.loads((tmp_path / "rlda-amazon__sweep_0m__pod16x16.json").read_text())
    assert saved["sweep_ms"] == rec["sweep_ms"] and "result" not in saved


def test_client_server_run_is_the_sweep_called_directly():
    rec = R.run_one(False, num_tokens=TOKENS, block=BLOCK, device="cpu", cfg=SMALL,
                    client_server=True, workers=2, sync_every=2, outdir=None)
    gen, corpus, state = _replay()
    n_dt, n_wt, _ = codec.decode_counts(SMALL, state)
    docs_l, words, z, wts, n_dt_sh, inv = distributed.shard_corpus(
        SMALL, corpus, state.z, n_dt, 2)
    step = distributed.make_client_server_sweep(SMALL, comm_lib.make(2), block=BLOCK,
                                                sync_every=2)
    for _ in range(4):
        z, n_dt_sh, n_wt, n_t = step(docs_l, words, z, wts, n_dt_sh, n_wt, gen)
    want = (z[inv], n_dt_sh[:SMALL.num_docs], n_wt, n_t)
    for got, w in zip(rec["result"], want):
        assert torch.equal(got, w)
    assert rec["invariants"]["ok"] and rec["workers"] == 2 and rec["step_sweeps"] == 2
    assert rec["sync_bytes_per_device"] == int(2 * 1 / 2 * SMALL.vocab_size * 16 * 4)


def test_invariants_catch_a_broken_count():
    gen, corpus, state = _replay()
    n_dt, n_wt, n_t = codec.decode_counts(SMALL, state)
    assert R.check_counts(SMALL, corpus, state.z, n_dt, n_wt, n_t)["ok"]
    bad = n_wt.clone()
    bad[3, 5] += 0.01  # past a stored unit (1/512) and any float error
    assert not R.check_counts(SMALL, corpus, state.z, n_dt, bad, n_t)["ok"]
    z = state.z.clone()
    z[0] = (z[0] + 1) % SMALL.num_topics
    assert not R.check_counts(SMALL, corpus, z, n_dt, n_wt, n_t)["ok"]
    assert not R.check_counts(SMALL, corpus, state.z, n_dt, n_wt, n_t * 1.01)["ok"]


def test_static_bytes_under_the_reference_specs():
    cfg, n = R.production_lda_config(), 16_777_216
    pod = R.static_per_device(cfg, n, mesh_lib.make_production_mesh(), shard_docs=True,
                              shard_vocab=False)
    assert pod["z_bytes"] == pod["docs_bytes"] == n // 16 * 4
    assert pod["n_dt_bytes"] == 200_000 // 16 * 256 * 4
    assert pod["n_wt_bytes"] == 250_000 * 256 * 4  # the replicated model cache
    pod2 = R.static_per_device(cfg, n, mesh_lib.make_production_mesh(multi_pod=True),
                               shard_docs=False, shard_vocab=True)
    assert pod2["weights_bytes"] == n // 32 * 4
    assert pod2["n_dt_bytes"] == 200_000 * 256 * 4
    assert pod2["n_wt_bytes"] == 250_000 // 16 * 256 * 4
    assert pod2["total_bytes"] == sum(v for k, v in pod2.items() if k != "total_bytes")


def test_bound_counts_each_input_and_output_once():
    cfg = R.production_lda_config()
    n = 16_777_216
    corpus, state = R.abstract_corpus(cfg, n), R.abstract_state(cfg, n)
    b = R.sweep_bound(cfg, corpus, state)
    state_bytes = n * 4 + (200_000 + 250_000) * 256 * 4 + 256 * 4
    assert b["bytes"] == 3 * n * 4 + 2 * state_bytes
    assert b["ops"] == n * 256 * R.SCORE_OPS
    noisy = R.sweep_bound(cfg, corpus, state, noise_bytes=2 * n * 256 * 4)
    assert noisy["bytes"] - b["bytes"] == 2 * n * 256 * 4 and noisy["bottleneck"] == "memory_s"


def test_count_headroom_reports_the_fixed_point_limit():
    cfg = R.production_lda_config()
    got = R.count_headroom(cfg, torch.tensor([[3.0, 40.5]]), torch.tensor([1000.0, 9.0]))
    assert got["fixed_scale"] == 512 and got["max_n_t_stored"] == 512_000
    assert got["fixed_limit_real"] == R.INT32_MAX / 512


def test_cli_on_the_cpu(tmp_path):
    rc = R.main(["--device", "cpu", "--tokens", "4096", "--block", "2048",
                 "--outdir", str(tmp_path), "--tag", "cpu"])
    assert rc == 0
    rec = json.loads((tmp_path / "rlda-amazon__sweep_0m__pod16x16__cpu.json").read_text())
    assert rec["config"]["num_topics"] == 256 and rec["invariants"]["ok"]
