"""The ssm family (RWKV6, `rwkv6-1.6b`) serving path on the port vs the JAX
reference.

`configs.get("rwkv6-1.6b").reduced()` on both sides, the reference's weights
carried across by `models.convert.params_from_reference`: the config field
for field, the schema (with its `lora = max(32, d // 32)`), the full
config's parameter count, the time mix (prefill: the chunk_scan wrapper's
general entry in rwkv6 mode at chunk 32, its plain version on the CPU), its
one-token step and the channel mix against the reference's functions
directly, then prefill logits and caches, three teacher-forced decode steps
from each side's own cache, one from the reference's cache, and the port's
prefill/decode consistency. Tolerances as `tests/_torch_models.py` states
them; the mixes alone run at the reference's chunk_scan tolerances in bf16.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_models import (CACHE_TOL, CONSISTENCY_TOL, LOGITS_TOL,  # noqa: E402
                           decode_from_reference_cache, model, prefill_decode_rels, rel,
                           schema_rows, teacher_forced)
from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.chunk_scan import ops as cs_ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params, ssm  # noqa: E402

NAME = "rwkv6-1.6b"
PROMPT, CACHE, STEPS = 62, 96, 3  # 62 tokens: the scan runs at chunk 31 (62's divisor)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    ref, cfg = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.arch_type == "ssm" and cfg.ssm_variant == "rwkv6"


@pytest.mark.parametrize("reduced", [False, True])
def test_schema_matches_the_reference(reduced):
    c_r, c = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        c_r, c = c_r.reduced(), c.reduced()
    rows = schema_rows(M.build_schema(c))
    assert rows == schema_rows(ref_model.build_schema(c_r))
    lora = max(32, c.d_model // 32)
    assert rows["blk/att/w_lora_a"][0] == (c.num_layers, c.d_model, lora)
    assert rows["blk/att/w0"][2:] == ("decay", "float32")
    assert rows["blk/att/u"][2:] == ("small_normal", "float32")


def test_full_config_parameter_count():
    """1.48 B parameters at the published widths (the reference's range is
    1.2-2.2 B); the float32 leaves are w0 and u."""
    full = configs.get(NAME)
    n = params.count_params(M.build_schema(full))
    assert n == ref_params.count_params(ref_model.build_schema(ref_configs.get(NAME)))
    assert n == 1_483_231_232
    f32 = full.num_layers * 2 * full.ssm_heads * full.ssm_head_dim
    assert params.tree_bytes(M.build_schema(full)) == 2 * n + 2 * f32


def test_init_params_kinds_and_seed():
    _, cfg, p_r, _ = model(NAME)
    mine = dict(params.leaves(M.init_model(cfg, seed=3, device="cpu")))
    other = dict(params.leaves(M.init_model(cfg, seed=4, device="cpu")))
    schema = dict(params.leaves(M.build_schema(cfg)))
    ref = dict(params.leaves(p_r))
    assert set(mine) == set(schema) == set(ref)
    for path, t in mine.items():
        d = schema[path]
        assert t.shape == d.shape and t.dtype == params.DTYPES[d.dtype], path
        if d.init == "zeros":
            assert not t.any()
            continue
        assert not torch.equal(t, other[path]), path
        if d.init == "decay":
            assert float(t.min()) >= -6.0 and float(t.max()) <= -2.0
            continue
        scale = 1.0 / np.sqrt(max(params._fan_in(d.shape), 1))
        scale *= 0.1 if d.init == "small_normal" else 1.0
        assert float(t.float().abs().max()) <= 2.0 * scale * 1.01, path
        if t.numel() > 10_000:
            ref_t = np.asarray(ref[path], np.float32)
            assert abs(float(t.float().std()) / ref_t.std() - 1) < 0.05, path


def _layer0():
    """Layer 0's time- and channel-mix weights on both sides, and a (2, 40,
    D) bf16 input with a nonzero shifted-in token."""
    cfg_r, cfg, p_r, p = model(NAME)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    prev = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    pr = jax.tree.map(lambda a: a[0], p_r["blk"])
    pt = M._layer(p["blk"], 0)
    xj, prevj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(prev, jnp.bfloat16)
    xt, prevt = torch.tensor(x).bfloat16(), torch.tensor(prev).bfloat16()
    return cfg_r, cfg, pr, pt, (xj, prevj), (xt, prevt)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_the_reference(with_state):
    """The prefill's time mix (the port: `chunk_scan`'s general entry at
    chunk 32, 40 tokens -> chunk 20) against the reference's jnp chunked
    scan, from a zero or a given state."""
    cfg_r, cfg, pr, pt, (xj, prevj), (xt, prevt) = _layer0()
    h, dk = cfg.ssm_heads, cfg.ssm_head_dim
    s0 = (np.random.default_rng(8).standard_normal((2, h, dk, dk)) * 0.1).astype(np.float32)
    sj, st = (jnp.asarray(s0), torch.tensor(s0)) if with_state else (None, None)
    y_r, (last_r, S_r) = ref_ssm.rwkv6_time_mix(pr["att"], xj, prevj, sj, cfg_r)
    y, (last, S) = ssm.rwkv6_time_mix(pt["att"], xt, prevt, st, cfg)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    assert rel(y.float().numpy(), y_r) < CACHE_TOL
    assert rel(S.numpy(), S_r) < CACHE_TOL
    np.testing.assert_array_equal(last.float().numpy(), np.asarray(last_r, np.float32))


def test_time_mix_calls_the_general_entry(monkeypatch):
    """Prefill's scan goes through the kernel wrapper `ops.chunk_scan` in
    rwkv6 mode with the bonus u and chunk 32."""
    calls = []
    real = cs_ops.chunk_scan

    def spy(w, k, *rest, **kw):
        calls.append((w.dtype, k.dtype, rest[-1] is not None, kw["include_current"],
                      kw["chunk"]))
        return real(w, k, *rest, **kw)

    monkeypatch.setattr(cs_ops, "chunk_scan", spy)
    _, cfg, _, pt, _, (xt, prevt) = _layer0()
    ssm.rwkv6_time_mix(pt["att"], xt, prevt, None, cfg)
    assert calls == [(torch.float32, torch.bfloat16, True, False, 32)]


def test_time_mix_step_matches_the_reference():
    cfg_r, cfg, pr, pt, (xj, prevj), (xt, prevt) = _layer0()
    h, dk = cfg.ssm_heads, cfg.ssm_head_dim
    s0 = (np.random.default_rng(9).standard_normal((2, h, dk, dk)) * 0.1).astype(np.float32)
    y_r, (x_r, S_r) = ref_ssm.rwkv6_time_mix_step(pr["att"], xj[:, :1], prevj,
                                                  jnp.asarray(s0), cfg_r)
    y, (x1, S) = ssm.rwkv6_time_mix_step(pt["att"], xt[:, :1], prevt, torch.tensor(s0), cfg)
    assert y.shape == (2, 1, cfg.d_model) and S.shape == (2, h, dk, dk)
    assert rel(y.float().numpy(), y_r) < CACHE_TOL
    assert rel(S.numpy(), S_r) < CACHE_TOL
    np.testing.assert_array_equal(x1.float().numpy(), np.asarray(x_r, np.float32))


@pytest.mark.parametrize("tokens_in", [40, 1])
def test_channel_mix_matches_the_reference(tokens_in):
    _, _, pr, pt, (xj, prevj), (xt, prevt) = _layer0()
    y_r, last_r = ref_ssm.rwkv6_channel_mix(pr["ffn"], xj[:, :tokens_in], prevj)
    y, last = ssm.rwkv6_channel_mix(pt["ffn"], xt[:, :tokens_in], prevt)
    assert rel(y.float().numpy(), y_r) < CACHE_TOL
    np.testing.assert_array_equal(last.float().numpy(), np.asarray(last_r, np.float32))


def test_prefill_logits_and_caches_match_the_reference():
    _, cfg, _, _ = model(NAME)
    (c_r, l_r), (c, lg) = teacher_forced(NAME, PROMPT, CACHE, STEPS)[0]
    assert lg.shape == (2, cfg.vocab_size) and np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    desc = M._cache_desc(cfg, 2, CACHE)
    assert set(c) == set(c_r) == set(desc) == {"S", "ax", "fx"}
    for key, a in c_r.items():
        assert c[key].shape == a.shape == desc[key][0], key
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_teacher_forced_decode_matches_the_reference(step):
    (c_r, l_r), (c, lg) = teacher_forced(NAME, PROMPT, CACHE, STEPS)[step]
    assert np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


def test_decode_from_the_reference_cache():
    c_r, l_r, c, lg = decode_from_reference_cache(NAME, PROMPT, CACHE)
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("prompt", [40, 64])
def test_prefill_decode_consistency(prompt):
    """Prefill then two decode steps, each against the full forward over the
    tokens up to it; 64 tokens run two whole chunks of 32."""
    assert max(prefill_decode_rels(NAME, prompt, 96, 2)) < CONSISTENCY_TOL


def test_cache_layout():
    cfg = configs.get(NAME)
    desc = M._cache_desc(cfg, 2, 8192)
    n, h, dk, d = cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_model
    assert desc == {"S": ((n, 2, h, dk, dk), torch.float32),
                    "ax": ((n, 2, 1, d), torch.bfloat16), "fx": ((n, 2, 1, d), torch.bfloat16)}
    small = M.init_cache(cfg.reduced(), 2, 80, device="cpu")
    assert all(not t.any() for t in small.values())
