"""The audio family's serving path (`whisper-base`) on the port vs the JAX reference.

`whisper-base` `reduced()` on both sides (2 encoder and 2 decoder layers,
16 frames, d_model 128, GQA with 2 kv heads), the reference's weights
carried across by `models.convert.params_from_reference`, the same random
frames (x 0.02, numpy seed) in bf16 on both sides: configs field for
field, schemas (reduced and full) and the full config's parameter count,
the sinusoids, `forward_hidden`, prefill logits and all four caches (the
self caches `k`/`v` and the encoder caches `xk`/`xv`), four
teacher-forced decode steps from each side's own cache and one from the
reference's, the port's own prefill/decode consistency, the decode step's
cross-attention over every encoder slot without a write, and an `Engine`
wave on the CPU with the zero frames the engine feeds. Tolerances as
`tests/_torch_models.py` states them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_models import (CACHE_TOL, CONSISTENCY_TOL, LOGITS_TOL,  # noqa: E402
                           decode_from_reference_cache, model, port_batch,
                           prefill_decode_rels, ref_batch, rel, schema_rows, teacher_forced,
                           tokens)
from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.models import convert, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

NAME = "whisper-base"
# 12 prompt tokens and four teacher-forced steps into a 32-slot self cache.
PROMPT, CACHE, STEPS = 12, 32, 4
FULL_PARAMS = 70_611_456  # the reference's range (tests/test_archs_smoke.py): 0.04-0.12 B


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _runs():
    return teacher_forced(NAME, PROMPT, CACHE, STEPS)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    ref, cfg = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.arch_type == "audio" and NAME in configs.names()


@pytest.mark.parametrize("reduced", [False, True])
def test_schema_matches_the_reference(reduced):
    c_r, c = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        c_r, c = c_r.reduced(), c.reduced()
    s = M.build_schema(c)
    assert schema_rows(s) == schema_rows(ref_model.build_schema(c_r))
    assert {"enc", "enc_ln_f", "dec"} <= set(s) and {"ln_cross", "xattn"} <= set(s["dec"])


def test_full_config_parameter_count():
    """0.0706 B parameters at the published widths, counted from the schema
    without allocating: the reference's count, inside its own range."""
    full = configs.get(NAME)
    n = params.count_params(M.build_schema(full))
    assert n == ref_params.count_params(ref_model.build_schema(ref_configs.get(NAME)))
    assert n == FULL_PARAMS and 0.04e9 <= n <= 0.12e9
    assert params.tree_bytes(M.build_schema(full)) == 2 * n  # every leaf bf16


def test_params_cross_exactly():
    _, _, p_r, p = model(NAME)
    back = dict(params.leaves(convert.cache_to_numpy(p)))
    for path, a in params.leaves(p_r):
        np.testing.assert_array_equal(back[path], np.asarray(a, np.float32))


@pytest.mark.parametrize("offset", [0, 7, 447])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sinusoid_matches_the_reference(offset, dtype):
    """Whisper's positions, computed in float32 and cast to the activations'
    type. The reference always casts to bf16, so both types are held to it
    within one bf16 unit at 1 (2^-8): its rounding."""
    got = M._sinusoid(5, 128, dtype, "cpu", offset=offset)
    want = np.asarray(ref_model._sinusoid(5, 128, offset=offset), np.float32)
    assert got.dtype == dtype and got.shape == (5, 128)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -8, rtol=0)


def test_forward_hidden_matches_the_reference():
    """The encoder and decoder over 12 tokens and the random frames: the
    final hidden state within the caches' tolerance."""
    cfg_r, cfg, p_r, p = model(NAME)
    toks = tokens(cfg, PROMPT)
    h_r, _, _ = ref_model.forward_hidden(p_r, cfg_r, ref_batch(cfg, toks), train=False)
    h, _, raw = M.forward_hidden(p, cfg, port_batch(cfg, toks))
    assert raw is None and h.shape == (2, PROMPT, cfg.d_model) and h.dtype == torch.bfloat16
    assert rel(h.float().numpy(), np.asarray(h_r, np.float32)) < CACHE_TOL


def test_prefill_logits_and_caches_match_the_reference():
    _, cfg, _, _ = model(NAME)
    (c_r, l_r), (c, lg) = _runs()[0]
    assert lg.shape == (2, cfg.vocab_size) and np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    desc = M._cache_desc(cfg, 2, CACHE)
    assert set(c) == set(c_r) == set(desc) == {"k", "v", "xk", "xv"}
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    assert desc["xk"][0] == (cfg.num_layers, 2, cfg.encoder_tokens, hkv, hd)
    assert desc["k"][0] == (cfg.num_layers, 2, CACHE, hkv, hd)
    for key, a in c_r.items():
        assert c[key].shape == a.shape == desc[key][0], key
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_teacher_forced_decode_matches_the_reference(step):
    (c_r, l_r), (c, lg) = _runs()[step]
    assert np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


def test_decode_from_the_reference_cache():
    c_r, l_r, c, lg = decode_from_reference_cache(NAME, PROMPT, CACHE)
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("prompt", [1, 12])
def test_prefill_decode_consistency(prompt):
    """Prefill, then three decode steps: each equals the last logits of the
    full forward over the tokens up to it (the sinusoid at `pos`)."""
    assert max(prefill_decode_rels(NAME, prompt, CACHE, 3)) < CONSISTENCY_TOL


def test_cross_step_reads_every_frame_and_writes_none(monkeypatch):
    """A decode step calls decode_attn once a layer for the self cache
    (`length = pos + 1`) and once for the encoder cache (`length = pos =
    frames`), writes the new key into the self cache at `pos` and leaves
    `xk` / `xv` as they were."""
    _, cfg, _, p = model(NAME)
    toks = torch.tensor(tokens(cfg, PROMPT + 1))
    cache, _ = M.prefill(p, cfg, port_batch(cfg, toks[:, :PROMPT]), CACHE)
    before = {k: t.clone() for k, t in cache.items()}
    calls = []
    real = da_ops.decode_attention

    def filed(q, k_cache, v_cache, **kw):
        calls.append((k_cache.shape[1], kw["length"], kw["pos"]))
        return real(q, k_cache, v_cache, **kw)

    monkeypatch.setattr(da_ops, "decode_attention", filed)
    cache, _ = M.decode_step(p, cfg, cache, toks[:, PROMPT], PROMPT)
    frames = cfg.encoder_tokens
    assert calls == [(CACHE, PROMPT + 1, PROMPT), (frames, frames, frames)] * cfg.num_layers
    for key in ("xk", "xv"):
        assert torch.equal(cache[key], before[key]), key
    for key in ("k", "v"):
        assert torch.equal(cache[key][:, :, :PROMPT], before[key][:, :, :PROMPT])
        assert cache[key][:, :, PROMPT].any() and not before[key][:, :, PROMPT].any()


def test_the_frames_reach_the_logits():
    """Other frames give other logits: the decoder's cross-attention is live
    (it is not gated). With random weights it moves the logits by under 1%
    of their scale, inside the model tolerance, so the cross-attention is
    also held against the reference's alone (`test_cross_attention_...`);
    the port is deterministic, so any change shows the path."""
    _, cfg, _, p = model(NAME)
    batch = port_batch(cfg, tokens(cfg, PROMPT))
    _, lg = M.prefill(p, cfg, batch, CACHE)
    _, lg_zero = M.prefill(p, cfg, dict(batch, frames=torch.zeros_like(batch["frames"])), CACHE)
    assert rel(lg_zero.numpy(), lg.numpy()) > 1e-3


@pytest.mark.parametrize("layer", [0, 1])
def test_cross_attention_matches_the_reference(layer):
    """A decoder layer's cross-attention alone, on the same bf16 inputs: the
    full-sequence form (`_attn_full` with `cross_src`: its output and the
    keys and values it caches) and the one-token form over the encoder
    cache (`_attn_decode(cross=True)`), within the caches' tolerance."""
    _, cfg, p_r, p = model(NAME)
    rng = np.random.default_rng(layer)
    h, src = (rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 5, cfg.d_model), (2, cfg.encoder_tokens, cfg.d_model)))
    pr = {k: v[layer] for k, v in p_r["dec"]["xattn"].items()}
    pt = {k: v[layer] for k, v in p["dec"]["xattn"].items()}
    jb, tb = (lambda a: jnp.asarray(a, jnp.bfloat16)), (lambda a: torch.tensor(a).bfloat16())
    pos = jnp.broadcast_to(jnp.arange(5)[None], (2, 5))
    out_r, (k_r, v_r) = ref_model._attn_full(pr, jb(h), cfg, positions=pos,
                                             cross_src=jb(src))
    out, (k, v) = M._attn_full(pt, tb(h), cfg, positions=None, cross_src=tb(src))
    for got, want in ((out, out_r), (k, k_r), (v, v_r)):
        assert got.shape == want.shape
        assert rel(got.float().numpy(), np.asarray(want, np.float32)) < CACHE_TOL
    out1_r, _, _ = ref_model._attn_decode(pr, jb(h[:, :1]), cfg, k_r, v_r, 9, cross=True)
    out1, _, _ = M._attn_decode(pt, tb(h[:, :1]), cfg, k, v, 9, cross=True)
    assert rel(out1.float().numpy(), np.asarray(out1_r, np.float32)) < CACHE_TOL
    # The one-token form is the full form's first row: the same attention.
    assert rel(out1.float().numpy(), out[:, :1].float().numpy()) < CACHE_TOL


def test_engine_serves_a_wave_with_zero_frames():
    """`Engine` on the CPU: one wave of two requests, prefill with zero
    frames (as the reference's engine feeds them) and greedy decode through
    the cache; the tokens equal the port's own prefill and decode steps."""
    _, cfg, _, p = model(NAME)
    prompts = tokens(cfg, 6, seed=3)
    eng = Engine(cfg, p, cache_len=CACHE, max_batch=2, device="cpu")
    for i in range(2):
        eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=4))
    results = sorted(eng.run(), key=lambda r: r.uid)
    assert [r.wave_id for r in results] == [0, 0]

    zeros = torch.zeros(2, cfg.encoder_tokens, cfg.d_model, dtype=torch.bfloat16)
    with torch.inference_mode():
        cache, logits = M.prefill(p, cfg, {"tokens": torch.tensor(prompts), "frames": zeros},
                                  CACHE)
        want = []
        for i in range(4):
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok.numpy())
            cache, logits = M.decode_step(p, cfg, cache, tok, 6 + i)
    np.testing.assert_array_equal(np.stack([r.tokens for r in results]), np.stack(want, 1))


def test_reference_engine_extras_match():
    """The reference's engine feeds the same zero frames: (B, frames, D) bf16."""
    from repro.serving.engine import Engine as RefEngine

    cfg_r, cfg, p_r, p = model(NAME)
    ref = RefEngine.__new__(RefEngine)
    ref.cfg = cfg_r
    eng = Engine(cfg, p, cache_len=CACHE, max_batch=2, device="cpu")
    want = ref._extra_inputs(2)["frames"]
    got = eng._extra_inputs(2)["frames"]
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert not got.any()
