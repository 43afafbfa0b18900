"""The VLM family's serving path (`llama-3.2-vision-90b`) on the port vs the JAX reference.

`llama-3.2-vision-90b` `reduced()` on both sides (one group: 1
self-attention layer + 1 gated cross-attention layer, 16 patches, d_model
128, GQA with 2 kv heads), the reference's weights carried across by
`models.convert.params_from_reference` with every cross block's
`gate_attn` and `gate_mlp` set to 0.5 on both sides (zero at init, they
would hide the cross layers; `tests/_torch_models.py`), the same random
patches (x 0.02, numpy seed) in bf16 on both sides: configs field for
field, schemas (reduced and full), the full config's parameter count and
the depth the card serves, `forward_hidden`, prefill logits and all four
caches (`k`/`v` of the self layers, `xk`/`xv` of the cross layers), four
teacher-forced decode steps from each side's own cache and one from the
reference's, the port's own prefill/decode consistency, the gates, the
decode step's cross-attention over every patch without a write, and an
`Engine` wave on the CPU with the zero patches the engine feeds.
Tolerances as `tests/_torch_models.py` states them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_models import (CACHE_TOL, CONSISTENCY_TOL, GATE, LOGITS_TOL,  # noqa: E402
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

NAME = "llama-3.2-vision-90b"
PROMPT, CACHE, STEPS = 12, 32, 4
FULL_PARAMS = 87_666_794_536
CARD_LAYERS, CARD_PARAMS = 20, 19_214_442_504  # the depth `chip_smoke.py` serves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _runs():
    return teacher_forced(NAME, PROMPT, CACHE, STEPS)


def _with_gates(p, value):
    """`p` with every cross block's two gates set to `value` (a new tree)."""
    xblk = dict(p["xblk"], **{g: torch.full_like(p["xblk"][g], value)
                              for g in ("gate_attn", "gate_mlp")})
    return dict(p, xblk=xblk)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    ref, cfg = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.arch_type == "vlm" and NAME in configs.names()


@pytest.mark.parametrize("reduced", [False, True])
def test_schema_matches_the_reference(reduced):
    c_r, c = ref_configs.get(NAME), configs.get(NAME)
    if reduced:
        c_r, c = c_r.reduced(), c.reduced()
    s = M.build_schema(c)
    assert schema_rows(s) == schema_rows(ref_model.build_schema(c_r))
    groups = c.num_layers // c.cross_attn_every
    assert M.n_cross(c) == ref_model.n_cross(c_r) == groups
    assert s["blk"]["attn"]["wq"].shape[:2] == (groups, c.cross_attn_every - 1)
    assert s["xblk"]["gate_attn"].shape == (groups, 1)
    assert s["xblk"]["gate_attn"].dtype == "float32" and s["xblk"]["gate_mlp"].init == "zeros"


def test_full_config_parameter_count():
    """87.7 B parameters at the published widths (175 GB in bf16: more than
    one card), counted from the schema without allocating."""
    full = configs.get(NAME)
    n = params.count_params(M.build_schema(full))
    assert n == ref_params.count_params(ref_model.build_schema(ref_configs.get(NAME)))
    assert n == FULL_PARAMS
    # every leaf bf16 but the 2 x 20 float32 gates
    assert params.tree_bytes(M.build_schema(full)) == 2 * n + 2 * 2 * 20


def test_the_cards_depth_cut_keeps_every_width():
    """The card serves 20 of the 100 layers (4 groups of 4 self + 1 gated
    cross layer): every width as published, 19.2 B parameters, under 40 GB
    in bf16."""
    full = configs.get(NAME)
    cut = dataclasses.replace(full, num_layers=CARD_LAYERS)
    s = M.build_schema(cut)
    assert M.n_cross(cut) == 4 and params.count_params(s) == CARD_PARAMS
    assert params.tree_bytes(s) < 40e9
    rows, full_rows = schema_rows(s), schema_rows(M.build_schema(full))
    assert set(rows) == set(full_rows)
    for path, (shape, *rest) in rows.items():
        assert shape[-1] == full_rows[path][0][-1] and rest == list(full_rows[path][1:]), path


def test_params_cross_exactly():
    _, _, p_r, p = model(NAME)
    back = dict(params.leaves(convert.cache_to_numpy(p)))
    for path, a in params.leaves(p_r):
        np.testing.assert_array_equal(back[path], np.asarray(a, np.float32))
    assert p["xblk"]["gate_attn"].dtype == torch.float32
    assert torch.all(p["xblk"]["gate_attn"] == GATE) and torch.all(p["xblk"]["gate_mlp"] == GATE)


def test_forward_hidden_matches_the_reference():
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
    g, hkv, hd = M.n_cross(cfg), cfg.num_kv_heads, cfg.head_dim
    assert desc["k"][0] == (g, cfg.cross_attn_every - 1, 2, CACHE, hkv, hd)
    assert desc["xk"][0] == (g, 2, cfg.num_frontend_tokens, hkv, hd)
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
    assert max(prefill_decode_rels(NAME, prompt, CACHE, 3)) < CONSISTENCY_TOL


def test_gates_scale_the_cross_block():
    """At zero gates (the init) the cross block adds nothing: other patches
    give the same logits, bit for bit. At the tests' gates they move them."""
    _, cfg, _, p = model(NAME)
    batch = port_batch(cfg, tokens(cfg, PROMPT))
    other = dict(batch, patches=torch.zeros_like(batch["patches"]))
    closed = _with_gates(p, 0.0)
    assert torch.equal(M.prefill(closed, cfg, batch, CACHE)[1],
                       M.prefill(closed, cfg, other, CACHE)[1])
    assert rel(M.prefill(p, cfg, other, CACHE)[1].numpy(),
               M.prefill(p, cfg, batch, CACHE)[1].numpy()) > 1e-3


@pytest.mark.parametrize("value", [0.0, GATE, -1.5])
def test_gated_block_matches_the_reference(value):
    """The cross block alone (`_block_full` with `cross_src`) at a gate
    value on both sides: tanh(gate) in the activations' type times each
    branch."""
    cfg_r, cfg, p_r, p = model(NAME)
    rng = np.random.default_rng(3)
    x, src = (rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 5, cfg.d_model), (2, cfg.num_frontend_tokens, cfg.d_model)))
    pr = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in p_r["xblk"].items()}
    pr["gate_attn"] = pr["gate_mlp"] = jnp.full((1,), value, jnp.float32)
    pt = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in _with_gates(p, value)["xblk"].items()}
    jb, tb = (lambda a: jnp.asarray(a, jnp.bfloat16)), (lambda a: torch.tensor(a).bfloat16())
    pos = jnp.broadcast_to(jnp.arange(5)[None], (2, 5))
    aux = {"load_balance": jnp.float32(0.0), "router_z": jnp.float32(0.0)}
    out_r, (k_r, _), _ = ref_model._block_full(pr, jb(x), cfg_r, aux, positions=pos,
                                               cross_src=jb(src), train=False)
    out, (k, _), _ = M._block_full(pt, tb(x), cfg, None, positions=None, cross_src=tb(src))
    assert rel(out.float().numpy(), np.asarray(out_r, np.float32)) < CACHE_TOL
    assert rel(k.float().numpy(), np.asarray(k_r, np.float32)) < CACHE_TOL
    if value == 0.0:
        assert torch.equal(out, tb(x))
    # The one-token form over the patches' keys: the first row of the full form.
    kx, vx = (t.contiguous() for t in M._attn_full(
        pt["attn"], tb(x), cfg, positions=None, cross_src=tb(src))[1])
    out1, _, _ = M._block_decode(pt, tb(x[:, :1]), cfg, kx, vx, 9, cross=True)
    assert rel(out1.float().numpy(), out[:, :1].float().numpy()) < CACHE_TOL


def test_cross_step_reads_every_patch_and_writes_none(monkeypatch):
    """A decode step calls decode_attn once a self layer (`length = pos +
    1`) and once a cross layer (`length = pos = patches`), writes the self
    caches at `pos` and leaves `xk` / `xv` as they were."""
    _, cfg, _, p = model(NAME)
    toks = torch.tensor(tokens(cfg, PROMPT + 1))
    cache, _ = M.prefill(p, cfg, port_batch(cfg, toks[:, :PROMPT]), CACHE)
    before = {k: t.clone() for k, t in cache.items()}
    calls = []
    real = da_ops.decode_attention

    def filed(q, k_cache, v_cache, **kw):
        calls.append((q.shape[1] // k_cache.shape[2], k_cache.shape[1], kw["length"],
                      kw["pos"]))
        return real(q, k_cache, v_cache, **kw)

    monkeypatch.setattr(da_ops, "decode_attention", filed)
    cache, _ = M.decode_step(p, cfg, cache, toks[:, PROMPT], PROMPT)
    g, n = cfg.num_heads // cfg.num_kv_heads, cfg.num_frontend_tokens
    assert calls == ([(g, CACHE, PROMPT + 1, PROMPT)] * (cfg.cross_attn_every - 1)
                     + [(g, n, n, n)]) * M.n_cross(cfg)
    for key in ("xk", "xv"):
        assert torch.equal(cache[key], before[key]), key
    for key in ("k", "v"):
        assert torch.equal(cache[key][..., :PROMPT, :, :], before[key][..., :PROMPT, :, :])
        assert cache[key][..., PROMPT, :, :].any() and not before[key][..., PROMPT, :, :].any()


def test_engine_serves_a_wave_with_zero_patches():
    """`Engine` on the CPU: a wave of two greedy requests and one of a
    sampled request, prefill with zero patches (as the reference's engine
    feeds them); the greedy tokens equal the port's own steps."""
    _, cfg, _, p = model(NAME)
    prompts = tokens(cfg, 6, seed=3)
    eng = Engine(cfg, p, cache_len=CACHE, max_batch=2, device="cpu")
    for i in range(2):
        eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=4))
    eng.submit(Request(uid=2, prompt=prompts[0], max_new_tokens=3, temperature=0.8))
    results = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(r.tokens) for r in results] == [4, 4, 3]
    assert results[0].wave_id == results[1].wave_id != results[2].wave_id

    zeros = torch.zeros(2, cfg.num_frontend_tokens, cfg.d_model, dtype=torch.bfloat16)
    with torch.inference_mode():
        cache, logits = M.prefill(p, cfg, {"tokens": torch.tensor(prompts),
                                           "patches": zeros}, CACHE)
        want = []
        for i in range(4):
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok.numpy())
            cache, logits = M.decode_step(p, cfg, cache, tok, 6 + i)
    np.testing.assert_array_equal(np.stack([r.tokens for r in results[:2]]), np.stack(want, 1))


def test_reference_engine_extras_match():
    """The reference's engine feeds the same zero patches: (B, patches, D) bf16."""
    from repro.serving.engine import Engine as RefEngine

    cfg_r, cfg, _, p = model(NAME)
    ref = RefEngine.__new__(RefEngine)
    ref.cfg = cfg_r
    want = ref._extra_inputs(2)["patches"]
    got = Engine(cfg, p, cache_len=CACHE, max_batch=2, device="cpu")._extra_inputs(2)["patches"]
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert not got.any()
