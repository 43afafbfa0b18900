"""The MoE family's serving path on the port vs the JAX reference.

`arctic-480b` (128 experts top-2 + a dense residual in every layer) and
`llama4-maverick-400b-a17b` (dense and MoE layers in pairs, top-1 + a shared
expert), each `reduced()` on both sides (4 experts, d_model 128) with the
reference's weights carried across by `models.convert.params_from_reference`:
configs field for field, schemas (full and reduced), the full configs'
parameter counts and the depth and expert share the card serves,
`moe_layer` against the reference's (picks, slots, keep mask, output and
losses, at capacity factors that drop pairs and that do not), one card's
share of the experts summed over the shards against the reference's whole
layer, `forward_hidden`, prefill logits and caches, teacher-forced decode
from each side's own cache and from the reference's, the capacity policy,
the port's prefill/decode consistency, decode_attn's calls a step, an
`Engine` wave, and `flash_attention`'s one tile enumeration against both
of the reference's strategies ("masked" and "triangular").

Tolerances. float32 `moe_layer`: picks and slots exact (the inputs hold no
near-tie: each token's top k+1 probabilities differ by more than 1e-5, so
the two packages' float32 router sums cannot reorder them), output within
1e-5 of its scale (float32 products summed in another order), losses within
1e-5. bf16: the output within 2% of its scale (`CACHE_TOL`: bf16 roundings
in other places, as the dense family's caches). A share's routed parts,
summed over the shards, are the whole layer's within 1e-5 (float32; the k
gated outputs summed in another order). The model runs: `tests/_torch_models.py`.
`flash_attention` against the reference's two strategies: within 1e-5 of
the scale in float32 (the same sums, the skipped tiles adding exact zeros).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_models import (CACHE_TOL, CONSISTENCY_TOL, LOGITS_TOL,  # noqa: E402
                           decode_from_reference_cache, model, moe_params, port_batch,
                           prefill_decode_rels, ref_batch, rel, schema_rows, teacher_forced,
                           tokens)
from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.models import attention, convert, moe, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

MOE = ["arctic-480b", "llama4-maverick-400b-a17b"]
PROMPT, CACHE, STEPS = 12, 32, 3
FULL_PARAMS = {"arctic-480b": 476_850_275_328, "llama4-maverick-400b-a17b": 400_711_848_960}
# The card's cut (`chip_smoke.py`): published widths, expert share 0 of 8
# (16 of 128 experts a MoE layer), 10 layers of Arctic, 6 (dense, MoE) pairs
# of Maverick.
CARD_LAYERS = {"arctic-480b": 10, "llama4-maverick-400b-a17b": 12}
CARD_PARAMS = {"arctic-480b": 19_423_710_208, "llama4-maverick-400b-a17b": 17_172_526_080}
BANDS = {"arctic-480b": (420e9, 520e9), "llama4-maverick-400b-a17b": (350e9, 450e9)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TIE = 1e-5  # top-k margin in probability under which the two packages may reorder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- configs, schema, params --------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_config_matches_the_reference(name, reduced):
    ref, cfg = ref_configs.get(name), configs.get(name)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.arch_type == "moe" and name in configs.names()
    assert type(cfg) is configs.ArchConfig and cfg.expert_slice == (0, cfg.num_experts)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_schema_matches_the_reference(name, reduced):
    c_r, c = ref_configs.get(name), configs.get(name)
    if reduced:
        c_r, c = c_r.reduced(), c.reduced()
    s = M.build_schema(c)
    assert schema_rows(s) == schema_rows(ref_model.build_schema(c_r))
    stack = s["moe_blk"] if c.moe_every == 2 else s["blk"]
    assert stack["moe"]["router"].shape[-2:] == (c.d_model, c.num_experts)
    assert stack["moe"]["router"].dtype == "float32"
    assert stack["moe"]["w_down"].shape[-3:] == (c.num_experts, c.d_ff, c.d_model)
    if c.moe_every == 2:  # llama4: the dense layers at their own d_ff
        assert s["dense_blk"]["mlp"]["up"].shape[-1] == c.moe_dense_layer_ff
        assert "moe" not in s["dense_blk"]


@pytest.mark.parametrize("name", MOE)
def test_full_config_parameter_count(name):
    """Counted from the schema without allocating: the reference's count,
    in the reference's band (`tests/test_archs_smoke.py`)."""
    n = params.count_params(M.build_schema(configs.get(name)))
    assert n == ref_params.count_params(ref_model.build_schema(ref_configs.get(name)))
    assert n == FULL_PARAMS[name] and BANDS[name][0] <= n <= BANDS[name][1]


@pytest.mark.parametrize("name", MOE)
def test_the_cards_cut_keeps_every_width(name):
    """The card's share 0 of 8 at its depth: 16 experts a MoE layer, every
    other leaf as published (the router's 128 outputs included), under 40
    GB in bf16."""
    full = configs.get(name)
    cut = dataclasses.replace(configs.expert_share(full, 0, 8), num_layers=CARD_LAYERS[name])
    assert isinstance(cut, configs.ExpertShare) and cut.expert_slice == (0, 16)
    s = M.build_schema(cut)
    assert params.count_params(s) == CARD_PARAMS[name]
    assert params.tree_bytes(s) < 40e9
    rows, full_rows = schema_rows(s), schema_rows(M.build_schema(full))
    assert set(rows) == set(full_rows)
    for path, (shape, *rest) in rows.items():
        want = full_rows[path][0]
        if path.rsplit("/", 1)[-1] in convert.EXPERT_LEAVES:
            assert shape[1:] == (16,) + want[2:], path
        else:
            assert shape[1:] == want[1:], path
        assert rest == list(full_rows[path][1:]), path


def test_expert_share_checks_and_keeps_its_fields():
    cfg = configs.get("arctic-480b")
    share = configs.expert_share(cfg, 3, 8)
    assert share.expert_slice == (48, 64)
    assert {k: v for k, v in dataclasses.asdict(share).items()
            if k not in ("expert_shard", "expert_shards")} == dataclasses.asdict(cfg)
    assert dataclasses.replace(share, num_layers=10).expert_slice == (48, 64)
    assert configs.expert_share(cfg, 0, 1).expert_slice == cfg.expert_slice
    for shard, shards in ((0, 3), (8, 8), (-1, 8), (0, 0)):
        with pytest.raises(ValueError):
            configs.expert_share(cfg, shard, shards)
    with pytest.raises(ValueError):  # 4 experts do not split 8 ways
        share.reduced()
    assert configs.get("arctic-480b") is cfg  # the registry's config is untouched


# -- moe_layer ------------------------------------------------------------------


def _layer_inputs(name, dtype, seed=5, s=16):
    """(reference cfg, port cfg, reference layer params, port layer params,
    x numpy (2, s, D)) on the reduced model's first MoE layer."""
    cfg_r, cfg, p_r, p = model(name)
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    lp_r = jax.tree.map(lambda a: a if a.dtype == jnp.float32 else a.astype(jdt),
                        moe_params(p_r))
    lp = {k: ({kk: vv.to(tdt) for kk, vv in v.items()} if isinstance(v, dict)
              else v if v.dtype == torch.float32 else v.to(tdt))
          for k, v in moe_params(p).items()}
    return cfg_r, cfg, lp_r, lp, x


def _ref_picks(p_r, x, cfg_r, cf):
    """The reference's routing steps (`moe.py:37-51`): probabilities (n, E),
    top-k ids (n, k), each pair's slot and keep mask, and cap."""
    b, s, _ = x.shape
    n, e, k = b * s, cfg_r.num_experts, cfg_r.experts_per_token
    cap = max(1, int(n * k * (cf if cf is not None else cfg_r.capacity_factor) / e))
    probs, _ = ref_moe.router_probs(x, p_r["router"])
    _, idx = jax.lax.top_k(probs.reshape(n, e), k)
    onehot = jax.nn.one_hot(idx.reshape(-1), e, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(axis=-1)
    return (np.asarray(probs).reshape(n, e), np.asarray(idx), np.asarray(pos),
            np.asarray(pos < cap), cap)


def _cfs(name):
    e = configs.get(name).reduced().num_experts
    return {"None": None, "2.0": 2.0, "E": float(e), "0.5": 0.5}


@pytest.mark.parametrize("cf", ["None", "2.0", "E", "0.5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_layer_matches_the_reference(name, dtype, cf):
    cf = _cfs(name)[cf]
    cfg_r, cfg, lp_r, lp, x = _layer_inputs(name, dtype)
    tdt, jdt = DTYPES[dtype]
    xj, xt = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    out_r, aux_r = ref_moe.moe_layer(lp_r, xj, cfg_r, capacity_factor=cf)
    out, aux = moe.moe_layer(lp, xt, cfg, capacity_factor=cf)
    assert out.dtype == tdt and out.shape == x.shape

    probs_r, idx_r, pos_r, keep_r, cap = _ref_picks(lp_r, xj, cfg_r, cf)
    top = -np.sort(-probs_r, axis=-1)[:, :cfg.experts_per_token + 1]
    assert np.diff(top, axis=-1).min() < -TIE, "the inputs hold a near-tie"
    probs, _ = moe.router_probs(xt.reshape(-1, cfg.d_model), lp["router"])
    np.testing.assert_allclose(probs.numpy(), probs_r, atol=1e-6)
    gates, idx = moe.route(probs, cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), idx_r)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)
    assert moe.capacity(x.shape[0] * x.shape[1], cfg.experts_per_token,
                        cf if cf is not None else cfg.capacity_factor, cfg.num_experts) == cap
    pos, keep = moe.slots(idx.reshape(-1), cfg.num_experts, cap)
    np.testing.assert_array_equal(pos.numpy(), pos_r)
    np.testing.assert_array_equal(keep.numpy(), keep_r)
    assert int(aux["dropped"]) == int((~keep_r).sum())
    if cf == 0.5:
        assert int(aux["dropped"]) > 0  # the drop-forcing factor does drop
    if cf == float(cfg.num_experts):
        assert int(aux["dropped"]) == 0

    tol = 1e-5 if dtype == "float32" else CACHE_TOL
    assert rel(out.float().numpy(), np.asarray(out_r, np.float32)) < tol
    for key in ("load_balance", "router_z"):
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(float(aux[key]), float(aux_r[key]), rtol=1e-5)


@pytest.mark.parametrize("cf", ["E", "0.5"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", MOE)
def test_expert_shares_sum_to_the_whole_layer(name, shards, cf):
    """Every shard of the experts on the reference's weights cut to it
    (`convert.expert_shard_tree`): the routed parts summed over the shards,
    with the dense branch (Arctic's residual, Maverick's shared expert) that
    every card computes alike counted once, equal the reference's whole
    layer, drops forced (cf 0.5) included. Routing and cap are over all E
    on every shard."""
    cf = _cfs(name)[cf]
    cfg_r, cfg, lp_r, lp, x = _layer_inputs(name, "float32")
    xt = torch.tensor(x)
    out_r, _ = ref_moe.moe_layer(lp_r, jnp.asarray(x), cfg_r, capacity_factor=cf)
    dense = M.mlp(xt, lp["dense"], "swiglu")
    total, dropped = torch.zeros_like(xt), set()
    for i in range(shards):
        share = configs.expert_share(cfg, i, shards)
        part = convert.expert_shard_tree(lp, i, shards)
        assert part["w_gate"].shape[0] == cfg.num_experts // shards
        assert part["router"] is lp["router"]
        out, aux = moe.moe_layer(part, xt, share, capacity_factor=cf)
        total += out - dense
        dropped.add(int(aux["dropped"]))
    total += dense
    assert len(dropped) == 1  # every shard counts the same drops
    assert (cf == 0.5) == (dropped.pop() > 0)
    assert rel(total.numpy(), np.asarray(out_r)) < 1e-5
    whole, _ = moe.moe_layer(lp, xt, cfg, capacity_factor=cf)
    assert rel(total.numpy(), whole.numpy()) < 1e-5
    with pytest.raises(ValueError):  # a share's config with the whole tree's experts
        moe.moe_layer(lp, xt, configs.expert_share(cfg, 0, shards), capacity_factor=cf)


def test_expert_shard_tree_cuts_the_stacked_experts_axis():
    _, cfg, _, p = model("llama4-maverick-400b-a17b")
    part = convert.expert_shard_tree(p, 1, 2)
    e = cfg.num_experts
    for leaf in convert.EXPERT_LEAVES:
        assert torch.equal(part["moe_blk"]["moe"][leaf], p["moe_blk"]["moe"][leaf][:, e // 2:])
    assert part["moe_blk"]["moe"]["router"] is p["moe_blk"]["moe"]["router"]
    assert part["dense_blk"] == p["dense_blk"] and part["embed"] is p["embed"]
    with pytest.raises(ValueError):
        convert.expert_shard_tree(p, 0, 3)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("name", MOE)
def test_forward_hidden_matches_the_reference(name):
    cfg_r, cfg, p_r, p = model(name)
    toks = tokens(cfg, PROMPT)
    h_r, _, _ = ref_model.forward_hidden(p_r, cfg_r, ref_batch(cfg, toks), train=False)
    h, _, raw = M.forward_hidden(p, cfg, port_batch(cfg, toks))
    assert raw is None and h.shape == (2, PROMPT, cfg.d_model) and h.dtype == torch.bfloat16
    assert rel(h.float().numpy(), np.asarray(h_r, np.float32)) < CACHE_TOL


@pytest.mark.parametrize("name", MOE)
def test_prefill_logits_and_caches_match_the_reference(name):
    _, cfg, _, _ = model(name)
    (c_r, l_r), (c, lg) = teacher_forced(name, PROMPT, CACHE, STEPS)[0]
    assert lg.shape == (2, cfg.vocab_size) and np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    desc = M._cache_desc(cfg, 2, CACHE)
    pairs = cfg.moe_every == 2
    assert set(c) == set(c_r) == set(desc) == (
        {"k_dense", "v_dense", "k_moe", "v_moe"} if pairs else {"k", "v"})
    layers = cfg.num_layers // 2 if pairs else cfg.num_layers
    for key, a in c_r.items():
        assert c[key].shape == a.shape == desc[key][0] == (
            layers, 2, CACHE, cfg.num_kv_heads, cfg.head_dim), key
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("step", range(1, STEPS + 1))
@pytest.mark.parametrize("name", MOE)
def test_teacher_forced_decode_matches_the_reference(name, step):
    (c_r, l_r), (c, lg) = teacher_forced(name, PROMPT, CACHE, STEPS)[step]
    assert np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("name", MOE)
def test_decode_from_the_reference_cache(name):
    c_r, l_r, c, lg = decode_from_reference_cache(name, PROMPT, CACHE)
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("prompt", [1, PROMPT])
@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_consistency_without_drops(name, prompt):
    """Decode never drops a pair (cf = E), a full forward over 2+ tokens may
    (cf 2.0: Maverick's reduced top-1 over 4 experts has cap 2 at the first
    step after a 1-token prompt, 2 x 2 tokens). The cache path is held
    without drops: the prefill and the full forward at cf = E too."""
    e = float(configs.get(name).reduced().num_experts)
    assert max(prefill_decode_rels(name, prompt, CACHE, 3, capacity_factor=e)) < CONSISTENCY_TOL


@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_consistency_at_the_served_capacity(name):
    """The reference's own test's setup (`tests/test_archs_smoke.py`): 64
    prompt tokens, one step, the served capacity (cf 2.0)."""
    assert max(prefill_decode_rels(name, 64, 128, 1)) < CONSISTENCY_TOL


@pytest.mark.parametrize("name", MOE)
def test_capacity_policy_is_the_references(name, monkeypatch):
    """A one-token input never drops (cf = E: every decode step and a
    one-token prompt); a longer one runs at the reference's 2.0, or at the
    factor `prefill` is given. Every MoE layer of the stack is called."""
    _, cfg, _, p = model(name)
    seen = []
    real = moe.moe_layer

    def filed(p_, x, cfg_, **kw):
        seen.append((x.shape[1], kw["capacity_factor"]))
        return real(p_, x, cfg_, **kw)

    monkeypatch.setattr(moe, "moe_layer", filed)
    toks = torch.tensor(tokens(cfg, PROMPT + 1))
    moe_layers = cfg.num_layers // cfg.moe_every
    e = float(cfg.num_experts)
    cache, _ = M.prefill(p, cfg, {"tokens": toks[:, :PROMPT]}, CACHE)
    M.decode_step(p, cfg, cache, toks[:, PROMPT], PROMPT)
    M.prefill(p, cfg, {"tokens": toks[:, :1]}, CACHE)
    M.prefill(p, cfg, {"tokens": toks[:, :PROMPT]}, CACHE, capacity_factor=e)
    assert seen == ([(PROMPT, M.PREFILL_CAPACITY)] * moe_layers
                    + [(1, e)] * moe_layers * 2 + [(PROMPT, e)] * moe_layers)


@pytest.mark.parametrize("name", MOE)
def test_decode_calls_decode_attn_once_a_layer(name, monkeypatch):
    """Every layer, dense or MoE, calls decode_attn once a step over its own
    cache (`length = pos + 1`); G is the arch's (7 for Arctic's 56 / 8 heads
    at full width, 5 for Maverick's 40 / 8; the reduced 4 / 2 here)."""
    _, cfg, _, p = model(name)
    toks = torch.tensor(tokens(cfg, PROMPT + 1))
    cache, _ = M.prefill(p, cfg, {"tokens": toks[:, :PROMPT]}, CACHE)
    calls = []
    real = da_ops.decode_attention

    def filed(q, k_cache, v_cache, **kw):
        calls.append((q.shape[1] // k_cache.shape[2], k_cache.shape[1], kw["length"],
                      kw["pos"]))
        return real(q, k_cache, v_cache, **kw)

    monkeypatch.setattr(da_ops, "decode_attention", filed)
    M.decode_step(p, cfg, cache, toks[:, PROMPT], PROMPT)
    g = cfg.num_heads // cfg.num_kv_heads
    assert calls == [(g, CACHE, PROMPT + 1, PROMPT)] * cfg.num_layers
    full = configs.get(name)
    assert full.num_heads // full.num_kv_heads == {"arctic-480b": 7,
                                                    "llama4-maverick-400b-a17b": 5}[name]


@pytest.mark.parametrize("name", MOE)
def test_engine_serves_a_wave(name):
    """`Engine` on the CPU: a wave of two greedy requests and one of a
    sampled request; the greedy tokens equal the port's own steps."""
    _, cfg, _, p = model(name)
    prompts = tokens(cfg, 6, seed=3)
    eng = Engine(cfg, p, cache_len=CACHE, max_batch=2, device="cpu")
    assert eng._extra_inputs(2) == {}
    for i in range(2):
        eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=4))
    eng.submit(Request(uid=2, prompt=prompts[0], max_new_tokens=3, temperature=0.8))
    results = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(r.tokens) for r in results] == [4, 4, 3]
    assert results[0].wave_id == results[1].wave_id != results[2].wave_id
    with torch.inference_mode():
        cache, logits = M.prefill(p, cfg, {"tokens": torch.tensor(prompts)}, CACHE)
        want = []
        for i in range(4):
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok.numpy())
            cache, logits = M.decode_step(p, cfg, cache, tok, 6 + i)
    np.testing.assert_array_equal(np.stack([r.tokens for r in results[:2]]), np.stack(want, 1))


@pytest.mark.parametrize("name", MOE)
def test_a_share_serves_on_the_references_cut_weights(name):
    """Shard 1 of 2 of the reduced model, on the reference's weights cut to
    it: its schema's shapes are the cut tree's, prefill and a decode step
    run finite, and its logits are the share's, not the whole model's (the
    absent experts add nothing here)."""
    _, cfg, _, p = model(name)
    share = configs.expert_share(cfg, 1, 2)
    part = convert.expert_shard_tree(p, 1, 2)
    assert {path: d.shape for path, d in params.leaves(M.build_schema(share))} == {
        path: tuple(t.shape) for path, t in params.leaves(part)}
    toks = torch.tensor(tokens(cfg, PROMPT + 1))
    cache, lg = M.prefill(part, share, {"tokens": toks[:, :PROMPT]}, CACHE)
    cache, lg1 = M.decode_step(part, share, cache, toks[:, PROMPT], PROMPT)
    assert torch.isfinite(lg).all() and torch.isfinite(lg1).all()
    _, whole = M.prefill(p, cfg, {"tokens": toks[:, :PROMPT]}, CACHE)
    assert rel(lg.numpy(), whole.numpy()) > 1e-3


# -- flash_attention's tiles ---------------------------------------------------


ATTN_CASES = {"causal": dict(causal=True, window=0), "window": dict(causal=True, window=20),
              "window_noncausal": dict(causal=False, window=8),
              "offset": dict(causal=True, window=0, q_offset=16),
              "offset_unaligned": dict(causal=True, window=0, q_offset=12)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_tiles_match_both_reference_strategies(case):
    """q 40 x kv 56 at q_block 8 and kv_block 16 (both padded; GQA 4 / 2
    heads, hd 16), float32: the port's one enumeration against the
    reference's masked strategy, and, where the offset is whole tiles,
    against its triangular one, the same tile pairs skipped. An offset
    inside a tile (12) is exact only in the port, which takes the q tile's
    true first position: the reference's triangular strategy rounds it down
    to whole tiles and skips a tile that holds unmasked entries."""
    kw = dict(ATTN_CASES[case], q_block=8, kv_block=16)
    off = kw.get("q_offset", 0)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 56, 2, 16)).astype(np.float32) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = attention.flash_attention(*map(torch.tensor, (q, k, v)), **kw).numpy()
    masked = np.asarray(ref_attention.flash_attention(jq, jk, jv, impl="masked", **kw))
    tri = np.asarray(ref_attention.flash_attention(jq, jk, jv, impl="triangular", **kw))
    assert rel(got, masked) < 1e-5
    nq, nkv = 5, 4
    pairs = attention._block_pairs(nq, nkv, causal=kw["causal"], window=kw["window"],
                                   q_block=8, kv_block=16, q_offset=off)
    ref_pairs = ref_attention._block_pairs(nq, nkv, causal=kw["causal"],
                                           window=kw["window"], q_block=8, kv_block=16,
                                           q_offset_blocks=off // 8)
    assert len(pairs) < nq * nkv  # tiles are skipped
    if off % 8:
        assert set(ref_pairs) < set(pairs)
        assert rel(tri, masked) > 1e-3
    else:
        assert pairs == ref_pairs
        assert rel(got, tri) < 1e-5


@pytest.mark.parametrize("name", MOE)
def test_prefill_tiles_match_both_reference_strategies(name, monkeypatch):
    """The model's prefill at 4 x 4 tiles (3 x 3 of them on the 12-token
    prompt, 3 skipped) against the reference's masked and triangular
    prefills at their own tiles (the reduced prompt whole in one)."""
    cfg_r, cfg, p_r, p = model(name)
    real = attention.flash_attention
    calls = []

    def small_tiles(*args, **kw):
        calls.append(kw)
        return real(*args, q_block=4, kv_block=4, **kw)

    monkeypatch.setattr(M, "flash_attention", small_tiles)
    toks = tokens(cfg, PROMPT)
    c, lg = M.prefill(p, cfg, port_batch(cfg, toks), CACHE)
    assert len(calls) == cfg.num_layers
    assert len(attention._block_pairs(3, 3, causal=True, window=0, q_block=4, kv_block=4,
                                      q_offset=0)) == 6
    for impl in ("masked", "triangular"):
        c_r, l_r = ref_model.prefill(p_r, cfg_r, ref_batch(cfg, toks), cache_len=CACHE,
                                     impl=impl)
        assert rel(lg.numpy(), np.asarray(l_r)) < LOGITS_TOL, impl
        for key in c:
            assert rel(c[key].float().numpy(),
                       np.asarray(c_r[key], np.float32)) < CACHE_TOL, (impl, key)
