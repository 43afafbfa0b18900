"""The hybrid (Zamba2) serving path of the port vs the JAX reference.

`configs.get("zamba2-2.7b").reduced()` on both sides; the reference's
weights (`repro.models.model.init_model`) carried across with
`models.convert.params_from_reference`, so both packages run the same
model on the same tokens. Also: configs, schema, init kinds, parameter
counts and the shared layers against the reference's.

Tolerance: both sides run bf16 activations and round in other places
(PyTorch's `silu` rounds once where XLA rounds each of its bf16 steps;
PyTorch's bf16 matmul sums in another order), so a bf16 ulp here and there
becomes, through the model's random weights, up to 2.7% of the logits'
scale (the worst of the runs measured while writing this test: seeds 0-2,
prompts of 40 and 62 tokens, prefill and three decode steps; ~1.5%
typical). Logits are bounded at 4% of the reference's largest
logit, caches at 2% of their scale (bf16 ring caches equal exactly: k and
v come straight from one bf16 matmul each). The port's own
prefill/decode consistency is held at 2%, as the reference's own test
holds it (`tests/test_archs_smoke.py`).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import convert, layers, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

PROMPT, CACHE = 62, 64  # the reduced window is 64: the third decode step wraps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_configs.get("zamba2-2.7b").reduced()
    cfg = configs.get("zamba2-2.7b").reduced()
    p_r = ref_model.init_model(cfg_r, jax.random.PRNGKey(0))
    p = convert.params_from_reference(jax.tree.map(np.asarray, p_r), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, PROMPT + 3))
    return cfg_r, cfg, p_r, p, toks.astype(np.int32)


@pytest.fixture(scope="module")
def runs(model):
    """Prefill then three teacher-forced decode steps on both sides:
    [(reference cache, logits), (port cache, logits)] per step."""
    cfg_r, cfg, p_r, p, toks = model
    c_r, l_r = ref_model.prefill(p_r, cfg_r, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                 cache_len=CACHE)
    c, lg = M.prefill(p, cfg, {"tokens": torch.tensor(toks[:, :PROMPT])}, CACHE)
    steps = [((jax.tree.map(np.asarray, c_r), np.asarray(l_r)),
              (convert.cache_to_numpy(c), lg.numpy()))]
    for i in range(3):
        pos = PROMPT + i
        c_r, l_r = ref_model.decode_step(p_r, cfg_r, c_r, jnp.asarray(toks[:, pos]),
                                         jnp.int32(pos))
        c, lg = M.decode_step(p, cfg, c, torch.tensor(toks[:, pos]), pos)
        steps.append(((jax.tree.map(np.asarray, c_r), np.asarray(l_r)),
                      (convert.cache_to_numpy(c), lg.numpy())))
    return steps


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


# -- configs, schema, params --------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    ref = ref_configs.get("zamba2-2.7b")
    cfg = configs.get("zamba2-2.7b")
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert configs.names() == ["arctic-480b", "gemma-7b", "gemma2-9b", "gemma2-9b-sw",
                               "llama-3.2-vision-90b", "llama4-maverick-400b-a17b",
                               "phi3-medium-14b", "qwen2-7b", "rwkv6-1.6b", "whisper-base",
                               "zamba2-2.7b"]


def test_unported_archs_raise_and_name_the_roadmap():
    """No arch is left unported: every name the reference registers is a
    config here (the MoE archs included), an unknown name raises `KeyError`,
    and an `arch_type` outside the six families raises `ValueError` at every
    entry of the model rather than reaching the hybrid branch."""
    assert configs.names() == sorted(base.REFERENCE_ARCHS) == ref_configs.names()
    for name in base.REFERENCE_ARCHS:
        assert configs.get(name).name == name
    with pytest.raises(KeyError):
        configs.get("no-such-arch")
    unknown = dataclasses.replace(configs.get("zamba2-2.7b").reduced(), name="a",
                                  arch_type="hybrid2")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    for entry in (lambda: M.build_schema(unknown),
                  lambda: M.init_cache(unknown, 1, 8, device="cpu"),
                  lambda: M.forward_hidden({}, unknown, {"tokens": toks}),
                  lambda: M.prefill({}, unknown, {"tokens": toks}, 8),
                  lambda: M.decode_step({"embed": torch.zeros(8, 4)}, unknown, {},
                                        toks[:, 0], 4)):
        with pytest.raises(ValueError, match="unknown arch_type"):
            entry()


def _schema_rows(schema):
    return {"/".join(path): (tuple(d.shape), tuple(d.axes), d.init, d.dtype)
            for path, d in params.leaves(schema)}


def test_schema_matches_the_reference(model):
    cfg_r, cfg, *_ = model
    for c_r, c in ((cfg_r, cfg), (ref_configs.get("zamba2-2.7b"), configs.get("zamba2-2.7b"))):
        ref_rows = {"/".join(path): (tuple(d.shape), tuple(d.axes), d.init, d.dtype)
                    for path, d in params.leaves(ref_model.build_schema(c_r))}
        assert _schema_rows(M.build_schema(c)) == ref_rows


def test_full_config_parameter_count():
    """2.34 B parameters at the published widths (the reference's range
    is 2-4 B), counted from the schema without allocating."""
    full = configs.get("zamba2-2.7b")
    n = params.count_params(M.build_schema(full))
    ref_n = ref_params.count_params(ref_model.build_schema(ref_configs.get("zamba2-2.7b")))
    assert n == ref_n and 2e9 <= n <= 4e9
    assert params.tree_bytes(M.build_schema(full)) == 2 * n + 2 * 54 * 80 * 3  # 3 f32 vectors a layer


def test_init_params_kinds_and_seed(model):
    _, cfg, p_r, p, _ = model
    mine = M.init_model(cfg, seed=3, device="cpu")
    again = M.init_model(cfg, seed=3, device="cpu")
    other = M.init_model(cfg, seed=4, device="cpu")
    schema = dict(params.leaves(M.build_schema(cfg)))
    for path, t in params.leaves(mine):
        d = schema[path]
        assert t.shape == d.shape and t.dtype == params.DTYPES[d.dtype], path
        assert torch.equal(t, dict(params.leaves(again))[path])
        if d.init == "zeros":
            assert not t.any()
        elif d.init == "ones":
            assert (t == 1).all()
        elif d.init == "decay":
            assert float(t.min()) >= -6.0 and float(t.max()) <= -2.0
        else:
            scale = 1.0 / np.sqrt(max(params._fan_in(d.shape), 1))
            scale *= 0.1 if d.init == "small_normal" else 1.0
            assert float(t.float().abs().max()) <= 2.0 * scale * 1.01, path
            assert not torch.equal(t, dict(params.leaves(other))[path])
            if t.numel() > 10_000:
                ref_t = np.asarray(dict(params.leaves(p_r))[path], np.float32)
                assert abs(float(t.float().std()) / ref_t.std() - 1) < 0.05, path


def test_params_cross_exactly(model):
    _, _, p_r, p, _ = model
    back = convert.cache_to_numpy(p)
    for path, a in params.leaves(p_r):
        t = dict(params.leaves(p))[path]
        want_dtype = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert t.dtype == want_dtype
        np.testing.assert_array_equal(dict(params.leaves(back))[path], np.asarray(a, np.float32))


# -- layers ------------------------------------------------------------------


def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)) + 5
    np.testing.assert_allclose(
        layers.rope(torch.tensor(x), torch.tensor(pos), 10000.0).numpy(),
        np.asarray(ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), atol=1e-5)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    sc = (rng.standard_normal(64) * 0.1).astype(np.float32)
    hb, scb = jnp.asarray(h, jnp.bfloat16), jnp.asarray(sc, jnp.bfloat16)
    np.testing.assert_array_equal(
        layers.rms_norm(torch.tensor(h).bfloat16(), torch.tensor(sc).bfloat16()).float().numpy(),
        np.asarray(ref_layers.rms_norm(hb, scb), np.float32))
    table = (rng.standard_normal((50, 64)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        layers.logits_last(torch.tensor(h).bfloat16(), torch.tensor(table).bfloat16(), 30.0)
        .numpy(),
        np.asarray(ref_layers.logits_last(hb, jnp.asarray(table, jnp.bfloat16), 30.0)),
        atol=1e-5)
    toks = np.array([[3, 7, 49]])
    for scale in (False, True):
        np.testing.assert_array_equal(
            layers.embed(torch.tensor(toks), torch.tensor(table), scale).numpy(),
            np.asarray(ref_layers.embed(jnp.asarray(toks), jnp.asarray(table), scale)))
    np.testing.assert_allclose(layers.softcap(torch.tensor(h) * 40, 30.0).numpy(),
                               np.asarray(ref_layers.softcap(jnp.asarray(h) * 40, 30.0)),
                               atol=1e-5)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_variants_match_the_reference(variant):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("gate", (32, 48)), ("up", (32, 48)), ("down", (48, 32)))}
    want = ref_layers.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, variant)
    got = layers.mlp(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()}, variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- prefill and decode ------------------------------------------------------


def test_prefill_logits_and_caches_match_the_reference(model, runs):
    cfg_r, cfg, *_ = model
    (c_r, l_r), (c, lg) = runs[0]
    assert lg.shape == (2, cfg.vocab_size) and lg.dtype == np.float32
    assert np.isfinite(lg).all()
    assert _rel(lg, l_r) < 0.04
    desc = M._cache_desc(cfg, 2, CACHE)
    assert set(c) == set(c_r) == set(desc)
    for name, a in c_r.items():
        assert c[name].shape == a.shape == desc[name][0], name
        assert _rel(c[name], a) < 0.02, name
    np.testing.assert_array_equal(c["ak"], np.asarray(c_r["ak"], np.float32))
    np.testing.assert_array_equal(c["av"], np.asarray(c_r["av"], np.float32))


@pytest.mark.parametrize("step", [1, 2, 3])
def test_teacher_forced_decode_matches_the_reference(runs, step):
    """Both sides decode the same tokens from their own caches; step 3
    writes slot 64 % 64 = 0, past the ring's wrap."""
    (c_r, l_r), (c, lg) = runs[step]
    assert np.isfinite(lg).all()
    assert _rel(lg, l_r) < 0.04
    for name, a in c_r.items():
        assert _rel(c[name], a) < 0.02, name


def test_decode_from_the_reference_cache(model):
    """The port's decode step from the reference's own prefill cache (carried
    across with `cache_from_reference`): only the decode path differs."""
    cfg_r, cfg, p_r, p, toks = model
    c_r, _ = ref_model.prefill(p_r, cfg_r, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                               cache_len=CACHE)
    c = convert.cache_from_reference(jax.tree.map(np.asarray, c_r), device="cpu")
    for name, a in c_r.items():
        assert c[name].dtype == (torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(convert.cache_to_numpy(c)[name], np.asarray(a, np.float32))
    tok = toks[:, PROMPT]
    c_r, l_r = ref_model.decode_step(p_r, cfg_r, c_r, jnp.asarray(tok), jnp.int32(PROMPT))
    c, lg = M.decode_step(p, cfg, c, torch.tensor(tok), PROMPT)
    assert _rel(lg.numpy(), l_r) < 0.04
    for name, a in c_r.items():
        assert _rel(convert.cache_to_numpy(c)[name], a) < 0.02, name


def test_prefill_decode_consistency(model):
    """Prefill s tokens then decode token s equals the last logits of the
    full forward over s + 1 tokens (rel < 0.02, as the reference holds it)."""
    _, cfg, _, p, toks = model
    t = torch.tensor(toks[:, :41])
    cache, _ = M.prefill(p, cfg, {"tokens": t[:, :40]}, 64)
    _, dec = M.decode_step(p, cfg, cache, t[:, 40], 40)
    h, _, _ = M.forward_hidden(p, cfg, {"tokens": t})
    full = layers.logits_last(h[:, -1], M.unembed_table(p, cfg), cfg.final_softcap)
    assert _rel(dec.numpy(), full.numpy()) < 0.02


@pytest.fixture(scope="module")
def past_the_window(model):
    """A 70-token prompt (s = w + 6 at the 64 window, cache 128) and three
    decode steps: [(decode logits at pos, full-forward logits over pos + 1
    tokens)] per step."""
    _, cfg, _, p, _ = model
    s = 70
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, s + 3))
                        .astype(np.int32))
    cache, _ = M.prefill(p, cfg, {"tokens": toks[:, :s]}, 128)
    assert cache["ak"].shape[2] == 64
    out = []
    for i in range(3):
        cache, dec = M.decode_step(p, cfg, cache, toks[:, s + i], s + i)
        h, _, _ = M.forward_hidden(p, cfg, {"tokens": toks[:, :s + i + 1]})
        full = layers.logits_last(h[:, -1], M.unembed_table(p, cfg), cfg.final_softcap)
        out.append((dec.numpy(), full.numpy()))
    return out


@pytest.mark.parametrize("step", [1, 2, 3])
def test_prefill_decode_consistency_past_the_window(past_the_window, step):
    """A prompt longer than the ring window and not a multiple of it: each
    decode step equals the full forward over s + 1 tokens (rel < 0.02). The
    prefill's ring tail must put position p in slot p mod w."""
    dec, full = past_the_window[step - 1]
    assert _rel(dec, full) < 0.02


def test_init_cache_and_ring_tail(model):
    """The tail of a prompt longer than the window is rolled so that
    position p sits in slot p mod w; the reference keeps it unrolled (its
    docstring assumes S % w == 0), so for S = 70 the port equals the
    reference's tail rolled by S mod w: a deliberate departure."""
    _, cfg, *_ = model
    cache = M.init_cache(cfg, 3, 200, device="cpu")
    desc = M._cache_desc(cfg, 3, 200)
    for name, t in cache.items():
        assert t.shape == desc[name][0] and t.dtype == desc[name][1] and not t.any()
    k = torch.arange(2 * 128 * 1 * 2, dtype=torch.float32).reshape(2, 128, 1, 2)
    assert torch.equal(M._ring_tail(k, 64), k[:, 64:])
    assert M._ring_tail(k[:, :40], 64).shape == (2, 64, 1, 2)
    assert np.array_equal(np.asarray(ref_model._ring_tail(jnp.asarray(k.numpy()[:, :40]), 64)),
                          M._ring_tail(k[:, :40], 64).numpy())
    ref70 = np.asarray(ref_model._ring_tail(jnp.asarray(k.numpy()[:, :70]), 64))
    got70 = M._ring_tail(k[:, :70], 64).numpy()
    assert np.array_equal(got70, np.roll(ref70, 70 % 64, axis=1))
    for p in range(6, 70):  # position p in slot p mod 64
        assert np.array_equal(got70[:, p % 64], k.numpy()[:, p])
