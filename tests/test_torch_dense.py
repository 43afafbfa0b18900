"""The dense family's serving path on the port vs the JAX reference.

`qwen2-7b` (GQA, QKV bias), `gemma-7b` (GeGLU, hd 256, scaled embeddings),
`gemma2-9b` (local/global pairs, soft caps, post norms), `gemma2-9b-sw`
(every layer windowed) and `phi3-medium-14b`, each `reduced()` on both
sides with the reference's weights carried across by
`models.convert.params_from_reference`: configs field for field, schemas,
the full configs' parameter counts, prefill logits and caches, three
teacher-forced decode steps from each side's own cache (the third writes
slot 64 mod 64 = 0 of the reduced 64-slot window's ring) and one from the
reference's cache, and the port's prefill/decode consistency, past the
window too for the windowed archs. Tolerances as `tests/_torch_models.py`
states them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_models import (CACHE_TOL, CONSISTENCY_TOL, LOGITS_TOL,  # noqa: E402
                           decode_from_reference_cache, model, prefill_decode_rels, rel,
                           schema_rows, teacher_forced)
from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DENSE = ["qwen2-7b", "gemma-7b", "gemma2-9b", "gemma2-9b-sw", "phi3-medium-14b"]
WINDOWED = ["gemma2-9b", "gemma2-9b-sw"]
# 62 prompt tokens and three steps: positions 62..64, so the reduced window's
# 64-slot ring wraps at the third step; full caches hold 96 positions.
PROMPT, CACHE, STEPS = 62, 96, 3
# Parameters of the full configs (counted from the schema), in billions: the
# reference's ranges (`tests/test_archs_smoke.py`) hold them.
FULL_PARAMS = {"qwen2-7b": 7_615_616_512, "gemma-7b": 8_537_680_896,
               "gemma2-9b": 9_241_705_984, "gemma2-9b-sw": 9_241_705_984,
               "phi3-medium-14b": 14_659_507_200}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_config_matches_the_reference(name, reduced):
    ref, cfg = ref_configs.get(name), configs.get(name)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.arch_type == "dense" and name in configs.names()


@pytest.mark.parametrize("name", DENSE)
def test_schema_matches_the_reference(name):
    for reduce in (False, True):
        c_r, c = ref_configs.get(name), configs.get(name)
        if reduce:
            c_r, c = c_r.reduced(), c.reduced()
        assert schema_rows(M.build_schema(c)) == schema_rows(ref_model.build_schema(c_r))
    s = M.build_schema(configs.get(name))
    pairs = configs.get(name).attn_pattern == "local_global"
    assert set(s) >= ({"local", "global"} if pairs else {"blk"})


@pytest.mark.parametrize("name", DENSE)
def test_full_config_parameter_count(name):
    full = configs.get(name)
    n = params.count_params(M.build_schema(full))
    assert n == ref_params.count_params(ref_model.build_schema(ref_configs.get(name)))
    assert n == FULL_PARAMS[name]
    assert params.tree_bytes(M.build_schema(full)) == 2 * n  # every leaf bf16


def test_init_params_kinds_and_seed():
    """gemma2's schema (post norms, local and global stacks) drawn on the
    port: kinds, shapes, types, the seed."""
    _, cfg, p_r, _ = model("gemma2-9b")
    mine = dict(params.leaves(M.init_model(cfg, seed=3, device="cpu")))
    again = dict(params.leaves(M.init_model(cfg, seed=3, device="cpu")))
    schema = dict(params.leaves(M.build_schema(cfg)))
    assert set(mine) == set(schema) == {path for path, _ in params.leaves(p_r)}
    for path, t in mine.items():
        d = schema[path]
        assert t.shape == d.shape and t.dtype == params.DTYPES[d.dtype], path
        assert torch.equal(t, again[path])
        if d.init == "zeros":
            assert not t.any()
        else:
            scale = 1.0 / np.sqrt(max(params._fan_in(d.shape), 1))
            assert float(t.float().abs().max()) <= 2.0 * scale * 1.01, path


@pytest.mark.parametrize("name", DENSE)
def test_params_cross_exactly(name):
    _, _, p_r, p = model(name)
    back = dict(params.leaves(convert.cache_to_numpy(p)))
    mine = dict(params.leaves(p))
    for path, a in params.leaves(p_r):
        assert mine[path].dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(back[path], np.asarray(a, np.float32))


def _runs(name):
    return teacher_forced(name, PROMPT, CACHE, STEPS)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_logits_and_caches_match_the_reference(name):
    _, cfg, _, _ = model(name)
    (c_r, l_r), (c, lg) = _runs(name)[0]
    assert lg.shape == (2, cfg.vocab_size) and lg.dtype == np.float32
    assert np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    desc = M._cache_desc(cfg, 2, CACHE)
    assert set(c) == set(c_r) == set(desc)
    for key, a in c_r.items():
        assert c[key].shape == a.shape == desc[key][0], key
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("step", range(1, STEPS + 1))
@pytest.mark.parametrize("name", DENSE)
def test_teacher_forced_decode_matches_the_reference(name, step):
    (c_r, l_r), (c, lg) = _runs(name)[step]
    assert np.isfinite(lg).all()
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("name", DENSE)
def test_decode_from_the_reference_cache(name):
    c_r, l_r, c, lg = decode_from_reference_cache(name, PROMPT, CACHE)
    assert rel(lg, l_r) < LOGITS_TOL
    for key, a in c_r.items():
        assert rel(c[key], a) < CACHE_TOL, key


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_consistency(name):
    """Prefill 40 tokens then decode two: each step equals the last logits of
    the full forward over the tokens up to it."""
    assert max(prefill_decode_rels(name, 40, 64, 2)) < CONSISTENCY_TOL


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("name", WINDOWED)
def test_prefill_decode_consistency_past_the_window(name, step):
    """A 70-token prompt past the reduced 64-slot window (70 mod 64 = 6):
    the local layers' ring tails must hold position p in slot p mod 64. The
    reference's tail is unrolled there, so the port is held against its own
    full forward."""
    assert prefill_decode_rels(name, 70, 128, 3)[step - 1] < CONSISTENCY_TOL


@pytest.mark.parametrize("name", DENSE)
def test_cache_layout(name):
    """The decode state's keys, shapes and types: the window's rings on the
    local layers, full caches on the others; zeros from `init_cache`."""
    cfg = configs.get(name)
    desc = M._cache_desc(cfg, 2, 8192)
    hkv, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    want = {"qwen2-7b": {"k": (n, 2, 8192, hkv, hd)},
            "gemma-7b": {"k": (n, 2, 8192, hkv, hd)},
            "phi3-medium-14b": {"k": (n, 2, 8192, hkv, hd)},
            "gemma2-9b-sw": {"k": (n, 2, 4096, hkv, hd)},
            "gemma2-9b": {"k_local": (n // 2, 2, 4096, hkv, hd),
                          "k_global": (n // 2, 2, 8192, hkv, hd)}}[name]
    for key, shape in want.items():
        assert desc[key] == (shape, torch.bfloat16)
        assert desc[key.replace("k", "v", 1)] == (shape, torch.bfloat16)
    assert len(desc) == 2 * len(want)
    small = M.init_cache(configs.get(name).reduced(), 2, 80, device="cpu")
    assert all(not t.any() for t in small.values())


@pytest.mark.parametrize("name", WINDOWED)
def test_float32_weights_run_the_same_path(name):
    """A float32 copy of the weights runs prefill and decode in float32 (the
    activations and caches take the weights' type): prefill/decode agree to
    float32 rounding, past the window too, and the logits stay within the
    bf16 tolerance of the reference's."""
    from repro_torch.models import layers

    _, cfg, p_r, p = model(name)

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    wide = widen(p)
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 73)))
    cache, pre = M.prefill(wide, cfg, {"tokens": toks[:, :70]}, 128)
    assert all(t.dtype == torch.float32 for t in cache.values())
    h, _, _ = M.forward_hidden(wide, cfg, {"tokens": toks})
    table = M.unembed_table(wide, cfg)
    for i in range(3):
        cache, dec = M.decode_step(wide, cfg, cache, toks[:, 70 + i], 70 + i)
        full = layers.logits_last(h[:, 70 + i], table, cfg.final_softcap)
        assert rel(dec.numpy(), full.numpy()) < 1e-5
    _, l_r = ref_model.prefill(p_r, ref_configs.get(name).reduced(),
                               {"tokens": jnp.asarray(toks[:, :70].numpy())}, cache_len=128)
    assert rel(pre.numpy(), l_r) < LOGITS_TOL
