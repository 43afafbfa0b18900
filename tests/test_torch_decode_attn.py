"""The decode_attn kernel's plain version and `flash_attention` vs the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel `decode_attention_pallas` in interpret mode (through
`repro.kernels.decode_attn.ops`) and the jnp oracle
`repro.models.attention.decode_attention`; `flash_attention` against
the reference's default ("masked") strategy, which is jnp in both
packages. Inputs are made with numpy from a seed and handed to both sides.

Tolerance: float32 within 2e-5 (the reference's own); a bf16 cache within
3e-2 (the reference's bf16 tolerance).

The Hopper kernel itself runs only on the card (`test_torch_cuda.py`);
here the wrapper takes the plain version because the tensors lie on the
CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import ops as ref_ops  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed, b, s, hkv, g, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hkv * g, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def _both(arrays, jdtype, tdtype):
    return (tuple(jnp.asarray(a, jdtype) for a in arrays),
            tuple(torch.tensor(a).to(tdtype) for a in arrays))


def _check(arrays, tol=2e-5, kv_block=64, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    (q, k, v), (tq, tk, tv) = _both(arrays, jdtype, tdtype)
    got = ops.decode_attention(tq, tk, tv, **kw)
    assert got.dtype == tdtype and ops.decode_attention.launches == 0
    for want in (ref_ops.decode_attention(q, k, v, kv_block=kv_block, **kw),
                 ref_attention.decode_attention(q, k, v, **kw)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize("b,s,hkv,g,hd", [
    (2, 256, 2, 4, 64), (1, 128, 4, 1, 32), (2, 512, 1, 8, 128), (3, 64, 2, 2, 256),
])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_full_cache(b, s, hkv, g, hd, cap):
    _check(_case(b + s, b, s, hkv, g, hd), length=s - 7, pos=s - 8, cap=cap)


@pytest.mark.parametrize("window", [16, 64])
def test_sliding_window(window):
    _check(_case(0, 2, 128, 2, 2, 64), length=100, pos=99, window=window, kv_block=32)


@pytest.mark.parametrize("pos,length", [(40, 41), (63, 64), (100, 101), (200, 201)])
def test_ring_buffer(pos, length):
    """Ring cache of size 64 at the reference tests' wrap positions."""
    _check(_case(pos, 2, 64, 2, 2, 32), length=length, pos=pos, window=64, ring=True,
           kv_block=32)


@pytest.mark.parametrize("g,hd", [(7, 128), (1, 80)])
def test_the_path_head_widths(g, hd):
    """qwen2-like GQA (G = 7, hd = 128) and Zamba2's MHA at hd = 80, the
    latter on a ring with a cap."""
    _check(_case(g, 2, 96, 2, g, hd), length=60, pos=59, kv_block=32)
    _check(_case(hd, 2, 64, 2, g, hd), length=131, pos=130, window=64, ring=True,
           cap=50.0, kv_block=32)


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("g", [7, 5])
def test_the_moe_families_group_sizes(b, g):
    """The MoE decode steps' GQA at hd 128: G 7 (arctic-480b, 56 / 8 heads)
    and G 5 (llama4-maverick, 40 / 8; a group size no other served arch
    has), at the served batches 1, 2 and 8, a flat cache read past its
    first tile."""
    _check(_case(b + g, b, 96, 2, g, 128), length=71, pos=70, kv_block=32)


@pytest.mark.parametrize("s", [100, 1500])
@pytest.mark.parametrize("g,hd", [(1, 64), (8, 128)])
def test_cross_attention_shape(s, g, hd):
    """The cross-attention call of the audio and VLM decode steps: a static
    cache of S encoder frames or image patches, every slot valid (`length =
    pos = S`, no window), S not a multiple of the kernel's 64-position tile
    (1,500 is whisper's frame count); G 1 at hd 64 (whisper), G 8 at hd 128
    (llama-3.2-vision, the kernel's largest G)."""
    _check(_case(s + g, 2, s, 2, g, hd), length=s, pos=s)
    assert ops.valid_positions(s, length=s, pos=s, device="cpu").all()
    assert ops.any_valid(s, length=s, pos=s)


def test_bf16_cache():
    _check(_case(5, 2, 128, 2, 4, 64), tol=3e-2, jdtype=jnp.bfloat16,
           tdtype=torch.bfloat16, length=128, pos=127)


def test_attention_module_decode_is_the_plain_version():
    arrays = _case(9, 2, 64, 2, 2, 32)
    tq, tk, tv = (torch.tensor(a) for a in arrays)
    kw = dict(length=50, pos=49, window=16)
    assert torch.equal(attention.decode_attention(tq, tk, tv, **kw),
                       ops.decode_attention_plain(tq, tk, tv, **kw))


@pytest.mark.parametrize("sq,skv,window,cap,q_block,kv_block", [
    (96, 96, 0, 0.0, 32, 64),      # causal, padded kv tiles
    (100, 100, 24, 0.0, 32, 32),   # windowed, padded q and kv tiles
    (64, 64, 0, 30.0, 512, 1024),  # one tile, soft cap
])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_matches_the_reference(sq, skv, window, cap, q_block, kv_block, g):
    rng = np.random.default_rng(sq + g)
    arrays = tuple(rng.standard_normal(shape).astype(np.float32)
                   for shape in ((2, sq, 2 * g, 32), (2, skv, 2, 32), (2, skv, 2, 32)))
    kw = dict(causal=True, window=window, cap=cap, q_block=q_block, kv_block=kv_block)
    (q, k, v), (tq, tk, tv) = _both(arrays, jnp.float32, torch.float32)
    want = np.asarray(ref_attention.flash_attention(q, k, v, **kw))
    got = attention.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16():
    rng = np.random.default_rng(11)
    arrays = tuple(rng.standard_normal(shape).astype(np.float32)
                   for shape in ((1, 80, 4, 32), (1, 80, 4, 32), (1, 80, 4, 32)))
    (q, k, v), (tq, tk, tv) = _both(arrays, jnp.bfloat16, torch.bfloat16)
    want = np.asarray(ref_attention.flash_attention(q, k, v, window=32, q_block=32,
                                                    kv_block=32), np.float32)
    got = attention.flash_attention(tq, tk, tv, window=32, q_block=32, kv_block=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)



@pytest.mark.parametrize("ring", [False, True])
def test_any_valid_reads_the_mask(ring):
    """The wrapper refuses a call that leaves no slot valid (the kernel would
    write zeros where the plain version averages the whole cache); the host
    rule it uses agrees with the mask itself."""
    s = 16
    for length in range(0, 36, 3):
        for pos in range(-2, 40, 3):
            for window in (0, 1, 5, 16, 30):
                kw = dict(length=length, pos=pos, window=window, ring=ring)
                want = bool(ops.valid_positions(s, device="cpu", **kw).any())
                assert ops.any_valid(s, **kw) == want, kw


# -- the split: partials over P partitions and their merge --------------------

MERGE_CASES = {
    # a flat cache written to slot 20 of 96: the later partitions hold no valid slot
    "flat_short": (dict(b=2, s=96, hkv=2, g=4, hd=64), dict(length=21, pos=20)),
    # a ring written to slot 30 of 64: the same, on the ring
    "ring_early": (dict(b=2, s=64, hkv=2, g=1, hd=80),
                   dict(length=31, pos=30, window=64, ring=True)),
    # a ring past its wrap, with a cap: every partition valid
    "ring_wrapped": (dict(b=1, s=64, hkv=2, g=2, hd=32),
                     dict(length=101, pos=100, window=64, ring=True, cap=50.0)),
    # a window narrower than a partition, and S not divisible by P
    "window": (dict(b=2, s=100, hkv=1, g=7, hd=128), dict(length=90, pos=89, window=9)),
}


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_partials_equals_the_plain_version(case, parts):
    """Partials over P partitions (the split kernel's first step) merged by
    `merge_partials` (the merge kernel's plain version) equal
    `decode_attention_plain`, partitions with no valid slot included
    (weighted 0, no NaN)."""
    shape, kw = MERGE_CASES[case]
    q, k, v = (torch.tensor(a) for a in _case(parts, **shape))
    spp = -(-shape["s"] // parts)
    m, l, acc = ops.partials_plain(q, k, v, parts=parts, slots_per_part=spp, **kw)
    assert m.shape == l.shape == (shape["b"], shape["hkv"] * shape["g"], parts)
    empty = l == 0
    if case in ("flat_short", "ring_early") and parts > 1:
        assert empty.any()
    assert torch.all(m[empty] == ops.NEG_INF) and not acc[empty].any()
    got = ops.merge_partials(m, l, acc)
    assert torch.isfinite(got).all()
    want = ops.decode_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,hkv,hd,itemsize", [
    (2, 4096, 32, 80, 2),    # Zamba2's decode ring, bf16
    (2, 8192, 4, 128, 2),    # qwen2-like GQA, bf16
    (2, 1024, 2, 256, 4),    # wide rows, float32
    (1, 100, 2, 16, 4),      # a short cache: one tile a partition
    (64, 4096, 8, 128, 2),   # a batch that fills the card by itself
])
def test_plan_fills_the_card_from_the_shape(b, s, hkv, hd, itemsize):
    pl = ops.plan(b, s, hkv, hd, itemsize)
    ntiles = -(-s // pl.tile)
    assert pl.tile in (32, 64) and pl.stages in (2, 3)
    assert 3 * 2 * pl.tile * ops.row_bytes(hd, itemsize) <= ops.STAGE_BUDGET or pl.stages == 2
    assert (pl.parts - 1) * pl.tiles_per_part < ntiles <= pl.parts * pl.tiles_per_part
    assert b * hkv * pl.parts >= 2 * ops.SMS or pl.tiles_per_part == 1 or pl.parts == 1
    assert pl.launches == (1 if pl.parts == 1 else 2)
    assert ops.row_bytes(hd, itemsize) % 32 == 16
