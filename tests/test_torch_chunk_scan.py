"""The chunk_scan kernel's plain version and the Mamba2 mixer vs the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel `chunk_scan_pallas` in interpret mode (through
`repro.kernels.chunk_scan.ops`) and the sequential oracle
`chunk_scan_reference`. Inputs are made with numpy from a seed and handed
to both sides.

Tolerance: float32 within 3e-5 (the reference's own); bf16 inputs with y
within 5e-2 and the state within 2e-2 (the reference's bf16 tolerances).
The Mamba2 mixer on carried-across weights runs bf16 activations on both
sides, and PyTorch's `silu` rounds once where XLA's rounds each of its four
bf16 steps, so its outputs differ by a bf16 ulp or two: measured worst 0.7%
of the output's scale for y and 0.5% for the float32 state; bounded at 2%.

The Hopper kernel itself runs only on the card (`test_torch_cuda.py`);
here the wrapper takes the plain version because the tensors lie on the
CPU.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.chunk_scan import ops as ref_ops  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels.chunk_scan import kernel, ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.6, 1.0, (b, s, h, dk)).astype(np.float32),
            (rng.standard_normal((b, s, h, dk)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, h, dv)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, h, dk)) * 0.3).astype(np.float32),
            (rng.standard_normal((h, dk)) * 0.1).astype(np.float32),
            (rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32))


def _jax(arrays, dtype):
    w, k, v, q, u, s0 = arrays
    return (*(jnp.asarray(x, dtype) for x in (w, k, v, q)), jnp.asarray(u), jnp.asarray(s0))


def _torch(arrays, dtype):
    w, k, v, q, u, s0 = arrays
    return (*(torch.tensor(x).to(dtype) for x in (w, k, v, q)), torch.tensor(u),
            torch.tensor(s0))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,dk,dv", [
    (2, 128, 2, 64, 64), (1, 256, 4, 32, 32), (2, 64, 1, 128, 64), (3, 96, 2, 64, 128),
])
@pytest.mark.parametrize("include_current", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_matches_pallas_kernel_and_oracle(b, s, h, dk, dv, include_current, chunk):
    arrays = _inputs(b * s + dk, b, s, h, dk, dv)
    w, k, v, q, u, s0 = _jax(arrays, jnp.float32)
    uu = None if include_current else u
    y_k, S_k = ref_ops.chunk_scan(w, k, v, q, uu, include_current=include_current,
                                  chunk=chunk, s0=s0)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.float32)
    y, S = ops.chunk_scan(tw, tk, tv, tq, None if include_current else tu,
                          include_current=include_current, chunk=chunk, s0=ts0)
    assert y.dtype == torch.float32 and S.dtype == torch.float32
    assert ops.chunk_scan.launches == 0  # CPU tensors never launch the kernel
    _close(y, y_k, 3e-5)
    _close(S, S_k, 3e-5)
    if chunk == 32:  # the oracle once per shape and mode
        y_r, S_r = ref_ssm.chunk_scan_reference(w, k, v, q, uu,
                                                include_current=include_current, s0=s0)
        _close(y, y_r, 3e-5)
        _close(S, S_r, 3e-5)


@pytest.mark.parametrize("include_current", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ragged_length_runs_at_the_largest_divisor(include_current, with_s0):
    arrays = _inputs(7, 2, 100, 2, 32, 48)  # 100 tokens at chunk 32 -> chunk 25
    assert ops.chunk_len(100, 32) == 25 and ops.chunk_len(128, 32) == 32
    w, k, v, q, u, s0 = _jax(arrays, jnp.float32)
    s0 = s0 if with_s0 else None
    y_k, S_k = ref_ops.chunk_scan(w, k, v, q, u, include_current=include_current,
                                  chunk=32, s0=s0)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.float32)
    y, S = ops.chunk_scan(tw, tk, tv, tq, tu, include_current=include_current, chunk=32,
                          s0=ts0 if with_s0 else None)
    _close(y, y_k, 3e-5)
    _close(S, S_k, 3e-5)


@pytest.mark.parametrize("include_current", [False, True])
def test_bf16_inputs(include_current):
    arrays = _inputs(0, 2, 64, 2, 64, 64)
    w, k, v, q, u, s0 = _jax(arrays, jnp.bfloat16)
    uu = None if include_current else u
    y_k, S_k = ref_ops.chunk_scan(w, k, v, q, uu, include_current=include_current,
                                  chunk=32, s0=s0)
    y_r, S_r = ref_ssm.chunk_scan_reference(w, k, v, q, uu,
                                            include_current=include_current, s0=s0)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.bfloat16)
    y, S = ops.chunk_scan(tw, tk, tv, tq, tu, include_current=include_current, chunk=32,
                          s0=ts0)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    for want_y, want_S in ((y_k, S_k), (y_r, S_r)):
        _close(y, want_y, 5e-2)
        _close(S, want_S, 2e-2)


@pytest.mark.parametrize("include_current", [False, True])
def test_system_chunk_scan_and_oracle_match_the_reference(include_current):
    """The port's `ssm.chunk_scan` against its own sequential oracle and the
    reference's, and `recurrence_step` token by token against both."""
    arrays = _inputs(1, 2, 96, 3, 32, 64)
    w, k, v, q, u, s0 = _jax(arrays, jnp.float32)
    uu = None if include_current else u
    y_r, S_r = ref_ssm.chunk_scan_reference(w, k, v, q, uu,
                                            include_current=include_current, s0=s0)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.float32)
    tuu = None if include_current else tu
    y_c, S_c = ssm.chunk_scan(tw, tk, tv, tq, tuu, include_current=include_current,
                              chunk=24, s0=ts0)
    y_o, S_o = ssm.chunk_scan_reference(tw, tk, tv, tq, tuu,
                                        include_current=include_current, s0=ts0)
    for y, S in ((y_c, S_c), (y_o, S_o)):
        _close(y, y_r, 3e-5)
        _close(S, S_r, 3e-5)
    S, ys = ts0, []
    for t in range(16):
        S, y = ssm.recurrence_step(S, tw[:, t], tk[:, t], tv[:, t], tq[:, t], tu,
                                   include_current=include_current)
        ys.append(y)
    y16, S16 = ssm.chunk_scan_reference(tw[:, :16], tk[:, :16], tv[:, :16], tq[:, :16],
                                        tuu, include_current=include_current, s0=ts0)
    _close(torch.stack(ys, 1), y16.numpy(), 1e-5)
    _close(S, S16.numpy(), 1e-5)


# -- the Mamba2 mixer on carried-across weights ------------------------------


@pytest.fixture(scope="module")
def mamba_layer():
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    from repro_torch import configs
    from repro_torch.models import convert

    cfg_r = ref_configs.get("zamba2-2.7b").reduced()
    cfg = configs.get("zamba2-2.7b").reduced()
    params = ref_model.init_model(cfg_r, jax.random.PRNGKey(0))
    p_r = jax.tree.map(lambda a: a[0, 1], params["blk"])
    p = convert.params_from_reference(jax.tree.map(np.asarray, p_r), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    return cfg_r, cfg, p_r, p, x


def _scaled_close(got, want, frac):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def test_mamba2_mix_matches_the_reference(mamba_layer):
    cfg_r, cfg, p_r, p, x = mamba_layer
    y_r, (S_r, c_r) = ref_ssm.mamba2_mix(p_r, jnp.asarray(x, jnp.bfloat16), None, None, cfg_r)
    y, (S, c) = ssm.mamba2_mix(p, torch.tensor(x).bfloat16(), None, None, cfg)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32 and c.dtype == torch.bfloat16
    assert S.shape == (2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    _scaled_close(y, y_r, 2e-2)
    _scaled_close(S, S_r, 2e-2)
    _scaled_close(c, c_r, 1e-2)


def test_mamba2_mix_step_matches_the_reference(mamba_layer):
    cfg_r, cfg, p_r, p, x = mamba_layer
    _, (S_r, c_r) = ref_ssm.mamba2_mix(p_r, jnp.asarray(x[:, :32], jnp.bfloat16), None, None,
                                       cfg_r)
    S, c = torch.tensor(np.asarray(S_r)), torch.tensor(np.asarray(c_r, np.float32)).bfloat16()
    x1 = x[:, 32:33]
    y_r, (S1_r, c1_r) = ref_ssm.mamba2_mix_step(p_r, jnp.asarray(x1, jnp.bfloat16), S_r, c_r,
                                                cfg_r)
    y, (S1, c1) = ssm.mamba2_mix_step(p, torch.tensor(x1).bfloat16(), S, c, cfg)
    _scaled_close(y, y_r, 2e-2)
    _scaled_close(S1, S1_r, 2e-2)
    _scaled_close(c1, c1_r, 1e-2)


# -- the Mamba2 entry: a decay scalar a head, k and q shared by every head ----


def _mamba2_inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.6, 1.0, (b, s, h)).astype(np.float32),
            (rng.standard_normal((b, s, dk)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, dk)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, h, dv)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32))


def _broadcast(w, k, q, h):
    """The reference's `mamba2_mix` inputs: w over dk, k and q over heads."""
    b, s, dk = k.shape
    return (np.broadcast_to(w[..., None], (b, s, h, dk)),
            np.broadcast_to(k[:, :, None], (b, s, h, dk)),
            np.broadcast_to(q[:, :, None], (b, s, h, dk)))


@pytest.mark.parametrize("b,s,h,dk,dv", [
    (2, 128, 2, 64, 64), (1, 256, 4, 32, 32), (2, 64, 1, 128, 64), (3, 96, 2, 64, 128),
])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mamba2_entry_matches_pallas_kernel_and_plain(b, s, h, dk, dv, chunk):
    """`chunk_scan_mamba2` (its plain version, on CPU tensors) against the
    reference's Pallas kernel in interpret mode and the port's general entry,
    both on the broadcast inputs, float32 within 3e-5."""
    w, k, q, v, s0 = _mamba2_inputs(b * s + dk + 1, b, s, h, dk, dv)
    wb, kb, qb = _broadcast(w, k, q, h)
    y_k, S_k = ref_ops.chunk_scan(*(jnp.asarray(x) for x in (wb, kb, v, qb)), None,
                                  include_current=True, chunk=chunk, s0=jnp.asarray(s0))
    tw, tk, tq, tv, ts0 = (torch.tensor(x) for x in (w, k, q, v, s0))
    y, S = ops.chunk_scan_mamba2(tw, tk, tq, tv, chunk=chunk, s0=ts0)
    assert y.dtype == torch.float32 and S.shape == (b, h, dk, dv)
    assert ops.chunk_scan.launches == 0
    _close(y, y_k, 3e-5)
    _close(S, S_k, 3e-5)
    y_p, S_p = ops.chunk_scan_plain(*(torch.tensor(np.ascontiguousarray(x))
                                      for x in (wb, kb, v, qb)), None, include_current=True,
                                    chunk=chunk, s0=ts0)
    assert torch.equal(y, y_p) and torch.equal(S, S_p)


@pytest.mark.parametrize("s,chunk", [(100, 32), (600, 64)])  # chunks of 25 and 60
@pytest.mark.parametrize("with_s0", [False, True])
def test_mamba2_entry_ragged_lengths(s, chunk, with_s0):
    w, k, q, v, s0 = _mamba2_inputs(s + int(with_s0), 2, s, 2, 32, 48)
    s0 = s0 if with_s0 else None
    wb, kb, qb = _broadcast(w, k, q, 2)
    y_k, S_k = ref_ops.chunk_scan(*(jnp.asarray(x) for x in (wb, kb, v, qb)), None,
                                  include_current=True, chunk=chunk,
                                  s0=None if s0 is None else jnp.asarray(s0))
    y, S = ops.chunk_scan_mamba2(*(torch.tensor(x) for x in (w, k, q, v)), chunk=chunk,
                                 s0=None if s0 is None else torch.tensor(s0))
    _close(y, y_k, 3e-5)
    _close(S, S_k, 3e-5)


def test_mamba2_entry_bf16_inputs():
    w, k, q, v, s0 = _mamba2_inputs(3, 2, 64, 2, 64, 64)
    wb, kb, qb = _broadcast(w, k, q, 2)
    y_k, S_k = ref_ops.chunk_scan(*(jnp.asarray(x, jnp.bfloat16) for x in (wb, kb, v, qb)),
                                  None, include_current=True, chunk=32, s0=jnp.asarray(s0))
    y, S = ops.chunk_scan_mamba2(torch.tensor(w).bfloat16(), torch.tensor(k).bfloat16(),
                                 torch.tensor(q).bfloat16(), torch.tensor(v).bfloat16(),
                                 chunk=32, s0=torch.tensor(s0))
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    _close(y, y_k, 5e-2)
    _close(S, S_k, 2e-2)


@pytest.mark.parametrize("b,h,dv,want", [(2, 80, 64, 32), (1, 80, 64, 16), (1, 2, 48, 16),
                                         (4, 80, 48, 16)])
def test_mamba2_entry_fills_the_card_from_the_shape(b, h, dv, want):
    blk = ops.dv_block(b, h, dv)
    assert blk == want
    assert dv % blk == 0
    assert b * h * (dv // blk) >= 2 * ops.SMS or blk == 16


# -- the general entry's kernel decomposition, replayed in eager PyTorch ------


def _source_constant(name):
    """A design constant of the general entry's CUDA source, read from the
    file the card builds (`constexpr int <name> = <value>;`)."""
    found = re.findall(rf"constexpr int {name} = (\d+);", kernel.SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


SUB = _source_constant("kSub")  # rows of a prep sub-chunk
DVB = _source_constant("kDvb")  # state columns a scan block owns (the library's `dv_block()`)


def _replay(w, k, v, q, u, *, include_current, chunk, s0=None):
    """The card's two kernels step by step: per chunk the prep's record (the
    decays; A over sub-chunks of SUB rows, the diagonal blocks with one exp a
    (t, i, d), the blocks below them as the product of the anchored factors
    qf, M and kf), then the state pass over slices of DVB state columns."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    c = ops.chunk_len(s, chunk)
    n = s // c

    def chunked(x):  # (B, H, n, C, d)
        return x.float().reshape(b, n, c, h, -1).permute(0, 3, 1, 2, 4)

    lw = chunked(torch.clamp(torch.log(torch.clamp_min(w.float(), 1e-30)), ops.LOG_W_MIN, 0.0))
    kc, vc, qc = chunked(k), chunked(v), chunked(q)
    L = torch.cumsum(lw, dim=-2)
    Lq = L if include_current else L - lw
    Lc = L[..., -1:, :]
    qs, kd, elc = qc * torch.exp(Lq), kc * torch.exp(Lc - L), torch.exp(Lc[..., 0, :])
    A = torch.zeros(b, h, n, c, c)
    for T in range(-(-c // SUB)):
        rows = slice(SUB * T, min(SUB * T + SUB, c))
        m = rows.stop - rows.start
        ratio = Lq[..., rows, None, :] - L[..., None, rows, :]
        blk = torch.sum(torch.exp(ratio) * qc[..., rows, None, :] * kc[..., None, rows, :], -1)
        keep = torch.tril(torch.ones(m, m, dtype=torch.bool), 0 if include_current else -1)
        A[..., rows, rows] = torch.where(keep, blk, 0.0)
        a = SUB * T - 1  # the row before sub-chunk T
        for I in range(T):
            cols, r = slice(SUB * I, SUB * I + SUB), SUB * I + SUB - 1  # r: I's last row
            qf = qc[..., rows, :] * torch.exp(Lq[..., rows, :] - L[..., a:a + 1, :])
            kf = kc[..., cols, :] * torch.exp(L[..., r:r + 1, :] - L[..., cols, :])
            M = torch.exp(L[..., a:a + 1, :] - L[..., r:r + 1, :])
            A[..., rows, cols] = (qf * M) @ kf.transpose(-1, -2)
    if not include_current:
        uf = torch.zeros(h, dk) if u is None else u.float()
        diag = torch.sum(qc * uf[None, :, None, None, :] * kc, -1)
        A = A + torch.diag_embed(diag)
    S = torch.zeros(b, h, dk, dv) if s0 is None else s0.float().clone()
    y = torch.empty(b, h, n, c, dv)
    for e0 in range(0, dv, DVB):
        sl = slice(e0, e0 + DVB)
        St = S[..., sl]
        for i in range(n):
            vs = vc[:, :, i, :, sl]
            y[:, :, i, :, sl] = qs[:, :, i] @ St + A[:, :, i] @ vs
            St = elc[:, :, i, :, None] * St + kd[:, :, i].transpose(-1, -2) @ vs
        S[..., sl] = St
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, dv).to(v.dtype), S


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 128, 2, 64, 64, 32),
    (1, 100, 2, 32, 48, 32),  # ragged: chunk 25
    (1, 600, 2, 32, 48, 64),  # ragged: chunk 60, dk != dv
    (2, 64, 3, 20, 40, 16),   # dk 20, dv 40: a last slice of 8 columns
])
@pytest.mark.parametrize("include_current", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
def test_kernel_decomposition_matches_plain_and_pallas_kernel(b, s, h, dk, dv, chunk,
                                                             include_current, with_s0):
    """The prep's record and the sliced state pass, replayed, against the
    plain version and the reference's Pallas kernel in interpret mode,
    float32 within 3e-5."""
    arrays = _inputs(b * s + dk + int(with_s0), b, s, h, dk, dv)
    w, k, v, q, u, s0 = _jax(arrays, jnp.float32)
    s0 = s0 if with_s0 else None
    uu = None if include_current else u
    y_k, S_k = ref_ops.chunk_scan(w, k, v, q, uu, include_current=include_current,
                                  chunk=chunk, s0=s0)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.float32)
    ts0 = ts0 if with_s0 else None
    kw = dict(include_current=include_current, chunk=chunk, s0=ts0)
    y, S = _replay(tw, tk, tv, tq, tu, **kw)
    y_p, S_p = ops.chunk_scan_plain(tw, tk, tv, tq, tu, **kw)
    for want_y, want_S in ((y_p, S_p), (y_k, S_k)):
        _close(y, np.asarray(want_y), 3e-5)
        _close(S, np.asarray(want_S), 3e-5)


@pytest.mark.parametrize("with_s0", [False, True])
def test_kernel_decomposition_rwkv6_without_u(with_s0):
    """rwkv6 mode with u None: a bonus of zeros, as the reference takes it."""
    arrays = _inputs(11 + int(with_s0), 2, 96, 2, 64, 32)
    w, k, v, q, _, s0 = _jax(arrays, jnp.float32)
    s0 = s0 if with_s0 else None
    y_k, S_k = ref_ops.chunk_scan(w, k, v, q, None, include_current=False, chunk=32, s0=s0)
    tw, tk, tv, tq, _, ts0 = _torch(arrays, torch.float32)
    kw = dict(include_current=False, chunk=32, s0=ts0 if with_s0 else None)
    y, S = _replay(tw, tk, tv, tq, None, **kw)
    y_p, S_p = ops.chunk_scan_plain(tw, tk, tv, tq, None, **kw)
    for want_y, want_S in ((y_p, S_p), (y_k, S_k)):
        _close(y, np.asarray(want_y), 3e-5)
        _close(S, np.asarray(want_S), 3e-5)


def test_kernel_decomposition_past_a_thousand_tokens():
    """rwkv6's served widths (H 32 cut to 2) over 2,048 tokens: the state
    carries through 64 chunks, so float32 within 1e-4."""
    arrays = _inputs(5, 1, 2048, 2, 64, 64)
    tw, tk, tv, tq, tu, ts0 = _torch(arrays, torch.float32)
    kw = dict(include_current=False, chunk=32, s0=ts0)
    y, S = _replay(tw, tk, tv, tq, tu, **kw)
    y_p, S_p = ops.chunk_scan_plain(tw, tk, tv, tq, tu, **kw)
    _close(y, y_p.numpy(), 1e-4)
    _close(S, S_p.numpy(), 1e-4)


@pytest.mark.parametrize("b,h,dv,want", [(2, 32, 64, (64, 4)), (1, 32, 64, (32, 4)),
                                         (2, 32, 40, (64, 3)), (2, 32, 128, (64, 8))])
def test_general_entry_scan_grid_follows_the_shape(b, h, dv, want):
    """A scan block a (b, h) and slice of the source's DVB state columns
    (the last slice ragged): 256 blocks at rwkv6's B 2 (2 on 124 of the
    H100's 132 SMs), 128 at B 1. The card test
    `test_chunk_scan_scan_grid_on_card` holds the built library's
    `dv_block()` and the launched grid to the same."""
    slices = -(-dv // DVB)
    assert (b * h, slices) == want
    assert slices * DVB >= dv > (slices - 1) * DVB


@pytest.mark.parametrize("b,s", [(2, 4096), (2, 512), (1, 512)])
def test_general_entry_scratch_at_rwkv6_served_shapes(b, s):
    """One record a chunk: kd (32 x 64), qs^T (64 x 32), A^T (32 x 32),
    exp(Lc) (64), float32 — 20,736 bytes; 170 MB at 2 x 4096."""
    assert kernel.record_floats(64, 32) == 2 * 32 * 64 + 32 * 32 + 64 == 5184
    n = b * 32 * (s // 32)
    assert kernel.scratch_floats(b, s, 32, 64, 32) == n * 5184
    if (b, s) == (2, 4096):
        assert kernel.scratch_floats(b, s, 32, 64, 32) * 4 == 169_869_312
    # Ragged and odd widths round the chunk and dk up to 4 in a record.
    assert kernel.record_floats(20, 25) == 2 * 28 * 20 + 28 * 28 + 20
