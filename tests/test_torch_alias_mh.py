"""The alias_mh kernel's plain version and wrapper vs the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel `alias_mh_blocked` in interpret mode (rows and tables pre-gathered
per token; K lane-padded to 128 and N padded to the 256-token block as its
`ops.py` pads: thresholds with 0.0, accept uniforms with 1.0) and the
pure-jnp oracle `ref.mh_tile`. Inputs, tables and draws are made with numpy
from a seed and handed to both sides.

Tolerance: topics are equal on every token except accept near-ties, where
|log u_acc - log a| is below 1e-5 in some round — XLA's and PyTorch's
float32 `log` may differ by an ulp there. Both sides read identical tables,
so the proposal step itself never differs.

The Hopper kernel itself runs only on the card (`test_torch_cuda.py`);
here the wrapper takes the plain version because the tensors lie on the
CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.alias_mh import kernel as ref_kernel  # noqa: E402
from repro.kernels.alias_mh import ref as ref_ref  # noqa: E402
from repro_torch.core import alias  # noqa: E402
from repro_torch.kernels.alias_mh import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, k, w_bits, seed, mh_steps=4, d=60, v=300):
    """Ids, assignments, weights (10% zero), count tables (float32 or int32
    fixed point), the stale alias tables built from the real-unit counts,
    and (S, N) draws — all numpy."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    z = rng.integers(0, k, n).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0  # frozen / padding tokens
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (v, k)).astype(np.float32)
    if w_bits is not None:
        sc = 1 << (w_bits + 1)
        n_dt, n_wt = (np.round(x * sc) / sc for x in (n_dt, n_wt))
    n_t = n_wt.sum(0, dtype=np.float32)
    tw, aw = alias.build_alias_tables(torch.tensor(n_wt + HP["beta"], dtype=torch.float32))
    td, ad = alias.build_alias_tables(torch.tensor(n_dt + HP["alpha"], dtype=torch.float32))
    if w_bits is not None:
        sc = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * sc).astype(np.int32) for x in (n_dt, n_wt, n_t))
    j_prop = rng.integers(0, k, (mh_steps, n)).astype(np.int32)
    u_prop = rng.random((mh_steps, n)).astype(np.float32)
    u_acc = rng.random((mh_steps, n)).astype(np.float32)
    return (docs, words, z, weights, n_dt, n_wt, n_t, tw.numpy(), aw.numpy(), td.numpy(),
            ad.numpy(), j_prop, u_prop, u_acc)


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _assert_same_but_near_ties(got, want, arrays, w_bits):
    got, want = np.asarray(got), np.asarray(want)
    acc, _ = ops.margins(*_torch(arrays), w_bits=w_bits, **HP)
    acc = acc.numpy()
    weights = arrays[3]
    diff = np.flatnonzero(got != want)
    for i in diff:
        assert weights[i] > 0, f"frozen token {i} moved"
        assert acc[i] < NEAR_TIE, f"token {i}: {got[i]} vs {want[i]}, accept margin {acc[i]}"
    return len(diff)


@pytest.mark.parametrize("mh_steps", [2, 4])
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128, 200])
def test_plain_matches_pallas_kernel_interpret(k, w_bits, mh_steps):
    n = 1000
    arrays = _inputs(n, k, w_bits, seed=k + (w_bits or 0) + mh_steps, mh_steps=mh_steps)
    (docs, words, z, weights, n_dt, n_wt, n_t, tw, aw, td, ad,
     j_prop, u_prop, u_acc) = arrays
    got = ops.mh_resample(*_torch(arrays), w_bits=w_bits, **HP)
    assert got.dtype == torch.int32 and got.shape == (n,)

    kp, npad = -(-k // 128) * 128, -(-n // 256) * 256

    def pad2(x, fill=0):
        return jnp.asarray(np.pad(x, ((0, npad - n), (0, kp - k)), constant_values=fill))

    def pad1(x):
        return jnp.asarray(np.pad(x, (0, npad - n)))

    def pad_s(x, fill=0):
        return jnp.asarray(np.pad(x, ((0, 0), (0, npad - n)), constant_values=fill))

    want = ref_kernel.alias_mh_blocked(
        pad2(n_dt[docs]), pad2(n_wt[words]), jnp.asarray(np.pad(n_t, (0, kp - k))),
        pad2(tw[words], 0.0), pad2(aw[words]), pad2(td[docs], 0.0), pad2(ad[docs]),
        pad1(z), pad1(weights), pad_s(j_prop), pad_s(u_prop, 0.0), pad_s(u_acc, 1.0),
        w_bits=w_bits, interpret=True, **HP)[:n]
    flips = _assert_same_but_near_ties(got.numpy(), want, arrays, w_bits)
    assert flips <= n // 100


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128, 200])
def test_plain_matches_reference_oracle(k, w_bits):
    n = 2048
    arrays = _inputs(n, k, w_bits, seed=7 * k + 1)
    (docs, words, z, weights, n_dt, n_wt, n_t, tw, aw, td, ad,
     j_prop, u_prop, u_acc) = arrays
    got = ops.mh_resample_plain(*_torch(arrays), w_bits=w_bits, **HP)
    s = np.float32(1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    want = ref_ref.mh_tile(
        jnp.asarray(n_dt[docs] * s), jnp.asarray(n_wt[words] * s), jnp.asarray(n_t * s),
        jnp.asarray(tw[words]), jnp.asarray(aw[words]), jnp.asarray(td[docs]),
        jnp.asarray(ad[docs]), jnp.asarray(z), jnp.asarray(weights), jnp.asarray(j_prop),
        jnp.asarray(u_prop), jnp.asarray(u_acc), **HP)
    _assert_same_but_near_ties(got.numpy(), want, arrays, w_bits)
    # The chain does move: a dead proposal would leave every token in place.
    assert (got.numpy() != z).sum() > n // 10


@pytest.mark.parametrize("w_bits", [None, 8])
def test_frozen_tokens_keep_their_topic(w_bits):
    arrays = list(_inputs(500, 12, w_bits, seed=5))
    arrays[3][::2] = 0.0  # half the tokens frozen
    arrays[13][:] = 0.0  # u_acc = 0: log u = -inf, every live proposal accepted
    got = ops.mh_resample(*_torch(arrays), w_bits=w_bits, **HP).numpy()
    frozen = arrays[3] == 0.0
    np.testing.assert_array_equal(got[frozen], arrays[2][frozen])
    acc, prop = ops.margins(*_torch(arrays), w_bits=w_bits, **HP)
    assert torch.isinf(acc[torch.as_tensor(frozen)]).all()
    assert torch.isinf(prop[torch.as_tensor(frozen)]).all()
    assert torch.isfinite(prop[~torch.as_tensor(frozen)]).all()


def test_margins_find_the_tokens_a_perturbed_log_would_flip():
    """Scaling every accept uniform by 1 + 1e-3 shifts log u by about 1e-3:
    exactly the tokens whose accept margin is below that may move."""
    arrays = _inputs(20000, 12, None, seed=8)
    base = ops.mh_resample_plain(*_torch(arrays), **HP)
    nudged = list(arrays)
    nudged[13] = (arrays[13] * np.float32(1 + 1e-3)).astype(np.float32)
    moved = (ops.mh_resample_plain(*_torch(nudged), **HP) != base).numpy()
    acc, _ = ops.margins(*_torch(arrays), **HP)
    assert moved.any()
    assert (acc.numpy()[moved] < 1.001e-3).all()


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    arrays = _torch(_inputs(300, 12, None, seed=3))
    before = ops.mh_resample.launches
    got = ops.mh_resample(*arrays, **HP)
    assert torch.equal(got, ops.mh_resample_plain(*arrays, **HP))
    assert ops.mh_resample.launches == before


def test_draws_are_seeded_and_in_range():
    a = alias.sweep_draws(torch.Generator().manual_seed(1), 5000, 7, 3, "cpu")
    b = alias.sweep_draws(torch.Generator().manual_seed(1), 5000, 7, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    j, up, ua = a
    assert j.dtype == torch.int32 and j.shape == (3, 5000)
    assert int(j.min()) == 0 and int(j.max()) == 6
    for u in (up, ua):
        assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02


def test_wrapper_checks_what_the_kernel_takes():
    good = list(_torch(_inputs(64, 12, 8, seed=4)))
    ops._check(*good, 8)

    def refused(i, bad, match, w_bits=8):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            ops._check(*args, w_bits)

    with pytest.raises(ValueError, match="must be torch.float32"):
        ops._check(*good, None)  # int tables need w_bits
    refused(0, good[0].long(), "docs must be int32")
    refused(1, good[1][:10].contiguous(), "words must be int32")
    refused(3, good[3].double(), "weights must be float32")
    refused(4, good[4][:, :5].contiguous(), "count tables")
    refused(7, good[7][:, :5].contiguous(), "thresh_w must be float32")
    refused(8, good[8].float(), "alias_w must be int32")
    refused(10, good[10][:7].contiguous(), "alias_d must be int32")
    refused(11, good[11][:, :10].contiguous(), "draws must be")
    refused(11, good[11].long(), "j_prop must be int32")
    refused(13, good[13][:1].contiguous(), "u_acc must be float32")
    refused(12, good[12].t().contiguous().t(), "contiguous")
    refused(5, torch.empty(good[5].shape, dtype=torch.int32, device="meta"), "n_wt is on meta")
    # No kernel for a device other than the card; the CPU takes the plain
    # version, and so does `meta` (the dry run's shape propagation).
    z = ops.mh_resample(*(t.to("meta") for t in good), w_bits=8, **HP)
    assert z.device.type == "meta" and z.shape == good[2].shape
    elsewhere = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no alias_mh kernel"):
        ops.mh_resample(*[elsewhere] * 11, w_bits=8, **HP)
