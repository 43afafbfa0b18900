"""The batched kernels' plain versions and wrappers vs the JAX reference.

`resample_many_plain` (lda_gibbs) and `mh_resample_many_plain` (alias_mh)
are held against the reference's model-grid Pallas kernels
`gibbs_resample_blocked_batched` and `alias_mh_blocked_batched`, run as
the reference's own tests run them on the CPU: in interpret mode, with
per-model rows and tables pre-gathered and padded as its `ops.py` pads
(K to 128 lanes, N to the 256-token block; noise -inf, thresholds 0 and
accept uniforms 1 in the padding). Inputs, noise and draws are made with
numpy from a seed and handed to both sides. Each stack is ragged: every
model has its own real token count, the rest of its row is weight-0
padding.

Tolerance: topics are equal on every token except near-ties (a top-2
margin of score + noise below 1e-5 for lda_gibbs, an accept margin
|log u - log a| below 1e-5 in some round for alias_mh), where XLA's and
PyTorch's float32 `log` may differ by an ulp. Within the port, model m's
row of a batched call equals a single-model call on its own tables
exactly.

The Hopper kernels themselves run only on the card (`test_torch_cuda.py`);
here the wrappers take the plain versions because the tensors lie on the
CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.alias_mh import kernel as ref_alias_kernel  # noqa: E402
from repro.kernels.lda_gibbs import kernel as ref_kernel  # noqa: E402
from repro_torch.core import alias  # noqa: E402
from repro_torch.kernels.alias_mh import ops as alias_ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)
M, N, D, V = 3, 500, 40, 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stack(k, w_bits, seed, mh_steps=None):
    """A ragged stack of M models, all numpy: ids, z and weights (M, N)
    with weight-0 padding past each model's length (and 10% zero weights
    among its real tokens), stored count tables (M, D, K)/(M, V, K)/(M, K),
    then Gumbel noise (M, N, K) or, with `mh_steps`, the stale alias tables
    built from the real-unit counts and (M, S, N) draws."""
    rng = np.random.default_rng(seed)
    lengths = [N, N - 123, N // 2 + 7][:M]
    docs = rng.integers(0, D, (M, N)).astype(np.int32)
    words = rng.integers(0, V, (M, N)).astype(np.int32)
    z = rng.integers(0, k, (M, N)).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, (M, N)).astype(np.float32)
    weights[rng.random((M, N)) < 0.1] = 0.0
    for m, n_m in enumerate(lengths):
        docs[m, n_m:] = words[m, n_m:] = z[m, n_m:] = 0
        weights[m, n_m:] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (M, D, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (M, V, k)).astype(np.float32)
    if w_bits is not None:  # real counts on the fixed-point grid
        s = 1 << (w_bits + 1)
        n_dt, n_wt = (np.round(x * s) / s for x in (n_dt, n_wt))
    n_t = n_wt.sum(1, dtype=np.float32)
    head = (docs, words, z, weights)
    if mh_steps is None:
        tail = (rng.gumbel(size=(M, N, k)).astype(np.float32),)
    else:
        tw, aw = alias.build_alias_tables(torch.tensor(n_wt + HP["beta"]))
        td, ad = alias.build_alias_tables(torch.tensor(n_dt + HP["alpha"]))
        tail = (tw.numpy(), aw.numpy(), td.numpy(), ad.numpy(),
                rng.integers(0, k, (M, mh_steps, N)).astype(np.int32),
                rng.random((M, mh_steps, N)).astype(np.float32),
                rng.random((M, mh_steps, N)).astype(np.float32))
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, n_wt, n_t))
    return head + (n_dt, n_wt, n_t) + tail


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _per_model(table, ids):
    return np.stack([table[m][ids[m]] for m in range(table.shape[0])])


def _pad3(x, k, fill=0):
    kp, npad = -(-k // 128) * 128, -(-N // 256) * 256
    return jnp.asarray(np.pad(x, ((0, 0), (0, npad - N), (0, kp - k)), constant_values=fill))


def _pad_last(x, fill=0):
    npad = -(-N // 256) * 256
    pad = [(0, 0)] * (x.ndim - 1) + [(0, npad - N)]
    return jnp.asarray(np.pad(x, pad, constant_values=fill))


def _gibbs_near_ties_only(got, want, arrays, w_bits):
    scores = ops.perturbed_scores(*_torch(arrays), w_bits=w_bits, **HP)
    top2 = scores.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    diff = np.argwhere(np.asarray(got) != np.asarray(want))
    for m, i in diff:
        assert arrays[3][m, i] > 0, f"frozen token {m},{i} moved"
        assert margin[m, i] < NEAR_TIE, f"token {m},{i}: margin {margin[m, i]}"
    return len(diff)


def _alias_near_ties_only(got, want, arrays, w_bits):
    acc, _ = alias_ops.margins(*_torch(arrays), w_bits=w_bits, **HP)
    diff = np.argwhere(np.asarray(got) != np.asarray(want))
    for m, i in diff:
        assert arrays[3][m, i] > 0, f"frozen token {m},{i} moved"
        assert acc[m, i] < NEAR_TIE, f"token {m},{i}: accept margin {acc[m, i]}"
    return len(diff)


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [6, 16])
def test_resample_many_plain_matches_pallas_batched_interpret(k, w_bits):
    arrays = _stack(k, w_bits, seed=k + (w_bits or 0))
    docs, words, z, weights, n_dt, n_wt, n_t, noise = arrays
    got = ops.resample_many(*_torch(arrays), w_bits=w_bits, **HP)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    kp = -(-k // 128) * 128
    want = ref_kernel.gibbs_resample_blocked_batched(
        _pad3(_per_model(n_dt, docs), k), _pad3(_per_model(n_wt, words), k),
        jnp.asarray(np.pad(n_t, ((0, 0), (0, kp - k)))), _pad_last(z),
        _pad_last(weights), _pad3(noise, k, -np.inf),
        w_bits=w_bits, interpret=True, **HP)[:, :N]
    assert _gibbs_near_ties_only(got.numpy(), want, arrays, w_bits) <= M * N // 100
    pad = weights == 0
    np.testing.assert_array_equal(got.numpy()[pad], z[pad])


@pytest.mark.parametrize("mh_steps", [2, 4])
@pytest.mark.parametrize("w_bits", [None, 8])
def test_mh_resample_many_plain_matches_pallas_batched_interpret(w_bits, mh_steps):
    k = 12
    arrays = _stack(k, w_bits, seed=5 + mh_steps + (w_bits or 0), mh_steps=mh_steps)
    (docs, words, z, weights, n_dt, n_wt, n_t, tw, aw, td, ad,
     j_prop, u_prop, u_acc) = arrays
    got = alias_ops.mh_resample_many(*_torch(arrays), w_bits=w_bits, **HP)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    kp = -(-k // 128) * 128
    want = ref_alias_kernel.alias_mh_blocked_batched(
        _pad3(_per_model(n_dt, docs), k), _pad3(_per_model(n_wt, words), k),
        jnp.asarray(np.pad(n_t, ((0, 0), (0, kp - k)))),
        _pad3(_per_model(tw, words), k, 0.0), _pad3(_per_model(aw, words), k),
        _pad3(_per_model(td, docs), k, 0.0), _pad3(_per_model(ad, docs), k),
        _pad_last(z), _pad_last(weights), _pad_last(j_prop), _pad_last(u_prop, 0.0),
        _pad_last(u_acc, 1.0), w_bits=w_bits, interpret=True, **HP)[:, :N]
    assert _alias_near_ties_only(got.numpy(), want, arrays, w_bits) <= M * N // 100
    assert (got.numpy() != z).sum() > M * N // 20  # the chains move


@pytest.mark.parametrize("w_bits", [None, 8])
def test_model_rows_equal_single_model_calls(w_bits):
    """Row m of a batched call is exactly the single-model call on model
    m's own tables: no model reads another's counts."""
    arrays = _torch(_stack(12, w_bits, seed=2))
    got = ops.resample_many(*arrays, w_bits=w_bits, **HP)
    for m in range(M):
        one = ops.resample(*(a[m] for a in arrays), w_bits=w_bits, **HP)
        assert torch.equal(got[m], one)
    arrays = _torch(_stack(12, w_bits, seed=3, mh_steps=4))
    got = alias_ops.mh_resample_many(*arrays, w_bits=w_bits, **HP)
    for m in range(M):
        one = alias_ops.mh_resample(*(a[m].contiguous() for a in arrays), w_bits=w_bits, **HP)
        assert torch.equal(got[m], one)


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    g = _torch(_stack(12, 8, seed=4))
    a = _torch(_stack(12, 8, seed=4, mh_steps=2))
    before = (ops.resample_many.launches, alias_ops.mh_resample_many.launches)
    assert torch.equal(ops.resample_many(*g, w_bits=8, **HP),
                       ops.resample_many_plain(*g, w_bits=8, **HP))
    assert torch.equal(alias_ops.mh_resample_many(*a, w_bits=8, **HP),
                       alias_ops.mh_resample_many_plain(*a, w_bits=8, **HP))
    assert (ops.resample_many.launches, alias_ops.mh_resample_many.launches) == before
    with pytest.raises(ValueError, match="no lda_gibbs kernel"):
        ops.resample_many(*(t.to("meta") for t in g), w_bits=8, **HP)
    with pytest.raises(ValueError, match="no alias_mh kernel"):
        alias_ops.mh_resample_many(*(t.to("meta") for t in a), w_bits=8, **HP)


def test_batched_checks_refuse_what_the_kernels_do_not_take():
    good = list(_torch(_stack(12, 8, seed=6)))
    ops._check(*good, 8, many=True)

    def refused(i, bad, match, w_bits=8, many=True):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            ops._check(*args, w_bits, many=many)

    refused(7, good[7][0], r"noise must be \(M, N, K\)")
    refused(0, good[0][:2].contiguous(), "docs must be int32")
    refused(3, good[3][:, :10].contiguous(), "weights must be float32")
    refused(4, good[4][:2].contiguous(), "count tables")
    refused(6, good[6][:, :5].contiguous(), "count tables")
    refused(5, good[5].transpose(1, 2), "contiguous")
    with pytest.raises(ValueError, match=r"noise must be \(N, K\)"):
        ops._check(*good, 8)  # a stack is not one model

    good = list(_torch(_stack(12, 8, seed=7, mh_steps=2)))
    alias_ops._check(*good, 8, many=True)
    for i, bad, match in [
        (2, good[2][0], r"must be int32 of shape \(M, N\)"),
        (4, good[4][:2].contiguous(), "count tables"),
        (7, good[7][:, :5].contiguous(), "thresh_w must be float32"),
        (10, good[10][:1].contiguous(), "alias_d must be int32"),
        (11, good[11][0], "draws must be"),
        (13, good[13][:, :1].contiguous(), "u_acc must be float32"),
    ]:
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            alias_ops._check(*args, 8, many=True)
