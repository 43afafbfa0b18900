"""The alias-table build's wrapper (`kernels/alias_tables/ops.py`) off the
card: CPU and `meta` tensors take the plain version
(`core.alias.build_alias_tables`) and launch nothing, the argument check
refuses what the kernel does not take, and the rows counter counts each
implementation's rows while obs is on. The kernel itself is held to the
plain version bit for bit in `tests/test_torch_cuda.py` (marker `cuda`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import alias, types  # noqa: E402
from repro_torch.kernels.alias_tables import ops  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _counts(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.4, 2.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = 0.0
    return torch.tensor(x)


def _rows(impl):
    return metrics.REGISTRY.get("vedalia_alias_table_rows_total").value(impl=impl)


@pytest.mark.parametrize("shape,doc_shape", [((40, 12), (9, 12)), ((3, 25, 7), (3, 4, 7)),
                                             ((16,), (16,)), ((1, 5), (1, 5))])
def test_cpu_tables_are_the_plain_build_and_launch_nothing(shape, doc_shape):
    n_wt, n_dt = _counts(shape), _counts(doc_shape, 1)
    before = ops.build_tables.launches
    got = ops.build_tables(n_wt, 0.01, n_dt, 0.1)
    want = (*alias.build_alias_tables(n_wt + 0.01), *alias.build_alias_tables(n_dt + 0.1))
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * 2
    assert [t.shape for t in got] == [n_wt.shape] * 2 + [n_dt.shape] * 2
    assert ops.build_tables.launches == before


def test_meta_tables_take_the_plain_build_and_launch_nothing():
    before = ops.build_tables.launches
    tw, aw, td, ad = ops.build_tables(torch.empty(250, 256, device="meta"), 0.01,
                                      torch.empty(2, 200, 256, device="meta"), 0.1)
    assert (tw.device.type, tw.shape, aw.dtype) == ("meta", (250, 256), torch.int32)
    assert (td.shape, ad.shape) == ((2, 200, 256), (2, 200, 256))
    assert ops.build_tables.launches == before


def test_sweep_tables_on_the_cpu_are_unchanged():
    cfg = types.LDAConfig(num_topics=9, vocab_size=30, num_docs=11)
    n_dt, n_wt = _counts((11, 9), 1), _counts((30, 9), 2)
    got = alias.sweep_tables(cfg, n_dt, n_wt)
    want = (*alias.build_alias_tables(n_wt + cfg.beta), *alias.build_alias_tables(n_dt + cfg.alpha))
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.ones(4, 8, dtype=torch.float64), "float32"),
    (lambda: torch.ones(4, 8, dtype=torch.int32), "float32"),
    (lambda: torch.ones(8, 4).t(), "contiguous"),
    (lambda: torch.ones(4, 0), "K >= 1"),
    (lambda: torch.ones(()), "K >= 1"),
])
def test_argument_check_refuses_what_the_kernel_does_not_take(bad, match):
    before = ops.build_tables.launches
    with pytest.raises(ValueError, match=match):
        ops.build_tables(torch.ones(3, 8), 0.1, bad(), 0.1)
    with pytest.raises(ValueError, match=match):
        ops.build_tables(bad(), 0.1, torch.ones(3, 8), 0.1)
    assert ops.build_tables.launches == before


def test_rows_counter_counts_plain_rows_only_while_obs_is_on():
    counts = (_counts((6, 5, 4)), _counts((9, 4), 3))
    start = _rows("plain"), _rows("kernel")
    with obs.config.scope(False):
        ops.build_tables(counts[0], 0.5, counts[1], 0.5)
    assert (_rows("plain"), _rows("kernel")) == start
    with obs.config.scope(True):
        ops.build_tables(counts[0], 0.5, counts[1], 0.5)
    assert (_rows("plain"), _rows("kernel")) == (start[0] + 30 + 9, start[1])


@pytest.mark.parametrize("doc", [lambda: torch.ones(5, 9),
                                 lambda: torch.ones(5, 8, device="meta")])
def test_build_tables_refuses_two_tables_of_another_k_or_device(doc):
    """A sweep's two tables share K and a device: one launch builds both."""
    before = ops.build_tables.launches
    with pytest.raises(ValueError, match="one K and one device"):
        ops.build_tables(torch.ones(3, 8), 0.1, doc(), 0.1)
    assert ops.build_tables.launches == before


@pytest.mark.parametrize("k,rows,offset,here", [
    (128, 3000, 0, False), (132, 3000, 0, True), (130, 3000, 0, False), (256, 16, 0, True),
    (256, 15, 0, False), (256, 3000, 1, False), (8160, 40, 0, True), (8164, 40, 0, False)])
def test_kernel_sums_rows_only_where_pytorch_gives_a_row_a_warp(k, rows, offset, here):
    """The rule `sums_in_kernel` applies: K a multiple of 4 in [132, 8160],
    16 rows or more, rows 16-byte aligned (the card tests hold the sums it
    picks to PyTorch's bit for bit)."""
    flat = torch.zeros(rows * k + offset)
    assert ops.sums_in_kernel(flat[offset:].view(rows, k)) == here
