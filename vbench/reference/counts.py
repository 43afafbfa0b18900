"""The count tables rebuilt from assignments, in plain PyTorch, and how far
a program's stored tables lie from them.

`rebuild` sums each token's weight into (doc, topic) and (word, topic) and
the topic totals, in float64 by default, with the number of tokens summed
into each entry. The program stores float32 sums rounded to the fixed
point (unit 2^-(w_bits+1)), so an entry of it may lie from the exact sum
by half a unit plus the float32 sum's own error, at most (n - 1) 2^-24 of
the sum for n terms. `deviation` is the largest ratio of an entry's
distance to that allowance: at most 1 for a sound rebuild.
"""

from __future__ import annotations

from typing import Optional

import torch

F32_ROUNDOFF = 2.0 ** -24


def _scatter(rows, z, w, num_rows: int, k: int, dtype) -> torch.Tensor:
    m = rows.shape[0]
    flat = (torch.arange(m, device=rows.device)[:, None] * num_rows + rows.long()) * k + z.long()
    out = torch.zeros(m * num_rows * k, dtype=dtype, device=rows.device)
    out.index_add_(0, flat.reshape(-1), w.reshape(-1).to(dtype))
    return out.view(m, num_rows, k)


def rebuild(docs, words, z, weights, num_docs: int, vocab_size: int, k: int,
            dtype=torch.float64) -> dict:
    """Stacked (M, N) ids, z, weights -> real-unit tables n_dt (M, D, K),
    n_wt (M, V, K), n_t (M, K) in `dtype`, and the tokens summed into each
    entry (`terms_*`)."""
    live = (weights > 0).to(dtype)
    n_dt = _scatter(docs, z, weights, num_docs, k, dtype)
    n_wt = _scatter(words, z, weights, vocab_size, k, dtype)
    return {"n_dt": n_dt, "n_wt": n_wt, "n_t": n_wt.sum(dim=1),
            "terms_dt": _scatter(docs, z, live, num_docs, k, dtype),
            "terms_wt": _scatter(words, z, live, vocab_size, k, dtype)}


def encode(table: torch.Tensor, w_bits: Optional[int]) -> torch.Tensor:
    """Real-unit sums -> stored units (fixed point rounds half to even)."""
    if w_bits is None:
        return table.to(torch.float32)
    return torch.round(table.to(torch.float32) * float(1 << (w_bits + 1))).to(torch.int32)


def deviation(state, ref: dict, w_bits: Optional[int]) -> float:
    """The largest |stored - exact| / (unit / 2 + (n - 1) 2^-24 |exact|) over
    the entries of n_dt, n_wt and n_t (n: the terms summed; for a total,
    its tokens plus the V rows summed). `state` holds stored (M, ...)
    tables."""
    unit = 0.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    vocab = ref["n_wt"].shape[1]
    terms = {"n_dt": ref["terms_dt"], "n_wt": ref["terms_wt"],
             "n_t": ref["terms_wt"].sum(dim=1) + vocab}
    worst = 0.0
    for name in ("n_dt", "n_wt", "n_t"):
        got = getattr(state, name).to(torch.float64) * (1.0 if w_bits is None else unit)
        want = ref[name].to(torch.float64)
        allow = unit / 2 + torch.clamp_min(terms[name] - 1, 0) * F32_ROUNDOFF * want.abs()
        dev = (got - want).abs()
        ratio = torch.where(dev > 0, dev / torch.clamp_min(allow, 1e-30), 0.0)
        worst = max(worst, float(ratio.max()))
    return worst
