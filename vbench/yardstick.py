"""The benchmark's yardstick: the card's published peaks, the byte and
operation counts of a sweep and of its kernel, and the statistics the
metrics are taken with. Copies, kept here so that a change to the program
cannot move them:

  * the peaks of `repro_torch.launch.mesh` (NVIDIA's data sheet for the
    H100 80GB HBM3 SXM at 700 W, dense rates);
  * `sweep_bound`, the arithmetic of `repro_torch.launch.dryrun_rlda.
    sweep_bound`: the corpus and the stored state read once, the new state
    written once, `SCORE_OPS` float32 operations a token and topic;
  * `gibbs_kernel_bound`, the least time of the Gibbs resample from what
    its inputs need, whatever implements it or makes its noise (the
    counting of `chip_smoke.lda_bound`, without its noise-mode terms).
"""

from __future__ import annotations

from typing import Sequence

import torch

#: float32 operations a second outside the tensor cores, one H100 SXM.
PEAK_FLOPS_F32 = 67e12
#: HBM bytes a second, one H100 SXM.
HBM_BYTES_PER_S = 3.35e12
#: The power limit the peaks assume.
PEAK_POWER_W = 700.0

#: float32 operations a token and topic of the collapsed-Gibbs score: the
#: two count sums, a product, a quotient, its log (counted as 4) and the
#: noise added.
SCORE_OPS = 9
#: float32 operations a variate of the Gumbel transform -log(-log(u)): two
#: logs at about 4 each. The uniform's own generator is not counted, so a
#: change of how noise is made does not move the yardstick.
GUMBEL_OPS = 8
#: float32 operations a token and MH round: the acceptance ratio's two
#: targets (three logs each) and two proposal densities (a log each), the
#: accept uniform's log, at about 4 a log, and ten sums and compares.
MH_OPS = 46
#: Bytes of one id, topic, weight or stored count.
WORD = 4


def _bound(moved: float, ops: float) -> dict:
    bytes_s, ops_s = moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS_F32
    return {"bytes": moved, "ops": ops, "bytes_s": bytes_s, "ops_s": ops_s,
            "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def sweep_bound(num_tokens: int, num_topics: int, num_docs: int, vocab_size: int,
                *, noise_bytes: int = 0) -> dict:
    """The least time of one whole sweep: the corpus (docs, words, weights)
    and the stored state (z and the three count tables) read once, the new
    state written once, over the HBM rate; `SCORE_OPS` operations a token
    and topic over the float32 rate; the larger of the two."""
    corpus = 3 * WORD * num_tokens
    state = WORD * (num_tokens + num_topics * (num_docs + vocab_size + 1))
    return _bound(corpus + 2 * state + noise_bytes, num_tokens * num_topics * SCORE_OPS)


def gibbs_kernel_bound(live_tokens: int, num_topics: int, doc_rows: int, word_rows: int,
                       models: int = 1) -> dict:
    """The least time of one Gibbs resample over `live_tokens` tokens: each
    token's doc, word, weight and old z read and its new z written once,
    the count rows its tokens touch (`doc_rows` + `word_rows` rows of K)
    and each model's K totals read once; the score's `SCORE_OPS` and the
    Gumbel transform's `GUMBEL_OPS` a token and topic."""
    moved = (5 * WORD * live_tokens
             + WORD * num_topics * (doc_rows + word_rows + models))
    return _bound(moved, live_tokens * num_topics * (SCORE_OPS + GUMBEL_OPS))


def alias_kernel_bound(live_tokens: int, rounds: int) -> dict:
    """The least time of one AliasLDA MH resample over `live_tokens` tokens
    and `rounds` rounds: each token's doc, word, weight and old z read and
    its new z written once (the table entries a round reads depend on the
    draws and are not counted); `MH_OPS` operations a token and round."""
    return _bound(5 * WORD * live_tokens, live_tokens * rounds * MH_OPS)


def live_tokens(corpora) -> int:
    """Real tokens (weight > 0) of the corpora: what one sweep of every
    model resamples."""
    return sum(int((c.weights > 0).sum()) for c in corpora)


def rows_touched(corpora) -> tuple[int, int]:
    """Distinct (model, doc) and (model, word) rows the corpora's real
    tokens touch: the count rows a resample must read."""
    doc_rows = word_rows = 0
    for c in corpora:
        live = c.weights > 0
        doc_rows += int(torch.unique(c.docs[live]).numel())
        word_rows += int(torch.unique(c.words[live]).numel())
    return doc_rows, word_rows


def sweep_ops(live_tokens: int, num_topics: int) -> int:
    """The dense collapsed-Gibbs conditional's float32 operations of one
    sweep, whatever sampler runs it."""
    return live_tokens * num_topics * SCORE_OPS


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, linearly
    interpolated between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
