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
    counting of `chip_smoke.lda_bound`, without its noise-mode terms);
  * `mamba2_scan_bound`, the arithmetic of `chip_smoke._scan_cost_mamba2`
    (the Mamba2 scan entry's row), at a chunk of 32 whatever the length;
  * `hybrid_flops`, a hybrid language model's matmul, attention, conv and
    scan operations a served wave, and `decode_attn_bound`, the bytes of
    one decode step's attention over its valid positions.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: float32 operations a second outside the tensor cores, one H100 SXM.
PEAK_FLOPS_F32 = 67e12
#: bfloat16 operations a second on the tensor cores, dense, one H100 SXM.
PEAK_FLOPS_BF16 = 989.4e12
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


def mamba2_scan_bound(b: int, s: int, h: int, dk: int, dv: int, itemsize: int,
                      chunk: int = 32) -> dict:
    """The least time of one Mamba2 scan from a zero state (a prompt's):
    the decays w (B, S, H) float32, k and q (B, S, dk) and v (B, S, H, dv)
    read once, y written once, the final state (B, H, dk, dv) float32
    written once; q . k once a (b, chunk) pair, and a (b, h, chunk) the
    decays of the pairs the mask keeps, y's two contractions, the state
    update and the scan of the log decays, at `chunk` tokens a chunk
    (S / chunk chunks, a fraction where it does not divide)."""
    moved = (4 * b * s * h + itemsize * (2 * b * s * dk + 2 * b * s * h * dv)
             + 4 * b * h * dk * dv)
    pairs = chunk * (chunk + 1) // 2
    exps = pairs + 2 * chunk + 1
    per_chunk = (2 * pairs + 2 * chunk * dk * dv + 2 * pairs * dv + 2 * chunk * dv
                 + chunk * dk + 2 * chunk * dk * dv + 2 * dk * dv + 4 * chunk + exps)
    chunks = s / chunk
    return _bound(moved, b * h * chunks * per_chunk + b * chunks * 2 * pairs * dk)


def decode_attn_bound(b: int, valid: int, hkv: int, g: int, hd: int, itemsize: int) -> dict:
    """The least time of one decode step's attention over `valid` cached
    positions: their keys and values read once, the queries read and the
    output written once; 4 operations a (query head, position, dim)."""
    moved = itemsize * (2 * b * valid * hkv * hd + 2 * b * hkv * g * hd)
    return _bound(moved, 4 * b * hkv * g * hd * valid)


def hybrid_flops(cfg: dict, rows: int, prompt: int, new: int) -> tuple[float, float]:
    """Operations of one served wave of a hybrid model (`cfg`, the
    configuration file): (the prefill of `rows` prompts of `prompt` tokens
    with the first token's logits, the `new - 1` decode steps with theirs).
    A token costs 2 a weight of every matrix it passes (in and out
    projections of each Mamba2 layer; q, k, v, o and the MLP of each
    shared block's call), 2 a conv tap and channel, 5 a Mamba2 state entry
    (decay, update, readout) and 4 a (query head, dim) of each position it
    attends to (causal, within the window); a position whose logits are
    taken costs 2 a weight of the tied vocabulary."""
    d, layers, groups = cfg["d_model"], cfg["num_layers"], cfg["num_layers"] // cfg["hybrid_attn_every"]
    h, hd, ns = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]
    inner = h * hd
    q, kv = cfg["num_heads"] * cfg["head_dim"], cfg["num_kv_heads"] * cfg["head_dim"]
    mamba = d * (2 * inner + 2 * ns + h) + inner * d
    shared = d * q + 2 * d * kv + q * d + 3 * d * cfg["d_ff"]
    per_token = (2 * (layers * mamba + groups * shared)
                 + layers * (2 * cfg["conv_width"] * (inner + 2 * ns) + 5 * ns * inner))
    window = cfg["sliding_window"] or prompt + new

    def attended(lo: int, hi: int) -> int:  # sum over positions lo..hi-1 of min(p + 1, window)
        return sum(min(p + 1, window) for p in range(lo, hi))

    per_pos = groups * 4 * q
    logits = 2 * d * cfg["vocab_size"]
    prefill = rows * (prompt * per_token + per_pos * attended(0, prompt) + logits)
    decode = rows * ((new - 1) * (per_token + logits) + per_pos * attended(prompt, prompt + new - 1))
    return float(prefill), float(decode)


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
