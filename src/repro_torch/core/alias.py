"""AliasLDA (Li et al., 2014a) — stale alias-table proposals + parallel MH.

AliasLDA cuts the per-token cost to O(1) per proposal by drawing topics
from *stale* alias tables (built once per sweep from a snapshot of the
counts) and correcting with Metropolis–Hastings. As in the reference
(`repro.core.alias`), all tables — per word and per doc, since MH rounds
alternate Li et al.'s word/doc cycle proposals — are rebuilt once per
sweep in one vectorized pass over the rows, and the proposal draws and
accept/reject steps of all tokens run in parallel against the
sweep-stale counts.

`build_alias_tables` is the reference's exact linearization of Vose's
algorithm (sort into light/heavy buckets, prefix sums, read every
threshold and alias off the cumulative deficit/excess curves), in PyTorch
operations: the plain version, which CPU and `meta` tensors run. On the
card a sweep's tables come from the `alias_tables` kernel
(`repro_torch.kernels.alias_tables`), which gives the same bits as this
function does there. PyTorch's `cumsum` rounds differently from XLA's, so
a threshold may differ from the reference's in its last bits and, at a
near-tie between heavy buckets, an alias may differ; both tables encode
the same distribution, which is what the tests hold them to.

`mh_rounds` is the MH arithmetic in eager PyTorch: the plain version of
the `alias_mh` kernel (`repro_torch.kernels.alias_mh.ops`) and the body of
`mh_sweep`, the real-unit oracle the tests replay the reference's sweep
with. The `alias` backend runs `repro_torch.kernels.alias_mh.ops.mh_sweep`,
and `run_many` over M stacked models (`core.batch`'s layout) for the batch
engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts
from repro_torch.obs import metrics, trace

_TABLES_S = metrics.counter(
    "vedalia_alias_tables_device_seconds_total",
    "Device seconds of the alias table builds (`alias.tables` spans).")


def _build_rows(mass: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact alias tables for (R, K) rows of Vose-scaled masses (each row
    sums to K) — the reference's `_build_row`, vectorized over rows.

    Lights (mass < 1) come first in a stable order, then heavies. Light i
    takes its alias from the first heavy whose cumulative excess E exceeds
    the deficit D absorbed before it; heavy j keeps 1 + E_j - D_i(j), where
    i(j) is the first light whose cumulative deficit reaches E_j, and
    aliases to the next heavy in order (the drained-donor chain).
    """
    rows, k = mass.shape
    light = mass < 1.0
    order = torch.argsort((~light).to(torch.int8), dim=-1, stable=True)
    m_s = mass.gather(-1, order)
    light_s = light.gather(-1, order)

    deficit = torch.where(light_s, 1.0 - m_s, 0.0)
    excess = torch.where(light_s, 0.0, m_s - 1.0)
    cum_d = deficit.cumsum(-1)  # constant on the heavy suffix
    cum_e = excess.cumsum(-1)  # zero on the light prefix

    d_prev = cum_d - deficit
    donor = torch.searchsorted(cum_e, d_prev, right=True).clamp_(0, k - 1)

    cum_d_ext = torch.cat([torch.zeros(rows, 1, dtype=cum_d.dtype, device=cum_d.device),
                           cum_d], dim=-1)
    closer = torch.searchsorted(cum_d_ext, cum_e).clamp_(0, k)
    thresh_heavy = (1.0 + cum_e - cum_d_ext.gather(-1, closer)).clamp_(0.0, 1.0)

    pos = torch.arange(k, device=mass.device)
    thresh_s = torch.where(light_s, m_s, thresh_heavy)
    alias_pos = torch.where(light_s, donor, torch.clamp_max(pos + 1, k - 1))
    alias_s = order.gather(-1, alias_pos)

    thresh = torch.empty_like(m_s).scatter_(-1, order, thresh_s)
    alias = torch.empty(rows, k, dtype=torch.int32, device=mass.device).scatter_(
        -1, order, alias_s.to(torch.int32))
    return thresh, alias


def build_alias_tables(probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact alias tables for a whole batch of distributions at once.

    `probs` is (..., K) of non-negative (un-normalized) masses; returns
    float32 `thresh` and int32 `alias` of the same shape. Sample
    u ~ U[0, 1), j ~ U{0..K-1}; the topic is j if u < thresh[..., j] else
    alias[..., j]. Rows whose total mass is zero fall back to the uniform
    distribution.
    """
    probs = torch.as_tensor(probs, dtype=torch.float32)
    k = probs.shape[-1]
    lead = probs.shape[:-1]
    row_sum = probs.sum(-1, keepdim=True)
    ok = row_sum > 0.0
    mass = torch.where(ok, probs * (k / torch.where(ok, row_sum, 1.0)), 1.0)
    thresh, alias = _build_rows(mass.reshape(-1, k).contiguous())
    return thresh.reshape(*lead, k), alias.reshape(*lead, k)


def sweep_draws(gen: Optional[torch.Generator], n: int, k: int, mh_steps: int,
                device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sweep's randomness as (S, N) matrices, the reference's layout:
    per MH round a proposal bucket (int32 in [0, K)), a bucket-vs-alias
    uniform and an accept uniform (float32 in [0, 1)), drawn on `device`."""
    j_prop = torch.randint(0, k, (mh_steps, n), generator=gen, device=device,
                           dtype=torch.int32)
    u_prop = torch.rand((mh_steps, n), generator=gen, device=device)
    u_acc = torch.rand((mh_steps, n), generator=gen, device=device)
    return j_prop, u_prop, u_acc


def sweep_tables(cfg: LDAConfig, n_dt: torch.Tensor, n_wt: torch.Tensor):
    """The stale proposal tables of a sweep from real-unit counts:
    ``(thresh_w, alias_w, thresh_d, alias_d)`` with q_w ∝ n_wt + β over
    (V, K) and q_d ∝ n_dt + α over (D, K), leading (M,) axes kept. On the
    card one launch of the `alias_tables` kernel builds both, elsewhere
    `build_alias_tables` (`kernels.alias_tables.ops.build_tables`). The
    `alias.tables` span, device-timed into
    `vedalia_alias_tables_device_seconds_total`."""
    from repro_torch.kernels.alias_tables.ops import build_tables

    with trace.span("alias.tables", on=n_wt.device, counter=_TABLES_S):
        return build_tables(n_wt, cfg.beta, n_dt, cfg.alpha)


def mh_rounds(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
              thresh_d, alias_d, j_prop, u_prop, u_acc, *, alpha, beta, beta_bar,
              w_bits=None):
    """The S MH rounds of a sweep in eager PyTorch, on full count tables
    (real units, or int32 fixed point scaled by 2^-(w_bits+1) when `w_bits`
    is set): (new z, each token's smallest |log u_acc - log a| and smallest
    |u_prop - thresh[j]| over the rounds; +inf on weight-0 tokens).
    Stacked inputs — a leading (M,) axis on ids, z, weights, tables and
    totals, draws (M, S, N) — run all M models at once, each on its own
    tables, and give (M, N).

    Even rounds propose from the stale word table (q ∝ n_tw + β), odd
    rounds from the stale doc table (q ∝ n_td + α); the move s -> t is
    accepted when log u < log[p(t) q(s) / (p(s) q(t))], against the stale
    target p(t) ∝ (n_td+α)(n_tw+β)/(n_t+β̄) with the token's own weight
    excluded at its sweep-start topic. Weight-0 tokens keep their topic.
    """
    scale = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    d, w, z0 = docs.long(), words.long(), z.long()
    live = weights > 0.0
    tot = n_t.to(torch.float32) * scale
    model = ()  # one model: tables index by (row, topic)
    if z.dim() == 2:  # M stacked models: by (model, row, topic); draws (S, M, N)
        model = (torch.arange(z.shape[0], device=z.device)[:, None],)
        j_prop, u_prop, u_acc = (x.transpose(0, 1) for x in (j_prop, u_prop, u_acc))

    def count(table, rows, t):
        return table[(*model, rows, t)].to(torch.float32) * scale

    def log_p(t):  # stale target, own weight excluded at the sweep-start topic
        sub = torch.where((t == z0) & live, weights, 0.0)
        ndt = torch.clamp_min(count(n_dt, d, t) - sub, 0.0)
        nwt = torch.clamp_min(count(n_wt, w, t) - sub, 0.0)
        nt = torch.clamp_min(tot[(*model, t)] - sub, 1e-9)
        return (torch.log(ndt + alpha) + torch.log(nwt + beta)) - torch.log(nt + beta_bar)

    def log_q_w(t):  # stale proposal densities (un-normalized: ratios)
        return torch.log(count(n_wt, w, t) + beta)

    def log_q_d(t):
        return torch.log(count(n_dt, d, t) + alpha)

    inf = torch.full(z0.shape, float("inf"), device=z0.device)
    acc_margin, prop_margin = inf, inf
    z_cur = z0
    for s in range(j_prop.shape[0]):
        j = j_prop[s].long()
        if s % 2 == 0:  # word-proposal round of the Li et al. cycle
            rows, thresh, alias_t, log_q = w, thresh_w, alias_w, log_q_w
        else:  # doc-proposal round
            rows, thresh, alias_t, log_q = d, thresh_d, alias_d, log_q_d
        th = thresh[(*model, rows, j)]
        prop = torch.where(u_prop[s] < th, j, alias_t[(*model, rows, j)].long())
        log_a = (log_p(prop) + log_q(z_cur)) - (log_p(z_cur) + log_q(prop))
        log_u = torch.log(u_acc[s])
        z_cur = torch.where((log_u < log_a) & live, prop, z_cur)
        acc_margin = torch.minimum(acc_margin, torch.where(live, (log_u - log_a).abs(), inf))
        prop_margin = torch.minimum(prop_margin, torch.where(live, (u_prop[s] - th).abs(), inf))
    return z_cur.to(z.dtype), acc_margin, prop_margin


def mh_sweep(
    cfg: LDAConfig,
    state: LDAState,
    corpus: Corpus,
    gen: Optional[torch.Generator],
    mh_steps: int = 2,
    draws: Optional[tuple] = None,
    tables: Optional[tuple] = None,
) -> LDAState:
    """One AliasLDA sweep in eager PyTorch on real-unit counts (the
    reference's `core.alias.mh_sweep`): the stale tables, the draws, the
    `mh_rounds`, then the count rebuild.

    `draws`, an injected ``(j_prop, u_prop, u_acc)`` of shape (S, N), and
    `tables`, an injected ``(thresh_w, alias_w, thresh_d, alias_d)``,
    replace the draw from `gen` and the table build, so a test can replay
    the reference's.
    """
    if tables is None:
        tables = sweep_tables(cfg, state.n_dt, state.n_wt)
    if draws is None:
        draws = sweep_draws(gen, corpus.num_tokens, cfg.num_topics, mh_steps, corpus.device)
    z_new = mh_rounds(corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt,
                      state.n_wt, state.n_t, *tables, *draws, alpha=cfg.alpha,
                      beta=cfg.beta, beta_bar=cfg.beta_bar)[0]
    return build_counts(cfg, corpus, z_new)


# -- batched multi-model sweeps (the `serving.batch_engine` layout) ---------


def run_many(cfg: LDAConfig, states: LDAState, corpora: Corpus,
             gens: Sequence[torch.Generator], num_sweeps: int, mh_steps: int = 4,
             lengths: Optional[Sequence[int]] = None) -> LDAState:
    """`num_sweeps` AliasLDA sweeps over M stacked models (stored units in
    and out), one `kernels.alias_mh.ops.mh_sweep_many` launch each.

    Model i has `lengths[i]` real tokens (default: every slot) and consumes
    `gens[i]` exactly as `_BaseSampler.run`'s `alias` sweeps do for it alone,
    so a batched run is M sequential `alias` runs from the same generators.
    On the card a sweep's draws are made in the kernel: row i of the (M, 2)
    key table is `philox_key(gens[i])`, the key the single-model sweep takes,
    and a token's draw depends only on its index within its model. Off the
    card model i draws `sweep_draws` at its own length, never at the padded
    one, into its rows of (M, S, N) buffers allocated once for the run (the
    padding keeps j = 0, u_prop = 0, u_acc = 1 and weight 0).
    """
    from repro_torch.kernels.alias_mh import ops as kops
    from repro_torch.kernels.lda_gibbs.ops import philox_keys

    m, n = corpora.docs.shape
    dev = corpora.device
    if dev.type == "cuda":
        for _ in range(num_sweeps):
            states = kops.mh_sweep_many(cfg, states, corpora, philox=philox_keys(gens, dev),
                                        mh_steps=mh_steps)
        return states
    lengths = [n] * m if lengths is None else list(lengths)
    j_prop = torch.zeros((m, mh_steps, n), dtype=torch.int32, device=dev)
    u_prop = torch.zeros((m, mh_steps, n), dtype=torch.float32, device=dev)
    u_acc = torch.ones((m, mh_steps, n), dtype=torch.float32, device=dev)
    for _ in range(num_sweeps):
        for i, (gen, n_i) in enumerate(zip(gens, lengths, strict=True)):
            for buf, draw in zip((j_prop, u_prop, u_acc),
                                 sweep_draws(gen, n_i, cfg.num_topics, mh_steps, dev)):
                buf[i, :, :n_i] = draw
        states = kops.mh_sweep_many(cfg, states, corpora, (j_prop, u_prop, u_acc))
    return states
