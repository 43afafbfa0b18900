"""One AliasLDA sweep's resample in plain PyTorch (Li et al., 2014a): the
stale proposal tables, the draws and the Metropolis-Hastings rounds.

  tables  Vose alias tables of q_w ∝ n_wt + beta over (V, K) and of
          q_d ∝ n_dt + alpha over (D, K), from the counts in real units
          (stored / 2^(w_bits+1)), built by the exact linearization of
          Vose's method (lights first in a stable order, then heavies; each
          threshold and alias read off the cumulative deficit and excess)
  draws   round r, token i: words x0..x2 of Philox4x32-10 with counter
          (r, i, offset_lo, offset_hi) and key (seed_lo, seed_hi ^ ALIAS_TAG):
          j = (x0 * K) >> 32, u_prop = (x1 >> 8) 2^-24, u_acc = (x2 >> 8) 2^-24
  rounds  even rounds propose from the word table, odd ones from the doc
          table: t = j if u_prop < thresh[row, j] else alias[row, j]; the
          move s -> t is taken when log u_acc < log p(t) + log q(s)
          - log p(s) - log q(t), p the stale collapsed conditional with the
          token's own weight taken out at its sweep-start topic; a weight-0
          token keeps its topic

The arithmetic after the tables is rounded to `dtype` (float32 as the
configuration states; bfloat16 is the control).
"""

from __future__ import annotations

from typing import Callable

import torch

from vbench.reference.philox import U32, philox

ALIAS_TAG = 0x414C4D48
TOKENS = 1 << 22  # tokens a block


def _vose_rows(mass: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Alias tables of (R, K) rows of masses that sum to K each."""
    rows, k = mass.shape
    light = mass < 1.0
    order = torch.argsort((~light).to(torch.int8), dim=-1, stable=True)
    m_s = mass.gather(-1, order)
    light_s = light.gather(-1, order)
    deficit = torch.where(light_s, 1.0 - m_s, 0.0)
    excess = torch.where(light_s, 0.0, m_s - 1.0)
    cum_d = deficit.cumsum(-1)
    cum_e = excess.cumsum(-1)
    donor = torch.searchsorted(cum_e, cum_d - deficit, right=True).clamp_(0, k - 1)
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


def tables(probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Alias tables of (R, K) non-negative masses; a row of mass 0 is
    uniform."""
    k = probs.shape[-1]
    row_sum = probs.sum(-1, keepdim=True)
    ok = row_sum > 0.0
    mass = torch.where(ok, probs * (k / torch.where(ok, row_sum, 1.0)), 1.0)
    return _vose_rows(mass.contiguous())


def philox_draws(seed: int, offset: int, start: int, stop: int, rounds: int, k: int, device):
    """(rounds, stop - start) proposals j and uniforms u_prop, u_acc."""
    s = torch.tensor(seed, dtype=torch.int64, device=device)
    o = torch.tensor(offset, dtype=torch.int64, device=device)
    r = torch.arange(rounds, device=device, dtype=torch.int64)[:, None]
    i = torch.arange(start, stop, device=device, dtype=torch.int64)[None, :]
    x0, x1, x2, _ = torch.broadcast_tensors(
        *philox(r, i, o & U32, (o >> 32) & U32, s & U32, ((s >> 32) & U32) ^ ALIAS_TAG))
    j = ((x0 * k) >> 32).to(torch.int32)
    u_prop, u_acc = ((x >> 8).to(torch.float32) * 2.0 ** -24 for x in (x1, x2))
    return j, u_prop, u_acc


def resample(docs, words, z, weights, n_dt, n_wt, n_t, draws: Callable, *, alpha: float,
             beta: float, beta_bar: float, scale: float,
             dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """New topics (N,) from one model's ids, z and weights (N,), stored
    tables (D, K), (V, K), (K,) and `draws(start, stop)`, the round-major
    (j, u_prop, u_acc) of a block of tokens; and each token's margin, the
    least over its rounds of |log u_acc - log a| and |u_prop - threshold|
    (+inf for a weight-0 token)."""
    unit = 1.0 / scale  # real counts are stored / 2^(w_bits+1), divided as the codec divides
    thresh_w, alias_w = tables(n_wt.to(torch.float32) / unit + beta)
    thresh_d, alias_d = tables(n_dt.to(torch.float32) / unit + alpha)
    tot = (n_t.to(torch.float32) * scale).to(dtype)
    out = torch.empty_like(z)
    margin = torch.full(z.shape, float("inf"), device=z.device)
    for start in range(0, z.shape[0], TOKENS):
        stop = min(z.shape[0], start + TOKENS)
        d, w = docs[start:stop].long(), words[start:stop].long()
        z0, wt = z[start:stop].long(), weights[start:stop]
        live = wt > 0.0

        def count(table, rows, t):
            return (table[rows, t].to(torch.float32) * scale).to(dtype)

        def log_p(t):
            sub = torch.where((t == z0) & live, wt, 0.0).to(dtype)
            ndt = torch.clamp_min(count(n_dt, d, t) - sub, 0.0)
            nwt = torch.clamp_min(count(n_wt, w, t) - sub, 0.0)
            nt = torch.clamp_min(tot[t] - sub, 1e-9)
            return (torch.log(ndt + alpha) + torch.log(nwt + beta)) - torch.log(nt + beta_bar)

        j_all, u_prop, u_acc = draws(start, stop)
        cur = z0
        near = torch.full(z0.shape, float("inf"), device=z.device)
        for s in range(j_all.shape[0]):
            j = j_all[s].long()
            if s % 2 == 0:
                rows, thresh, alias = w, thresh_w, alias_w

                def log_q(t):
                    return torch.log(count(n_wt, w, t) + beta)
            else:
                rows, thresh, alias = d, thresh_d, alias_d

                def log_q(t):
                    return torch.log(count(n_dt, d, t) + alpha)
            th = thresh[rows, j]
            prop = torch.where(u_prop[s] < th, j, alias[rows, j].long())
            log_a = (log_p(prop) + log_q(cur)) - (log_p(cur) + log_q(prop))
            log_u = torch.log(u_acc[s]).to(dtype)
            cur = torch.where((log_u < log_a) & live, prop, cur)
            near = torch.minimum(near, torch.minimum((log_u - log_a).abs().to(torch.float32),
                                                     (u_prop[s] - th).abs()))
        out[start:stop] = cur.to(z.dtype)
        margin[start:stop] = torch.where(live, near, float("inf"))
    return out, margin
