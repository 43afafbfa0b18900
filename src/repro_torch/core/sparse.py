"""SparseLDA (Yao et al., 2009) — faithful sequential reference sampler.

This is the algorithm the paper runs on the phone (§2.4, §4.3): the
collapsed-Gibbs conditional is decomposed into three buckets

    p(z=t | rest) ∝ (n_td + α)(n_tw + β)/(n_t + β̄)
                  =  α β /(n_t+β̄)            [s: smoothing, dense but cached]
                  +  n_td β /(n_t+β̄)         [r: doc-sparse]
                  +  (n_td + α) n_tw /(n_t+β̄) [q: word-sparse]

so a draw costs O(k_d + k_w) instead of O(k). It is sequential numpy host
code on purpose: it models the phone, not the server, so it draws from
`np.random.default_rng(seed)` and gives the same `z` and the same float64
counts as the JAX package's `core.sparse` from the same seed and inputs,
draw for draw. It is NOT the card's path: a per-token-sequential bucket
walk has no parallel form, so the server's samplers are the blocked sweep
(`gibbs.py`) and the proposal sampler (`alias.py`).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import LDAConfig


class SparseLDASampler:
    """Sequential O(k_d + k_w) collapsed Gibbs with s/r/q buckets."""

    def __init__(
        self,
        cfg: LDAConfig,
        docs,
        words,
        z,
        weights=None,
        seed: int = 0,
        counts=None,
    ):
        self.cfg = cfg
        self.docs = np.asarray(docs, np.int64)
        self.words = np.asarray(words, np.int64)
        self.z = np.asarray(z, np.int64).copy()
        self.weights = (
            np.ones_like(self.docs, np.float64)
            if weights is None
            else np.asarray(weights, np.float64)
        )
        self.rng = np.random.default_rng(seed)

        k = cfg.num_topics
        if counts is not None:
            # Externally supplied sufficient statistics (the stored-state
            # adapter path). They may cover more mass than (z, weights) —
            # e.g. incremental updates freeze old tokens by zeroing their
            # weights while their counts keep participating.
            n_dt, n_wt, n_t = counts
            self.n_dt = np.asarray(n_dt, np.float64).copy()
            self.n_wt = np.asarray(n_wt, np.float64).copy()
            self.n_t = np.asarray(n_t, np.float64).copy()
        else:
            self.n_dt = np.zeros((cfg.num_docs, k))
            self.n_wt = np.zeros((cfg.vocab_size, k))
            self.n_t = np.zeros(k)
            np.add.at(self.n_dt, (self.docs, self.z), self.weights)
            np.add.at(self.n_wt, (self.words, self.z), self.weights)
            np.add.at(self.n_t, self.z, self.weights)

        # Smoothing-bucket cache: s = Σ_t αβ/(n_t+β̄); maintained incrementally.
        self._denom = self.n_t + cfg.beta_bar
        self._s_terms = cfg.alpha * cfg.beta / self._denom
        self.s = float(self._s_terms.sum())

    # -- incremental bucket maintenance -------------------------------------
    def _update_topic(self, t: int) -> None:
        cfg = self.cfg
        old = self._s_terms[t]
        self._denom[t] = self.n_t[t] + cfg.beta_bar
        self._s_terms[t] = cfg.alpha * cfg.beta / self._denom[t]
        self.s += self._s_terms[t] - old

    def _remove(self, i: int) -> None:
        d, w, t, wt = self.docs[i], self.words[i], self.z[i], self.weights[i]
        self.n_dt[d, t] -= wt
        self.n_wt[w, t] -= wt
        self.n_t[t] -= wt
        self._update_topic(t)

    def _add(self, i: int, t: int) -> None:
        d, w, wt = self.docs[i], self.words[i], self.weights[i]
        self.n_dt[d, t] += wt
        self.n_wt[w, t] += wt
        self.n_t[t] += wt
        self.z[i] = t
        self._update_topic(t)

    # -- one token ------------------------------------------------------------
    def _sample_token(self, i: int) -> None:
        cfg = self.cfg
        d, w = self.docs[i], self.words[i]
        self._remove(i)

        doc_topics = np.nonzero(self.n_dt[d] > 0)[0]  # k_d instantiated topics
        word_topics = np.nonzero(self.n_wt[w] > 0)[0]  # k_w instantiated topics

        r_terms = cfg.beta * self.n_dt[d, doc_topics] / self._denom[doc_topics]
        q_terms = (
            (self.n_dt[d, word_topics] + cfg.alpha)
            * self.n_wt[w, word_topics]
            / self._denom[word_topics]
        )
        r = float(r_terms.sum())
        q = float(q_terms.sum())

        u = self.rng.uniform(0.0, self.s + r + q)
        if u < q:  # q first: it dominates for converged models (Yao §3)
            c = np.cumsum(q_terms)
            t = int(word_topics[np.searchsorted(c, u)])
        elif u < q + r:
            c = np.cumsum(r_terms)
            t = int(doc_topics[np.searchsorted(c, u - q)])
        else:
            c = np.cumsum(self._s_terms)
            t = int(np.searchsorted(c, u - q - r))
        self._add(i, t)

    def sweep(self) -> None:
        for i in range(len(self.docs)):
            if self.weights[i] > 0:
                self._sample_token(i)

    def run(self, num_sweeps: int) -> None:
        for _ in range(num_sweeps):
            self.sweep()


class DenseGibbsSampler(SparseLDASampler):
    """Sequential O(k) dense sampler — the MALLET-style baseline (paper §2.2).

    Identical semantics, no bucket decomposition: every draw normalizes all
    k terms. This is the 'previous system' baseline the paper improves on.
    """

    def _sample_token(self, i: int) -> None:
        cfg = self.cfg
        d, w = self.docs[i], self.words[i]
        self._remove(i)
        p = (self.n_dt[d] + cfg.alpha) * (self.n_wt[w] + cfg.beta) / self._denom
        c = np.cumsum(p)
        u = self.rng.uniform(0.0, c[-1])
        self._add(i, int(np.searchsorted(c, u)))
