"""The Gibbs-resample kernel's wrapper, its plain version, and the sweep.

`resample` is the one entry point every sampler calls. On a CUDA tensor it
validates its arguments and launches the hand-written Hopper kernel
(`kernel.launch`, from `csrc/lda_gibbs.cu`), adding one to
``resample.launches``; there is no fall back. On a CPU tensor it runs
`resample_plain`, the same function in eager PyTorch (semantics of the
reference's `kernels/lda_gibbs/ref.py::resample_tile`), which is also the
yardstick the kernel is held against on the card.

Unlike the TPU wrapper, nothing is padded or pre-gathered: the kernel
takes the full count tables and the token ids and gathers rows itself.

`sweep` is the single-launch sweep of the `cuda` backend: one `resample`
over all N tokens, then the count rebuild.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import codec
from repro_torch.core.types import Corpus, LDAConfig, LDAState

_TINY = torch.finfo(torch.float32).tiny


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise drawn as `jax.random.gumbel` draws it:
    -log(-log(U)) with U uniform on [tiny, 1), so U is never 0."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min_(_TINY)))


def perturbed_scores(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
                     alpha: float, beta: float, beta_bar: float,
                     w_bits: Optional[int] = None) -> torch.Tensor:
    """(N, K) self-excluded collapsed-Gibbs log scores (paper Eq. 5) plus
    the Gumbel noise — the quantity both versions take the argmax of."""
    scale = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    rows_d = n_dt[docs].to(torch.float32) * scale
    rows_w = n_wt[words].to(torch.float32) * scale
    tot = n_t.to(torch.float32) * scale
    topic = torch.arange(noise.shape[1], device=noise.device)
    own = torch.where(topic[None, :] == z[:, None], weights[:, None], 0.0)
    rd = torch.clamp_min(rows_d - own, 0.0)
    rw = torch.clamp_min(rows_w - own, 0.0)
    tt = torch.clamp_min(tot[None, :] - own, 1e-9)
    logits = torch.log(rd + alpha) + torch.log(rw + beta) - torch.log(tt + beta_bar)
    return logits + noise


def resample_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
                   alpha: float, beta: float, beta_bar: float,
                   w_bits: Optional[int] = None) -> torch.Tensor:
    """Eager-PyTorch resample: Gumbel-max over `perturbed_scores` (ties to
    the lowest topic); weight-0 tokens keep their topic."""
    scores = perturbed_scores(docs, words, z, weights, n_dt, n_wt, n_t, noise,
                              alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    z_new = torch.argmax(scores, dim=-1).to(z.dtype)
    return torch.where(weights > 0.0, z_new, z)


def _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits) -> None:
    n, k = noise.shape
    named = dict(docs=docs, words=words, z=z, weights=weights, n_dt=n_dt,
                 n_wt=n_wt, n_t=n_t, noise=noise)
    for name, t in named.items():
        if t.device != noise.device:
            raise ValueError(f"{name} is on {t.device}, noise on {noise.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("docs", "words", "z"):
        if named[name].dtype != torch.int32 or named[name].shape != (n,):
            raise ValueError(f"{name} must be int32 of shape ({n},)")
    if weights.dtype != torch.float32 or weights.shape != (n,):
        raise ValueError(f"weights must be float32 of shape ({n},)")
    if noise.dtype != torch.float32:
        raise ValueError("noise must be float32")
    want = torch.float32 if w_bits is None else torch.int32
    for name in ("n_dt", "n_wt", "n_t"):
        if named[name].dtype != want:
            raise ValueError(f"{name} must be {want} (w_bits={w_bits})")
    if n_dt.dim() != 2 or n_wt.dim() != 2 or n_dt.shape[1] != k \
            or n_wt.shape[1] != k or n_t.shape != (k,):
        raise ValueError(f"count tables must be (D,{k}), (V,{k}), ({k},)")


def resample(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
             alpha: float, beta: float, beta_bar: float,
             w_bits: Optional[int] = None) -> torch.Tensor:
    """New topic per token (N,) int32 from ids (N,), the full count tables
    (D,K)/(V,K)/(K,) — int32 fixed point when `w_bits` is set, else
    float32 — and Gumbel noise (N, K). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if noise.device.type == "cpu":
        return resample_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise,
                              alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    if noise.device.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {noise.device}")
    _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits)
    from repro_torch.kernels.lda_gibbs import kernel

    z_out = torch.empty_like(z)
    kernel.launch(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                  alpha=float(alpha), beta=float(beta), beta_bar=float(beta_bar),
                  scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    resample.launches += 1
    return z_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts).
resample.launches = 0


def sweep_resample(cfg: LDAConfig, state: LDAState, corpus: Corpus,
                   gen: torch.Generator,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full resampling pass in a single `resample` call; returns the new
    z (counts rebuilt by the caller). Stored tables go in as they are
    (fixed-point int32 is rescaled inside the kernel). `noise` (N, K)
    replaces the draw from `gen`, so a test can replay the reference's."""
    w_bits = codec.codec_for(cfg).spec.w_bits
    if noise is None:
        noise = gumbel((corpus.num_tokens, cfg.num_topics), gen, corpus.device)
    return resample(corpus.docs, corpus.words, state.z, corpus.weights,
                    state.n_dt, state.n_wt, state.n_t, noise,
                    alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                    w_bits=w_bits)


def sweep(cfg: LDAConfig, state: LDAState, corpus: Corpus, gen: torch.Generator,
          noise: Optional[torch.Tensor] = None) -> LDAState:
    """Full kernel-path Gibbs sweep (one launch + count rebuild)."""
    z_new = sweep_resample(cfg, state, corpus, gen, noise)
    return codec.rebuild_state(cfg, corpus, z_new)
