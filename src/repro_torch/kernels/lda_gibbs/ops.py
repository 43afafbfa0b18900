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

`resample_many` / `sweep_many` are the same for M stacked models (the
`core.batch` layout: a leading (M,) axis on every token and count tensor),
one launch of the batched kernel for all M; their plain version is the
same arithmetic over the model axis (each model reads only its own rows
and totals), so on the CPU model m's row equals a single-model call.
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
    return gumbel_(torch.rand(shape, generator=gen, device=device, dtype=torch.float32))


def gumbel_(u: torch.Tensor) -> torch.Tensor:
    """`gumbel`'s transform in place: uniforms U -> -log(-log(max(U, tiny)))."""
    return u.clamp_min_(_TINY).log_().neg_().log_().neg_()


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Count rows by id: (R, K)[(N,)] -> (N, K), or per model
    (M, R, K)[(M, N)] -> (M, N, K)."""
    if ids.dim() == 1:
        return table[ids]
    return table[torch.arange(ids.shape[0], device=ids.device)[:, None], ids]


def perturbed_scores(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
                     alpha: float, beta: float, beta_bar: float,
                     w_bits: Optional[int] = None) -> torch.Tensor:
    """(N, K) self-excluded collapsed-Gibbs log scores (paper Eq. 5) plus
    the Gumbel noise — the quantity both versions take the argmax of.
    Stacked inputs (a leading (M,) axis) give (M, N, K)."""
    scale = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    rows_d = _rows(n_dt, docs).to(torch.float32) * scale
    rows_w = _rows(n_wt, words).to(torch.float32) * scale
    tot = n_t.to(torch.float32) * scale
    topic = torch.arange(noise.shape[-1], device=noise.device)
    own = torch.where(topic == z[..., None], weights[..., None], 0.0)
    rd = torch.clamp_min(rows_d - own, 0.0)
    rw = torch.clamp_min(rows_w - own, 0.0)
    tt = torch.clamp_min(tot[..., None, :] - own, 1e-9)
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


def resample_many_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
                        alpha: float, beta: float, beta_bar: float,
                        w_bits: Optional[int] = None) -> torch.Tensor:
    """`resample_plain` over M stacked models: ids, z and weights (M, N),
    tables (M, D, K), (M, V, K), (M, K), noise (M, N, K) -> (M, N)."""
    return resample_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise, alpha=alpha,
                          beta=beta, beta_bar=beta_bar, w_bits=w_bits)


def _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits,
           many: bool = False) -> None:
    """What the kernel takes: one model, or with `many` M stacked models
    (a leading (M,) axis on every argument)."""
    if noise.dim() != 2 + many:
        raise ValueError(f"noise must be {'(M, N, K)' if many else '(N, K)'}")
    lead = tuple(noise.shape[:-2])
    n, k = noise.shape[-2:]
    named = dict(docs=docs, words=words, z=z, weights=weights, n_dt=n_dt,
                 n_wt=n_wt, n_t=n_t, noise=noise)
    for name, t in named.items():
        if t.device != noise.device:
            raise ValueError(f"{name} is on {t.device}, noise on {noise.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("docs", "words", "z"):
        if named[name].dtype != torch.int32 or named[name].shape != (*lead, n):
            raise ValueError(f"{name} must be int32 of shape {(*lead, n)}")
    if weights.dtype != torch.float32 or weights.shape != (*lead, n):
        raise ValueError(f"weights must be float32 of shape {(*lead, n)}")
    if noise.dtype != torch.float32:
        raise ValueError("noise must be float32")
    want = torch.float32 if w_bits is None else torch.int32
    for name in ("n_dt", "n_wt", "n_t"):
        if named[name].dtype != want:
            raise ValueError(f"{name} must be {want} (w_bits={w_bits})")
    if n_dt.dim() != 2 + many or n_wt.dim() != 2 + many \
            or n_dt.shape[:-2] != lead or n_wt.shape[:-2] != lead \
            or n_dt.shape[-1] != k or n_wt.shape[-1] != k or n_t.shape != (*lead, k):
        pre = "M," if many else ""
        raise ValueError(f"count tables must be ({pre}D,{k}), ({pre}V,{k}), ({pre}{k},)")


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


def resample_many(docs, words, z, weights, n_dt, n_wt, n_t, noise, *,
                  alpha: float, beta: float, beta_bar: float,
                  w_bits: Optional[int] = None) -> torch.Tensor:
    """New topics (M, N) int32 for M stacked models from ids (M, N), their
    count tables (M, D, K)/(M, V, K)/(M, K) — int32 fixed point when
    `w_bits` is set, else float32 — and noise (M, N, K). CPU tensors take
    the plain version; CUDA tensors launch the batched kernel once for all
    M models."""
    if noise.device.type == "cpu":
        return resample_many_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise,
                                   alpha=alpha, beta=beta, beta_bar=beta_bar,
                                   w_bits=w_bits)
    if noise.device.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {noise.device}")
    _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits, many=True)
    from repro_torch.kernels.lda_gibbs import kernel

    z_out = torch.empty_like(z)
    kernel.launch_many(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                       alpha=float(alpha), beta=float(beta), beta_bar=float(beta_bar),
                       scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    resample_many.launches += 1
    return z_out


#: Batched kernel launches so far (CUDA tensors only).
resample_many.launches = 0


def sweep_many(cfg: LDAConfig, states: LDAState, corpora: Corpus,
               noise: torch.Tensor) -> LDAState:
    """One Gibbs sweep over M stacked models from their (M, N, K) noise:
    one `resample_many` on the stored tables, then the batched count
    rebuild, stored units in and out. `cfg` is the stack's shared config
    (`cfg.num_docs` the padded per-model document capacity)."""
    z_new = resample_many(corpora.docs, corpora.words, states.z, corpora.weights,
                          states.n_dt, states.n_wt, states.n_t, noise,
                          alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                          w_bits=codec.codec_for(cfg).spec.w_bits)
    return codec.rebuild_state(cfg, corpora, z_new)
