"""The AliasLDA MH kernel's wrapper, its plain version, and the sweep.

`mh_resample` is the one entry point the `alias` backend calls. On a CUDA
tensor it validates its arguments and launches the hand-written Hopper
kernel (`kernel.launch`, from `csrc/alias_mh.cu`), adding one to
``mh_resample.launches``; there is no fall back. On a CPU tensor it runs
`mh_resample_plain`, the same function in eager PyTorch (semantics of the
reference's `kernels/alias_mh/ref.py::mh_tile`), which is also the
yardstick the kernel is held against on the card.

Unlike the TPU wrapper, nothing is padded or pre-gathered: both versions
take the token ids, the full count tables and the full alias tables, and
look up one entry per token and round.

`mh_sweep` is the `alias` backend's sweep: the stale tables (built in
PyTorch from the decoded counts, as the reference builds them outside its
kernel), the (S, N) draws, one `mh_resample`, then the count rebuild.
Stored units go in and out.

`mh_resample_many` / `mh_sweep_many` are the same for M stacked models (the
`core.batch` layout: a leading (M,) axis on every token, count, table and
draw tensor), one launch of the batched kernel for all M; the tables of
all M×V and M×D rows build in one `build_alias_tables` call each.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import codec
from repro_torch.core.alias import mh_rounds, sweep_draws, sweep_tables
from repro_torch.core.types import Corpus, LDAConfig, LDAState


def mh_resample_plain(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                      thresh_d, alias_d, j_prop, u_prop, u_acc, *, alpha: float,
                      beta: float, beta_bar: float,
                      w_bits: Optional[int] = None) -> torch.Tensor:
    """Eager-PyTorch S-round proposal + MH resample; weight-0 tokens keep
    their topic."""
    return mh_rounds(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                     thresh_d, alias_d, j_prop, u_prop, u_acc, alpha=alpha,
                     beta=beta, beta_bar=beta_bar, w_bits=w_bits)[0]


def margins(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
            alias_d, j_prop, u_prop, u_acc, *, alpha: float, beta: float,
            beta_bar: float, w_bits: Optional[int] = None):
    """Per token, the smallest accept margin |log u_acc - log a| and the
    smallest proposal margin |u_prop - thresh[j]| over the S rounds, as the
    plain version computes them (+inf on weight-0 tokens). A token whose
    margin is within an ulp-sized band may legitimately resolve the other
    way in another implementation of `log`; tests exempt those."""
    return mh_rounds(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                     thresh_d, alias_d, j_prop, u_prop, u_acc, alpha=alpha,
                     beta=beta, beta_bar=beta_bar, w_bits=w_bits)[1:]


def mh_resample_many_plain(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                           thresh_d, alias_d, j_prop, u_prop, u_acc, *, alpha: float,
                           beta: float, beta_bar: float,
                           w_bits: Optional[int] = None) -> torch.Tensor:
    """`mh_resample_plain` over M stacked models: ids, z and weights
    (M, N), count and alias tables (M, D, K) / (M, V, K), totals (M, K),
    draws (M, S, N) -> (M, N). Each model reads only its own tables."""
    return mh_rounds(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                     thresh_d, alias_d, j_prop, u_prop, u_acc, alpha=alpha,
                     beta=beta, beta_bar=beta_bar, w_bits=w_bits)[0]


def _check(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
           alias_d, j_prop, u_prop, u_acc, w_bits, many: bool = False) -> None:
    """What the kernel takes: one model, or with `many` M stacked models
    (a leading (M,) axis on every argument)."""
    lead = tuple(z.shape[:1]) if many and z.dim() == 2 else ()
    n = z.shape[-1] if z.dim() == 1 + many else -1
    pre = "M, " if many else ""
    named = dict(docs=docs, words=words, z=z, weights=weights, n_dt=n_dt, n_wt=n_wt,
                 n_t=n_t, thresh_w=thresh_w, alias_w=alias_w, thresh_d=thresh_d,
                 alias_d=alias_d, j_prop=j_prop, u_prop=u_prop, u_acc=u_acc)
    for name, t in named.items():
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("docs", "words", "z"):
        if named[name].dtype != torch.int32 or named[name].shape != (*lead, n):
            raise ValueError(f"{name} must be int32 of shape {'(M, N)' if many else '(N,)'}")
    if weights.dtype != torch.float32 or weights.shape != (*lead, n):
        raise ValueError(f"weights must be float32 of shape {(*lead, n)}")
    want = torch.float32 if w_bits is None else torch.int32
    for name in ("n_dt", "n_wt", "n_t"):
        if named[name].dtype != want:
            raise ValueError(f"{name} must be {want} (w_bits={w_bits})")
    if n_dt.dim() != 2 + many or n_wt.dim() != 2 + many \
            or n_dt.shape[:-2] != lead or n_wt.shape[:-2] != lead:
        raise ValueError(f"count tables must be ({pre}D, K) and ({pre}V, K)")
    k = n_dt.shape[-1]
    if n_wt.shape[-1] != k or n_t.shape != (*lead, k):
        raise ValueError(f"count tables must be ({pre}D,{k}), ({pre}V,{k}), ({pre}{k},)")
    for name, rows in (("w", n_wt.shape[-2]), ("d", n_dt.shape[-2])):
        th, al = named[f"thresh_{name}"], named[f"alias_{name}"]
        if th.dtype != torch.float32 or th.shape != (*lead, rows, k):
            raise ValueError(f"thresh_{name} must be float32 of shape {(*lead, rows, k)}")
        if al.dtype != torch.int32 or al.shape != (*lead, rows, k):
            raise ValueError(f"alias_{name} must be int32 of shape {(*lead, rows, k)}")
    if j_prop.dim() != 2 + many or j_prop.shape[:-2] != lead \
            or j_prop.shape[-1] != n or j_prop.shape[-2] < 1:
        raise ValueError(f"draws must be ({pre}S, {n}) with S >= 1")
    if j_prop.dtype != torch.int32:
        raise ValueError("j_prop must be int32")
    for name in ("u_prop", "u_acc"):
        if named[name].dtype != torch.float32 or named[name].shape != j_prop.shape:
            raise ValueError(f"{name} must be float32 of shape {tuple(j_prop.shape)}")


def mh_resample(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                thresh_d, alias_d, j_prop, u_prop, u_acc, *, alpha: float,
                beta: float, beta_bar: float,
                w_bits: Optional[int] = None) -> torch.Tensor:
    """New topic per token (N,) int32 from ids (N,), the full count tables
    (D,K)/(V,K)/(K,) — int32 fixed point when `w_bits` is set, else
    float32 — the stale alias tables (V,K)/(D,K), and the (S, N) draws.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    args = (docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
            alias_d, j_prop, u_prop, u_acc)
    if z.device.type == "cpu":
        return mh_resample_plain(*args, alpha=alpha, beta=beta, beta_bar=beta_bar,
                                 w_bits=w_bits)
    if z.device.type != "cuda":
        raise ValueError(f"no alias_mh kernel for device {z.device}")
    _check(*args, w_bits)
    from repro_torch.kernels.alias_mh import kernel

    z_out = torch.empty_like(z)
    kernel.launch(*args, z_out, alpha=float(alpha), beta=float(beta),
                  beta_bar=float(beta_bar),
                  scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    mh_resample.launches += 1
    return z_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts).
mh_resample.launches = 0


def mh_sweep(cfg: LDAConfig, state: LDAState, corpus: Corpus,
             gen: Optional[torch.Generator], mh_steps: int = 4,
             draws: Optional[tuple] = None,
             tables: Optional[tuple] = None) -> LDAState:
    """Full kernel-path AliasLDA sweep (one launch + count rebuild), stored
    units in and out. `draws` and `tables` replace the draw from `gen` and
    the table build (see `core.alias.mh_sweep`)."""
    sc = codec.codec_for(cfg)
    if tables is None:
        tables = sweep_tables(cfg, sc.decode_array(state.n_dt), sc.decode_array(state.n_wt))
    if draws is None:
        draws = sweep_draws(gen, corpus.num_tokens, cfg.num_topics, mh_steps, corpus.device)
    z_new = mh_resample(corpus.docs, corpus.words, state.z, corpus.weights,
                        state.n_dt, state.n_wt, state.n_t, *tables, *draws,
                        alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                        w_bits=sc.spec.w_bits)
    return codec.rebuild_state(cfg, corpus, z_new)


def mh_resample_many(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                     thresh_d, alias_d, j_prop, u_prop, u_acc, *, alpha: float,
                     beta: float, beta_bar: float,
                     w_bits: Optional[int] = None) -> torch.Tensor:
    """New topics (M, N) int32 for M stacked models from ids (M, N), their
    count tables (M, D, K)/(M, V, K)/(M, K) — int32 fixed point when
    `w_bits` is set, else float32 — their stale alias tables, and the
    (M, S, N) draws. CPU tensors take the plain version; CUDA tensors
    launch the batched kernel once for all M models."""
    args = (docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
            alias_d, j_prop, u_prop, u_acc)
    if z.device.type == "cpu":
        return mh_resample_many_plain(*args, alpha=alpha, beta=beta, beta_bar=beta_bar,
                                      w_bits=w_bits)
    if z.device.type != "cuda":
        raise ValueError(f"no alias_mh kernel for device {z.device}")
    _check(*args, w_bits, many=True)
    from repro_torch.kernels.alias_mh import kernel

    z_out = torch.empty_like(z)
    kernel.launch_many(*args, z_out, alpha=float(alpha), beta=float(beta),
                       beta_bar=float(beta_bar),
                       scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    mh_resample_many.launches += 1
    return z_out


#: Batched kernel launches so far (CUDA tensors only).
mh_resample_many.launches = 0


def mh_sweep_many(cfg: LDAConfig, states: LDAState, corpora: Corpus, draws: tuple,
                  tables: Optional[tuple] = None) -> LDAState:
    """One AliasLDA sweep over M stacked models from their (M, S, N)
    ``(j_prop, u_prop, u_acc)`` draws: the stale tables of all M models
    (or the injected `tables`), one `mh_resample_many`, then the batched
    count rebuild, stored units in and out. `cfg` is the stack's shared
    config (`cfg.num_docs` the padded per-model document capacity)."""
    sc = codec.codec_for(cfg)
    if tables is None:
        tables = sweep_tables(cfg, sc.decode_array(states.n_dt), sc.decode_array(states.n_wt))
    z_new = mh_resample_many(corpora.docs, corpora.words, states.z, corpora.weights,
                             states.n_dt, states.n_wt, states.n_t, *tables, *draws,
                             alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                             w_bits=sc.spec.w_bits)
    return codec.rebuild_state(cfg, corpora, z_new)
