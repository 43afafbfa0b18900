"""The AliasLDA MH kernel's wrapper, its plain version, and the sweep.

`mh_resample` is the one entry point the `alias` backend calls. On a CUDA
tensor it validates its arguments and launches the hand-written Hopper
kernel (`kernel.launch`, from `csrc/alias_mh.cu`), adding one to
``mh_resample.launches`` (and to ``mh_resample.launches_philox`` in the
Philox mode); there is no fall back. On a CPU tensor it runs
`mh_resample_plain`, the same function in eager PyTorch (semantics of the
reference's `kernels/alias_mh/ref.py::mh_tile`), which is also the
yardstick the kernel is held against on the card.

Draws come in two modes. Injected: the (S, N) ``(j_prop, u_prop, u_acc)``
matrices, as the TPU kernel takes them (the parity tests and the reference
replays). Philox: `philox=(seed, offset)` and `mh_steps` with no draw
tensors; the kernel draws each round itself from one Philox4x32-10 call
(`philox_mh_draws_plain` is the same draw in eager PyTorch, and what the
plain version takes on a CPU tensor). The key comes from the sweep's
generator by `lda_gibbs.ops.philox_key` (an (M, 2) table by `philox_keys`
for M models).

Unlike the TPU wrapper, nothing is padded or pre-gathered: both versions
take the token ids, the full count tables and the full alias tables, and
look up one entry per token and round.

`mh_sweep` is the `alias` backend's sweep: the stale tables from the
decoded counts, outside this kernel as the reference builds them (on the
card one launch of the `alias_tables` kernel, elsewhere the plain
`build_alias_tables`; `core.alias.sweep_tables`), one `mh_resample`
(Philox draws on the card, `sweep_draws` on the CPU), then the count
rebuild.
Stored units go in and out. A packed `cfg.quant` spec scores and builds
the word tables against the fake-quantized word-topic table.

`mh_resample_many` / `mh_sweep_many` are the same for M stacked models (the
`core.batch` layout: a leading (M,) axis on every token, count, table and
draw tensor), one launch of the batched kernel for all M; the tables of
all M×V and M×D rows build together (one `alias_tables` launch on the
card). In the Philox mode the key is an (M, 2) table and model m draws
what its single-model call would under its own key: the counter holds the
token's index within its model.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import codec, quant
from repro_torch.core.alias import mh_rounds, sweep_draws, sweep_tables
from repro_torch.core.types import Corpus, LDAConfig, LDAState
from repro_torch.kernels import PLAIN_DEVICES
from repro_torch.kernels.lda_gibbs.ops import _scale, check_philox_key, philox_key, philox_plain

#: Tag XORed into the Philox key's high word, apart from the Gibbs kernel's
#: (`lda_gibbs.ops.PHILOX_KEY_TAG`), so the two kernels' streams of one
#: generator never coincide.
PHILOX_KEY_TAG = 0x414C4D48


def philox_mh_draws_plain(seed, offset, n: int, s: int, k: int, *, start: int = 0,
                          device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Philox mode's draws in eager PyTorch: for rounds r < s and tokens
    i in [start, start + n), words x0..x2 of Philox4x32-10 with counter
    (r, i, offset_lo, offset_hi) and key (seed_lo, seed_hi ^ PHILOX_KEY_TAG)
    give j = (x0 * k) >> 32 in [0, k) and u_prop, u_acc = (x >> 8) * 2^-24
    in [0, 1). `seed` and `offset` are ints -> three (s, n) tensors, or (M,)
    int64 tensors of the same bits, one pair a model -> (M, s, n)."""
    r = torch.arange(s, dtype=torch.int64)[:, None]
    i = torch.arange(start, start + n, dtype=torch.int64)[None, :]
    x = philox_plain(seed, offset, r, i, tag=PHILOX_KEY_TAG, device=device)
    j = ((x[..., 0] * k) >> 32).to(torch.int32)
    u_prop, u_acc = ((x[..., q] >> 8).to(torch.float32) * 2.0 ** -24 for q in (1, 2))
    return j, u_prop, u_acc


def philox_draws(z, n_t, philox, mh_steps: int):
    """The Philox mode's draws as tensors: (S, N) under a (seed, offset)
    pair, (M, S, N) under an (M, 2) key table."""
    n, k = z.shape[-1], n_t.shape[-1]
    if isinstance(philox, torch.Tensor):
        return philox_mh_draws_plain(philox[:, 0], philox[:, 1], n, mh_steps, k)
    return philox_mh_draws_plain(philox[0], philox[1], n, mh_steps, k, device=z.device)


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
           alias_d, j_prop, u_prop, u_acc, w_bits, many: bool = False, philox=None,
           mh_steps: Optional[int] = None) -> None:
    """What the kernel takes: one model, or with `many` M stacked models
    (a leading (M,) axis on every argument), with injected draws or, when
    all three are None, a Philox key `philox` and `mh_steps` rounds:
    (seed, offset) for one model, an (M, 2) int64 table on the tokens'
    device for M."""
    draws = (j_prop, u_prop, u_acc)
    injected = all(x is not None for x in draws)
    if injected == (philox is not None) or not (injected or all(x is None for x in draws)):
        raise ValueError("pass either the three draws or a Philox key, not both or neither")
    if philox is not None and not (isinstance(mh_steps, int) and mh_steps >= 1):
        raise ValueError("the Philox mode needs mh_steps >= 1")
    if injected and mh_steps is not None:
        raise ValueError("mh_steps goes with a Philox key; injected draws carry their S")
    lead = tuple(z.shape[:1]) if many and z.dim() == 2 else ()
    n = z.shape[-1] if z.dim() == 1 + many else -1
    pre = "M, " if many else ""
    named = dict(docs=docs, words=words, z=z, weights=weights, n_dt=n_dt, n_wt=n_wt,
                 n_t=n_t, thresh_w=thresh_w, alias_w=alias_w, thresh_d=thresh_d,
                 alias_d=alias_d, j_prop=j_prop, u_prop=u_prop, u_acc=u_acc)
    for name, t in named.items():
        if t is None:
            continue
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
    if philox is not None:
        check_philox_key(philox, lead, z.device, many)
        return
    if j_prop.dim() != 2 + many or j_prop.shape[:-2] != lead \
            or j_prop.shape[-1] != n or j_prop.shape[-2] < 1:
        raise ValueError(f"draws must be ({pre}S, {n}) with S >= 1")
    if j_prop.dtype != torch.int32:
        raise ValueError("j_prop must be int32")
    for name in ("u_prop", "u_acc"):
        if named[name].dtype != torch.float32 or named[name].shape != j_prop.shape:
            raise ValueError(f"{name} must be float32 of shape {tuple(j_prop.shape)}")


def mh_resample(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                thresh_d, alias_d, j_prop=None, u_prop=None, u_acc=None, *,
                alpha: float, beta: float, beta_bar: float,
                w_bits: Optional[int] = None, philox: Optional[tuple[int, int]] = None,
                mh_steps: Optional[int] = None) -> torch.Tensor:
    """New topic per token (N,) int32 from ids (N,), the full count tables
    (D,K)/(V,K)/(K,) — int32 fixed point when `w_bits` is set, else
    float32 — the stale alias tables (V,K)/(D,K), and either the (S, N)
    draws or a Philox key `philox` = (seed, offset) under which the kernel
    draws `mh_steps` rounds. CPU tensors take the plain version (on
    `philox_mh_draws_plain`'s draws in the Philox mode), and so do `meta`
    tensors (the dry run's shape propagation); CUDA tensors launch the
    kernel."""
    args = (docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d, alias_d)
    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    if z.device.type in PLAIN_DEVICES:
        if philox is not None or any(x is None for x in (j_prop, u_prop, u_acc)):
            _check(*args, j_prop, u_prop, u_acc, w_bits, philox=philox, mh_steps=mh_steps)
            j_prop, u_prop, u_acc = philox_draws(z, n_t, philox, mh_steps)
        return mh_resample_plain(*args, j_prop, u_prop, u_acc, **hp)
    if z.device.type != "cuda":
        raise ValueError(f"no alias_mh kernel for device {z.device}")
    _check(*args, j_prop, u_prop, u_acc, w_bits, philox=philox, mh_steps=mh_steps)
    from repro_torch.kernels.alias_mh import kernel

    z_out = torch.empty_like(z)
    kernel.launch(*args, j_prop, u_prop, u_acc, z_out, alpha=float(alpha), beta=float(beta),
                  beta_bar=float(beta_bar), scale=_scale(w_bits), philox=philox or (0, 0),
                  mh_steps=mh_steps)
    mh_resample.launches += 1
    if philox is not None:
        mh_resample.launches_philox += 1
    return z_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts),
#: and those of them in the Philox mode.
mh_resample.launches = 0
mh_resample.launches_philox = 0


def sweep_counts(cfg: LDAConfig, state: LDAState):
    """The count tables a sweep hands the kernel: (counts, w_bits, (n_dt,
    n_wt) in real units for the table build). Stored tables and the codec's
    `w_bits`; with a packed `cfg.quant`, the decoded n_dt and n_t and the
    fake-quantized word table in float32 (``w_bits=None``)."""
    sc = codec.codec_for(cfg)
    spec = cfg.quant_spec
    n_dt, n_wt = sc.decode_array(state.n_dt), sc.decode_array(state.n_wt)
    if spec.packed:
        n_wt = quant.fake_quantize_rows(n_wt, spec.bits)
        return (n_dt, n_wt, sc.decode_array(state.n_t)), None, (n_dt, n_wt)
    return (state.n_dt, state.n_wt, state.n_t), sc.spec.w_bits, (n_dt, n_wt)


def mh_sweep(cfg: LDAConfig, state: LDAState, corpus: Corpus,
             gen: Optional[torch.Generator], mh_steps: int = 4,
             draws: Optional[tuple] = None,
             tables: Optional[tuple] = None) -> LDAState:
    """Full kernel-path AliasLDA sweep (one launch + count rebuild), stored
    units in and out. `draws` and `tables` replace the draw from `gen` and
    the table build (see `core.alias.mh_sweep`). Without `draws`, a sweep on
    the card draws in the kernel under `philox_key(gen)` and a CPU sweep
    draws `sweep_draws` from `gen`.

    With a packed `cfg.quant` (int8/int4_packed) the stale word-topic table
    is fake-quantized to the spec's width (`core.quant.fake_quantize_rows`:
    the accuracy model of the packed table), the word alias tables are
    built from it, and the kernel runs its float mode (``w_bits=None``) on
    the decoded n_dt, that table and the decoded n_t, as the reference's
    packed sweep does; doc rows and totals stay exact."""
    counts, w_bits, real = sweep_counts(cfg, state)
    if tables is None:
        tables = sweep_tables(cfg, *real)
    noise = {}
    if draws is None and corpus.device.type == "cuda":
        noise = dict(philox=philox_key(gen), mh_steps=mh_steps)
    elif draws is None:
        draws = sweep_draws(gen, corpus.num_tokens, cfg.num_topics, mh_steps, corpus.device)
    z_new = mh_resample(corpus.docs, corpus.words, state.z, corpus.weights,
                        *counts, *tables, *(draws or ()),
                        alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                        w_bits=w_bits, **noise)
    return codec.rebuild_state(cfg, corpus, z_new)


def mh_resample_many(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,
                     thresh_d, alias_d, j_prop=None, u_prop=None, u_acc=None, *,
                     alpha: float, beta: float, beta_bar: float,
                     w_bits: Optional[int] = None, philox: Optional[torch.Tensor] = None,
                     mh_steps: Optional[int] = None) -> torch.Tensor:
    """New topics (M, N) int32 for M stacked models from ids (M, N), their
    count tables (M, D, K)/(M, V, K)/(M, K) — int32 fixed point when
    `w_bits` is set, else float32 — their stale alias tables, and either
    the (M, S, N) draws or a Philox key `philox`, an (M, 2) int64 table of
    (seed, offset) rows (`philox_keys`), with `mh_steps` rounds. CPU (and
    `meta`) tensors take the plain version; CUDA tensors launch the batched
    kernel once for all M models."""
    args = (docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d, alias_d)
    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    if z.device.type in PLAIN_DEVICES:
        if philox is not None or any(x is None for x in (j_prop, u_prop, u_acc)):
            _check(*args, j_prop, u_prop, u_acc, w_bits, many=True, philox=philox,
                   mh_steps=mh_steps)
            j_prop, u_prop, u_acc = philox_draws(z, n_t, philox, mh_steps)
        return mh_resample_many_plain(*args, j_prop, u_prop, u_acc, **hp)
    if z.device.type != "cuda":
        raise ValueError(f"no alias_mh kernel for device {z.device}")
    _check(*args, j_prop, u_prop, u_acc, w_bits, many=True, philox=philox, mh_steps=mh_steps)
    from repro_torch.kernels.alias_mh import kernel

    z_out = torch.empty_like(z)
    kernel.launch_many(*args, j_prop, u_prop, u_acc, z_out, alpha=float(alpha),
                       beta=float(beta), beta_bar=float(beta_bar), scale=_scale(w_bits),
                       philox=philox, mh_steps=mh_steps)
    mh_resample_many.launches += 1
    if philox is not None:
        mh_resample_many.launches_philox += 1
    return z_out


#: Batched kernel launches so far (CUDA tensors only), and those of them in
#: the Philox mode.
mh_resample_many.launches = 0
mh_resample_many.launches_philox = 0


def mh_sweep_many(cfg: LDAConfig, states: LDAState, corpora: Corpus,
                  draws: Optional[tuple] = None, tables: Optional[tuple] = None, *,
                  philox: Optional[torch.Tensor] = None,
                  mh_steps: Optional[int] = None) -> LDAState:
    """One AliasLDA sweep over M stacked models from their (M, S, N)
    ``(j_prop, u_prop, u_acc)`` draws or their (M, 2) Philox key table
    `philox` with `mh_steps` rounds: the stale tables of all M models (or
    the injected `tables`), one `mh_resample_many`, then the batched count
    rebuild, stored units in and out. `cfg` is the stack's shared config
    (`cfg.num_docs` the padded per-model document capacity)."""
    sc = codec.codec_for(cfg)
    if tables is None:
        tables = sweep_tables(cfg, sc.decode_array(states.n_dt), sc.decode_array(states.n_wt))
    z_new = mh_resample_many(corpora.docs, corpora.words, states.z, corpora.weights,
                             states.n_dt, states.n_wt, states.n_t, *tables, *(draws or ()),
                             alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                             w_bits=sc.spec.w_bits, philox=philox, mh_steps=mh_steps)
    return codec.rebuild_state(cfg, corpora, z_new)
