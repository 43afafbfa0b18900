"""The Gibbs-resample kernel's wrapper, its plain version, and the sweep.

`resample` is the one entry point every sampler calls. On a CUDA tensor it
validates its arguments and launches the hand-written Hopper kernel
(`kernel.launch`, from `csrc/lda_gibbs.cu`), adding one to
``resample.launches`` (and to ``resample.launches_philox`` in the Philox
mode); there is no fall back. On a CPU tensor it runs
`resample_plain`, the same function in eager PyTorch (semantics of the
reference's `kernels/lda_gibbs/ref.py::resample_tile`), which is also the
yardstick the kernel is held against on the card.

Unlike the TPU wrapper, nothing is padded or pre-gathered: the kernel
takes the full count tables and the token ids and gathers rows itself.

Noise comes in two modes. Injected: an (N, K) Gumbel tensor, as the TPU
kernel takes it (the parity tests and the blocked `torch` sweep). Philox:
`philox=(seed, offset)` and no noise tensor; the kernel draws g(i, t) itself
from Philox4x32-10 (`philox_gumbel_plain` is the same draw in eager
PyTorch, and the plain version a CPU tensor takes). `philox_key` takes one
sweep's key from a CUDA generator without a device sync.

`sweep` is the single-launch sweep of the `cuda` backend: one `resample`
over all N tokens (Philox noise on the card, `torch.rand` Gumbel noise on
the CPU), then the count rebuild.

`resample_many` / `sweep_many` are the same for M stacked models (the
`core.batch` layout: a leading (M,) axis on every token and count tensor),
one launch of the batched kernel for all M; their plain version is the
same arithmetic over the model axis (each model reads only its own rows
and totals), so on the CPU model m's row equals a single-model call. In
Philox mode the key is an (M, 2) table, one (seed, offset) row a model,
and model m draws what its single-model call would under its own key.

`resample_quant` is the packed-table variant (a `cfg.quant` of mode int8
or int4_packed): the word-topic table arrives as uint8 codes (nibble-packed
for int4) with one float32 scale per row, which the kernel gathers by word
id and dequantizes; doc-topic counts and totals stay exact. It takes the
same two noise modes, and under one Philox key it draws the noise
`resample` draws. `sweep_resample` takes it for a packed spec, quantizing
the stale (V, K) table once a sweep as the reference's packed sweep does:
`pack_word_table` launches one kernel on the card (counted in
``pack_word_table.launches``) and runs `pack_word_table_plain`
(`core.quant.quantize_rows_torch` + `pack_nibbles_torch`) on the CPU; the
two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import codec, quant
from repro_torch.core.types import Corpus, LDAConfig, LDAState

_TINY = torch.finfo(torch.float32).tiny


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise drawn as `jax.random.gumbel` draws it:
    -log(-log(U)) with U uniform on [tiny, 1), so U is never 0."""
    return gumbel_(torch.rand(shape, generator=gen, device=device, dtype=torch.float32))


def gumbel_(u: torch.Tensor) -> torch.Tensor:
    """`gumbel`'s transform in place: uniforms U -> -log(-log(max(U, tiny)))."""
    return u.clamp_min_(_TINY).log_().neg_().log_().neg_()


# Philox4x32-10 (Salmon et al., SC'11): round multipliers and key Weyl
# increments, and the tag XORed into the key's high word so the kernels'
# stream stays apart from PyTorch's own Philox draws on the same generator.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_KEY_TAG = 0x4C444147
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * m for uint32 values held in int64,
    with m split into 16-bit halves so no product passes 2^48."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & _U32


def philox4x32_10_plain(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 in int64 tensor ops: counter (..., 4) and key (..., 2)
    of uint32 words held in int64 (broadcast against each other) -> the
    (..., 4) output words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), -1)


def _i64(x: int) -> int:
    """A uint64 as the int64 of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def philox_plain(seed, offset, c0: torch.Tensor, i: torch.Tensor, *, tag: int,
                 device=None) -> torch.Tensor:
    """Philox4x32-10 words of counters (c0, i, offset_lo, offset_hi) under
    key (seed_lo, seed_hi ^ tag), the layout both kernels draw from.
    `seed` and `offset` are ints, or (M,) int64 tensors of the same bits, one
    pair a model (a leading (M,) axis on the result); `c0` and `i` are int64
    tensors broadcast against each other -> (*lead, *shape, 4) uint32 words
    held in int64."""
    seed = torch.as_tensor(_i64(seed) if isinstance(seed, int) else seed,
                           dtype=torch.int64, device=device)
    offset = torch.as_tensor(_i64(offset) if isinstance(offset, int) else offset,
                             dtype=torch.int64, device=seed.device)
    lead, shape = tuple(seed.shape), torch.broadcast_shapes(c0.shape, i.shape)
    seed, offset = (x.reshape(lead + (1,) * len(shape)) for x in (seed, offset))
    counter = torch.stack(torch.broadcast_tensors(
        c0.to(seed.device), i.to(seed.device), offset & _U32, (offset >> 32) & _U32), -1)
    key = torch.stack(torch.broadcast_tensors(seed & _U32, ((seed >> 32) & _U32) ^ tag), -1)
    return philox4x32_10_plain(counter, key)


def philox_gumbel_plain(seed, offset, n: int, k: int, *, start: int = 0,
                        device=None) -> torch.Tensor:
    """The Philox mode's noise in eager PyTorch: g(i, t) for tokens i in
    [start, start + n) and topics t < k, from word t & 3 of Philox4x32-10
    with counter (t >> 2, i, offset_lo, offset_hi) and key (seed_lo,
    seed_hi ^ PHILOX_KEY_TAG); u = (x >> 8) * 2^-24 takes `gumbel_`'s
    transform. `seed` and `offset` are ints -> (n, k), or (M,) int64 tensors
    of the same bits, one pair a model -> (M, n, k)."""
    i = torch.arange(start, start + n, dtype=torch.int64)[:, None]
    c = torch.arange((k + 3) // 4, dtype=torch.int64)[None, :]
    g = philox_words_to_gumbel(philox_plain(seed, offset, c, i, tag=PHILOX_KEY_TAG,
                                            device=device))
    return g.reshape(*g.shape[:-2], -1)[..., :k].contiguous()


def philox_words_to_gumbel(words: torch.Tensor) -> torch.Tensor:
    """Philox output words (uint32 in int64) -> Gumbel noise: the top 24
    bits as u = (x >> 8) * 2^-24 in [0, 1 - 2^-24], then `gumbel_`."""
    return gumbel_((words >> 8).to(torch.float32) * 2.0 ** -24)


def philox_key(gen: torch.Generator) -> tuple[int, int]:
    """One sweep's Philox key from a CUDA generator: (seed, offset), then
    the generator's offset advanced by 4, so every sweep (and every later
    draw of PyTorch's own on it) gets fresh counters. No device sync. A CPU
    generator has no offset and raises."""
    seed, offset = gen.initial_seed(), gen.get_offset()
    gen.set_offset(offset + 4)
    return seed, offset


def philox_keys(gens, device) -> torch.Tensor:
    """`philox_key` of each generator as the batched entry's (M, 2) int64
    key table on `device`: one host-to-device copy, no sync."""
    rows = [[_i64(s), _i64(o)] for s, o in map(philox_key, gens)]
    return torch.tensor(rows, dtype=torch.int64).to(device, non_blocking=True)


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
    scale = _scale(w_bits)
    return _tile_scores(_rows(n_dt, docs).to(torch.float32) * scale,
                        _rows(n_wt, words).to(torch.float32) * scale,
                        n_t.to(torch.float32) * scale, z, weights, noise,
                        alpha=alpha, beta=beta, beta_bar=beta_bar)


def _scale(w_bits: Optional[int]) -> float:
    """Stored units -> real units: 2^-(w_bits+1) for fixed point, else 1."""
    return 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)


def _tile_scores(rows_d, rows_w, tot, z, weights, noise, *, alpha: float, beta: float,
                 beta_bar: float) -> torch.Tensor:
    """Score + noise from real-unit gathered rows (the reference's
    `_resample_tile` before its argmax)."""
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
           many: bool = False, philox=None) -> None:
    """What the kernel takes: one model, or with `many` M stacked models
    (a leading (M,) axis on every argument), with injected `noise` or, when
    it is None, a Philox key `philox`: (seed, offset) for one model, an
    (M, 2) int64 table on the tokens' device for M."""
    if (noise is None) == (philox is None):
        raise ValueError("pass either noise or a Philox key, not both or neither")
    ref = z if noise is None else noise
    if ref.dim() != (1 if noise is None else 2) + many:
        what = ("z must be (M, N)" if many else "z must be (N,)") if noise is None \
            else ("noise must be (M, N, K)" if many else "noise must be (N, K)")
        raise ValueError(what)
    if noise is None:
        lead, n, k = tuple(z.shape[:-1]), z.shape[-1], n_t.shape[-1]
    else:
        lead = tuple(noise.shape[:-2])
        n, k = noise.shape[-2:]
    named = dict(docs=docs, words=words, z=z, weights=weights, n_dt=n_dt,
                 n_wt=n_wt, n_t=n_t, noise=noise)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {'z' if noise is None else 'noise'} "
                             f"on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("docs", "words", "z"):
        if named[name].dtype != torch.int32 or named[name].shape != (*lead, n):
            raise ValueError(f"{name} must be int32 of shape {(*lead, n)}")
    if weights.dtype != torch.float32 or weights.shape != (*lead, n):
        raise ValueError(f"weights must be float32 of shape {(*lead, n)}")
    if noise is not None and noise.dtype != torch.float32:
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
    if philox is not None:
        check_philox_key(philox, lead, ref.device, many)


def check_philox_key(philox, lead: tuple, device, many: bool) -> None:
    """A Philox key as the kernels take it: a (seed, offset) pair of uint64
    ints for one model, a contiguous (M, 2) int64 table on `device` (`lead`
    = (M,)) for M."""
    if many:
        if not isinstance(philox, torch.Tensor) or philox.dtype != torch.int64 \
                or philox.shape != (*lead, 2) or philox.device != device \
                or not philox.is_contiguous():
            raise ValueError(f"the Philox key must be a contiguous int64 tensor of shape "
                             f"{(*lead, 2)} on {device}")
    elif not (isinstance(philox, tuple) and len(philox) == 2
              and all(isinstance(x, int) and 0 <= x < 1 << 64 for x in philox)):
        raise ValueError("the Philox key must be a (seed, offset) pair of uint64 ints")


def philox_noise(z, n_t, philox) -> torch.Tensor:
    """The Philox mode's noise as a tensor: (N, K) under a (seed, offset)
    pair, (M, N, K) under an (M, 2) key table."""
    n, k = z.shape[-1], n_t.shape[-1]
    if isinstance(philox, torch.Tensor):
        return philox_gumbel_plain(philox[:, 0], philox[:, 1], n, k)
    return philox_gumbel_plain(philox[0], philox[1], n, k, device=z.device)


def resample(docs, words, z, weights, n_dt, n_wt, n_t, noise=None, *,
             alpha: float, beta: float, beta_bar: float,
             w_bits: Optional[int] = None, philox: Optional[tuple[int, int]] = None
             ) -> torch.Tensor:
    """New topic per token (N,) int32 from ids (N,), the full count tables
    (D,K)/(V,K)/(K,) — int32 fixed point when `w_bits` is set, else
    float32 — and either Gumbel noise (N, K) or a Philox key `philox` =
    (seed, offset) under which the kernel draws it. CPU tensors take the plain
    version (`resample_plain`, on `philox_gumbel_plain`'s noise in Philox
    mode); CUDA tensors launch the kernel."""
    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    dev = (z if noise is None else noise).device
    if dev.type == "cpu":
        if noise is None:
            _check(docs, words, z, weights, n_dt, n_wt, n_t, None, w_bits, philox=philox)
            noise = philox_noise(z, n_t, philox)
        elif philox is not None:
            raise ValueError("pass either noise or a Philox key, not both or neither")
        return resample_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise, **hp)
    if dev.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {dev}")
    _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits, philox=philox)
    from repro_torch.kernels.lda_gibbs import kernel

    z_out = torch.empty_like(z)
    kernel.launch(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                  alpha=float(alpha), beta=float(beta), beta_bar=float(beta_bar),
                  scale=_scale(w_bits), philox=philox or (0, 0))
    resample.launches += 1
    resample.tokens += z.numel()
    if noise is None:
        resample.launches_philox += 1
    return z_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts),
#: those of them in the Philox mode, and the tokens the launches resampled.
resample.launches = 0
resample.launches_philox = 0
resample.tokens = 0


def perturbed_scores_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, *,
                           alpha: float, beta: float, beta_bar: float, bits: int,
                           w_bits: Optional[int] = None) -> torch.Tensor:
    """(N, K) scores plus noise with a packed word table: the gathered code
    rows dequantize to ``float(code) * scale`` (the reference's
    ``codes.astype(f32) * scales``), then score as `perturbed_scores` does
    with ``w_bits=None`` on the decoded n_dt / n_t."""
    k = noise.shape[-1]
    rows_c = codes[words]
    if bits == 4:
        rows_c = quant.unpack_nibbles_torch(rows_c, k)
    rows_w = rows_c.to(torch.float32) * scales[words][:, None]
    scale = _scale(w_bits)
    return _tile_scores(n_dt[docs].to(torch.float32) * scale, rows_w,
                        n_t.to(torch.float32) * scale, z, weights, noise,
                        alpha=alpha, beta=beta, beta_bar=beta_bar)


def resample_quant_plain(docs, words, z, weights, n_dt, codes, scales, n_t, noise, *,
                         alpha: float, beta: float, beta_bar: float, bits: int,
                         w_bits: Optional[int] = None) -> torch.Tensor:
    """Eager-PyTorch packed-table resample: Gumbel-max over
    `perturbed_scores_quant` (ties to the lowest topic); weight-0 tokens
    keep their topic."""
    scores = perturbed_scores_quant(docs, words, z, weights, n_dt, codes, scales, n_t,
                                    noise, alpha=alpha, beta=beta, beta_bar=beta_bar,
                                    bits=bits, w_bits=w_bits)
    z_new = torch.argmax(scores, dim=-1).to(z.dtype)
    return torch.where(weights > 0.0, z_new, z)


def _check_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, bits,
                 w_bits, philox=None) -> None:
    """What the packed-table entry takes: `_check`'s arguments with the
    word table replaced by (V, Kc) uint8 codes and (V,) float32 scales."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if noise is not None and noise.dim() != 2:
        raise ValueError("noise must be (N, K)")
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError("codes must be a (V, Kc) uint8 table")
    ref, ref_name = (z, "z") if noise is None else (noise, "noise")
    k = n_t.shape[-1] if noise is None else noise.shape[-1]
    kc = k if bits == 8 else (k + 1) // 2
    if codes.shape[1] != kc:
        raise ValueError(f"codes must have {kc} columns for K={k} at {bits} bits")
    if scales.dtype != torch.float32 or scales.shape != (codes.shape[0],):
        raise ValueError(f"scales must be float32 of shape ({codes.shape[0]},)")
    for name, t in (("codes", codes), ("scales", scales)):
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The exact arguments as `_check` sees them, with a word table of the
    # counts' own type standing in for the codes (it is not read).
    stand_in = torch.empty((0, k), dtype=n_dt.dtype, device=n_dt.device)
    _check(docs, words, z, weights, n_dt, stand_in, n_t, noise, w_bits, philox=philox)


def resample_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise=None, *,
                   alpha: float, beta: float, beta_bar: float, bits: int,
                   w_bits: Optional[int] = None,
                   philox: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """New topic per token (N,) int32 from ids (N,), the stored doc-topic
    table (D, K) and totals (K,) — int32 fixed point when `w_bits` is set,
    else float32 — the packed word table (`codes` (V, K) uint8 for bits 8,
    (V, ceil(K/2)) nibble-packed for bits 4, `scales` (V,) float32) and
    either Gumbel noise (N, K) or a Philox key `philox` = (seed, offset),
    under which the kernel draws what `resample` draws under it. CPU tensors
    take the plain version (`resample_quant_plain`, on `philox_gumbel_plain`'s
    noise in Philox mode); CUDA tensors launch the kernel."""
    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, bits=bits, w_bits=w_bits)
    dev = (z if noise is None else noise).device
    if dev.type == "cpu":
        if noise is None:
            _check_quant(docs, words, z, weights, n_dt, codes, scales, n_t, None, bits, w_bits,
                         philox=philox)
            noise = philox_noise(z, n_t, philox)
        elif philox is not None:
            raise ValueError("pass either noise or a Philox key, not both or neither")
        return resample_quant_plain(docs, words, z, weights, n_dt, codes, scales, n_t,
                                    noise, **hp)
    if dev.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {dev}")
    _check_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, bits, w_bits,
                 philox=philox)
    from repro_torch.kernels.lda_gibbs import kernel

    z_out = torch.empty_like(z)
    kernel.launch_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, z_out,
                        bits=bits, alpha=float(alpha), beta=float(beta),
                        beta_bar=float(beta_bar), scale=_scale(w_bits),
                        philox=philox or (0, 0))
    resample_quant.launches += 1
    if noise is None:
        resample_quant.launches_philox += 1
    return z_out


#: Packed-table kernel launches so far (CUDA tensors only), and those of
#: them in the Philox mode.
resample_quant.launches = 0
resample_quant.launches_philox = 0


def pack_word_table_plain(cfg: LDAConfig, n_wt: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """`pack_word_table` in eager PyTorch: the stored (V, K) counts decoded
    (`codec.decode_array`), row-quantized (`quant.quantize_rows_torch`) and,
    for int4, nibble-packed (`quant.pack_nibbles_torch`)."""
    bits = cfg.quant_spec.bits
    codes, scales = quant.quantize_rows_torch(codec.decode_array(cfg, n_wt), bits)
    if bits == 4:
        codes = quant.pack_nibbles_torch(codes)
    return codes, scales


def pack_word_table(cfg: LDAConfig, n_wt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A packed sweep's stale word table: the stored (V, K) counts decoded
    and row-quantized to the spec's width (codes nibble-packed for int4),
    with their (V,) scales. A CPU table takes `pack_word_table_plain`; a
    CUDA table one launch of the pack kernel (`kernel.pack_rows`, counted in
    ``pack_word_table.launches``), equal to it bit for bit."""
    if n_wt.device.type == "cpu":
        return pack_word_table_plain(cfg, n_wt)
    if n_wt.device.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {n_wt.device}")
    bits = cfg.quant_spec.bits
    w_bits = codec.codec_for(cfg).spec.w_bits
    want = torch.float32 if w_bits is None else torch.int32
    if n_wt.dtype != want or n_wt.dim() != 2 or not n_wt.is_contiguous():
        raise ValueError(f"n_wt must be a contiguous 2-D {want} table (w_bits={w_bits})")
    v, k = n_wt.shape
    codes = torch.empty((v, k if bits == 8 else (k + 1) // 2), dtype=torch.uint8,
                        device=n_wt.device)
    scales = torch.empty(v, dtype=torch.float32, device=n_wt.device)
    from repro_torch.kernels.lda_gibbs import kernel

    kernel.pack_rows(n_wt, codes, scales, bits=bits, scale=_scale(w_bits))
    pack_word_table.launches += 1
    return codes, scales


#: Pack-kernel launches so far (CUDA tables only).
pack_word_table.launches = 0


def sweep_resample(cfg: LDAConfig, state: LDAState, corpus: Corpus,
                   gen: torch.Generator,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full resampling pass in a single kernel call; returns the new z
    (counts rebuilt by the caller). Stored tables go in as they are
    (fixed-point int32 is rescaled inside the kernel). With a packed
    `cfg.quant` (int8/int4_packed) the word-topic table is quantized once
    for the sweep (`pack_word_table`) and `resample_quant` scores against
    it; n_dt and n_t stay exact. `noise` (N, K) replaces the draw from
    `gen`, so a test can replay the reference's. Without it, a sweep on the
    card, exact or packed, draws its noise in the kernel under
    `philox_key(gen)`, and a CPU sweep draws (N, K) `torch.rand` Gumbel
    noise from `gen`: either way an exact and a packed sweep from one
    generator state share their noise, as the reference's do from one key."""
    spec = cfg.quant_spec
    w_bits = codec.codec_for(cfg).spec.w_bits
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    philox = None
    if noise is None and corpus.device.type == "cuda":
        philox = philox_key(gen)
    elif noise is None:
        noise = gumbel((corpus.num_tokens, cfg.num_topics), gen, corpus.device)
    if spec.packed:
        codes, scales = pack_word_table(cfg, state.n_wt)
        return resample_quant(corpus.docs, corpus.words, state.z, corpus.weights,
                              state.n_dt, codes, scales, state.n_t, noise, philox=philox,
                              bits=spec.bits, **hp)
    return resample(corpus.docs, corpus.words, state.z, corpus.weights,
                    state.n_dt, state.n_wt, state.n_t, noise, philox=philox, **hp)


def sweep(cfg: LDAConfig, state: LDAState, corpus: Corpus, gen: torch.Generator,
          noise: Optional[torch.Tensor] = None) -> LDAState:
    """Full kernel-path Gibbs sweep (one launch + count rebuild)."""
    z_new = sweep_resample(cfg, state, corpus, gen, noise)
    return codec.rebuild_state(cfg, corpus, z_new)


def resample_many(docs, words, z, weights, n_dt, n_wt, n_t, noise=None, *,
                  alpha: float, beta: float, beta_bar: float,
                  w_bits: Optional[int] = None,
                  philox: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New topics (M, N) int32 for M stacked models from ids (M, N), their
    count tables (M, D, K)/(M, V, K)/(M, K) — int32 fixed point when
    `w_bits` is set, else float32 — and either noise (M, N, K) or a Philox
    key `philox`, an (M, 2) int64 table of (seed, offset) rows
    (`philox_keys`).
    CPU tensors take the plain version; CUDA tensors launch the batched
    kernel once for all M models."""
    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    dev = (z if noise is None else noise).device
    if dev.type == "cpu":
        if noise is None:
            _check(docs, words, z, weights, n_dt, n_wt, n_t, None, w_bits, many=True,
                   philox=philox)
            noise = philox_noise(z, n_t, philox)
        elif philox is not None:
            raise ValueError("pass either noise or a Philox key, not both or neither")
        return resample_many_plain(docs, words, z, weights, n_dt, n_wt, n_t, noise, **hp)
    if dev.type != "cuda":
        raise ValueError(f"no lda_gibbs kernel for device {dev}")
    _check(docs, words, z, weights, n_dt, n_wt, n_t, noise, w_bits, many=True, philox=philox)
    from repro_torch.kernels.lda_gibbs import kernel

    z_out = torch.empty_like(z)
    kernel.launch_many(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                       alpha=float(alpha), beta=float(beta), beta_bar=float(beta_bar),
                       scale=_scale(w_bits), philox=philox)
    resample_many.launches += 1
    if noise is None:
        resample_many.launches_philox += 1
    return z_out


#: Batched kernel launches so far (CUDA tensors only), and those of them in
#: the Philox mode.
resample_many.launches = 0
resample_many.launches_philox = 0


def sweep_many(cfg: LDAConfig, states: LDAState, corpora: Corpus,
               noise: Optional[torch.Tensor] = None, *,
               philox: Optional[torch.Tensor] = None) -> LDAState:
    """One Gibbs sweep over M stacked models from their (M, N, K) noise or
    their (M, 2) Philox key table: one `resample_many` on the stored
    tables, then the batched count rebuild, stored units in and out. `cfg`
    is the stack's shared config (`cfg.num_docs` the padded per-model
    document capacity)."""
    z_new = resample_many(corpora.docs, corpora.words, states.z, corpora.weights,
                          states.n_dt, states.n_wt, states.n_t, noise,
                          alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                          w_bits=codec.codec_for(cfg).spec.w_bits, philox=philox)
    return codec.rebuild_state(cfg, corpora, z_new)
