// Fused collapsed-Gibbs score + Gumbel-max resample for Hopper (sm_90a).
//
// Replaces the TPU kernels `gibbs_resample_blocked` (entry
// `lda_gibbs_resample`), `gibbs_resample_blocked_batched` (entry
// `lda_gibbs_resample_batched`) and `gibbs_resample_blocked_quant` (entry
// `lda_gibbs_resample_quant`) in src/repro/kernels/lda_gibbs/kernel.py
// (`_gibbs_kernel`, `_gibbs_kernel_batched`, `_gibbs_kernel_quant`,
// `_resample_tile`).
// For every token i with doc d, word w, topic z and weight wt, over K topics:
//
//   own_t   = wt * [t == z]
//   score_t = log(max(n_dt[d,t]*s - own_t, 0) + alpha)
//           + log(max(n_wt[w,t]*s - own_t, 0) + beta)
//           - log(max(n_t[t]*s   - own_t, 1e-9) + beta_bar)
//   z'      = argmax_t(score_t + g[i,t])        (ties -> lowest t)
//
// with s = 2^-(w_bits+1) for int32 fixed-point counts and s = 1 for float32
// counts; tokens of weight <= 0 keep z.
//
// Noise. Every entry takes g in one of two modes:
//   injected  an (N, K) / (M, N, K) float32 input, as the TPU kernel takes
//             it (the parity tests and the blocked `torch` sweep use it);
//   Philox    drawn here: u(i, t) is word t & 3 of Philox4x32-10 with
//             counter (t >> 2, i, offset_lo, offset_hi) and key (seed_lo,
//             seed_hi ^ 0x4C444147), i the token's index within its own
//             model; u = (x >> 8) * 2^-24 and g = -log(-log(max(u, FLT_MIN))).
//             The tag keeps the stream apart from PyTorch's own Philox draws
//             on the same generator; (seed, offset) come from the sweep's
//             generator, one pair per model in the batched entry. The quant
//             entry draws the same g(i, t) as the single-model entry under
//             the same key, so an exact and a packed sweep share their noise
//             (the reference draws both at one width from one key).
//
// What bounds it: bytes, counted once. Per token it reads 16 B of
// ids/assignment/weight and writes 4 B; the injected mode adds the K*4 B
// noise row. The count rows are gathered by id from small (D*K, V*K) tables
// that stay in L2, so device memory sees only the per-token streams. The TPU
// version received the (N, K) rows pre-gathered in HBM; no gathered copy is
// written here. In practice the arithmetic bounds it: the Philox mode reads
// no noise but computes two more logs and a quarter of a Philox call a
// topic, which on the H100 takes longer than the noise row's read (a sweep
// still gains: no separate draw, no (N, K) buffer).
//
// One body serves every entry; the quant entry reads its word row from the
// packed table (`WordRows`), the others from the stored counts.
// K <= 32, from 2^17 tokens: one thread a token, templated
// on a K bucket (16 or 32, the tail masked). A thread loads its token's ids (coalesced across
// the warp), then its rows (16-byte vectors when K % 4 == 0 and the tables
// are 16-byte aligned: K = 12 is 3 vectors a row) and injected noise, all
// before it scores any topic. Scores stay in registers and the argmax runs
// in the thread (strict > over ascending t: the first maximum), so no
// shuffles. (Two or four tokens a thread, every load ahead of every score,
// ran slower on the H100: their registers cost more warps than their
// overlapped gathers gained.) A weight-0 slot writes its z back and skips
// the gathers and the noise (45% of the zoo's larger bucket is padding).
// The grid comes from N (and M, as blockIdx.y): no grid-stride chains.
// Each block stages its model's totals and their logs, log(max(n_t*s,
// 1e-9) + beta_bar), in shared memory.
// Log tables: every topic but the token's own scores log(n_dt*s + alpha) +
// log(n_wt*s + beta), which depends on the row alone. With a thread a
// token, a first kernel (`log_rows_kernel`) writes those logs once a call
// into scratch the wrapper allocates, and the token kernel gathers log rows
// in place of count rows; only t == z takes its three self-excluded logs,
// once a token. Same logf on the same floats, so
// the scores are bit for bit those of the direct form; the two logs a
// token and topic the tables save were a quarter of the kernel's time.
// Few tokens, K <= 32: a call with fewer than 2^17 tokens (a 4,096-token
// block of the `torch` route) takes a group of 16 lanes a token (32 above
// K 16), lane t scoring topic t from the count rows and totals as they are
// (no log tables, no shared memory, no barrier: a launch's serial chain is
// ids -> rows -> three logs -> a butterfly), so the card has enough
// threads and each one little to do. In the Philox mode lane t takes word
// t & 3 of its chunk's Philox call.
// K > 32: a warp a token; lane l scores topic chunks
// 4c .. 4c+3 for c = l, l + 32, ... (one Philox call a chunk), then a
// butterfly picks the maximum with ties to the lower topic. The block keeps
// the (K,) totals and their logs in 2 K floats of dynamic shared memory:
// past the 48 KB a kernel has by default above K 6,144, so the kernel is
// opted in to the card's limit once per instantiation (K <= 8,192 takes 64
// KB).
//
// Quant entry (packed word table): the word-topic counts arrive as a
// (V, Kc) uint8 code table — Kc = K for int8, ceil(K/2) nibble-packed (low
// nibble first) for int4 — and a (V,) float32 scale table; topic t reads
// code[w, t] (int4: byte t>>1, low nibble for even t) and scale[w] by the
// token's word id and scores against float(code) * scale, the reference's
// `codes.astype(f32) * scales` product. Its log table is
// lw[v, t] = log(float(code[v, t]) * scale[v] + beta), the same logf of the
// same float the plain version takes; the token kernel reads code[w, z] and
// scale[w] for its own topic only. Codes are read a byte at a time (the
// rows are a few bytes and stay in L1/L2).
//
// Packing (`pack_rows_kernel`, entry `lda_gibbs_pack_word_table`): a packed
// sweep's stale word table in one launch, a warp a row: decode the stored
// counts, the row's maximum by shuffles, scale = max / levels by IEEE
// division, codes = clamp(rint(x / safe), 0, levels) (half to even), int4
// nibbles low first with a zero nibble padding odd K: bit for bit the
// eager `quantize_rows_torch` + `pack_nibbles_torch`. It writes no log
// table: the quant entry takes (codes, scales) as every caller hands them
// and builds its own, reading the codes once more (a tenth of a megabyte).
//
// Build without fast math and with -fmad=false: `logf` (not `__logf`) and
// unfused multiply-subtract keep the scores within an ulp of the reference.

#include <cuda_runtime.h>
#include <curand_kernel.h>  // curand_Philox4x32_10, for the test entry only
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // the K > 32 path, the log tables, packing
constexpr int kTokenThreads = 128;    // the K <= 32 path, a thread a token
constexpr int kGroupThreads = 256;    // the K <= 32 path, few tokens
constexpr int kWarpTokens = 4;        // tokens a warp takes in the K > 32 path
constexpr int kMaxK = 8192;           // topics a call may have
constexpr int kMaxSmem = 232448;      // bytes a block can opt into on sm_90
constexpr unsigned kPhiloxKeyTag = 0x4C444147u;
constexpr float kFltMin = 1.17549435e-38f;

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., SC'11), as in Random123 and cuRAND.

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// One model's noise key: (seed_lo, seed_hi ^ tag) and the offset's words.
struct NoiseKey {
  uint2 key;
  unsigned off_lo, off_hi;
};

__device__ __forceinline__ NoiseKey noise_key(unsigned long long seed,
                                              unsigned long long offset) {
  return {make_uint2(static_cast<unsigned>(seed),
                     static_cast<unsigned>(seed >> 32) ^ kPhiloxKeyTag),
          static_cast<unsigned>(offset), static_cast<unsigned>(offset >> 32)};
}

__device__ __forceinline__ float gumbel_of(unsigned x) {
  const float u = static_cast<float>(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
  return -logf(-logf(fmaxf(u, kFltMin)));
}

// Gumbel noise of token i, topics 4c .. 4c+3.
__device__ __forceinline__ void philox_gumbel4(const NoiseKey& nk, unsigned c,
                                               unsigned i, float (&g)[4]) {
  const uint4 x = philox4x32_10(make_uint4(c, i, nk.off_lo, nk.off_hi), nk.key);
  g[0] = gumbel_of(x.x);
  g[1] = gumbel_of(x.y);
  g[2] = gumbel_of(x.z);
  g[3] = gumbel_of(x.w);
}

// ---------------------------------------------------------------------------
// Pieces every entry shares.

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

// Four entries 4c .. 4c+3 of a row, times `scale` (real units); a 16-byte
// load when `vec`, else scalar loads of the entries below k.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ row, int c, int k, bool vec,
                                      float scale, float (&out)[4]) {
  if (vec) {
    const typename Vec4<T>::type v = reinterpret_cast<const typename Vec4<T>::type*>(row)[c];
    out[0] = static_cast<float>(v.x) * scale;
    out[1] = static_cast<float>(v.y) * scale;
    out[2] = static_cast<float>(v.z) * scale;
    out[3] = static_cast<float>(v.w) * scale;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[q] = (4 * c + q < k) ? static_cast<float>(row[4 * c + q]) * scale : 0.0f;
    }
  }
}

// Word-topic count t of a packed row: an 8-bit code, or the t-th nibble
// (low first), times the row's scale.
template <int kCodeBits>
__device__ __forceinline__ float word_count(const uint8_t* row, int t, float s) {
  if constexpr (kCodeBits == 4) {
    const unsigned b = row[t >> 1];
    return static_cast<float>((t & 1) ? (b >> 4) : (b & 0xFu)) * s;
  } else {
    return static_cast<float>(row[t]) * s;
  }
}

// The word-topic table in real units: the stored (V, K) counts times
// `scale` (kCodeBits 0: the exact entries), or a packed (V, Kc) code table
// with one scale a row (kCodeBits 8, or 4 nibble-packed).
template <typename T, int kCodeBits>
struct WordRows {
  const T* n_wt;          // the model's stored counts (kCodeBits 0)
  const uint8_t* codes;   // the packed table (kCodeBits 8 or 4)
  const float* w_scales;  // (V,) row scales (kCodeBits 8 or 4)

  __device__ __forceinline__ float count(long long w, int t, int k, float scale) const {
    if constexpr (kCodeBits == 0) {
      return static_cast<float>(n_wt[w * k + t]) * scale;
    } else {
      const long long kc = kCodeBits == 4 ? (k + 1) / 2 : k;
      return word_count<kCodeBits>(codes + w * kc, t, w_scales[w]);
    }
  }
};

// Model m's tables, totals, tokens and noise (64-bit offsets), and its key.
template <typename T, bool kBatched>
struct ModelView {
  const int32_t* docs;
  const int32_t* words;
  const int32_t* z;
  const float* weights;
  const T* n_dt;
  const T* n_wt;
  const T* n_t;
  const float* noise;
  int32_t* z_out;
  const float* ld;  // the model's log tables (`log_rows_kernel`), when given
  const float* lw;
  NoiseKey nk;

  __device__ ModelView(const int32_t* docs_, const int32_t* words_, const int32_t* z_,
                       const float* weights_, const T* n_dt_, const T* n_wt_,
                       const T* n_t_, const float* noise_, int32_t* z_out_,
                       const float* work, const unsigned long long* keys,
                       unsigned long long seed, unsigned long long offset, int n, int d,
                       int v, int k) {
    const long long m = kBatched ? blockIdx.y : 0;
    const long long models = kBatched ? gridDim.y : 1;
    const long long tok0 = m * n;
    docs = docs_ + tok0;
    words = words_ + tok0;
    z = z_ + tok0;
    weights = weights_ + tok0;
    z_out = z_out_ + tok0;
    noise = noise_ ? noise_ + tok0 * k : nullptr;
    n_dt = n_dt_ + m * d * k;
    n_wt = n_wt_ + m * v * k;
    n_t = n_t_ + m * k;
    ld = work ? work + m * d * k : nullptr;
    lw = work ? work + models * d * k + m * v * k : nullptr;
    nk = (kBatched && keys) ? noise_key(keys[2 * m], keys[2 * m + 1]) : noise_key(seed, offset);
  }
};

// Stage the model's totals in real units and their logs without
// self-exclusion: tot[t] and ltot[t] = log(max(tot[t], 1e-9) + beta_bar),
// the n_t term of every topic but the token's own (own = 0 there, and
// tot - 0 is tot exactly).
template <typename T>
__device__ __forceinline__ void stage_totals(const T* __restrict__ n_t, int k, float scale,
                                             float beta_bar, float* tot, float* ltot) {
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const float x = static_cast<float>(n_t[t]) * scale;
    tot[t] = x;
    ltot[t] = logf(fmaxf(x, 1e-9f) + beta_bar);
  }
  __syncthreads();
}

// Score topics 4c .. 4c+3 (those below k) and keep the first maximum:
// ltot[t] the staged totals' logs for t != z, lz the token's own topic's.
__device__ __forceinline__ void score4(int c, int k, int zi, float wi, float lz,
                                       const float (&rd4)[4], const float (&rw4)[4],
                                       const float (&g4)[4], const float* ltot,
                                       float alpha, float beta, float& best, int& best_t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * c + q;
    if (t < k) {
      const bool mine = t == zi;
      const float own = mine ? wi : 0.0f;
      const float rd = fmaxf(rd4[q] - own, 0.0f);
      const float rw = fmaxf(rw4[q] - own, 0.0f);
      const float lt = mine ? lz : ltot[t];
      const float logit = (logf(rd + alpha) + logf(rw + beta)) - lt;
      const float val = logit + g4[q];
      if (val > best) {  // strict: the first maximum over ascending t
        best = val;
        best_t = t;
      }
    }
  }
}

// The same from log tables: ld4[q] = log(n_dt*s + alpha) and lw4[q] =
// log(n_wt*s + beta) of topic 4c+q without self-exclusion, lzd, lzw and lz
// the three terms of the token's own topic.
__device__ __forceinline__ void score4_logs(int c, int k, int zi, float lzd, float lzw,
                                            float lz, const float (&ld4)[4],
                                            const float (&lw4)[4], const float (&g4)[4],
                                            const float* ltot, float& best, int& best_t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * c + q;
    if (t < k) {
      const bool mine = t == zi;
      const float logit = ((mine ? lzd : ld4[q]) + (mine ? lzw : lw4[q])) - (mine ? lz : ltot[t]);
      const float val = logit + g4[q];
      if (val > best) {
        best = val;
        best_t = t;
      }
    }
  }
}

// One sweep's log tables of the count rows, without self-exclusion:
// ld = log(max(n_dt*s, 0) + alpha) over all M*D*K entries, then
// lw = log(max(n_wt*s, 0) + beta) over M*V*K (the terms score4 takes for
// t != z, bit for bit: x - 0 is x); from a packed table (one model),
// lw = log(max(code*scale, 0) + beta).
template <typename T, int kCodeBits>
__global__ void __launch_bounds__(kThreads)
log_rows_kernel(const T* __restrict__ n_dt, const WordRows<T, kCodeBits> wr, long long dk,
                long long vk, int k, float alpha, float beta, float scale,
                float* __restrict__ ld, float* __restrict__ lw) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < dk + vk;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (j < dk) {
      ld[j] = logf(fmaxf(static_cast<float>(n_dt[j]) * scale, 0.0f) + alpha);
    } else if constexpr (kCodeBits == 0) {
      lw[j - dk] = logf(fmaxf(static_cast<float>(wr.n_wt[j - dk]) * scale, 0.0f) + beta);
    } else {
      const long long jw = j - dk;
      lw[jw] = logf(fmaxf(wr.count(jw / k, static_cast<int>(jw % k), k, scale), 0.0f) + beta);
    }
  }
}

// ---------------------------------------------------------------------------
// K <= 32: a thread a token, CPL chunks of 4 topics.

template <typename T, int CPL, bool kBatched, bool kPhilox, int kCodeBits>
__global__ void __launch_bounds__(kTokenThreads)
resample_token_kernel(const int32_t* __restrict__ docs_, const int32_t* __restrict__ words_,
                      const int32_t* __restrict__ z_, const float* __restrict__ weights_,
                      const T* __restrict__ n_dt_, const T* __restrict__ n_wt_,
                      const uint8_t* __restrict__ codes, const float* __restrict__ w_scales,
                      const T* __restrict__ n_t_, const float* __restrict__ noise_,
                      const float* __restrict__ work,
                      const unsigned long long* __restrict__ keys,
                      unsigned long long seed, unsigned long long offset,
                      int32_t* __restrict__ z_out_, int n, int d, int v, int k,
                      float alpha, float beta, float beta_bar, float scale, int vec) {
  constexpr int KB = 4 * CPL;  // the K bucket
  const ModelView<T, kBatched> mv(docs_, words_, z_, weights_, n_dt_, n_wt_, n_t_, noise_,
                                  z_out_, work, keys, seed, offset, n, d, v, k);
  const WordRows<T, kCodeBits> wr{mv.n_wt, codes, w_scales};
  __shared__ float tot[KB];
  __shared__ float ltot[KB];
  stage_totals(mv.n_t, k, scale, beta_bar, tot, ltot);

  const long long i = static_cast<long long>(blockIdx.x) * kTokenThreads + threadIdx.x;
  const bool valid = i < n;
  // Ids: neighbouring threads, neighbouring tokens.
  const int zi = valid ? mv.z[i] : 0;
  const float wi = valid ? mv.weights[i] : 0.0f;
  const int di = valid ? mv.docs[i] : 0;
  const int wd = valid ? mv.words[i] : 0;
  const bool live = wi > 0.0f;  // weight-0 slots skip the gathers and the noise

  // Every chunk's log rows (and injected noise) before any score, and the
  // token's own two counts.
  float ld[CPL][4], lw[CPL][4], g[kPhilox ? 1 : CPL][4];
  float own_d = 0.0f, own_w = 0.0f;
  if (live) {
    const long long od = static_cast<long long>(di) * k, ow = static_cast<long long>(wd) * k;
    own_d = static_cast<float>(mv.n_dt[od + zi]) * scale;
    own_w = wr.count(wd, zi, k, scale);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (4 * c < k) {
        load4(mv.ld + od, c, k, vec, 1.0f, ld[c]);
        load4(mv.lw + ow, c, k, vec, 1.0f, lw[c]);
        if constexpr (!kPhilox) load4(mv.noise + i * k, c, k, vec, 1.0f, g[c]);
      }
    }
  }
  float best = -CUDART_INF_F;
  int best_t = 0x7fffffff;
  if (live) {
    const float lz = logf(fmaxf(tot[zi] - wi, 1e-9f) + beta_bar);
    const float lzd = logf(fmaxf(own_d - wi, 0.0f) + alpha);
    const float lzw = logf(fmaxf(own_w - wi, 0.0f) + beta);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (4 * c < k) {
        float e[4];
        if constexpr (kPhilox) {
          philox_gumbel4(mv.nk, c, static_cast<unsigned>(i), e);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) e[q] = g[c][q];
        }
        score4_logs(c, k, zi, lzd, lzw, lz, ld[c], lw[c], e, ltot, best, best_t);
      }
    }
  }
  if (valid) mv.z_out[i] = !live ? zi : (best_t == 0x7fffffff ? 0 : best_t);
}

// ---------------------------------------------------------------------------
// K <= 32, few tokens: G lanes a token (16, or 32 above K 16), lane t
// scoring topic t from the count rows (or codes) as the reference writes
// it, then a butterfly within the group.

template <typename T, int G, bool kBatched, bool kPhilox, int kCodeBits>
__global__ void __launch_bounds__(kGroupThreads)
resample_group_kernel(const int32_t* __restrict__ docs_, const int32_t* __restrict__ words_,
                      const int32_t* __restrict__ z_, const float* __restrict__ weights_,
                      const T* __restrict__ n_dt_, const T* __restrict__ n_wt_,
                      const uint8_t* __restrict__ codes, const float* __restrict__ w_scales,
                      const T* __restrict__ n_t_, const float* __restrict__ noise_,
                      const unsigned long long* __restrict__ keys,
                      unsigned long long seed, unsigned long long offset,
                      int32_t* __restrict__ z_out_, int n, int d, int v, int k,
                      float alpha, float beta, float beta_bar, float scale) {
  const ModelView<T, kBatched> mv(docs_, words_, z_, weights_, n_dt_, n_wt_, n_t_, noise_,
                                  z_out_, nullptr, keys, seed, offset, n, d, v, k);
  const WordRows<T, kCodeBits> wr{mv.n_wt, codes, w_scales};
  const int t = threadIdx.x % G;
  const long long i = static_cast<long long>(blockIdx.x) * (kGroupThreads / G) + threadIdx.x / G;
  const bool valid = i < n;
  const int zi = valid ? mv.z[i] : 0;
  const float wi = valid ? mv.weights[i] : 0.0f;
  const int di = valid ? mv.docs[i] : 0;
  const int wd = valid ? mv.words[i] : 0;
  const bool live = wi > 0.0f;  // weight-0 slots skip the gathers and the noise
  float best = -CUDART_INF_F;
  int best_t = 0x7fffffff;
  if (live && t < k) {
    const float own = t == zi ? wi : 0.0f;
    const float rd = fmaxf(static_cast<float>(mv.n_dt[static_cast<long long>(di) * k + t]) *
                           scale - own, 0.0f);
    const float rw = fmaxf(wr.count(wd, t, k, scale) - own, 0.0f);
    const float tt = fmaxf(static_cast<float>(mv.n_t[t]) * scale - own, 1e-9f);
    float g;
    if constexpr (kPhilox) {
      const uint4 x = philox4x32_10(
          make_uint4(t >> 2, static_cast<unsigned>(i), mv.nk.off_lo, mv.nk.off_hi), mv.nk.key);
      const int q = t & 3;
      g = gumbel_of(q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w);
    } else {
      g = mv.noise[i * k + t];
    }
    const float val = ((logf(rd + alpha) + logf(rw + beta)) - logf(tt + beta_bar)) + g;
    if (val > best) {
      best = val;
      best_t = t;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    if (ov > best || (ov == best && ot < best_t)) {
      best = ov;
      best_t = ot;
    }
  }
  if (valid && t == 0) mv.z_out[i] = !live ? zi : (best_t == 0x7fffffff ? 0 : best_t);
}

// ---------------------------------------------------------------------------
// K > 32: a warp a token, kWarpTokens tokens a warp.

template <typename T, bool kBatched, bool kPhilox, int kCodeBits>
__global__ void __launch_bounds__(kThreads)
resample_warp_kernel(const int32_t* __restrict__ docs_, const int32_t* __restrict__ words_,
                     const int32_t* __restrict__ z_, const float* __restrict__ weights_,
                     const T* __restrict__ n_dt_, const T* __restrict__ n_wt_,
                     const uint8_t* __restrict__ codes, const float* __restrict__ w_scales,
                     const T* __restrict__ n_t_, const float* __restrict__ noise_,
                     const unsigned long long* __restrict__ keys,
                     unsigned long long seed, unsigned long long offset,
                     int32_t* __restrict__ z_out_, int n, int d, int v, int k,
                     float alpha, float beta, float beta_bar, float scale, int vec) {
  const ModelView<T, kBatched> mv(docs_, words_, z_, weights_, n_dt_, n_wt_, n_t_, noise_,
                                  z_out_, nullptr, keys, seed, offset, n, d, v, k);
  const WordRows<T, kCodeBits> wr{mv.n_wt, codes, w_scales};
  extern __shared__ float smem[];  // (K,) totals, then (K,) their logs
  float* tot = smem;
  float* ltot = smem + k;
  stage_totals(mv.n_t, k, scale, beta_bar, tot, ltot);

  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int chunks = (k + 3) / 4;
  for (int r = 0; r < kWarpTokens; ++r) {
    const long long i = warp * kWarpTokens + r;
    if (i >= n) break;  // uniform across the warp
    const int zi = mv.z[i];
    const float wi = mv.weights[i];
    if (!(wi > 0.0f)) {
      if (lane == 0) mv.z_out[i] = zi;
      continue;
    }
    const T* row_d = mv.n_dt + static_cast<long long>(mv.docs[i]) * k;
    const long long wd = mv.words[i];
    const float lz = logf(fmaxf(tot[zi] - wi, 1e-9f) + beta_bar);
    float best = -CUDART_INF_F;
    int best_t = 0x7fffffff;
    for (int c = lane; c < chunks; c += 32) {
      float a[4], b[4], e[4];
      load4(row_d, c, k, vec, scale, a);
      if constexpr (kCodeBits == 0) {
        load4(mv.n_wt + wd * k, c, k, vec, scale, b);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b[q] = 4 * c + q < k ? wr.count(wd, 4 * c + q, k, scale) : 0.0f;
        }
      }
      if constexpr (kPhilox) {
        philox_gumbel4(mv.nk, c, static_cast<unsigned>(i), e);
      } else {
        load4(mv.noise + i * k, c, k, vec, 1.0f, e);
      }
      score4(c, k, zi, wi, lz, a, b, e, ltot, alpha, beta, best, best_t);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int ot = __shfl_xor_sync(0xffffffffu, best_t, off);
      if (ov > best || (ov == best && ot < best_t)) {
        best = ov;
        best_t = ot;
      }
    }
    if (lane == 0) mv.z_out[i] = best_t;
  }
}

// A thread a token fills the card from about 2^17 tokens; below that, a
// group of lanes a token (one topic a lane) cuts each token's serial chain.
bool few_tokens(int m, int n) { return static_cast<long long>(m) * n < (1 << 17); }

// Floats of scratch a call takes: the sweep's log tables of n_dt and n_wt
// (M*(D+V)*K) when a thread takes a token, else 0 (the count rows are read
// as they are). The tables pay when a model's tokens pass about half its
// D + V rows: they save 2K - 2 logs a token for (D + V) * K a call.
long long workspace_floats(int m, int n, int d, int v, int k) {
  if (k > 32 || few_tokens(m, n)) return 0;
  return static_cast<long long>(m) * (static_cast<long long>(d) + v) * k;
}

// Opt a kernel in to the card's shared-memory limit once per process (per
// instantiation); each launch then asks for what its K needs.
template <typename K>
cudaError_t opt_in(K kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T, bool kBatched, bool kPhilox, int kCodeBits>
cudaError_t launch_body(const int32_t* docs, const int32_t* words, const int32_t* z,
                        const float* weights, const void* n_dt, const void* n_wt,
                        const uint8_t* codes, const float* w_scales, const void* n_t,
                        const float* noise, float* work, const unsigned long long* keys,
                        unsigned long long seed, unsigned long long offset, int32_t* z_out,
                        int m, int n, int d, int v, int k, float alpha, float beta,
                        float beta_bar, float scale, int vec, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(n_dt);
  const T* wt = static_cast<const T*>(n_wt);
  const T* tt = static_cast<const T*>(n_t);
#define LDA_TOKEN_LAUNCH(CPL)                                                             \
  do {                                                                                    \
    const dim3 grid(static_cast<unsigned>((n + kTokenThreads - 1) / kTokenThreads),       \
                    static_cast<unsigned>(m));                                            \
    resample_token_kernel<T, CPL, kBatched, kPhilox, kCodeBits>                           \
        <<<grid, kTokenThreads, 0, stream>>>(docs, words, z, weights, dt, wt, codes,      \
                                             w_scales, tt, noise, work, keys, seed, offset, \
                                             z_out, n, d, v, k, alpha, beta, beta_bar,    \
                                             scale, vec);                                 \
  } while (0)
#define LDA_GROUP_LAUNCH(G)                                                               \
  do {                                                                                    \
    const long long per = kGroupThreads / (G);                                            \
    const dim3 grid(static_cast<unsigned>((n + per - 1) / per), static_cast<unsigned>(m)); \
    resample_group_kernel<T, G, kBatched, kPhilox, kCodeBits>                             \
        <<<grid, kGroupThreads, 0, stream>>>(docs, words, z, weights, dt, wt, codes,      \
                                             w_scales, tt, noise, keys, seed, offset,     \
                                             z_out, n, d, v, k, alpha, beta, beta_bar,    \
                                             scale);                                      \
  } while (0)
  const bool few = few_tokens(m, n);
  if (workspace_floats(m, n, d, v, k) > 0) {
    const long long dk = static_cast<long long>(m) * d * k, vk = static_cast<long long>(m) * v * k;
    long long blocks = (dk + vk + kThreads - 1) / kThreads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    log_rows_kernel<T, kCodeBits><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        dt, WordRows<T, kCodeBits>{wt, codes, w_scales}, dk, vk, k, alpha, beta, scale, work,
        work + dk);
  }
  if (k <= 16) {
    if (few) LDA_GROUP_LAUNCH(16); else LDA_TOKEN_LAUNCH(4);
  } else if (k <= 32) {
    if (few) LDA_GROUP_LAUNCH(32); else LDA_TOKEN_LAUNCH(8);
  } else {
    auto body = resample_warp_kernel<T, kBatched, kPhilox, kCodeBits>;
    static const cudaError_t ok = opt_in(body);
    if (ok != cudaSuccess) return ok;
    const long long per = static_cast<long long>(kThreads / 32) * kWarpTokens;
    const dim3 grid(static_cast<unsigned>((n + per - 1) / per), static_cast<unsigned>(m));
    const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float);
    body<<<grid, kThreads, smem, stream>>>(docs, words, z, weights, dt, wt, codes, w_scales,
                                           tt, noise, keys, seed, offset, z_out, n, d, v, k,
                                           alpha, beta, beta_bar, scale, vec);
  }
#undef LDA_GROUP_LAUNCH
#undef LDA_TOKEN_LAUNCH
  return cudaGetLastError();
}

cudaError_t check_shape(int m, int d, int v, int k) {
  if (k <= 0 || k > kMaxK || m > 65535 || d < 0 || v < 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Every entry: the exact ones (kCodeBits 0, `n_wt` the stored counts) and
// the quant entry (one model, `codes` and `w_scales` the packed table).
template <bool kBatched, int kCodeBits>
cudaError_t run(const int32_t* docs, const int32_t* words, const int32_t* z,
                const float* weights, const void* n_dt, const void* n_wt, const uint8_t* codes,
                const float* w_scales, const void* n_t, int counts_int, const float* noise,
                float* work, const unsigned long long* keys, unsigned long long seed,
                unsigned long long offset, int32_t* z_out, int m, int n, int d, int v, int k,
                float alpha, float beta, float beta_bar, float scale, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (check_shape(m, d, v, k) != cudaSuccess) return cudaErrorInvalidValue;
  if (kBatched && !noise && !keys) return cudaErrorInvalidValue;
  if (!work && workspace_floats(m, n, d, v, k) > 0) return cudaErrorInvalidValue;
  // Rows (and the totals, the noise and the log tables) as 16-byte vectors
  // when K % 4 == 0 and every base address is 16-byte aligned: then every
  // row of K entries is too. (A packed word table is read a byte at a
  // time; its `n_wt` is NULL.)
  const int vec = k % 4 == 0 && aligned16(n_dt) && aligned16(n_wt) && aligned16(n_t) &&
                  (!noise || aligned16(noise)) && (!work || aligned16(work));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDA_RUN(T, PHILOX)                                                                 \
  launch_body<T, kBatched, PHILOX, kCodeBits>(docs, words, z, weights, n_dt, n_wt, codes,  \
                                              w_scales, n_t, noise, work, keys, seed,      \
                                              offset, z_out, m, n, d, v, k, alpha, beta,   \
                                              beta_bar, scale, vec, s)
  if (counts_int) return noise ? LDA_RUN(int32_t, false) : LDA_RUN(int32_t, true);
  return noise ? LDA_RUN(float, false) : LDA_RUN(float, true);
#undef LDA_RUN
}

// ---------------------------------------------------------------------------
// The packed sweep's stale word table: a warp a row of the stored (V, K)
// counts -> its codes and scale, bit for bit the eager
// `quantize_rows_torch` (+ `pack_nibbles_torch` for int4).

template <int kCodeBits>
__device__ __forceinline__ unsigned code_of(float x, float safe) {
  constexpr float kLevels = kCodeBits == 4 ? 15.0f : 255.0f;
  // clamp(round_half_even(x / safe), 0, levels), x >= 0: IEEE division.
  return static_cast<unsigned>(fminf(fmaxf(rintf(__fdiv_rn(x, safe)), 0.0f), kLevels));
}

template <typename T, int kCodeBits>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const T* __restrict__ n_wt, uint8_t* __restrict__ codes,
                 float* __restrict__ scales, int v, int k, float scale) {
  constexpr float kLevels = kCodeBits == 4 ? 15.0f : 255.0f;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= v) return;  // uniform across the warp
  const T* x = n_wt + row * k;
  // Real units, negatives clipped: max(n * s, 0) (n * 2^-(w_bits+1) is the
  // decode's quotient exactly).
  auto real = [&](int t) { return fmaxf(static_cast<float>(x[t]) * scale, 0.0f); };
  float mx = 0.0f;
  for (int t = lane; t < k; t += 32) mx = fmaxf(mx, real(t));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float s = __fdiv_rn(mx, kLevels);
  const float safe = s > 0.0f ? s : 1.0f;
  if (lane == 0) scales[row] = s;
  if constexpr (kCodeBits == 4) {
    const int kc = (k + 1) / 2;
    for (int j = lane; j < kc; j += 32) {
      const unsigned lo = code_of<4>(real(2 * j), safe);
      const unsigned hi = 2 * j + 1 < k ? code_of<4>(real(2 * j + 1), safe) : 0u;
      codes[row * kc + j] = static_cast<uint8_t>(lo | (hi << 4));
    }
  } else {
    for (int t = lane; t < k; t += 32) {
      codes[row * k + t] = static_cast<uint8_t>(code_of<8>(real(t), safe));
    }
  }
}

__global__ void philox_words_kernel(const uint32_t* __restrict__ ctr,
                                    const uint32_t* __restrict__ key,
                                    uint32_t* __restrict__ ours,
                                    uint32_t* __restrict__ theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]);
  const uint2 k = make_uint2(key[2 * i], key[2 * i + 1]);
  const uint4 a = philox4x32_10(c, k);
  const uint4 b = curand_Philox4x32_10(c, k);
  ours[4 * i] = a.x;
  ours[4 * i + 1] = a.y;
  ours[4 * i + 2] = a.z;
  ours[4 * i + 3] = a.w;
  theirs[4 * i] = b.x;
  theirs[4 * i + 1] = b.y;
  theirs[4 * i + 2] = b.z;
  theirs[4 * i + 3] = b.w;
}

}  // namespace

// Plain C entry points (loaded with ctypes). `counts_int` selects int32
// fixed-point tables (scaled by `scale` in-kernel) over float32 tables.
// Each launches on `stream`, allocates nothing, returns cudaGetLastError().
//
// Floats of scratch (`work`) an exact call of these shapes needs: the
// sweep's log tables of the count rows, or 0 when it reads the rows as they
// are (a pointer of NULL is then fine).
extern "C" long long lda_gibbs_workspace(int m, int n, int d, int v, int k) {
  return workspace_floats(m, n, d, v, k);
}

// One model: ids/z/weights (n,), n_dt (d, k), n_wt (v, k), n_t (k,), and
// noise (n, k) — or, with noise NULL, Philox noise under (seed, offset).
extern "C" int lda_gibbs_resample(const int32_t* docs, const int32_t* words,
                                  const int32_t* z, const float* weights,
                                  const void* n_dt, const void* n_wt,
                                  const void* n_t, int counts_int,
                                  const float* noise, float* work, unsigned long long seed,
                                  unsigned long long offset, int32_t* z_out, int n, int d,
                                  int v, int k, float alpha, float beta,
                                  float beta_bar, float scale, void* stream) {
  return static_cast<int>(run<false, 0>(docs, words, z, weights, n_dt, n_wt, nullptr,
                                        nullptr, n_t, counts_int, noise, work, nullptr, seed,
                                        offset, z_out, 1, n, d, v, k, alpha, beta, beta_bar,
                                        scale, stream));
}

// M stacked models: ids/z/weights (m, n), n_dt (m, d, k), n_wt (m, v, k),
// n_t (m, k), and noise (m, n, k) — or, with noise NULL, Philox noise under
// `keys` (m, 2) int64 rows (seed, offset), one a model. All row-major.
extern "C" int lda_gibbs_resample_batched(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
    int counts_int, const float* noise, float* work, const unsigned long long* keys,
    int32_t* z_out, int m, int n, int d, int v, int k, float alpha, float beta,
    float beta_bar, float scale, void* stream) {
  return static_cast<int>(run<true, 0>(docs, words, z, weights, n_dt, n_wt, nullptr, nullptr,
                                       n_t, counts_int, noise, work, keys, 0, 0, z_out, m, n,
                                       d, v, k, alpha, beta, beta_bar, scale, stream));
}

// One model with a packed word table: ids/z/weights (n,), n_dt (d, k) and
// n_t (k,) stored as above (`counts_int`, `scale`), `codes` (v, k) uint8 for
// bits = 8 or (v, ceil(k/2)) nibble-packed for bits = 4, `w_scales` (v,)
// float32, and noise (n, k) — or, with noise NULL, Philox noise under
// (seed, offset), the draw `lda_gibbs_resample` makes under that key.
// `work`: `lda_gibbs_workspace(1, n, d, v, k)` floats.
extern "C" int lda_gibbs_resample_quant(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const uint8_t* codes,
    const float* w_scales, const void* n_t, int counts_int, int bits,
    const float* noise, float* work, unsigned long long seed, unsigned long long offset,
    int32_t* z_out, int n, int d, int v, int k, float alpha, float beta, float beta_bar,
    float scale, void* stream) {
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bits == 8 ? run<false, 8>(docs, words, z, weights, n_dt, nullptr, codes, w_scales, n_t,
                                counts_int, noise, work, nullptr, seed, offset, z_out, 1, n, d,
                                v, k, alpha, beta, beta_bar, scale, stream)
                : run<false, 4>(docs, words, z, weights, n_dt, nullptr, codes, w_scales, n_t,
                                counts_int, noise, work, nullptr, seed, offset, z_out, 1, n, d,
                                v, k, alpha, beta, beta_bar, scale, stream));
}

// A packed sweep's word table from the stored (v, k) counts `n_wt`
// (`counts_int` as above, `scale` to real units): `codes` (v, k) uint8 for
// bits = 8 or (v, ceil(k/2)) nibble-packed for bits = 4, `scales` (v,).
extern "C" int lda_gibbs_pack_word_table(const void* n_wt, int counts_int, int bits,
                                         uint8_t* codes, float* scales, int v, int k,
                                         float scale, void* stream) {
  if (v <= 0) return 0;
  if (k <= 0 || (bits != 8 && bits != 4)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(v) + kThreads / 32 - 1) /
                                                (kThreads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDA_PACK(T, BITS)                                                                 \
  pack_rows_kernel<T, BITS><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(n_wt), codes, \
                                                         scales, v, k, scale)
  if (counts_int) {
    if (bits == 8) LDA_PACK(int32_t, 8); else LDA_PACK(int32_t, 4);
  } else {
    if (bits == 8) LDA_PACK(float, 8); else LDA_PACK(float, 4);
  }
#undef LDA_PACK
  return static_cast<int>(cudaGetLastError());
}

// Test entry: the kernels' Philox4x32-10 and cuRAND's `curand_Philox4x32_10`
// on n counters (n, 4) and keys (n, 2), uint32, into `ours` and `theirs`.
extern "C" int lda_gibbs_philox_words(const uint32_t* ctr, const uint32_t* key,
                                      uint32_t* ours, uint32_t* theirs, int n,
                                      void* stream) {
  if (n <= 0) return 0;
  philox_words_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ctr, key, ours, theirs, n);
  return static_cast<int>(cudaGetLastError());
}
