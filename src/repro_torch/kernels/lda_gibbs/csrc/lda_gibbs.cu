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
// What bounds it: bytes. Per token it reads 16 B of ids/assignment/weight,
// K*4 B of noise and two K-wide count rows, and writes 4 B; the arithmetic
// (3K logs) is far below the card's float rate. The TPU version received the
// (N, K) rows pre-gathered in HBM; here the kernel gathers the n_dt / n_wt
// rows itself by id, so no (N, K) gathered copy is ever written or read. The
// tables are small (D*K, V*K) and stay in L2, so device-memory traffic is the
// ids, the noise and the output. n_t is staged once per block in shared
// memory. No K or N padding: lanes stride over K and the ragged token edge
// is masked.
//
// Batched: M stacked models of the same K and hyperparameters, each with
// N (padded) token slots, D (padded) doc rows and V word rows. Model m's
// tables start at n_dt + m*D*K, n_wt + m*V*K, n_t + m*K, its tokens at
// m*N and its noise at m*N*K (64-bit offsets throughout). The grid is
// (blocks per model, M): blockIdx.y picks the model, whose n_t the block
// stages, and the block's warps stride over that model's N slots. The TPU
// kernel took (M, N, K) pre-gathered rows; here rows are gathered by id as
// above. Weight-0 slots (the stack's padding) skip the score loop. Both
// entries share one body: the batched instantiation (kBatched) adds the
// model offsets and the skip; the single-model one compiles without either,
// which on the H100 kept it at its earlier time (with them it ran ~10%
// slower).
//
// Packed word table (quant): the word-topic counts arrive as a (V, Kc)
// uint8 code table — Kc = K for int8, ceil(K/2) nibble-packed (low nibble
// first) for int4 — and a (V,) float32 scale table; lane t of a token's
// group reads code[w, t] (int4: byte t>>1, low nibble for even t) and
// scale[w] by the token's word id and scores against float(code) * scale,
// the reference's `codes.astype(f32) * scales` product. n_dt and n_t stay
// exact (scaled by s as above). What bounds it: bytes, as above — the (N, K)
// noise read dominates; the code table is 4x (int8) or 8x (int4) smaller
// than an f32 n_wt and stays in L2. The TPU version received (N, Kc)
// pre-gathered code rows and (N,) scales; here they are gathered by id, so
// no (N, K) rows are written. The word-row source is a template parameter
// of the one body (kCodeBits = 0: the count table itself, scaled by s;
// 8 or 4: codes with per-row scales), so the single-model and batched
// instantiations compile as before.
//
// Shape: a group of G lanes (G = 8, 16 or 32, the least that covers K, capped
// at a warp) owns one token; each lane scans topics lane, lane+G, ... keeping
// its first maximum, then a butterfly shuffle within the group picks the
// overall maximum with ties to the lower topic id. Warps walk the tokens in a
// grid-stride loop whose trip count is uniform across the warp, so every
// shuffle has all 32 lanes present.
//
// Build without fast math and with -fmad=false: `logf` (not `__logf`) and
// unfused multiply-subtract keep the scores within an ulp of the reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Word-topic count t of a word row: the table's own entry (kCodeBits = 0),
// an 8-bit code, or the t-th nibble of a packed row, times the row's scale.
template <int kCodeBits, typename W>
__device__ __forceinline__ float word_count(const W* row, int t, float s) {
  if constexpr (kCodeBits == 4) {
    const unsigned b = row[t >> 1];
    return static_cast<float>((t & 1) ? (b >> 4) : (b & 0xFu)) * s;
  } else {
    return static_cast<float>(row[t]) * s;
  }
}

// T: the stored n_dt / n_t type (float or int32 fixed point, scaled by
// `scale`). W: the word table's type — T itself (kCodeBits = 0) or uint8
// codes (kCodeBits = 8 or 4) with one float scale per row in `w_scales`.
template <typename T, typename W, int kCodeBits, int G, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gibbs_resample_kernel(const int32_t* __restrict__ docs,
                      const int32_t* __restrict__ words,
                      const int32_t* __restrict__ z,
                      const float* __restrict__ weights,
                      const T* __restrict__ n_dt,
                      const W* __restrict__ n_wt,
                      const float* __restrict__ w_scales,
                      const T* __restrict__ n_t,
                      const float* __restrict__ noise,
                      int32_t* __restrict__ z_out,
                      int n, int d, int v, int k, float alpha, float beta,
                      float beta_bar, float scale) {
  // Row stride of the word table: K entries, or K/2 bytes rounded up.
  const int kw = kCodeBits == 4 ? (k + 1) / 2 : k;
  if (kBatched) {  // this block's model: its tables, totals, tokens, noise
    const long long model = blockIdx.y;
    const long long tok0 = model * n;
    docs += tok0;
    words += tok0;
    z += tok0;
    weights += tok0;
    z_out += tok0;
    noise += tok0 * k;
    n_dt += model * d * k;
    n_wt += model * v * kw;
    n_t += model * k;
  }

  extern __shared__ float tot[];  // (K,) topic totals in real units
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    tot[t] = static_cast<float>(n_t[t]) * scale;
  }
  __syncthreads();

  constexpr int kGroupsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;          // lane within the token's group
  const int group = lane / G;        // token slot within the warp
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int num_warps = (gridDim.x * blockDim.x) >> 5;

  for (long long base = static_cast<long long>(warp) * kGroupsPerWarp; base < n;
       base += static_cast<long long>(num_warps) * kGroupsPerWarp) {
    const long long i = base + group;
    const bool valid = i < n;
    float best = -CUDART_INF_F;
    int best_t = 0x7fffffff;
    int zi = 0;
    int di = 0;
    int wd = 0;
    float wi = 0.0f;
    if (valid) {  // all four loads in flight together, ahead of the branch below
      zi = z[i];
      wi = weights[i];
      di = docs[i];
      wd = words[i];
    }
    // Invalid slots have wi = 0; weight-0 tokens keep z either way.
    if (kBatched ? wi > 0.0f : valid) {
      const T* row_d = n_dt + static_cast<long long>(di) * k;
      const W* row_w = n_wt + static_cast<long long>(wd) * kw;
      const float ws = kCodeBits ? w_scales[wd] : scale;
      const float* g = noise + i * k;
      for (int t = sub; t < k; t += G) {
        const float own = (t == zi) ? wi : 0.0f;
        const float rd = fmaxf(static_cast<float>(row_d[t]) * scale - own, 0.0f);
        const float rw = fmaxf(word_count<kCodeBits>(row_w, t, ws) - own, 0.0f);
        const float tt = fmaxf(tot[t] - own, 1e-9f);
        const float logit = (logf(rd + alpha) + logf(rw + beta)) - logf(tt + beta_bar);
        const float val = logit + g[t];
        if (val > best) {  // strict: the first maximum of this lane's topics
          best = val;
          best_t = t;
        }
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
    if (valid && sub == 0) {
      z_out[i] = (wi > 0.0f) ? best_t : zi;
    }
  }
}

template <typename T, typename W, int kCodeBits, int G, bool kBatched>
cudaError_t launch(const int32_t* docs, const int32_t* words, const int32_t* z,
                   const float* weights, const void* n_dt, const void* n_wt,
                   const float* w_scales, const void* n_t, const float* noise,
                   int32_t* z_out, int m, int n, int d, int v, int k, float alpha,
                   float beta, float beta_bar, float scale, cudaStream_t stream) {
  constexpr int kTokensPerBlock = (kThreads / 32) * (32 / G);
  long long blocks = (static_cast<long long>(n) + kTokensPerBlock - 1) / kTokensPerBlock;
  // Enough blocks in all to fill the card several times over; the
  // grid-stride loop covers the rest of each model and amortizes the n_t
  // staging.
  const long long cap = (132 * 16) / m;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(m));
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  gibbs_resample_kernel<T, W, kCodeBits, G, kBatched><<<grid, kThreads, smem, stream>>>(
      docs, words, z, weights, static_cast<const T*>(n_dt),
      static_cast<const W*>(n_wt), w_scales, static_cast<const T*>(n_t), noise,
      z_out, n, d, v, k, alpha, beta, beta_bar, scale);
  return cudaGetLastError();
}

template <typename T, typename W, int kCodeBits, bool kBatched>
cudaError_t dispatch_width(const int32_t* docs, const int32_t* words,
                           const int32_t* z, const float* weights,
                           const void* n_dt, const void* n_wt,
                           const float* w_scales, const void* n_t,
                           const float* noise, int32_t* z_out, int m, int n,
                           int d, int v, int k, float alpha, float beta,
                           float beta_bar, float scale, cudaStream_t stream) {
  if (k <= 8)
    return launch<T, W, kCodeBits, 8, kBatched>(docs, words, z, weights, n_dt, n_wt,
                                                w_scales, n_t, noise, z_out, m, n, d, v,
                                                k, alpha, beta, beta_bar, scale, stream);
  if (k <= 16)
    return launch<T, W, kCodeBits, 16, kBatched>(docs, words, z, weights, n_dt, n_wt,
                                                 w_scales, n_t, noise, z_out, m, n, d, v,
                                                 k, alpha, beta, beta_bar, scale, stream);
  return launch<T, W, kCodeBits, 32, kBatched>(docs, words, z, weights, n_dt, n_wt,
                                               w_scales, n_t, noise, z_out, m, n, d, v,
                                               k, alpha, beta, beta_bar, scale, stream);
}

cudaError_t check_shape(int m, int d, int v, int k) {
  if (k <= 0 || k > 8192 || m > 65535 || d < 0 || v < 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool kBatched>
cudaError_t run(const int32_t* docs, const int32_t* words, const int32_t* z,
                const float* weights, const void* n_dt, const void* n_wt,
                const void* n_t, int counts_int, const float* noise,
                int32_t* z_out, int m, int n, int d, int v, int k, float alpha,
                float beta, float beta_bar, float scale, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (check_shape(m, d, v, k) != cudaSuccess) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return counts_int
             ? dispatch_width<int32_t, int32_t, 0, kBatched>(
                   docs, words, z, weights, n_dt, n_wt, nullptr, n_t, noise, z_out,
                   m, n, d, v, k, alpha, beta, beta_bar, scale, s)
             : dispatch_width<float, float, 0, kBatched>(
                   docs, words, z, weights, n_dt, n_wt, nullptr, n_t, noise, z_out,
                   m, n, d, v, k, alpha, beta, beta_bar, scale, s);
}

template <int kCodeBits>
cudaError_t run_quant(const int32_t* docs, const int32_t* words, const int32_t* z,
                      const float* weights, const void* n_dt, const uint8_t* codes,
                      const float* w_scales, const void* n_t, int counts_int,
                      const float* noise, int32_t* z_out, int n, int k, float alpha,
                      float beta, float beta_bar, float scale, cudaStream_t s) {
  return counts_int
             ? dispatch_width<int32_t, uint8_t, kCodeBits, false>(
                   docs, words, z, weights, n_dt, codes, w_scales, n_t, noise, z_out,
                   1, n, 0, 0, k, alpha, beta, beta_bar, scale, s)
             : dispatch_width<float, uint8_t, kCodeBits, false>(
                   docs, words, z, weights, n_dt, codes, w_scales, n_t, noise, z_out,
                   1, n, 0, 0, k, alpha, beta, beta_bar, scale, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes). `counts_int` selects int32
// fixed-point tables (scaled by `scale` in-kernel) over float32 tables.
// Each launches on `stream`, allocates nothing, returns cudaGetLastError().
//
// One model: ids/z/weights (n,), n_dt (D, k), n_wt (V, k), n_t (k,),
// noise (n, k).
extern "C" int lda_gibbs_resample(const int32_t* docs, const int32_t* words,
                                  const int32_t* z, const float* weights,
                                  const void* n_dt, const void* n_wt,
                                  const void* n_t, int counts_int,
                                  const float* noise, int32_t* z_out, int n,
                                  int k, float alpha, float beta,
                                  float beta_bar, float scale, void* stream) {
  return static_cast<int>(run<false>(docs, words, z, weights, n_dt, n_wt, n_t,
                              counts_int, noise, z_out, 1, n, 0, 0, k, alpha,
                              beta, beta_bar, scale, stream));
}

// M stacked models: ids/z/weights (m, n), n_dt (m, d, k), n_wt (m, v, k),
// n_t (m, k), noise (m, n, k), all row-major.
extern "C" int lda_gibbs_resample_batched(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
    int counts_int, const float* noise, int32_t* z_out, int m, int n, int d,
    int v, int k, float alpha, float beta, float beta_bar, float scale,
    void* stream) {
  return static_cast<int>(run<true>(docs, words, z, weights, n_dt, n_wt, n_t,
                              counts_int, noise, z_out, m, n, d, v, k, alpha,
                              beta, beta_bar, scale, stream));
}

// One model with a packed word table: ids/z/weights (n,), n_dt (D, k) and
// n_t (k,) stored as above (`counts_int`, `scale`), `codes` (V, k) uint8 for
// bits = 8 or (V, ceil(k/2)) nibble-packed for bits = 4, `w_scales` (V,)
// float32, noise (n, k).
extern "C" int lda_gibbs_resample_quant(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const uint8_t* codes,
    const float* w_scales, const void* n_t, int counts_int, int bits,
    const float* noise, int32_t* z_out, int n, int k, float alpha, float beta,
    float beta_bar, float scale, void* stream) {
  if (n <= 0) return 0;
  if (check_shape(1, 0, 0, k) != cudaSuccess || (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bits == 8 ? run_quant<8>(docs, words, z, weights, n_dt, codes, w_scales, n_t,
                               counts_int, noise, z_out, n, k, alpha, beta, beta_bar,
                               scale, s)
                : run_quant<4>(docs, words, z, weights, n_dt, codes, w_scales, n_t,
                               counts_int, noise, z_out, n, k, alpha, beta, beta_bar,
                               scale, s));
}
