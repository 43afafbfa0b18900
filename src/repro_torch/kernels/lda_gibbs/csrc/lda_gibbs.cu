// Fused collapsed-Gibbs score + Gumbel-max resample for Hopper (sm_90a).
//
// Replaces the TPU kernels `gibbs_resample_blocked` (entry
// `lda_gibbs_resample`) and `gibbs_resample_blocked_batched` (entry
// `lda_gibbs_resample_batched`) in src/repro/kernels/lda_gibbs/kernel.py
// (`_gibbs_kernel`, `_gibbs_kernel_batched`, `_resample_tile`).
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

template <typename T, int G, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gibbs_resample_kernel(const int32_t* __restrict__ docs,
                      const int32_t* __restrict__ words,
                      const int32_t* __restrict__ z,
                      const float* __restrict__ weights,
                      const T* __restrict__ n_dt,
                      const T* __restrict__ n_wt,
                      const T* __restrict__ n_t,
                      const float* __restrict__ noise,
                      int32_t* __restrict__ z_out,
                      int n, int d, int v, int k, float alpha, float beta,
                      float beta_bar, float scale) {
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
    n_wt += model * v * k;
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
      const T* row_w = n_wt + static_cast<long long>(wd) * k;
      const float* g = noise + i * k;
      for (int t = sub; t < k; t += G) {
        const float own = (t == zi) ? wi : 0.0f;
        const float rd = fmaxf(static_cast<float>(row_d[t]) * scale - own, 0.0f);
        const float rw = fmaxf(static_cast<float>(row_w[t]) * scale - own, 0.0f);
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

template <typename T, int G, bool kBatched>
cudaError_t launch(const int32_t* docs, const int32_t* words, const int32_t* z,
                   const float* weights, const void* n_dt, const void* n_wt,
                   const void* n_t, const float* noise, int32_t* z_out, int m,
                   int n, int d, int v, int k, float alpha, float beta,
                   float beta_bar, float scale, cudaStream_t stream) {
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
  gibbs_resample_kernel<T, G, kBatched><<<grid, kThreads, smem, stream>>>(
      docs, words, z, weights, static_cast<const T*>(n_dt),
      static_cast<const T*>(n_wt), static_cast<const T*>(n_t), noise, z_out, n,
      d, v, k, alpha, beta, beta_bar, scale);
  return cudaGetLastError();
}

template <typename T, bool kBatched>
cudaError_t dispatch_width(const int32_t* docs, const int32_t* words,
                           const int32_t* z, const float* weights,
                           const void* n_dt, const void* n_wt, const void* n_t,
                           const float* noise, int32_t* z_out, int m, int n,
                           int d, int v, int k, float alpha, float beta,
                           float beta_bar, float scale, cudaStream_t stream) {
  if (k <= 8)
    return launch<T, 8, kBatched>(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                        m, n, d, v, k, alpha, beta, beta_bar, scale, stream);
  if (k <= 16)
    return launch<T, 16, kBatched>(docs, words, z, weights, n_dt, n_wt, n_t, noise,
                         z_out, m, n, d, v, k, alpha, beta, beta_bar, scale,
                         stream);
  return launch<T, 32, kBatched>(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                       m, n, d, v, k, alpha, beta, beta_bar, scale, stream);
}

template <bool kBatched>
cudaError_t run(const int32_t* docs, const int32_t* words, const int32_t* z,
                const float* weights, const void* n_dt, const void* n_wt,
                const void* n_t, int counts_int, const float* noise,
                int32_t* z_out, int m, int n, int d, int v, int k, float alpha,
                float beta, float beta_bar, float scale, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || k > 8192 || m > 65535 || d < 0 || v < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return counts_int
             ? dispatch_width<int32_t, kBatched>(docs, words, z, weights, n_dt, n_wt, n_t,
                                       noise, z_out, m, n, d, v, k, alpha, beta,
                                       beta_bar, scale, s)
             : dispatch_width<float, kBatched>(docs, words, z, weights, n_dt, n_wt, n_t,
                                     noise, z_out, m, n, d, v, k, alpha, beta,
                                     beta_bar, scale, s);
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
