// Fused collapsed-Gibbs score + Gumbel-max resample for Hopper (sm_90a).
//
// Replaces the TPU kernel `gibbs_resample_blocked`
// (src/repro/kernels/lda_gibbs/kernel.py, `_gibbs_kernel` / `_resample_tile`).
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

template <typename T, int G>
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
                      int n, int k, float alpha, float beta, float beta_bar,
                      float scale) {
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
    float wi = 0.0f;
    if (valid) {
      zi = z[i];
      wi = weights[i];
      const T* row_d = n_dt + static_cast<long long>(docs[i]) * k;
      const T* row_w = n_wt + static_cast<long long>(words[i]) * k;
      const float* g = noise + i * k;
      for (int t = sub; t < k; t += G) {
        const float own = (t == zi) ? wi : 0.0f;
        const float rd = fmaxf(static_cast<float>(row_d[t]) * scale - own, 0.0f);
        const float rw = fmaxf(static_cast<float>(row_w[t]) * scale - own, 0.0f);
        const float tt = fmaxf(tot[t] - own, 1e-9f);
        const float logit = (logf(rd + alpha) + logf(rw + beta)) - logf(tt + beta_bar);
        const float v = logit + g[t];
        if (v > best) {  // strict: the first maximum of this lane's topics
          best = v;
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

template <typename T, int G>
cudaError_t launch(const int32_t* docs, const int32_t* words, const int32_t* z,
                   const float* weights, const void* n_dt, const void* n_wt,
                   const void* n_t, const float* noise, int32_t* z_out, int n,
                   int k, float alpha, float beta, float beta_bar, float scale,
                   cudaStream_t stream) {
  constexpr int kTokensPerBlock = (kThreads / 32) * (32 / G);
  long long blocks = (static_cast<long long>(n) + kTokensPerBlock - 1) / kTokensPerBlock;
  // Enough blocks to fill the card several times over; the grid-stride loop
  // covers the rest and amortizes the n_t staging.
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  gibbs_resample_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      docs, words, z, weights, static_cast<const T*>(n_dt),
      static_cast<const T*>(n_wt), static_cast<const T*>(n_t), noise, z_out, n,
      k, alpha, beta, beta_bar, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(const int32_t* docs, const int32_t* words,
                           const int32_t* z, const float* weights,
                           const void* n_dt, const void* n_wt, const void* n_t,
                           const float* noise, int32_t* z_out, int n, int k,
                           float alpha, float beta, float beta_bar, float scale,
                           cudaStream_t stream) {
  if (k <= 8)
    return launch<T, 8>(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                        n, k, alpha, beta, beta_bar, scale, stream);
  if (k <= 16)
    return launch<T, 16>(docs, words, z, weights, n_dt, n_wt, n_t, noise,
                         z_out, n, k, alpha, beta, beta_bar, scale, stream);
  return launch<T, 32>(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out,
                       n, k, alpha, beta, beta_bar, scale, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `counts_int` selects int32
// fixed-point tables (scaled by `scale` in-kernel) over float32 tables.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lda_gibbs_resample(const int32_t* docs, const int32_t* words,
                                  const int32_t* z, const float* weights,
                                  const void* n_dt, const void* n_wt,
                                  const void* n_t, int counts_int,
                                  const float* noise, int32_t* z_out, int n,
                                  int k, float alpha, float beta,
                                  float beta_bar, float scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0 || k > 8192) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      counts_int
          ? dispatch_width<int32_t>(docs, words, z, weights, n_dt, n_wt, n_t,
                                    noise, z_out, n, k, alpha, beta, beta_bar,
                                    scale, s)
          : dispatch_width<float>(docs, words, z, weights, n_dt, n_wt, n_t,
                                  noise, z_out, n, k, alpha, beta, beta_bar,
                                  scale, s);
  return static_cast<int>(err);
}
