// AliasLDA stale-proposal + Metropolis-Hastings resample for Hopper (sm_90a).
//
// Replaces the TPU kernels `alias_mh_blocked` (entry `alias_mh_resample`)
// and `alias_mh_blocked_batched` (entry `alias_mh_resample_batched`) in
// src/repro/kernels/alias_mh/kernel.py (`_alias_mh_kernel`,
// `_alias_mh_kernel_batched`, `_mh_tile`).
// For every token i with doc d, word w, sweep-start topic z0 and weight wt,
// over S rounds r (even rounds: word tables, odd rounds: doc tables):
//
//   prop   = j_r            if u_prop_r < thresh[row, j_r]
//          = alias[row, j_r] otherwise                 (row = w or d)
//   log_a  = (log p(prop) + log q(z)) - (log p(z) + log q(prop))
//   z      = prop           if log(u_acc_r) < log_a
//
// with the stale, self-excluded target (own = wt at z0, else 0)
//
//   log p(t) = (log(max(n_dt[d,t]*s - own, 0) + alpha)
//            +  log(max(n_wt[w,t]*s - own, 0) + beta))
//            -  log(max(n_t[t]*s   - own, 1e-9) + beta_bar)
//
// and the stale proposal density log q(t) = log(n_wt[w,t]*s + beta) on word
// rounds, log(n_dt[d,t]*s + alpha) on doc rounds. s = 2^-(w_bits+1) for int32
// fixed-point counts and 1 for float32 counts; tokens of weight <= 0 keep z0.
//
// What bounds it: bytes, and the latency of dependent gathers. Per token it
// reads 16 B of ids/assignment/weight and 12 B of draws a round, and writes
// 4 B; each round is a chain draw -> table entry -> two count lookups per
// candidate topic -> accept, about 10 scalar loads and 7 logs, far below the
// card's float rate. The TPU kernel received six gathered (N, K) row tensors
// and picked one lane per lookup with a masked reduction over K (it has no
// lane gather); here each lookup is one scalar load by id from the full
// tables, so a round costs O(1) per token whatever K is, which is the point
// of AliasLDA. The count and alias tables are small (D*K, V*K) and stay in
// L2; device-memory traffic is the ids, the draws and the output.
//
// Shape: one thread per token in a grid-stride loop; S is a runtime loop and
// its parity picks the word or doc tables. No padding: the ragged edge is the
// loop bound.
//
// Batched: M stacked models of the same K and hyperparameters, each with N
// (padded) token slots, D (padded) doc rows and V word rows. Model m's count
// tables start at n_dt + m*D*K, n_wt + m*V*K, n_t + m*K, its alias tables
// likewise, its tokens at m*N and its (S, N) draws at m*S*N (64-bit offsets
// throughout). The grid is (blocks per model, M): blockIdx.y picks the model
// and the block strides over that model's N slots. The single-model entry is
// the same kernel with M = 1. Weight-0 tokens (the stack's padding) keep z.
//
// Build without fast math and with -fmad=false: `logf` (not `__logf`) and the
// reference's operation order keep log_a within an ulp of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
alias_mh_kernel(const int32_t* __restrict__ docs,
                const int32_t* __restrict__ words,
                const int32_t* __restrict__ z,
                const float* __restrict__ weights,
                const T* __restrict__ n_dt,
                const T* __restrict__ n_wt,
                const T* __restrict__ n_t,
                const float* __restrict__ thresh_w,
                const int32_t* __restrict__ alias_w,
                const float* __restrict__ thresh_d,
                const int32_t* __restrict__ alias_d,
                const int32_t* __restrict__ j_prop,
                const float* __restrict__ u_prop,
                const float* __restrict__ u_acc,
                int32_t* __restrict__ z_out,
                int n, int d, int v, int k, int s, float alpha, float beta,
                float beta_bar, float scale) {
  // This block's model: its tables, tokens and draws.
  const long long model = blockIdx.y;
  const long long tok0 = model * n;
  docs += tok0;
  words += tok0;
  z += tok0;
  weights += tok0;
  z_out += tok0;
  j_prop += tok0 * s;
  u_prop += tok0 * s;
  u_acc += tok0 * s;
  n_dt += model * d * k;
  thresh_d += model * d * k;
  alias_d += model * d * k;
  n_wt += model * v * k;
  thresh_w += model * v * k;
  alias_w += model * v * k;
  n_t += model * k;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int z0 = z[i];
    const float wt = weights[i];
    if (!(wt > 0.0f)) {  // frozen / padding token
      z_out[i] = z0;
      continue;
    }
    const long long d_off = static_cast<long long>(docs[i]) * k;
    const long long w_off = static_cast<long long>(words[i]) * k;
    const T* row_d = n_dt + d_off;
    const T* row_w = n_wt + w_off;

    auto log_p = [&](int t) {
      const float own = (t == z0) ? wt : 0.0f;
      const float ndt = fmaxf(static_cast<float>(row_d[t]) * scale - own, 0.0f);
      const float nwt = fmaxf(static_cast<float>(row_w[t]) * scale - own, 0.0f);
      const float nt = fmaxf(static_cast<float>(n_t[t]) * scale - own, 1e-9f);
      return (logf(ndt + alpha) + logf(nwt + beta)) - logf(nt + beta_bar);
    };

    int zc = z0;
    for (int r = 0; r < s; ++r) {
      const long long ri = static_cast<long long>(r) * n + i;
      const int j = j_prop[ri];
      const bool word_round = (r & 1) == 0;
      const long long off = (word_round ? w_off : d_off) + j;
      const float th = word_round ? thresh_w[off] : thresh_d[off];
      const int prop = (u_prop[ri] < th) ? j : (word_round ? alias_w[off] : alias_d[off]);
      float lq_cur, lq_prop;
      if (word_round) {
        lq_cur = logf(static_cast<float>(row_w[zc]) * scale + beta);
        lq_prop = logf(static_cast<float>(row_w[prop]) * scale + beta);
      } else {
        lq_cur = logf(static_cast<float>(row_d[zc]) * scale + alpha);
        lq_prop = logf(static_cast<float>(row_d[prop]) * scale + alpha);
      }
      const float log_a = (log_p(prop) + lq_cur) - (log_p(zc) + lq_prop);
      if (logf(u_acc[ri]) < log_a) zc = prop;
    }
    z_out[i] = zc;
  }
}

template <typename T>
cudaError_t launch(const int32_t* docs, const int32_t* words, const int32_t* z,
                   const float* weights, const void* n_dt, const void* n_wt,
                   const void* n_t, const float* thresh_w,
                   const int32_t* alias_w, const float* thresh_d,
                   const int32_t* alias_d, const int32_t* j_prop,
                   const float* u_prop, const float* u_acc, int32_t* z_out,
                   int m, int n, int d, int v, int k, int s, float alpha,
                   float beta, float beta_bar, float scale,
                   cudaStream_t stream) {
  long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  // Enough blocks in all to fill the card several times over; the
  // grid-stride loop covers the rest of each model.
  const long long cap = (132 * 16) / m;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(m));
  alias_mh_kernel<T><<<grid, kThreads, 0, stream>>>(
      docs, words, z, weights, static_cast<const T*>(n_dt),
      static_cast<const T*>(n_wt), static_cast<const T*>(n_t), thresh_w,
      alias_w, thresh_d, alias_d, j_prop, u_prop, u_acc, z_out, n, d, v, k, s,
      alpha, beta, beta_bar, scale);
  return cudaGetLastError();
}

cudaError_t run(const int32_t* docs, const int32_t* words, const int32_t* z,
                const float* weights, const void* n_dt, const void* n_wt,
                const void* n_t, int counts_int, const float* thresh_w,
                const int32_t* alias_w, const float* thresh_d,
                const int32_t* alias_d, const int32_t* j_prop,
                const float* u_prop, const float* u_acc, int32_t* z_out, int m,
                int n, int d, int v, int k, int s, float alpha, float beta,
                float beta_bar, float scale, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || s <= 0 || m > 65535 || d < 0 || v < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return counts_int
             ? launch<int32_t>(docs, words, z, weights, n_dt, n_wt, n_t,
                               thresh_w, alias_w, thresh_d, alias_d, j_prop,
                               u_prop, u_acc, z_out, m, n, d, v, k, s, alpha,
                               beta, beta_bar, scale, st)
             : launch<float>(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w,
                             alias_w, thresh_d, alias_d, j_prop, u_prop, u_acc,
                             z_out, m, n, d, v, k, s, alpha, beta, beta_bar,
                             scale, st);
}

}  // namespace

// Plain C entry points (loaded with ctypes). `counts_int` selects int32
// fixed-point count tables (scaled by `scale` in-kernel) over float32 ones.
// Each launches on `stream`, allocates nothing, returns cudaGetLastError().
//
// One model: ids/z/weights (n,), count and alias tables (D, k) / (V, k),
// n_t (k,), draws (s, n), all row-major.
extern "C" int alias_mh_resample(const int32_t* docs, const int32_t* words,
                                 const int32_t* z, const float* weights,
                                 const void* n_dt, const void* n_wt,
                                 const void* n_t, int counts_int,
                                 const float* thresh_w, const int32_t* alias_w,
                                 const float* thresh_d, const int32_t* alias_d,
                                 const int32_t* j_prop, const float* u_prop,
                                 const float* u_acc, int32_t* z_out, int n,
                                 int k, int s, float alpha, float beta,
                                 float beta_bar, float scale, void* stream) {
  return static_cast<int>(run(docs, words, z, weights, n_dt, n_wt, n_t,
                              counts_int, thresh_w, alias_w, thresh_d, alias_d,
                              j_prop, u_prop, u_acc, z_out, 1, n, 0, 0, k, s,
                              alpha, beta, beta_bar, scale, stream));
}

// M stacked models: ids/z/weights (m, n), count and alias tables
// (m, d, k) / (m, v, k), n_t (m, k), draws (m, s, n), all row-major.
extern "C" int alias_mh_resample_batched(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
    int counts_int, const float* thresh_w, const int32_t* alias_w,
    const float* thresh_d, const int32_t* alias_d, const int32_t* j_prop,
    const float* u_prop, const float* u_acc, int32_t* z_out, int m, int n,
    int d, int v, int k, int s, float alpha, float beta, float beta_bar,
    float scale, void* stream) {
  return static_cast<int>(run(docs, words, z, weights, n_dt, n_wt, n_t,
                              counts_int, thresh_w, alias_w, thresh_d, alias_d,
                              j_prop, u_prop, u_acc, z_out, m, n, d, v, k, s,
                              alpha, beta, beta_bar, scale, stream));
}
