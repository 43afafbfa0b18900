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
// Draws. Both entries take (j_r, u_prop_r, u_acc_r) in one of two modes:
//   injected  (S, N) / (M, S, N) inputs, as the TPU kernel takes them (the
//             parity tests and the reference replays use it);
//   Philox    drawn here, one Philox4x32-10 call a token and round: counter
//             (r, i, offset_lo, offset_hi), key (seed_lo, seed_hi ^
//             0x414C4D48), i the token's index within its own model; word 0
//             gives j = umulhi(x0, K), words 1 and 2 give u = (x >> 8) *
//             2^-24. The tag differs from lda_gibbs.cu's 0x4C444147, so the
//             two kernels' streams of one generator never coincide; (seed,
//             offset) come from the sweep's generator, one pair a model in
//             the batched entry.
//
// Carried terms. z0 is fixed for the sweep, so log p(t) for t != z0 is
// (ld[d,t] + lw[w,t]) - lt[t] with ld = log(max(n_dt*s, 0) + alpha), lw =
// log(max(n_wt*s, 0) + beta), lt = log(max(n_t*s, 1e-9) + beta_bar): the
// terms above with own = 0 (x - 0 is x). The stored counts are never
// negative (sums of non-negative weights; a packed sweep's fake-quantized
// word table is codes >= 0 times scales >= 0), so max(x*s, 0) is x*s and
// log q_w(t) = lw[w,t], log q_d(t) = ld[d,t]. A token computes log p(z0)
// once (three logs, self-excluded) and carries log p, lw and ld of its
// current topic in registers across the rounds; a round is then a chain
// draw -> thresh/alias entry -> three entries of the candidate -> compare
// against one log(u_acc), in the reference's operation order.
//
// Two bodies. Direct: the candidate's three logs from its counts (3 logs a
// round). Tables: a first kernel writes ld, lw and lt once a call (M*(D+V+1)
// *K logs into scratch the wrapper allocates) and a round reads them (no log
// but log(u_acc)). The tables take the same logf of the same floats, so both
// bodies give the same bits. They pay when a model's rounds outnumber its
// table entries and the call has enough tokens to hide the extra launch
// (`use_tables`); K never enters a round's cost: every lookup is one load by
// id, so a token's work is O(1) in K, AliasLDA's point.
//
// What bounds it: by bytes, the injected mode's draws (per token 16 B of
// ids, 12 B of draws a round, 4 B out; the Philox mode reads no draws but
// does 40 integer multiplies a round). In practice the gathers do: the
// count, alias and log tables are small and stay in L2, but tokens come in
// document order, so the ten or so loads a token makes by word id go to as
// many lines as a warp has lanes, and both modes take about the same time.
//
// Shape: a thread a token, the grid from N (blockIdx.x) and M (blockIdx.y),
// no grid-stride loop. With S = 2 or 4 the rounds unroll and a thread issues
// all its draws' loads (or Philox calls) ahead of the chain. A weight-0 slot
// (the stack's padding) writes its z back and gathers nothing.
//
// Build without fast math and with -fmad=false: `logf` (not `__logf`) and the
// reference's operation order keep log_a within an ulp of the plain version.

#include <cuda_runtime.h>
#include <curand_kernel.h>  // curand_Philox4x32_10, for the test entry only
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kPhiloxKeyTag = 0x414C4D48u;
constexpr float kTwoPow24Inv = 5.9604644775390625e-8f;  // 2^-24
// The tables take a launch of their own: below this many tokens a call is
// latency bound and the direct body's three logs a round cost less.
constexpr long long kTableMinTokens = 1 << 15;

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

// Everything a launch reads and writes. Tables are (M, D, K) / (M, V, K) /
// (M, K), tokens (M, N), injected draws (M, S, N), all row-major; M = 1 for
// the single-model entry.
template <typename T>
struct Args {
  const int32_t* docs;
  const int32_t* words;
  const int32_t* z;
  const float* weights;
  const T* n_dt;
  const T* n_wt;
  const T* n_t;
  const float* thresh_w;
  const int32_t* alias_w;
  const float* thresh_d;
  const int32_t* alias_d;
  const int32_t* j_prop;  // injected draws, or null in the Philox mode
  const float* u_prop;
  const float* u_acc;
  const unsigned long long* keys;  // batched Philox keys (M, 2), or null
  unsigned long long seed, offset;  // the single-model Philox key
  const float* ld;  // log tables (M, D, K), (M, V, K), (M, K), or null
  const float* lw;
  const float* lt;
  int32_t* z_out;
  int n, d, v, k, s;
  float alpha, beta, beta_bar, scale;
};

// One call's log tables: ld over M*D*K, lw over M*V*K, lt over M*K, the
// terms of log p with own = 0 (and of log q), bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
log_tables_kernel(const T* __restrict__ n_dt, const T* __restrict__ n_wt,
                  const T* __restrict__ n_t, long long dk, long long vk, long long kk,
                  float alpha, float beta, float beta_bar, float scale,
                  float* __restrict__ ld, float* __restrict__ lw, float* __restrict__ lt) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < dk + vk + kk; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (j < dk) {
      ld[j] = logf(fmaxf(static_cast<float>(n_dt[j]) * scale, 0.0f) + alpha);
    } else if (j < dk + vk) {
      lw[j - dk] = logf(fmaxf(static_cast<float>(n_wt[j - dk]) * scale, 0.0f) + beta);
    } else {
      lt[j - dk - vk] = logf(fmaxf(static_cast<float>(n_t[j - dk - vk]) * scale, 1e-9f) +
                             beta_bar);
    }
  }
}

// One round's draws.
struct Draw {
  int j;
  float up, ua;
};

__device__ __forceinline__ Draw philox_draw(int r, unsigned i, uint2 key, unsigned off_lo,
                                            unsigned off_hi, int k) {
  const uint4 x = philox4x32_10(make_uint4(static_cast<unsigned>(r), i, off_lo, off_hi), key);
  return {static_cast<int>(__umulhi(x.x, static_cast<unsigned>(k))),
          static_cast<float>(x.y >> 8) * kTwoPow24Inv,
          static_cast<float>(x.z >> 8) * kTwoPow24Inv};
}

// kTables: read the log tables (else the direct body); kPhilox: draw in the
// kernel (else read the injected draws); kS: the round count when 2 or 4
// (unrolled), 0 for any other (a loop over a.s).
template <typename T, bool kTables, bool kPhilox, int kS>
__global__ void __launch_bounds__(kThreads) alias_mh_kernel(const Args<T> a) {
  const long long m = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long tok = m * a.n + i;
  // Ids: neighbouring threads, neighbouring tokens; all four loads in
  // flight before the branch.
  const int z0 = a.z[tok];
  const float wt = a.weights[tok];
  const int di = a.docs[tok];
  const int wi = a.words[tok];
  if (!(wt > 0.0f)) {  // frozen / padding token
    a.z_out[tok] = z0;
    return;
  }
  const int k = a.k;
  const int s = kS > 0 ? kS : a.s;
  const long long d_off = (m * a.d + di) * k;  // the token's rows in (M, D, K), (M, V, K)
  const long long w_off = (m * a.v + wi) * k;
  const long long t_off = m * k;

  uint2 key = make_uint2(0u, 0u);
  unsigned off_lo = 0u, off_hi = 0u;
  if constexpr (kPhilox) {
    const unsigned long long seed = a.keys ? a.keys[2 * m] : a.seed;
    const unsigned long long offset = a.keys ? a.keys[2 * m + 1] : a.offset;
    key = make_uint2(static_cast<unsigned>(seed),
                     static_cast<unsigned>(seed >> 32) ^ kPhiloxKeyTag);
    off_lo = static_cast<unsigned>(offset);
    off_hi = static_cast<unsigned>(offset >> 32);
  }
  const long long draw0 = m * s * static_cast<long long>(a.n) + i;  // round 0's draw
  auto draw = [&](int r) -> Draw {
    if constexpr (kPhilox) {
      return philox_draw(r, static_cast<unsigned>(i), key, off_lo, off_hi, k);
    } else {
      const long long ri = draw0 + static_cast<long long>(r) * a.n;
      return {a.j_prop[ri], a.u_prop[ri], a.u_acc[ri]};
    }
  };

  // The candidate t's unexcluded terms ld, lw, lt (see the header).
  auto terms = [&](int t, float& ldt, float& lwt, float& ltt) {
    if constexpr (kTables) {
      ldt = a.ld[d_off + t];
      lwt = a.lw[w_off + t];
      ltt = a.lt[t_off + t];
    } else {
      ldt = logf(fmaxf(static_cast<float>(a.n_dt[d_off + t]) * a.scale, 0.0f) + a.alpha);
      lwt = logf(fmaxf(static_cast<float>(a.n_wt[w_off + t]) * a.scale, 0.0f) + a.beta);
      ltt = logf(fmaxf(static_cast<float>(a.n_t[t_off + t]) * a.scale, 1e-9f) + a.beta_bar);
    }
  };

  // log p(z0), self-excluded, once; and z0's unexcluded ld and lw (its log q).
  const float nd0 = static_cast<float>(a.n_dt[d_off + z0]) * a.scale;
  const float nw0 = static_cast<float>(a.n_wt[w_off + z0]) * a.scale;
  const float nt0 = static_cast<float>(a.n_t[t_off + z0]) * a.scale;
  const float lp0 = (logf(fmaxf(nd0 - wt, 0.0f) + a.alpha) + logf(fmaxf(nw0 - wt, 0.0f) + a.beta)) -
                    logf(fmaxf(nt0 - wt, 1e-9f) + a.beta_bar);
  float lq_d, lq_w, unused;
  terms(z0, lq_d, lq_w, unused);

  int zc = z0;
  float lp = lp0;
  auto round = [&](int r, const Draw& dr) {
    const bool word = (r & 1) == 0;
    const long long off = (word ? w_off : d_off) + dr.j;
    const float th = word ? a.thresh_w[off] : a.thresh_d[off];
    const int al = word ? a.alias_w[off] : a.alias_d[off];
    const int prop = (dr.up < th) ? dr.j : al;
    float ldp, lwp, ltp;
    terms(prop, ldp, lwp, ltp);
    const float lp_prop = (prop == z0) ? lp0 : (ldp + lwp) - ltp;
    const float log_a = (lp_prop + (word ? lq_w : lq_d)) - (lp + (word ? lwp : ldp));
    if (logf(dr.ua) < log_a) {
      zc = prop;
      lp = lp_prop;
      lq_d = ldp;
      lq_w = lwp;
    }
  };
  if constexpr (kS > 0) {
    Draw dr[kS];  // every draw ahead of the chain
#pragma unroll
    for (int r = 0; r < kS; ++r) dr[r] = draw(r);
#pragma unroll
    for (int r = 0; r < kS; ++r) round(r, dr[r]);
  } else {
    for (int r = 0; r < s; ++r) round(r, draw(r));
  }
  a.z_out[tok] = zc;
}

bool use_tables(long long m, long long n, long long d, long long v, long long k, long long s) {
  return m * n >= kTableMinTokens && n * s >= (d + v + 1) * k;
}

// body: -1 picks by `use_tables`, 0 forces the direct body, 1 the tables.
bool tables_for(int body, int m, int n, int d, int v, int k, int s) {
  return body < 0 ? use_tables(m, n, d, v, k, s) : body == 1;
}

long long workspace_floats(int m, int n, int d, int v, int k, int s, int body) {
  if (!tables_for(body, m, n, d, v, k, s)) return 0;
  return static_cast<long long>(m) * (static_cast<long long>(d) + v + 1) * k;
}

template <typename T, bool kTables, bool kPhilox>
cudaError_t launch_body(const Args<T>& a, int m, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(m));
  switch (a.s) {
    case 2:
      alias_mh_kernel<T, kTables, kPhilox, 2><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      alias_mh_kernel<T, kTables, kPhilox, 4><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      alias_mh_kernel<T, kTables, kPhilox, 0><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Args<T> a, int m, bool tables, float* work, cudaStream_t stream) {
  if (tables) {
    const long long dk = static_cast<long long>(m) * a.d * a.k;
    const long long vk = static_cast<long long>(m) * a.v * a.k;
    const long long kk = static_cast<long long>(m) * a.k;
    long long blocks = (dk + vk + kk + kThreads - 1) / kThreads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    a.ld = work;
    a.lw = work + dk;
    a.lt = work + dk + vk;
    log_tables_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        a.n_dt, a.n_wt, a.n_t, dk, vk, kk, a.alpha, a.beta, a.beta_bar, a.scale, work,
        work + dk, work + dk + vk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool philox = a.j_prop == nullptr;
  if (tables) return philox ? launch_body<T, true, true>(a, m, stream)
                            : launch_body<T, true, false>(a, m, stream);
  return philox ? launch_body<T, false, true>(a, m, stream)
                : launch_body<T, false, false>(a, m, stream);
}

template <typename T>
Args<T> make_args(const int32_t* docs, const int32_t* words, const int32_t* z,
                  const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
                  const float* thresh_w, const int32_t* alias_w, const float* thresh_d,
                  const int32_t* alias_d, const int32_t* j_prop, const float* u_prop,
                  const float* u_acc, const unsigned long long* keys, unsigned long long seed,
                  unsigned long long offset, int32_t* z_out, int n, int d, int v, int k, int s,
                  float alpha, float beta, float beta_bar, float scale) {
  Args<T> a;
  a.docs = docs;
  a.words = words;
  a.z = z;
  a.weights = weights;
  a.n_dt = static_cast<const T*>(n_dt);
  a.n_wt = static_cast<const T*>(n_wt);
  a.n_t = static_cast<const T*>(n_t);
  a.thresh_w = thresh_w;
  a.alias_w = alias_w;
  a.thresh_d = thresh_d;
  a.alias_d = alias_d;
  a.j_prop = j_prop;
  a.u_prop = u_prop;
  a.u_acc = u_acc;
  a.keys = keys;
  a.seed = seed;
  a.offset = offset;
  a.ld = a.lw = a.lt = nullptr;
  a.z_out = z_out;
  a.n = n;
  a.d = d;
  a.v = v;
  a.k = k;
  a.s = s;
  a.alpha = alpha;
  a.beta = beta;
  a.beta_bar = beta_bar;
  a.scale = scale;
  return a;
}

cudaError_t run(const int32_t* docs, const int32_t* words, const int32_t* z,
                const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
                int counts_int, const float* thresh_w, const int32_t* alias_w,
                const float* thresh_d, const int32_t* alias_d, const int32_t* j_prop,
                const float* u_prop, const float* u_acc, const unsigned long long* keys,
                unsigned long long seed, unsigned long long offset, float* work, int body,
                int32_t* z_out, int m, int n, int d, int v, int k, int s, float alpha,
                float beta, float beta_bar, float scale, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || s <= 0 || m > 65535 || d <= 0 || v <= 0) return cudaErrorInvalidValue;
  // Injected draws come as all three or none.
  if ((j_prop == nullptr) != (u_prop == nullptr) || (j_prop == nullptr) != (u_acc == nullptr))
    return cudaErrorInvalidValue;
  const bool tables = tables_for(body, m, n, d, v, k, s);
  if (tables && work == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ALIAS_MH_RUN(T)                                                                     \
  launch<T>(make_args<T>(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w,       \
                         thresh_d, alias_d, j_prop, u_prop, u_acc, keys, seed, offset, z_out, \
                         n, d, v, k, s, alpha, beta, beta_bar, scale),                      \
            m, tables, work, st)
  return counts_int ? ALIAS_MH_RUN(int32_t) : ALIAS_MH_RUN(float);
#undef ALIAS_MH_RUN
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
// fixed-point count tables (scaled by `scale` in-kernel) over float32 ones.
// Draws: j_prop/u_prop/u_acc, or all three NULL for the Philox mode. `body`:
// -1 picks the body by shape, 0 forces the direct body, 1 the log tables.
// `work` is the scratch `alias_mh_workspace` sizes (NULL when that is 0).
// Each launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" long long alias_mh_workspace(int m, int n, int d, int v, int k, int s, int body) {
  return workspace_floats(m, n, d, v, k, s, body);
}

// One model: ids/z/weights (n,), count and alias tables (d, k) / (v, k),
// n_t (k,), injected draws (s, n) or Philox draws under (seed, offset).
extern "C" int alias_mh_resample(const int32_t* docs, const int32_t* words,
                                 const int32_t* z, const float* weights,
                                 const void* n_dt, const void* n_wt,
                                 const void* n_t, int counts_int,
                                 const float* thresh_w, const int32_t* alias_w,
                                 const float* thresh_d, const int32_t* alias_d,
                                 const int32_t* j_prop, const float* u_prop,
                                 const float* u_acc, unsigned long long seed,
                                 unsigned long long offset, float* work, int body,
                                 int32_t* z_out, int n, int d, int v, int k, int s,
                                 float alpha, float beta, float beta_bar, float scale,
                                 void* stream) {
  return static_cast<int>(run(docs, words, z, weights, n_dt, n_wt, n_t, counts_int, thresh_w,
                              alias_w, thresh_d, alias_d, j_prop, u_prop, u_acc, nullptr, seed,
                              offset, work, body, z_out, 1, n, d, v, k, s, alpha, beta,
                              beta_bar, scale, stream));
}

// M stacked models: ids/z/weights (m, n), count and alias tables
// (m, d, k) / (m, v, k), n_t (m, k), injected draws (m, s, n) or Philox
// draws under `keys`, (m, 2) int64 rows (seed, offset), one a model.
extern "C" int alias_mh_resample_batched(
    const int32_t* docs, const int32_t* words, const int32_t* z,
    const float* weights, const void* n_dt, const void* n_wt, const void* n_t,
    int counts_int, const float* thresh_w, const int32_t* alias_w,
    const float* thresh_d, const int32_t* alias_d, const int32_t* j_prop,
    const float* u_prop, const float* u_acc, const unsigned long long* keys, float* work,
    int body, int32_t* z_out, int m, int n, int d, int v, int k, int s, float alpha,
    float beta, float beta_bar, float scale, void* stream) {
  if (j_prop == nullptr && keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(docs, words, z, weights, n_dt, n_wt, n_t, counts_int, thresh_w,
                              alias_w, thresh_d, alias_d, j_prop, u_prop, u_acc, keys, 0, 0,
                              work, body, z_out, m, n, d, v, k, s, alpha, beta, beta_bar,
                              scale, stream));
}

// Test entry: the kernel's Philox4x32-10 and cuRAND's `curand_Philox4x32_10`
// on n counters (n, 4) and keys (n, 2), uint32, into `ours` and `theirs`.
extern "C" int alias_mh_philox_words(const uint32_t* ctr, const uint32_t* key,
                                     uint32_t* ours, uint32_t* theirs, int n, void* stream) {
  if (n <= 0) return 0;
  philox_words_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ctr, key, ours, theirs, n);
  return static_cast<int>(cudaGetLastError());
}
