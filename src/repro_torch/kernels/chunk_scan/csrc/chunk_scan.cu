// Chunked diagonal-decay linear recurrence for Hopper (sm_90a): the
// general entry (a decay per key channel; RWKV6, and Mamba2 on broadcast
// inputs).
//
// Replaces the TPU kernel `chunk_scan_pallas` in
// src/repro/kernels/chunk_scan/kernel.py (body `_chunk_scan_kernel`), the
// shared core of Mamba2 (SSD) and RWKV6, in both of its modes. Per (batch,
// head) a (dk, dv) float32 state S runs over chunks of C tokens:
//
//   lw     = clip(log(max(w, 1e-30)), -20, 0)        (C, dk)
//   L      = cumsum_t lw,  Lprev = L - lw
//   mamba2 (include_current): Lq = L,     A[t,i] over i <= t
//   rwkv6:                    Lq = Lprev, A[t,i] over i <  t, plus
//                             A[t,t] = sum_d q u k (the u bonus)
//   A[t,i] = sum_d q[t,d] k[i,d] exp(Lq[t,d] - L[i,d])   (every ratio <= 1)
//   y      = (q * exp(Lq)) @ S + A @ v
//   S      = exp(L[C-1]) * S + (k * exp(L[C-1] - L))^T @ v
//
// y is written in v's type, the final state in float32.
//
// What bounds it: operations. At rwkv6-1.6b's served prefill (B 2, S 4096,
// H 32, dk = dv = 64, C 32, bf16 k/q/v, float32 w) the recurrence needs
// 5.80 G float32 operations (0.087 ms at 67 TFLOP/s; most are the two
// state contractions, with A counted in its cheapest known form) against
// 202 MB of inputs and outputs (0.060 ms at 3.35 TB/s). This design adds
// its scratch, one 20,736-byte record a chunk (170 MB) written once and
// read once, so it moves 541 MB (0.16 ms at 3.35 TB/s): the bytes of the
// split are its floor.
//
// Design: two launches, the prep parallel across chunks, the scan across
// (b, h) and slices of the state's columns.
//  1. `prep_kernel`, one block of 256 threads per (b, h, chunk) — B * H *
//     S / C blocks, 8,192 at the served prefill — does all of a chunk that
//     does not read the carried state: it copies the chunk's w, k and q
//     rows in with cp.async, takes the clipped log decays and their
//     cumulative sum (sequential sums in token order, as torch.cumsum takes
//     them) and writes the chunk's record: kd = k * exp(Lc - L),
//     qs = q * exp(Lq) transposed, A transposed and exp(Lc), all float32. A
//     is computed once per chunk. The chunk splits into sub-chunks of 8
//     rows. A diagonal 8 x 8 block keeps one exp a (t, i, d): a 2 x 2
//     register tile of (t, i) pairs reuses the q, Lq, k and L rows, the 10
//     tiles of a block are numbered over its lower triangle (no warp idles
//     on the mask), and four lanes split a tile's d range and add their sums
//     by shuffles. An off-diagonal block (rows in sub-chunk T, columns in
//     I < T) is a product: exp(Lq[t] - L[i]) = exp(Lq[t] - L[a])
//     exp(L[a] - L[r]) exp(L[r] - L[i]) with a = 8 T - 1 the row before t's
//     sub-chunk and r = 8 I + 7 the last row of i's, each factor <= 1 (L
//     does not rise), so A there is sum_d qf[t,d] M[d] kf[i,d] with one exp
//     a (t, d), a (i, d) and a (T, I, d). At C 32, dk 64 that is 13,696 exps
//     for A instead of C(C-1)/2 * dk = 31,744.
//  2. `scan_kernel`: the dv columns of S are independent, so a block of 128
//     threads owns one (b, h) and a slice of 16 state columns: B * H *
//     ceil(dv / 16) blocks, 256 at the served B 2 (2 an SM on 124 of the
//     132 SMs), 128 at B 1. It loops over the chunks with its (dk, 16) state
//     in shared memory, double-buffered so that y (which reads S) and the
//     update (which writes S) share one phase: two barriers a chunk. Each
//     chunk's record is copied whole, and its v slice row by row, with
//     cp.async into a ring of three stages (two where three do not fit: dk
//     128 at chunk 64), so two chunks are in flight while one computes; v
//     takes scalar copies where its rows are off the 16-byte path, and is
//     read in place, bf16 widened in registers. y = qs @ S + A @ v and S' = exp(Lc) * S +
//     kd^T @ v run as register tiles (y: C/16 rows x 2 columns a thread;
//     the update: 4 rows x 2 columns a pass of 64 rows) whose both operands
//     are vector reads from shared memory. Columns past dv in the last slice
//     are zero and not written. Slices of 8 columns (512 blocks at B 2, with
//     thinner tiles and twice the record traffic) and of 32 ran slower on
//     the H100 at every shape measured (PERF.md).
// Everything stays float32 on the CUDA cores. Products use fmaf; exps and
// logs are the accurate expf/logf (no fast math, -fmad=false). Rows past a
// ragged chunk (25, 60, ...) are zero in the record, so no garbage enters a
// product; sums of y rows past the chunk are not written.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, CUDA events
// through the wrapper): 0.66 ms a call at the served 2 x 4096 prefill (prep
// 0.27, scan 0.39), 7.6x the 0.087 ms operation bound and 4.1x the design's
// 0.16 ms of bytes; 0.096 / 0.066 ms at 2 x 512 / 1 x 512 (bounds 0.011 /
// 0.0054). PERF.md §6 row 6 keeps the runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrepThreads = 256;
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kScanThreads = 128;
constexpr int kDvb = 16;          // state columns a scan block owns
constexpr int kMaxStages = 3;     // the scan's copy ring: chunks in flight, where they fit
constexpr int kMaxChunk = 64;
constexpr int kSub = 8;           // rows of a sub-chunk (the prep's A blocks)
constexpr int kHalf = kSub / 2;   // 2 x 2 tiles a row of a sub-chunk block
constexpr int kDiagTiles = kHalf * (kHalf + 1) / 2;  // tiles of a diagonal block's lower triangle
constexpr int kOffTiles = kHalf * kHalf;             // tiles of an off-diagonal block
constexpr int kMaxSmem = 232448;  // bytes a block can opt into on sm_90
constexpr float kLogWMin = -20.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A chunk's record in the scratch, written by the prep and copied whole by
// the scan, in floats (every part a multiple of 4): kd (cp rows of dk4),
// qs^T (dk4 rows of cp), A^T (cp rows of cp), exp(Lc) (dk4). Rows and
// columns past the chunk and past dk are zero.
struct Record {
  int qt, at, elc, size;  // offsets (kd at 0) and size
};
__host__ __device__ inline Record record(int dk4, int cp) {
  return {cp * dk4, 2 * cp * dk4, 2 * cp * dk4 + cp * cp, 2 * cp * dk4 + cp * cp + dk4};
}

// Row and column of entry p of a lower triangle numbered row by row
// (col <= row).
__device__ __forceinline__ void tri(int p, int& row, int& col) {
  row = 0;
  while ((row + 1) * (row + 2) / 2 <= p) ++row;
  col = p - row * (row + 1) / 2;
}

// N consecutive floats (N = 1, 2, 4 or 8) from shared memory aligned to
// 4 * N bytes (16 for N >= 4).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    out[0] = r.x;
    out[1] = r.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + j);
      out[j] = r.x;
      out[j + 1] = r.y;
      out[j + 2] = r.z;
      out[j + 3] = r.w;
    }
  }
}

// Shared memory of the prep kernel, in floats: q, k, L, Lq (cmax rows of
// ks), qf (rows kSub.. of the chunk), kf (rows ..cmax - kSub), M (one row a
// pair of sub-chunks), u (one row) and A^T (cmax rows of cmax + 1).
__host__ __device__ inline int prep_floats(int c, int dk) {
  const int nsub = (c + kSub - 1) / kSub, cmax = kSub * nsub, ks = round_up(dk, 4) + 4;
  const int npairs = nsub * (nsub - 1) / 2;
  return (4 * cmax + 2 * (cmax - kSub) + npairs + 1) * ks + cmax * (cmax + 1);
}

// One block per (chunk, h, b): writes chunk g = (b H + h) n + ci's record
// (float32) to rec + g * record(dk4, cp).size.
template <typename T, bool kIncludeCurrent>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ w, const T* __restrict__ k, const T* __restrict__ q,
            const float* __restrict__ u, float* __restrict__ rec, int s_len, int h, int dk,
            int c, int cp, int vec_w, int vec_kq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, n = gridDim.x;
  const int tid = threadIdx.x;
  const int nsub = (c + kSub - 1) / kSub, cmax = kSub * nsub;
  const int npairs = nsub * (nsub - 1) / 2;
  const int dk4 = round_up(dk, 4), ks = dk4 + 4, as = cmax + 1;
  float* sQ = reinterpret_cast<float*>(smem);  // (cmax, ks) q
  float* sK = sQ + cmax * ks;             // (cmax, ks) k
  float* sL = sK + cmax * ks;             // (cmax, ks) lw, then L
  float* sLq = sL + cmax * ks;            // (cmax, ks) Lq
  float* sQf = sLq + cmax * ks;           // rows t >= kSub: q * exp(Lq - L[a])
  float* sKf = sQf + (cmax - kSub) * ks;  // rows i < cmax - kSub: k * exp(L[r] - L)
  float* sM = sKf + (cmax - kSub) * ks;   // (npairs, ks) exp(L[a] - L[r])
  float* sU = sM + npairs * ks;           // (ks) u
  float* sAt = sU + ks;                   // (cmax, as) A^T

  const int warp = tid >> 5, lane = tid & 31;
  const long long g = (static_cast<long long>(b) * h + hh) * n + ci;
  const long long tok0 = static_cast<long long>(b) * s_len + static_cast<long long>(ci) * c;
  // The chunk's w, k and q rows, a warp a row: 16-byte cp.async copies where
  // the rows allow (w into sL; float32 k, q into sK, sQ; bf16 k, q staged in
  // sLq's space, which the cumulative sum fills later), else scalar loads.
  constexpr bool kWide = sizeof(T) == 4;
  T* rawk = reinterpret_cast<T*>(sLq);
  T* rawq = rawk + cmax * dk4;
  for (int r = warp; r < c; r += kPrepWarps) {
    const long long o = ((tok0 + r) * h + hh) * dk;
    if (vec_w) {
      for (int j = lane; j < dk / 4; j += 32) cp_async16(sL + r * ks + 4 * j, w + o + 4 * j);
    } else {
      for (int d = lane; d < dk; d += 32) sL[r * ks + d] = w[o + d];
    }
    if (vec_kq) {
      constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
      T* dk_row = kWide ? reinterpret_cast<T*>(sK + r * ks) : rawk + r * dk4;
      T* dq_row = kWide ? reinterpret_cast<T*>(sQ + r * ks) : rawq + r * dk4;
      for (int j = lane; j < dk / kPer; j += 32) {
        cp_async16(dk_row + kPer * j, k + o + kPer * j);
        cp_async16(dq_row + kPer * j, q + o + kPer * j);
      }
    } else {
      for (int d = lane; d < dk; d += 32) {
        sK[r * ks + d] = to_f(k[o + d]);
        sQ[r * ks + d] = to_f(q[o + d]);
      }
    }
  }
  cp_async_commit();
  if (!kIncludeCurrent) {
    for (int d = tid; d < dk4; d += kPrepThreads)
      sU[d] = (u != nullptr && d < dk) ? u[hh * dk + d] : 0.0f;
  }
  for (int idx = tid; idx < cmax * as; idx += kPrepThreads) sAt[idx] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  // lw in place of w, bf16 k and q widened; rows past c and columns past dk
  // are zero.
  for (int t = warp; t < cmax; t += kPrepWarps) {
    for (int d = lane; d < dk4; d += 32) {
      const bool in = t < c && d < dk;
      sL[t * ks + d] = in ? fminf(fmaxf(logf(fmaxf(sL[t * ks + d], 1e-30f)), kLogWMin), 0.0f)
                          : 0.0f;
      if (!kWide && vec_kq) {
        sK[t * ks + d] = in ? to_f(rawk[t * dk4 + d]) : 0.0f;
        sQ[t * ks + d] = in ? to_f(rawq[t * dk4 + d]) : 0.0f;
      } else if (!in) {
        sK[t * ks + d] = 0.0f;
        sQ[t * ks + d] = 0.0f;
      }
    }
  }
  __syncthreads();
  // The cumulative log decay, a thread a column, in token order (rows past
  // c add lw = 0).
  for (int d = tid; d < dk4; d += kPrepThreads) {
    float run = 0.0f;
    for (int t = 0; t < cmax; ++t) {
      const float lw = sL[t * ks + d];
      run = run + lw;
      sL[t * ks + d] = run;
      sLq[t * ks + d] = kIncludeCurrent ? run : run - lw;
    }
  }
  __syncthreads();

  const float* lc = sL + (c - 1) * ks;  // the chunk's total decay
  const Record R = record(dk4, cp);
  float* out = rec + g * R.size;  // this chunk's record
  for (int t = warp; t < cp; t += kPrepWarps)  // rows past c are zero: k is
    for (int d = lane; d < dk4; d += 32)
      out[t * dk4 + d] = sK[t * ks + d] * expf(lc[d] - sL[t * ks + d]);
  for (int d = warp; d < dk4; d += kPrepWarps)
    for (int t = lane; t < cp; t += 32)
      out[R.qt + d * cp + t] = sQ[t * ks + d] * expf(sLq[t * ks + d]);
  for (int d = tid; d < dk4; d += kPrepThreads) out[R.elc + d] = d < dk ? expf(lc[d]) : 0.0f;
  for (int r = warp; r < cmax - kSub; r += kPrepWarps) {
    const int t = r + kSub, a = t / kSub * kSub - 1;  // the row before t's sub-chunk
    const int e = r / kSub * kSub + kSub - 1;         // the last row of r's sub-chunk
    for (int d = lane; d < dk4; d += 32) {
      sQf[r * ks + d] = sQ[t * ks + d] * expf(sLq[t * ks + d] - sL[a * ks + d]);
      sKf[r * ks + d] = sK[r * ks + d] * expf(sL[e * ks + d] - sL[r * ks + d]);
    }
  }
  for (int p = warp; p < npairs; p += kPrepWarps) {
    int tm, ii;
    tri(p, tm, ii);  // p = T (T - 1) / 2 + I, I < T
    const int a = kSub * (tm + 1) - 1, r = kSub * ii + kSub - 1;
    for (int d = lane; d < dk4; d += 32)  // 1 where I = T - 1
      sM[p * ks + d] = expf(sL[a * ks + d] - sL[r * ks + d]);
  }
  __syncthreads();

  // A: the diagonal blocks' 2 x 2 tiles first, each over four lanes that
  // split the d range and add their sums, then the off-diagonal ones.
  const int n_diag = nsub * kDiagTiles, n_items = 4 * n_diag + npairs * kOffTiles;
  const int dq = round_up((dk4 + 3) / 4, 4);  // d a lane of a diagonal tile
  for (int p = tid; p < n_items; p += kPrepThreads) {
    float a[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    int t0, i0;
    bool lead = true;
    if (p < 4 * n_diag) {  // the four lanes of a tile are in one warp
      const int tile = p >> 2, part = p & 3;
      const int blk = tile / kDiagTiles;
      int x, y;
      tri(tile - blk * kDiagTiles, x, y);
      t0 = kSub * blk + 2 * x;
      i0 = kSub * blk + 2 * y;
      const float* qr = sQ + t0 * ks;
      const float* lqr = sLq + t0 * ks;
      const float* kr = sK + i0 * ks;
      const float* lr = sL + i0 * ks;
      const int d_hi = min(dk4, (part + 1) * dq);
      for (int d = part * dq; d < d_hi; d += 4) {
        float qv[2][4], lqv[2][4], kv[2][4], lv[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          load_row<4>(qr + r * ks + d, qv[r]);
          load_row<4>(lqr + r * ks + d, lqv[r]);
          load_row<4>(kr + r * ks + d, kv[r]);
          load_row<4>(lr + r * ks + d, lv[r]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int s = 0; s < 2; ++s)  // a masked pair's value is dropped below
              a[r][s] = fmaf(expf(lqv[r][j] - lv[s][j]) * qv[r][j], kv[s][j], a[r][s]);
      }
      const unsigned group = 0xFu << (lane & ~3);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          a[r][s] += __shfl_xor_sync(group, a[r][s], 1);
          a[r][s] += __shfl_xor_sync(group, a[r][s], 2);
        }
      lead = part == 0;
    } else {
      const int pp = p - 4 * n_diag, pair = pp / kOffTiles, loc = pp - pair * kOffTiles;
      int tm, ii;
      tri(pair, tm, ii);
      t0 = kSub * (tm + 1) + 2 * (loc / kHalf);
      i0 = kSub * ii + 2 * (loc % kHalf);
      const float* qr = sQf + (t0 - kSub) * ks;
      const float* kr = sKf + i0 * ks;
      const float* mr = sM + pair * ks;
      for (int d = 0; d < dk4; d += 4) {
        float qv[2][4], kv[2][4], mv[4];
        load_row<4>(mr + d, mv);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          load_row<4>(qr + r * ks + d, qv[r]);
          load_row<4>(kr + r * ks + d, kv[r]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              a[r][s] = fmaf(qv[r][j] * mv[j], kv[s][j], a[r][s]);
      }
    }
    if (!lead) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int t = t0 + r, i = i0 + s;
        const bool keep = kIncludeCurrent ? i <= t : i < t;
        sAt[i * as + t] = keep ? a[r][s] : 0.0f;
      }
  }
  __syncthreads();
  if (!kIncludeCurrent) {  // the u bonus on the diagonal
    for (int t = tid; t < c; t += kPrepThreads) {
      float a = 0.0f;
      for (int d = 0; d < dk; ++d) a = fmaf(sQ[t * ks + d] * sU[d], sK[t * ks + d], a);
      sAt[t * as + t] = a;
    }
    __syncthreads();
  }
  for (int i = warp; i < cp; i += kPrepWarps)  // zero past the chunk (q or k is)
    for (int t = lane; t < cp; t += 32) out[R.at + i * cp + t] = sAt[i * as + t];
}

// Shared-memory layout of the scan kernel (bytes). A stage holds a chunk's
// record as the prep wrote it, then the v slice (CMAX rows of
// round_up(DVB * item, 16) bytes, read in place). Then the double-buffered
// state slice (dk4 rows of DVB).
struct Layout {
  int dk4, rowv;
  int off_v;  // the v slice inside a stage
  int stage;  // bytes of one stage
  int off_s;
  int total;
};

__host__ __device__ inline Layout layout(int dk, int c, int item, int cmax, int stages) {
  Layout l;
  l.dk4 = round_up(dk, 4);
  l.rowv = round_up(kDvb * item, 16);
  l.off_v = record(l.dk4, round_up(c, 4)).size * 4;
  l.stage = l.off_v + cmax * l.rowv;
  l.off_s = stages * l.stage;
  l.total = l.off_s + 2 * l.dk4 * kDvb * 4;
  return l;
}

// E consecutive v values of a staged row, widened (aligned to E elements).
template <int E>
__device__ __forceinline__ void load_v(const float* p, float* out) {
  load_row<E>(p, out);
}
template <int E>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int j = 0; j < E; j += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + j));
    out[j] = f.x;
    out[j + 1] = f.y;
  }
}

// kThreads threads as 16 row groups (rg) x CG column groups (cg). Register
// tiles: y as RY = CMAX / 16 rows x E columns, S's update as 4 rows x E
// columns a pass of 64 rows; both operands of every product are vector
// reads. `vec`: v's rows take 16-byte copies (dv * item % 16 == 0 and v
// 16-byte aligned).
template <typename T, int CMAX, int STAGES>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ rec, const T* __restrict__ v,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
            int s_len, int h, int dk, int dv, int c, int cp, int vec) {
  constexpr int kThreads = kScanThreads;
  constexpr int DVB = kDvb;
  constexpr int CG = 8;              // column groups
  constexpr int E = DVB / CG;        // state columns a thread
  constexpr int RG = kThreads / CG;  // row groups
  constexpr int RY = CMAX / RG;      // rows of y a thread
  constexpr int SR = 64 / RG;        // rows of S a thread a pass of 64
  constexpr int item = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(dk, c, item, CMAX, STAGES);
  const Record R = record(lay.dk4, cp);
  const int rowv = lay.rowv / item;  // elements a staged v row

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / h, hh = bh - b * h;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int col = E * cg;      // this thread's first state column in the slice
  const int e0 = split * DVB;  // the slice's first state column
  const long long tok0 = static_cast<long long>(b) * s_len;
  const int n = s_len / c;
  const int dk4 = lay.dk4;

  float* sS = reinterpret_cast<float*>(smem + lay.off_s);  // 2 x (dk4, DVB) state slice
  auto st_r = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.stage); };
  auto st_v = [&](int st) { return reinterpret_cast<T*>(smem + st * lay.stage + lay.off_v); };

  // Zero everything once: rows past the chunk, pad columns and the state
  // columns past dv stay zero.
  for (int i = tid; i < lay.total / 4; i += kThreads) reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < dk * DVB; i += kThreads) {
    const int d = i / DVB, e = i - d * DVB;
    if (s0 != nullptr && e0 + e < dv)
      sS[d * DVB + e] = s0[(static_cast<long long>(bh) * dk + d) * dv + e0 + e];
  }

  // Each thread's share of a chunk's 16-byte copies, fixed for the whole
  // sequence: rows r0, r0 + rstep, .., 16-byte unit `ch` of the row.
  struct Copy {
    int r0, ch, rstep;
  };
  auto share = [&](int units) {  // units a row (<= kThreads)
    const int rstep = kThreads / units;
    const int r0 = tid / units;
    return Copy{r0 < rstep ? r0 : 1 << 30, tid - r0 * units, rstep};
  };
  const Copy cpv = share(lay.rowv / 16);
  const int vbytes = (dv - e0 < DVB ? dv - e0 : DVB) * item;  // bytes of v a row in this slice

  auto load_chunk = [&](int ci, int st) {
    const long long t0 = tok0 + static_cast<long long>(ci) * c;
    const float* rc = rec + (static_cast<long long>(bh) * n + ci) * R.size;
    float* sr = st_r(st);
    T* sv = st_v(st);
    for (int j = tid; j < R.size / 4; j += kThreads) cp_async16(sr + 4 * j, rc + 4 * j);
    if (vec) {
      for (int r = cpv.r0; r < c; r += cpv.rstep) {
        if (cpv.ch * 16 >= vbytes) continue;  // past dv in the last slice
        const long long o = ((t0 + r) * h + hh) * dv + e0;
        cp_async16(reinterpret_cast<unsigned char*>(sv + r * rowv) + cpv.ch * 16,
                   reinterpret_cast<const unsigned char*>(v + o) + cpv.ch * 16);
      }
    } else {  // scalar copies: the stage is not read until the next barrier
      for (int i = tid; i < c * DVB; i += kThreads) {
        const int r = i / DVB, e = i - r * DVB;
        if (e0 + e < dv) sv[r * rowv + e] = v[((t0 + r) * h + hh) * dv + e0 + e];
      }
    }
    cp_async_commit();
  };

  for (int ci = 0; ci < STAGES - 1; ++ci) {
    if (ci < n) load_chunk(ci, ci); else cp_async_commit();
  }
  for (int ci = 0; ci < n; ++ci) {
    const int st = ci % STAGES;
    const float* s_cur = sS + (ci & 1) * dk4 * DVB;
    float* s_nxt = sS + ((ci & 1) ^ 1) * dk4 * DVB;
    // The stage chunk ci - 1 read: free since the barrier that ended it.
    const int ahead = ci + STAGES - 1;
    if (ahead < n) load_chunk(ahead, ahead % STAGES); else cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // chunk ci is staged (every thread's copies)

    // Rows of y past cp read the next row of qs^T and A^T: their sums are
    // not written.
    const float* fk = st_r(st);
    const float* fqt = fk + R.qt;
    const float* sAt = fk + R.at;
    const float* se = fk + R.elc;
    const T* sv = st_v(st);

    {  // y = qs @ S + A @ v for rows RY * rg .., columns col ..
      const int t0r = RY * rg;
      float ys[RY][E], ya[RY][E];
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int u = 0; u < E; ++u) ys[r][u] = ya[r][u] = 0.0f;
      // Four rows of the contraction at a time, loads first (the pad rows
      // past dk and past the chunk are zero).
#pragma unroll 2
      for (int d = 0; d < dk4; d += 4) {
        float sr[4][E], qv[4][RY];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_row<E>(s_cur + (d + w4) * DVB + col, sr[w4]);
          load_row<RY>(fqt + (d + w4) * cp + t0r, qv[w4]);
        }
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int u = 0; u < E; ++u) ys[r][u] = fmaf(qv[w4][r], sr[w4][u], ys[r][u]);
      }
      const int imax = min(c, t0r + RY);  // A is zero past the band's last row
      for (int i = 0; i < imax; i += 4) {
        float vv[4][E], av[4][RY];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_v<E>(sv + (i + w4) * rowv + col, vv[w4]);
          load_row<RY>(sAt + (i + w4) * cp + t0r, av[w4]);
        }
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int u = 0; u < E; ++u) ya[r][u] = fmaf(av[w4][r], vv[w4][u], ya[r][u]);
      }
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int t = t0r + r;
        if (t >= c) continue;
        T* yr = y + ((tok0 + static_cast<long long>(ci) * c + t) * h + hh) * dv + e0 + col;
#pragma unroll
        for (int u = 0; u < E; ++u)
          if (e0 + col + u < dv) yr[u] = from_f<T>(ys[r][u] + ya[r][u]);
      }
    }

    // S' = exp(Lc) * S + kd^T @ v into the other state buffer, rows
    // d0 + SR rg .., columns col .., a pass of 64 rows.
    for (int d0 = 0; d0 < dk; d0 += 64) {
      const int dq = d0 + SR * rg;
      if (dq >= dk) continue;
      float acc[SR][E];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int u = 0; u < E; ++u) acc[r][u] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < c; j += 4) {  // rows past the chunk are zero
        float vv[4][E], kr[4][SR];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_v<E>(sv + (j + w4) * rowv + col, vv[w4]);
          load_row<SR>(fk + (j + w4) * dk4 + dq, kr[w4]);
        }
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
#pragma unroll
          for (int r = 0; r < SR; ++r)
#pragma unroll
            for (int u = 0; u < E; ++u) acc[r][u] = fmaf(kr[w4][r], vv[w4][u], acc[r][u]);
      }
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const int d = dq + r;
        if (d >= dk) continue;
        const float ed = se[d];
#pragma unroll
        for (int u = 0; u < E; ++u)
          s_nxt[d * DVB + col + u] = ed * s_cur[d * DVB + col + u] + acc[r][u];
      }
    }
    __syncthreads();  // the new state and this stage are done before the next chunk
  }
  cp_async_wait<0>();
  const float* s_fin = sS + (n & 1) * dk4 * DVB;
  for (int i = tid; i < dk * DVB; i += kThreads) {
    const int d = i / DVB, e = i - d * DVB;
    if (e0 + e < dv) s_out[(static_cast<long long>(bh) * dk + d) * dv + e0 + e] = s_fin[i];
  }
}

// Opt a kernel in to the card's shared-memory limit once per process (per
// instantiation); each launch then asks for what its shapes need.
template <typename K>
cudaError_t opt_in(K kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

struct Args {
  const float* w;
  const void* k;
  const void* v;
  const void* q;
  const float* u;
  const float* s0;
  void* y;
  float* s_out;
  float* rec;
  int b, s_len, h, dk, dv, c, cp, stages, vec, vec_w, vec_kq;
};

template <typename T, bool kIncludeCurrent>
cudaError_t launch_prep(const Args& a, cudaStream_t st) {
  auto prep = prep_kernel<T, kIncludeCurrent>;
  static const cudaError_t ok = opt_in(prep);
  if (ok != cudaSuccess) return ok;
  prep<<<dim3(a.s_len / a.c, a.h, a.b), kPrepThreads, prep_floats(a.c, a.dk) * 4, st>>>(
      a.w, static_cast<const T*>(a.k), static_cast<const T*>(a.q), a.u, a.rec, a.s_len, a.h,
      a.dk, a.c, a.cp, a.vec_w, a.vec_kq);
  return cudaGetLastError();
}

// The scan's grid: a block a (b, h) and slice of kDvb state columns (the
// last slice may be ragged).
inline dim3 scan_grid(int b, int h, int dv) { return dim3(b * h, (dv + kDvb - 1) / kDvb); }

template <typename T, int CMAX, int STAGES>
cudaError_t launch_scan(const Args& a, cudaStream_t st) {
  auto scan = scan_kernel<T, CMAX, STAGES>;
  static const cudaError_t ok = opt_in(scan);
  if (ok != cudaSuccess) return ok;
  scan<<<scan_grid(a.b, a.h, a.dv), kScanThreads,
         layout(a.dk, a.c, sizeof(T), CMAX, STAGES).total, st>>>(
      a.rec, static_cast<const T*>(a.v), a.s0, static_cast<T*>(a.y), a.s_out, a.s_len, a.h,
      a.dk, a.dv, a.c, a.cp, a.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, bool include_current, cudaStream_t st) {
  const cudaError_t err = include_current ? launch_prep<T, true>(a, st)
                                          : launch_prep<T, false>(a, st);
  if (err != cudaSuccess) return err;
  if (a.stages == kMaxStages) {
    return a.c <= 32 ? launch_scan<T, 32, kMaxStages>(a, st)
                     : launch_scan<T, 64, kMaxStages>(a, st);
  }
  return a.c <= 32 ? launch_scan<T, 32, 2>(a, st) : launch_scan<T, 64, 2>(a, st);
}

// The scan's copy stages: kMaxStages where they fit, else 2.
inline int scan_stages(int c, int dk, int item) {
  const int cmax = c <= 32 ? 32 : 64;
  return layout(dk, c, item, cmax, kMaxStages).total <= kMaxSmem ? kMaxStages : 2;
}

inline int smem_total(int c, int dk, int item) {
  const int scan = layout(dk, c, item, c <= 32 ? 32 : 64, scan_stages(c, dk, item)).total;
  const int prep = prep_floats(c, dk) * 4;
  return scan > prep ? scan : prep;
}

}  // namespace

// Shared memory (bytes) the larger of the two kernels needs at chunk c,
// width dk and element size `item` (2 for bf16, 4 for float32).
extern "C" int chunk_scan_smem_bytes(int c, int dk, int item) { return smem_total(c, dk, item); }

// State columns a scan block owns, and the blocks the scan launches at b,
// h and dv (its grid, as `chunk_scan` launches it).
extern "C" int chunk_scan_dv_block() { return kDvb; }
extern "C" int chunk_scan_scan_blocks(int b, int h, int dv) {
  const dim3 g = scan_grid(b, h, dv);
  return static_cast<int>(g.x * g.y);
}

// Floats of scratch the two kernels share at b, s_len, h, dk and chunk c:
// one record a chunk (`record`).
extern "C" long long chunk_scan_scratch_floats(int b, int s_len, int h, int dk, int c) {
  return static_cast<long long>(b) * h * (s_len / c) * record(round_up(dk, 4), round_up(c, 4)).size;
}

// Plain C entry point (loaded with ctypes). w (b, s_len, h, dk) float32;
// k, q (b, s_len, h, dk) and v (b, s_len, h, dv) of one type (`bf16` picks
// bfloat16 over float32); u (h, dk) float32 or null (zeros); s0
// (b, h, dk, dv) float32 or null (zeros); y like v; s_out (b, h, dk, dv)
// float32; rec, float32 scratch of `chunk_scan_scratch_floats`, 16-byte
// aligned. All row-major; s_len % c == 0, 1 <= c <= 64. Two launches on
// `stream`, the scan over kDvb state columns a block (the last slice may be
// ragged); allocates nothing; returns a CUDA error code.
extern "C" int chunk_scan(const float* w, const void* k, const void* v, const void* q,
                          const float* u, const float* s0, void* y, float* s_out, float* rec,
                          int b, int s_len, int h, int dk, int dv, int c,
                          int include_current, int bf16, void* stream) {
  const int item = bf16 ? 2 : 4;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (c < 1 || c > kMaxChunk || s_len < c || s_len % c != 0 || dk < 1 || dv < 1 || b < 1 ||
      h < 1 || !aligned(rec) || smem_total(c, dk, item) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (dv * item) % 16 == 0 && aligned(v);
  const int vec_w = dk % 4 == 0 && aligned(w);
  const int vec_kq = (dk * item) % 16 == 0 && aligned(k) && aligned(q);
  const Args a{w, k, v, q, u, s0, y, s_out, rec, b, s_len, h, dk, dv, c, round_up(c, 4),
               scan_stages(c, dk, item), vec, vec_w, vec_kq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<__nv_bfloat16>(a, include_current != 0, st)
                               : launch<float>(a, include_current != 0, st));
}
