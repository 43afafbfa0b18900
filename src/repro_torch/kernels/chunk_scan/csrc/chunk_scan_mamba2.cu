// The chunked scan's Mamba2 entry for Hopper (sm_90a): one decay scalar a
// head and k, q shared by every head.
//
// Replaces, for Mamba2, the TPU kernel `chunk_scan_pallas` in
// src/repro/kernels/chunk_scan/kernel.py (body `_chunk_scan_kernel`), which
// the reference reaches with the decay and Bc/Cc broadcast to (B, S, H, dk)
// (src/repro/models/ssm.py::mamba2_mix). Here w is (B, S, H) float32, k and
// q are (B, S, dk) (Zamba2's n_groups = 1), v is (B, S, H, dv). Per (b, h)
// a (dk, dv) float32 state S runs over chunks of C tokens:
//
//   lw   = clip(log(max(w, 1e-30)), -20, 0)            (C,) a scalar a token
//   L    = cumsum_t lw                                 (inclusive)
//   A    = (q k^T)[t, i] * exp(L[t] - L[i])  for i <= t (every ratio <= 1)
//   y    = exp(L) * (q @ S) + A @ v
//   S    = exp(L[C-1]) * S + (k * exp(L[C-1] - L))^T @ v
//
// exactly `chunk_scan(include_current=True)` on the broadcast inputs, whose
// per-dk decays are all equal: the C(C+1)/2 * dk exps of a chunk become
// C(C+1)/2, and q_t . k_i is one dot for every head. y is written in v's
// type, the final state in float32.
//
// What bounds it: operations. At Zamba2's prefill (B 2, S 4096, H 80,
// dk = dv = 64, C 32, bf16) it moves 175 MB (0.052 ms at 3.35 TB/s) and
// does about 12 G float32 operations (0.18 ms at 67 TFLOP/s). On the CUDA
// cores the three (C or dk) x dk x DVB products a chunk are bounded by
// shared-memory reads more than by the FMA pipes (see the scan kernel).
//
// Design: two launches.
//  1. `mamba2_prep_kernel`, one block per (chunk, b): the masked q k^T of
//     the chunk (C x C, computed once instead of once per head and state
//     slice, written transposed), k widened to float32 and q transposed a
//     chunk (float32), and for every head the scan of
//     the clipped log decay with its exps: L, exp(L), exp(Lc - L) per token
//     and exp(Lc) per chunk (sequential sums, as torch.cumsum takes them).
//  2. `mamba2_scan_kernel`: the dv columns of S are independent, so a block
//     owns one (b, h) and a slice of DVB (16 or 32) state columns, DVB chosen
//     by the wrapper so that B * H * dv / DVB >= 2 * 132 (at B = 1 too). It
//     loops over the chunks with its (dk, DVB) state in shared memory,
//     double-buffered so that y (which reads S) and the update (which
//     writes S) share one phase: three barriers a chunk. The next chunk's
//     k, q^T, the v slice, (q k^T)^T and the decays are copied with
//     `cp.async` into the other half of a two-stage buffer while the
//     current chunk computes. A^T = (q k^T)^T * exp(L[t] - L[i]) is made in
//     place (the C(C+1)/2 exps of the chunk). The products are bounded by
//     shared-memory reads, not by the FMA pipes (a warp's read of a vector
//     costs one cycle a quarter warp, uniform or not), so 128 threads
//     (three blocks an SM; 256 with smaller tiles and 64 with larger ones
//     both ran slower on the H100) own 2-D register tiles whose both
//     operands are vector reads: y as 2 or 4 rows x DVB / 8 columns, the
//     update as 4 rows x DVB / 8 columns a pass of 64 rows.
// Everything stays float32 on the CUDA cores (the state and its products).
// Products use fmaf; exps and logs are the accurate expf/logf. A chunk that
// does not fill the tile (the ragged chunks 25, 60, ...) runs with its tail
// rows masked; rows past the chunk are zero in shared memory, so no garbage
// enters a product. The chunk's row tiles: CMAX = 32 for C <= 32, else 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the prep kernel
constexpr int kScanThreads = 128;  // the scan kernel
constexpr int kMaxChunk = 64;
constexpr int kMaxDk = 256;
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
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout of the scan kernel (bytes unless named floats). A
// stage holds the chunk's k (CMAX rows of dk4 floats), q transposed (dk4
// rows of CMAX), the v slice (CMAX rows of round_up(DVB * item, 16) bytes),
// q k^T transposed (CMAX rows of CMAX, turned into A^T in place) and L,
// exp(L), exp(Lc - L), exp(Lc). Then v and v * exp(Lc - L) in float32
// (CMAX rows of DVB) and the double-buffered state slice (dk4 rows of DVB).
struct Layout {
  int dk4, rowv;
  int off_qt, off_v, off_g, off_l;  // offsets inside a stage
  int stage;                        // bytes of one stage
  int off_v32, off_vf, off_s;
  int total;
};

__host__ __device__ inline Layout layout(int dk, int dvb, int item, int cmax) {
  Layout l;
  l.dk4 = round_up(dk, 4);
  l.rowv = round_up(dvb * item, 16);
  l.off_qt = cmax * l.dk4 * 4;
  l.off_v = l.off_qt + l.dk4 * cmax * 4;
  l.off_g = l.off_v + cmax * l.rowv;
  l.off_l = l.off_g + cmax * cmax * 4;
  l.stage = l.off_l + (3 * cmax + 4) * 4;
  l.off_v32 = 2 * l.stage;
  l.off_vf = l.off_v32 + cmax * dvb * 4;
  l.off_s = l.off_vf + cmax * dvb * 4;
  l.total = l.off_s + 2 * l.dk4 * dvb * 4;
  return l;
}

// Shared memory of the prep kernel: k and q of a chunk in float32.
__host__ __device__ inline int prep_bytes(int dk, int cmax) {
  return 2 * cmax * (round_up(dk, 4) + 4) * 4;
}

// N consecutive floats (N = 2, 4 or 8) from 16-byte (N >= 4) or 8-byte
// aligned shared memory.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (N == 2) {
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

// One block per (chunk, b). Writes kf (B, S, dk) float32; qt (B, nch, dk, cp)
// q transposed a chunk; gt (B, nch, c, cp) the masked q k^T transposed (row
// i, column t; zero where i > t and in the padding to cp); lx (3, B, S, H):
// L, exp(L), exp(Lc - L); elc (B, H, nch) exp(Lc).
template <typename T, int CMAX>
__global__ void __launch_bounds__(kThreads)
mamba2_prep_kernel(const float* __restrict__ w, const T* __restrict__ k,
                   const T* __restrict__ q, float* __restrict__ kf, float* __restrict__ qt,
                   float* __restrict__ gt, float* __restrict__ lx, float* __restrict__ elc,
                   int s_len, int h, int dk, int c, int cp) {
  constexpr int RT = CMAX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci = blockIdx.x, b = blockIdx.y, nch = gridDim.x;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dk4 = round_up(dk, 4), ks = dk4 + 4;
  float* sk = reinterpret_cast<float*>(smem);
  float* sq = sk + CMAX * ks;
  const long long tok0 = static_cast<long long>(b) * s_len + static_cast<long long>(ci) * c;
  const long long chunk = static_cast<long long>(b) * nch + ci;

  for (int i = tid; i < CMAX * dk4; i += kThreads) {
    const int r = i / dk4, d = i - r * dk4;
    float kv = 0.0f, qv = 0.0f;
    if (r < c && d < dk) {
      const long long o = (tok0 + r) * dk + d;
      kv = to_f(k[o]);
      qv = to_f(q[o]);
      kf[o] = kv;
    }
    sk[r * ks + d] = kv;
    sq[r * ks + d] = qv;
  }
  __syncthreads();
  for (int i = tid; i < dk * cp; i += kThreads) {  // q transposed, t fastest
    const int d = i / cp, t = i - d * cp;
    qt[(chunk * dk + d) * cp + t] = sq[t * ks + d];  // rows t >= c are zero
  }
  {  // q k^T on rows t = ty + 16 r, columns i = tx + 16 cc (cc <= r: the rest is i > t)
    float acc[RT][RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int cc = 0; cc < RT; ++cc) acc[r][cc] = 0.0f;
    for (int d = 0; d < dk4; d += 4) {
      float4 qv[RT], kv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(sq + (ty + 16 * r) * ks + d);
        kv[r] = *reinterpret_cast<const float4*>(sk + (tx + 16 * r) * ks + d);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int cc = 0; cc <= r; ++cc) {
          float a = acc[r][cc];
          a = fmaf(qv[r].x, kv[cc].x, a);
          a = fmaf(qv[r].y, kv[cc].y, a);
          a = fmaf(qv[r].z, kv[cc].z, a);
          a = fmaf(qv[r].w, kv[cc].w, a);
          acc[r][cc] = a;
        }
    }
    float* gc = gt + chunk * c * cp;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int t = ty + 16 * r;
      if (t >= cp) continue;
#pragma unroll
      for (int cc = 0; cc < RT; ++cc) {
        const int i = tx + 16 * cc;
        if (i < c) gc[i * cp + t] = (i <= t && t < c && cc <= r) ? acc[r][cc] : 0.0f;
      }
    }
  }
  // The decays, one head a thread: sequential sums over the chunk.
  const long long bsh = static_cast<long long>(gridDim.y) * s_len * h;
  for (int hh = tid; hh < h; hh += kThreads) {
    float run = 0.0f;
    for (int t = 0; t < c; ++t) {
      const long long o = (tok0 + t) * h + hh;
      run = run + fminf(fmaxf(logf(fmaxf(w[o], 1e-30f)), kLogWMin), 0.0f);
      lx[o] = run;
    }
    for (int t = 0; t < c; ++t) {
      const long long o = (tok0 + t) * h + hh;
      const float l = lx[o];
      lx[bsh + o] = expf(l);
      lx[2 * bsh + o] = expf(run - l);
    }
    elc[(static_cast<long long>(b) * h + hh) * nch + ci] = expf(run);
  }
}

// kScanThreads threads as RG row groups (rg) x 8 column groups (cg).
// Register tiles: y as RY = CMAX / RG rows x E = DVB / 8 columns, S's update
// as SR = 64 / RG rows x E columns a pass of 64 rows. Both operands of every product are vector
// reads (q^T, A^T and k along rows, S, v along columns): shared memory,
// not the FMA pipes, bounds these products, and a tile of R x E costs
// R + E words a thread for R * E FMAs.
template <typename T, int CMAX, int DVB>
__global__ void __launch_bounds__(kScanThreads, 3)  // three blocks an SM: 2 x 80 x 2 fit at once
mamba2_scan_kernel(const float* __restrict__ kf, const float* __restrict__ qt,
                   const T* __restrict__ v, const float* __restrict__ gt,
                   const float* __restrict__ lx, const float* __restrict__ elc,
                   const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                   int nb, int s_len, int h, int dk, int dv, int c, int cp) {
  constexpr int kThreads = kScanThreads;
  constexpr int RG = kThreads / 8;         // row groups
  constexpr int RY = CMAX / RG;            // rows of y a thread
  constexpr int E = DVB / 8;               // state columns a thread
  constexpr int SR = 64 / RG;              // rows of S a thread a pass of 64
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(dk, DVB, sizeof(T), CMAX);

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / h, hh = bh - b * h;
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int col = E * cg;  // this thread's first state column
  const int e0 = split * DVB;  // first state column of this block
  const long long tok0 = static_cast<long long>(b) * s_len;
  const long long bsh = static_cast<long long>(nb) * s_len * h;
  const int n = s_len / c;
  const int dk4 = lay.dk4;

  float* sS = reinterpret_cast<float*>(smem + lay.off_s);  // 2 x (dk4, DVB) state slice
  float* v32 = reinterpret_cast<float*>(smem + lay.off_v32);  // (CMAX, DVB) v
  float* vf = reinterpret_cast<float*>(smem + lay.off_vf);    // (CMAX, DVB) v * exp(Lc - L)
  auto st_k = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.stage); };
  auto st_qt = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.stage + lay.off_qt); };
  auto st_v = [&](int st) { return smem + st * lay.stage + lay.off_v; };
  auto st_g = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.stage + lay.off_g); };
  auto st_l = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.stage + lay.off_l); };

  // Zero everything once: rows past the chunk and pad columns stay zero.
  for (int i = tid; i < lay.total / 4; i += kThreads) reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < dk * DVB; i += kThreads) {
    const int d = i / DVB, e = i - d * DVB;
    sS[i] = s0 ? s0[(static_cast<long long>(bh) * dk + d) * dv + e0 + e] : 0.0f;
  }

  // Each thread's share of a chunk's 16-byte copies, fixed for the whole
  // sequence: row r0 + j * rstep, 16-byte unit `ch` of the row.
  struct Copy {
    int r0, ch, rstep;
  };
  auto share = [&](int units) {  // units a row (<= kThreads)
    const int rstep = kThreads / units;
    const int r0 = tid / units;
    return Copy{r0 < rstep ? r0 : CMAX * 64, tid - r0 * units, rstep};
  };
  const int ng = cp / 4;  // q^T and (q k^T)^T rows: cp floats, 16-byte aligned
  const Copy cpk = share(dk / 4);
  const Copy cpv = share(DVB * static_cast<int>(sizeof(T)) / 16);
  const Copy cpg = share(ng);

  auto load_chunk = [&](int ci, int st) {
    const long long t0 = tok0 + static_cast<long long>(ci) * c;
    const long long chunk = static_cast<long long>(b) * n + ci;
    float* sk = st_k(st);
    float* sqt = st_qt(st);
    unsigned char* sv = st_v(st);
    float* sg = st_g(st);
    float* sl = st_l(st);
    for (int r = cpk.r0; r < c; r += cpk.rstep)
      cp_async16(sk + r * dk4 + 4 * cpk.ch, kf + (t0 + r) * dk + 4 * cpk.ch);
    for (int r = cpv.r0; r < c; r += cpv.rstep) {
      const long long o = ((t0 + r) * h + hh) * dv + e0;
      cp_async16(sv + r * lay.rowv + cpv.ch * 16,
                 reinterpret_cast<const unsigned char*>(v + o) + cpv.ch * 16);
    }
    const float* qc = qt + chunk * dk * cp;
    for (int r = cpg.r0; r < dk; r += cpg.rstep)
      cp_async16(sqt + r * CMAX + 4 * cpg.ch, qc + r * cp + 4 * cpg.ch);
    const float* gc = gt + chunk * c * cp;
    for (int r = cpg.r0; r < c; r += cpg.rstep)
      cp_async16(sg + r * CMAX + 4 * cpg.ch, gc + r * cp + 4 * cpg.ch);
    for (int i = tid; i < 3 * c; i += kThreads) {
      const int which = i / c, r = i - which * c;
      cp_async4(sl + which * CMAX + r, lx + which * bsh + (t0 + r) * h + hh);
    }
    if (tid == 0) cp_async4(sl + 3 * CMAX, elc + static_cast<long long>(bh) * n + ci);
    cp_async_commit();
  };

  load_chunk(0, 0);
  for (int ci = 0; ci < n; ++ci) {
    const int st = ci & 1;
    const float* s_cur = sS + st * dk4 * DVB;
    float* s_nxt = sS + (st ^ 1) * dk4 * DVB;
    if (ci + 1 < n) load_chunk(ci + 1, st ^ 1); else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ci is staged (every thread's copies)

    const float* fk = st_k(st);
    const float* fqt = st_qt(st);
    float* sAt = st_g(st);
    const float* sL = st_l(st);
    const float* sEL = sL + CMAX;
    const float* sF = sEL + CMAX;
    const float elcv = sL[3 * CMAX];
    {  // v and v * exp(Lc - L) in float32
      const unsigned char* sv = st_v(st);
      for (int i = tid; i < c * DVB; i += kThreads) {
        const int r = i / DVB, e = i - r * DVB;
        const float x = to_f(reinterpret_cast<const T*>(sv + r * lay.rowv)[e]);
        v32[i] = x;
        vf[i] = x * sF[r];
      }
    }
    {  // A^T = (q k^T)^T * exp(L[t] - L[i]) in place: column t, rows i = i0, i0 + step, ..
      constexpr int kStep = kThreads / CMAX;
      const int t = tid % CMAX;
      if (t < c) {
        const float lt = sL[t];
        for (int i = tid / CMAX; i <= t; i += kStep) sAt[i * CMAX + t] *= expf(lt - sL[i]);
      }
    }
    __syncthreads();

    {  // y = exp(L) * (q @ S) + A @ v for rows RY * rg .., columns col ..
      const int t0r = RY * rg;
      float ys[RY][E], ya[RY][E];
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int u = 0; u < E; ++u) ys[r][u] = ya[r][u] = 0.0f;
      // Four rows of the contraction at a time, loads first (the pad rows
      // past dk and past the chunk are zero).
      for (int d = 0; d < dk4; d += 4) {
        float sv[4][E], qv[4][RY];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_row<E>(s_cur + (d + w4) * DVB + col, sv[w4]);
          load_row<RY>(fqt + (d + w4) * CMAX + t0r, qv[w4]);
        }
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int u = 0; u < E; ++u) ys[r][u] = fmaf(qv[w4][r], sv[w4][u], ys[r][u]);
      }
      const int imax = min(c, t0r + RY);  // A is zero past the band's last row
      for (int i = 0; i < imax; i += 4) {
        float vv[4][E], av[4][RY];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_row<E>(v32 + (i + w4) * DVB + col, vv[w4]);
          load_row<RY>(sAt + (i + w4) * CMAX + t0r, av[w4]);
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
        const float el = sEL[t];
        T* yr = y + ((tok0 + static_cast<long long>(ci) * c + t) * h + hh) * dv + e0 + col;
#pragma unroll
        for (int u = 0; u < E; ++u) yr[u] = from_f<T>(el * ys[r][u] + ya[r][u]);
      }
    }

    // S' = exp(Lc) * S + k^T @ (v * exp(Lc - L)) into the other state buffer,
    // rows d0 + SR rg .., columns col .., a pass of 64 rows.
    for (int d0 = 0; d0 < dk; d0 += 64) {
      const int dq = d0 + SR * rg;
      if (dq >= dk) continue;
      float acc[SR][E];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int u = 0; u < E; ++u) acc[r][u] = 0.0f;
      for (int j = 0; j < c; j += 4) {  // rows past the chunk are zero
        float vv[4][E], kr[4][SR];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          load_row<E>(vf + (j + w4) * DVB + col, vv[w4]);
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
#pragma unroll
        for (int u = 0; u < E; ++u)
          s_nxt[d * DVB + col + u] = elcv * s_cur[d * DVB + col + u] + acc[r][u];
      }
    }
    __syncthreads();  // the new state and this stage are done before the next chunk
  }
  cp_async_wait<0>();
  const float* s_fin = sS + (n & 1) * dk4 * DVB;
  for (int i = tid; i < dk * DVB; i += kThreads) {
    const int d = i / DVB, e = i - d * DVB;
    s_out[(static_cast<long long>(bh) * dk + d) * dv + e0 + e] = s_fin[i];
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
  const void* q;
  const void* v;
  const float* s0;
  void* y;
  float* s_out;
  float* kf;
  float* qt;
  float* gt;
  float* lx;
  float* elc;
  int b, s_len, h, dk, dv, c, cp;
};

template <typename T, int CMAX, int DVB>
cudaError_t launch3(const Args& a, cudaStream_t st) {
  auto prep = mamba2_prep_kernel<T, CMAX>;
  auto scan = mamba2_scan_kernel<T, CMAX, DVB>;
  static const cudaError_t prep_ok = opt_in(prep);
  static const cudaError_t scan_ok = opt_in(scan);
  if (prep_ok != cudaSuccess) return prep_ok;
  if (scan_ok != cudaSuccess) return scan_ok;
  prep<<<dim3(a.s_len / a.c, a.b), kThreads, prep_bytes(a.dk, CMAX), st>>>(
      a.w, static_cast<const T*>(a.k), static_cast<const T*>(a.q), a.kf, a.qt, a.gt, a.lx,
      a.elc, a.s_len, a.h, a.dk, a.c, a.cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan<<<dim3(a.b * a.h, (a.dv + DVB - 1) / DVB), kScanThreads,
         layout(a.dk, DVB, sizeof(T), CMAX).total, st>>>(
      a.kf, a.qt, static_cast<const T*>(a.v), a.gt, a.lx, a.elc, a.s0, static_cast<T*>(a.y),
      a.s_out, a.b, a.s_len, a.h, a.dk, a.dv, a.c, a.cp);
  return cudaGetLastError();
}

template <typename T, int CMAX>
cudaError_t launch2(const Args& a, int dvb, cudaStream_t st) {
  return dvb == 16 ? launch3<T, CMAX, 16>(a, st) : launch3<T, CMAX, 32>(a, st);
}

template <typename T>
cudaError_t launch(const Args& a, int dvb, cudaStream_t st) {
  return a.c <= 32 ? launch2<T, 32>(a, dvb, st) : launch2<T, 64>(a, dvb, st);
}

inline int smem_total(int c, int dk, int dvb, int item) {
  const int cmax = c <= 32 ? 32 : 64;
  const int scan = layout(dk, dvb, item, cmax).total;
  const int prep = prep_bytes(dk, cmax);
  return scan > prep ? scan : prep;
}

}  // namespace

// Shared memory (bytes) the larger of the two kernels needs at chunk c,
// width dk, slice dvb and element size `item` (2 for bf16, 4 for float32).
extern "C" int chunk_scan_mamba2_smem_bytes(int c, int dk, int dvb, int item) {
  return smem_total(c, dk, dvb, item);
}

// Plain C entry point (loaded with ctypes). w (b, s_len, h) float32; k, q
// (b, s_len, dk) and v (b, s_len, h, dv) of the type `bf16` picks (bfloat16
// over float32); s0 (b, h, dk, dv) float32 or null (zeros); y like v; s_out
// (b, h, dk, dv) float32. Scratch, all float32: kf (b, s_len, dk); qt
// (b, s_len / c, dk, cp) and gt (b, s_len / c, c, cp) with cp = c rounded up
// to 4; lx (3, b, s_len, h);
// elc (b, h, s_len / c). All row-major; s_len % c == 0, 1 <= c <= 64,
// dk <= 256 and dk % 4 == 0, dvb in {16, 32} state columns a block with
// dv % dvb == 0, v 16-byte aligned (every copy into shared memory is a
// 16-byte cp.async). Two launches on `stream`; allocates nothing; returns a
// CUDA error code.
extern "C" int chunk_scan_mamba2(const float* w, const void* k, const void* q, const void* v,
                                 const float* s0, void* y, float* s_out, float* kf, float* qt,
                                 float* gt, float* lx, float* elc, int b, int s_len, int h,
                                 int dk, int dv, int c, int dvb, int bf16,
                                 void* stream) {
  const int item = bf16 ? 2 : 4;
  if (c < 1 || c > kMaxChunk || s_len % c != 0 || dk < 4 || dk > kMaxDk || dk % 4 != 0 ||
      dv < 1 || dv % dvb != 0 || b < 1 || h < 1 || (dvb != 16 && dvb != 32) ||
      smem_total(c, dk, dvb, item) > kMaxSmem ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{w, k, q, v, s0, y, s_out, kf, qt, gt, lx, elc, b, s_len, h, dk, dv, c,
               round_up(c, 4)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<__nv_bfloat16>(a, dvb, st) : launch<float>(a, dvb, st));
}
