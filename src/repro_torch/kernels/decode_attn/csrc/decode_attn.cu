// One-token GQA flash-decode for Hopper (sm_90a), split over the cache.
//
// Replaces the TPU kernel `decode_attention_pallas` in
// src/repro/kernels/decode_attn/kernel.py (body `_decode_attn_kernel`).
// For each batch row b and kv head h, the G query heads of that group
// attend over the cache k, v (b, S, Hkv, hd):
//
//   s[c]  = cap * tanh((q . k[c]) * scale / cap)      (no cap when cap <= 0)
//   valid = ring:  age = (pos mod S - c) mod S, abs = pos - age,
//                  age < min(length, S) and abs >= 0 [and abs > pos - window]
//           else:  c < length [and c > pos - window]
//   out   = softmax over the valid c of s, times v     (online, float32)
//
// scale = hd^-0.5. The result is written in q's type.
//
// What bounds it: bytes. Per valid position and kv head it reads 2 * hd
// elements of K and V and does 4 * hd * G flops: G <= 8 flops a byte in
// bf16, below what the CUDA cores sustain, so no tensor cores. At B = 2, a
// 4096-slot ring, Hkv = 32, hd = 80 in bf16 that is 84 MB (0.025 ms at
// 3.35 TB/s); at a qwen2-like GQA shape (Hkv 4, G 7, hd 128, 8192 long)
// 34 MB (0.010 ms). One block per (b, h), the first design, gave 64 and 8
// blocks there, on 132 SMs, so the card's memory pipes were mostly idle.
//
// Design (flash-decoding):
//  * The S slots are cut into tiles of T positions (64; 32 for rows past
//    480 bytes) and the tiles into P contiguous partitions, P chosen by the
//    wrapper from (B, Hkv, S) alone so that B * Hkv * P >= 2 * 132 with at
//    least one tile a partition. The grid is (P, Hkv, B), 128 threads a
//    block.
//  * Loads: one thread copies a tile of K and one of V with Hopper's tensor
//    copies (TMA, a 4-D tensor map of the cache, one box of T positions of
//    one kv head), completing on an mbarrier, into a 2-3 stage ring, so the
//    next tiles stream while one computes (on the H100 this streamed the
//    decode shape faster than 16-byte cp.async copies issued by every
//    thread). A tile with no valid slot is never copied, so an
//    early ring costs only its valid part; the invalid slots of a copied
//    tile are masked. Rows that are not whole 16-byte units, or caches off
//    16-byte alignment, take a scalar copy path instead (padded rows).
//  * Compute: each of the 4 warps takes T / 4 positions of every tile and
//    keeps its own running softmax (m, l, acc) for the block's G query
//    heads, so a tile needs no block-wide max or sum: 32 / (T / 4) lanes
//    a position split its row's 16-byte chunks (starting at a rotated
//    chunk, so a quarter warp reads distinct banks of the dense rows) and
//    dot them with q (float32, shared memory) for all G heads at once; a
//    few shuffles join the parts and give the warp's max
//    and sum (masked scores never enter the max); for the values, a lane
//    owns the dim pairs lane, lane + 32, ... and accumulates the warp's
//    positions. The 4 warps' partials are merged once, at the end.
//  * P > 1: each block writes (acc, m, l) in float32 to a workspace
//    (B, Hq, P, hd + 2); a second kernel, one block per (b, query head),
//    merges the P partials and writes out. A partition with no valid slot
//    writes l = 0, m = -1e30 and is weighted 0 (no NaN). P = 1 writes out
//    directly. A query with no valid slot at all is refused by the wrapper.
//
// Products use fmaf (one rounding, as a float32 GEMM does); exps are the
// accurate expf. Build flags in kernels/_build.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 512;
constexpr int kMaxSmem = 232448;  // bytes a block can opt into on sm_90
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes of a row as floats: 4 float32 or 8 bf16.
__device__ __forceinline__ void chunk_f(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The valid slots as at most two intervals [lo0, hi0) and [lo1, hi1).
// Ring: the slots of ages 0 .. A-1 ending at pos mod S, where
// A = min(written, pos + 1[, window]) (age <= pos is abs >= 0; age < window
// is abs > pos - window). Flat: [max(0, pos - window + 1), min(length, S)).
struct Valid {
  int lo0, hi0, lo1, hi1;
  __device__ bool has(int c) const { return (c >= lo0 && c < hi0) || (c >= lo1 && c < hi1); }
  __device__ bool any(int a, int b) const {
    return (a < hi0 && b > lo0) || (a < hi1 && b > lo1);
  }
};

__device__ Valid valid_slots(int s, int pos, int length, int window, int ring) {
  Valid v{0, 0, 0, 0};
  if (ring) {
    const int written = min(length, s);
    long long a = min(static_cast<long long>(written), static_cast<long long>(pos) + 1);
    if (window > 0) a = min(a, static_cast<long long>(window));
    if (a <= 0) return v;
    if (a >= s) {
      v.hi0 = s;
      return v;
    }
    const int wp = pos % s;
    const int start = wp - static_cast<int>(a) + 1;
    if (start >= 0) {
      v.lo0 = start;
      v.hi0 = wp + 1;
    } else {
      v.hi0 = wp + 1;
      v.lo1 = s + start;
      v.hi1 = s;
    }
    return v;
  }
  v.lo0 = window > 0 ? max(0, pos - window + 1) : 0;
  v.hi0 = min(length, s);
  if (v.hi0 < v.lo0) v.hi0 = v.lo0;
  return v;
}

// Hopper's bulk tensor copy (the TMA unit, through a 4-D tensor map of the
// cache; see `tma_load_4d` below) into shared memory, completing on an mbarrier.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completes on `bar` with the box's bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy (bulk copy) writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory layout of the split kernel, in bytes. A tile of K (then
// one of V) takes TILE rows: dense (hd * item bytes, as the tensor copy
// writes them) on the TMA path, else padded to an odd number of 16-byte
// units; each tile starts on 128 bytes.
struct Layout {
  int rs;        // bytes a cache row takes
  int tb;        // bytes a tile takes (rounded up to 128)
  int qs;        // floats a q row takes (hd rounded up to 4)
  int ring;      // bytes of the stage ring (also holds the final merge of the warps)
  int off_q, off_p, off_bar;
  int total;
};

__host__ __device__ inline int row_bytes(int hd, int item, bool vec) {
  if (vec) return hd * item;
  int units = (hd * item + 15) / 16;
  if (units % 2 == 0) ++units;
  return units * 16;
}

inline Layout layout(int hd, int item, int tile, int stages, bool vec) {
  Layout l;
  l.rs = row_bytes(hd, item, vec);
  l.tb = (tile * l.rs + 127) / 128 * 128;
  l.qs = (hd + 3) / 4 * 4;
  const int merge = kWarps * kMaxG * (hd + 2) * 4;
  l.ring = stages * 2 * l.tb > merge ? stages * 2 * l.tb : merge;
  l.off_q = l.ring;
  l.off_p = l.off_q + kMaxG * l.qs * 4;
  l.off_bar = l.off_p + kWarps * kMaxG * (tile / kWarps) * 4;
  l.total = l.off_bar + 8 * stages;
  return l;
}

// TILE positions a tile; VEC: rows are whole 16-byte units at 16-byte
// aligned caches (tensor-copy path, `tmk` and `tmv` map the caches);
// NSLOT: dim pairs a lane owns in the values (ceil(hd / 64)).
template <typename T, int TILE, bool VEC, int NSLOT>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  T* __restrict__ out, float* __restrict__ ws, int s, int hkv, int hd, int g,
                  int pos, int length, int window, int ring, float cap, float scale,
                  int stages, int parts, int tiles_per_part, int rs, int tb, int qs,
                  int ring_bytes, const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv) {
  constexpr int PPW = TILE / kWarps;     // positions a warp takes in each tile
  constexpr int SPLIT = 32 / PPW;        // lanes a position in the score phase
  constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];  // tensor copies land on 128 bytes
  const Layout lay{rs, tb, qs, ring_bytes, ring_bytes, ring_bytes + kMaxG * qs * 4,
                   ring_bytes + kMaxG * qs * 4 + kWarps * kMaxG * PPW * 4, 0};
  float* sQ = reinterpret_cast<float*>(smem + lay.off_q);            // (kMaxG, qs)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.off_bar);  // one a stage

  const int part = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sP = reinterpret_cast<float*>(smem + lay.off_p) + warp * kMaxG * PPW;  // (kMaxG, PPW)
  const int item = sizeof(T);
  const long long row = static_cast<long long>(hkv) * hd;  // elements position to position
  const T* kb = kc + static_cast<long long>(bi) * s * row + static_cast<long long>(hi) * hd;
  const T* vb = vc + static_cast<long long>(bi) * s * row + static_cast<long long>(hi) * hd;
  const long long qbase = (static_cast<long long>(bi) * hkv + hi) * g * hd;
  const Valid valid = valid_slots(s, pos, length, window, ring);

  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd, d = i - gi * hd;
    sQ[gi * qs + d] = to_f(q[qbase + i]);
  }
  if (VEC && tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(bars + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  const int ntiles = (s + TILE - 1) / TILE;
  const int t_begin = part * tiles_per_part;
  const int t_end = min(ntiles, t_begin + tiles_per_part);
  auto next_valid = [&](int t) {
    while (t < t_end && !valid.any(t * TILE, min(s, t * TILE + TILE))) ++t;
    return t;
  };
  // One thread copies tile t of K and of V into a stage (two tensor copies;
  // rows past S are zero-filled) and arms the stage's barrier with their
  // bytes. Slots of the tile that are not valid are read and masked.
  auto issue = [&](int t, int st) {
    unsigned char* sk = smem + st * 2 * lay.tb;
    fence_proxy_async();
    mbar_expect_tx(bars + st, 2 * TILE * hd * item);
    tma_load_4d(sk, &tmk, 0, hi, t * TILE, bi, bars + st);
    tma_load_4d(sk + lay.tb, &tmv, 0, hi, t * TILE, bi, bars + st);
  };

  // Running softmax of this warp's positions, one per query head (lane-uniform).
  float m_run[kMaxG], l_run[kMaxG], acc[kMaxG][NSLOT][2];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m_run[gi] = kNegInf;
    l_run[gi] = 0.0f;
#pragma unroll
    for (int u = 0; u < NSLOT; ++u) acc[gi][u][0] = acc[gi][u][1] = 0.0f;
  }
  const int npairs = (hd + 1) / 2;

  int t_load = next_valid(t_begin);
  if (VEC && tid == 0) {
    for (int st = 0; st < stages - 1 && t_load < t_end; ++st) {
      issue(t_load, st);
      t_load = next_valid(t_load + 1);
    }
  }
  int k = 0;
  for (int t = next_valid(t_begin); t < t_end; t = next_valid(t + 1), ++k) {
    const int stage = VEC ? k % stages : 0;
    unsigned char* sk = smem + stage * 2 * lay.tb;
    unsigned char* sv = sk + lay.tb;
    const int c0 = t * TILE;
    if (VEC) {
      if (tid == 0) {
        if (t_load < t_end) {
          issue(t_load, (k + stages - 1) % stages);
          t_load = next_valid(t_load + 1);
        }
      }
      mbar_wait(bars + stage, (k / stages) & 1);
    } else {
      for (int i = tid; i < TILE * hd; i += kThreads) {
        const int r = i / hd, d = i - r * hd;
        const int c = c0 + r;
        const bool live = c < s && valid.has(c);
        const long long off = static_cast<long long>(c) * row + d;
        reinterpret_cast<T*>(sk + r * rs)[d] = live ? kb[off] : from_f<T>(0.0f);
        reinterpret_cast<T*>(sv + r * rs)[d] = live ? vb[off] : from_f<T>(0.0f);
      }
      __syncthreads();
    }

    // Scores of this warp's PPW positions: SPLIT lanes a position split its
    // row's chunks and dot them with q for all G heads at once.
    const int pl = lane / SPLIT, sp = lane - pl * SPLIT;
    const int p = warp * PPW + pl;
    const bool ok = c0 + p < s && valid.has(c0 + p);
    const T* krow = reinterpret_cast<const T*>(sk + p * rs);
    float dot[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) dot[gi] = 0.0f;
    if (VEC) {
      // Dense rows: each position starts its chunks at a rotated place so
      // that the positions of a quarter warp read distinct banks.
      const int nch = hd / EPC, kmax = (nch + SPLIT - 1) / SPLIT;
      int m = pl % kmax;
      for (int kk = 0; kk < kmax; ++kk) {
        const int ch = sp + SPLIT * m;
        if (++m == kmax) m = 0;
        if (ch >= nch) continue;
        float kv[EPC];
        chunk_f(krow + ch * EPC, kv);
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi >= g) break;
          const float* qr = sQ + gi * qs + ch * EPC;
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            dot[gi] = fmaf(qv.x, kv[e], dot[gi]);
            dot[gi] = fmaf(qv.y, kv[e + 1], dot[gi]);
            dot[gi] = fmaf(qv.z, kv[e + 2], dot[gi]);
            dot[gi] = fmaf(qv.w, kv[e + 3], dot[gi]);
          }
        }
      }
    } else {
      for (int d = sp; d < hd; d += SPLIT) {
        const float kv = to_f(krow[d]);
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi >= g) break;
          dot[gi] = fmaf(sQ[gi * qs + d], kv, dot[gi]);
        }
      }
    }
    float corr[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi >= g) break;
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], off);
      float sc = dot[gi] * scale;
      if (cap > 0.0f) sc = cap * tanhf(sc / cap);
      // The warp's max over its valid positions (masked scores never enter it).
      float mx = ok ? sc : kNegInf;
#pragma unroll
      for (int off = SPLIT; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[gi], mx);
      corr[gi] = expf(m_run[gi] - m_new);
      const float pr = ok ? expf(sc - m_new) : 0.0f;
      float sum = sp == 0 ? pr : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[gi] = l_run[gi] * corr[gi] + sum;
      m_run[gi] = m_new;
      if (sp == 0) sP[gi * PPW + pl] = pr;
    }
    __syncwarp();
    // Values: acc = acc * corr + probs @ v over this warp's positions; lane
    // owns the dim pairs lane, lane + 32, ...
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi >= g) break;
#pragma unroll
      for (int u = 0; u < NSLOT; ++u) {
        acc[gi][u][0] *= corr[gi];
        acc[gi][u][1] *= corr[gi];
      }
    }
#pragma unroll 4
    for (int pp = 0; pp < PPW; ++pp) {
      const T* vrow = reinterpret_cast<const T*>(sv + (warp * PPW + pp) * rs);
      float2 vv[NSLOT];
#pragma unroll
      for (int u = 0; u < NSLOT; ++u) {
        const int j = lane + 32 * u;
        vv[u] = j < npairs ? pair_f(vrow + 2 * j) : make_float2(0.0f, 0.0f);
        if (2 * j + 1 >= hd) vv[u].y = 0.0f;
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi >= g) break;
        const float pr = sP[gi * PPW + pp];
#pragma unroll
        for (int u = 0; u < NSLOT; ++u) {
          acc[gi][u][0] = fmaf(pr, vv[u].x, acc[gi][u][0]);
          acc[gi][u][1] = fmaf(pr, vv[u].y, acc[gi][u][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and sP) before it is refilled
  }

  // Merge the warps' partial softmaxes (the stage ring is free now).
  float* wm = reinterpret_cast<float*>(smem);      // (kWarps, kMaxG)
  float* wl = wm + kWarps * kMaxG;                 // (kWarps, kMaxG)
  float* wacc = wl + kWarps * kMaxG;               // (kWarps, g, hd)
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi >= g) break;
    if (lane == 0) {
      wm[warp * kMaxG + gi] = m_run[gi];
      wl[warp * kMaxG + gi] = l_run[gi];
    }
#pragma unroll
    for (int u = 0; u < NSLOT; ++u) {
      const int j = lane + 32 * u;
      if (j < npairs) {
        float* dst = wacc + (warp * g + gi) * hd + 2 * j;
        dst[0] = acc[gi][u][0];
        if (2 * j + 1 < hd) dst[1] = acc[gi][u][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd, d = i - gi * hd;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, wm[w * kMaxG + gi]);
    float lt = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kMaxG + gi] - mt);
      lt += wl[w * kMaxG + gi] * f;
      a += wacc[(w * g + gi) * hd + d] * f;
    }
    if (parts == 1) {
      out[qbase + i] = from_f<T>(a / fmaxf(lt, 1e-30f));
    } else {
      float* w = ws + ((qbase / hd + gi) * parts + part) * (hd + 2);
      w[d] = a;
      if (d == 0) {
        w[hd] = mt;
        w[hd + 1] = lt;
      }
    }
  }
}

// Merge P partials of one (b, query head): out = sum_p acc_p e^(m_p - M) /
// sum_p l_p e^(m_p - M), M = max_p m_p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ ws, T* __restrict__ out, int hq, int hd, int parts) {
  __shared__ float sW[kMaxParts];
  __shared__ float sLW[kMaxParts];
  const long long row = static_cast<long long>(blockIdx.y) * hq + blockIdx.x;
  const float* w = ws + row * parts * (hd + 2);
  float mt = kNegInf;
  for (int p = 0; p < parts; ++p) mt = fmaxf(mt, w[p * (hd + 2) + hd]);
  for (int p = threadIdx.x; p < parts; p += kThreads) {
    const float f = expf(w[p * (hd + 2) + hd] - mt);
    sW[p] = f;
    sLW[p] = w[p * (hd + 2) + hd + 1] * f;
  }
  __syncthreads();
  float lt = 0.0f;
  for (int p = 0; p < parts; ++p) lt += sLW[p];
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.0f;
    for (int p = 0; p < parts; ++p) a += w[p * (hd + 2) + d] * sW[p];
    out[row * hd + d] = from_f<T>(a / fmaxf(lt, 1e-30f));
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda needed).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A cache (b, s, hkv, hd) as a 4-D tensor map whose box is one kv head's
// `tile` consecutive positions: dims innermost first (hd, hkv, s, b).
cudaError_t encode_cache(CUtensorMap* map, const void* base, int b, int s, int hkv, int hd,
                         int item, int tile) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * item;
  const cuuint64_t strides[3] = {row, row * hkv, row * hkv * s};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), 1, static_cast<cuuint32_t>(tile), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         4, const_cast<void*>(base), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int TILE, bool VEC, int NSLOT>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out, float* ws,
                         int b, int s, int hkv, int hd, int g, int pos, int length, int window,
                         int ring, float cap, float scale, int stages, int parts, int tpp,
                         cudaStream_t st) {
  const Layout l = layout(hd, sizeof(T), TILE, stages, VEC);
  CUtensorMap mk{}, mv{};
  if (VEC) {
    const cudaError_t err = encode_cache(&mk, k, b, s, hkv, hd, sizeof(T), TILE) ;
    if (err != cudaSuccess) return err;
    const cudaError_t err2 = encode_cache(&mv, v, b, s, hkv, hd, sizeof(T), TILE);
    if (err2 != cudaSuccess) return err2;
  }
  auto kern = decode_attn_split<T, TILE, VEC, NSLOT>;
  // Opt in once per process (per instantiation): setting the attribute
  // before every launch slows the launches.
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  kern<<<dim3(parts, hkv, b), kThreads, l.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ws, s, hkv, hd, g, pos, length, window, ring, cap, scale, stages,
      parts, tpp, l.rs, l.tb, l.qs, l.ring, mk, mv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  merge_kernel<T><<<dim3(hkv * g, b), kThreads, 0, st>>>(ws, static_cast<T*>(out), hkv * g, hd,
                                                         parts);
  return cudaGetLastError();
}

template <typename T, int TILE, bool VEC>
cudaError_t launch_slots(const void* q, const void* k, const void* v, void* out, float* ws,
                         int b, int s, int hkv, int hd, int g, int pos, int length, int window,
                         int ring, float cap, float scale, int stages, int parts, int tpp,
                         cudaStream_t st) {
#define DA_ARGS q, k, v, out, ws, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, \
                stages, parts, tpp, st
  if (hd <= 64) return launch_split<T, TILE, VEC, 1>(DA_ARGS);
  if (hd <= 128) return launch_split<T, TILE, VEC, 2>(DA_ARGS);
  return launch_split<T, TILE, VEC, 4>(DA_ARGS);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* ws, int b,
                   int s, int hkv, int hd, int g, int pos, int length, int window, int ring,
                   float cap, float scale, int tile, int vec, int stages, int parts, int tpp,
                   cudaStream_t st) {
  if (tile == 64) {
    return vec ? launch_slots<T, 64, true>(DA_ARGS) : launch_slots<T, 64, false>(DA_ARGS);
  }
  return vec ? launch_slots<T, 32, true>(DA_ARGS) : launch_slots<T, 32, false>(DA_ARGS);
#undef DA_ARGS
}

}  // namespace

// Plain C entry point (loaded with ctypes). q (b, hkv * g, hd), k and v
// (b, s, hkv, hd), out like q, all row-major and of one type (`bf16` picks
// bfloat16 over float32); 1 <= g <= 8, 1 <= hd <= 256. `vec` (rows of whole
// 16-byte units at 16-byte aligned k and v) copies each tile of K and V
// with one TMA box of a 4-D tensor map, else the scalar copies. The cache is cut into
// tiles of `tile` (32 or 64) positions, `tiles_per_part` tiles to each of
// `parts` partitions; when parts > 1, `ws` is float32 (b, hkv * g, parts,
// hd + 2) scratch and a merge kernel follows (two launches). Launches on
// `stream`, allocates nothing, returns a CUDA error code.
extern "C" int decode_attn(const void* q, const void* k, const void* v, void* out, void* ws,
                           int b, int s, int hkv, int hd, int g, int pos, int length,
                           int window, int ring, float cap, float scale, int bf16, int tile,
                           int vec, int stages, int parts, int tiles_per_part, void* stream) {
  const int ntiles = (s + tile - 1) / tile;
  if (b < 1 || s < 1 || hkv < 1 || g < 1 || g > kMaxG || hd < 1 || hd > 256 || pos < 0 ||
      (tile != 32 && tile != 64) || (stages != 2 && stages != 3) || parts < 1 ||
      parts > kMaxParts || tiles_per_part < 1 || (parts - 1) * tiles_per_part >= ntiles ||
      parts * tiles_per_part < ntiles || (parts > 1 && ws == nullptr) ||
      layout(hd, bf16 ? 2 : 4, tile, stages, vec != 0).total > kMaxSmem ||
      (vec && (hd * (bf16 ? 2 : 4)) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, out, w, b, s, hkv, hd, g, pos, length, window, ring,
                                   cap, scale, tile, vec, stages, parts, tiles_per_part, st)
           : launch<float>(q, k, v, out, w, b, s, hkv, hd, g, pos, length, window, ring, cap,
                           scale, tile, vec, stages, parts, tiles_per_part, st);
  return static_cast<int>(err);
}

// The merge kernel alone (for holding it against its plain version): ws
// float32 (b, hq, parts, hd + 2) partials (acc, m, l), out (b, hq, hd) of
// the type `bf16` picks; parts >= 2.
extern "C" int decode_attn_merge(const void* ws, void* out, int b, int hq, int hd, int parts,
                                 int bf16, void* stream) {
  if (b < 1 || hq < 1 || hd < 1 || hd > 256 || parts < 2 || parts > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  if (bf16) {
    merge_kernel<__nv_bfloat16><<<dim3(hq, b), kThreads, 0, st>>>(
        w, static_cast<__nv_bfloat16*>(out), hq, hd, parts);
  } else {
    merge_kernel<float><<<dim3(hq, b), kThreads, 0, st>>>(w, static_cast<float*>(out), hq,
                                                              hd, parts);
  }
  return static_cast<int>(cudaGetLastError());
}
