// One-token GQA flash-decode for Hopper (sm_90a).
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
// Design. The TPU ran a grid (B, Hkv, S / C) whose last axis is sequential,
// carrying (m, l, acc) in VMEM across cache tiles. Here one block owns one
// (b, h) and its W warps split the cache between them: warp w takes the
// positions w*U .. w*U+U-1, then the next W*U, and so on, keeping its own
// running (m, l, acc) in registers (lane j holds head dims j, j+32, ...).
// A warp reads a key row with its 32 lanes side by side, reduces the dot
// product with shuffles (every lane ends with the same sum), and reads the
// value row the same way. At the end the W partial softmaxes are merged in
// shared memory. W is 16 for one query head per kv head (MHA, Zamba2's
// shared block) and 8 for GQA groups, whose (G, hd) accumulators take more
// registers: with one block per (b, h) the warps are all the card has to
// hide its memory latency with, and at Zamba2's decode shape 16 warps ran
// several times faster than 8 on the H100. Masked positions are skipped:
// their rows are never read, so a ring cache that is mostly unwritten costs
// what its valid part costs.
// Masked scores never enter a max, so no -inf arithmetic arises; a query
// with no valid position at all would get zeros where the plain version
// averages the whole cache, so the wrapper refuses such a call (the serving
// path always has the token's own slot).
//
// What bounds it: bytes. Each valid K and V row is read once (at B = 2, a
// 4096-slot ring, Hkv = 32, hd = 80 in bf16: 84 MB, 0.025 ms at 3.35
// TB/s); the arithmetic is 2 * hd multiply-adds and two exps per position
// and head. B * Hkv blocks (64 at Zamba2's decode, 8 at a qwen2-like GQA
// shape) leave SMs idle; splitting the cache over more blocks with a second
// merge pass (flash-decoding) is the next step for this kernel.
//
// Build without fast math and with -fmad=false (kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 8;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool is_valid(int c, int s, int pos, int length, int window,
                                         bool ring, int written, int wp) {
  if (ring) {
    int age = wp - c;  // (wp - c) mod s, non-negative
    if (age < 0) age += s;
    const int abs_pos = pos - age;
    return age < written && abs_pos >= 0 && (window <= 0 || abs_pos > pos - window);
  }
  return c < length && (window <= 0 || c > pos - window);
}

// NPL: head dims per lane (ceil(hd / 32)); G_MAX: query heads per kv head
// held in registers (the runtime g <= G_MAX); U: positions a warp takes at
// a time (their loads are in flight together); W: warps a block.
template <typename T, int NPL, int G_MAX, int U, int W>
__global__ void __launch_bounds__(W * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, T* __restrict__ out, int s, int hkv,
                   int hd, int g, int pos, int length, int window, int ring,
                   float cap, float scale) {
  extern __shared__ float smem[];
  float* sm_m = smem;               // (W, G_MAX)
  float* sm_l = sm_m + W * G_MAX;   // (W, G_MAX)
  float* sm_acc = sm_l + W * G_MAX; // (W, g, hd)

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qbase = (static_cast<long long>(bi) * hkv + hi) * g * hd;
  const long long row = static_cast<long long>(hkv) * hd;  // position to position
  const long long kbase = static_cast<long long>(bi) * s * row + static_cast<long long>(hi) * hd;
  const int written = min(length, s);
  const int wp = ((pos % s) + s) % s;

  float qr[G_MAX][NPL], acc[G_MAX][NPL], m[G_MAX], l[G_MAX];
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = lane + 32 * j;
      qr[gi][j] = (gi < g && d < hd) ? to_f(q[qbase + gi * hd + d]) : 0.0f;
      acc[gi][j] = 0.0f;
    }
  }

  for (int c0 = warp * U; c0 < s; c0 += W * U) {
    bool ok[U];
    float kr[U][NPL], vr[U][NPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      ok[u] = c < s && is_valid(c, s, pos, length, window, ring != 0, written, wp);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int d = lane + 32 * j;
        const bool live = ok[u] && d < hd;
        kr[u][j] = live ? to_f(kc[kbase + c * row + d]) : 0.0f;
        vr[u][j] = live ? to_f(vc[kbase + c * row + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi) {
      if (gi >= g) break;
      float sc[U];
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) dot += qr[gi][j] * kr[u][j];
        dot = warp_sum(dot) * scale;
        if (cap > 0.0f) dot = cap * tanhf(dot / cap);
        sc[u] = dot;
        if (ok[u]) mx = fmaxf(mx, dot);
      }
      const float corr = expf(m[gi] - mx);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = ok[u] ? expf(sc[u] - mx) : 0.0f;
        psum += sc[u];
      }
      l[gi] = l[gi] * corr + psum;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        float a = acc[gi][j] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a += sc[u] * vr[u][j];
        acc[gi][j] = a;
      }
      m[gi] = mx;
    }
  }

  // Merge the warps' partial softmaxes.
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi) {
    if (gi >= g) break;
    if (lane == 0) {
      sm_m[warp * G_MAX + gi] = m[gi];
      sm_l[warp * G_MAX + gi] = l[gi];
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) sm_acc[(warp * g + gi) * hd + d] = acc[gi][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * hd; i += W * 32) {
    const int gi = i / hd, d = i - gi * hd;
    float mt = kNegInf;
    for (int w = 0; w < W; ++w) mt = fmaxf(mt, sm_m[w * G_MAX + gi]);
    float lt = 0.0f, at = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float f = expf(sm_m[w * G_MAX + gi] - mt);
      lt += sm_l[w * G_MAX + gi] * f;
      at += sm_acc[(w * g + gi) * hd + d] * f;
    }
    out[qbase + i] = from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int NPL, int G_MAX>
cudaError_t launch3(const void* q, const void* k, const void* v, void* out, int b, int s,
                    int hkv, int hd, int g, int pos, int length, int window, int ring,
                    float cap, float scale, cudaStream_t st) {
  constexpr int U = (G_MAX == 1 && NPL <= 4) ? 8 : (NPL <= 4 ? 4 : 2);
  constexpr int W = G_MAX == 1 ? 16 : 8;
  constexpr int kMaxBytes = (2 * W * G_MAX + W * G_MAX * 32 * NPL) * sizeof(float);
  auto kern = decode_attn_kernel<T, NPL, G_MAX, U, W>;
  if (kMaxBytes > kDefaultSmem) {
    // Opt in once per process (per instantiation): on the card, setting the
    // attribute before every launch slowed the launches measurably.
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (opt_in != cudaSuccess) return opt_in;
  }
  const size_t bytes = (2 * W * G_MAX + static_cast<size_t>(W) * g * hd) * sizeof(float);
  kern<<<dim3(hkv, b), W * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, hkv, hd, g, pos, length, window, ring, cap, scale);
  return cudaGetLastError();
}

template <typename T, int NPL>
cudaError_t launch2(const void* q, const void* k, const void* v, void* out, int b, int s,
                    int hkv, int hd, int g, int pos, int length, int window, int ring,
                    float cap, float scale, cudaStream_t st) {
  return g == 1 ? launch3<T, NPL, 1>(q, k, v, out, b, s, hkv, hd, g, pos, length, window,
                                     ring, cap, scale, st)
                : launch3<T, NPL, kMaxG>(q, k, v, out, b, s, hkv, hd, g, pos, length,
                                         window, ring, cap, scale, st);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s,
                   int hkv, int hd, int g, int pos, int length, int window, int ring,
                   float cap, float scale, cudaStream_t st) {
  const int npl = (hd + 31) / 32;
  switch (npl) {
    case 1: return launch2<T, 1>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
    case 2: return launch2<T, 2>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
    case 3: return launch2<T, 3>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
    case 4: return launch2<T, 4>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
    default: return launch2<T, 8>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q (b, hkv * g, hd), k and v
// (b, s, hkv, hd), out like q, all row-major and of one type (`bf16` picks
// bfloat16 over float32); 1 <= g <= 8, 1 <= hd <= 256. Launches on
// `stream`, allocates nothing, returns a CUDA error code.
extern "C" int decode_attn(const void* q, const void* k, const void* v, void* out, int b,
                           int s, int hkv, int hd, int g, int pos, int length, int window,
                           int ring, float cap, float scale, int bf16, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || g < 1 || g > kMaxG || hd < 1 || hd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st)
           : launch<float>(q, k, v, out, b, s, hkv, hd, g, pos, length, window, ring, cap, scale, st);
  return static_cast<int>(err);
}
