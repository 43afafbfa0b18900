// Chunked diagonal-decay linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `chunk_scan_pallas` in
// src/repro/kernels/chunk_scan/kernel.py (body `_chunk_scan_kernel`), the
// shared core of Mamba2 (SSD) and RWKV6. Per (batch, head) it carries a
// (dk, dv) float32 state S across chunks of C tokens:
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
// Design. The TPU ran a grid (B*H, chunks) whose last axis is sequential,
// carrying S in VMEM scratch. Hopper's blocks run in no order, so here one
// block owns one (b, h) and loops over its chunks, S living in shared memory
// for the whole sequence. The Pallas body built a (C, C, dk) ratio tile
// (1 MB at C = 64); this kernel never builds it: a thread owns one (t, i)
// entry of A and contracts over d in registers, reading q, k, Lq and L rows
// from shared memory (rows padded to dk + 1 floats, so the 32 lanes of a
// warp, which hold 32 neighbouring i, hit 32 banks). The layout is the
// caller's (B, S, H, d), read by strides: no transpose.
//
// Shared memory, in floats: L, Lprev, k and q tiles C*(dk+1) each, v C*dv,
// A C*(C+1), S dk*dv, u dk. At the Zamba2 shape (C = 32, dk = dv = 64) that
// is 52 KB, past the 48 KB default, so the launcher opts in to the card's
// 227 KB once; the wrapper refuses shapes past it. The chunk is a runtime
// argument <= 64.
//
// What bounds it: operations. Per chunk a block does C(C+1)/2 * dk
// exp-multiply-adds for A (half of the C*C*dk the mask allows nothing for)
// and three C*dk*dv-sized contractions; each input element is read once
// and each output written once (bytes: w in float32, k, q, v and y in their
// type, the states). At B = 2, S = 4096, H = 80, dk = dv = 64, C = 32 that
// is 0.69 G exps against 0.5 GB of traffic. B*H blocks (160 there) fill the
// card's 132 SMs a little over once; the dv columns of S are independent,
// so a later version can split them over more blocks, and for Mamba2 the
// decay is one scalar per head, which would take A's exps from C*C*dk to
// C*C a chunk.
//
// Build without fast math and with -fmad=false (kernels/_build.py): `logf`
// and `expf` keep the kernel within float32 rounding of its plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
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

size_t smem_floats(int c, int dk, int dv) {
  return 4 * static_cast<size_t>(c) * (dk + 1) + static_cast<size_t>(c) * dv +
         static_cast<size_t>(c) * (c + 1) + static_cast<size_t>(dk) * dv + dk;
}

template <typename T, bool kIncludeCurrent>
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const float* __restrict__ w, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ q,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ s_out, int s_len,
                  int h, int dk, int dv, int c) {
  extern __shared__ float smem[];
  const int dkp = dk + 1;
  float* sL = smem;              // (c, dkp) inclusive cumulative log decay
  float* sLp = sL + c * dkp;     // (c, dkp) lw, then Lprev = L - lw
  float* sK = sLp + c * dkp;     // (c, dkp) k, then k * exp(Lc - L)
  float* sQ = sK + c * dkp;      // (c, dkp) q, then q * exp(Lq)
  float* sV = sQ + c * dkp;      // (c, dv)
  float* sA = sV + c * dv;       // (c, c + 1)
  float* sS = sA + c * (c + 1);  // (dk, dv) state
  float* sU = sS + dk * dv;      // (dk) u bonus (rwkv6)
  const float* sLq = kIncludeCurrent ? sL : sLp;

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh - b * h;
  const int tid = threadIdx.x;
  const long long kstride = static_cast<long long>(h) * dk;  // token to token
  const long long vstride = static_cast<long long>(h) * dv;
  const long long kbase = (static_cast<long long>(b) * s_len * h + hh) * dk;
  const long long vbase = (static_cast<long long>(b) * s_len * h + hh) * dv;
  const long long sbase = static_cast<long long>(bh) * dk * dv;

  for (int i = tid; i < dk * dv; i += kThreads) sS[i] = s0 ? s0[sbase + i] : 0.0f;
  if (!kIncludeCurrent) {
    for (int d = tid; d < dk; d += kThreads) sU[d] = u ? u[hh * dk + d] : 0.0f;
  }

  const int n = s_len / c;
  for (int ci = 0; ci < n; ++ci) {
    const int t0 = ci * c;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < c * dk; i += kThreads) {
      const int t = i / dk, d = i - t * dk;
      const long long g = kbase + static_cast<long long>(t0 + t) * kstride + d;
      sLp[t * dkp + d] = fminf(fmaxf(logf(fmaxf(w[g], 1e-30f)), kLogWMin), 0.0f);
      sK[t * dkp + d] = to_f(k[g]);
      sQ[t * dkp + d] = to_f(q[g]);
    }
    for (int i = tid; i < c * dv; i += kThreads) {
      const int t = i / dv, e = i - t * dv;
      sV[i] = to_f(v[vbase + static_cast<long long>(t0 + t) * vstride + e]);
    }
    __syncthreads();
    for (int d = tid; d < dk; d += kThreads) {  // cumsum over the chunk
      float run = 0.0f;
      for (int t = 0; t < c; ++t) {
        const float lw = sLp[t * dkp + d];
        run = run + lw;
        sL[t * dkp + d] = run;
        sLp[t * dkp + d] = run - lw;
      }
    }
    __syncthreads();
    for (int i = tid; i < c * c; i += kThreads) {  // A, one entry a thread
      const int t = i / c, j = i - t * c;
      const float* qr = sQ + t * dkp;
      const float* kr = sK + j * dkp;
      float a = 0.0f;
      if (kIncludeCurrent ? j <= t : j < t) {
        const float* lq = sLq + t * dkp;
        const float* lk = sL + j * dkp;
        for (int d = 0; d < dk; ++d) a += expf(lq[d] - lk[d]) * qr[d] * kr[d];
      } else if (!kIncludeCurrent && j == t) {
        for (int d = 0; d < dk; ++d) a += qr[d] * sU[d] * kr[d];
      }
      sA[t * (c + 1) + j] = a;
    }
    __syncthreads();
    const float* lc = sL + (c - 1) * dkp;  // the chunk's total decay
    for (int i = tid; i < c * dk; i += kThreads) {
      const int t = i / dk, d = i - t * dk;
      sQ[t * dkp + d] = sQ[t * dkp + d] * expf(sLq[t * dkp + d]);
      sK[t * dkp + d] = sK[t * dkp + d] * expf(lc[d] - sL[t * dkp + d]);
    }
    __syncthreads();
    for (int i = tid; i < c * dv; i += kThreads) {  // y = qs @ S + A @ v
      const int t = i / dv, e = i - t * dv;
      float ys = 0.0f;
      for (int d = 0; d < dk; ++d) ys += sQ[t * dkp + d] * sS[d * dv + e];
      float ya = 0.0f;
      for (int j = 0; j <= t; ++j) ya += sA[t * (c + 1) + j] * sV[j * dv + e];
      y[vbase + static_cast<long long>(t0 + t) * vstride + e] = from_f<T>(ys + ya);
    }
    __syncthreads();  // y has read S
    for (int i = tid; i < dk * dv; i += kThreads) {  // S = exp(Lc) S + k_dec^T v
      const int d = i / dv, e = i - d * dv;
      float kv = 0.0f;
      for (int j = 0; j < c; ++j) kv += sK[j * dkp + d] * sV[j * dv + e];
      sS[i] = expf(lc[d]) * sS[i] + kv;
    }
  }
  __syncthreads();
  for (int i = tid; i < dk * dv; i += kThreads) s_out[sbase + i] = sS[i];
}

template <typename T, bool kIncludeCurrent>
cudaError_t launch(const float* w, const void* k, const void* v, const void* q,
                   const float* u, const float* s0, void* y, float* s_out, int b,
                   int s_len, int h, int dk, int dv, int c, cudaStream_t st) {
  const size_t bytes = smem_floats(c, dk, dv) * sizeof(float);
  auto kern = chunk_scan_kernel<T, kIncludeCurrent>;
  // Opt in to the card's limit once per process (per instantiation); each
  // launch then asks for what its chunk and widths need.
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  kern<<<b * h, kThreads, bytes, st>>>(
      w, static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(q),
      u, s0, static_cast<T*>(y), s_out, s_len, h, dk, dv, c);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block needs at chunk c and widths dk, dv.
extern "C" int chunk_scan_smem_bytes(int c, int dk, int dv) {
  return static_cast<int>(smem_floats(c, dk, dv) * sizeof(float));
}

// Plain C entry point (loaded with ctypes). w (b, s_len, h, dk) float32;
// k, q (b, s_len, h, dk) and v (b, s_len, h, dv) of one type (`bf16` picks
// bfloat16 over float32); u (h, dk) float32 or null (zeros); s0
// (b, h, dk, dv) float32 or null (zeros); y like v; s_out (b, h, dk, dv)
// float32. All row-major; s_len % c == 0, 1 <= c <= 64. Launches on
// `stream`, allocates nothing, returns a CUDA error code.
extern "C" int chunk_scan(const float* w, const void* k, const void* v,
                          const void* q, const float* u, const float* s0,
                          void* y, float* s_out, int b, int s_len, int h, int dk,
                          int dv, int c, int include_current, int bf16,
                          void* stream) {
  if (c < 1 || c > kMaxChunk || s_len % c != 0 || dk < 1 || dv < 1 || b < 1 ||
      h < 1 || smem_floats(c, dk, dv) * sizeof(float) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = include_current
              ? launch<__nv_bfloat16, true>(w, k, v, q, u, s0, y, s_out, b, s_len, h, dk, dv, c, st)
              : launch<__nv_bfloat16, false>(w, k, v, q, u, s0, y, s_out, b, s_len, h, dk, dv, c, st);
  } else {
    err = include_current
              ? launch<float, true>(w, k, v, q, u, s0, y, s_out, b, s_len, h, dk, dv, c, st)
              : launch<float, false>(w, k, v, q, u, s0, y, s_out, b, s_len, h, dk, dv, c, st);
  }
  return static_cast<int>(err);
}
