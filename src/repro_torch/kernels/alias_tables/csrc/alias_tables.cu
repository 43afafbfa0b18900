// Vose alias tables of a sweep's proposal rows for Hopper (sm_90a), bit for
// bit those PyTorch's CUDA operations give for `core/alias.build_alias_tables`
// (`_build_rows`), which is the plain version and the yardstick here.
//
// For each row of counts and its prior, probs = counts + prior (K masses),
// and its sum rs (`probs.sum(-1)`, see below):
//
//   mass_c   = rs > 0 ? probs_c * ((1 / rs) * K) : 1     (`k / rs` is
//              `rs.reciprocal() * k` in PyTorch; the operand order is kept)
//   light_c  = mass_c < 1; order = the lights in column order, then the
//              heavies in column order (the stable argsort), as a ballot and
//              a prefix popcount per tile of 32 columns or fewer
//   D, E     = inclusive scans, in sorted order, of the deficit (1 - m on
//              the lights, else 0) and the excess (m - 1 on the heavies)
//   light p  thresh = m_p, alias = order[min(upper_bound(E, D_p - deficit_p), K-1)]
//   heavy p  thresh = clamp((E_p + 1) - D_ext[min(lower_bound(D_ext, E_p), K)], 0, 1)
//            alias  = order[min(p + 1, K - 1)]              (D_ext = [0, D])
//
// written once, in column order: thresh[order[p]], alias[order[p]].
//
// Why the same bits. An alias entry is read off the scans by a search, so a
// scan that rounds differently moves donors near their boundaries; the
// kernel therefore keeps PyTorch's orders. The scans follow
// `tensor_kernel_scan_innermost_dim` (ATen/native/cuda/ScanUtils.cuh): a row
// is cut into chunks of 2^(log_x + 1) columns; the previous chunk's total is
// added to the chunk's first entry, then a Sklansky tree runs over the chunk
// (level m adds entry ((j >> m) << (m + 1)) + 2^m - 1 into the next 2^m
// entries). log_x comes from `get_log_num_threads_x_inner_scan(rows, K)` in
// uint32_t arithmetic, wrap included (`scan_log_x` below), for the table's
// own row count; at K 256 and 250,000 or 200,000 rows it is 9, so a row is
// one tree, while 129 to 131,072 rows give chunks of 32 with a carry. The
// searches give `searchsorted`'s answers (ATen/native/cuda/Bucketization.cu)
// as counts, which the curves' monotony makes equal to its binary search.
// Every elementwise step takes PyTorch's operands in its order, and the
// library builds with -fmad=false. A one-row table is the one case this
// does not cover: PyTorch scans it with cub's device-wide scan, whose order
// is not copied here; the kernel scans it as above, and the tests hold it
// to the plain build's distribution rather than its bits.
//
// The row sum follows `Reduce.cuh`, whose order depends on the shape
// (`setReduceConfig`). Where PyTorch gives a row one warp with 4-wide
// vector loads (K a multiple of 4 in [132, 8160], at least 16 rows), lane x
// adds vectors x, x + 32, ... into four accumulators, combines them in
// order and a shuffle tree (offsets 16, 8, 4, 2, 1) sums the lanes: the
// kernel sums so (`warp_row_sum`). Elsewhere (a row split over warps or
// blocks, scalar loads, more threads a row when rows are few) the wrapper
// passes PyTorch's own row sums: two PyTorch operations a table
// ((counts + prior).sum(-1)) before the launch.
//
// Shape: a team of T threads builds a row, T = next_pow2(K) / 8 within
// [1, 1024]: several rows a warp at small K, a warp a row at K 256, a block
// a row from K 257 on. The team loads the row in column order and splits it
// by ballots; then each thread holds a block of 8 consecutive sorted
// positions in registers: it runs the scan's first three tree levels there
// and the rest through one shared word a block, and reads its 8 thresholds
// and aliases off the curves with 8 searches in step, a thread moving its
// block with 16-byte shared accesses. A team keeps its row in shared
// memory, about 25 K bytes (the kernel is opted in to the card's 227 KB);
// past K 9,288 the same layout lives in a global scratch the wrapper
// allocates (`alias_tables_workspace`), and a row past 8,192 positions is
// scanned in rounds of 8 T. One launch builds both tables of a sweep, the
// word rows then the doc rows, each under its own scan split; the grid is
// what the card holds at once, and teams stride over the rows.
//
// What bounds it: bytes. A row reads 4 K bytes and writes 8 K; at K 256 and
// 450,000 rows that is 1.38 GB, 0.41 ms at 3.35 TB/s. The kernel takes about
// 2.1 ms there, held by the instructions of its per-row work in shared
// memory, the searches most of all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // threads a block when a team is a warp or less
constexpr int kMaxTeam = 1024;
constexpr int kMaxSmem = 232448;   // the H100's opt-in dynamic shared memory a block
constexpr int kPer = 8;            // consecutive sorted positions a thread scans and reads off
constexpr int kSegWords = 33;      // per-warp light counts of a block team, its row sum

struct Table {
  const float* counts;   // (rows, k)
  float prior;
  const float* row_sum;  // (rows,) PyTorch's sums of counts + prior, or null: summed here
  float* thresh;         // (rows, k)
  int32_t* alias;        // (rows, k)
  long long rows;
  int log_x;             // PyTorch's scan split: chunks of 2^(log_x + 1)
};

// `get_log_num_threads_x_inner_scan<uint32_t>(num_rows, row_size)`, unsigned
// wrap and all.
int scan_log_x(long long rows, int k) {
  uint32_t lx = 0, ly = 0;
  while ((1u << lx) < static_cast<uint32_t>(k)) ++lx;
  while ((1ull << ly) < static_cast<unsigned long long>(rows)) ++ly;
  const uint32_t diff = lx - ly;
  uint32_t log_x = (9u + diff) / 2u;
  if (log_x < 4u) log_x = 4u;
  if (log_x > 9u) log_x = 9u;
  return static_cast<int>(log_x);
}

int team_log(int k) {
  int p = 0;
  while ((1 << p) < k) ++p;
  p -= 3;
  return p < 0 ? 0 : (p > 10 ? 10 : p);
}

// 4-byte words of a team's row, each array 16-byte aligned over Kp = K
// rounded up to 8: sorted masses, order, D, E, two column-order arrays
// (light counts, then the staged outputs), the last D and E of each block of
// 8 positions, the per-warp light counts and the row sum.
__host__ __device__ inline int padded(int k) { return (k + 7) & ~7; }
__host__ __device__ inline int block_words(int k) { return ((padded(k) / kPer) + 3) & ~3; }
__host__ __device__ inline long long team_words(int k) {
  return 6LL * padded(k) + 2LL * block_words(k) + kSegWords + 3;
}

struct Team {
  int size;       // T, a power of two
  int lane;       // 0 .. T-1
  int base;       // the team's first lane in its warp (T < 32)
  unsigned mask;  // the team's lanes of its warp
  __device__ __forceinline__ void sync() const {
    if (size > 32) __syncthreads(); else __syncwarp(mask);
  }
};

// `probs.sum(-1)` of one row as PyTorch sums it with a warp a row and 4-wide
// loads (K a multiple of 4): lane x's four accumulators over vectors x,
// x + 32, ..., combined in order, then the lanes by a shuffle tree. Every
// lane of the warp calls it; lane 0 holds the sum.
__device__ __forceinline__ float warp_row_sum(const float* __restrict__ counts, float prior,
                                              int k, int lane) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int v = lane; 4 * v + 3 < k; v += 32) {
    const float4 q = reinterpret_cast<const float4*>(counts)[v];
    a0 = a0 + (q.x + prior);
    a1 = a1 + (q.y + prior);
    a2 = a2 + (q.z + prior);
    a3 = a3 + (q.w + prior);
  }
  float s = ((a0 + a1) + a2) + a3;
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ void load8(const float* a, int p0, float (&x)[kPer]) {
  const float4 lo = *reinterpret_cast<const float4*>(a + p0);
  const float4 hi = *reinterpret_cast<const float4*>(a + p0 + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void store8(float* a, int p0, const float (&x)[kPer]) {
  *reinterpret_cast<float4*>(a + p0) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(a + p0 + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ void build_row(const Team& t, uint32_t* w, const float* __restrict__ counts,
                          float prior, const float* row_sum, float* __restrict__ thresh,
                          int32_t* __restrict__ alias, int k, int log_x) {
  const int kp = padded(k), nbw = block_words(k);
  float* ms = reinterpret_cast<float*>(w);                  // sorted masses
  int32_t* order = reinterpret_cast<int32_t*>(w + kp);      // column at each sorted position
  float* d = reinterpret_cast<float*>(w + 2 * kp);          // D
  float* e = reinterpret_cast<float*>(w + 3 * kp);          // E (masses, before step 3)
  int32_t* pos = reinterpret_cast<int32_t*>(w + 4 * kp);    // then the staged thresholds
  int32_t* out_alias = reinterpret_cast<int32_t*>(w + 5 * kp);
  float* last_d = reinterpret_cast<float*>(w + 6 * kp);     // D and E at each block's end
  float* last_e = last_d + nbw;
  int32_t* seg_lights = reinterpret_cast<int32_t*>(w + 6 * kp + 2 * nbw);
  float* shared_sum = reinterpret_cast<float*>(seg_lights + 32);

  float rs;
  if (row_sum != nullptr) {
    rs = *row_sum;
  } else if (t.size == 32) {
    rs = __shfl_sync(0xffffffffu, warp_row_sum(counts, prior, k, t.lane), 0);
  } else {  // a block team: its first warp sums
    if (t.lane < 32) {
      const float s = warp_row_sum(counts, prior, k, t.lane);
      if (t.lane == 0) *shared_sum = s;
    }
    t.sync();
    rs = *shared_sum;
  }
  const bool ok = rs > 0.0f;
  const float scale = (1.0f / (ok ? rs : 1.0f)) * static_cast<float>(k);

  // 1. Masses, and each column's count of lights before it. A block team
  // cuts the row into one segment a warp; a warp or a smaller team has one.
  const int sub = t.size > 32 ? 32 : t.size;
  const int nseg = t.size / sub;
  const int seg = t.lane / sub;
  const int sl = t.lane - seg * sub;
  const int len = (k + nseg - 1) / nseg;
  const int lo = min(k, seg * len), hi = min(k, lo + len);
  const unsigned wmask = t.size >= 32 ? 0xffffffffu : t.mask;
  const unsigned below = (1u << sl) - 1u;
  int lights = 0;
  for (int b = lo; b < hi; b += sub) {
    const int c = b + sl;
    const bool in = c < hi;
    float m = 0.0f;
    if (in) m = ok ? (counts[c] + prior) * scale : 1.0f;
    const unsigned vote = __ballot_sync(wmask, in && m < 1.0f);
    const unsigned own = t.size >= 32 ? vote : (vote >> t.base) & ((1u << t.size) - 1u);
    if (in) {
      e[c] = m;
      pos[c] = lights + __popc(own & below);
    }
    lights += __popc(own);
  }
  int before_seg = 0, total = lights;
  if (nseg > 1) {
    if (sl == 0) seg_lights[seg] = lights;
    t.sync();
    total = 0;
    for (int s = 0; s < nseg; ++s) {
      if (s < seg) before_seg += seg_lights[s];
      total += seg_lights[s];
    }
  }
  // 2. The stable partition: lights first, then heavies, each in column order.
  for (int c = lo + sl; c < hi; c += sub) {
    const float m = e[c];
    const int lights_before = pos[c] + before_seg;
    const int p = m < 1.0f ? lights_before : total + (c - lights_before);
    ms[p] = m;
    order[p] = c;
  }
  t.sync();

  // 3. Deficit and excess in sorted order, and both inclusive scans in
  // PyTorch's order: chunks one after another, the previous chunk's total
  // added to a chunk's first entry, then the chunk's tree. A thread holds the
  // block of positions p0 .. p0 + 7; level m adds the last entry of the block
  // of 2^m below into each entry whose bit m is set. Levels 0-2 stay in the
  // thread; from level 3 a thread adds one value, published in `last_*` by
  // the block that ends there, to all 8 of its entries (the source's bit m is
  // clear, so it does not change at that level: one sync a level is enough).
  // A block's final last entries stay in `last_*`, +inf for a part-filled
  // last block, for the searches.
  const int chunk = 2 << log_x;  // 32 .. 1024, a multiple of kPer
  const int span = kPer * t.size;
  const float inf = __int_as_float(0x7f800000);
  for (int rb = 0; rb < k; rb += span) {
    const int p0 = rb + kPer * t.lane;
    const int blk = p0 / kPer;
    float dv[kPer] = {}, ev[kPer];
    if (p0 < k) load8(ms, p0, dv);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j;
      const float m = dv[j];
      dv[j] = p < k && p < total ? 1.0f - m : 0.0f;
      ev[j] = p < k && p >= total ? m - 1.0f : 0.0f;
    }
    const int live = min(span, k - rb);
    for (int cb = rb; cb < rb + live; cb += chunk) {
      const int n = min(chunk, rb + live - cb);
      const int r = p0 - cb;  // this thread's first position within the chunk
      const bool mine = r >= 0 && r < n;  // its block has live positions in the chunk
      if (mine && r == 0 && cb > 0) {
        dv[0] = dv[0] + d[cb - 1];
        ev[0] = ev[0] + e[cb - 1];
      }
      if (mine) {
#pragma unroll
        for (int lv = 0; lv < 3; ++lv) {
          const int s = 1 << lv;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            if (j & s) {
              const int si = ((j >> (lv + 1)) << (lv + 1)) + s - 1;
              dv[j] = dv[j] + dv[si];
              ev[j] = ev[j] + ev[si];
            }
          }
        }
      }
      for (int lv = 3; (1 << lv) < n; ++lv) {
        if (mine) {
          last_d[blk] = dv[kPer - 1];
          last_e[blk] = ev[kPer - 1];
        }
        t.sync();
        if (mine && ((r >> lv) & 1)) {
          const int sb = (cb + ((r >> (lv + 1)) << (lv + 1)) + (1 << lv) - 1) / kPer;
          const float sd = last_d[sb], se = last_e[sb];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            dv[j] = dv[j] + sd;
            ev[j] = ev[j] + se;
          }
        }
      }
      if (mine) {
        store8(d, p0, dv);
        store8(e, p0, ev);
        const bool full = p0 + kPer <= k;
        last_d[blk] = full ? dv[kPer - 1] : inf;
        last_e[blk] = full ? ev[kPer - 1] : inf;
      }
      t.sync();
    }
  }

  // 4. Every threshold and alias off the curves, a block of 8 positions a
  // thread. Both curves are non-decreasing (a deficit or an excess is >= 0
  // for any mass but NaN, and a scan of such terms in any tree order is
  // monotone), so `searchsorted`'s answer is a count: for a light, the
  // donor is the count of E <= D_p - deficit_p (`right=True`); for a heavy,
  // `closer` is the count of [0, D] below E_p, that is 1 (for the 0) if E_p >
  // 0 plus the count of D <= the float below E_p. A count descends by powers
  // of two over the blocks' last entries (one word a block: no bank
  // conflicts), then over the 8 entries of the block it lands in; the 8
  // counts go in step. Outputs are staged by column.
  float* out_thresh = reinterpret_cast<float*>(pos);
  const int nb = (k + kPer - 1) / kPer;
  int top = 1;
  while (2 * top <= nb) top *= 2;
  for (int rb = 0; rb < k; rb += span) {
    const int p0 = rb + kPer * t.lane;
    if (p0 >= k) continue;
    float m[kPer], v[kPer], u[kPer], col[kPer];
    load8(ms, p0, m);
    load8(reinterpret_cast<const float*>(order), p0, col);  // the columns, as bits
    {
      float dv[kPer], ev[kPer];
      load8(d, p0, dv);
      load8(e, p0, ev);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool light = p0 + j < total;
        v[j] = light ? dv[j] - (1.0f - m[j]) : ev[j];
        const float below = v[j] > 0.0f ? __int_as_float(__float_as_int(v[j]) - 1)
                                        : -__int_as_float(1);  // the float below 0
        u[j] = p0 + j >= k ? -inf : (light ? v[j] : below);
      }
    }
    // Curves relative to D: E lies kp words on, the blocks' last E nbw on.
    int cnt[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) cnt[j] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = cnt[j] + step;
        if (q <= nb && last_d[(p0 + j < total ? nbw : 0) + q - 1] <= u[j]) cnt[j] = q;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) cnt[j] *= kPer;
#pragma unroll
    for (int step = kPer / 2; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = cnt[j] + step;
        if (q <= k && d[(p0 + j < total ? kp : 0) + q - 1] <= u[j]) cnt[j] = q;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j;
      if (p < k) {
        float th;
        int32_t al;
        if (p < total) {
          th = m[j];
          al = order[min(cnt[j], k - 1)];
        } else {
          const int closer = min(cnt[j] + (v[j] > 0.0f ? 1 : 0), k);  // [0, D] has 0 first
          const float x = (v[j] + 1.0f) - (closer > 0 ? d[closer - 1] : 0.0f);
          th = isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);  // `clamp_(0, 1)`, NaN kept
          // order[min(p + 1, K - 1)]
          al = p + 1 < k ? (j + 1 < kPer ? __float_as_int(col[j + 1]) : order[p + 1])
                         : __float_as_int(col[j]);
        }
        const int c = __float_as_int(col[j]);
        out_thresh[c] = th;
        out_alias[c] = al;
      }
    }
  }
  t.sync();
  for (int c = t.lane; c < k; c += t.size) {
    thresh[c] = out_thresh[c];
    alias[c] = out_alias[c];
  }
  t.sync();
}

__global__ void __launch_bounds__(kMaxTeam) build_tables_kernel(Table tw, Table td, int k,
                                                                int log_t, uint32_t* work) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int size = 1 << log_t;
  const int teams = blockDim.x >> log_t;
  const int team = threadIdx.x >> log_t;
  Team t;
  t.size = size;
  t.lane = threadIdx.x & (size - 1);
  t.base = size >= 32 ? 0 : (threadIdx.x & 31) & ~(size - 1);
  t.mask = size >= 32 ? 0xffffffffu : ((1u << size) - 1u) << t.base;
  const long long words = team_words(k);
  uint32_t* row_words = work ? work + (static_cast<long long>(blockIdx.x) * teams + team) * words
                             : smem + team * words;
  const long long total = tw.rows + td.rows;
  const long long step = static_cast<long long>(gridDim.x) * teams;
  for (long long g = static_cast<long long>(blockIdx.x) * teams + team; g < total; g += step) {
    const bool word = g < tw.rows;
    const long long r = word ? g : g - tw.rows;
    const long long at = r * k;
    const float* sums = word ? tw.row_sum : td.row_sum;
    build_row(t, row_words, (word ? tw.counts : td.counts) + at, word ? tw.prior : td.prior,
              sums ? sums + r : nullptr, (word ? tw.thresh : td.thresh) + at,
              (word ? tw.alias : td.alias) + at, k, word ? tw.log_x : td.log_x);
  }
}

template <typename K>
cudaError_t opt_in(K kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

struct Plan {
  int log_t, threads, teams;
  size_t smem;          // dynamic shared memory a block (0 with a global scratch)
  unsigned blocks;
  long long work_bytes;  // the global scratch, when a block's rows do not fit
};

// The launch of `rows` rows of K, the kernel opted in (the occupancy it
// reads counts the opted-in shared memory).
cudaError_t plan_for(long long rows, int k, Plan* out) {
  Plan pl;
  pl.log_t = team_log(k);
  const int size = 1 << pl.log_t;
  pl.threads = size > kBlock ? size : kBlock;
  pl.teams = pl.threads / size;
  const long long bytes = static_cast<long long>(pl.teams) * team_words(k) * 4;
  const bool global = bytes > kMaxSmem;
  pl.smem = global ? 0 : static_cast<size_t>(bytes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, build_tables_kernel, pl.threads,
                                                        pl.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (rows + pl.teams - 1) / pl.teams;
  const long long fit = static_cast<long long>(sms) * per_sm;
  pl.blocks = static_cast<unsigned>(need < fit ? need : fit);
  pl.work_bytes = global ? static_cast<long long>(pl.blocks) * bytes : 0;
  *out = pl;
  return cudaSuccess;
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns a cudaError_t.
//
// Bytes of global scratch a build of `rows` rows of K (both tables
// together) needs: 0 unless a block's rows pass the card's shared memory.
extern "C" long long alias_tables_workspace(long long rows, int k) {
  if (rows <= 0 || k <= 0) return 0;
  static const cudaError_t opted = opt_in(build_tables_kernel);
  Plan pl;
  if (opted != cudaSuccess || plan_for(rows, k, &pl) != cudaSuccess) return -1;
  return pl.work_bytes;
}

// PyTorch's scan split for `rows` rows of K (a test entry).
extern "C" int alias_tables_scan_log_x(long long rows, int k) { return scan_log_x(rows, k); }

// One launch for two tables of K columns, all row-major float32 / int32:
// word rows (rows_w, k) then doc rows (rows_d, k), either may be 0 rows.
// counts, prior and row_sum (PyTorch's sums of counts + prior, or NULL to
// sum in the kernel, which takes K a multiple of 4 in [132, 8160]) in,
// thresh and alias out; `work` is `alias_tables_workspace(rows_w + rows_d,
// k)` bytes, or NULL when that is 0.
extern "C" int alias_tables_build(const float* counts_w, float prior_w, const float* sum_w,
                                  float* thresh_w, int32_t* alias_w, long long rows_w,
                                  const float* counts_d, float prior_d, const float* sum_d,
                                  float* thresh_d, int32_t* alias_d, long long rows_d, int k,
                                  void* work, void* stream) {
  if (k <= 0 || rows_w < 0 || rows_d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool sums_here = (rows_w > 0 && sum_w == nullptr) || (rows_d > 0 && sum_d == nullptr);
  if (sums_here && (k % 4 != 0 || k < 132 || k > 8160))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_w + rows_d == 0) return 0;
  static const cudaError_t opted = opt_in(build_tables_kernel);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  Plan pl;
  const cudaError_t err = plan_for(rows_w + rows_d, k, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.work_bytes > 0 && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Table tw{counts_w, prior_w, sum_w, thresh_w, alias_w, rows_w, scan_log_x(rows_w, k)};
  const Table td{counts_d, prior_d, sum_d, thresh_d, alias_d, rows_d, scan_log_x(rows_d, k)};
  build_tables_kernel<<<pl.blocks, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      tw, td, k, pl.log_t, pl.work_bytes > 0 ? static_cast<uint32_t*>(work) : nullptr);
  return static_cast<int>(cudaGetLastError());
}
