// Banded symmetric2 DTW: the cost fill and the greedy backtrack.
//
// Fill. Replaces the three TPU fills of
// sonido_sonar_tpu/ops/stats/pallas_dtw.py: _fill_pairs_raw (:297,
// kernel _scan_kernel_pairs :205), fill_banded_pallas_batch (:439,
// _fill_kernel :373) and fill_banded_pallas_scan_batch (:173,
// _scan_kernel :129). The three differ only in how the TPU's VMEM split
// the work; they share one contract, which the fill keeps:
//   q [B, n, d], r [B, m, d] f32 -> cost [B, n+1, w] f32, w = 2 band + 1,
//   cost[b, i, k] = D[i, i - band + k], with
//   row 0:  0 at k == band, BIG elsewhere;
//   l[k] = sqrt(max(|q_{i-1}|^2 + |r_{j-1}|^2 - 2 q.r, 0)) for
//          j = i - band + k in [1, m], BIG outside;
//   a[k] = min(l[k] + min(up[k], diag[k]), BIG), up = prev[k+1]
//          (BIG past the band), diag = prev[k];
//   D[k] = min(a[k], D[k-1] + l[k]) clamped to BIG, BIG outside [1, m].
// That is dtw._fill_banded (sonido_sonar_tpu/ops/stats/dtw.py:343-390).
//
// It runs as two kernels, as JAX's split fill does (K7: the band
// distances first, _banded_local_distances pallas_dtw.py:86, then a scan
// that only scans):
// 1. The distance pre-pass writes row 0 and every l[k] into the cost band
//    itself (no other memory). It is parallel over (pair, row, column):
//    consecutive threads take consecutive columns, so they read
//    consecutive rows of r and write the band coalesced; bytes bound it.
// 2. The row recurrence overwrites rows 1..n with D. Rows depend on each
//    other, so one pair is a chain of n rows, each a min-plus scan over
//    w columns: one thread block owns one pair and walks its rows in
//    order; the chain of rows, not bytes, bounds it. Each thread folds a
//    run of columns into one (c, a) pair, a warp-shuffle scan and a
//    shuffle scan of the warp totals give each run its prefix, and the run
//    then writes its D. The (min, +) combine is
//      (c1, a1) . (c2, a2) = (c1 + c2, min(a1 + c2, a2)), identity (0, BIG),
//    as in dtw._minplus_row_scan (dtw.py:115-130). Two regimes:
//    - shared rows, up to band 9,672 (w = 19,345): three rows in shared
//      memory (D of row i-1; row i's distances, overwritten with D; row
//      i+1's distances, fetched by cp.async while row i is scanned), each
//      moved to and from the band in 16-byte pieces; a thread's run
//      (odd, at most 77 columns, up to 256 threads) stays in registers
//      from the fold to the write. Two block barriers a row.
//    - rows in the band, past that: each warp owns a contiguous segment
//      of 288-column tiles; a tile moves between the band and registers
//      with coalesced accesses (the next tile's loads issued before the
//      current tile is scanned) and is turned lane-contiguous through a
//      warp-private buffer. Pass 1 folds the segment, pass 2 loads it
//      again, scans and writes D. Two block barriers a row.
// Distances use explicit round-to-nearest intrinsics and the sqrt is
// IEEE; the clamps to BIG stay. No dense [n, m] tensor exists anywhere.
//
// Backtrack. Replaces _walk_moves in
// sonido_sonar_tpu/ops/stats/pallas_backtrack.py (:150, _walk_kernel
// :104, pallas_call :161) with the move codes and the reconstruction
// around it (:65-101, :190-245). It gives exactly the outputs of
// dtw._backtrack_banded (dtw.py:394-446): from (n, m) to (0, 0), strict-
// less preference up < left < diag; a cell outside the band or the
// matrix reads +inf (an in-band BIG compares as the finite value it is);
// i == 0 steps left, j == 0 steps up; qs = i - 1, rs = j - 1 in start ->
// end order, padded past `length` with the path's first point; cs =
// c(i, j) - c(i-1, j-1), 0 on the borders and where |cs| >= 1e30.
// What bounds it on this card is the walk's dependent chain, not bytes:
// 10-20 k steps a pair at the fleet's n = 10,332, each three comparisons
// of neighbours whose addresses depend on the step before (24 bytes a
// step; the bytes bound is microseconds). Read straight from the band,
// each step waited for an L2/HBM round trip. Here one block takes a pair:
// thread 0 walks while warp 1 stages the band rows ahead of it into a
// ring of R = 64 slots of C = 256 columns in shared memory, one bulk copy
// a row (a window around the walker's column, its 16-byte-aligned
// middle), published in order once complete. A step then reads shared
// memory only; a neighbour outside its row's window is read from the
// band in the same launch (a miss: the same value, later), so the path
// is exact by construction, and the count of misses is an output for
// measuring. Two things hold it above the chain's floor (PERF.md, NVIDIA
// H100 80GB HBM3, 700 W): the copies of one block complete a few at a
// time (~135 SM cycles a copy with 64 in flight, ~470 with one), so the
// walker catches up with the ring; and the step's loop costs ~250
// cycles, where a bare chain of shared loads and selects takes ~70.
// The block then flips the walk-order outputs in place and pads the tail.
//
// No fast math: the sentinel clamps and the inf comparisons need IEEE.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr float kBig = 3.4e38f / 4.0f;  // pallas_dtw.py:44, dtw.py:344
constexpr size_t kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kBacktrackThreads = 256;
constexpr int kDistThreads = 256;  // pre-pass: columns per block
constexpr int kDistRows = 32;      // pre-pass: rows per block (fewer at d > 1,814)

struct MinPlus {
  float c;
  float a;
};

__device__ __forceinline__ MinPlus combine(MinPlus x, MinPlus y) {
  return {__fadd_rn(x.c, y.c), fminf(__fadd_rn(x.a, y.c), y.a)};
}

// The distance pre-pass: rows 0..n of `cost`, `rows` rows of one pair
// per block (grid: column tiles, row groups, pairs). Row 0 is the fill's
// first row (0 at k == band, BIG elsewhere); row i >= 1 holds l[k] of
// row i. Consecutive threads take consecutive columns, so they read
// consecutive rows of r and write one coalesced run of the row. The
// block's query rows and their |q|^2 sit in shared memory. kD is d when
// it is known at compile time (the fleet's energies: 1), else 0.
template <int kD>
__global__ void local_distances_kernel(const float* __restrict__ q, const float* __restrict__ r,
                                       float* __restrict__ cost, int n, int m, int d_arg,
                                       int band, int rows) {
  extern __shared__ float qs[];  // `rows` query rows, then their |q|^2
  const int d = kD > 0 ? kD : d_arg;
  const int w = 2 * band + 1;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * rows;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const float* qb = q + (size_t)b * n * d;
  const float* rb = r + (size_t)b * m * d;
  float* qsq = qs + rows * d;
  for (int t = threadIdx.x; t < rows * d; t += blockDim.x) {
    const int i = i0 + t / d;
    qs[t] = (i >= 1 && i <= n) ? qb[(size_t)(i - 1) * d + t % d] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const float* qrow = qs + threadIdx.x * d;
    float acc = 0.0f;
    for (int t = 0; t < d; ++t) acc = __fmaf_rn(qrow[t], qrow[t], acc);
    qsq[threadIdx.x] = acc;
  }
  __syncthreads();
  if (k >= w) return;
  float* out = cost + ((size_t)b * (n + 1) + i0) * w + k;
  const int last = min(rows, n + 1 - i0);
  int j = i0 - band + k;  // the column's reference index (1-based) in row i0
  for (int s = 0; s < last; ++s, ++j, out += w) {
    if (i0 + s == 0) {
      *out = (k == band) ? 0.0f : kBig;
    } else if (j < 1 || j > m) {
      *out = kBig;
    } else {
      const float* rj = rb + (size_t)(j - 1) * d;
      const float* qrow = qs + s * d;
      float cross = 0.0f, rsq = 0.0f;
#pragma unroll
      for (int t = 0; t < d; ++t) {
        const float v = __ldg(rj + t);
        cross = __fmaf_rn(v, qrow[t], cross);
        rsq = __fmaf_rn(v, v, rsq);
      }
      const float d2 = __fsub_rn(__fadd_rn(qsq[s], rsq), __fmul_rn(2.0f, cross));
      *out = sqrtf(fmaxf(d2, 0.0f));
    }
  }
}

// ---- the row recurrence -------------------------------------------------

constexpr int kTile = 9;               // global regime: columns per lane per tile
constexpr int kTileCols = 32 * kTile;  // 288 columns per warp tile
constexpr int kTileBuf = kTileCols + 32;  // a tile's l, or its prev row and one more
constexpr int kGlobalThreads = 1024;      // global regime: 32 warps
constexpr int kSharedThreads = 256;       // shared regime: at most 8 warps
constexpr int kMaxRun = 77;               // shared regime: columns a thread, at most

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The (c, a) element of a column from its distance and the previous
// row's D at the same column (diag) and the next (up).
__device__ __forceinline__ MinPlus element(float l, float diag, float up) {
  return {fminf(l, kBig), fminf(__fadd_rn(l, fminf(up, diag)), kBig)};
}

// Inclusive scan of x over the warp's lanes, in lane order.
__device__ __forceinline__ MinPlus warp_inclusive(MinPlus x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    MinPlus o;
    o.c = __shfl_up_sync(0xffffffffu, x.c, off);
    o.a = __shfl_up_sync(0xffffffffu, x.a, off);
    if (lane >= off) x = combine(o, x);
  }
  return x;
}

// The previous lane's inclusive value; the identity on lane 0.
__device__ __forceinline__ MinPlus lane_exclusive(MinPlus inc, int lane) {
  MinPlus exc;
  exc.c = __shfl_up_sync(0xffffffffu, inc.c, 1);
  exc.a = __shfl_up_sync(0xffffffffu, inc.a, 1);
  return lane == 0 ? MinPlus{0.0f, kBig} : exc;
}

// The combination of the warp totals of the warps before this one, in
// order: lane 31 of each warp has written its total to tot_c/tot_a and
// the block has passed a barrier since. A shuffle scan over the totals,
// identity past this warp.
__device__ __forceinline__ MinPlus warps_before(const float* tot_c, const float* tot_a, int lane,
                                                int warp) {
  MinPlus t = lane < warp ? MinPlus{tot_c[lane], tot_a[lane]} : MinPlus{0.0f, kBig};
  t = warp_inclusive(t, lane);
  return {__shfl_sync(0xffffffffu, t.c, 31), __shfl_sync(0xffffffffu, t.a, 31)};
}

// A row of the band in shared memory keeps the 16-byte alignment it has
// in the band: element k of a row at global address g sits at
// buf[shift(g) + k]. The row's aligned middle [head, tail) then moves as
// one bulk copy (the tensor memory accelerator, no thread issues a
// per-element instruction), its ends (at most three elements each) by
// the threads.
__device__ __forceinline__ int shift(const float* g) {
  return static_cast<int>((reinterpret_cast<size_t>(g) >> 2) & 3);
}

struct RowSplit {
  int head;  // elements before the aligned middle
  int tail;  // end of the aligned middle
};

__device__ __forceinline__ RowSplit split(const float* g, int w) {
  const int head = min((4 - shift(g)) & 3, w);
  return {head, head + ((w - head) & ~3)};
}

// Start the copy of row g (w floats) into buf: the middle by one bulk
// copy that thread 0 issues and that completes the current phase of
// `bar`, the ends by cp.async.
__device__ __forceinline__ void row_to_shared(float* buf, const float* g, int w,
                                              unsigned long long* bar, int tid, int nthreads) {
  float* dst = buf + shift(g);
  const RowSplit p = split(g, w);
  if (tid == 0) {
    const unsigned bytes = 4u * static_cast<unsigned>(p.tail - p.head);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    if (bytes > 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst + p.head)),
          "l"(g + p.head), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  }
  for (int t = tid; t < p.head + w - p.tail; t += nthreads) {
    const int k = t < p.head ? t : p.tail + t - p.head;
    cp_async_f32(dst + k, g + k);
  }
}

// Wait for the completion of `bar`'s phase of this parity. A phase that
// never completes (a lost bulk copy) traps, so the launch fails with a
// CUDA error instead of hanging.
__device__ __forceinline__ void wait_phase(unsigned long long* bar, int parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}

// Store buf (shifted for g) to row g: the middle by one bulk copy that
// thread 0 issues and commits as a bulk group, the ends by the threads.
// The threads that wrote buf have fenced their writes for the bulk copy
// and passed a barrier since.
__device__ __forceinline__ void shared_to_row(float* g, const float* buf, int w, int tid,
                                              int nthreads) {
  const float* src = buf + shift(g);
  const RowSplit p = split(g, w);
  if (tid == 0 && p.tail > p.head) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(g + p.head),
                 "r"(smem_addr(src + p.head)), "r"(4u * static_cast<unsigned>(p.tail - p.head))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  for (int t = tid; t < p.head + w - p.tail; t += nthreads) {
    const int k = t < p.head ? t : p.tail + t - p.head;
    g[k] = src[k];
  }
}

// Shared regime: three rows of the band in shared memory. prev holds
// D of row i-1, cur the distances of row i (overwritten with D), next
// receives row i+1's distances while row i is scanned; D of row i goes
// back to the band by a bulk copy issued after the row, which has two
// rows' time to read the buffer before it is loaded again. A thread owns
// a run of kRun columns (odd: a warp's strided reads hit 32 banks) and
// keeps their elements in registers from the fold to the write. Two
// barriers a row: after the warp totals, after the row.
template <int kRun>
__global__ void __launch_bounds__(kSharedThreads)
    fill_rows_shared_kernel(float* __restrict__ cost, int n, int m, int band) {
  extern __shared__ __align__(16) float smem[];
  const int w = 2 * band + 1;
  const int stride = (w + 3 + 3) & ~3;  // a row and its shift, in 16-byte pieces
  float* tot_c = smem;
  float* tot_a = smem + 32;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + 64);
  float* prev_buf = smem + 68;
  float* cur_buf = prev_buf + stride;
  float* next_buf = cur_buf + stride;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = tid * kRun;
  float* cb = cost + (size_t)blockIdx.x * (n + 1) * w;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < w; k += nthreads) prev_buf[shift(cb) + k] = cb[k];
  __syncthreads();
  row_to_shared(cur_buf, cb + w, w, bar, tid, nthreads);
  cp_async_wait_all();
  wait_phase(bar, 0);
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    float* crow = cb + (size_t)i * w;
    if (i < n) {
      // next_buf's last store (row i-2) must have been read out first
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      row_to_shared(next_buf, crow + w, w, bar, tid, nthreads);
    }
    const float* prev = prev_buf + shift(crow - w);
    float* cur = cur_buf + shift(crow);

    // pass 1: the run's elements into registers, folded
    float ec[kRun], ea[kRun];
    MinPlus agg = {0.0f, kBig};
    float up = k0 < w ? prev[k0] : kBig;
#pragma unroll
    for (int s = 0; s < kRun; ++s) {
      const int k = k0 + s;
      const float diag = up;
      up = k + 1 < w ? prev[k + 1] : kBig;
      const MinPlus e = k < w ? element(cur[k], diag, up) : MinPlus{0.0f, kBig};
      ec[s] = e.c;
      ea[s] = e.a;
      agg = combine(agg, e);
    }
    const MinPlus inc = warp_inclusive(agg, lane);
    if (lane == 31) {
      tot_c[warp] = inc.c;
      tot_a[warp] = inc.a;
    }
    __syncthreads();
    const MinPlus pre = combine(warps_before(tot_c, tot_a, lane, warp), lane_exclusive(inc, lane));

    // pass 2: D over the run, starting from D[k0 - 1] = pre.a
    const int klo = band + 1 - i, khi = band + m - i;  // j = i - band + k in [1, m]
    float dk = pre.a;
#pragma unroll
    for (int s = 0; s < kRun; ++s) {
      const int k = k0 + s;
      dk = fminf(fminf(ea[s], __fadd_rn(dk, ec[s])), kBig);
      if (k < w) cur[k] = (k >= klo && k <= khi) ? dk : kBig;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cp_async_wait_all();
    if (i < n) wait_phase(bar, i & 1);
    __syncthreads();
    shared_to_row(crow, cur_buf, w, tid, nthreads);
    float* t = prev_buf;
    prev_buf = cur_buf;
    cur_buf = next_buf;
    next_buf = t;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One warp tile of the global regime into registers: lane-strided
// (coalesced) distances of row i and D of row i-1, one column more of
// the latter, BIG past the warp's end `we` (distances) or the band (D).
struct TileRegs {
  float l[kTile];
  float p[kTile + 1];
};

__device__ __forceinline__ void load_tile(TileRegs& r, const float* crow, const float* prow,
                                          int tb, int we, int w, int lane) {
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    const int k = tb + lane + 32 * s;
    r.l[s] = k < we ? crow[k] : kBig;
    r.p[s] = k < w ? prow[k] : kBig;
  }
  const int k = tb + kTileCols + lane;
  r.p[kTile] = (lane == 0 && k < w) ? prow[k] : kBig;
}

__device__ __forceinline__ void store_tile(const TileRegs& r, float* lb, float* pb, int lane) {
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    lb[lane + 32 * s] = r.l[s];
    pb[lane + 32 * s] = r.p[s];
  }
  if (lane == 0) pb[kTileCols] = r.p[kTile];
}

// Global regime: rows i-1 and i are rows of the band itself. Each warp
// owns a contiguous segment of whole tiles of 288 columns; a tile moves
// between the band and registers with lane-strided (coalesced) accesses
// and is turned lane-contiguous (9 columns a lane, an odd, conflict-free
// stride) through a warp-private buffer in shared memory. The next
// tile's loads are issued before the current tile is scanned. Pass 1
// folds the segment into the warp's total; after one barrier, pass 2
// loads the tiles again, scans and writes D over the distances. Two
// barriers a row.
__global__ void __launch_bounds__(kGlobalThreads)
    fill_rows_global_kernel(float* __restrict__ cost, int n, int m, int band) {
  extern __shared__ __align__(16) float smem[];
  const int w = 2 * band + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* tot_c = smem;
  float* tot_a = smem + 32;
  float* lb = smem + 64 + warp * 2 * kTileBuf;
  float* pb = lb + kTileBuf;

  const int seg = (w + nwarps * kTileCols - 1) / (nwarps * kTileCols) * kTileCols;
  const int ws = min(warp * seg, w);
  const int we = min(ws + seg, w);
  const int ntiles = (we - ws + kTileCols - 1) / kTileCols;
  float* cb = cost + (size_t)blockIdx.x * (n + 1) * w;
  const MinPlus id = {0.0f, kBig};

  for (int i = 1; i <= n; ++i) {
    const float* prow = cb + (size_t)(i - 1) * w;
    float* crow = cb + (size_t)i * w;
    TileRegs r;

    // pass 1: the warp's total
    MinPlus carry = id;
    if (ntiles > 0) load_tile(r, crow, prow, ws, we, w, lane);
    for (int t = 0; t < ntiles; ++t) {
      const int tb = ws + t * kTileCols;
      store_tile(r, lb, pb, lane);
      __syncwarp();
      if (t + 1 < ntiles) load_tile(r, crow, prow, tb + kTileCols, we, w, lane);
      MinPlus agg = id;
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const int c = lane * kTile + s;
        if (tb + c < we) agg = combine(agg, element(lb[c], pb[c], pb[c + 1]));
      }
      const MinPlus inc = warp_inclusive(agg, lane);
      carry = combine(carry, {__shfl_sync(0xffffffffu, inc.c, 31),
                              __shfl_sync(0xffffffffu, inc.a, 31)});
      __syncwarp();
    }
    if (lane == 0) {
      tot_c[warp] = carry.c;
      tot_a[warp] = carry.a;
    }
    __syncthreads();

    // pass 2: D over the segment, from the warps before
    carry = warps_before(tot_c, tot_a, lane, warp);
    if (ntiles > 0) load_tile(r, crow, prow, ws, we, w, lane);
    for (int t = 0; t < ntiles; ++t) {
      const int tb = ws + t * kTileCols;
      store_tile(r, lb, pb, lane);
      __syncwarp();
      if (t + 1 < ntiles) load_tile(r, crow, prow, tb + kTileCols, we, w, lane);
      MinPlus e[kTile];
      MinPlus agg = id;
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const int c = lane * kTile + s;
        e[s] = tb + c < we ? element(lb[c], pb[c], pb[c + 1]) : id;
        agg = combine(agg, e[s]);
      }
      const MinPlus inc = warp_inclusive(agg, lane);
      float dk = combine(carry, lane_exclusive(inc, lane)).a;
      carry = combine(carry, {__shfl_sync(0xffffffffu, inc.c, 31),
                              __shfl_sync(0xffffffffu, inc.a, 31)});
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const int c = lane * kTile + s;
        dk = fminf(fminf(e[s].a, __fadd_rn(dk, e[s].c)), kBig);
        const int j = i - band + tb + c;
        lb[c] = (j >= 1 && j <= m) ? dk : kBig;
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const int k = tb + lane + 32 * s;
        if (k < we) crow[k] = lb[lane + 32 * s];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---- the backtrack -------------------------------------------------------

constexpr int kRingRows = 64;   // R: rows staged ahead of the walker (a power of two)
constexpr int kRingCols = 256;  // C: columns of a staged row (a multiple of 4)
// Columns a staged row reaches right of the walker's column when it is
// requested: the walker reads it at most R - 1 up steps later, one
// column a row, and the row's unaligned end may lose three more.
constexpr int kRingReach = kRingRows + 4;
constexpr int kRingMask = kRingRows * kRingCols - 1;  // R C is a power of two
// The ring, then per slot its row's window (lo, hi), the lowest row
// published (padded to 16 bytes), then per slot the walker's request
// (row, column) and an mbarrier.
constexpr size_t kRingSmem =
    sizeof(float) * kRingRows * kRingCols + 8 * kRingRows + 16 + 2 * 8 * kRingRows;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// A staged row as the walker holds it: band columns [lo, hi) at
// ring[(off + k) & kRingMask] (off: the slot's start less lo; the mask
// keeps a read outside the window inside the ring).
struct RingRow {
  int lo;
  int hi;
  int off;
};

__device__ __forceinline__ RingRow row_window(const int2* win, int r) {
  const int s = r & (kRingRows - 1);
  const int2 v = win[s];
  return {v.x, v.y, s * kRingCols - v.x};
}

// The producer's copy of row r of the band into its ring slot: a window
// of C columns around the walker's column kc (reaching kRingReach to the
// right, the rest to the left, where a run of left steps drifts without
// bound), clipped to the band, cut to its 16-byte-aligned middle and
// moved by one bulk copy that completes the slot's current mbarrier
// phase. The walker posted the request after its last read of the slot's
// earlier row, whose values it had already used.
__device__ __forceinline__ void stage_row(float* ring, int2* win, unsigned long long* bars,
                                          const float* cb, int r, int kc, int w) {
  const int s = r & (kRingRows - 1);
  int hi = kc + kRingReach, lo = hi - kRingCols;
  if (w <= kRingCols) {
    lo = 0;
    hi = w;
  } else if (lo < 0) {
    lo = 0;
    hi = kRingCols;
  } else if (hi > w) {
    hi = w;
    lo = w - kRingCols;
  }
  const float* g = cb + (size_t)r * w;
  const int sh = shift(g);
  const int a = lo + ((4 - ((sh + lo) & 3)) & 3);
  const int e = max(hi - ((sh + hi) & 3), a);
  win[s] = make_int2(a, e);
  const unsigned bytes = 4u * static_cast<unsigned>(e - a);
  unsigned long long* bar = bars + s;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(ring + s * kRingCols)),
        "l"(g + a), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// Whether `bar`'s phase of this parity has completed (no wait).
__device__ __forceinline__ bool phase_done(unsigned long long* bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// The producer (one thread of warp 1): rows n, n-1, ..., 0 in order. It
// stages every row whose request the walker has posted (the row in the
// low word, the column in the high word of the slot's request), then
// checks, without waiting, which copies have completed in order, and
// publishes the lowest row published so far with one release store into
// `front` (waiting on each copy in turn held the walker to ~1.2x the
// time, PERF.md). Rows enter a slot from n down, so row r is
// the slot's ((n - r) / R)-th copy, of that phase parity. A producer
// that makes no progress for too long (a lost copy, a walker that died)
// traps, so the launch fails instead of hanging.
__device__ void ring_producer(float* ring, int2* win, int* front, const unsigned long long* req,
                              unsigned long long* bars, const float* cb, int n, int w) {
  for (int s = 0; s < kRingRows; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s)) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  int next = n, pub = n;
  for (long long idle = 0; pub >= 0;) {
    bool progress = false;
    while (next >= 0) {
      const unsigned long long e = *reinterpret_cast<const volatile unsigned long long*>(
          req + (next & (kRingRows - 1)));
      if (static_cast<int>(static_cast<unsigned>(e)) != next) break;
      stage_row(ring, win, bars, cb, next, static_cast<int>(e >> 32), w);
      --next;
      progress = true;
    }
    const int top = pub;
    while (pub > next && phase_done(bars + (pub & (kRingRows - 1)), ((n - pub) / kRingRows) & 1)) {
      --pub;
    }
    if (pub != top) {
      store_release(front, pub + 1);
      progress = true;
    }
    if (progress) {
      idle = 0;
    } else if (++idle > (1LL << 32)) {
      __trap();
    }
  }
}

// The walker's request for row r around column kc.
__device__ __forceinline__ void post_row(unsigned long long* req, int r, int kc) {
  *reinterpret_cast<volatile unsigned long long*>(req + (r & (kRingRows - 1))) =
      (static_cast<unsigned long long>(static_cast<unsigned>(kc)) << 32) |
      static_cast<unsigned>(r);
}

// Wait until the producer has published row r (the lowest published row
// is at most r) and return the lowest published row. A row that never
// arrives traps, so the launch fails instead of hanging.
__device__ __forceinline__ int wait_front(const int* front, int r) {
  int f;
  for (long long spin = 0; (f = load_acquire(front)) > r; ++spin) {
    if (spin > (1LL << 26)) __trap();
  }
  return f;
}

// The walker's slow path: a neighbour outside its row's staged window,
// read from the band itself (+inf outside the band, not a miss).
__device__ __forceinline__ float band_read(const float* cb, int r, int kk, int w, int& misses) {
  if (kk < 0 || kk >= w) return CUDART_INF_F;
  ++misses;
  return cb[(size_t)r * w + kk];
}

// Band read at (i, j): +inf outside the band or the matrix.
__device__ __forceinline__ float band_at(const float* cb, int i, int j, int n, int band, int w) {
  const int k = j - i + band;
  if (i < 0 || j < 0 || k < 0 || k >= w || i > n) return CUDART_INF_F;
  return cb[(size_t)i * w + k];
}

// The walker's state and its step once the three neighbours are read:
// cs, the outputs at t, the move (strict-less preference up < left <
// diag), and on a move up or diagonal the request for row i-R and the
// shift of the rows (next: row i-2's window, read ahead).
struct Walker {
  int i, j, k, t;
  float c_ij;  // the cost of the current cell
  RingRow cur, up, next;

  __device__ __forceinline__ void step(float upv, float dv, float lv, int* qb, int* rbp, float* csb,
                                       unsigned long long* req) {
    float c = __fsub_rn(c_ij, dv);
    if (!(fabsf(c) < 1e30f)) c = 0.0f;
    qb[t] = i - 1;
    rbp[t] = j - 1;
    csb[t] = c;
    ++t;
    const bool pick_diag = (dv < upv) && (dv < lv);
    const bool pick_left = !pick_diag && (lv < upv);
    c_ij = pick_diag ? dv : (pick_left ? lv : upv);
    k += pick_diag ? 0 : (pick_left ? -1 : 1);
    j -= pick_left || pick_diag ? 1 : 0;
    if (!pick_left) {
      if (i >= kRingRows) post_row(req, i - kRingRows, k);
      --i;
      cur = up;
      up = next;
    }
  }
};

// One block per pair. Thread 0 walks from (n, m) to (0, 0) in band
// coordinates (k = j - i + band: up is (i-1, k+1), left (i, k-1), diag
// (i-1, k)), so a step touches rows i and i-1 only. Rows i .. i-R+1 sit
// in a ring of R slots of shared memory, staged ahead by a producer
// thread (warp 1): when the walker leaves row i, it posts row i-R for
// the freed slot around its new column and moves to row i-2's window,
// read ahead, once the producer has published that row. Neither the
// copies nor their mbarriers are on the walker's chain. The hot loop
// holds no nested loop and no global read (either, even untaken, cost
// the step ~40-160 cycles, PERF.md): it issues a step's three shared
// loads, compares and moves; a step with a neighbour outside its row's
// window (read from the band: a miss, the same value later) and the
// wait for a row not yet seen published run outside it. cs comes from
// the walk: c(i, j) is the neighbour chosen one step earlier (at (n, m),
// one read), c(i-1, j-1) this step's diag. The block then flips the
// walk-order outputs in place and pads the tail.
__global__ void __launch_bounds__(kBacktrackThreads)
    backtrack_banded_kernel(const float* __restrict__ cost, int* __restrict__ qs,
                            int* __restrict__ rs, float* __restrict__ cs,
                            int* __restrict__ length, int* __restrict__ misses_out, int n, int m,
                            int band) {
  extern __shared__ __align__(16) float ring[];
  int2* win = reinterpret_cast<int2*>(ring + kRingRows * kRingCols);
  int* front = reinterpret_cast<int*>(win + kRingRows);
  unsigned long long* req = reinterpret_cast<unsigned long long*>(front + 4);
  unsigned long long* bars = req + kRingRows;
  __shared__ int s_len;
  __shared__ int s_pad_q;
  __shared__ int s_pad_r;
  const int w = 2 * band + 1;
  const int max_len = n + m;
  const int b = blockIdx.x;
  const float* cb = cost + (size_t)b * (n + 1) * w;
  int* qb = qs + (size_t)b * max_len;
  int* rbp = rs + (size_t)b * max_len;
  float* csb = cs + (size_t)b * max_len;

  for (int s = threadIdx.x; s < kRingRows; s += blockDim.x) {
    req[s] = 0xffffffffull;  // row -1: no request
  }
  if (threadIdx.x == 0) *front = n + 1;  // nothing published
  __syncthreads();
  if (threadIdx.x == 32) ring_producer(ring, win, front, req, bars, cb, n, w);
  if (threadIdx.x == 0) {
    int misses = 0;
    Walker v{n, m, m - n + band, 0, band_at(cb, n, m, n, band, w), {}, {}, {}};
    for (int r = n; r >= 0 && r > n - kRingRows; --r) post_row(req, r, v.k);
    int seen = wait_front(front, n - 1);
    v.cur = row_window(win, n);
    v.up = row_window(win, n - 1);
    int& i = v.i;
    int& j = v.j;
    int& k = v.k;
    int& t = v.t;
    for (;;) {
      if (i > 0 && i - 1 < seen) {  // the walker caught up with the producer
        seen = wait_front(front, i - 1);
        v.up = row_window(win, i - 1);
      }
      // the hot loop; a miss, or a row not yet seen published, exits it
      while (i > 0 && j > 0) {
        v.next = row_window(win, i - 2);  // used once row i-2 is published
        const int ua = v.up.off + k, la = v.cur.off + k - 1;
        const float upv = ring[(ua + 1) & kRingMask];
        const float dv = ring[ua & kRingMask];
        const float lv = ring[la & kRingMask];
        if (!(k >= v.up.lo && k + 1 < v.up.hi && k - 1 >= v.cur.lo && k - 1 < v.cur.hi)) break;
        v.step(upv, dv, lv, qb, rbp, csb, req);
        if (i - 1 < seen) break;
      }
      if (i == 0 || j == 0) break;
      if (i - 1 < seen) continue;
      // a step with reads outside the windows (misses)
      v.next = row_window(win, i - 2);
      const bool u_in = k + 1 >= v.up.lo && k + 1 < v.up.hi;
      const bool d_in = k >= v.up.lo && k < v.up.hi;
      const bool l_in = k - 1 >= v.cur.lo && k - 1 < v.cur.hi;
      const float upv = u_in ? ring[v.up.off + k + 1] : band_read(cb, i - 1, k + 1, w, misses);
      const float dv = d_in ? ring[v.up.off + k] : band_read(cb, i - 1, k, w, misses);
      const float lv = l_in ? ring[v.cur.off + k - 1] : band_read(cb, i, k - 1, w, misses);
      v.step(upv, dv, lv, qb, rbp, csb, req);
    }
    for (; i > 0; ++t) {  // j == 0: up along column 0, no reads; the requests go on
      qb[t] = i - 1;
      rbp[t] = -1;
      csb[t] = 0.0f;
      ++k;
      if (i - kRingRows >= 0) post_row(req, i - kRingRows, k);
      --i;
    }
    for (; j > 0; ++t) {  // i == 0: left along row 0, no reads
      qb[t] = -1;
      rbp[t] = j - 1;
      csb[t] = 0.0f;
      --j;
    }
    s_len = t;
    s_pad_q = t > 0 ? qb[t - 1] : 0;
    s_pad_r = t > 0 ? rbp[t - 1] : 0;
    length[b] = t;
    if (misses_out != nullptr) misses_out[b] = misses;
  }
  __syncthreads();
  const int len = s_len;
  for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
    const int u = len - 1 - t;
    const int tq = qb[t], tr = rbp[t];
    const float tc = csb[t];
    qb[t] = qb[u];
    rbp[t] = rbp[u];
    csb[t] = csb[u];
    qb[u] = tq;
    rbp[u] = tr;
    csb[u] = tc;
  }
  for (int t = len + threadIdx.x; t < max_len; t += blockDim.x) {
    qb[t] = s_pad_q;
    rbp[t] = s_pad_r;
    csb[t] = 0.0f;
  }
}

// Threads of the shared regime: a warp per 128 columns, at most
// kSharedThreads.
int fill_threads(int w) {
  const int t = ((w + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kSharedThreads ? kSharedThreads : t);
}

// The shared regime's run: columns per thread, odd, so that a warp's
// strided reads of a row hit 32 different banks.
int shared_run(int w) { return ((w + fill_threads(w) - 1) / fill_threads(w)) | 1; }

// Bytes of dynamic shared memory of each regime: the warp totals, then
// an mbarrier and three shifted rows (shared) or two tiles a warp
// (global). The shared
// regime holds up to band 9,672 (w = 19,345), its run then 77 columns.
size_t shared_rows_smem(int band) {
  return sizeof(float) * (68 + 3 * (size_t)((2 * band + 1 + 3 + 3) & ~3));
}
constexpr size_t kGlobalRowsSmem = sizeof(float) * (64 + 2 * kTileBuf * (kGlobalThreads / 32));

template <int kD>
int launch_local_distances(const float* q, const float* r, float* cost, int batch, int n, int m,
                           int d, int band, cudaStream_t stream) {
  const int w = 2 * band + 1;
  const int rows = static_cast<int>(
      std::min<size_t>(kDistRows, kMaxSmem / (sizeof(float) * ((size_t)d + 1))));
  const size_t smem = sizeof(float) * rows * ((size_t)d + 1);
  if (rows < 1 || batch > 65535 || n / rows + 1 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(local_distances_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kDistThreads - 1) / kDistThreads, n / rows + 1, batch);
  local_distances_kernel<kD><<<grid, kDistThreads, smem, stream>>>(q, r, cost, n, m, d, band,
                                                                    rows);
  return static_cast<int>(cudaGetLastError());
}

// The shared regime at the least odd kRun >= run (run <= kMaxRun).
template <int kRun>
int launch_shared_rows(int run, float* cost, int batch, int n, int m, int band,
                       cudaStream_t stream) {
  if constexpr (kRun < kMaxRun) {
    if (run > kRun) return launch_shared_rows<kRun + 2>(run, cost, batch, n, m, band, stream);
  }
  const size_t smem = shared_rows_smem(band);
  const cudaError_t err = cudaFuncSetAttribute(
      fill_rows_shared_kernel<kRun>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_rows_shared_kernel<kRun><<<batch, fill_threads(2 * band + 1), smem, stream>>>(cost, n, m,
                                                                                    band);
  return static_cast<int>(cudaGetLastError());
}

int launch_fill_rows(float* cost, int batch, int n, int m, int band, cudaStream_t stream) {
  if (shared_rows_smem(band) <= kMaxSmem && shared_run(2 * band + 1) <= kMaxRun) {
    return launch_shared_rows<1>(shared_run(2 * band + 1), cost, batch, n, m, band, stream);
  }
  const cudaError_t err = cudaFuncSetAttribute(fill_rows_global_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kGlobalRowsSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_rows_global_kernel<<<batch, kGlobalThreads, kGlobalRowsSmem, stream>>>(cost, n, m, band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The distance pre-pass alone: rows 0..n of `cost` [batch, n+1, w].
extern "C" int sonido_dtw_local_distances(const float* q, const float* r, float* cost, int batch,
                                          int n, int m, int d, int band, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || d < 1 || band < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 1 ? launch_local_distances<1>(q, r, cost, batch, n, m, d, band, s)
                : launch_local_distances<0>(q, r, cost, batch, n, m, d, band, s);
}

// The row recurrence alone, in place over a band of local distances.
extern "C" int sonido_dtw_fill_rows(float* cost, int batch, int n, int m, int band, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || band < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fill_rows(cost, batch, n, m, band, static_cast<cudaStream_t>(stream));
}

// The banded fill on `stream`, the pre-pass then the recurrence; returns
// the CUDA error code.
extern "C" int sonido_dtw_fill_banded(const float* q, const float* r, float* cost, int batch,
                                      int n, int m, int d, int band, void* stream) {
  const int err = sonido_dtw_local_distances(q, r, cost, batch, n, m, d, band, stream);
  return err != 0 ? err : sonido_dtw_fill_rows(cost, batch, n, m, band, stream);
}

// Launch the banded backtrack on `stream`; returns the CUDA error code.
// `misses` (nullable) receives each pair's count of neighbours read from
// the band instead of the ring.
extern "C" int sonido_dtw_backtrack_banded(const float* cost, int* qs, int* rs, float* cs,
                                           int* length, int batch, int n, int m, int band,
                                           void* stream, int* misses) {
  if (batch < 1 || n < 1 || m < 1 || band < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(backtrack_banded_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kRingSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  backtrack_banded_kernel<<<batch, kBacktrackThreads, kRingSmem,
                            static_cast<cudaStream_t>(stream)>>>(cost, qs, rs, cs, length, misses,
                                                                 n, m, band);
  return static_cast<int>(cudaGetLastError());
}
