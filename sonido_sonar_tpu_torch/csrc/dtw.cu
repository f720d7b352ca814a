// Banded symmetric2 DTW: the cost fill and the greedy backtrack.
//
// Fill. Replaces the three TPU fills of
// sonido_sonar_tpu/ops/stats/pallas_dtw.py: _fill_pairs_raw (:297,
// kernel _scan_kernel_pairs :205), fill_banded_pallas_batch (:439,
// _fill_kernel :373) and fill_banded_pallas_scan_batch (:173,
// _scan_kernel :129). The three differ only in how the TPU's VMEM split
// the work; they share one contract, which this kernel keeps:
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
// What bounds it: rows depend on each other, so one pair is a chain of
// n rows, each a min-plus scan over w columns with d-wide distances.
// One thread block owns one pair and walks its rows in order; the
// previous row sits in dynamic shared memory (double-buffered, so a row
// is written while the last one is still read) when two rows fit there
// (band <= ~14,500); a wider band reads the previous row back from the
// cost band in global memory (L2-resident, just written) and writes each
// row straight there. r is read from global memory, where a pair's rows
// (m * d * 4 bytes) stay in L2. Each thread
// takes a contiguous run of columns: a first pass folds its run into one
// (c, a) pair, a warp-shuffle scan and a scan of the warp totals in
// shared memory give each run its prefix, and a second pass recomputes
// the run's distances and writes D. The (min, +) combine is
//   (c1, a1) . (c2, a2) = (c1 + c2, min(a1 + c2, a2)), identity (0, BIG),
// as in dtw._minplus_row_scan (dtw.py:115-130). |r|^2 is accumulated
// with the dot product from the same loads. Distances use explicit
// round-to-nearest intrinsics, so both passes compute the same bits.
// With shared rows, each finished row is copied to device memory by all
// threads with coalesced stores. No dense [n, m] tensor exists anywhere.
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
// The walk is a dependent pointer chase: one thread per pair walks it,
// reading its three neighbours straight from the band, and writes the
// points in walk order; then the block flips the prefix in place, pads
// the tail and computes the costs in parallel.
//
// No fast math: the sentinel clamps and the inf comparisons need IEEE.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 3.4e38f / 4.0f;  // pallas_dtw.py:44, dtw.py:344
constexpr size_t kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kBacktrackThreads = 256;

struct MinPlus {
  float c;
  float a;
};

__device__ __forceinline__ MinPlus combine(MinPlus x, MinPlus y) {
  return {__fadd_rn(x.c, y.c), fminf(__fadd_rn(x.a, y.c), y.a)};
}

// Local distance of column k of row i (j = i - band + k), BIG outside [1, m].
__device__ __forceinline__ float local_distance(const float* __restrict__ rb,
                                                const float* __restrict__ qrow, float qsq,
                                                int j, int m, int d) {
  if (j < 1 || j > m) return kBig;
  const float* rj = rb + (size_t)(j - 1) * d;
  float cross = 0.0f, rsq = 0.0f;
  for (int t = 0; t < d; ++t) {
    const float v = __ldg(rj + t);
    cross = __fmaf_rn(v, qrow[t], cross);
    rsq = __fmaf_rn(v, v, rsq);
  }
  const float d2 = __fsub_rn(__fadd_rn(qsq, rsq), __fmul_rn(2.0f, cross));
  return sqrtf(fmaxf(d2, 0.0f));
}

// The (c, a) element of column k, given the previous row.
__device__ __forceinline__ MinPlus element(const float* prev, int k, int w, float l) {
  const float up = (k + 1 < w) ? prev[k + 1] : kBig;
  const float diag = prev[k];
  return {fminf(l, kBig), fminf(__fadd_rn(l, fminf(up, diag)), kBig)};
}

// kSharedRows: the previous and current rows in shared memory (copied
// out after each row); otherwise both are rows of `cost` itself.
template <bool kSharedRows>
__global__ void fill_banded_kernel(const float* __restrict__ q, const float* __restrict__ r,
                                   float* __restrict__ cost, int n, int m, int d, int band) {
  extern __shared__ float smem[];
  const int w = 2 * band + 1;
  float* qrow = kSharedRows ? smem + 2 * w : smem;
  float* tot_c = qrow + d;
  float* tot_a = tot_c + 32;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const int run = (w + nthreads - 1) / nthreads;
  const int k0 = min(tid * run, w);
  const int k1 = min(k0 + run, w);

  const float* qb = q + (size_t)b * n * d;
  const float* rb = r + (size_t)b * m * d;
  float* cb = cost + (size_t)b * (n + 1) * w;

  float* prev = kSharedRows ? smem : cb;
  float* cur = kSharedRows ? smem + w : cb + w;
  for (int k = tid; k < w; k += nthreads) {
    const float v = (k == band) ? 0.0f : kBig;
    if (kSharedRows) prev[k] = v;
    cb[k] = v;
  }

  for (int i = 1; i <= n; ++i) {
    for (int t = tid; t < d; t += nthreads) qrow[t] = qb[(size_t)(i - 1) * d + t];
    __syncthreads();
    float qsq = 0.0f;
    for (int t = 0; t < d; ++t) qsq = __fmaf_rn(qrow[t], qrow[t], qsq);

    // pass 1: fold the run
    MinPlus agg = {0.0f, kBig};
    for (int k = k0; k < k1; ++k) {
      const float l = local_distance(rb, qrow, qsq, i - band + k, m, d);
      agg = combine(agg, element(prev, k, w, l));
    }
    // inclusive scan of the runs within the warp
    MinPlus inc = agg;
    for (int off = 1; off < 32; off <<= 1) {
      MinPlus o;
      o.c = __shfl_up_sync(0xffffffffu, inc.c, off);
      o.a = __shfl_up_sync(0xffffffffu, inc.a, off);
      if (lane >= off) inc = combine(o, inc);
    }
    MinPlus exc;
    exc.c = __shfl_up_sync(0xffffffffu, inc.c, 1);
    exc.a = __shfl_up_sync(0xffffffffu, inc.a, 1);
    if (lane == 0) exc = {0.0f, kBig};
    if (lane == 31) {
      tot_c[warp] = inc.c;
      tot_a[warp] = inc.a;
    }
    __syncthreads();
    MinPlus pre = {0.0f, kBig};
    for (int v = 0; v < warp && v < nwarps; ++v) pre = combine(pre, MinPlus{tot_c[v], tot_a[v]});
    pre = combine(pre, exc);

    // pass 2: D over the run, starting from D[k0 - 1] = pre.a
    float dk = pre.a;
    for (int k = k0; k < k1; ++k) {
      const int j = i - band + k;
      const float l = local_distance(rb, qrow, qsq, j, m, d);
      const MinPlus e = element(prev, k, w, l);
      dk = fminf(fminf(e.a, __fadd_rn(dk, e.c)), kBig);
      cur[k] = (j >= 1 && j <= m) ? dk : kBig;
    }
    __syncthreads();
    if (kSharedRows) {
      float* row = cb + (size_t)i * w;
      for (int k = tid; k < w; k += nthreads) row[k] = cur[k];
      float* t = prev;
      prev = cur;
      cur = t;
    } else {
      prev = cur;
      cur += w;
    }
  }
}

// Band read of the backtrack: +inf outside the band or the matrix.
__device__ __forceinline__ float band_at(const float* cb, int i, int j, int n, int band, int w) {
  const int k = j - i + band;
  if (i < 0 || j < 0 || k < 0 || k >= w || i > n) return CUDART_INF_F;
  return cb[(size_t)i * w + k];
}

__global__ void backtrack_banded_kernel(const float* __restrict__ cost, int* __restrict__ qs,
                                        int* __restrict__ rs, float* __restrict__ cs,
                                        int* __restrict__ length, int n, int m, int band) {
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

  if (threadIdx.x == 0) {
    int i = n, j = m, k = 0;
    while ((i > 0 || j > 0) && k < max_len) {
      qb[k] = i - 1;
      rbp[k] = j - 1;
      ++k;
      int ni, nj;
      if (i == 0) {
        ni = 0;
        nj = j - 1;
      } else if (j == 0) {
        ni = i - 1;
        nj = 0;
      } else {
        const float up = band_at(cb, i - 1, j, n, band, w);
        const float left = band_at(cb, i, j - 1, n, band, w);
        const float diag = band_at(cb, i - 1, j - 1, n, band, w);
        const bool pick_left = left < up;
        const bool pick_diag = (diag < up) && (diag < left);
        ni = pick_diag ? i - 1 : (pick_left ? i : i - 1);
        nj = pick_diag ? j - 1 : (pick_left ? j - 1 : j);
      }
      i = ni;
      j = nj;
    }
    s_len = k;
    s_pad_q = k > 0 ? qb[k - 1] : 0;
    s_pad_r = k > 0 ? rbp[k - 1] : 0;
    length[b] = k;
  }
  __syncthreads();
  const int len = s_len;
  for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
    const int u = len - 1 - t;
    const int tq = qb[t], tr = rbp[t];
    qb[t] = qb[u];
    rbp[t] = rbp[u];
    qb[u] = tq;
    rbp[u] = tr;
  }
  for (int t = len + threadIdx.x; t < max_len; t += blockDim.x) {
    qb[t] = s_pad_q;
    rbp[t] = s_pad_r;
    csb[t] = 0.0f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int i = qb[t] + 1, j = rbp[t] + 1;
    float c = 0.0f;
    if (i > 0 && j > 0) {
      c = __fsub_rn(band_at(cb, i, j, n, band, w), band_at(cb, i - 1, j - 1, n, band, w));
      if (!(fabsf(c) < 1e30f)) c = 0.0f;
    }
    csb[t] = c;
  }
}

int fill_threads(int w) {
  int t = ((w + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// Bytes of dynamic shared memory the fill needs: the two rows (if held
// there), one query row and the warp totals.
size_t fill_smem(bool shared_rows, int d, int band) {
  return sizeof(float) * ((shared_rows ? 2 * (2 * (size_t)band + 1) : 0) + d + 64);
}

template <bool kSharedRows>
int launch_fill(const float* q, const float* r, float* cost, int batch, int n, int m, int d,
                int band, cudaStream_t stream) {
  const int w = 2 * band + 1;
  const size_t smem = fill_smem(kSharedRows, d, band);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fill_banded_kernel<kSharedRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_banded_kernel<kSharedRows><<<batch, fill_threads(w), smem, stream>>>(q, r, cost, n, m, d,
                                                                           band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the banded fill on `stream`; returns the CUDA error code.
extern "C" int sonido_dtw_fill_banded(const float* q, const float* r, float* cost, int batch,
                                      int n, int m, int d, int band, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || d < 1 || band < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fill_smem(true, d, band) <= kMaxSmem ? launch_fill<true>(q, r, cost, batch, n, m, d, band, s)
                                 : launch_fill<false>(q, r, cost, batch, n, m, d, band, s);
}

// Launch the banded backtrack on `stream`; returns the CUDA error code.
extern "C" int sonido_dtw_backtrack_banded(const float* cost, int* qs, int* rs, float* cs,
                                           int* length, int batch, int n, int m, int band,
                                           void* stream) {
  if (batch < 1 || n < 1 || m < 1 || band < 0) return static_cast<int>(cudaErrorInvalidValue);
  backtrack_banded_kernel<<<batch, kBacktrackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cost, qs, rs, cs, length, n, m, band);
  return static_cast<int>(cudaGetLastError());
}
