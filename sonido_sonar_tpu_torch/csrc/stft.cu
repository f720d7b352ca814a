// K1: fused pre-emphasis + framing + windowed real FFT + magnitude, with
// the per-frame aux epilogue (rms, zero crossings, 0.85 rolloff bin,
// quarter-band energy ratios).
//
// Replaces the TPU kernel stft_magnitude_pallas(with_aux=True, pre_emph)
// in sonido_sonar_tpu/ops/pallas_stft.py (kernel body :240, pallas_call
// :486). Same contract: [B, N] float32 PCM -> magnitude [B, T, F] with
// T = (N - W)/hop + 1 (no centering) and F = W/2 + 1, plus aux planes
// [5, B, T]; pre-emphasis y[n] = x[n] - a x[n-1] with x[-1] = 0 only at
// the start of each row.
//
// What bounds it on an H100: the bytes. At B=128 x 30 s, 1024/256 it
// reads 677 MB of PCM and writes 1.37 GB of magnitudes, 0.61 ms at
// 3.35 TB/s; the transform is ~25 kFLOP per frame as a W/2-point complex
// FFT of the packed real frame (z[m] = x[2m] + i x[2m+1]) plus the
// real-FFT split, ~0.25 ms of fp32 work. The DFT as a matmul against a
// [W, 2F] basis (the TPU's choice, made for its MXU) would be ~2.1 MFLOP
// per frame.
//
// Design: one warp owns one frame end to end, so nothing inside the
// transform waits on the block.
//   - A block stages the pre-emphasized samples of up to kTileMax
//     consecutive frames ((frames-1)*hop + W floats) once, so the
//     4x-overlapped frames tensor never exists in device memory; the only
//     __syncthreads() is the one after staging.
//   - Each warp then walks its frames. The W/2-point FFT is a Stockham
//     autosort of radix-8 passes and one radix-2 or radix-4 pass for the
//     rest (FftPlan; 512 = 8 x 8 x 8). Within a pass every butterfly is in
//     registers (W/64 points per lane at W >= 512: lane l holds butterflies
//     j = l + 32 s); between passes the warp exchanges its points through
//     its own shared buffer under __syncwarp() only. The buffer is indexed
//     through an XOR swizzle (swz) that keeps every pass's loads and stores
//     free of bank conflicts at the size of the data, no padding.
//   - Pass 0 reads the staged samples and the window directly and adds up
//     the frame's sum of squares and zero crossings on the way; the other
//     passes read their twiddles from a table in pass order (lanes of
//     neighbouring butterflies read neighbouring entries).
//   - The passes after the first (fft_pass, FftPlan, swz, dft) are the
//     warp FFT core of csrc/warp_fft.cuh, shared with K2/K3 (yin.cu).
//   - The same warp then does the real-FFT split for bins k = l + 32 i,
//     writes the magnitudes (each store 32 consecutive floats of the
//     frame's contiguous row), and finds the rolloff bin by a warp prefix
//     sum over contiguous per-lane chunks of the power.
//
// Numerics: fp32 throughout; pre-emphasis is rounded exactly like the
// plain PyTorch version (multiply, then subtract) so the zero-crossing
// counts see the same samples. Twiddles come from the host, built in
// float64 (ops/hopper_stft.twiddle_table, whose numpy model fft_model
// runs the same pass order and index maps).
//
// K10, the feature epilogue (sonido_stft_features): replaces the
// with_features=True epilogue of the same TPU kernel (pallas_stft.py
// :334-417). The same warp writes feat [B, T, 43]: 26 mel energies and the
// 12-class chroma fold of the power (each a weighted sum over a sparse
// table from the host: a mel filter is a run of bins, a bin folds into at
// most one chroma class, so ~2F products per frame instead of the TPU's
// dense [F, 64] matmuls), the chroma normalized to unit sum, and the
// descriptor bundle's centroid, bandwidth (its second pass over
// (f - centroid)^2 m, not the TPU's moment expansion), flatness, crest and
// slope, finished per frame as ops/spectral.frame_descriptors finishes
// them. All fp32; the TPU's bf16 hi/lo tiers existed for its MXU and have
// no counterpart. The K1 launch (sonido_stft_aux) is the same template
// without the epilogue, one FFT core for both, so its magnitudes and aux
// bits are the same.
//
// What bounds K10: like K1, instruction issue, not bytes (the feat lanes
// add 0.11 GB to K1's 2.05 GB at B=128 x 30 s); its epilogue runs about as
// many instructions per frame as K1's transform. The parent design spent
// two thirds of K10 (3.5 of 5.2 ms on an H100) in the epilogue, most of it
// in the 38 weighted sums run one lane per row: the warp waited on the
// 119-entry mel row while the chroma lanes idled. So:
//   - The sums are load-balanced: the table's nnz entries (1,117 at
//     1024 / 44.1 kHz) are cut into 32 contiguous segments of floor or
//     ceil nnz / 32, one per lane (sums_plan, built once per block). A
//     lane walks its segment in table order with one running sum, reading
//     each entry (bin, row, weight) with one 8-byte load from a table the
//     host interleaves by lane (each warp load one 256-byte run), four
//     entries and their powers loaded before any is added, and at each
//     change of row stores its partial at warp slot lane + row; a lane per
//     row then adds that row's consecutive slots in lane order. No
//     atomics: the order is fixed, so two launches give the same bits
//     (ops/hopper_stft.feature_sums_model replays it in numpy). Not the
//     prefix-sum form of the triangles (differences of running sums of p
//     and p f): it cancels on high mel bands after loud low bins, and MFCC
//     takes the log of these values.
//   - The descriptors' sums are taken in the split loop, where each lane
//     holds its bins' power and magnitude in registers, instead of two
//     more passes over the frame in shared memory, with log2 m from one
//     MUFU op; eight of them are reduced by one transposed reduction (9
//     shuffles, one sum per lane), the counts and the maximum by one
//     warp-reduce instruction each. The bandwidth keeps its second pass,
//     over the magnitudes in shared memory.
//   - The chroma total is one warp sum over the 12 rows' lanes.
// The parts' times and the variants tried are in PERF.md (section 6,
// tools/profile_torch.py --ablate-stft).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp_fft.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileMax = 16;     // frames per block
constexpr int kSigCap = 8192;    // staged floats per block past which the tile has fewer frames
constexpr float kEps = 1e-10f;
constexpr float kRolloff = 0.85f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMel = 26;                  // feat lanes 0-25
constexpr int kChroma = 12;               // feat lanes 26-37
constexpr int kSums = kMel + kChroma;     // rows of the sparse table
constexpr int kFeatLanes = kSums + 5;     // + centroid, bandwidth, flatness, crest, slope
constexpr int kSlots = 32 + kSums;        // warp scratch of the sums' partials: lane l, row r at l + r
constexpr int kWalkStep = 4;              // table entries a lane loads together
constexpr float kLog10Of2 = 0.30102999566398120f;

// sqrt.approx (one MUFU op) for the magnitudes: the IEEE-rounded sqrtf's
// refinement costs 11 % of K1's time at W = 1024 (tools/profile_torch.py
// --ablate-stft); the magnitude gates of utils/parity hold either way.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Pass 0 (Ns = 1, no twiddles): the packed windowed frame from the staged
// samples, with the frame's sum of squares and zero crossings over the
// raw (pre-emphasized) samples on the way.
template <int N, int R>
__device__ __forceinline__ void fft_first_pass(const float* fr, bool even,
                                               const float2* __restrict__ win2, float2* buf,
                                               int lane, float& sq, int& zc) {
  constexpr int kB = N / R;
  constexpr int kSlots = (kB + 31) / 32;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (kB >= 32 || j < kB) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = j + r * kB;
        float a, b;
        if (even) {
          const float2 t = *reinterpret_cast<const float2*>(fr + 2 * m);
          a = t.x;
          b = t.y;
        } else {
          a = fr[2 * m];
          b = fr[2 * m + 1];
        }
        sq += a * a + b * b;
        zc += (a >= 0.f) != (b >= 0.f);
        if (m + 1 < N) zc += (b >= 0.f) != (fr[2 * m + 2] >= 0.f);
        const float2 wv = __ldg(win2 + m);
        v[r] = make_float2(a * wv.x, b * wv.y);
      }
      dft<R>(v);
#pragma unroll
      for (int r = 0; r < R; ++r) buf[swz(j * R + r)] = v[r];
    }
  }
}

// Shared-memory layout, in floats: the staged samples; for the feature
// epilogue the weighted sums' plan (sums_plan, one int2 per lane); then one
// buffer per warp (the frame's N complex points; after the split its power
// [F] and, for the feature epilogue, its magnitudes [F] and kSlots partial
// sums).
struct Layout {
  int tile, sig, plan, warp_buf, total;
  __host__ __device__ Layout(int w, int hop, bool features) {
    const int half = w / 2, f_bins = half + 1;
    const int fit = (kSigCap - w) / hop + 1;  // w <= 2048 < kSigCap, so fit >= 1
    tile = fit < kTileMax ? fit : kTileMax;
    sig = ((tile - 1) * hop + w + 3) & ~3;
    plan = features ? 2 * 32 : 0;
    warp_buf = features ? (2 * f_bins + kSlots + 3) & ~3 : 2 * half;
    total = sig + plan + kWarps * warp_buf;
  }
};

// The feature epilogue's output and constants (all null for K1 alone).
struct FeatArgs {
  float* feat;                 // [B, T, kFeatLanes]
  const int* row_ptr;          // [kSums + 1]
  const int2* entries;         // [S, 32]: lane l's t-th entry (bin | row << 16, weight's bits) at t * 32 + l
  const float2* freq_logf;     // [F]: (f, log10 f or 0 at f = 0)
};

// The weighted sums' plan of one lane, the same for every warp and frame:
// the table's nnz entries, in row order, cut into 32 contiguous segments
// of floor or ceil nnz / 32, lane l's [l nnz / 32, (l + 1) nnz / 32), so
// entry e is lane (32 e + 31) / nnz's. The host stores the segments
// interleaved (lane l's t-th entry at t * 32 + l), so the warp's t-th
// loads are one contiguous 256-byte run, each padded to kWalkStep * ceil(
// ceil(nnz / 32) / kWalkStep) entries with no-ops (weight 0 on the lane's
// last row). x is the padded count for a lane with entries, else 0; y
// the first slot and count of the partials of row `lane` (bits 0-7, 8-15)
// and of row lane + 32 (bits 16-23, 24-31). Lane l's partial of row r
// goes to slot l + r: the rows a lane touches rise with the lane, so no
// two partials share a slot, and row r's partials are the consecutive
// slots l + r for the lanes l of its first and last entries and those
// between (none for an empty row). ops/hopper_stft.feature_plan and
// feature_entries are the same plan and layout in numpy.
__device__ __forceinline__ int2 sums_plan(const int* __restrict__ rp, int lane) {
  const int nnz = rp[kSums];
  const int div = max(nnz, 1);
  auto row = [&](int r) {
    const int a = rp[r], b = rp[r + 1];
    const int lo = (32 * a + 31) / div;
    return (lo + r) | ((b > a ? (32 * (b - 1) + 31) / div - lo + 1 : 0) << 8);
  };
  const int second = lane < kSums - 32 ? row(lane + 32) : 0;
  const int steps = ((nnz + 31) / 32 + kWalkStep - 1) / kWalkStep * kWalkStep;
  const bool any = (lane + 1) * nnz / 32 > lane * nnz / 32;
  return make_int2(any ? steps : 0, row(lane) | (second << 16));
}

// log2 of a magnitude above kEps, for flatness and slope: one MUFU op;
// ln m and log10 m are it times constants, folded into the sums' finish.
__device__ __forceinline__ float log2_mag(float x) { return __log2f(x); }

// The descriptors' finishing arithmetic, IEEE-rounded as in the plain
// version.
__device__ __forceinline__ float finish_div(float a, float b) { return a / b; }
__device__ __forceinline__ float finish_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float finish_exp2(float x) { return exp2f(x); }

// One lane's share of the descriptor sums, taken where the split holds the
// frame's bins k = lane + 32 i in registers.
struct Descriptors {
  float psum = 0.f, msum = 0.f, fmsum = 0.f, lsum = 0.f;  // lsum: sum of log2 m
  float sx = 0.f, sxx = 0.f, sxl = 0.f, l0 = 0.f;  // sxl: sum of log2 m * log10 f; l0: log2 m at bin 0
  float mmax = 0.f;
  int cnt = 0;  // bins above kEps, + 65536 when bin 0 is one of them
  __device__ __forceinline__ void add(float m, float p, float2 fl, bool bin0) {
    psum += p;
    msum += m;
    fmsum += m * fl.x;
    mmax = fmaxf(mmax, m);
    if (m > kEps) {  // flatness: log m over bins above the threshold; slope: f > 0 too,
      const float lm = log2_mag(m);  // and log10 f is 0 at bin 0, so only its y needs taking out
      cnt += bin0 ? 65537 : 1;
      lsum += lm;
      if (bin0) l0 = lm;
      sx += fl.y;
      sxx += fl.y * fl.y;
      sxl += lm * fl.y;
    }
  }
};

// v[0..7] of every lane -> the warp's sum of v[(lane >> 2) & 7], in this
// lane: three exchange rounds that each halve the values a lane keeps
// (offsets 16, 8, 4), then two butterfly rounds: 9 shuffles for 8 sums.
__device__ __forceinline__ float transpose_sum8(const float (&v)[8], int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (u4 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, u4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (u3 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, u3 ? a[i] : a[i + 2], 8);
  float c = (u2 ? b[1] : b[0]) + __shfl_xor_sync(kFull, u2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFull, c, 2);
  return c + __shfl_xor_sync(kFull, c, 1);
}

// K10's per-frame epilogue, by the frame's warp: d the lane's descriptor
// sums, p and m the frame's power and magnitudes [F] in its buffer, slots
// kSlots floats of scratch, plan this lane's sums_plan.
__device__ __forceinline__ void feature_epilogue(const FeatArgs& fa, const Descriptors& d,
                                                 const float* __restrict__ p,
                                                 const float* __restrict__ m,
                                                 float* __restrict__ slots, int2 plan, int f_bins,
                                                 size_t frame, int lane) {
  // the descriptors: value i of the lane's sums ends in lanes 4i..4i+3
  const float v[8] = {d.psum, d.msum, d.fmsum, d.lsum, d.sx, d.sxx, d.sxl, d.l0};
  const float part = transpose_sum8(v, lane);
  const int cnt_all = __reduce_add_sync(kFull, d.cnt);
  const float mmax = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(d.mmax)));  // m >= 0
  const float msum = __shfl_sync(kFull, part, 4);
  const float fmsum = __shfl_sync(kFull, part, 8);
  const float centroid = msum > 0.f ? finish_div(fmsum, fmaxf(msum, kEps)) : 0.f;
  float bw = 0.f;  // second pass: sum (f - centroid)^2 m
  for (int k = lane; k < f_bins; k += 32) {
    const float dk = __ldg(&fa.freq_logf[k].x) - centroid;
    bw += dk * dk * m[k];
  }
  bw = warp_sum(bw);
  const float lsum = __shfl_sync(kFull, part, 12);
  const float sx = __shfl_sync(kFull, part, 16);
  const float sxx = __shfl_sync(kFull, part, 20);
  const float sxl = __shfl_sync(kFull, part, 24);
  const float l0 = __shfl_sync(kFull, part, 28);
  float* out = fa.feat + frame * kFeatLanes;
  if (lane == 0) {  // finish the five as frame_descriptors finishes them
    const float cnt = (float)(cnt_all & 0xffff), ns = cnt - (float)(cnt_all >> 16);
    const float sy = (lsum - l0) * kLog10Of2, sxy = sxl * kLog10Of2;  // log10 m = log2 m log10 2
    const float nb = (float)f_bins;
    const float arith = finish_div(msum, nb);
    const float geo = finish_exp2(finish_div(lsum, fmaxf(cnt, 1.f)));
    const float rms = finish_sqrt(finish_div(part, nb));  // part: the power sum in lane 0
    const float den = ns * sxx - sx * sx;
    out[kSums] = centroid;
    out[kSums + 1] = msum > 0.f ? finish_sqrt(finish_div(bw, fmaxf(msum, kEps))) : 0.f;
    out[kSums + 2] = (cnt > 0.f && arith > kEps) ? finish_div(geo, fmaxf(arith, kEps)) : 0.f;
    out[kSums + 3] = rms > 0.f ? finish_div(mmax, fmaxf(rms, kEps)) : 0.f;
    out[kSums + 4] = (ns >= 2.f && fabsf(den) > kEps) ? finish_div(ns * sxy - sx * sy, den) : 0.f;
  }

  // the 38 weighted sums of the power: each lane walks its segment of the
  // table in order with one running sum, storing it at each row change;
  // kWalkStep entries and their powers are loaded before any of them is
  // added, the next step's entries while this step adds
  const unsigned rows = plan.y;
  if (plan.x > 0) {
    const int2* col = fa.entries + lane;
    int2 next[kWalkStep];
#pragma unroll
    for (int u = 0; u < kWalkStep; ++u) next[u] = __ldg(col + 32 * u);
    int cur = next[0].x >> 16;
    float acc = 0.f;
    for (int t = 0; t < plan.x; t += kWalkStep) {
      int2 en[kWalkStep];
      float pv[kWalkStep];
#pragma unroll
      for (int u = 0; u < kWalkStep; ++u) {
        en[u] = next[u];
        pv[u] = p[en[u].x & 0xffff];
      }
      if (t + kWalkStep < plan.x) {
#pragma unroll
        for (int u = 0; u < kWalkStep; ++u) next[u] = __ldg(col + 32 * (t + kWalkStep + u));
      }
#pragma unroll
      for (int u = 0; u < kWalkStep; ++u) {
        const int row = en[u].x >> 16;
        if (row != cur) {
          slots[lane + cur] = acc;
          acc = 0.f;
          cur = row;
        }
        acc += __int_as_float(en[u].y) * pv[u];
      }
    }
    slots[lane + cur] = acc;
  }
  __syncwarp();
  // rows lane and lane + 32: their partials in lane order
  float v0 = 0.f, v1 = 0.f;
#pragma unroll 1
  for (int t = 0, n = (rows >> 8) & 0xff; t < n; ++t) v0 += slots[(rows & 0xff) + t];
#pragma unroll 1
  for (int t = 0, n = rows >> 24; t < n; ++t) v1 += slots[((rows >> 16) & 0xff) + t];
  // unit-sum chroma (pallas_stft.py:405-409): rows 26-37 are lanes 26-31's
  // first and lanes 0-5's second
  const float total = warp_sum((lane >= kMel ? v0 : 0.f) + v1);
  auto norm = [&](float e) { return total > kEps ? e / fmaxf(total, kEps) : e; };
  out[lane] = lane < kMel ? v0 : norm(v0);
  if (lane < kSums - 32) out[32 + lane] = norm(v1);
}

// Resident blocks per SM the registers must leave room for: at W <= 1024
// the shared memory allows 6 (24 warps); without the bound the compiler
// keeps the frame loop's twiddles and window in registers (128 at W = 1024,
// 4 blocks per SM, 11 % slower: tools/profile_torch.py --ablate-stft).
__host__ __device__ constexpr int min_blocks(int log2n) { return log2n <= 9 ? 6 : 3; }

template <int kLog2N, bool kFeatures>
__global__ void __launch_bounds__(kThreads, min_blocks(kLog2N)) stft_aux_kernel(
    const float* __restrict__ sig, const float* __restrict__ window,
    const float2* __restrict__ twiddle,  // FftPlan's table
    float* __restrict__ mag, float* __restrict__ aux, FeatArgs fa,
    int batch, int n, int t_frames, int hop, float pre_emph) {
  constexpr int N = 1 << kLog2N;  // complex points, W / 2
  constexpr int W = 2 * N;
  constexpr int F = N + 1;
  constexpr int kRounds = (F + 31) / 32;
  using Plan = FftPlan<kLog2N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(W, hop, kFeatures);
  float* s_sig = smem;

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * L.tile;
  const int frames_here = min(L.tile, t_frames - t0);
  const int slice = (frames_here - 1) * hop + W;  // <= n - t0*hop by the frame count
  const float* x = sig + (size_t)row * n;
  const int s0 = t0 * hop;

  // stage the tile's samples, pre-emphasized; x[-1] = 0 only at the row start
  for (int i = threadIdx.x; i < slice; i += kThreads) {
    const int p = s0 + i;
    float v = x[p];
    if (pre_emph != 0.f) {
      const float prev = p > 0 ? x[p - 1] : 0.f;
      v = __fsub_rn(v, __fmul_rn(pre_emph, prev));
    }
    s_sig[i] = v;
  }
  if constexpr (kFeatures) {
    if (threadIdx.x < 32)
      reinterpret_cast<int2*>(smem + L.sig)[threadIdx.x] = sums_plan(fa.row_ptr, threadIdx.x);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wbuf = smem + L.sig + L.plan + warp * L.warp_buf;
  float2* buf = reinterpret_cast<float2*>(wbuf);
  const float2* win2 = reinterpret_cast<const float2*>(window);
  const size_t plane = (size_t)batch * t_frames;
  constexpr int kSplit = F / 4;

  for (int f = warp; f < frames_here; f += kWarps) {
    const size_t frame = (size_t)row * t_frames + t0 + f;
    const float* fr = s_sig + f * hop;
    float sq = 0.f;
    int zc = 0;

    // 1. the FFT of z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1], natural order in buf
    fft_first_pass<N, 1 << Plan::log2_radix(0)>(fr, ((f * hop) & 1) == 0, win2, buf, lane, sq, zc);
    __syncwarp();
    fft_passes_from<kLog2N, 1>(buf, twiddle, lane);

    // 2. real-FFT split for bins k = lane + 32 i: 2 X[k] = A + W^k (-i B) with
    //    A = Z[k] + conj Z[N-k], B = Z[k] - conj Z[N-k]
    //    (with features, the lane's descriptor sums over the same bins)
    float pw[kRounds], mg[kRounds];
    float* out = mag + frame * F;
    [[maybe_unused]] Descriptors desc;
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int k = lane + 32 * i;
      if (k < F) {
        const float2 zk = buf[swz(k & (N - 1))];
        const float2 zn = buf[swz((N - k) & (N - 1))];
        const float2 a = make_float2(zk.x + zn.x, zk.y - zn.y);
        const float2 wb = cmul(__ldg(twiddle + k), make_float2(zk.y + zn.y, zn.x - zk.x));
        const float re = a.x + wb.x, im = a.y + wb.y;
        mg[i] = 0.5f * sqrt_approx(re * re + im * im);
        pw[i] = mg[i] * mg[i];
        out[k] = mg[i];
        if constexpr (kFeatures) desc.add(mg[i], pw[i], __ldg(fa.freq_logf + k), k == 0);
      }
    }
    __syncwarp();
    float* s_pow = wbuf;        // [F], the complex points are dead
    float* s_mag = wbuf + F;    // [F], feature epilogue only (the bandwidth's pass)
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int k = lane + 32 * i;
      if (k < F) {
        s_pow[k] = pw[i];
        if constexpr (kFeatures) s_mag[k] = mg[i];
      }
    }
    __syncwarp();

    // 3. aux epilogue: sums over contiguous lane chunks of the power, their
    //    prefix scan, then the rolloff bin inside the chunk that reaches
    //    0.85 of the total, one bin per lane
    {
      constexpr int kChunk = (F + 31) / 32;
      float part = 0.f, low = 0.f, high = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int k = lane * kChunk + t;
        if (k < F) {
          const float pk = s_pow[k];
          part += pk;
          if (k < kSplit) low += pk; else high += pk;
        }
      }
      float incl = part;  // inclusive scan of the lane chunks
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const float total = __shfl_sync(kFull, incl, 31);
      float run = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) run = 0.f;
      const float thr = kRolloff * total;
      const unsigned reach = __ballot_sync(kFull, incl >= thr);  // lane 31 at least
      const int cl = reach ? __ffs(reach) - 1 : 31;
      const float base = __shfl_sync(kFull, run, cl);
      const int kc = cl * kChunk + lane;
      const bool in_chunk = lane < kChunk && kc < F;
      float v = in_chunk ? s_pow[kc] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += y;
      }
      const unsigned at = __ballot_sync(kFull, in_chunk && base + v >= thr);
      const int first = at ? cl * kChunk + __ffs(at) - 1 : min(cl * kChunk + kChunk, F) - 1;
      low = warp_sum(low);
      high = warp_sum(high);
      sq = warp_sum(sq);
      zc = warp_sum_int(zc);
      if (lane == 0) {
        const bool pos = total > 0.f;
        aux[frame] = sqrtf(sq / (float)W);
        aux[plane + frame] = (float)zc;
        aux[2 * plane + frame] = pos ? (float)min(first, F - 1) : 0.f;
        aux[3 * plane + frame] = pos ? low / fmaxf(total, kEps) : 0.f;
        aux[4 * plane + frame] = pos ? high / fmaxf(total, kEps) : 0.f;
      }
    }

    // 4. feature epilogue (K10) on the same buffer
    if constexpr (kFeatures) {
      const int2 plan = reinterpret_cast<const int2*>(smem + L.sig)[lane];
      feature_epilogue(fa, desc, s_pow, s_mag, wbuf + 2 * F, plan, F, frame, lane);
    }
    __syncwarp();  // the buffer is reused by the warp's next frame
  }
}

// Set the kernel's shared-memory size (and the carveout that lets 6 blocks
// share an SM); *smem gets the bytes per block.
template <int kLog2N, bool kFeatures>
cudaError_t prepare(int hop, size_t* smem) {
  *smem = sizeof(float) * Layout(2 << kLog2N, hop, kFeatures).total;
  cudaError_t err = cudaFuncSetAttribute(stft_aux_kernel<kLog2N, kFeatures>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stft_aux_kernel<kLog2N, kFeatures>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// fn(std::integral_constant<int, log2(W/2)>) for a supported window W.
template <class Fn>
int with_log2_half(int w, Fn&& fn) {
  switch (w) {
    case 64: return fn(std::integral_constant<int, 5>{});
    case 128: return fn(std::integral_constant<int, 6>{});
    case 256: return fn(std::integral_constant<int, 7>{});
    case 512: return fn(std::integral_constant<int, 8>{});
    case 1024: return fn(std::integral_constant<int, 9>{});
    case 2048: return fn(std::integral_constant<int, 10>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kFeatures>
int launch_stft(const float* sig, const float* window, const float* twiddle, float* mag,
                float* aux, FeatArgs fa, int batch, int n, int t_frames, int w, int hop,
                float pre_emph, void* stream) {
  if (hop < 1 || t_frames < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_log2_half(w, [&](auto log2_half) {
    constexpr int kLog2N = decltype(log2_half)::value;
    size_t smem;
    const cudaError_t err = prepare<kLog2N, kFeatures>(hop, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tile = Layout(w, hop, kFeatures).tile;
    const dim3 grid((t_frames + tile - 1) / tile, batch);
    stft_aux_kernel<kLog2N, kFeatures><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        sig, window, reinterpret_cast<const float2*>(twiddle), mag, aux, fa, batch, n, t_frames,
        hop, pre_emph);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" const char* sonido_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K1 on `stream`. Window must be a power of two in [64, 2048];
// twiddle is ops/hopper_stft.twiddle_table(W). Returns the CUDA error
// code (0 on success).
extern "C" int sonido_stft_aux(const float* sig, const float* window, const float* twiddle,
                               float* mag, float* aux, int batch, int n, int t_frames,
                               int w, int hop, float pre_emph, void* stream) {
  return launch_stft<false>(sig, window, twiddle, mag, aux, FeatArgs{}, batch, n, t_frames,
                            w, hop, pre_emph, stream);
}

// Launch K1 with the K10 feature epilogue: feat [B, T, 43] besides the
// same magnitudes and aux planes; row_ptr [39] and freq_logf [F, 2] as
// ops/hopper_stft.feature_tables builds them, entries [S, 32, 2] int32 as
// ops/hopper_stft.feature_entries packs and interleaves its bins and
// weights.
extern "C" int sonido_stft_features(const float* sig, const float* window, const float* twiddle,
                                    float* mag, float* aux, float* feat, const int* row_ptr,
                                    const int* entries, const float* freq_logf, int batch, int n,
                                    int t_frames, int w, int hop, float pre_emph, void* stream) {
  const FeatArgs fa{feat, row_ptr, reinterpret_cast<const int2*>(entries),
                    reinterpret_cast<const float2*>(freq_logf)};
  return launch_stft<true>(sig, window, twiddle, mag, aux, fa, batch, n, t_frames, w, hop,
                           pre_emph, stream);
}

// The launch geometry of K1 (features = 0) or K10 (1) at window w, hop:
// shared memory per block and resident blocks per SM on the current card.
extern "C" int sonido_stft_occupancy(int w, int hop, int features, int* smem_bytes,
                                     int* blocks_per_sm) {
  if (hop < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto query = [&](auto log2_half, auto feat) {
    constexpr int kLog2N = decltype(log2_half)::value;
    constexpr bool kF = decltype(feat)::value;
    size_t smem;
    cudaError_t err = prepare<kLog2N, kF>(hop, &smem);
    *smem_bytes = static_cast<int>(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, stft_aux_kernel<kLog2N, kF>, kThreads, smem);
    return static_cast<int>(err);
  };
  return with_log2_half(w, [&](auto log2_half) {
    return features ? query(log2_half, std::true_type{}) : query(log2_half, std::false_type{});
  });
}
