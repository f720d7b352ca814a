// K2: fused YIN pitch — pre-emphasis, framing, difference function,
// CMNDF, first minimum below the threshold, parabolic interpolation and
// range check; only pitch and confidence per frame reach device memory.
//
// Replaces the TPU kernel yin_pitch_pallas in
// sonido_sonar_tpu/ops/pallas_yin.py (:238, body :281, pallas_call
// :370), with its period-amplitude option (:356-368). Same contract:
// [B, N] float32 PCM -> pitch, confidence [B, T] with T = (N - W)/hop + 1;
// H = W/2 lags; pre-emphasis y[n] = x[n] - a x[n-1] with x[-1] = 0 only
// at the start of each row; voicing is the confidence (the wrapper
// returns it twice). With a non-null `amp` the kernel also writes the
// RMS over the first pitch period of the (pre-emphasized) frame:
// plen = clamp((int)(sr / max(pitch, eps)), 1, W - 1) for a voiced
// frame, 1 otherwise; amp = sqrt(sum_{j<plen} x[j]^2 / plen).
//
// K3, the difference rows alone (sonido_yin_difference): replaces the TPU
// kernel yin_difference_pallas (pallas_yin.py:162, pallas_call :206),
// [B, N] -> d [B, T, H], no pre-emphasis. The same kernel template, with
// d written to device memory in place of the CMNDF and the pick.
//
// What bounds it on an H100: operations. The difference function is
// d(tau) = E1 + S(tau) - 2 r(tau) (the plain version's and the TPU
// kernel's formulation): E1 the first half's energy, S the sliding
// half-window energy, r the cross-correlation of the first half with the
// frame. Through real FFTs of W points for r and a prefix sum of squares
// for E1 and S it takes ~83.5 k operations per 1024-sample frame; the
// bytes are 4 per sample in and 8 per frame out (K3: 2 KB per frame out).
// The direct sum over (j, tau) would take ~790 k; the TPU kernel took r
// through bf16x3 DFT matmuls on its MXU, which have no counterpart here.
//
// Design: one warp owns one frame end to end, on K1's warp FFT core
// (csrc/warp_fft.cuh), so nothing after the staging waits on the block.
//   - A block stages the pre-emphasized samples of a tile of consecutive
//     frames once (the only __syncthreads()); the tile is cut so that 4
//     blocks (16 warps) share an SM at W = 1024.
//   - a = x[0:H] zero-padded to W and b = x[0:W], each packed as
//     z[m] = v[2m] + i v[2m+1] (N = W/2 complex points). Pass 0 of both
//     transforms reads the staged samples once (a's upper half is zero);
//     the later passes run on the warp's two buffers.
//   - One lane per bin pair (k, N - k) takes both real-FFT splits, the
//     Hermitian product P = conj(A) B and the inverse split, and stores
//     conj Z in place; the same forward passes on it give r[2m] + i
//     r[2m+1], conjugated and scaled (1/(2W) for 2r). j + tau <= W - 2, so
//     the circular correlation never wraps.
//   - The frame's squares cross A's freed buffer from lane-strided to
//     lane-contiguous order (the swz_scratch swizzle keeps both sides free
//     of bank conflicts). One warp scan over the lanes' chunk sums gives
//     csum[u] = sum_{j<u} x[j]^2 at every lag u and at u + H: S(tau) =
//     csum[tau + H] - csum[tau] (ops/pitch.py forms S the same way),
//     E1 = csum[H], and the period amplitude's sum csum[plen].
//   - Each lane owns H/32 consecutive lags: d, the CMNDF (a warp scan of
//     chunk sums), the first candidate (a warp min); lane 0 interpolates.
//     K3 writes d back through the scratch, 32 consecutive floats per store.
//
// Numerics: fp32 throughout, d = (E1 + S) - 2r rounded as the plain
// version rounds it; pre-emphasis rounded as the plain version rounds it
// (multiply, then subtract); twiddles from the float64-built table of K1
// (ops/hopper_stft.twiddle_table). The numpy model
// ops/hopper_yin.difference_model runs the same pass order, pair order,
// index maps and table reads.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp_fft.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileMax = 16;   // frames per block
constexpr int kSigCap = 5120;  // staged floats per block past which the tile has fewer frames
constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

// The scratch swizzle, in floats: bits 5-9 of the index flip its bits
// 0-4. Lane-strided accesses (32 i + lane) and lane-contiguous chunks
// (c lane + t, c = 4 ... 32) both fall on 32 distinct banks
// (ops/hopper_yin.scratch_swizzle).
__device__ __forceinline__ int swz_scratch(int i) { return i ^ ((i >> 5) & 31); }

// Shared-memory layout, in floats: the staged samples, then per warp two
// buffers of W/2 complex points (A's spectrum, then the scratch; B's
// spectrum, then the inverse transform).
struct Layout {
  int tile, sig, warp_buf, total;
  __host__ __device__ Layout(int w, int hop) {
    const int fit = (kSigCap - w) / hop + 1;  // w <= 2048 < kSigCap, so fit >= 1
    tile = fit < kTileMax ? fit : kTileMax;
    if (tile > kWarps) tile &= ~(kWarps - 1);  // whole rounds of the block's warps
    sig = ((tile - 1) * hop + w + 3) & ~3;
    warp_buf = 2 * w;
    total = sig + kWarps * warp_buf;
  }
};

// Resident blocks per SM the registers must leave room for: what the
// shared memory allows (Layout) at the main path's hops.
__host__ __device__ constexpr int min_blocks(int log2n) {
  return log2n <= 8 ? 6 : log2n == 9 ? 4 : 2;
}

// Pass 0 of both forward transforms from the staged samples: B's of the
// packed frame z[m] = x[2m] + i x[2m+1], A's of its first half (z[m] for
// m < N/2, zero above: in butterfly j, points j + r N/8 with r < 4).
template <int N>
__device__ __forceinline__ void first_pass_pair(const float* fr, bool even, float2* buf_a,
                                                float2* buf_b, int lane) {
  constexpr int R = 8;
  constexpr int kB = N / R;
  constexpr int kSlots = (kB + 31) / 32;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (kB >= 32 || j < kB) {
      float2 vb[R], va[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = j + r * kB;
        if (even) {
          vb[r] = *reinterpret_cast<const float2*>(fr + 2 * m);
        } else {
          vb[r] = make_float2(fr[2 * m], fr[2 * m + 1]);
        }
        va[r] = r < R / 2 ? vb[r] : make_float2(0.f, 0.f);
      }
      dft<R>(vb);
      dft<R>(va);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        buf_b[swz(j * R + r)] = vb[r];
        buf_a[swz(j * R + r)] = va[r];
      }
    }
  }
}

// The real-FFT split of bins k and N - k from Z[k] and Z[N - k] (indices
// mod N), unhalved: 2 X[k] = alpha + gamma, 2 X[N - k] = conj(alpha -
// gamma), with alpha = Z[k] + conj Z[N-k], gamma = W^k (-i)(Z[k] - conj
// Z[N-k]) and W^(N-k) = -conj W^k (K1's split at k, and its mirror).
__device__ __forceinline__ void split_pair(float2 zk, float2 zn, float2 w, float2& xk,
                                           float2& xn) {
  const float2 alpha = make_float2(zk.x + zn.x, zk.y - zn.y);
  const float2 gamma = cmul(w, make_float2(zk.y + zn.y, zn.x - zk.x));
  xk = cadd(alpha, gamma);
  xn = make_float2(alpha.x - gamma.x, gamma.y - alpha.y);
}

// One lane per bin pair (k, N - k), k in [0, N/2]: both splits, the
// product P = conj(A) B at k and N - k, and the inverse split Z[k] = mu +
// delta, Z[N - k] = conj(mu - delta) with mu = P[k] + conj P[N-k],
// delta = i conj(W^k) (P[k] - conj P[N-k]). conj Z replaces B's spectrum
// in place (k = 0 and N/2 are their own mirrors; the k store comes last).
// The spectra are unhalved, so Z is 8x the packed spectrum of r.
template <int N>
__device__ __forceinline__ void cross_spectrum(const float2* buf_a, float2* buf_b,
                                               const float2* __restrict__ tw, int lane) {
  constexpr int kPairs = N / 2 + 1;
  constexpr int kRounds = (kPairs + 31) / 32;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int k = lane + 32 * i;
    if (k < kPairs) {
      const int kn = (N - k) & (N - 1);
      const float2 w = __ldg(tw + k);
      float2 ak, an, bk, bn;
      split_pair(buf_a[swz(k)], buf_a[swz(kn)], w, ak, an);
      split_pair(buf_b[swz(k)], buf_b[swz(kn)], w, bk, bn);
      const float2 pk = cmul(make_float2(ak.x, -ak.y), bk);
      const float2 pn = cmul(make_float2(an.x, -an.y), bn);
      const float2 mu = make_float2(pk.x + pn.x, pk.y - pn.y);
      const float2 t = cmul(make_float2(w.x, -w.y), make_float2(pk.x - pn.x, pk.y + pn.y));
      const float2 delta = make_float2(-t.y, t.x);
      buf_b[swz(kn)] = csub(mu, delta);
      buf_b[swz(k)] = make_float2(mu.x + delta.x, -(mu.y + delta.y));
    }
  }
}

// The pick's and the period amplitude's outputs and constants (all null
// and 0 for K3).
struct PickArgs {
  float* pitch;
  float* conf;
  float* amp;  // null: no period amplitude
  float sample_rate, min_freq, max_freq, threshold;
};

template <int kLog2N, bool kRows>
__global__ void __launch_bounds__(kThreads, min_blocks(kLog2N)) yin_kernel(
    const float* __restrict__ sig, const float2* __restrict__ twiddle,
    float* __restrict__ rows,  // K3: d [B, T, H]
    PickArgs pa, int n, int t_frames, int hop, float pre_emph) {
  constexpr int N = 1 << kLog2N;  // complex points, W / 2; also the H lags
  constexpr int W = 2 * N;
  constexpr int H = N;
  constexpr int kC = H / 32;                 // lags per lane
  constexpr float kScale2 = 1.f / (2 * W);   // 2r from the inverse's output
  static_assert(FftPlan<kLog2N>::log2_radix(0) == 3, "pass 0 is radix 8");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(W, hop);
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
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* buf_a = reinterpret_cast<float2*>(smem + L.sig + warp * L.warp_buf);
  float2* buf_b = buf_a + N;
  float* scratch = reinterpret_cast<float*>(buf_a);  // W floats once A is consumed

  for (int f = warp; f < frames_here; f += kWarps) {
    const size_t frame = (size_t)row * t_frames + t0 + f;
    const float* fr = s_sig + f * hop;

    // 1. the forward transforms of a and b, natural order in their buffers
    first_pass_pair<N>(fr, ((f * hop) & 1) == 0, buf_a, buf_b, lane);
    __syncwarp();
    fft_passes_from<kLog2N, 1>(buf_a, twiddle, lane);
    fft_passes_from<kLog2N, 1>(buf_b, twiddle, lane);

    // 2. the splits, the product and the inverse split: conj Z in B's buffer
    cross_spectrum<N>(buf_a, buf_b, twiddle, lane);
    __syncwarp();

    // 3. the frame's squares into the scratch, lane-strided
#pragma unroll
    for (int i = 0; i < W / 32; ++i) {
      const float v = fr[32 * i + lane];
      scratch[swz_scratch(32 * i + lane)] = v * v;
    }

    // 4. the inverse transform: the forward passes on conj Z
    fft_passes_from<kLog2N, 0>(buf_b, twiddle, lane);

    // 5. lane-contiguous lags u = lane kC + t: the squares of samples u and
    //    u + H, their prefix sums, and d(u) = (E1 + S(u)) - 2 r(u)
    float q1[kC], q2[kC], d[kC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      q1[t] = scratch[swz_scratch(lane * kC + t)];
      q2[t] = scratch[swz_scratch(H + lane * kC + t)];
      s1 += q1[t];
      s2 += q2[t];
    }
    float i1 = s1, i2 = s2;  // inclusive scans of the chunk sums
    for (int o = 1; o < 32; o <<= 1) {
      const float y1 = __shfl_up_sync(kFull, i1, o);
      const float y2 = __shfl_up_sync(kFull, i2, o);
      if (lane >= o) {
        i1 += y1;
        i2 += y2;
      }
    }
    const float e1 = __shfl_sync(kFull, i1, 31);
    float c1 = __shfl_up_sync(kFull, i1, 1);  // csum[lane kC]
    float c2 = __shfl_up_sync(kFull, i2, 1);
    if (lane == 0) c1 = c2 = 0.f;
    c2 += e1;  // csum[H + lane kC]
    const float base1 = c1, base2 = c2;
#pragma unroll
    for (int t = 0; t < kC; t += 2) {
      const float2 y = buf_b[swz((lane * kC + t) >> 1)];  // 2r = (y.x, -y.y) / (2W)
      d[t] = (e1 + (c2 - c1)) - y.x * kScale2;
      c1 += q1[t];
      c2 += q2[t];
      d[t + 1] = (e1 + (c2 - c1)) + y.y * kScale2;
      c1 += q1[t + 1];
      c2 += q2[t + 1];
    }
    __syncwarp();  // every lane has read its squares: the scratch is free

    if constexpr (kRows) {
      // 6. K3: d through the scratch, then 32 consecutive floats per store
#pragma unroll
      for (int t = 0; t < kC; ++t) scratch[swz_scratch(lane * kC + t)] = d[t];
      __syncwarp();
      float* out = rows + frame * H;
#pragma unroll
      for (int i = 0; i < kC; ++i) out[32 * i + lane] = scratch[swz_scratch(32 * i + lane)];
    } else {
      // 6. CMNDF: running(u) = sum_{v=1..u} d(v), a warp scan of the chunk
      //    sums; cm(0) = 1, cm(u) = d(u) u / max(running(u), eps)
      float loc[kC];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        run += lane * kC + t == 0 ? 0.f : d[t];
        loc[t] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      float base = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) base = 0.f;
      float cm[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const int u = lane * kC + t;
        cm[t] = u == 0 ? 1.f : d[t] * (float)u / fmaxf(base + loc[t], kEps);
      }

      // 7. the first u >= 1 with cm(u) < threshold and cm(u) < cm(u + 1),
      //    cm(H) = inf; the neighbours of the pick through the scratch
      float after = __shfl_down_sync(kFull, cm[0], 1);
      if (lane == 31) after = INFINITY;
      int first = H;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        const int u = lane * kC + t;
        const float c = cm[t];
        if (u >= 1 && c < pa.threshold && c < after) first = u;
        after = c;
      }
      first = __reduce_min_sync(kFull, first);
#pragma unroll
      for (int t = 0; t < kC; ++t) scratch[swz_scratch(lane * kC + t)] = cm[t];
      __syncwarp();

      int plen = 1;
      if (lane == 0) {
        int tau = first;
        const bool has = tau < H;
        if (!has) tau = 0;
        const float y0 = scratch[swz_scratch(max(tau - 1, 0))];
        const float y1 = scratch[swz_scratch(tau)];
        const float y2 = scratch[swz_scratch(min(tau + 1, H - 1))];
        const float denom = y0 - 2.f * y1 + y2;
        const float shift = fabsf(denom) > kEps ? 0.5f * (y0 - y2) / denom : 0.f;
        const bool interior = tau > 0 && tau < H - 1;
        const float period = (float)tau + (interior ? shift : 0.f);
        const float freq = pa.sample_rate / fmaxf(period, kEps);
        const bool ok = has && freq >= pa.min_freq && freq <= pa.max_freq;
        const float p = ok ? freq : 0.f;
        pa.pitch[frame] = p;
        pa.conf[frame] = ok ? 1.f - y1 : 0.f;
        // IEEE division and a truncating cast, as the plain version does them
        const int pl = p > 0.f ? (int)__fdiv_rn(pa.sample_rate, fmaxf(p, kEps)) : 0;
        plen = min(max(pl, 1), W - 1);
      }

      // 8. the period amplitude: csum[plen] from the lane that holds it
      if (pa.amp != nullptr) {  // uniform across the grid
        plen = __shfl_sync(kFull, plen, 0);
        const bool low = plen < H;
        const int rel = low ? plen : plen - H;
        const int off = rel % kC;
        float acc = low ? base1 : base2;
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          if (t < off) acc += low ? q1[t] : q2[t];
        }
        acc = __shfl_sync(kFull, acc, rel / kC);
        if (lane == 0) pa.amp[frame] = sqrtf(__fdiv_rn(acc, (float)plen));
      }
    }
    __syncwarp();  // the buffers are reused by the warp's next frame
  }
}

// Set the kernel's shared-memory size (and the carveout that lets several
// blocks share an SM); *smem gets the bytes per block.
template <int kLog2N, bool kRows>
cudaError_t prepare(int hop, size_t* smem) {
  *smem = sizeof(float) * Layout(2 << kLog2N, hop).total;
  cudaError_t err = cudaFuncSetAttribute(yin_kernel<kLog2N, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(yin_kernel<kLog2N, kRows>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// fn(std::integral_constant<int, log2(W/2)>) for a supported window W.
template <class Fn>
int with_log2_half(int w, Fn&& fn) {
  switch (w) {
    case 256: return fn(std::integral_constant<int, 7>{});
    case 512: return fn(std::integral_constant<int, 8>{});
    case 1024: return fn(std::integral_constant<int, 9>{});
    case 2048: return fn(std::integral_constant<int, 10>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kRows>
int launch_yin(const float* sig, const float* twiddle, float* rows, PickArgs pa, int batch,
               int n, int t_frames, int w, int hop, float pre_emph, void* stream) {
  if (hop < 1 || t_frames < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_log2_half(w, [&](auto log2_half) {
    constexpr int kLog2N = decltype(log2_half)::value;
    size_t smem;
    const cudaError_t err = prepare<kLog2N, kRows>(hop, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tile = Layout(w, hop).tile;
    const dim3 grid((t_frames + tile - 1) / tile, batch);
    yin_kernel<kLog2N, kRows><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        sig, reinterpret_cast<const float2*>(twiddle), rows, pa, n, t_frames, hop, pre_emph);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Launch K2 on `stream`. Window must be 256, 512, 1024 or 2048; twiddle is
// ops/hopper_stft.twiddle_table(W); `amp` may be null (no period
// amplitude). Returns the CUDA error code (0 on success).
extern "C" int sonido_yin_pitch(const float* sig, const float* twiddle, float* pitch,
                                float* conf, float* amp, int batch, int n, int t_frames, int w,
                                int hop, float pre_emph, float sample_rate, float min_freq,
                                float max_freq, float threshold, void* stream) {
  const PickArgs pa{pitch, conf, amp, sample_rate, min_freq, max_freq, threshold};
  return launch_yin<false>(sig, twiddle, nullptr, pa, batch, n, t_frames, w, hop, pre_emph,
                           stream);
}

// Launch K3 on `stream`: d [B, T, W/2] of the raw (not pre-emphasized)
// signal. Window must be 256, 512, 1024 or 2048; twiddle as for K2.
// Returns the CUDA error code (0 on success).
extern "C" int sonido_yin_difference(const float* sig, const float* twiddle, float* d, int batch,
                                     int n, int t_frames, int w, int hop, void* stream) {
  return launch_yin<true>(sig, twiddle, d, PickArgs{}, batch, n, t_frames, w, hop, 0.f,
                          stream);
}

// The launch geometry of K2 (rows = 0) or K3 (1) at window w, hop: shared
// memory per block and resident blocks per SM on the current card.
extern "C" int sonido_yin_occupancy(int w, int hop, int rows, int* smem_bytes,
                                    int* blocks_per_sm) {
  if (hop < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto query = [&](auto log2_half, auto as_rows) {
    constexpr int kLog2N = decltype(log2_half)::value;
    constexpr bool kR = decltype(as_rows)::value;
    size_t smem;
    cudaError_t err = prepare<kLog2N, kR>(hop, &smem);
    *smem_bytes = static_cast<int>(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, yin_kernel<kLog2N, kR>,
                                                          kThreads, smem);
    return static_cast<int>(err);
  };
  return with_log2_half(w, [&](auto log2_half) {
    return rows ? query(log2_half, std::true_type{}) : query(log2_half, std::false_type{});
  });
}
