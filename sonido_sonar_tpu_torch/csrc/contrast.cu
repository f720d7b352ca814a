// K9: sort-free spectral-contrast band selection — per frame and band,
// the means of the k largest and the k smallest powers.
//
// Replaces the TPU kernel band_select_means_pallas in
// sonido_sonar_tpu/ops/pallas_contrast.py (:140, _contrast_kernel :85,
// pallas_call :172). Same contract: magnitude [R, F] float32 (R frames)
// and bands [NB, 3] int32 (lo, hi, k) -> peak, valley [R, NB], the means
// of the top and bottom k of p = m * m over bins [lo, hi); a band with
// lo >= hi gives 0 for both.
//
// The TPU kernel searched for the k-th value over 22-bit quantized keys
// with per-band count matmuls on its MXU and filled the tie bucket with
// its mean. Here the search is exact: p >= 0, so its 31-bit pattern
// orders like its value, and the k-th largest key t is found bit by bit
// from the most significant: keep bit b iff #{x >= t | b} >= k. The k-th
// smallest is the (w - k + 1)-th largest, so both selections count keys
// >= a threshold. Then
//   peak = (sum_{x > t} x + (k - #{x > t}) t) / k,
// and likewise the valley below the k-th smallest; equal to the mean of
// a full sort up to fp32 summation order.
//
// What bounds it on an H100: the rounds' compares, one per key per
// selection per round, issued by the SMs; the magnitudes are read once
// (4F bytes per frame), the outputs are 8 NB bytes per frame.
//
// The lane plan (band_means_lanes_kernel), for band tables that fit a
// warp (ops/hopper_contrast.band_plan): one warp per frame; each band
// owns an aligned group of a power-of-two lanes sized to its width, and
// each lane holds its band's keys in registers (18 at most at 1024 /
// 44.1 kHz: K = 18 slots; the plan's count is rounded up to an
// instantiation, see kMaxLaneKeys). All twelve selections of the six bands
// move one bit per round together, so a frame is one chain of rounds,
// not one per band: per round a lane counts its keys against its band's
// two thresholds (the top count in the low 16 bits, the bottom's in the
// high 16), an xor tree of shuffles totals the group, and the loop ends
// for the warp once every selection's bucket [prefix, prefix + 2^bit)
// holds one key (well short of 31 rounds on the test PCM's spectra, by
// the model's round count). A last pass
// takes the sums above and below the two k-th keys and the bucket's one
// key. Small bands cost nothing apart: their lanes run beside the wide
// band's. ops/hopper_contrast.band_means_model replays the plan.
//
// The general form (band_means_kernel), for any other table (more than
// 32 bands, a band of 2^16 bins, more than kMaxLaneKeys keys a lane, as
// at W = 4096): the frame's
// keys in shared memory (F words per warp), band by band, 31 rounds of
// two warp reductions each.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;  // frames per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMaxKey = 0x7fffffffu;

__global__ void __launch_bounds__(kThreads) band_means_kernel(
    const float* __restrict__ mag, const int* __restrict__ bands, float* __restrict__ peak,
    float* __restrict__ valley, long long frames, int f_bins, int nb) {
  extern __shared__ unsigned s_key[];  // [kWarps][f_bins]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * kWarps + warp;
  if (frame >= frames) return;  // the whole warp; no block barrier follows
  unsigned* key = s_key + (size_t)warp * f_bins;
  const float* m = mag + frame * f_bins;
  for (int k = lane; k < f_bins; k += 32) {
    const float v = m[k];
    key[k] = __float_as_uint(v * v);
  }
  __syncwarp();

  for (int b = 0; b < nb; ++b) {
    const int lo = bands[3 * b], hi = bands[3 * b + 1], kk = bands[3 * b + 2];
    float pk = 0.f, vl = 0.f;
    if (lo < hi) {
      unsigned top = 0, bot = 0;  // k-th largest key; k-th largest reversed key
      for (int bit = 30; bit >= 0; --bit) {
        const unsigned ct = top | (1u << bit), cb = bot | (1u << bit);
        unsigned nt = 0, nbot = 0;
        for (int k = lo + lane; k < hi; k += 32) {
          const unsigned x = key[k];
          nt += x >= ct;
          nbot += kMaxKey - x >= cb;
        }
        if (__reduce_add_sync(kFull, nt) >= (unsigned)kk) top = ct;
        if (__reduce_add_sync(kFull, nbot) >= (unsigned)kk) bot = cb;
      }
      const unsigned low = kMaxKey - bot;  // k-th smallest key
      float s_top = 0.f, s_bot = 0.f;
      unsigned n_top = 0, n_bot = 0;
      for (int k = lo + lane; k < hi; k += 32) {
        const unsigned x = key[k];
        if (x > top) {
          s_top += __uint_as_float(x);
          ++n_top;
        }
        if (x < low) {
          s_bot += __uint_as_float(x);
          ++n_bot;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        s_top += __shfl_xor_sync(kFull, s_top, o);
        s_bot += __shfl_xor_sync(kFull, s_bot, o);
      }
      n_top = __reduce_add_sync(kFull, n_top);
      n_bot = __reduce_add_sync(kFull, n_bot);
      const float kf = (float)kk;
      pk = (s_top + (float)(kk - (int)n_top) * __uint_as_float(top)) / kf;
      vl = (s_bot + (float)(kk - (int)n_bot) * __uint_as_float(low)) / kf;
    }
    if (lane == 0) {
      peak[frame * nb + b] = pk;
      valley[frame * nb + b] = vl;
    }
  }
}

// The lane plan: K key slots per lane. lanes[lane] = (band or -1, first
// bin, group size, keys); gmax the largest group.
template <int K>
__global__ void __launch_bounds__(kThreads) band_means_lanes_kernel(
    const float* __restrict__ mag, const int* __restrict__ bands, const int4* __restrict__ lanes,
    float* __restrict__ peak, float* __restrict__ valley, long long frames, int f_bins, int nb,
    int gmax) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * kWarps + warp;
  if (frame >= frames) return;  // the whole warp
  const int4 me = lanes[lane];
  const float* m = mag + frame * f_bins + me.y;
  unsigned key[K];  // 0 in unused slots: every threshold is >= 1
#pragma unroll
  for (int s = 0; s < K; ++s) {
    key[s] = 0u;
    if (s < me.w) {
      const float v = __ldg(m + s * me.z);
      key[s] = __float_as_uint(v * v);
    }
  }
  int w = 0, k = 1;
  if (me.x >= 0) {
    w = bands[3 * me.x + 1] - bands[3 * me.x];
    k = bands[3 * me.x + 2];
  }
  // ranks among the largest: the k-th largest; the k-th smallest
  const unsigned r_top = k, r_bot = w - k + 1;
  // per selection: prefix, #{x >= prefix}, #{x >= prefix + 2^bit}
  unsigned pt = 0u, gt = w, at = 0u, pb = 0u, gb = w, ab = 0u;
  int bit = 31;
  while (bit > 0) {
    const unsigned half = 1u << (bit - 1), ct = pt | half, cb = pb | half;
    unsigned nt = 0u, nbt = 0u;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      nt += key[s] >= ct;
      nbt += key[s] >= cb;
    }
    unsigned c = nt | (nbt << 16);
    for (int o = gmax >> 1; o > 0; o >>= 1) {
      const unsigned y = __shfl_xor_sync(kFull, c, o);
      if (o < me.z) c += y;
    }
    const unsigned c_t = c & 0xffffu, c_b = c >> 16;
    if (c_t >= r_top) {
      pt = ct;
      gt = c_t;
    } else {
      at = c_t;
    }
    if (c_b >= r_bot) {
      pb = cb;
      gb = c_b;
    } else {
      ab = c_b;
    }
    --bit;
    if (!__any_sync(kFull, me.x >= 0 && (gt - at > 1u || gb - ab > 1u))) break;
  }
  // each bucket [p, p + 2^bit) holds one key (or bit is 0: the prefix)
  const unsigned ut = pt + (1u << bit), ub = pb + (1u << bit);
  float s_top = 0.f, s_bot = 0.f;
  unsigned t_top = 0u, t_bot = 0u;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const unsigned x = key[s];
    if (x >= ut) s_top += __uint_as_float(x);
    if (x < pb) s_bot += __uint_as_float(x);
    if (x >= pt && x < ut) t_top += x;
    if (x >= pb && x < ub) t_bot += x;
  }
  for (int o = gmax >> 1; o > 0; o >>= 1) {
    const float a = __shfl_xor_sync(kFull, s_top, o), b = __shfl_xor_sync(kFull, s_bot, o);
    const unsigned c = __shfl_xor_sync(kFull, t_top, o), d = __shfl_xor_sync(kFull, t_bot, o);
    if (o < me.z) {
      s_top += a;
      s_bot += b;
      t_top += c;
      t_bot += d;
    }
  }
  if (me.x >= 0 && (lane & (me.z - 1)) == 0) {
    const float top = __uint_as_float(bit == 0 ? pt : t_top);
    const float low = __uint_as_float(bit == 0 ? pb : t_bot);
    const float kf = (float)k;
    peak[frame * nb + me.x] = (s_top + (float)(k - (int)at) * top) / kf;
    valley[frame * nb + me.x] = (s_bot + (float)(k - (w - (int)gb)) * low) / kf;
  }
  if (lane < nb && bands[3 * lane] >= bands[3 * lane + 1]) {  // a degenerate band
    peak[frame * nb + lane] = 0.f;
    valley[frame * nb + lane] = 0.f;
  }
}

// The lane plan's instantiations, in key slots per lane: every even
// count up to 32, then steps of 8 up to kMaxLaneKeys. A plan whose lanes
// need `keys` slots runs at the smallest K >= keys: the slots past a
// lane's keys hold 0, which no threshold counts and which adds 0 to every
// sum, so the result does not depend on K. A plan past kMaxLaneKeys takes
// the general form.
constexpr int kMaxLaneKeys = 64;
constexpr int next_lane_keys(int k) { return k < 32 ? k + 2 : k + 8; }

// f(std::integral_constant<int, K>) for the smallest instantiation K >=
// keys (1 <= keys <= kMaxLaneKeys).
template <int K, typename F>
cudaError_t with_lane_keys(int keys, F&& f) {
  if (keys <= K) return f(std::integral_constant<int, K>{});
  if constexpr (K < kMaxLaneKeys) {
    return with_lane_keys<next_lane_keys(K)>(keys, f);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch K9 on `stream`: magnitude [frames, F], bands [nb, 3] (lo, hi, k)
// -> peak, valley [frames, nb]. `lanes` [32, 4] is the lane plan
// (ops/hopper_contrast.band_plan), `keys` the most key slots one of its
// lanes needs and gmax its largest group; keys == 0 (no plan) or past
// kMaxLaneKeys: the general form (lanes unused). Returns the CUDA error
// code (0 on success).
extern "C" int sonido_contrast_band_means(const float* mag, const int* bands, const int* lanes,
                                          float* peak, float* valley, long long frames,
                                          int f_bins, int nb, int keys, int gmax, void* stream) {
  if (frames < 1 || f_bins < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((frames + kWarps - 1) / kWarps);
  if (keys < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (keys > 0 && keys <= kMaxLaneKeys) {
    return static_cast<int>(with_lane_keys<2>(keys, [&](auto k) {
      band_means_lanes_kernel<decltype(k)::value><<<blocks, kThreads, 0, st>>>(
          mag, bands, reinterpret_cast<const int4*>(lanes), peak, valley, frames, f_bins, nb,
          gmax);
      return cudaGetLastError();
    }));
  }
  const size_t smem = sizeof(unsigned) * kWarps * f_bins;
  cudaError_t err = cudaFuncSetAttribute(
      band_means_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_means_kernel<<<blocks, kThreads, smem, st>>>(mag, bands, peak, valley, frames, f_bins, nb);
  return static_cast<int>(cudaGetLastError());
}

// K9's resources for a lane plan needing `keys` slots per lane (0 or past
// kMaxLaneKeys: the general form at F = f_bins): registers, local (spill)
// bytes, shared memory per block and resident blocks per SM. Returns the
// CUDA error code.
extern "C" int sonido_contrast_occupancy(int keys, int f_bins, int* regs, int* local_bytes,
                                         int* smem, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err;
  int dynamic = 0;
  if (keys < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (keys > 0 && keys <= kMaxLaneKeys) {
    err = with_lane_keys<2>(keys, [&](auto k) {
      const cudaError_t e = cudaFuncGetAttributes(&attr, band_means_lanes_kernel<decltype(k)::value>);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, band_means_lanes_kernel<decltype(k)::value>, kThreads, 0);
    });
  } else {
    dynamic = static_cast<int>(sizeof(unsigned) * kWarps * f_bins);
    err = cudaFuncSetAttribute(band_means_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dynamic);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, band_means_kernel);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, band_means_kernel, kThreads,
                                                          dynamic);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(attr.sharedSizeBytes) + dynamic;
  return 0;
}
