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
// orders like its value, and one warp per frame finds, band by band, the
// exact k-th largest key t (and, on the reversed keys 0x7fffffff - x,
// the k-th smallest) bit by bit from the most significant: keep bit b iff
// #{x >= t | b} >= k, a count each lane takes over its share of the band
// and __reduce_add_sync totals. Then
//   peak = (sum_{x > t} x + (k - #{x > t}) t) / k,
// and likewise the valley below the k-th smallest; equal to the mean of
// a full sort up to fp32 summation order. The frame's keys sit in shared
// memory (F words per warp).
//
// What bounds it on an H100: the 31 search rounds, each two compares per
// band element and two warp reductions per band; the magnitudes are read
// once (4F bytes per frame), the outputs are 8 NB bytes per frame.

#include <cuda_runtime.h>

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

}  // namespace

// Launch K9 on `stream`: magnitude [frames, F], bands [nb, 3] (lo, hi, k)
// -> peak, valley [frames, nb]. Returns the CUDA error code (0 on success).
extern "C" int sonido_contrast_band_means(const float* mag, const int* bands, float* peak,
                                          float* valley, long long frames, int f_bins, int nb,
                                          void* stream) {
  if (frames < 1 || f_bins < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(unsigned) * kWarps * f_bins;
  cudaError_t err = cudaFuncSetAttribute(
      band_means_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((frames + kWarps - 1) / kWarps);
  band_means_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, bands, peak, valley, frames, f_bins, nb);
  return static_cast<int>(cudaGetLastError());
}
