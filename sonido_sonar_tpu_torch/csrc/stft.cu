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
// What bounds it on an H100: the DFT. As a matmul against the [W, 2F]
// windowed basis (the TPU's choice, made for its MXU) it is ~2.1 MFLOP
// per frame, 1.4 TFLOP per 128 x 30 s batch of fp32 work. Here each frame
// is windowed in shared memory and transformed by a W/2-point complex
// radix-2 FFT of the packed real signal (z[m] = x[2m] + i x[2m+1]) plus
// the real-FFT split, ~50 kFLOP per frame: the kernel is then bound by
// shared-memory traffic of the butterflies and by writing the magnitudes
// (4 * F bytes per frame) to device memory, not by arithmetic. The signal
// is read once: one block stages the samples of kTile frames
// ((kTile-1)*hop + W floats) in shared memory, so the 4x-overlapped
// [B, T, W] frames tensor never exists in device memory.
//
// Numerics: fp32 throughout; pre-emphasis is rounded exactly like the
// plain PyTorch version (multiply, then subtract) so the zero-crossing
// counts see the same samples. Twiddles come from the host, built in
// float64.
//
// K10, the feature epilogue (sonido_stft_features): replaces the
// with_features=True epilogue of the same TPU kernel (pallas_stft.py
// :334-417). After the aux epilogue, on the frame's power and magnitudes
// still in shared memory, it writes feat [B, T, 43]: 26 mel energies and
// the 12-class chroma fold of the power (each a weighted sum over a
// compressed sparse row table from the host: a mel filter is a run of
// bins, a bin folds into at most one chroma class, so ~2F products per
// frame instead of the TPU's dense [F, 64] matmuls), the chroma
// normalized to unit sum, and the descriptor bundle's centroid,
// bandwidth (its second pass over (f - centroid)^2 m, not the TPU's
// moment expansion), flatness, crest and slope, finished per frame as
// ops/spectral.frame_descriptors finishes them. All fp32; the TPU's bf16
// hi/lo tiers existed for its MXU and have no counterpart. What bounds
// it: the same magnitude write as K1 (the epilogue adds 43 floats per
// frame against 513) and the per-frame reductions, one warp per frame.
// The K1 launch (sonido_stft_aux) is the same template without the
// epilogue, so its code and its bits are unchanged.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 32;      // frames per block
constexpr int kGroup = 4;      // frames transformed at once (one warp each in the epilogue)
constexpr float kEps = 1e-10f;
constexpr float kRolloff = 0.85f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMel = 26;                  // feat lanes 0-25
constexpr int kChroma = 12;               // feat lanes 26-37
constexpr int kSums = kMel + kChroma;     // rows of the sparse table
constexpr int kFeatLanes = kSums + 5;     // + centroid, bandwidth, flatness, crest, slope
constexpr float kInvLn10 = 0.43429448190325176f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared-memory layout, in floats; every float2 array starts at an even
// offset. The feature epilogue adds the group's magnitudes and chroma sums.
struct Layout {
  int sig, win, tw, buf, pow, mag, chroma, total;
  __host__ __device__ Layout(int w, int hop, bool features) {
    const int half = w / 2;
    sig = 0;
    win = ((kTile - 1) * hop + w + 3) & ~3;
    tw = win + w;
    buf = tw + 2 * (half + 2);
    pow = buf + 2 * kGroup * half;
    mag = pow + kGroup * (half + 1);
    chroma = mag + (features ? kGroup * (half + 1) : 0);
    total = chroma + (features ? kGroup * kChroma : 0);
  }
};

// The feature epilogue's output and constants (all null for K1 alone).
struct FeatArgs {
  float* feat;                 // [B, T, kFeatLanes]
  const int* row_ptr;          // [kSums + 1]
  const int* bin;              // [nnz]
  const float* weight;         // [nnz]
  const float2* freq_logf;     // [F]: (f, log10 f or 0 at f = 0)
};

template <bool kFeatures>
__global__ void __launch_bounds__(kThreads) stft_aux_kernel(
    const float* __restrict__ sig, const float* __restrict__ window,
    const float2* __restrict__ twiddle,  // [W/2 + 1]: exp(-2 pi i k / W)
    float* __restrict__ mag, float* __restrict__ aux, FeatArgs fa,
    int batch, int n, int t_frames, int w, int log2_half, int hop, float pre_emph) {
  extern __shared__ float smem[];
  const Layout L(w, hop, kFeatures);
  float* s_sig = smem + L.sig;
  float* s_win = smem + L.win;
  float2* s_tw = reinterpret_cast<float2*>(smem + L.tw);
  float2* s_buf = reinterpret_cast<float2*>(smem + L.buf);
  float* s_pow = smem + L.pow;
  float* s_mag = smem + L.mag;
  float* s_chroma = smem + L.chroma;

  const int half = w >> 1;
  const int f_bins = half + 1;
  const int split = f_bins / 4;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int frames_here = min(kTile, t_frames - t0);
  const int slice = (frames_here - 1) * hop + w;  // <= n - t0*hop by the frame count
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
  for (int i = threadIdx.x; i < w; i += kThreads) s_win[i] = window[i];
  for (int i = threadIdx.x; i <= half; i += kThreads) s_tw[i] = twiddle[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < frames_here; g0 += kGroup) {
    const int ng = min(kGroup, frames_here - g0);

    // 1. windowed frames packed as z[m] = x[2m] + i x[2m+1], bit-reversed
    for (int i = threadIdx.x; i < kGroup * half; i += kThreads) {
      const int f = i >> log2_half, m = i & (half - 1);
      float2 z = make_float2(0.f, 0.f);
      if (f < ng) {
        const float* fr = s_sig + (g0 + f) * hop;
        z = make_float2(fr[2 * m] * s_win[2 * m], fr[2 * m + 1] * s_win[2 * m + 1]);
      }
      s_buf[f * half + (__brev(m) >> (32 - log2_half))] = z;
    }
    __syncthreads();

    // 2. iterative radix-2 decimation-in-time FFT of length W/2
    for (int s = 0; s < log2_half; ++s) {
      const int m = 1 << s;                 // butterfly span
      const int tw_stride = w >> (s + 1);   // exp(-2 pi i pos / 2m) = tw[pos * W / 2m]
      for (int i = threadIdx.x; i < kGroup * (half >> 1); i += kThreads) {
        const int f = i >> (log2_half - 1), b = i & ((half >> 1) - 1);
        const int pos = b & (m - 1);
        const int i0 = ((b >> s) << (s + 1)) + pos;
        float2* a = s_buf + f * half;
        const float2 u = a[i0];
        const float2 v = cmul(a[i0 + m], s_tw[pos * tw_stride]);
        a[i0] = make_float2(u.x + v.x, u.y + v.y);
        a[i0 + m] = make_float2(u.x - v.x, u.y - v.y);
      }
      __syncthreads();
    }

    // 3. real-FFT split: X[k] = E[k] + W^k O[k] with
    //    E = (Z[k] + conj Z[N2-k]) / 2, O = (Z[k] - conj Z[N2-k]) / 2i
    for (int i = threadIdx.x; i < kGroup * f_bins; i += kThreads) {
      const int f = i / f_bins, k = i - f * f_bins;
      if (f < ng) {
        const float2* a = s_buf + f * half;
        const float2 zk = a[k & (half - 1)];
        const float2 zc = a[(half - k) & (half - 1)];
        const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
        const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
        const float2 wo = cmul(s_tw[k], o);
        const float re = e.x + wo.x, im = e.y + wo.y;
        const float mg = sqrtf(re * re + im * im);
        mag[((size_t)row * t_frames + t0 + g0 + f) * f_bins + k] = mg;
        s_pow[f * f_bins + k] = mg * mg;
        if constexpr (kFeatures) s_mag[f * f_bins + k] = mg;
      }
    }
    __syncthreads();

    // 4. epilogue: warps 0..3 read the spectra, warps 4..7 the samples
    const size_t plane = (size_t)batch * t_frames;
    if (warp < kGroup) {
      const int f = warp;
      if (f < ng) {
        const float* p = s_pow + f * f_bins;
        const int chunk = (f_bins + 31) / 32;
        const int lo = min(lane * chunk, f_bins), hi = min(lo + chunk, f_bins);
        float part = 0.f, low = 0.f, high = 0.f;
        for (int k = lo; k < hi; ++k) {
          part += p[k];
          if (k < split) low += p[k]; else high += p[k];
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
        int first = f_bins;
        for (int k = lo; k < hi; ++k) {
          run += p[k];
          if (run >= thr) { first = k; break; }
        }
        first = warp_min_int(first);
        low = warp_sum(low);
        high = warp_sum(high);
        if (lane == 0) {
          const size_t o = (size_t)row * t_frames + t0 + g0 + f;
          const bool pos = total > 0.f;
          aux[2 * plane + o] = pos ? (float)min(first, f_bins - 1) : 0.f;
          aux[3 * plane + o] = pos ? low / fmaxf(total, kEps) : 0.f;
          aux[4 * plane + o] = pos ? high / fmaxf(total, kEps) : 0.f;
        }
      }
    } else {
      const int f = warp - kGroup;
      if (f < ng) {
        const float* fr = s_sig + (g0 + f) * hop;
        float sq = 0.f;
        int zc = 0;
        for (int j = lane; j < w; j += 32) {
          const float v = fr[j];
          sq += v * v;
          if (j + 1 < w) zc += (v >= 0.f) != (fr[j + 1] >= 0.f);
        }
        sq = warp_sum(sq);
        zc = warp_sum_int(zc);
        if (lane == 0) {
          const size_t o = (size_t)row * t_frames + t0 + g0 + f;
          aux[o] = sqrtf(sq / (float)w);
          aux[plane + o] = (float)zc;
        }
      }
    }

    // 5. feature epilogue (K10); steps 4 and 5a only read s_pow and s_mag
    if constexpr (kFeatures) {
      const size_t frame0 = (size_t)row * t_frames + t0 + g0;
      if (warp < kGroup) {
        // 5a. warps 0..3: one frame each, the descriptor sums
        const int f = warp;
        if (f < ng) {
          const float* p = s_pow + f * f_bins;
          const float* m = s_mag + f * f_bins;
          float psum = 0.f, msum = 0.f, fmsum = 0.f, mmax = 0.f, cnt = 0.f, lsum = 0.f;
          float ns = 0.f, sx = 0.f, sxx = 0.f, sy = 0.f, sxy = 0.f;
          for (int k = lane; k < f_bins; k += 32) {
            const float mk = m[k];
            const float2 fl = fa.freq_logf[k];
            psum += p[k];
            msum += mk;
            fmsum += mk * fl.x;
            mmax = fmaxf(mmax, mk);
            if (mk > kEps) {  // flatness: ln m over bins above the threshold
              const float lm = logf(mk);
              cnt += 1.f;
              lsum += lm;
              if (fl.x > 0.f) {  // slope: log10 m on log10 f, f > 0 too
                const float y = lm * kInvLn10;
                ns += 1.f;
                sx += fl.y;
                sxx += fl.y * fl.y;
                sy += y;
                sxy += y * fl.y;
              }
            }
          }
          psum = warp_sum(psum);
          msum = warp_sum(msum);
          fmsum = warp_sum(fmsum);
          cnt = warp_sum(cnt);
          lsum = warp_sum(lsum);
          ns = warp_sum(ns);
          sx = warp_sum(sx);
          sxx = warp_sum(sxx);
          sy = warp_sum(sy);
          sxy = warp_sum(sxy);
          for (int o = 16; o > 0; o >>= 1) mmax = fmaxf(mmax, __shfl_xor_sync(kFull, mmax, o));
          const float centroid = msum > 0.f ? fmsum / fmaxf(msum, kEps) : 0.f;
          float bw = 0.f;  // second pass: sum (f - centroid)^2 m
          for (int k = lane; k < f_bins; k += 32) {
            const float d = fa.freq_logf[k].x - centroid;
            bw += d * d * m[k];
          }
          bw = warp_sum(bw);
          if (lane == 0) {
            float* out = fa.feat + (frame0 + f) * kFeatLanes + kSums;
            const float nb = (float)f_bins;
            const float arith = msum / nb;
            const float geo = expf(lsum / fmaxf(cnt, 1.f));
            const float rms = sqrtf(psum / nb);
            const float den = ns * sxx - sx * sx;
            out[0] = centroid;
            out[1] = msum > 0.f ? sqrtf(bw / fmaxf(msum, kEps)) : 0.f;
            out[2] = (cnt > 0.f && arith > kEps) ? geo / fmaxf(arith, kEps) : 0.f;
            out[3] = rms > 0.f ? mmax / fmaxf(rms, kEps) : 0.f;
            out[4] = (ns >= 2.f && fabsf(den) > kEps) ? (ns * sxy - sx * sy) / den : 0.f;
          }
        }
      } else {
        // 5a. warps 4..7: the 38 weighted sums of each frame's power
        constexpr int kSumThreads = kThreads - kGroup * 32;
        for (int i = threadIdx.x - kGroup * 32; i < ng * kSums; i += kSumThreads) {
          const int f = i / kSums, o = i - f * kSums;
          const float* p = s_pow + f * f_bins;
          float acc = 0.f;
          for (int j = fa.row_ptr[o]; j < fa.row_ptr[o + 1]; ++j) acc += fa.weight[j] * p[fa.bin[j]];
          if (o < kMel) {
            fa.feat[(frame0 + f) * kFeatLanes + o] = acc;
          } else {
            s_chroma[f * kChroma + o - kMel] = acc;
          }
        }
      }
      __syncthreads();
      // 5b. unit-sum chroma (pallas_stft.py:405-409)
      for (int i = threadIdx.x; i < ng * kChroma; i += kThreads) {
        const int f = i / kChroma, c = i - f * kChroma;
        const float* e = s_chroma + f * kChroma;
        float total = 0.f;
        for (int j = 0; j < kChroma; ++j) total += e[j];
        fa.feat[(frame0 + f) * kFeatLanes + kMel + c] =
            total > kEps ? e[c] / fmaxf(total, kEps) : e[c];
      }
    }
    __syncthreads();  // s_buf, s_pow, s_mag and s_chroma are reused by the next group
  }
}

template <bool kFeatures>
int launch_stft(const float* sig, const float* window, const float* twiddle, float* mag,
                float* aux, FeatArgs fa, int batch, int n, int t_frames, int w, int hop,
                float pre_emph, void* stream) {
  if (w < 64 || w > 2048 || (w & (w - 1)) != 0 || hop < 1 || t_frames < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2_half = 0;
  while ((1 << log2_half) < w / 2) ++log2_half;
  const size_t smem = sizeof(float) * Layout(w, hop, kFeatures).total;
  cudaError_t err = cudaFuncSetAttribute(stft_aux_kernel<kFeatures>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_frames + kTile - 1) / kTile, batch);
  stft_aux_kernel<kFeatures><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sig, window, reinterpret_cast<const float2*>(twiddle), mag, aux, fa, batch, n, t_frames,
      w, log2_half, hop, pre_emph);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sonido_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K1 on `stream`. Window must be a power of two in [64, 2048];
// returns the CUDA error code (0 on success).
extern "C" int sonido_stft_aux(const float* sig, const float* window, const float* twiddle,
                               float* mag, float* aux, int batch, int n, int t_frames,
                               int w, int hop, float pre_emph, void* stream) {
  return launch_stft<false>(sig, window, twiddle, mag, aux, FeatArgs{}, batch, n, t_frames,
                            w, hop, pre_emph, stream);
}

// Launch K1 with the K10 feature epilogue: feat [B, T, 43] besides the
// same magnitudes and aux planes; row_ptr [39], bin and weight [nnz] and
// freq_logf [F, 2] as ops/hopper_stft.feature_tables builds them.
extern "C" int sonido_stft_features(const float* sig, const float* window, const float* twiddle,
                                    float* mag, float* aux, float* feat, const int* row_ptr,
                                    const int* bin, const float* weight, const float* freq_logf,
                                    int batch, int n, int t_frames, int w, int hop,
                                    float pre_emph, void* stream) {
  const FeatArgs fa{feat, row_ptr, bin, weight, reinterpret_cast<const float2*>(freq_logf)};
  return launch_stft<true>(sig, window, twiddle, mag, aux, fa, batch, n, t_frames, w, hop,
                           pre_emph, stream);
}
