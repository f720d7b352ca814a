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
// frame, 1 otherwise; amp = sqrt(sum_{j<plen} x[j]^2 / plen). The frame
// already sits in shared memory, so this is one block reduction more.
//
// What bounds it on an H100: the difference function. The TPU kernel
// computed d(tau) = E1 + S(tau) - 2 r(tau) through three bf16x3 DFT
// matmuls on its MXU. Here d(tau) = sum_{j<H} (x[j] - x[j+tau])^2 is
// taken directly in fp32 (W*W/4 = 262k FMA per frame at W = 1024): exact
// up to summation order, with no E1 + S - 2r cancellation, and bound by
// shared-memory reads in the inner loop. Each thread owns R lags
// (tau = tid + 128 r), so one broadcast read of x[j] serves R FMAs. One
// block handles one frame; the frame (W floats) and its H difference
// values live in shared memory, so the [B, T, W] frames tensor and the
// [B, T, H] difference rows never exist in device memory.
//
// K3, the difference rows alone (sonido_yin_difference): replaces the TPU
// kernel yin_difference_pallas (pallas_yin.py:162, pallas_call :206),
// [B, N] -> d [B, T, H], no pre-emphasis. The same staging and the same
// difference function (the device functions below) as K2, with d written
// to device memory in place of the CMNDF and the pick. Bound the same way
// as K2's first half; the H floats a frame writes are coalesced (lag tau
// = tid + 128 r).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

// Stage frame t (samples [t*hop, t*hop + W) of row x) in s_x,
// pre-emphasized when pre_emph != 0 (x[-1] = 0 only at the row start).
template <int W>
__device__ __forceinline__ void stage_frame(const float* __restrict__ x, int t, int hop,
                                            float pre_emph, float* s_x) {
  const int s0 = t * hop;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int p = s0 + i;
    float v = x[p];
    if (pre_emph != 0.f) {
      const float prev = p > 0 ? x[p - 1] : 0.f;
      v = __fsub_rn(v, __fmul_rn(pre_emph, prev));
    }
    s_x[i] = v;
  }
}

// The difference function d(tau) = sum_{j<H} (x[j] - x[j+tau])^2 of the
// staged frame for this thread's lags tau = tid + kThreads * r.
template <int R>
__device__ __forceinline__ void difference(const float* s_x, float (&acc)[R]) {
  constexpr int H = R * kThreads;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float a = s_x[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dl = a - s_x[j + tid + r * kThreads];
      acc[r] = fmaf(dl, dl, acc[r]);
    }
  }
}

template <int R>  // lags per thread: H = R * kThreads
__global__ void __launch_bounds__(kThreads) yin_kernel(
    const float* __restrict__ sig, float* __restrict__ pitch, float* __restrict__ conf,
    float* __restrict__ amp, int n, int t_frames, int hop, float pre_emph,
    float sample_rate, float min_freq, float max_freq, float threshold) {
  constexpr int H = R * kThreads;
  constexpr int W = 2 * H;
  __shared__ float s_x[W];
  __shared__ float s_cm[H];  // d, then the CMNDF
  __shared__ float s_warp[kWarps];
  __shared__ int s_first[kWarps];
  __shared__ int s_plen;

  const int t = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  stage_frame<W>(sig + (size_t)row * n, t, hop, pre_emph, s_x);
  __syncthreads();

  float acc[R];
  difference<R>(s_x, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) s_cm[tid + r * kThreads] = acc[r];
  __syncthreads();

  // CMNDF: running[tau] = sum_{u=1..tau} d[u] (d[0] excluded), as a block
  // scan over contiguous chunks u = tid*R + r
  float d[R], loc[R];
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u = tid * R + r;
    d[r] = s_cm[u];
    sum += u == 0 ? 0.f : d[r];
    loc[r] = sum;
  }
  float incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  float base = __shfl_up_sync(kFull, incl, 1);  // exclusive within the warp
  if (lane == 0) base = 0.f;
  for (int wi = 0; wi < warp; ++wi) base += s_warp[wi];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u = tid * R + r;
    const float running = base + loc[r];
    s_cm[u] = u == 0 ? 1.f : d[r] * (float)u / fmaxf(running, kEps);
  }
  __syncthreads();

  // first tau >= 1 with cm[tau] < threshold and cm[tau] < cm[tau+1] (cm[H] = inf)
  int first = H;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u = tid * R + r;
    const float c = s_cm[u];
    const float nxt = u + 1 < H ? s_cm[u + 1] : INFINITY;
    if (u >= 1 && c < threshold && c < nxt) first = min(first, u);
  }
  for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kFull, first, o));
  if (lane == 0) s_first[warp] = first;
  __syncthreads();

  if (tid == 0) {
    int tau = H;
    for (int wi = 0; wi < kWarps; ++wi) tau = min(tau, s_first[wi]);
    const bool has = tau < H;
    if (!has) tau = 0;
    const float y0 = s_cm[max(tau - 1, 0)];
    const float y1 = s_cm[tau];
    const float y2 = s_cm[min(tau + 1, H - 1)];
    const float denom = y0 - 2.f * y1 + y2;
    const float shift = fabsf(denom) > kEps ? 0.5f * (y0 - y2) / denom : 0.f;
    const bool interior = tau > 0 && tau < H - 1;
    const float period = (float)tau + (interior ? shift : 0.f);
    const float freq = sample_rate / fmaxf(period, kEps);
    const bool ok = has && freq >= min_freq && freq <= max_freq;
    const size_t o = (size_t)row * t_frames + t;
    const float p = ok ? freq : 0.f;
    pitch[o] = p;
    conf[o] = ok ? 1.f - y1 : 0.f;
    // IEEE division and a truncating cast, as the plain version does them
    const int plen = p > 0.f ? (int)__fdiv_rn(sample_rate, fmaxf(p, kEps)) : 0;
    s_plen = min(max(plen, 1), W - 1);
  }
  if (amp == nullptr) return;  // uniform across the block
  __syncthreads();

  // period amplitude: block sum of s_x[j]^2 over j < plen
  const int plen = s_plen;
  float sq = 0.f;
  for (int j = tid; j < plen; j += kThreads) sq = fmaf(s_x[j], s_x[j], sq);
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
  if (lane == 0) s_warp[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) total += s_warp[wi];
    amp[(size_t)row * t_frames + t] = sqrtf(__fdiv_rn(total, (float)plen));
  }
}

// K3: the difference rows of each frame, d [B, T, H], to device memory.
template <int R>
__global__ void __launch_bounds__(kThreads) yin_difference_kernel(
    const float* __restrict__ sig, float* __restrict__ d, int n, int t_frames, int hop) {
  constexpr int H = R * kThreads;
  __shared__ float s_x[2 * H];
  const int t = blockIdx.x, row = blockIdx.y;
  stage_frame<2 * H>(sig + (size_t)row * n, t, hop, 0.f, s_x);
  __syncthreads();
  float acc[R];
  difference<R>(s_x, acc);
  float* out = d + ((size_t)row * t_frames + t) * H;
#pragma unroll
  for (int r = 0; r < R; ++r) out[threadIdx.x + r * kThreads] = acc[r];
}

template <int R>
cudaError_t launch_difference(const float* sig, float* d, int batch, int n, int t_frames, int hop,
                              cudaStream_t stream) {
  yin_difference_kernel<R><<<dim3(t_frames, batch), kThreads, 0, stream>>>(sig, d, n, t_frames,
                                                                           hop);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch(const float* sig, float* pitch, float* conf, float* amp, int batch, int n,
                   int t_frames, int hop, float pre_emph, float sample_rate, float min_freq,
                   float max_freq, float threshold, cudaStream_t stream) {
  const dim3 grid(t_frames, batch);
  yin_kernel<R><<<grid, kThreads, 0, stream>>>(sig, pitch, conf, amp, n, t_frames, hop,
                                               pre_emph, sample_rate, min_freq, max_freq,
                                               threshold);
  return cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`. Window must be 256, 512, 1024 or 2048; `amp`
// may be null (no period amplitude). Returns the CUDA error code (0 on
// success).
extern "C" int sonido_yin_pitch(const float* sig, float* pitch, float* conf, float* amp,
                                int batch, int n,
                                int t_frames, int w, int hop, float pre_emph,
                                float sample_rate, float min_freq, float max_freq,
                                float threshold, void* stream) {
  if (hop < 1 || t_frames < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 256: err = launch<1>(sig, pitch, conf, amp, batch, n, t_frames, hop, pre_emph, sample_rate, min_freq, max_freq, threshold, s); break;
    case 512: err = launch<2>(sig, pitch, conf, amp, batch, n, t_frames, hop, pre_emph, sample_rate, min_freq, max_freq, threshold, s); break;
    case 1024: err = launch<4>(sig, pitch, conf, amp, batch, n, t_frames, hop, pre_emph, sample_rate, min_freq, max_freq, threshold, s); break;
    case 2048: err = launch<8>(sig, pitch, conf, amp, batch, n, t_frames, hop, pre_emph, sample_rate, min_freq, max_freq, threshold, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Launch K3 on `stream`: d [B, T, W/2] of the raw (not pre-emphasized)
// signal. Window must be 256, 512, 1024 or 2048. Returns the CUDA error
// code (0 on success).
extern "C" int sonido_yin_difference(const float* sig, float* d, int batch, int n, int t_frames,
                                     int w, int hop, void* stream) {
  if (hop < 1 || t_frames < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 256: err = launch_difference<1>(sig, d, batch, n, t_frames, hop, s); break;
    case 512: err = launch_difference<2>(sig, d, batch, n, t_frames, hop, s); break;
    case 1024: err = launch_difference<4>(sig, d, batch, n, t_frames, hop, s); break;
    case 2048: err = launch_difference<8>(sig, d, batch, n, t_frames, hop, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
