// The warp FFT core shared by K1/K10 (stft.cu) and K2/K3 (yin.cu): a
// Stockham autosort FFT of N = 2^kLog2N complex points owned by one warp.
// Within a pass every butterfly is in registers; between passes the warp
// exchanges its points through its own shared buffer under __syncwarp()
// only, indexed through an XOR swizzle (swz) that keeps every pass's loads
// and stores free of bank conflicts. Twiddles come from one table in pass
// order (ops/hopper_stft.twiddle_table, whose numpy model
// ops/hopper_stft.fft_passes_model runs the same pass order and index maps).
//
// The definitions sit in an unnamed namespace: each source that includes
// this header gets its own copies, all inlined.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// The warp buffer's swizzle, in float2 units: bits 3-6 of the index flip
// its bits 0-3. A 64-bit access is served per half-warp; with it the
// stride-R stores of pass 0, the 8-runs of pass 1 and the unit-stride
// loads all fall on 16 distinct bank pairs (ops/hopper_stft.swizzle).
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

// In-register forward DFTs, exp(-2 pi i k n / R).
template <int R> __device__ __forceinline__ void dft(float2 (&v)[R]);

template <> __device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]), d13 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[1] = cadd(d02, d13);
  v[2] = csub(s02, s13);
  v[3] = csub(d02, d13);
}

template <> __device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  constexpr float h = 0.70710678118654752f;
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));    // * exp(-i pi/4)
  o[2] = mul_neg_i(o[2]);                                             // * -i
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));   // * exp(-3i pi/4)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// The pass schedule of the N = 2^kLog2N point FFT: radix-8 passes, then one
// of radix 2 or 4; pass p has span Ns = the product of the earlier radices.
// Twiddles: the split's exp(-2 pi i k / W), k in [0, N], at 0; pass p >= 1
// reads exp(-2 pi i q r / (Ns R)) at tw_offset(p) + (r - 1) Ns + q.
template <int kLog2N>
struct FftPlan {
  static constexpr int kN = 1 << kLog2N;
  static constexpr int kPasses = (kLog2N + 2) / 3;
  __host__ __device__ static constexpr int log2_radix(int p) {
    return p < kLog2N / 3 ? 3 : kLog2N % 3;
  }
  __host__ __device__ static constexpr int log2_span(int p) {
    return p == 0 ? 0 : log2_span(p - 1) + log2_radix(p - 1);
  }
  __host__ __device__ static constexpr int tw_offset(int p) {
    return p <= 1 ? kN + 1
                  : tw_offset(p - 1) + ((1 << log2_radix(p - 1)) - 1) * (1 << log2_span(p - 1));
  }
};

// Pass p, in place: every lane loads its butterflies' points, the warp
// syncs, then each stores its results to their Stockham places. Pass 0
// (NS = 1) has no twiddles; K1 runs its own pass 0 from the samples, the
// inverse transform of K2/K3 runs this one on the buffer.
template <int N, int R, int NS>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* __restrict__ tw, int lane) {
  constexpr int kB = N / R;
  constexpr int kSlots = (kB + 31) / 32;
  float2 v[kSlots][R];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (kB >= 32 || j < kB) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[s][r] = buf[swz(j + r * kB)];
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (kB >= 32 || j < kB) {
      const int q = j & (NS - 1);
      if constexpr (NS > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[s][r] = cmul(v[s][r], __ldg(tw + (r - 1) * NS + q));
      }
      dft<R>(v[s]);
      const int dst = (j / NS) * NS * R + q;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[swz(dst + r * NS)] = v[s][r];
    }
  }
}

// Passes P.. of the plan, each followed by __syncwarp().
template <int kLog2N, int P>
__device__ __forceinline__ void fft_passes_from(float2* buf, const float2* __restrict__ tw,
                                                int lane) {
  using Plan = FftPlan<kLog2N>;
  if constexpr (P < Plan::kPasses) {
    fft_pass<Plan::kN, 1 << Plan::log2_radix(P), 1 << Plan::log2_span(P)>(
        buf, tw + Plan::tw_offset(P), lane);
    __syncwarp();
    fft_passes_from<kLog2N, P + 1>(buf, tw, lane);
  }
}

}  // namespace
