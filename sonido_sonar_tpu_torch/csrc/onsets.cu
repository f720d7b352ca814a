// K4: min-interval onset thinning. Scanning each row left to right,
// candidate i is kept iff cand[i] and i - last >= min_frames, where last
// is the previous KEPT index (initially -min_frames - 1).
//
// Replaces the TPU kernel thin_onsets_pallas in
// sonido_sonar_tpu/ops/pallas_onsets.py (:60, _thin_kernel :33,
// pallas_call :76). Same contract: [R, T] candidates -> [R, T] kept
// mask, both one byte per element (torch.bool); the output is
// bit-identical to the sequential recurrence (integer decisions only).
//
// What bounds it on an H100: the recurrence is sequential along T, and
// the work per frame is a compare. The TPU kernel put 128 rows in vector
// lanes and stepped frames in a hardware loop. Here one warp owns one
// row: each step loads 32 frames (one byte per lane, coalesced), takes a
// __ballot_sync of the candidates, and walks only the set bits in order
// (__ffs), carrying `last` in a register. Every lane walks the same bits,
// so the kept word and `last` need no broadcast, and each lane writes
// its own frame. The cost is T/32 ballots plus one step per candidate;
// rows run in parallel across warps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps = 4 rows per block
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) thin_kernel(
    const unsigned char* __restrict__ cand, unsigned char* __restrict__ kept, int rows,
    int t_frames, int min_frames) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const unsigned char* c = cand + (size_t)row * t_frames;
  unsigned char* out = kept + (size_t)row * t_frames;
  int last = -min_frames - 1;
  for (int i0 = 0; i0 < t_frames; i0 += 32) {
    const int i = i0 + lane;
    const bool is_cand = i < t_frames && c[i] != 0;
    unsigned bits = __ballot_sync(kFull, is_cand);
    unsigned keep = 0u;
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1u;
      if (i0 + b - last >= min_frames) {
        keep |= 1u << b;
        last = i0 + b;
      }
    }
    if (i < t_frames) out[i] = (keep >> lane) & 1u;
  }
}

}  // namespace

// Launch K4 on `stream`; returns the CUDA error code (0 on success).
extern "C" int sonido_thin_onsets(const unsigned char* cand, unsigned char* kept, int rows,
                                  int t_frames, int min_frames, void* stream) {
  if (rows < 1 || t_frames < 1 || min_frames < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  thin_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, kept, rows, t_frames, min_frames);
  return static_cast<int>(cudaGetLastError());
}
