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
// the work per frame is a compare, so the bytes (2 RT) are nothing; the
// time is a launch, one trip to memory and the walk's dependent chain.
// The TPU kernel put 128 rows in vector lanes and stepped frames in a
// hardware loop. Here one block owns one row (R blocks, so 128 rows
// reach 128 SMs) and takes it in tiles of kTile frames:
//   1. stage: every thread issues its 16-byte loads of the tile (the
//      aligned middle; the two partial chunks at the row's unaligned
//      ends byte by byte) before it stores any, into shared memory that
//      mirrors the 16-byte alignment of global memory;
//   2. ballots: each warp turns 32 staged bytes into one word of the
//      tile's candidate bitmask;
//   3. walk (warp 0): from p, the first frame the next onset may take,
//      the next kept frame is the first set bit >= p. The walk steps
//      through a 64-frame word on its bitmask in registers, a few
//      dependent integer operations a kept onset: keep the lowest set
//      bit, drop the bits below it shifted up by min_frames. Up to 64
//      frames, the part of the shifted mask that leaves the word masks
//      the next word, whose bits were loaded while this one was walked;
//      an empty word is skipped by a ballot over the next 32 words; p
//      carries across tiles;
//   4. write: each thread expands 16 kept bits into 16 bytes and stores
//      them as one 16-byte store (the partial chunks at the ends byte by
//      byte), aligned in the output's own address space.
// ops/hopper_onsets.thin_onsets_model replays the tiles, the ballots'
// words and the walk in numpy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksPerThread = 4;  // 16-byte loads in flight per thread
// frames per tile: a multiple of 32 whose chunks at any alignment (up to
// 15 bytes before the tile) fit kThreads * kChunksPerThread loads
constexpr int kTile = kThreads * kChunksPerThread * 16 - 32;
constexpr int kTileWords = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

// 16 bits -> 16 bytes of 0/1, bit j in byte j.
__device__ __forceinline__ uint4 expand_bits(unsigned bits) {
  uint4 v;
  v.x = ((bits & 15u) * 0x00204081u) & 0x01010101u;
  v.y = (((bits >> 4) & 15u) * 0x00204081u) & 0x01010101u;
  v.z = (((bits >> 8) & 15u) * 0x00204081u) & 0x01010101u;
  v.w = (((bits >> 12) & 15u) * 0x00204081u) & 0x01010101u;
  return v;
}

// Shared memory by 32-bit shared-window address. The walk holds its
// arrays' addresses in registers: addressing them by name, the compiler
// rebuilds the window's base (a special-register read) inside the loop.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm("mov.b32 %0, %0;" : "+r"(a));  // opaque: computed once, kept in a register
  return a;
}
__device__ __forceinline__ unsigned long long ld_shared64(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared64(unsigned addr, unsigned long long v) {
  asm volatile("st.shared.u64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}

// The candidates at or after frame p in the first 64-frame word at or
// after p's that holds any, as that word's bitmask (w set to it); 0 when
// none is left in the tile. `cand` is the bitmask's shared address. An
// empty word is skipped by a ballot over the next 32 words.
// Warp-uniform: every lane returns the same.
__device__ __forceinline__ unsigned long long seek(unsigned cand, unsigned p, int pairs, int lane,
                                                   int& w) {
  w = (int)(p >> 6);
  if (w >= pairs) return 0ull;
  unsigned long long m = ld_shared64(cand + 8u * (unsigned)w) & (~0ull << (p & 63u));
  while (m == 0ull && ++w < pairs) {
    const unsigned long long x =
        w + lane < pairs ? ld_shared64(cand + 8u * (unsigned)(w + lane)) : 0ull;
    const unsigned nz = __ballot_sync(kFull, x != 0ull);
    if (nz != 0u) {
      w += __ffs(nz) - 1;
      m = __shfl_sync(kFull, x, __ffs(nz) - 1);
    } else {
      w += 31;
    }
  }
  return m;
}

__global__ void __launch_bounds__(kThreads) thin_kernel(
    const unsigned char* __restrict__ cand, unsigned char* __restrict__ kept, int t_frames,
    int min_frames) {
  __shared__ __align__(16) unsigned char s_byte[kTile + 32];
  // the tile's bitmasks, 32-bit words read in pairs as 64-bit words
  __shared__ __align__(8) unsigned s_cand[kTileWords + 1];
  __shared__ __align__(8) unsigned s_kept[kTileWords + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned char* c = cand + (size_t)blockIdx.x * t_frames;
  unsigned char* out = kept + (size_t)blockIdx.x * t_frames;
  // the first frame (of the row) the next kept onset may take; warp 0's
  long long next = 0;

  for (int t0 = 0; t0 < t_frames; t0 += kTile) {
    const int n = min(kTile, t_frames - t0);
    const int pairs = (n + 63) >> 6, words = 2 * pairs;  // the last word may be all padding

    // 1. stage: byte f of the tile goes to s_byte[head + f]
    const unsigned char* src = c + t0;
    const int head = (int)(reinterpret_cast<uintptr_t>(src) & 15u);
    const uint4* src16 = reinterpret_cast<const uint4*>(src - head);
    const int chunks = (head + n + 15) >> 4;
    uint4 v[kChunksPerThread];
#pragma unroll
    for (int j = 0; j < kChunksPerThread; ++j) {
      const int q = tid + j * kThreads, lo = q * 16 - head;
      if (q < chunks && lo >= 0 && lo + 16 <= n) v[j] = __ldg(src16 + q);
    }
#pragma unroll
    for (int j = 0; j < kChunksPerThread; ++j) {
      const int q = tid + j * kThreads, lo = q * 16 - head;
      if (q >= chunks) break;
      if (lo < 0 || lo + 16 > n) {  // a partial chunk at an end of the tile
        unsigned w4[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < 16; ++b) {
          const int f = lo + b;
          if (f >= 0 && f < n) w4[b >> 2] |= (unsigned)src[f] << (8 * (b & 3));
        }
        v[j] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
      reinterpret_cast<uint4*>(s_byte)[q] = v[j];
    }
    __syncthreads();

    // 2. ballots: word w holds frames [32 w, 32 w + 32) of the tile (none
    // past n)
    for (int w = warp; w < words; w += kWarps) {
      const int f = 32 * w + lane;
      const unsigned bits = __ballot_sync(kFull, f < n && s_byte[head + f] != 0);
      if (lane == 0) {
        s_cand[w] = bits;
        s_kept[w] = 0u;
      }
    }
    __syncthreads();

    // 3. walk (warp 0; every lane holds the same state, so every branch
    // is uniform), over 64-frame words. Inside a word a step is register
    // arithmetic on its bit mask m: below = m ^ (m - 1) is the lowest
    // candidate, kept, and the bits under it; ~below << (min_frames - 1)
    // masks the candidates the interval allows. Up to 64 frames, the part
    // of that mask shifted out of the word masks the next word, whose
    // bits were loaded while this one was walked; past 64, the walk seeks
    // from the kept frame.
    if (warp == 0) {
      const unsigned cand = shared_address(s_cand), kept_at = shared_address(s_kept);
      const int sh = min(min_frames, 64) - 1;
      unsigned p = next > t0 ? (unsigned)min(next - t0, (long long)n) : 0u;
      int w, lw = -1;  // the word walked; the word of the last kept bit
      unsigned long long m = seek(cand, p, pairs, lane, w), below = 0ull;
      while (m != 0ull) {
        const unsigned long long ahead =
            w + 1 < pairs ? ld_shared64(cand + 8u * (unsigned)(w + 1)) : 0ull;
        unsigned long long kword = 0ull;
        do {
          below = m ^ (m - 1ull);
          kword |= m & below;
          m &= ~below << sh;
        } while (m != 0ull);
        st_shared64(kept_at + 8u * (unsigned)w, kword);
        lw = w;
        if (min_frames <= 64) {
          m = ahead & (sh == 0 ? ~0ull : (~below >> (64 - sh)) | (~0ull << sh));
          if (m == 0ull) {
            m = seek(cand, 64u * (unsigned)(w + 2), pairs, lane, w);
          } else {
            ++w;
          }
        } else {
          m = seek(cand, 64u * (unsigned)w + (unsigned)(__popcll(below) - 1) + (unsigned)min_frames,
                   pairs, lane, w);
        }
      }
      if (lw >= 0) {  // else next stands: it may lie past this tile
        next = t0 + 64ll * lw + (__popcll(below) - 1) + min_frames;
      }
    }
    __syncthreads();

    // 4. write: out byte f of the tile from kept bit f
    unsigned char* dst = out + t0;
    const int ohead = (int)(reinterpret_cast<uintptr_t>(dst) & 15u);
    uint4* dst16 = reinterpret_cast<uint4*>(dst - ohead);
    const int ochunks = (ohead + n + 15) >> 4;
    for (int q = tid; q < ochunks; q += kThreads) {
      const int lo = q * 16 - ohead;
      if (lo >= 0 && lo + 16 <= n) {
        const int w = lo >> 5, sh = lo & 31;
        unsigned bits = s_kept[w] >> sh;
        if (sh > 16) bits |= s_kept[w + 1] << (32 - sh);
        dst16[q] = expand_bits(bits & 0xffffu);
      } else {
        for (int b = 0; b < 16; ++b) {
          const int f = lo + b;
          if (f >= 0 && f < n) dst[f] = (unsigned char)((s_kept[f >> 5] >> (f & 31)) & 1u);
        }
      }
    }
    // the next tile's stage writes only s_byte, which nothing here reads;
    // its ballots come after the barrier that follows it
  }
}

}  // namespace

// Launch K4 on `stream`; returns the CUDA error code (0 on success).
extern "C" int sonido_thin_onsets(const unsigned char* cand, unsigned char* kept, int rows,
                                  int t_frames, int min_frames, void* stream) {
  if (rows < 1 || t_frames < 1 || min_frames < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // past the row's length the interval keeps only the first candidate
  // either way; the clamp keeps the walk's frame index below 2^32
  if (min_frames > t_frames) min_frames = t_frames;
  thin_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(cand, kept, t_frames,
                                                                       min_frames);
  return static_cast<int>(cudaGetLastError());
}

// K4's resources: registers, local (spill) bytes, static shared memory
// per block and resident blocks per SM. Returns the CUDA error code.
extern "C" int sonido_thin_onsets_occupancy(int* regs, int* local_bytes, int* smem, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, thin_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, thin_kernel, kThreads, 0));
}
