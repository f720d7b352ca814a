// Microbenchmarks behind the DTW backtrack's design (csrc/dtw.cu), one
// block on one SM, SM cycles from clock64():
//   1. a walker-like dependent chain (three shared loads, compares, a
//      selected move) alone, with a rarely taken global read in its loop,
//      with a never-entered nested spin loop in it, and with both;
//   2. bulk copies (cp.async.bulk, each completing its own mbarrier) of
//      1 KB and 2 KB band-like rows (41 KB apart), 1, 4, 16 or 64 in
//      flight: cycles per copy.
// Build and run on the card (not part of the package):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o micro_walk tools/micro_walk.cu
//   ./micro_walk
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned sa(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n" : "=r"(v) : "r"(sa(p)) : "memory");
  return v;
}

// kMode bit 0: a nested spin loop (never entered) in the step's loop;
// bit 1: a global read (never taken) in it.
template <int kMode>
__global__ void chain(int iters, const float* g, long long* out, int* sink) {
  __shared__ float s[4096];
  __shared__ int front;
  for (int t = threadIdx.x; t < 4096; t += blockDim.x) s[t] = static_cast<float>((t * 7919) % 1000);
  if (threadIdx.x == 0) front = -1000000000;
  __syncthreads();
  if (threadIdx.x == 0) {
    int i = 0, k = 2048, seen = -1000000000, misses = 0;
    float c = 0.0f;
    const long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
      float u = s[(k + 1) & 4095], d = s[k & 4095];
      const float l = s[(k - 1 + 64) & 4095];
      if ((kMode & 2) && k == -5) {
        u = g[k + 7];
        d = g[k + 6];
        ++misses;
      }
      const bool pd = d < u && d < l, pl = !pd && l < u;
      c += pd ? d : (pl ? l : u);
      k += pd ? 64 : (pl ? -1 : 65);
      i += pl ? 0 : 1;
      if ((kMode & 1) && !pl && -i < seen) {
        for (long long spin = 0; (seen = load_acquire(&front)) > -i; ++spin) {
          if (spin > (1LL << 26)) __trap();
        }
      }
    }
    out[0] = clock64() - t0;
    sink[0] = i + static_cast<int>(c) + misses;
  }
  __syncthreads();
}

__device__ __forceinline__ void wait_parity(unsigned long long* bar, int parity) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(ok)
        : "r"(sa(bar)), "r"(parity)
        : "memory");
  }
}

__global__ void bulk_copies(const float* g, int batch, int bytes, int rounds, long long* out) {
  __shared__ __align__(128) float ring[16 * 512];
  __shared__ unsigned long long bars[64];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < 64; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(bars + s)) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long t0 = clock64();
  int row = 0;
  for (int r = 0; r < rounds; ++r) {
    for (int b = 0; b < batch; ++b, ++row) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sa(bars + b)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(sa(ring + (b & 15) * 512)),
          "l"(g + static_cast<size_t>(row) * 10336), "r"(bytes), "r"(sa(bars + b))
          : "memory");
    }
    for (int b = 0; b < batch; ++b) wait_parity(bars + b, r & 1);
  }
  out[0] = clock64() - t0;
}

template <int kMode>
void run_chain(const float* g, long long* out, int* sink) {
  const int iters = 100000;
  long long h = 0;
  chain<kMode><<<1, 256>>>(iters, g, out, sink);
  chain<kMode><<<1, 256>>>(iters, g, out, sink);
  cudaMemcpy(&h, out, sizeof(h), cudaMemcpyDeviceToHost);
  printf("chain%s%s: %.1f cycles a step\n", kMode & 1 ? " + nested spin loop" : "",
         kMode & 2 ? " + global read" : "", static_cast<double>(h) / iters);
}

int main() {
  long long* out;
  int* sink;
  float* g;
  const size_t rows = 20000;
  cudaMalloc(&out, sizeof(long long));
  cudaMalloc(&sink, sizeof(int));
  cudaMalloc(&g, sizeof(float) * 10336 * rows);
  cudaMemset(g, 0, sizeof(float) * 10336 * rows);
  run_chain<0>(g, out, sink);
  run_chain<1>(g, out, sink);
  run_chain<2>(g, out, sink);
  run_chain<3>(g, out, sink);
  for (int bytes : {1024, 2048}) {
    for (int batch : {1, 4, 16, 64}) {
      const int rounds = 4096 / batch;
      long long h = 0;
      bulk_copies<<<1, 32>>>(g, batch, bytes, rounds, out);
      bulk_copies<<<1, 32>>>(g, batch, bytes, rounds, out);
      cudaMemcpy(&h, out, sizeof(h), cudaMemcpyDeviceToHost);
      printf("bulk copies of %d B, %d in flight: %.1f cycles a copy\n", bytes, batch,
             static_cast<double>(h) / (rounds * batch));
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
