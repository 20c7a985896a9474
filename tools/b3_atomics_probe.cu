// How fast one SM adds into a histogram in shared memory, by the way a
// (row, column) pair is added: the probe behind B3's design
// (lightgbm_tpu_torch/csrc/wide_hist.cu).  Built and run by
// `python3 tools/p1_time.py b3_probe`, which also reads the SASS atomic
// opcodes of each variant (a 64-bit or f32 shared add compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN).
//
// Each of 132 blocks of 1024 threads walks `iters` x 8 pairs: a column c
// of 8, a cell of its bins drawn from a per-thread xorshift (uniform, or
// skewed: x & x >> 7 & x >> 13, most lanes on a few bins), and the
// variant's adds into 7 planes of `CELLS` words.  Prints one JSON line a
// variant and shape: the time, pairs and 32-bit atomic lanes a clock an
// SM at the card's maximum SM clock.

#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 7;
constexpr int kCols = 8;

__device__ __forceinline__ unsigned carry_of(unsigned o, unsigned a) {
  return o + a < o ? 1u : 0u;
}

// V: 0 one u32 add; 1 five u32 adds (B3's pair); 2 five with the two low
// adds returning the old word for the high adds' carry (the previous
// pair); 3 seven u32 adds; 4 two u64 adds and a u32 count; 5 one f32 add
template <int V, int CELLS>
__global__ void __launch_bounds__(1024, 1)
probe_kernel(int iters, int skew, unsigned long long* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* p = reinterpret_cast<unsigned*>(smem);
  auto* q = reinterpret_cast<unsigned long long*>(smem);
  for (int i = threadIdx.x; i < kPlanes * CELLS; i += blockDim.x) p[i] = 0;
  __syncthreads();
  constexpr int bins = CELLS / kCols;
  unsigned x = (blockIdx.x * 1024u + threadIdx.x) * 2654435761u + 12345u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      x ^= x << 13;
      x ^= x >> 17;
      x ^= x << 5;
      const unsigned r = skew ? (x & (x >> 7) & (x >> 13)) : x;
      const int k = c * bins + (int)(r % (unsigned)bins);
      const unsigned a = x | 1u;
      if (V == 0) {
        atomicAdd(p + k, a);
      } else if (V == 1) {
        atomicAdd(p + k, a & 0x7FFFFu);
        atomicAdd(p + CELLS + k, a >> 19);
        atomicAdd(p + 3 * CELLS + k, a & 0xFFFFu);
        atomicAdd(p + 4 * CELLS + k, a >> 20);
        atomicAdd(p + 6 * CELLS + k, 1u);
      } else if (V == 2) {
        const unsigned og = atomicAdd(p + k, a);
        const unsigned oh = atomicAdd(p + 2 * CELLS + k, a >> 1);
        atomicAdd(p + 4 * CELLS + k, 1u);
        atomicAdd(p + CELLS + k, 3u + carry_of(og, a));
        atomicAdd(p + 3 * CELLS + k, 1u + carry_of(oh, a >> 1));
      } else if (V == 3) {
        atomicAdd(p + k, a & 0xFFFFu);
        atomicAdd(p + CELLS + k, a >> 16);
        atomicAdd(p + 2 * CELLS + k, a >> 3);
        atomicAdd(p + 3 * CELLS + k, a & 0xFFFu);
        atomicAdd(p + 4 * CELLS + k, a >> 20);
        atomicAdd(p + 5 * CELLS + k, a >> 5);
        atomicAdd(p + 6 * CELLS + k, 1u);
      } else if (V == 4) {
        atomicAdd(q + k, (unsigned long long)a);
        atomicAdd(q + CELLS + k, (unsigned long long)(a >> 1));
        atomicAdd(p + 4 * CELLS + k, 1u);
      } else {
        atomicAdd(reinterpret_cast<float*>(p) + k, (float)(a & 0xFFFFu));
      }
    }
  }
  __syncthreads();
  unsigned long long s = 0;
  for (int i = threadIdx.x; i < kPlanes * CELLS; i += blockDim.x) s += p[i];
  atomicAdd(sink, s);
}

template <int V, int CELLS>
void run(const char* name, int atomics, int skew,
         unsigned long long* sink) {
  const int smem = kPlanes * CELLS * 4;
  cudaFuncSetAttribute(probe_kernel<V, CELLS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = 132, iters = 256;
  probe_kernel<V, CELLS><<<blocks, 1024, smem>>>(4, skew, sink);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  probe_kernel<V, CELLS><<<blocks, 1024, smem>>>(iters, skew, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  const int err = (int)cudaGetLastError();
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const double pairs = (double)blocks * 1024 * iters * kCols;
  const double per_clk = pairs / (ms * 1e-3) / blocks / (khz * 1e3);
  printf("{\"variant\": \"%s\", \"cells\": %d, \"skewed\": %d, "
         "\"ms\": %.4f, \"pairs_per_clock_sm\": %.3f, "
         "\"atomic_lanes_per_clock_sm\": %.3f, \"max_sm_mhz\": %d, "
         "\"cuda_error\": %d}\n",
         name, CELLS, skew, ms, per_clk, per_clk * atomics, khz / 1000,
         err);
}

}  // namespace

int main() {
  unsigned long long* sink = nullptr;
  cudaMalloc(&sink, sizeof(unsigned long long));
  for (int skew = 0; skew < 2; ++skew) {
    run<0, 8192>("u32 x1", 1, skew, sink);
    run<1, 8192>("u32 x5 (B3)", 5, skew, sink);
    run<2, 8192>("u32 x5, 2 returning (previous B3)", 5, skew, sink);
    run<3, 8192>("u32 x7", 7, skew, sink);
    run<4, 4096>("u64 x2 + u32", 3, skew, sink);
    run<5, 8192>("f32 x1", 1, skew, sink);
    run<1, 512>("u32 x5 (B3), 64 bins", 5, skew, sink);
  }
  cudaFree(sink);
  return 0;
}
