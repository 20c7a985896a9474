// The packed-accumulator quantizer for Hopper (sm_90a), kernel Q1.  Entry
// point with a plain C interface, loaded through ctypes by
// lightgbm_tpu_torch/ops/kernels.py:
//
//   lgbt_quantize_pack — replaces no Pallas kernel: the JAX package's
//       quantizer, lightgbm_tpu/ops/pallas_histogram.py:
//       quantize_pack_channels (:188-233), is XLA.  It runs once a tree
//       before the histogram kernels' packed-accumulator mode
//       (histogram.cu, kAcc), and in torch it would be two threefry
//       streams of 20 rounds as chains of int64 elementwise operations
//       over every row.
//
// What it computes, row i of n (ops/histogram.py quantize_pack_plain, its
// plain version, bit for bit): gm = grad * member and hm = hess * member;
// t = gm / scale_g; q = clip(floor(t) + (u < t - floor(t)), -qmax, qmax)
// with u the row's uniform from the key kg (jax.random.uniform: threefry2x32
// of the counter (0, i), the two words xor-ed, its top 23 bits as a float
// in [1, 2) minus 1), the same for the hessian with kh; then
// w2[0, i] = (qg << 16) | (qh & 0xFFFF), w2[1, i] = member's f32 bits, and
// clips counts the values with |q| >= qmax.  The keys are the JAX
// package's: kg, kh = split(fold_in(PRNGKey(0x517CC1B7), seed)), seed the
// sum of the uint32 bits of gm[:8]; the wrapper computes the seed and the
// scales (max |gm| / qmax, max |hm| / qmax) with torch reductions on the
// card, and each block derives the two keys from the seed in shared
// memory, so no value goes to the host.  IEEE f32 division (no fast math),
// floorf and an f32 compare, so the bits are the plain version's.
//
// What bounds it: bytes.  A row reads 12 B (grad, hess, member) and writes
// 8 B: 0.06 ms at 10.5M rows at 3.35 TB/s.  Two threefry hashes a row are
// ~300 integer operations, below the card's ratio of operations to bytes.
// One thread a row, both hashes in registers, one pass, and one integer
// atomic a warp for the clip count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kKeySeed = 0x517CC1B7u;   // pallas_histogram.py:217

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter (x1, x2) under the key (k1, k2): 20 rounds,
// the key injected every four (utils/random.py threefry2x32).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t x1, uint32_t x2,
                                         uint32_t* y1, uint32_t* y2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y1 = x1;
  *y2 = x2;
}

// jax.random.uniform's value for counter i under key (k1, k2).
__device__ __forceinline__ float uniform01(uint32_t k1, uint32_t k2,
                                           uint32_t i) {
  uint32_t y1, y2;
  threefry(k1, k2, 0u, i, &y1, &y2);
  return __uint_as_float(((y1 ^ y2) >> 9) | 0x3F800000u) - 1.0f;
}

// One value's stochastic rounding (_q, pallas_histogram.py:220-224).
__device__ __forceinline__ int quantize(float x, float scale, float u,
                                        float qmax) {
  const float t = __fdiv_rn(x, scale);
  const float fl = floorf(t);
  const float up = u < __fsub_rn(t, fl) ? 1.0f : 0.0f;
  const float q = fminf(fmaxf(__fadd_rn(fl, up), -qmax), qmax);
  return __float2int_rz(q);
}

__global__ void __launch_bounds__(kQuantThreads)
quantize_pack_kernel(const float* __restrict__ grad,
                     const float* __restrict__ hess,
                     const float* __restrict__ member, long long n,
                     const float* __restrict__ scales,
                     const long long* __restrict__ seed, float qmax,
                     int* __restrict__ w2, int* __restrict__ clips) {
  __shared__ uint32_t s_keys[4];
  if (threadIdx.x == 0) {
    // fold_in(PRNGKey(0x517CC1B7), seed), then split into kg and kh
    uint32_t a, b;
    threefry(0u, kKeySeed, 0u, (uint32_t)__ldg(seed), &a, &b);
    threefry(a, b, 0u, 0u, &s_keys[0], &s_keys[1]);
    threefry(a, b, 0u, 1u, &s_keys[2], &s_keys[3]);
  }
  __syncthreads();
  const uint32_t kg1 = s_keys[0], kg2 = s_keys[1];
  const uint32_t kh1 = s_keys[2], kh2 = s_keys[3];
  const float sg = __ldg(scales), sh = __ldg(scales + 1);
  int clipped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float m = member[i];
    const float gm = __fmul_rn(grad[i], m);
    const float hm = __fmul_rn(hess[i], m);
    const int qg = quantize(gm, sg, uniform01(kg1, kg2, (uint32_t)i), qmax);
    const int qh = quantize(hm, sh, uniform01(kh1, kh2, (uint32_t)i), qmax);
    clipped += int(fabsf((float)qg) >= qmax) + int(fabsf((float)qh) >= qmax);
    w2[i] = (int)(((unsigned)qg << 16) | ((unsigned)qh & 0xFFFFu));
    w2[n + i] = __float_as_int(m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    clipped += __shfl_down_sync(0xffffffffu, clipped, off);
  if ((threadIdx.x & 31u) == 0 && clipped != 0) atomicAdd(clips, clipped);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

}  // namespace

extern "C" {

// Q1, one kernel launch and no other operation on the stream.  grad, hess,
// member [n] f32, scales [2] f32 (max |grad * member| / qmax, the same for
// the hessian, floored at 1e-30 / qmax), seed [1] i64 (the uint32 sum of
// the bits of (grad * member)[:8]) on the device; qmax = 2^(bits - 1) - 1
// for bits in [2, 15]; w2 [2, n] i32 out; clips [1] i32, zero on entry,
// gains the count of clipped values.  Returns a CUDA error code (0 on
// success).
int lgbt_quantize_pack(const float* grad, const float* hess,
                       const float* member, long long n, const float* scales,
                       const long long* seed, int bits, int* w2, int* clips,
                       void* stream) {
  if (n < 0 || n > 0xffffffffll || bits < 2 || bits > 15)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  long long blocks = (n + kQuantThreads - 1) / kQuantThreads;
  const long long wave = 16ll * sm_count();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  quantize_pack_kernel<<<(unsigned)blocks, kQuantThreads, 0,
                         (cudaStream_t)stream>>>(grad, hess, member, n,
                                                 scales, seed, qmax, w2,
                                                 clips);
  return (int)cudaGetLastError();
}

}  // extern "C"
