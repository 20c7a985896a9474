// The packed-accumulator quantizer for Hopper (sm_90a), kernel Q1: two
// launches.  Entry point with a plain C interface, loaded through ctypes by
// lightgbm_tpu_torch/ops/kernels.py:
//
//   lgbt_quantize_pack — replaces no Pallas kernel: the JAX package's
//       quantizer, lightgbm_tpu/ops/pallas_histogram.py:
//       quantize_pack_channels (:188-233), is XLA.  It runs once a tree
//       before the histogram kernels' packed-accumulator mode
//       (histogram.cu, kAcc).
//
// What it computes, row i of n (ops/histogram.py quantize_pack_plain, its
// plain version, bit for bit): gm = grad * member and hm = hess * member;
// t = gm / scale_g; q = clip(floor(t) + (u < t - floor(t)), -qmax, qmax)
// with u the row's uniform from the key kg (jax.random.uniform: threefry2x32
// of the counter (0, i), the two words xor-ed, its top 23 bits as a float
// in [1, 2) minus 1), the same for the hessian with kh; then
// w2[0, i] = (qg << 16) | (qh & 0xFFFF), w2[1, i] = member's f32 bits, and
// clips counts the values with |q| >= qmax.  The scales are max(max |gm|,
// 1e-30) / qmax and the same for hm; the keys are the JAX package's: kg, kh
// = split(fold_in(PRNGKey(0x517CC1B7), seed)), seed the sum of the uint32
// bits of gm[:8].  IEEE f32 multiply and division (no fast math), floorf
// and an f32 compare, so the bits are the plain version's.
//
// What bounds it: bytes and integer operations about equally.  The scales
// need a whole pass over the rows before any row can be quantized, and 12
// bytes a row of inputs at 10.5M rows (126 MB) do not stay in the 50 MB
// L2, so the rows are read twice: 12 + 12 + 8 = 32 bytes a row, 0.100 ms
// at 10.5M rows at 3.35 TB/s; the two threefry hashes and the rounding,
// ~162 integer operations a row, take 0.102 ms at the card's INT32 rate
// (132 SMs x 64 a clock x 1.98 GHz).  The first design ran a dozen torch
// operations for the scales and the seed (two 42 MB products, abs, max,
// stack, clamp, a division, the seed's slice and sum) before a kernel of
// one row a thread whose every block re-derived the keys.  This one is two
// kernels and nothing else on the stream:
//
//  (a) quantize_reduce_kernel: reads grad, hess and member once (16-byte
//      loads where the tensors allow), a block's max |gm| and max |hm| as
//      the bits of non-negative floats (a NaN's bits exceed inf's, so a
//      NaN propagates as torch.max propagates it), one atomicMax a block
//      into a persistent scratch; the last block to arrive (a counter)
//      writes the scales, the seed's keys and a zero clip count into the
//      call's parameter block, and zeroes the scratch for the next call.
//      Max is exact in any order: the scales have torch.max's bits.
//  (b) quantize_pack_kernel: reads the parameter block, four consecutive
//      rows a thread (16-byte loads and stores where the tensors allow),
//      the eight threefry chains of the four rows interleaved, rotations
//      as funnel shifts, one atomicAdd a warp for the clips.
//
// Calls on one device share the scratch, so they must follow each other
// on one stream (the port's growers quantize on the current stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kKeySeed = 0x517CC1B7u;   // pallas_histogram.py:217
// the parameter block (8 int32 words): scale_g and scale_h (f32 bits),
// the keys kg1, kg2, kh1, kh2, the clip count; the persistent scratch (4
// u32 words): max |gm| bits, max |hm| bits, the arrival counter
constexpr int kClipsWord = 6;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
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

// |x|'s bits: non-negative floats order as their bits, a NaN above inf.
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// max(m, 1e-30) / qmax as torch.clamp and jnp.maximum take it (a NaN
// stays NaN), in IEEE f32 division as the JAX package divides.
__device__ __forceinline__ float scale_of(uint32_t bits, float qmax) {
  const float m = __uint_as_float(bits);
  return __fdiv_rn(m < 1e-30f ? 1e-30f : m, qmax);
}

template <bool kVec>
__global__ void __launch_bounds__(kQuantThreads)
quantize_reduce_kernel(const float* __restrict__ grad,
                       const float* __restrict__ hess,
                       const float* __restrict__ member, long long n,
                       float qmax, uint32_t* __restrict__ scratch,
                       int* __restrict__ params) {
  __shared__ uint32_t red[2][kQuantThreads / 32];
  __shared__ bool last;
  uint32_t mg = 0, mh = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(grad);
    const float4* h4 = reinterpret_cast<const float4*>(hess);
    const float4* m4 = reinterpret_cast<const float4*>(member);
    for (long long i = t0; i < n4; i += stride) {
      const float4 g = __ldg(g4 + i), h = __ldg(h4 + i), m = __ldg(m4 + i);
      mg = max(max(max(mg, abs_bits(__fmul_rn(g.x, m.x))),
                   abs_bits(__fmul_rn(g.y, m.y))),
               max(abs_bits(__fmul_rn(g.z, m.z)),
                   abs_bits(__fmul_rn(g.w, m.w))));
      mh = max(max(max(mh, abs_bits(__fmul_rn(h.x, m.x))),
                   abs_bits(__fmul_rn(h.y, m.y))),
               max(abs_bits(__fmul_rn(h.z, m.z)),
                   abs_bits(__fmul_rn(h.w, m.w))));
    }
    for (long long i = 4 * n4 + t0; i < n; i += stride) {
      mg = max(mg, abs_bits(__fmul_rn(grad[i], member[i])));
      mh = max(mh, abs_bits(__fmul_rn(hess[i], member[i])));
    }
  } else {
    for (long long i = t0; i < n; i += stride) {
      const float m = member[i];
      mg = max(mg, abs_bits(__fmul_rn(grad[i], m)));
      mh = max(mh, abs_bits(__fmul_rn(hess[i], m)));
    }
  }
  mg = block_max(mg, red[0]);
  mh = block_max(mh, red[1]);
  if (threadIdx.x == 0) {
    atomicMax(scratch, mg);
    atomicMax(scratch + 1, mh);
    __threadfence();
    last = atomicAdd(scratch + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const uint32_t g_bits = atomicAdd(scratch, 0u);
  const uint32_t h_bits = atomicAdd(scratch + 1, 0u);
  // the seed: the uint32 sum of the bits of gm[:8]
  uint32_t seed = 0;
  for (long long i = 0; i < n && i < 8; ++i)
    seed += __float_as_uint(__fmul_rn(grad[i], member[i]));
  // fold_in(PRNGKey(0x517CC1B7), seed), then split into kg and kh
  uint32_t a, b, k[4];
  threefry(0u, kKeySeed, 0u, seed, &a, &b);
  threefry(a, b, 0u, 0u, &k[0], &k[1]);
  threefry(a, b, 0u, 1u, &k[2], &k[3]);
  params[0] = __float_as_int(scale_of(g_bits, qmax));
  params[1] = __float_as_int(scale_of(h_bits, qmax));
  for (int j = 0; j < 4; ++j) params[2 + j] = (int)k[j];
  params[kClipsWord] = 0;
  // the scratch, zero again for the next call
  scratch[0] = 0u;
  scratch[1] = 0u;
  scratch[2] = 0u;
}

template <bool kVec>
__global__ void __launch_bounds__(kQuantThreads)
quantize_pack_kernel(const float* __restrict__ grad,
                     const float* __restrict__ hess,
                     const float* __restrict__ member, long long n,
                     float qmax, int* __restrict__ params,
                     int* __restrict__ w2) {
  const float sg = __int_as_float(__ldg(params)),
              sh = __int_as_float(__ldg(params + 1));
  const uint32_t kg1 = (uint32_t)__ldg(params + 2),
                 kg2 = (uint32_t)__ldg(params + 3),
                 kh1 = (uint32_t)__ldg(params + 4),
                 kh2 = (uint32_t)__ldg(params + 5);
  int clipped = 0;
  const long long groups = (n + kRowsPerThread - 1) / kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < groups; q += stride) {
    const long long i0 = q * kRowsPerThread;
    float g[kRowsPerThread], h[kRowsPerThread], m[kRowsPerThread];
    if (kVec) {
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad) + q);
      const float4 h4 = __ldg(reinterpret_cast<const float4*>(hess) + q);
      const float4 m4 = __ldg(reinterpret_cast<const float4*>(member) + q);
      g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
      h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
      m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const bool in = i0 + j < n;
        g[j] = in ? grad[i0 + j] : 0.0f;
        h[j] = in ? hess[i0 + j] : 0.0f;
        m[j] = in ? member[i0 + j] : 0.0f;
      }
    }
    int word[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const uint32_t i = (uint32_t)(i0 + j);
      const float ug = uniform01(kg1, kg2, i);
      const float uh = uniform01(kh1, kh2, i);
      const int qg = quantize(__fmul_rn(g[j], m[j]), sg, ug, qmax);
      const int qh = quantize(__fmul_rn(h[j], m[j]), sh, uh, qmax);
      if (i0 + j < n)
        clipped += int(fabsf((float)qg) >= qmax) +
                   int(fabsf((float)qh) >= qmax);
      word[j] = (int)(((unsigned)qg << 16) | ((unsigned)qh & 0xFFFFu));
    }
    if (kVec) {
      reinterpret_cast<int4*>(w2)[q] =
          make_int4(word[0], word[1], word[2], word[3]);
      reinterpret_cast<int4*>(w2 + n)[q] =
          make_int4(__float_as_int(m[0]), __float_as_int(m[1]),
                    __float_as_int(m[2]), __float_as_int(m[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (i0 + j < n) {
          w2[i0 + j] = word[j];
          w2[n + i0 + j] = __float_as_int(m[j]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    clipped += __shfl_down_sync(0xffffffffu, clipped, off);
  if ((threadIdx.x & 31u) == 0 && clipped != 0)
    atomicAdd(params + kClipsWord, clipped);
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

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// Q1, two kernel launches and no other operation on the stream.  grad,
// hess, member [n] f32 on the device, n in [1, 2^32); bits in [2, 15]
// (qmax = 2^(bits - 1) - 1); scratch [4] u32, this device's persistent
// zeroed scratch (left zero); params [8] i32 out (the scales' f32 bits,
// the keys, the clip count at word 6); w2 [2, n] i32 out.  Returns a CUDA
// error code (0 on success).
int lgbt_quantize_pack(const float* grad, const float* hess,
                       const float* member, long long n, int bits,
                       unsigned* scratch, int* params, int* w2,
                       void* stream) {
  if (n < 1 || n > 0xffffffffll || bits < 2 || bits > 15)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  const bool in_vec = aligned16(grad) && aligned16(hess) && aligned16(member);
  long long blocks = (n + 4ll * kQuantThreads - 1) / (4ll * kQuantThreads);
  const long long reduce_cap = 4ll * sm_count();
  const long long rb = blocks < reduce_cap ? blocks : reduce_cap;
  if (in_vec) {
    quantize_reduce_kernel<true><<<(unsigned)rb, kQuantThreads, 0, st>>>(
        grad, hess, member, n, qmax, scratch, params);
  } else {
    quantize_reduce_kernel<false><<<(unsigned)rb, kQuantThreads, 0, st>>>(
        grad, hess, member, n, qmax, scratch, params);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long pack_cap = 8ll * sm_count();
  const long long pb = blocks < pack_cap ? blocks : pack_cap;
  if (in_vec && n % 4 == 0 && aligned16(w2)) {
    quantize_pack_kernel<true><<<(unsigned)pb, kQuantThreads, 0, st>>>(
        grad, hess, member, n, qmax, params, w2);
  } else {
    quantize_pack_kernel<false><<<(unsigned)pb, kQuantThreads, 0, st>>>(
        grad, hess, member, n, qmax, params, w2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
