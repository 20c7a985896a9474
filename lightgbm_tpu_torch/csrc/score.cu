// Boosting score update for Hopper (sm_90a): out = score + table[leaf_id].
//
// K4, replaces the TPU kernel lightgbm_tpu/ops/pallas_score.py:
// score_gather_add (_kernel), which turned the gather into a one-hot
// matrix product because the TPU's gather was slow.  On the card a gather
// from a table of at most a few hundred floats is served from L1, so the
// kernel is the plain elementwise pass.
//
// What bounds it: bytes — 12 B a row (score and leaf id in, score out)
// against one add.  Each thread handles rows of a grid-stride loop with
// coalesced 4-byte accesses.
//
// Exactness: one IEEE round-to-nearest float add per row, no fused
// multiply, so the result is bit-identical to score + table[leaf_id] in
// float32.  Leaf ids outside [0, L) add 0, as the TPU kernel's all-zero
// one-hot column did.
//
// In place: out may be score (the boosting loop updates a row of its
// [C, N] score this way), so those two pointers carry no __restrict__;
// each row is read and then written by the same thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void score_gather_add_kernel(const float* score,
                                        const int* __restrict__ leaf_id,
                                        const float* __restrict__ table,
                                        float* out, long long n,
                                        int num_leaves) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int l = leaf_id[i];
    const float v = (l >= 0 && l < num_leaves) ? table[l] : 0.0f;
    out[i] = score[i] + v;
  }
}

}  // namespace

extern "C" int lgbt_score_gather_add(const float* score, const int* leaf_id,
                                     const float* table, float* out,
                                     long long n, int num_leaves,
                                     void* stream) {
  if (n > 0) {
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 32ll * (sms > 0 ? sms : 1);
    if (blocks > cap) blocks = cap;
    score_gather_add_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        score, leaf_id, table, out, n, num_leaves);
  }
  return (int)cudaGetLastError();
}
