// Histograms and split routing of the segment grower, for Hopper
// (sm_90a).  Entry points with a plain C interface, loaded through ctypes
// by lightgbm_tpu_torch/ops/kernels.py:
//
//   lgbt_histogram_segment  — K1, replaces the TPU kernel
//       lightgbm_tpu/ops/pallas_histogram.py:histogram_segment
//       (_kernel_segment / _accumulate_block);
//   lgbt_histogram_segment  with a route descriptor — K3, replaces
//       pallas_histogram.py:histogram_segment_routed
//       (_kernel_segment_routed);
//   lgbt_route_window       — K2, replaces pallas_histogram.py:route_window
//       (_kernel_route_window / _route_block_ids);
//   lgbt_histogram_all      — K5, replaces pallas_histogram.py:
//       histogram_all (_kernel_all) for C stacked bf16 channel sets: the
//       root histograms of all C class trees of a multiclass iteration.
//
// K1/K3 compute, over the rows [row_lo, row_hi) whose leaf id equals
// `target`, the per-(feature, bin) sums of gradient, hessian and row count.
// K5 computes the same sums over every row, once per channel set: the
// class set is gridDim.z, so each block reads one set's five channels and
// the bin rows of its feature tile.  It is the K1 body without the leaf-id
// test, and sums in the same fixed point at the set's own scale, so class
// c's slice equals K1 on a root of class c at that scale, bit for bit.
// The TPU kernel contracted a one-hot [F*B, chunk] matrix against the
// weight channels on the matrix unit; here a histogram is a scatter into
// shared memory, as in the reference's OpenCL kernels
// (src/treelearner/ocl/histogram{16,64,256}.cl).
//
// What bounds it.  The least time is set by bytes: one pass reads, per row
// of the window, the leaf id (4 B), the five live bf16 weight channels
// (10 B) and one bin byte per feature; at the HIGGS shape (28 features)
// about 42 B a row against a handful of integer operations, far below the
// card's ratio of operations to bytes.  This first version does not reach
// that bound: each (row, feature) pair costs three shared-memory atomics,
// two of them 64-bit, and the lanes of a warp that hit one bin serialise,
// so the atomics set its time (PERF.md has the measurements).  The design
// keeps the data streamed once: each block walks a strided share of the
// window, one row a thread, so a warp reads 32 neighbouring bytes of each
// feature row; it accumulates into its own shared-memory histogram and
// flushes that to device memory once, with atomics.
//
// Determinism: float atomics would make the sums depend on the order in
// which threads arrive.  Gradients and hessians are converted to 64-bit
// fixed point (value * 2^k, k chosen per tree by fixed_point_scales so no
// sum can overflow) and added as integers, so every launch gives the same
// bits whatever the scheduling.  Counts are integers too.
//
// Shared memory: a histogram of ft features x B bins x (8 + 8 + 4) bytes.
// Features are tiled across gridDim.y so a tile fits the 48 KB a block
// gets without opting in (37 features at 64 bins, 9 at 256 bins); each
// tile re-reads the leaf ids and weights, which costs bytes only on
// shapes wider than the HIGGS one.  K5 adds the class sets as gridDim.z,
// so its bin rows are read once per set: (F + 10) bytes a row and set
// against the (F + 10 C) bytes a row of one pass over all sets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRouteWords = 19;   // pallas_histogram.py:_ROUTE_WORDS
constexpr int kMissingZero = 1;   // core/binning.py MISSING_ZERO
constexpr int kMissingNan = 2;    // core/binning.py MISSING_NAN
constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;
constexpr int kBytesPerBin = 8 + 8 + 4;

// pack_route's layout: leaf, new_leaf, row, col, thr, dl, cat, mt, dbin,
// nbf, off, bitset[8]
struct RouteDesc {
  int w[kRouteWords];
};

// One row's leaf id after the split: _route_block_ids
// (pallas_histogram.py:1007-1042) for one row, in the same 0/1 integer
// arithmetic.  `g` is the row's value in the split feature's bin row.
__device__ __forceinline__ int routed_leaf(const RouteDesc& r, int g,
                                           int lid) {
  const int thr = r.w[4], dl = r.w[5], cat = r.w[6], mt = r.w[7];
  const int dbin = r.w[8], nbf = r.w[9], off = r.w[10];
  const int in_range = int(g >= off) * int(g < off + nbf);
  const int fcol = in_range == 1 ? g - off : dbin;
  const int miss_z = int(mt == kMissingZero) * int(fcol == dbin);
  const int miss_n = int(mt == kMissingNan) * int(fcol == nbf - 1);
  const int is_missing = min(miss_z + miss_n, 1);
  const int num_left = is_missing * dl + (1 - is_missing) * int(fcol <= thr);
  const int idx = min(max(fcol, 0), 255);
  int word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) word = (idx / 32 == k) ? r.w[11 + k] : word;
  const int cat_left = (word >> (idx % 32)) & 1;
  const int go_left = cat * cat_left + (1 - cat) * num_left;
  const int take = int(lid == r.w[0]) * (1 - go_left);
  return take == 1 ? r.w[1] : lid;
}

__device__ __forceinline__ double bf16_bits_to_double(uint16_t b) {
  return (double)__uint_as_float(((uint32_t)b) << 16);
}

enum HistMode { kSegment = 0, kRouted = 1, kAll = 2 };

// One launch covers rows [row_lo, row_hi) x the feature tile blockIdx.y x
// the channel set blockIdx.z (K5; K1/K3 launch one set).  w8 is
// [8 * sets, npad] bf16 (as raw bits): g_hi, g_lo, h_hi, h_lo, member, 0...
// per set; scales [sets, 2]; acc [sets, F * B, 3].  kAll reads no leaf ids.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
segment_hist_kernel(const uint8_t* __restrict__ bins,
                    const uint16_t* __restrict__ w8, int* leaf_id,
                    long long npad, int num_features, int num_bins,
                    int tile_features, long long row_lo, long long row_hi,
                    int target, const float* __restrict__ scales,
                    RouteDesc route, unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long smem[];
  const long long set = blockIdx.z;
  w8 += set * 8 * npad;
  scales += 2 * set;
  acc += set * 3ll * num_features * num_bins;
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int cells = nf * num_bins;
  unsigned long long* sg = smem;
  unsigned long long* sh = smem + cells;
  unsigned int* sc = reinterpret_cast<unsigned int*>(smem + 2 * cells);
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    sg[k] = 0ull;
    sh[k] = 0ull;
    sc[k] = 0u;
  }
  __syncthreads();

  const double scale_g = (double)scales[0];
  const double scale_h = (double)scales[1];
  const uint8_t* frow = bins + (long long)route.w[2] * npad;
  const uint8_t* tile = bins + (long long)f0 * npad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = row_lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < row_hi; i += stride) {
    if (kMode != kAll) {
      int lid = leaf_id[i];
      if (kMode == kRouted) {
        const int moved = routed_leaf(route, frow[i], lid);
        // the route is idempotent (moved rows stop matching route.w[0]),
        // so a tile reading an id another tile already rewrote agrees
        if (moved != lid && blockIdx.y == 0) leaf_id[i] = moved;
        lid = moved;
      }
      if (lid != target) continue;
    }
    // member is 0 (pad rows) or 1: the port has no bagging weights
    if (w8[4 * npad + i] == 0) continue;
    const long long qg = __double2ll_rn(
        (bf16_bits_to_double(w8[i]) + bf16_bits_to_double(w8[npad + i]))
        * scale_g);
    const long long qh = __double2ll_rn(
        (bf16_bits_to_double(w8[2 * npad + i])
         + bf16_bits_to_double(w8[3 * npad + i])) * scale_h);
    for (int f = 0; f < nf; ++f) {
      const int b = tile[(long long)f * npad + i];
      if (b >= num_bins) continue;   // the TPU one-hot drops such bins too
      const int k = f * num_bins + b;
      atomicAdd(&sg[k], (unsigned long long)qg);
      atomicAdd(&sh[k], (unsigned long long)qh);
      atomicAdd(&sc[k], 1u);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    if (sc[k] == 0u) continue;
    unsigned long long* dst = acc + 3ll * ((long long)f0 * num_bins + k);
    atomicAdd(dst + 0, sg[k]);
    atomicAdd(dst + 1, sh[k]);
    atomicAdd(dst + 2, (unsigned long long)sc[k]);
  }
}

// acc [sets, F*B, 3] fixed point -> out [sets, F*B, 3] f32 (sum_grad,
// sum_hess, count), each set at its own scales [sets, 2]
__global__ void finalize_kernel(const long long* __restrict__ acc,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int cells,
                                long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const long long set = k / cells;
  out[3 * k + 0] = (float)((double)acc[3 * k + 0] / (double)scales[2 * set]);
  out[3 * k + 1] = (float)((double)acc[3 * k + 1]
                           / (double)scales[2 * set + 1]);
  out[3 * k + 2] = (float)acc[3 * k + 2];
}

__global__ void route_window_kernel(const uint8_t* __restrict__ frow,
                                    int* __restrict__ leaf_id,
                                    long long row_lo, long long row_hi,
                                    RouteDesc route) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = row_lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < row_hi; i += stride) {
    const int lid = leaf_id[i];
    const int moved = routed_leaf(route, frow[i], lid);
    if (moved != lid) leaf_id[i] = moved;
  }
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

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Largest feature tile whose shared histogram fits the default 48 KB.
int lgbt_histogram_tile_features(int num_features, int num_bins) {
  const int ft = kSmemBudget / (num_bins * kBytesPerBin);
  return ft < 1 ? 0 : (ft < num_features ? ft : num_features);
}

// K1 (route == NULL) or K3 (route = host pointer to 19 ints).
// bins [F, npad] u8, w8 [8, npad] bf16 bits, leaf_id [npad] i32 (updated in
// place by K3), scales [2] f32 on the device, acc scratch [F*B*3] i64,
// out [F, B, 3] f32.  Returns cudaGetLastError().
int lgbt_histogram_segment(const uint8_t* bins, const uint16_t* w8,
                           int* leaf_id, long long npad, int num_features,
                           int num_bins, long long row_lo, long long row_hi,
                           int target, const float* scales, const int* route,
                           long long* acc, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cells_all = num_features * num_bins;
  cudaMemsetAsync(acc, 0, sizeof(long long) * 3 * (size_t)cells_all, s);
  const long long rows = row_hi - row_lo;
  if (rows > 0) {
    const int ft = lgbt_histogram_tile_features(num_features, num_bins);
    if (ft < 1) return (int)cudaErrorInvalidValue;
    const int tiles = (int)div_up(num_features, ft);
    long long bx = div_up(rows, 4ll * kThreads);
    const long long cap = div_up(4ll * sm_count(), tiles);
    if (bx > cap) bx = cap;
    dim3 grid((unsigned)bx, (unsigned)tiles);
    const size_t smem = (size_t)ft * num_bins * kBytesPerBin;
    RouteDesc desc = {};
    if (route != nullptr) {
      for (int k = 0; k < kRouteWords; ++k) desc.w[k] = route[k];
      segment_hist_kernel<kRouted><<<grid, kThreads, smem, s>>>(
          bins, w8, leaf_id, npad, num_features, num_bins, ft, row_lo,
          row_hi, target, scales, desc,
          reinterpret_cast<unsigned long long*>(acc));
    } else {
      segment_hist_kernel<kSegment><<<grid, kThreads, smem, s>>>(
          bins, w8, leaf_id, npad, num_features, num_bins, ft, row_lo,
          row_hi, target, scales, desc,
          reinterpret_cast<unsigned long long*>(acc));
    }
  }
  finalize_kernel<<<(unsigned)div_up(cells_all, kThreads), kThreads, 0, s>>>(
      acc, scales, out, cells_all, cells_all);
  return (int)cudaGetLastError();
}

// K5: bins [F, npad] u8, w8 [8 * sets, npad] bf16 bits (pad rows carry
// member 0), scales [sets, 2] f32 on the device, acc scratch
// [sets * F*B*3] i64, out [sets, F, B, 3] f32.  Returns cudaGetLastError().
int lgbt_histogram_all(const uint8_t* bins, const uint16_t* w8,
                       long long npad, int num_features, int num_bins,
                       int sets, const float* scales, long long* acc,
                       float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cells_all = num_features * num_bins;
  const long long total = (long long)sets * cells_all;
  cudaMemsetAsync(acc, 0, sizeof(long long) * 3 * (size_t)total, s);
  if (npad > 0 && sets > 0) {
    const int ft = lgbt_histogram_tile_features(num_features, num_bins);
    if (ft < 1) return (int)cudaErrorInvalidValue;
    const int tiles = (int)div_up(num_features, ft);
    long long bx = div_up(npad, 4ll * kThreads);
    const long long cap = div_up(4ll * sm_count(), (long long)tiles * sets);
    if (bx > cap) bx = cap;
    dim3 grid((unsigned)bx, (unsigned)tiles, (unsigned)sets);
    const size_t smem = (size_t)ft * num_bins * kBytesPerBin;
    RouteDesc desc = {};
    segment_hist_kernel<kAll><<<grid, kThreads, smem, s>>>(
        bins, w8, nullptr, npad, num_features, num_bins, ft, 0, npad, 0,
        scales, desc, reinterpret_cast<unsigned long long*>(acc));
  }
  if (total > 0) {
    finalize_kernel<<<(unsigned)div_up(total, kThreads), kThreads, 0, s>>>(
        acc, scales, out, cells_all, total);
  }
  return (int)cudaGetLastError();
}

// K2: route = host pointer to 19 ints; frow = the split feature's bin row.
int lgbt_route_window(const uint8_t* bins, int* leaf_id, long long npad,
                      long long row_lo, long long row_hi, const int* route,
                      void* stream) {
  RouteDesc desc;
  for (int k = 0; k < kRouteWords; ++k) desc.w[k] = route[k];
  const long long rows = row_hi - row_lo;
  if (rows > 0) {
    long long blocks = div_up(rows, kThreads);
    const long long cap = 16ll * sm_count();
    if (blocks > cap) blocks = cap;
    route_window_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        bins + (long long)desc.w[2] * npad, leaf_id, row_lo, row_hi, desc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
