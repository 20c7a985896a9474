// Histograms and split routing of the segment and frontier growers, for Hopper
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
//       root histograms of all C class trees of a multiclass iteration;
//   lgbt_histogram_frontier — K6 without routes, replaces
//       pallas_histogram.py:histogram_frontier (_kernel_frontier); with K
//       routes, K7, replaces histogram_frontier_routed (KT = K targets)
//       and histogram_frontier_fusedk (KT = 2K) (_kernel_frontier_routed).
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
// K6/K7 (the frontier grower's batched kernels) walk the rows of a list of
// whole row blocks, the union of the round's confinement windows, not one
// window; K7 first applies the round's K split routes to each row's leaf
// id (at most one route matches a row, since the routed leaves are
// distinct and no new id is a routed leaf), then each row adds to the
// histogram of the target slot its leaf id matches (targets are distinct;
// -1 matches nothing).  Same fixed-point sums as K1: slot k of a launch is,
// bit for bit, K1 of target k over the same rows at the same scale.
//
// Shared memory: a histogram of ft features x B bins x (8 + 8 + 4) bytes.
// Features are tiled across gridDim.y so a tile fits the 48 KB a block
// gets without opting in (37 features at 64 bins, 9 at 256 bins); each
// tile re-reads the leaf ids and weights, which costs bytes only on
// shapes wider than the HIGGS one.  K5 adds the class sets as gridDim.z,
// so its bin rows are read once per set: (F + 10) bytes a row and set
// against the (F + 10 C) bytes a row of one pass over all sets.  K6/K7
// hold ft features x tt target slots per block: a slot of one feature is
// 20 B a bin, so 16 slots at 64 bins take 20 KB a feature and 32 slots at
// 256 bins 160 KB.  They opt in to kFrontierSmemBudget (above the 48 KB
// default; two such blocks of 512 threads fit an SM, one wave of them
// covers the grid) and tile features across gridDim.y
// and, when one feature's KT slots do not fit, target slots across
// gridDim.z (lgbt_frontier_tiling).  Every tile re-reads its rows' leaf
// ids and weights; K7's route is rewritten by tile (0, 0) only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRouteWords = 19;   // pallas_histogram.py:_ROUTE_WORDS
constexpr int kMissingZero = 1;   // core/binning.py MISSING_ZERO
constexpr int kMissingNan = 2;    // core/binning.py MISSING_NAN
constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;
constexpr int kFrontierSmemBudget = 100 * 1024;
// two frontier blocks of at most kFrontierSmemBudget fit an SM; at 512
// threads each they keep 32 warps resident to hide the shared atomics'
// latency (at 256, the first version, 16)
constexpr int kFrontierThreads = 512;
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
// sum_hess, count), set s at scales[scale_step * s : + 2] (scale_step 2:
// K5's one pair per set; 0: the frontier kernels' target slots, which
// share the tree's one pair)
__global__ void finalize_kernel(const long long* __restrict__ acc,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int cells,
                                long long total, int scale_step) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const float* sc = scales + scale_step * (k / cells);
  out[3 * k + 0] = (float)((double)acc[3 * k + 0] / (double)sc[0]);
  out[3 * k + 1] = (float)((double)acc[3 * k + 1] / (double)sc[1]);
  out[3 * k + 2] = (float)acc[3 * k + 2];
}

// K6 (kRouted false) and K7 (true).  One launch covers the rows of
// block_list[:n_blocks] (n_rows = n_blocks * block_rows) x the feature
// tile blockIdx.y x the target tile blockIdx.z.  params (device memory):
// targets[n_targets], then n_routes route descriptors of kRouteWords.
// acc [n_targets, F * B, 3]: slot k's histogram at offset k * F * B * 3.
template <bool kRouted>
__global__ void __launch_bounds__(kFrontierThreads, 2)
frontier_hist_kernel(const uint8_t* __restrict__ bins,
                     const uint16_t* __restrict__ w8, int* leaf_id,
                     long long npad, int num_features, int num_bins,
                     int tile_features, int tile_targets,
                     const int* __restrict__ block_list, long long n_rows,
                     int block_rows, const int* __restrict__ params,
                     int n_targets, int n_routes,
                     const float* __restrict__ scales,
                     unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long smem[];
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int s0 = blockIdx.z * tile_targets;
  const int ns = min(tile_targets, n_targets - s0);
  const int slot_cells = nf * num_bins;
  const int cells = ns * slot_cells;
  unsigned long long* sg = smem;
  unsigned long long* sh = smem + cells;
  unsigned int* sc = reinterpret_cast<unsigned int*>(smem + 2 * cells);
  int* s_target = reinterpret_cast<int*>(sc + cells);     // [ns]
  int* s_route_leaf = s_target + ns;                       // [n_routes]
  const int* routes = params + n_targets;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    sg[k] = 0ull;
    sh[k] = 0ull;
    sc[k] = 0u;
  }
  for (int k = threadIdx.x; k < ns; k += blockDim.x)
    s_target[k] = params[s0 + k];
  for (int k = threadIdx.x; k < n_routes; k += blockDim.x)
    s_route_leaf[k] = routes[k * kRouteWords];
  __syncthreads();

  const double scale_g = (double)scales[0];
  const double scale_h = (double)scales[1];
  const uint8_t* tile = bins + (long long)f0 * npad;
  const bool writer = blockIdx.y == 0 && blockIdx.z == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    const long long pos = i / block_rows;
    const long long row = (long long)block_list[pos] * block_rows
                          + (i - pos * block_rows);
    if (row < 0 || row >= npad) continue;   // a block outside the layout
    int lid = leaf_id[row];
    if (kRouted) {
      int r = -1;
      for (int k = 0; k < n_routes; ++k) {
        if (s_route_leaf[k] == lid) {
          r = k;
          break;
        }
      }
      if (r >= 0) {
        RouteDesc desc;
#pragma unroll
        for (int k = 0; k < kRouteWords; ++k)
          desc.w[k] = routes[r * kRouteWords + k];
        const int moved = routed_leaf(
            desc, bins[(long long)desc.w[2] * npad + row], lid);
        // idempotent (a moved row matches no route), so a tile that reads
        // an id tile (0, 0) already rewrote computes the same id
        if (moved != lid && writer) leaf_id[row] = moved;
        lid = moved;
      }
    }
    int s = -1;
    for (int k = 0; k < ns; ++k) {
      if (s_target[k] == lid) {
        s = k;
        break;
      }
    }
    if (s < 0) continue;
    if (w8[4 * npad + row] == 0) continue;   // member 0: a pad row
    const long long qg = __double2ll_rn(
        (bf16_bits_to_double(w8[row]) + bf16_bits_to_double(w8[npad + row]))
        * scale_g);
    const long long qh = __double2ll_rn(
        (bf16_bits_to_double(w8[2 * npad + row])
         + bf16_bits_to_double(w8[3 * npad + row])) * scale_h);
    const int base = s * slot_cells;
    for (int f = 0; f < nf; ++f) {
      const int b = tile[(long long)f * npad + row];
      if (b >= num_bins) continue;
      const int k = base + f * num_bins + b;
      atomicAdd(&sg[k], (unsigned long long)qg);
      atomicAdd(&sh[k], (unsigned long long)qh);
      atomicAdd(&sc[k], 1u);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    if (sc[k] == 0u) continue;
    const int s = k / slot_cells;
    const int fb = k - s * slot_cells;
    unsigned long long* dst =
        acc + 3ll * ((long long)(s0 + s) * num_features * num_bins
                     + (long long)f0 * num_bins + fb);
    atomicAdd(dst + 0, sg[k]);
    atomicAdd(dst + 1, sh[k]);
    atomicAdd(dst + 2, (unsigned long long)sc[k]);
  }
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

// Opts the kernel in to `smem` bytes of dynamic shared memory when that is
// above the default, then launches one wave: as many blocks as fit the
// card at once, split over the tiles (fewer when the rows are few), so
// each block flushes its shared histogram once.  Returns a CUDA error.
template <bool kRouted>
int launch_frontier(int tiles_y, int tiles_z, size_t smem, cudaStream_t s,
                    const uint8_t* bins, const uint16_t* w8, int* leaf_id,
                    long long npad, int num_features, int num_bins, int ft,
                    int tt, const int* block_list, long long n_rows,
                    int block_rows, const int* params, int n_targets,
                    int n_routes, const float* scales, long long* acc) {
  cudaError_t e = cudaSuccess;
  if (smem > (size_t)kSmemBudget) {
    e = cudaFuncSetAttribute(frontier_hist_kernel<kRouted>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, frontier_hist_kernel<kRouted>, kFrontierThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)tiles_y * tiles_z;
  long long bx = div_up(n_rows, 4ll * kFrontierThreads);
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const long long cap = wave / tiles > 0 ? wave / tiles : 1;
  if (bx > cap) bx = cap;
  dim3 grid((unsigned)bx, (unsigned)tiles_y, (unsigned)tiles_z);
  frontier_hist_kernel<kRouted><<<grid, kFrontierThreads, smem, s>>>(
      bins, w8, leaf_id, npad, num_features, num_bins, ft, tt, block_list,
      n_rows, block_rows, params, n_targets, n_routes, scales,
      reinterpret_cast<unsigned long long*>(acc));
  return 0;
}

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
      acc, scales, out, cells_all, cells_all, 2);
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
        acc, scales, out, cells_all, total, 2);
  }
  return (int)cudaGetLastError();
}

// K6/K7 tiling: out[0] features per tile, out[1] target slots per tile,
// out[2] dynamic shared memory a block (bytes).  All n_targets slots of
// as many features as fit kFrontierSmemBudget; when one feature's slots
// do not fit, one feature a tile and as many slots as fit.  Returns 0, or
// cudaErrorInvalidValue when not even one slot of one feature fits.
int lgbt_frontier_tiling(int num_features, int num_bins, int n_targets,
                         int n_routes, int* out) {
  const int slot_bytes = num_bins * kBytesPerBin;
  const int budget =
      kFrontierSmemBudget - 4 * (n_routes + n_targets) - 8;
  if (num_features < 1 || n_targets < 1 || budget < slot_bytes)
    return (int)cudaErrorInvalidValue;
  int ft, tt;
  if ((long long)n_targets * slot_bytes <= budget) {
    tt = n_targets;
    ft = budget / (n_targets * slot_bytes);
    if (ft > num_features) ft = num_features;
  } else {
    ft = 1;
    tt = budget / slot_bytes;
  }
  out[0] = ft;
  out[1] = tt;
  out[2] = ft * tt * slot_bytes + 4 * (tt + n_routes);
  return 0;
}

// K6 (n_routes == 0) or K7 (n_routes > 0, KT = n_targets = K or 2K).
// bins [F, npad] u8, w8 [8, npad] bf16 bits, leaf_id [npad] i32 (K7
// updates it in place over the listed blocks), block_list [>= n_blocks]
// i32 on the device, params on the device: targets [n_targets] then
// routes [n_routes, 19]; scales [2] f32 on the device, acc scratch
// [n_targets * F*B*3] i64, out [n_targets, F, B, 3] f32.  n_blocks == 0
// writes zero histograms and leaves leaf_id alone.  Returns a CUDA error
// code (0 on success).
int lgbt_histogram_frontier(const uint8_t* bins, const uint16_t* w8,
                            int* leaf_id, long long npad, int num_features,
                            int num_bins, int block_rows,
                            const int* block_list, long long n_blocks,
                            const int* params, int n_targets, int n_routes,
                            const float* scales, long long* acc, float* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int tiling[3];
  int rc = lgbt_frontier_tiling(num_features, num_bins, n_targets, n_routes,
                                tiling);
  if (rc != 0) return rc;
  const int ft = tiling[0], tt = tiling[1];
  const size_t smem = (size_t)tiling[2];
  const long long total = (long long)n_targets * num_features * num_bins;
  cudaMemsetAsync(acc, 0, sizeof(long long) * 3 * (size_t)total, s);
  const long long n_rows = n_blocks * (long long)block_rows;
  if (n_rows > 0) {
    const int tiles_y = (int)div_up(num_features, ft);
    const int tiles_z = (int)div_up(n_targets, tt);
    rc = n_routes > 0
             ? launch_frontier<true>(tiles_y, tiles_z, smem, s, bins, w8,
                                     leaf_id, npad, num_features, num_bins,
                                     ft, tt, block_list, n_rows, block_rows,
                                     params, n_targets, n_routes, scales, acc)
             : launch_frontier<false>(tiles_y, tiles_z, smem, s, bins, w8,
                                      leaf_id, npad, num_features, num_bins,
                                      ft, tt, block_list, n_rows, block_rows,
                                      params, n_targets, n_routes, scales,
                                      acc);
    if (rc != 0) return rc;
  }
  finalize_kernel<<<(unsigned)div_up(total, kThreads), kThreads, 0, s>>>(
      acc, scales, out, num_features * num_bins, total, 0);
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
