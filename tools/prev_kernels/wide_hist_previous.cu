// The previous design of B3, kept as it was for timing only:
// tools/p1_time.py builds it into the previous designs' library beside
// predict_previous.cu and quantize_previous.cu and calls it in turns with
// the shipped lightgbm_tpu_torch/csrc/wide_hist.cu.  The package never
// builds or calls it.  Its interface: column-major bins [G, npad], the
// f32 channels w3 [3, npad] and scales [2] on the device.
//
// B3, the histogram of the second histogram path, for Hopper (sm_90a):
// lgbt_histogram_chunked, with a plain C interface, loaded through ctypes
// by lightgbm_tpu_torch/ops/kernels.py.
//
// It replaces lightgbm_tpu/ops/histogram.py histogram_chunked (:32,
// _hist_one_chunk :72): per (column, bin), the sums over every row of
// three f32 channels [grad * m, hess * m, m].  That function is not a
// Pallas kernel: XLA contracts a one-hot [rows, G, B] matrix against the
// channels at HIGHEST precision, in row chunks.  The JAX package takes
// it where the Pallas kernels cannot serve: a column of more than 256
// bins (two-byte bins), gpu_use_dp / tpu_double_precision, or
// tpu_histogram_backend="onehot" (lightgbm_tpu/models/gbdt.py:436-462),
// always with its fused grower.  Here the fused grower calls it
// (lightgbm_tpu_torch/models/grower_fused.py) for the root and for each
// split's smaller child, m selecting the leaf's rows.
//
// Exactness.  The channels are f32, their full mantissa (what
// gpu_use_dp asks for), not the bf16 hi + lo pairs K1-K7 read.  Each
// row with m != 0 adds round(grad * m * scale) and round(hess * m *
// scale) as 64-bit integers (the scales are powers of two,
// ops/histogram.py channel_scales, chosen so no sum can overflow) and 1
// to the count; integer adds commute, so every launch gives the same
// bits in any order of the threads, and the plain version
// (ops/histogram.py histogram_chunked_plain) repeats the arithmetic bit
// for bit.  The port's member channel is 0 or 1, so the count is the
// JAX package's sum of m.
//
// What bounds it.  One pass reads every row's three channels (12 B) and,
// for a row with m != 0, one bin a column (1 or 2 B): (G + 12) or
// (2 G + 12) B a row when every row is a member (the root).  Against
// that the work is five shared-memory atomics a (row, column) pair, which
// is what sets the time, as in K5 (PERF.md §6).
//
// The design, simple and exact first:
//   * one 1024-thread block an SM, with the SM's shared memory (227 KB),
//     holding five u32 planes (g lo, g hi, h lo, h hi, count) of a tile
//     of columns x B bins; a 64-bit sum is two 32-bit planes, the low
//     word's carry going into the high word's add (carry_of, as K1-K7
//     add them);
//   * columns tile across gridDim.y where they do not all fit (B = 1024:
//     20 KB a column, 11 a block; the bound above counts each tile's
//     re-read of the channels), row ranges across gridDim.x, one wave;
//   * a thread takes a row, skips it when m is 0 (a small leaf reads few
//     bins), and adds it into each column of its tile;
//   * each block flushes its tile's non-empty cells into a persistent i64
//     scratch with global atomics; the last block of the tile to arrive
//     converts the tile to f32 (each sum over its scale in f64) and
//     zeroes the scratch again: one launch a call;
//   * where not even one column's cells fit a block (B of 16,384 and
//     more), the rows add straight into the i64 scratch with 64-bit
//     global atomics (kGlobal), a block a range of rows over every
//     column; exact all the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB3Threads = 1024;
// a (column, bin) cell: g lo, g hi, h lo, h hi, count (u32 planes)
constexpr int kB3CellBytes = 5 * 4;

__device__ __forceinline__ unsigned b3_carry(unsigned old, unsigned add) {
  return old + add < old ? 1u : 0u;
}

template <typename BinT, bool kGlobal>
__global__ void __launch_bounds__(kB3Threads, 1)
chunked_hist_kernel(const BinT* __restrict__ bins,
                    const float* __restrict__ w3, long long npad,
                    int num_cols, int num_bins, int tile_cols,
                    const float* __restrict__ scales,
                    unsigned long long* __restrict__ acc,
                    unsigned int* __restrict__ arrivals,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int c0 = blockIdx.y * tile_cols;
  const int nc = min(tile_cols, num_cols - c0);
  const long long cells = (long long)nc * num_bins;
  unsigned* g_lo = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* g_hi = g_lo + cells;
  unsigned* h_lo = g_hi + cells;
  unsigned* h_hi = h_lo + cells;
  unsigned* cnt = h_hi + cells;
  if (!kGlobal) {
    for (long long k = threadIdx.x; k < 5 * cells; k += blockDim.x)
      g_lo[k] = 0u;
    __syncthreads();
  }
  const double sg = (double)scales[0], sh = (double)scales[1];
  const BinT* tile = bins + (long long)c0 * npad;
  unsigned long long* tile_acc = acc + 3ll * c0 * num_bins;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < npad; row += stride) {
    if (w3[2 * npad + row] == 0.0f) continue;
    const unsigned long long qg =
        (unsigned long long)__double2ll_rn((double)w3[row] * sg);
    const unsigned long long qh =
        (unsigned long long)__double2ll_rn((double)w3[npad + row] * sh);
    int b_next = (int)tile[row];
    for (int c = 0; c < nc; ++c) {
      const int b = b_next;
      if (c + 1 < nc) b_next = (int)tile[(long long)(c + 1) * npad + row];
      // the JAX one-hot drops a bin >= num_bins
      if (b >= num_bins) continue;
      const long long k = (long long)c * num_bins + b;
      if (kGlobal) {
        atomicAdd(tile_acc + 3 * k, qg);
        atomicAdd(tile_acc + 3 * k + 1, qh);
        atomicAdd(tile_acc + 3 * k + 2, 1ull);
      } else {
        const unsigned og = atomicAdd(g_lo + k, (unsigned)qg);
        const unsigned oh = atomicAdd(h_lo + k, (unsigned)qh);
        atomicAdd(cnt + k, 1u);
        atomicAdd(g_hi + k, (unsigned)(qg >> 32) + b3_carry(og, (unsigned)qg));
        atomicAdd(h_hi + k, (unsigned)(qh >> 32) + b3_carry(oh, (unsigned)qh));
      }
    }
  }
  if (!kGlobal) {
    __syncthreads();
    for (long long k = threadIdx.x; k < cells; k += blockDim.x) {
      if (cnt[k] == 0u) continue;
      unsigned long long* dst = tile_acc + 3 * k;
      atomicAdd(dst, ((unsigned long long)g_hi[k] << 32) | g_lo[k]);
      atomicAdd(dst + 1, ((unsigned long long)h_hi[k] << 32) | h_lo[k]);
      atomicAdd(dst + 2, (unsigned long long)cnt[k]);
    }
  }
  // the last block of the tile to arrive sees every block's adds
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* tile_out = out + 3ll * c0 * num_bins;
  for (long long k = threadIdx.x; k < cells; k += blockDim.x) {
    const long long a0 = (long long)__ldcg(tile_acc + 3 * k);
    const long long a1 = (long long)__ldcg(tile_acc + 3 * k + 1);
    const long long a2 = (long long)__ldcg(tile_acc + 3 * k + 2);
    tile_out[3 * k] = (float)((double)a0 / sg);
    tile_out[3 * k + 1] = (float)((double)a1 / sh);
    tile_out[3 * k + 2] = (float)a2;
    tile_acc[3 * k] = 0ull;
    tile_acc[3 * k + 1] = 0ull;
    tile_acc[3 * k + 2] = 0ull;
  }
  if (threadIdx.x == 0) arrivals[blockIdx.y] = 0u;
}

int b3_sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// The dynamic shared memory a block may take: the SM's, less the 1 KB
// the card reserves for each block, at most the block opt-in limit, less
// the kernel's static shared memory (s_last, rounded up).
int b3_smem_budget() {
  static int budget = 0;
  if (budget == 0) {
    int dev = 0, per_sm = 0, optin = 0, reserved = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&reserved,
                           cudaDevAttrReservedSharedMemoryPerBlock, dev);
    int b = per_sm - reserved;
    if (b > optin) b = optin;
    budget = b - 16;
  }
  return budget;
}

long long b3_div_up(long long a, long long b) { return (a + b - 1) / b; }

template <typename BinT, bool kGlobal>
int launch_chunked(const void* bins, const float* w3, long long npad,
                   int num_cols, int num_bins, int tile_cols, size_t smem,
                   const float* scales, unsigned long long* acc,
                   unsigned int* arrivals, float* out, cudaStream_t s) {
  static bool opted_in = false;
  if (!kGlobal && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_hist_kernel<BinT, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, b3_smem_budget());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int tiles = (int)b3_div_up(num_cols, tile_cols);
  // one wave: the SMs shared out over the tiles, at most a block a
  // 1024-row step
  long long bx = b3_sm_count() / tiles;
  if (bx < 1) bx = 1;
  const long long steps = b3_div_up(npad, kB3Threads);
  if (bx > steps) bx = steps > 0 ? steps : 1;
  dim3 grid((unsigned)bx, (unsigned)tiles);
  chunked_hist_kernel<BinT, kGlobal><<<grid, kB3Threads, smem, s>>>(
      static_cast<const BinT*>(bins), w3, npad, num_cols, num_bins,
      tile_cols, scales, acc, arrivals, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3's tiling: out[0] columns a tile, out[1] dynamic shared memory a
// block (bytes), out[2] 1 where no column fits a block (the global-atomic
// mode, one tile of every column).  As many columns as fit the budget,
// spread evenly over the fewest tiles.  Returns 0, or
// cudaErrorInvalidValue on an empty shape.
int lgbt_chunked_tiling(int num_cols, int num_bins, int* out) {
  if (num_cols < 1 || num_bins < 1) return (int)cudaErrorInvalidValue;
  const long long per_col = (long long)num_bins * kB3CellBytes;
  long long most = b3_smem_budget() / per_col;
  if (most < 1) {
    out[0] = num_cols;
    out[1] = 0;
    out[2] = 1;
    return 0;
  }
  if (most > num_cols) most = num_cols;
  const long long tc = b3_div_up(num_cols, b3_div_up(num_cols, most));
  out[0] = (int)tc;
  out[1] = (int)(tc * per_col);
  out[2] = 0;
  return 0;
}

// B3, one kernel launch and no other operation on the stream.  bins
// [num_cols, npad] of bin_bytes 1 (u8) or 2 (u16), w3 [3, npad] f32
// (grad * m, hess * m, m; pad rows m = 0), scales [2] f32 powers of two
// on the device; scratch = the wrapper's persistent i64 buffer, all
// zero, of num_cols * num_bins * 3 words plus one u32 a column tile, left
// all zero; out [num_cols, num_bins, 3] f32.  Returns a CUDA error code
// (0 on success).
int lgbt_histogram_chunked(const void* bins, int bin_bytes, const float* w3,
                           long long npad, int num_cols, int num_bins,
                           const float* scales, long long* scratch,
                           float* out, void* stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) || npad < 0 || num_bins > 65536)
    return (int)cudaErrorInvalidValue;
  int tiling[3];
  const int rc = lgbt_chunked_tiling(num_cols, num_bins, tiling);
  if (rc != 0) return rc;
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* arrivals = reinterpret_cast<unsigned int*>(
      scratch + 3ll * num_cols * num_bins);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)tiling[1];
  if (tiling[2] != 0)
    return bin_bytes == 1
        ? launch_chunked<uint8_t, true>(bins, w3, npad, num_cols, num_bins,
                                        tiling[0], 0, scales, acc, arrivals,
                                        out, s)
        : launch_chunked<uint16_t, true>(bins, w3, npad, num_cols, num_bins,
                                         tiling[0], 0, scales, acc, arrivals,
                                         out, s);
  return bin_bytes == 1
      ? launch_chunked<uint8_t, false>(bins, w3, npad, num_cols, num_bins,
                                       tiling[0], smem, scales, acc,
                                       arrivals, out, s)
      : launch_chunked<uint16_t, false>(bins, w3, npad, num_cols, num_bins,
                                        tiling[0], smem, scales, acc,
                                        arrivals, out, s);
}

}  // extern "C"
