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
//   lgbt_histogram_segment_step, lgbt_route_window_step — K1/K3 and K2
//       with their window, target and route read from a step block in
//       device memory, as the TPU kernels read their scalar-prefetch
//       operand (pallas_histogram.py:1100-1110, :1583): the segment
//       grower's split step, replayed in a CUDA graph, asks the host for
//       nothing;
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
// K5 computes the same sums over every row, once per channel set, in the
// same fixed point at the set's own scale, so class c's slice equals K1 on
// a root of class c at that scale, bit for bit.  The TPU kernel contracted
// a one-hot [F*B, chunk] matrix against the weight channels on the matrix
// unit; here a histogram is a scatter into shared memory, as in the
// reference's OpenCL kernels (src/treelearner/ocl/histogram{16,64,256}.cl).
//
// What bounds it.  The least time is set by bytes: one pass reads, per row
// of the window, the leaf id (4 B), the five live bf16 weight channels
// (10 B) and one bin byte per feature; at the HIGGS shape (28 features)
// about 42 B a row against a handful of integer operations, far below the
// card's ratio of operations to bytes.  What sets the time instead is the
// shared-memory adds and the chain of loads that feeds them (PERF.md has
// the measurements): five 32-bit atomics per (row, feature) pair, and per
// (row, feature, set) in K5.
//
// Determinism: float atomics would make the sums depend on the order in
// which threads arrive.  Gradients and hessians are converted to 64-bit
// fixed point (value * 2^k, k chosen per tree by fixed_point_scales so no
// sum can overflow) and added as integers, so every launch gives the same
// bits whatever the scheduling.  Counts are integers too.
//
// K1/K3's body (segment_window_kernel) is the K6/K7 scheme for one target
// over one window:
//   * one launch a call, nothing else on the stream: blocks flush into a
//     persistent i64 scratch kept zero, and the last block of a feature
//     tile converts it to f32 and zeroes it again;
//   * one 1024-thread block an SM with up to 227 KB of shared memory, so
//     28 features fit one tile at 256 bins (the first body's 48 KB blocks
//     took 4 tiles there, each re-reading leaf ids and weights); one block
//     a 1024-row step of the window, at most one wave, so a late split's
//     window of a few row blocks still spreads over several SMs;
//   * each warp queues the rows that match (a ballot and its prefix) and
//     adds 32 at a time, a row a lane, however sparse the matches;
//   * a 64-bit sum is two 32-bit shared planes with the low word's carry
//     (carry_of); no compare-and-swap loop;
//   * every lane of a warp adds the same feature at once, four features
//     at a time, while the next four features' bins load: without that
//     prefetch each group of adds waited on its loads (1.7x the time at
//     the HIGGS root).
// Lanes that add different features at once into a bin-major histogram
// (a feature a bank), copies of the histogram by warp, and staging the
// bins in shared memory were each slower (tools/segment_candidates.py,
// PERF.md).  Features tile across gridDim.y where they do not fit one
// block (lgbt_segment_tiling); only tile 0 writes K3's ids back (the
// route is idempotent).
//
// K5 (all_hist_kernel) is K1's body over every row and C channel sets:
// the same block, scratch, carry adds and prefetching add loop, but no
// leaf-id test and so no queue (every row but the pad rows is in the
// root: a lane adds its own row, one set after another).  A block holds
// the cells of a tile of (feature, set) pairs, features across gridDim.y
// and sets across gridDim.z.  One tile of every pair would read (F + 10 C)
// bytes a row, the bound and what the TPU kernel's one pass over all sets
// read (pallas_histogram.py:482-505); but the adds, not the bytes, set
// the time, and lgbt_all_tiling gives a block one set and its features,
// which measured fastest.
//
// K2 (route_window_kernel) rewrites the leaf ids of one window.  Its bound
// is 5 B a row plus 4 B a moved row; what held its first version at a
// third of it was one row a thread (a one-byte and a four-byte load in
// flight) and the route's arithmetic on every row.  Each block now first
// turns the route into a table of the 256 bin values (a row with bin g of
// the routed leaf goes right or not: one ballot a warp), and each thread
// routes 4 consecutive rows a step, its bins in one 4-byte load and its
// ids in one 16-byte load, writing back the ids only where one changed;
// the grid is sized to the window, so a late split's few row blocks
// spread over many SMs (16 rows a thread was slower: fewer threads, more
// registers).
//
// K6/K7 (the frontier grower's batched kernels) walk the rows of a list of
// whole row blocks, the union of the round's confinement windows, not one
// window; K7 first applies the round's K split routes to each row's leaf
// id (at most one route matches a row, since the routed leaves are
// distinct and no new id is a routed leaf), then each row adds to the
// histogram of the target slot its leaf id matches (-1 matches nothing).
// Same fixed-point sums as K1: slot k of a launch is, bit for bit, K1 of
// target k over the same rows at the same scale.
//
// What bounds K6/K7, and what held the first version back.  The bytes are
// few (4 B of leaf id a listed row, F + 10 B a row in a target: 0.035 ms
// at the HIGGS round), so the time is instructions and shared-memory
// atomics.  The first version spent it around the sums: four device
// operations a call (a blocking upload of targets and routes, a memset of
// the i64 scratch, the kernel, a finalize kernel); a 64-bit division and
// linear searches over the KT targets and K routes on every row, repeated
// by each of 7-14 feature tiles of 100 KB blocks; each route's 19 words
// reloaded from device memory; two 64-bit shared atomics per (row,
// feature), for which sm_90 has no native add (PERF.md has the SASS).
//
// The design.  One launch a call, with nothing else on the stream:
//   * targets and routes travel by value in the kernel's parameter block
//     (FrontierParams, 21.5 KB; CUDA 12.1+ takes up to 32,764 bytes), so
//     no host-to-device copy;
//   * each block builds leaf -> slot and leaf -> route tables (16-bit, as
//     long as the largest id the host found) and the route descriptors in
//     shared memory, so a row's bookkeeping is two table reads;
//   * one block an SM, of 1024 threads and the SM's whole shared memory
//     (227 KB), so a tile holds 2-3x the features of two 100 KB blocks
//     and fewer tiles re-walk the rows (HIGGS: 3 instead of 7; fused-K 6
//     instead of 14); a step of the block is 1024 rows of one listed row
//     block, so no row pays a division;
//   * a 64-bit sum is two 32-bit planes in shared memory: the low word's
//     atomic add returns the old value, whose carry goes into the high
//     word's add (XGBoost's AtomicAdd64As32).  Integer adds commute, so
//     the sums are exact and the same in any order;
//   * a block flushes its tile's non-empty cells to a persistent i64
//     scratch with global atomics, then counts itself in the tile's
//     arrival counter; the last block of the tile converts the tile to
//     f32 (each sum over its scale, in double), and zeroes the scratch
//     cells and the counter for the next launch.
// Features tile across gridDim.y and, when one feature's KT slots do not
// fit, target slots across gridDim.z (lgbt_frontier_tiling).  Every tile
// re-reads its rows' leaf ids; K7's ids are rewritten by tile (0, 0) only.
//
// The 4-bit packed layout (kPacked4; the TPU kernels' packed4 branch,
// _accumulate_block's nibble unpack at pallas_histogram.py:329-334 and
// _route_block_ids' parity at :1018; the reference's Dense4bitsBin,
// dense_nbits_bin.hpp:42).  A dataset whose bin axis is at most 16 stores
// two columns a byte: column 2i in the low nibble of byte row i, 2i + 1 in
// the high one (ops/histogram.py:pack_bins_4bit), so the bins are
// [ceil(G / 2), npad] and every kernel that reads them reads each byte and
// picks the nibble itself (unpack_bin); no unpacked copy exists.  The
// histogram kernels then take num_features = the logical columns (2 x the
// byte rows, the pad nibble of an odd G included, as the TPU kernels'
// F_log), and their tilings cut features in pairs, so a tile starts on a
// byte and each byte the four-feature loads fetch feeds two features
// (load_bins4).  A route's w[2] is the byte row and w[3] the column, whose
// parity picks the nibble; K2's table is built over the 256 byte values
// with the nibble already picked, so its row loop is unchanged.  The bound
// falls with the bytes: at HIGGS (28 columns) K1 reads G / 2 + 14 = 28 B a
// row instead of 42; the adds, 16 bins where there were 64, meet more
// often on one address.
//
// The packed-accumulator stream (kAcc; the TPU kernels' int32 weight
// branch, _packed_wrows at pallas_histogram.py:245-258, taken by
// _kernel_all, _kernel_segment, _kernel_frontier, _kernel_segment_routed
// and _kernel_frontier_routed).  In place of the eight bf16 channels the
// weights are ops/histogram.py quantize_pack's [2, npad] int32 stream: row
// 0 packs a row's stochastically rounded gradient (high half) and hessian
// (low half) as int16, row 1 holds member as f32 bits.  A row reads one
// int32 for both values and one for member; each half is sign-extended
// and rounded to bf16 (acc_value: the identity up to 9 bits, and the value
// the TPU's matrix unit adds above), and added as a 32-bit integer: a
// cell is three 32-bit shared planes (g, h, count) and three independent
// atomics a (row, feature), no carry chain, 12 B where the fixed-point
// cell takes 20 B, so the tilings fit more features (K1/K3/K5) or slots
// (K6/K7) a tile.  A block's int32 sums stay exact: |value| <= 2^14 (15
// bits, bf16-rounded), and the launches give each block at most
// kAccMaxRows rows (more blocks where the rows need them), so no plane
// passes 2^31.  The flush and the last block's finalize are
// the fixed-point ones; the finalize writes float(sum) * scale in f32,
// the order of unpack_hist_packed (pallas_histogram.py:236-242), with the
// quantizer's scales.  A sum below 2^24 is then, bit for bit, the TPU
// kernel's f32 matrix-unit sum; above 2^24 that sum rounds, and this one
// stays the exact integer.  The bound falls by the two channels' 2 B a
// row: at HIGGS K1 reads G + 12 B a row instead of G + 14.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kRouteWords = 19;   // pallas_histogram.py:_ROUTE_WORDS
constexpr int kMissingZero = 1;   // core/binning.py MISSING_ZERO
constexpr int kMissingNan = 2;    // core/binning.py MISSING_NAN
// K2: threads a block (one bin value of the route table each), rows a
// thread a step (1, 4 or 16), and the route by the table (true) or by
// routed_leaf on every row (false)
constexpr int kRouteThreads = 256;
constexpr int kRouteRows = 4;
constexpr bool kRouteTable = true;
// K1/K3 and K5: one block an SM of 1024 threads
constexpr int kSegThreads = 1024;
// the warps' queues of matching rows: 64 rows (i32) a warp
constexpr int kSegQueueBytes = kSegThreads * 2 * 4;
// a (feature, bin) cell, and K6/K7's (slot, feature, bin) cell: g lo, g
// hi, h lo, h hi, count, u32 planes; (kAcc) g, h, count
constexpr int kFixedCellBytes = 5 * 4;
constexpr int kAccCellBytes = 3 * 4;
__host__ __device__ constexpr int cell_bytes(bool acc) {
  return acc ? kAccCellBytes : kFixedCellBytes;
}
// rows a block walks at least (one step of the block): a window of a
// few row blocks still spreads over as many SMs as it has steps
constexpr int kSegMinRows = kSegThreads;
// K6/K7: blocks an SM, each of 1024 / kFrontierBlocksPerSm threads and an
// equal share of the SM's shared memory (32 warps an SM either way)
constexpr int kFrontierBlocksPerSm = 1;
constexpr int kFrontierThreads = 1024 / kFrontierBlocksPerSm;
// kAcc: the rows a block may walk, so that a shared int32 plane cannot
// pass 2^31 when every row adds the largest value, 2^14 (qmax 16383 at 15
// bits, rounded to bf16)
constexpr int kAccMaxValue = 1 << 14;
constexpr long long kAccMaxRows = 0x7fffffffll / kAccMaxValue;
static_assert(kAccMaxRows >= kSegThreads && kAccMaxRows >= kFrontierThreads,
              "a step fits an int32 plane");
// the parameter block's capacity: every frontier the grower asks at
// num_leaves <= 257 (K <= 256 routes, KT = 2K targets);
// ops/histogram.py:FRONTIER_MAX_ROUTES / _TARGETS
constexpr int kFrontierMaxRoutes = 256;
constexpr int kFrontierMaxTargets = 512;

// pack_route's layout: leaf, new_leaf, row, col, thr, dl, cat, mt, dbin,
// nbf, off, bitset[8]
struct RouteDesc {
  int w[kRouteWords];
};

// K6/K7's parameter block, passed by value (ops/histogram.py:
// frontier_params packs it): the target leaf of each slot (-1 = none; an
// id repeated by a later slot or route is -1 there, so the first wins),
// the route descriptors, and n_ids = 1 + the largest leaf id among the
// targets and the routed leaves (the length of the shared leaf tables).
struct FrontierParams {
  int n_targets, n_routes, n_ids, pad;
  int targets[kFrontierMaxTargets];
  int routes[kFrontierMaxRoutes * kRouteWords];
};

// shared-memory layout of a K6/K7 block: leaf -> slot and leaf -> route
// tables (int16, n_ids each), the route descriptors (K7), the queue of
// matching rows, then the five u32 planes of the histogram; each part
// 16-byte aligned
__host__ __device__ inline int frontier_table_bytes(int n_ids) {
  return (n_ids * 4 + 15) / 16 * 16;
}
__host__ __device__ inline int frontier_route_bytes(int n_routes) {
  return (n_routes * kRouteWords * 4 + 15) / 16 * 16;
}
// the warps' queues of matching rows: 64 (row i32, slot i16) a warp
constexpr int kFrontierQueueBytes = 2 * kFrontierThreads * (4 + 2);
// the kernel's static shared memory (the last-block flag), rounded up
constexpr int kFrontierStaticSmem = 16;

// Whether a row of the routed leaf whose value in the split feature's bin
// row is `g` goes right (takes new_leaf): _route_block_ids
// (pallas_histogram.py:1007-1042) for one row, in the same 0/1 integer
// arithmetic.
__device__ __forceinline__ int goes_right(const RouteDesc& r, int g) {
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
  return 1 - go_left;
}

// One row's leaf id after the split (K3, K7, and K2 without its table).
__device__ __forceinline__ int routed_leaf(const RouteDesc& r, int g,
                                           int lid) {
  return lid == r.w[0] && goes_right(r, g) == 1 ? r.w[1] : lid;
}

// The bin of logical column `col` from the byte that holds it: the byte
// itself, or (kPacked4) its low nibble for an even column and its high
// nibble for an odd one (ops/histogram.py:unpack_nibble).  Every read of
// training bins goes through it.
template <bool kPacked4>
__device__ __forceinline__ int unpack_bin(int byte, int col) {
  if (!kPacked4) return byte;
  return (col & 1) ? byte >> 4 : byte & 15;
}

// The bins of columns c .. c + 3 of one row into nb (num_bins, which no
// cell takes, from column `end` on), `brow` pointing at the row in the
// byte row of column 0.  Unpacked, a byte a column; packed, c even (the
// tilings cut features in pairs), one byte feeds two columns.
template <bool kPacked4>
__device__ __forceinline__ void load_bins4(const uint8_t* __restrict__ brow,
                                           long long npad, int c, int end,
                                           int num_bins, int nb[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kPacked4 && (j & 1)) continue;
    const int col = c + j;
    const int byte = col < end
        ? (int)brow[(long long)(kPacked4 ? col >> 1 : col) * npad] : 0;
    nb[j] = col < end ? unpack_bin<kPacked4>(byte, col) : num_bins;
    if (kPacked4)
      nb[j + 1] = col + 1 < end ? unpack_bin<kPacked4>(byte, col + 1)
                                : num_bins;
  }
}

// The split column's bin of a row, from the route's byte row w[2] (frow:
// that row of the bin matrix) and, packed, the parity of its column w[3].
template <bool kPacked4>
__device__ __forceinline__ int route_bin(const uint8_t* __restrict__ frow,
                                         const RouteDesc& r, long long row) {
  return unpack_bin<kPacked4>(frow[row], r.w[3]);
}

// A split's step block, as the segment grower's device loop writes it
// (ops/histogram.py:pack_step): [start_block, n_blocks, target, route[19]]
// int32 in device memory, the TPU kernels' scalar-prefetch operand
// (pallas_histogram.py:1100-1102).  The window is rows [row_lo, row_hi):
// whole row blocks, clipped to the layout, as the by-value entries' hosts
// clip it (ops/histogram.py:_window).  A route whose bin row lies outside
// the bin matrix routes nothing (its leaf becomes -1).
struct StepArgs {
  long long row_lo, row_hi;
  int target;
  RouteDesc route;
};

__device__ __forceinline__ StepArgs read_step(const int* __restrict__ step,
                                              long long npad, int block_rows,
                                              int bin_rows) {
  StepArgs a;
  const long long start = __ldg(step), n_blocks = __ldg(step + 1);
  a.row_lo = min(max(start, 0ll) * block_rows, npad);
  a.row_hi = min(a.row_lo + max(n_blocks, 0ll) * block_rows, npad);
  a.target = __ldg(step + 2);
#pragma unroll
  for (int k = 0; k < kRouteWords; ++k) a.route.w[k] = __ldg(step + 3 + k);
  if (a.route.w[2] < 0 || a.route.w[2] >= bin_rows) {
    a.route.w[0] = -1;
    a.route.w[2] = 0;
  }
  return a;
}

__device__ __forceinline__ double bf16_bits_to_double(uint16_t b) {
  return (double)__uint_as_float(((uint32_t)b) << 16);
}

// K6/K7 add a 64-bit value into a shared word pair (lo, hi) with two
// 32-bit atomics: the low word's add returns what the word held, whose
// carry_of the add goes, with the value's high half, into the high word.
// Every wrap of the low word adds exactly one carry, so (hi, lo) is the
// 64-bit sum modulo 2^64 whatever the order of the adds.
__device__ __forceinline__ unsigned carry_of(unsigned old, unsigned add) {
  return old + add < old ? 1u : 0u;
}

// kAcc: a quantized value as the TPU kernels add it, i32 -> f32 -> bf16
// (round to nearest even) and back: the identity for |q| <= 256, so for
// up to 9 bits (pallas_histogram.py:255-256).
__device__ __forceinline__ int acc_value(int q) {
  return (int)__bfloat162float(__float2bfloat16_rn((float)q));
}

// Whether row `row` is a member (not a pad or out-of-bag row) in a weight
// stream `w`: w8's member channel (bf16 bits, row 4), or (kAcc) row 1 of
// the int32 stream (f32 bits).  Member is 0 or 1 in the port.
template <bool kAcc>
__device__ __forceinline__ bool is_member(const uint16_t* __restrict__ w,
                                          long long npad, long long row) {
  if (kAcc) return reinterpret_cast<const int*>(w)[npad + row] != 0;
  return w[4 * npad + row] != 0;
}

// A row's 32-bit adds {g lo, g hi, h lo, h hi} from the weight stream `w`:
// the halves of its 64-bit fixed-point gradient and hessian (the hi + lo
// bf16 channels times the scales, rounded to the nearest integer), or
// (kAcc) its two quantized values (unpacked, sign-extended, acc_value),
// whose high words no add reads.
template <bool kAcc>
__device__ __forceinline__ void row_adds(const uint16_t* __restrict__ w,
                                         long long npad, long long row,
                                         double scale_g, double scale_h,
                                         unsigned a[4]) {
  if (kAcc) {
    const int q = reinterpret_cast<const int*>(w)[row];
    a[0] = (unsigned)acc_value(q >> 16);
    a[2] = (unsigned)acc_value((int)((unsigned)q << 16) >> 16);
    a[1] = a[3] = 0u;
    return;
  }
  const unsigned long long qg = (unsigned long long)__double2ll_rn(
      (bf16_bits_to_double(w[row]) + bf16_bits_to_double(w[npad + row]))
      * scale_g);
  const unsigned long long qh = (unsigned long long)__double2ll_rn(
      (bf16_bits_to_double(w[2 * npad + row])
       + bf16_bits_to_double(w[3 * npad + row])) * scale_h);
  a[0] = (unsigned)qg;
  a[1] = (unsigned)(qg >> 32);
  a[2] = (unsigned)qh;
  a[3] = (unsigned)(qh >> 32);
}

// The shared planes of a histogram tile of `cells` cells from `base`:
// g lo, g hi, h lo, h hi, count, or (kAcc) g, h, count in g_lo, h_lo and
// cnt (g_hi and h_hi are then not used).
template <bool kAcc>
struct Planes {
  unsigned *g_lo, *g_hi, *h_lo, *h_hi, *cnt;
  static constexpr int kCount = kAcc ? 3 : 5;
  __device__ __forceinline__ Planes(unsigned* base, int cells) {
    g_lo = base;
    g_hi = base + cells;
    h_lo = base + (kAcc ? 1 : 2) * cells;
    h_hi = base + 3 * cells;
    cnt = base + (kAcc ? 2 : 4) * cells;
  }
  // the adds of one row into the cells k[0..3] (-1: none): the low (kAcc:
  // the only) adds and the counts first, then the high adds that wait on
  // the low adds' carries
  __device__ __forceinline__ void add4(const int k[4], const unsigned a[4]) {
    unsigned og[4], oh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k[j] < 0) continue;
      og[j] = atomicAdd(g_lo + k[j], a[0]);
      oh[j] = atomicAdd(h_lo + k[j], a[2]);
      atomicAdd(cnt + k[j], 1u);
    }
    if (kAcc) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k[j] < 0) continue;
      atomicAdd(g_hi + k[j], a[1] + carry_of(og[j], a[0]));
      atomicAdd(h_hi + k[j], a[3] + carry_of(oh[j], a[2]));
    }
  }
  // cell k's block sums into the i64 scratch cell dst (kAcc: the int32
  // sums sign-extended)
  __device__ __forceinline__ void flush(int k,
                                        unsigned long long* dst) const {
    if (kAcc) {
      atomicAdd(dst + 0, (unsigned long long)(long long)(int)g_lo[k]);
      atomicAdd(dst + 1, (unsigned long long)(long long)(int)h_lo[k]);
    } else {
      atomicAdd(dst + 0, ((unsigned long long)g_hi[k] << 32) | g_lo[k]);
      atomicAdd(dst + 1, ((unsigned long long)h_hi[k] << 32) | h_lo[k]);
    }
    atomicAdd(dst + 2, (unsigned long long)cnt[k]);
  }
};

// A finished sum in real units: the fixed-point sum over its scale in
// double, rounded to f32; (kAcc) the integer sum as f32 times its scale
// in f32 (unpack_hist_packed's order).
template <bool kAcc>
__device__ __forceinline__ float finish_sum(long long sum, float scale) {
  if (kAcc) return __fmul_rn(__ll2float_rn(sum), scale);
  return (float)((double)sum / (double)scale);
}

// The blocks of a launch whose blocks stride over `steps` steps of
// `step_rows` rows: `blocks`, or (kAcc) more where one would walk more
// than kAccMaxRows rows.
template <bool kAcc>
long long acc_blocks(long long blocks, long long steps, int step_rows) {
  if (!kAcc) return blocks;
  const long long per_block = kAccMaxRows / step_rows;
  const long long need = (steps + per_block - 1) / per_block;
  return blocks > need ? blocks : need;
}

// K6 (kRouted false) and K7 (true).  One launch covers the rows of
// block_list[:n_blocks] x the feature tile blockIdx.y x the target tile
// blockIdx.z, and writes out [n_targets, F, B, 3] f32.  acc
// [n_targets, F * B, 3] i64 and arrivals [tiles] u32 are the wrapper's
// scratch, zero on entry and left zero: each block adds its tile's cells
// into acc, and the last block of a tile to arrive converts the tile into
// out and zeroes it again.
//
// A block step looks at kFrontierThreads rows of one listed block, one a
// thread: the row's route and slot, from the leaf tables.  Each warp
// queues its rows that match a slot in its own 64 entries of shared
// memory (a ballot and its prefix), and whenever its queue holds 32 rows,
// adds their features, a row a lane.  So the adds run with full warps
// however sparse the matches are (half the listed rows at the HIGGS
// round's K6), and no warp waits for another; the order of the adds moves
// no bit.  kPacked4: two columns a byte (unpack_bin); kAcc: the int32
// packed-accumulator stream in place of w8 (row_adds, Planes).
template <bool kRouted, bool kPacked4, bool kAcc>
__global__ void __launch_bounds__(kFrontierThreads, kFrontierBlocksPerSm)
frontier_hist_kernel(const uint8_t* __restrict__ bins,
                     const uint16_t* __restrict__ w8, int* leaf_id,
                     long long npad, int num_features, int num_bins,
                     int tile_features, int tile_targets,
                     const int* __restrict__ block_list, long long n_blocks,
                     int block_rows, const float* __restrict__ scales,
                     unsigned long long* __restrict__ acc,
                     unsigned int* __restrict__ arrivals,
                     float* __restrict__ out,
                     const __grid_constant__ FrontierParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int s0 = blockIdx.z * tile_targets;
  const int ns = min(tile_targets, p.n_targets - s0);
  const int slot_cells = nf * num_bins;
  const int cells = ns * slot_cells;
  const int n_ids = p.n_ids;
  short* s_slot = reinterpret_cast<short*>(smem_raw);
  short* s_route = s_slot + n_ids;
  unsigned char* at = smem_raw + frontier_table_bytes(n_ids);
  int* s_routes = reinterpret_cast<int*>(at);
  at += frontier_route_bytes(p.n_routes);
  const unsigned lane = threadIdx.x & 31u;
  // this warp's queue: 64 (row, slot) entries
  int* q_row = reinterpret_cast<int*>(at) + 2 * (threadIdx.x - lane);
  short* q_slot = reinterpret_cast<short*>(
      reinterpret_cast<int*>(at) + 2 * kFrontierThreads)
      + 2 * (threadIdx.x - lane);
  Planes<kAcc> pl(reinterpret_cast<unsigned*>(at + kFrontierQueueBytes),
                  cells);
  for (int k = threadIdx.x; k < pl.kCount * cells; k += blockDim.x)
    pl.g_lo[k] = 0u;
  for (int k = threadIdx.x; k < n_ids; k += blockDim.x) {
    s_slot[k] = -1;
    s_route[k] = -1;
  }
  if (kRouted) {
    for (int k = threadIdx.x; k < p.n_routes * kRouteWords; k += blockDim.x)
      s_routes[k] = p.routes[k];
  }
  __syncthreads();
  // the host made the ids distinct and below n_ids, so no two writes meet
  for (int k = threadIdx.x; k < ns; k += blockDim.x) {
    const int t = p.targets[s0 + k];
    if (t >= 0) s_slot[t] = (short)k;
  }
  if (kRouted) {
    for (int k = threadIdx.x; k < p.n_routes; k += blockDim.x) {
      const int leaf = p.routes[k * kRouteWords];
      if (leaf >= 0) s_route[leaf] = (short)k;
    }
  }
  __syncthreads();

  const double scale_g = (double)scales[0];
  const double scale_h = (double)scales[1];
  // the tile's first byte row (packed: f0 is even)
  const uint8_t* tile = bins + (long long)(kPacked4 ? f0 >> 1 : f0) * npad;
  // adds queued row q's features into the shared histogram; four features
  // at a time: their bins loaded together, their low adds issued before
  // the high adds that wait on them
  auto add_row = [&](int q) {
    const long long row = q_row[q];
    unsigned a[4];
    row_adds<kAcc>(w8, npad, row, scale_g, scale_h, a);
    const uint8_t* brow = tile + row;
    const int base = q_slot[q] * slot_cells;
    for (int f = 0; f < nf; f += 4) {
      int k[4], nb[4];
      load_bins4<kPacked4>(brow, npad, f, nf, num_bins, nb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the TPU one-hot drops bins >= num_bins too
        k[j] = nb[j] < num_bins ? base + (f + j) * num_bins + nb[j] : -1;
      }
      pl.add4(k, a);
    }
  };

  const bool writer = blockIdx.y == 0 && blockIdx.z == 0;
  int queued = 0;   // the same in every lane of the warp
  const int steps_per_block = (block_rows + kFrontierThreads - 1)
                              / kFrontierThreads;
  const long long n_steps = n_blocks * steps_per_block;
  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long pos = c / steps_per_block;
    const int off = (int)(c - pos * steps_per_block) * kFrontierThreads
                    + (int)threadIdx.x;
    const long long row = (long long)block_list[pos] * block_rows + off;
    int slot = -1;
    // a row past the block's end, or of a block outside the layout,
    // matches nothing
    if (off < block_rows && row >= 0 && row < npad) {
      int lid = leaf_id[row];
      if (kRouted && (unsigned)lid < (unsigned)n_ids && s_route[lid] >= 0) {
        const RouteDesc& desc = *reinterpret_cast<const RouteDesc*>(
            s_routes + s_route[lid] * kRouteWords);
        const int moved = routed_leaf(
            desc, route_bin<kPacked4>(bins + (long long)desc.w[2] * npad,
                                      desc, row), lid);
        // idempotent (a moved row matches no route), so a tile that
        // reads an id tile (0, 0) already rewrote computes the same id
        if (moved != lid && writer) leaf_id[row] = moved;
        lid = moved;
      }
      // member 0: a pad row
      if ((unsigned)lid < (unsigned)n_ids && is_member<kAcc>(w8, npad, row))
        slot = s_slot[lid];
    }
    const unsigned match = __ballot_sync(0xffffffffu, slot >= 0);
    if (slot >= 0) {
      // fewer than 32 rows wait at a step's start, so 64 entries hold
      // the step's matches too
      const int q = queued + __popc(match & ((1u << lane) - 1u));
      q_row[q] = (int)row;
      q_slot[q] = (short)slot;
    }
    queued += __popc(match);
    __syncwarp();
    if (queued >= 32) {
      add_row(lane);
      __syncwarp();
      queued -= 32;
      if ((int)lane < queued) {
        q_row[lane] = q_row[32 + lane];
        q_slot[lane] = q_slot[32 + lane];
      }
      __syncwarp();
    }
  }
  if ((int)lane < queued) add_row(lane);
  __syncthreads();

  const long long cells_all = (long long)num_features * num_bins;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    if (pl.cnt[k] == 0u) continue;
    const int s = k / slot_cells;
    const int fb = k - s * slot_cells;
    pl.flush(k, acc + 3ll * ((s0 + s) * cells_all + (long long)f0 * num_bins
                             + fb));
  }
  // the last block of the tile to arrive sees every block's adds
  __threadfence();
  __syncthreads();
  const unsigned tile_id = blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + tile_id, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four cells a thread at a time, their loads in flight together; each
  // sum in real units (finish_sum), then the cells zeroed
  for (int k0 = threadIdx.x; k0 < cells; k0 += 4 * blockDim.x) {
    long long cell[4], a[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * blockDim.x;
      cell[j] = -1;
      if (k >= cells) continue;
      const int s = k / slot_cells;
      cell[j] = (s0 + s) * cells_all + (long long)f0 * num_bins
                + (k - s * slot_cells);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        a[j][i] = (long long)__ldcg(acc + 3 * cell[j] + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cell[j] < 0) continue;
      out[3 * cell[j] + 0] = finish_sum<kAcc>(a[j][0], scales[0]);
      out[3 * cell[j] + 1] = finish_sum<kAcc>(a[j][1], scales[1]);
      out[3 * cell[j] + 2] = (float)a[j][2];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[3 * cell[j] + i] = 0ull;
    }
  }
  if (threadIdx.x == 0) arrivals[tile_id] = 0u;
}

// K1 (kRouted false) and K3 (true).  One launch covers the rows
// [row_lo, row_hi) x the feature tile blockIdx.y, and writes out [F, B, 3]
// f32.  acc [F * B, 3] i64 and arrivals [tiles] u32 are the wrapper's
// scratch, zero on entry and left zero: each block adds its tile's cells
// into acc, and the last block of a tile to arrive converts the tile into
// out and zeroes it again.
//
// Shared memory: the warps' row queues, then five u32 planes (g lo, g hi,
// h lo, h hi, count) of the tile's nf x num_bins cells, feature-major
// (kAcc: three, Planes).  kPacked4: two columns a byte (unpack_bin); kAcc:
// the int32 packed-accumulator stream in place of w8.
template <bool kRouted, bool kPacked4, bool kAcc>
__device__ __forceinline__ void
segment_window(const uint8_t* __restrict__ bins,
               const uint16_t* __restrict__ w8, int* leaf_id,
               long long npad, int num_features, int num_bins,
               int tile_features, long long row_lo, long long row_hi,
               int target, const float* __restrict__ scales,
               const RouteDesc& route, unsigned long long* __restrict__ acc,
               unsigned int* __restrict__ arrivals,
               float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int cells = nf * num_bins;
  const unsigned lane = threadIdx.x & 31u;
  // this warp's queue: 64 rows
  int* q_row = reinterpret_cast<int*>(smem_raw) + 2 * (threadIdx.x - lane);
  Planes<kAcc> pl(reinterpret_cast<unsigned*>(smem_raw + kSegQueueBytes),
                  cells);
  for (int k = threadIdx.x; k < pl.kCount * cells; k += blockDim.x)
    pl.g_lo[k] = 0u;
  __syncthreads();

  const double scale_g = (double)scales[0];
  const double scale_h = (double)scales[1];
  // the tile's first byte row (packed: f0 is even)
  const uint8_t* tile = bins + (long long)(kPacked4 ? f0 >> 1 : f0) * npad;
  // adds the features of queued rows [0, n), a row a lane, so the lanes
  // of a warp add one feature at a time; four features at a time, their
  // low adds issued before the high adds that wait on them, while the
  // next four features' bins load
  auto add_rows = [&](int n) {
    if ((int)lane >= n) return;
    const long long row = q_row[lane];
    unsigned a[4];
    row_adds<kAcc>(w8, npad, row, scale_g, scale_h, a);
    const uint8_t* brow = tile + row;
    // past the tile, a bin of num_bins: no cell
    int nb[4];
    load_bins4<kPacked4>(brow, npad, 0, nf, num_bins, nb);
    for (int f = 0; f < nf; f += 4) {
      int k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the TPU one-hot drops bins >= num_bins too
        k[j] = nb[j] < num_bins ? (f + j) * num_bins + nb[j] : -1;
      }
      load_bins4<kPacked4>(brow, npad, f + 4, nf, num_bins, nb);
      pl.add4(k, a);
    }
  };

  const uint8_t* frow = bins + (long long)route.w[2] * npad;
  const bool writer = blockIdx.y == 0;
  int queued = 0;   // the same in every lane of the warp
  const long long n_steps = (row_hi - row_lo + kSegThreads - 1) / kSegThreads;
  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long row = row_lo + c * kSegThreads + threadIdx.x;
    bool match = false;
    if (row < row_hi) {
      int lid = leaf_id[row];
      if (kRouted) {
        const int moved = routed_leaf(route,
                                      route_bin<kPacked4>(frow, route, row),
                                      lid);
        // the route is idempotent (moved rows stop matching route.w[0]),
        // so a tile reading an id tile 0 already rewrote agrees
        if (moved != lid && writer) leaf_id[row] = moved;
        lid = moved;
      }
      // member is 0 (pad rows) or 1: the port has no bagging weights
      match = lid == target && is_member<kAcc>(w8, npad, row);
    }
    const unsigned m = __ballot_sync(0xffffffffu, match);
    // fewer than 32 rows wait at a step's start, so 64 entries hold the
    // step's matches too
    if (match) q_row[queued + __popc(m & ((1u << lane) - 1u))] = (int)row;
    queued += __popc(m);
    __syncwarp();
    if (queued >= 32) {
      add_rows(32);
      __syncwarp();
      queued -= 32;
      if ((int)lane < queued) q_row[lane] = q_row[32 + lane];
      __syncwarp();
    }
  }
  add_rows(queued);
  __syncthreads();

  // the block's non-empty cells into acc; the tile's cells are contiguous
  // there and in out
  const long long tile_base = (long long)f0 * num_bins;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    if (pl.cnt[k] == 0u) continue;
    pl.flush(k, acc + 3 * (tile_base + k));
  }
  // the last block of the tile to arrive sees every block's adds
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four cells a thread at a time, their loads in flight together; each
  // sum in real units (finish_sum), then the cells zeroed
  for (int k0 = threadIdx.x; k0 < cells; k0 += 4 * blockDim.x) {
    long long a[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k >= cells) continue;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        a[j][i] = (long long)__ldcg(acc + 3 * (tile_base + k) + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k >= cells) continue;
      const long long cell = tile_base + k;
      out[3 * cell + 0] = finish_sum<kAcc>(a[j][0], scales[0]);
      out[3 * cell + 1] = finish_sum<kAcc>(a[j][1], scales[1]);
      out[3 * cell + 2] = (float)a[j][2];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[3 * cell + i] = 0ull;
    }
  }
  if (threadIdx.x == 0) arrivals[blockIdx.y] = 0u;
}

// K1's and K3's kernels: the window, target and route as launch
// parameters (segment_window_kernel), or read by every block at entry from
// a step block in device memory (segment_step_kernel), so that a split's
// step needs no value from the host (read_step).  The same body, so the
// two give the same bits on the same window and route.
template <bool kRouted, bool kPacked4, bool kAcc>
__global__ void __launch_bounds__(kSegThreads, 1)
segment_window_kernel(const uint8_t* __restrict__ bins,
                      const uint16_t* __restrict__ w8, int* leaf_id,
                      long long npad, int num_features, int num_bins,
                      int tile_features, long long row_lo, long long row_hi,
                      int target, const float* __restrict__ scales,
                      RouteDesc route, unsigned long long* __restrict__ acc,
                      unsigned int* __restrict__ arrivals,
                      float* __restrict__ out) {
  segment_window<kRouted, kPacked4, kAcc>(bins, w8, leaf_id, npad,
                                          num_features, num_bins,
                                          tile_features, row_lo, row_hi,
                                          target, scales, route, acc,
                                          arrivals, out);
}

template <bool kRouted, bool kPacked4, bool kAcc>
__global__ void __launch_bounds__(kSegThreads, 1)
segment_step_kernel(const uint8_t* __restrict__ bins,
                    const uint16_t* __restrict__ w8, int* leaf_id,
                    long long npad, int num_features, int num_bins,
                    int tile_features, int block_rows,
                    const int* __restrict__ step,
                    const float* __restrict__ scales,
                    unsigned long long* __restrict__ acc,
                    unsigned int* __restrict__ arrivals,
                    float* __restrict__ out) {
  // packed, the logical columns are twice the byte rows
  const StepArgs a = read_step(step, npad, block_rows,
                               kPacked4 ? num_features / 2 : num_features);
  segment_window<kRouted, kPacked4, kAcc>(bins, w8, leaf_id, npad,
                                          num_features, num_bins,
                                          tile_features, a.row_lo, a.row_hi,
                                          a.target, scales, a.route, acc,
                                          arrivals, out);
}

// K5.  One launch covers every row x the feature tile blockIdx.y x the set
// tile blockIdx.z, and writes out [C, F, B, 3] f32.  w8 is [8 C, npad] bf16
// bits (set c's g_hi, g_lo, h_hi, h_lo, member, 0, 0, 0 at rows 8c..8c+7),
// scales [C, 2]; acc [C, F * B, 3] i64 and arrivals [tiles] u32 are the
// wrapper's scratch, zero on entry and left zero, as K1's.
//
// Shared memory: five u32 planes (g lo, g hi, h lo, h hi, count) of the
// tile's ns x nf x num_bins cells, set-major then feature-major.  A lane
// adds its own row's features into each set of the tile in turn, with
// K1's add loop (segment_window_kernel: four features at a time, their
// low adds before the high adds that wait on them, while the next four
// features' bins load); a row's bins come from device memory for the
// first set and from the cache for the others.  kPacked4: two columns a
// byte (unpack_bin); kAcc: one set, the int32 packed-accumulator stream
// [2, npad] in place of w8, and its quantizer's scales [2] (Planes).
template <bool kPacked4, bool kAcc>
__global__ void __launch_bounds__(kSegThreads, 1)
all_hist_kernel(const uint8_t* __restrict__ bins,
                const uint16_t* __restrict__ w8, long long npad,
                int num_features, int num_bins, int num_sets,
                int tile_features, int tile_sets,
                const float* __restrict__ scales,
                unsigned long long* __restrict__ acc,
                unsigned int* __restrict__ arrivals,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int c0 = blockIdx.z * tile_sets;
  const int ns = min(tile_sets, num_sets - c0);
  const int set_cells = nf * num_bins;
  const int cells = ns * set_cells;
  Planes<kAcc> pl(reinterpret_cast<unsigned*>(smem_raw), cells);
  for (int k = threadIdx.x; k < pl.kCount * cells; k += blockDim.x)
    pl.g_lo[k] = 0u;
  __syncthreads();

  // the tile's first byte row (packed: f0 is even)
  const uint8_t* tile = bins + (long long)(kPacked4 ? f0 >> 1 : f0) * npad;
  const long long n_steps = (npad + kSegThreads - 1) / kSegThreads;
  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long row = c * kSegThreads + threadIdx.x;
    if (row >= npad) break;
    const uint8_t* brow = tile + row;
    for (int s = 0; s < ns; ++s) {
      const uint16_t* w = w8 + (long long)(c0 + s) * 8 * npad;
      // member is 0 (pad rows) or 1: the port has no bagging weights
      if (!is_member<kAcc>(w, npad, row)) continue;
      unsigned a[4];
      row_adds<kAcc>(w, npad, row, (double)scales[2 * (c0 + s)],
                     (double)scales[2 * (c0 + s) + 1], a);
      const int base = s * set_cells;
      // past the tile, a bin of num_bins: no cell
      int nb[4];
      load_bins4<kPacked4>(brow, npad, 0, nf, num_bins, nb);
      for (int f = 0; f < nf; f += 4) {
        int k[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the TPU one-hot drops bins >= num_bins too
          k[j] = nb[j] < num_bins ? base + (f + j) * num_bins + nb[j] : -1;
        }
        load_bins4<kPacked4>(brow, npad, f + 4, nf, num_bins, nb);
        pl.add4(k, a);
      }
    }
  }
  __syncthreads();

  // cell k of the tile: set c0 + k / set_cells, (feature, bin) f0 * B +
  // k % set_cells of that set's [F * B] cells in acc and out
  const long long cells_all = (long long)num_features * num_bins;
  auto cell_of = [&](int k) {
    const int s = k / set_cells;
    return (c0 + s) * cells_all + (long long)f0 * num_bins
           + (k - s * set_cells);
  };
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    if (pl.cnt[k] == 0u) continue;
    pl.flush(k, acc + 3 * cell_of(k));
  }
  // the last block of the tile to arrive sees every block's adds
  __threadfence();
  __syncthreads();
  const unsigned tile_id = blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + tile_id, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four cells a thread at a time, their loads in flight together; each
  // sum in real units at its set's scale (finish_sum), then the cells
  // zeroed
  for (int k0 = threadIdx.x; k0 < cells; k0 += 4 * blockDim.x) {
    long long cell[4], a[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * blockDim.x;
      cell[j] = -1;
      if (k >= cells) continue;
      cell[j] = cell_of(k);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        a[j][i] = (long long)__ldcg(acc + 3 * cell[j] + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cell[j] < 0) continue;
      const float* sc = scales + 2 * (cell[j] / cells_all);
      out[3 * cell[j] + 0] = finish_sum<kAcc>(a[j][0], sc[0]);
      out[3 * cell[j] + 1] = finish_sum<kAcc>(a[j][1], sc[1]);
      out[3 * cell[j] + 2] = (float)a[j][2];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[3 * cell[j] + i] = 0ull;
    }
  }
  if (threadIdx.x == 0) arrivals[tile_id] = 0u;
}

// K2.  One launch covers the rows [row_lo, row_hi) of one window.  With
// kTable, each block first turns the route into s_right, a table of the
// 256 bin values (bit g: a row of the routed leaf whose bin is g goes
// right), one value a thread and one ballot a warp; a row then costs a
// table read and a compare with the routed leaf.  Each thread routes kRows
// consecutive rows of [vec_lo, vec_hi) a step: their bins in one load of
// kRows bytes and their ids in 16-byte loads, all in flight together, and
// writes back only the 16-byte groups in which an id changed.  The host
// picks vec_lo and vec_hi so that both arrays are aligned there and the
// span is a whole number of steps; the rows outside it (fewer than
// 2 kRows, or the whole window where the two arrays cannot be aligned
// together) are routed one a thread.  kPacked4: frow holds two columns a
// byte, and a row's bin is the nibble of the route's column (route_bin);
// the table is over the 256 byte values, each with its nibble picked.
template <int kRows, bool kTable, bool kPacked4>
__device__ __forceinline__ void
route_window(const uint8_t* __restrict__ frow, int* __restrict__ leaf_id,
             long long row_lo, long long row_hi, long long vec_lo,
             long long vec_hi, const RouteDesc& route) {
  static_assert(kRouteThreads == 256, "one route-table entry a thread");
  static_assert(kRows == 1 || kRows == 4 || kRows == 16, "rows a thread");
  __shared__ unsigned s_right[8];
  if (kTable) {
    const unsigned word = __ballot_sync(
        0xffffffffu,
        goes_right(route, unpack_bin<kPacked4>((int)threadIdx.x,
                                               route.w[3])) == 1);
    if ((threadIdx.x & 31u) == 0) s_right[threadIdx.x >> 5] = word;
    __syncthreads();
  }
  const int leaf = route.w[0], new_leaf = route.w[1];
  // g: the row's byte
  auto route_row = [&](int g, int lid) {
    if (!kTable)
      return routed_leaf(route, unpack_bin<kPacked4>(g, route.w[3]), lid);
    return lid == leaf && ((s_right[g >> 5] >> (g & 31)) & 1u) ? new_leaf
                                                              : lid;
  };
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long steps = (vec_hi - vec_lo) / kRows;
  for (long long q = first; q < steps; q += stride) {
    const long long r0 = vec_lo + q * kRows;
    if constexpr (kRows == 1) {
      const int lid = leaf_id[r0];
      const int moved = route_row(frow[r0], lid);
      if (moved != lid) leaf_id[r0] = moved;
    } else {
      unsigned g[kRows / 4];
      if constexpr (kRows == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(frow + r0);
        g[0] = v.x;
        g[1] = v.y;
        g[2] = v.z;
        g[3] = v.w;
      } else {
        g[0] = *reinterpret_cast<const unsigned*>(frow + r0);
      }
      int4 ids[kRows / 4];
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j)
        ids[j] = reinterpret_cast<const int4*>(leaf_id + r0)[j];
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) {
        // row r0 + 4j + k has byte k of word j (little-endian)
        const int4 n = make_int4(route_row(g[j] & 255u, ids[j].x),
                                 route_row((g[j] >> 8) & 255u, ids[j].y),
                                 route_row((g[j] >> 16) & 255u, ids[j].z),
                                 route_row(g[j] >> 24, ids[j].w));
        if (n.x != ids[j].x || n.y != ids[j].y || n.z != ids[j].z
            || n.w != ids[j].w)
          reinterpret_cast<int4*>(leaf_id + r0)[j] = n;
      }
    }
  }
  const long long head = vec_lo - row_lo;
  const long long edge = head + (row_hi - vec_hi);
  for (long long e = first; e < edge; e += stride) {
    const long long i = e < head ? row_lo + e : vec_hi + (e - head);
    const int lid = leaf_id[i];
    const int moved = route_row(frow[i], lid);
    if (moved != lid) leaf_id[i] = moved;
  }
}

// The aligned span [vec_lo, vec_hi) of K2's window for kRows rows a step:
// from the first row at or after row_lo where frow is kRows-byte aligned
// and leaf_id 16-byte aligned (kRows >= 4), a whole number of steps.
// Where the two cannot be aligned together the span is empty.
template <int kRows>
__host__ __device__ inline void route_span(const uint8_t* frow,
                                           const int* leaf_id,
                                           long long row_lo, long long row_hi,
                                           long long* vec_lo,
                                           long long* vec_hi) {
  *vec_lo = *vec_hi = row_hi;
  long long lo = row_lo;
  if (kRows > 1) {
    const long long fa = (long long)(reinterpret_cast<uintptr_t>(frow + lo)
                                     % kRows);
    lo += (kRows - fa) % kRows;
    if (reinterpret_cast<uintptr_t>(leaf_id + lo) % 16 != 0) return;
  }
  if (lo >= row_hi) return;
  *vec_lo = lo;
  *vec_hi = lo + (row_hi - lo) / kRows * kRows;
}

// K2's kernels: the window and route as launch parameters, the aligned
// span picked by the host (route_window_kernel), or read by every block at
// entry from a split's step block in device memory, the span computed from
// the row_lo read there (route_step_kernel).
template <int kRows, bool kTable, bool kPacked4>
__global__ void __launch_bounds__(kRouteThreads)
route_window_kernel(const uint8_t* __restrict__ frow,
                    int* __restrict__ leaf_id, long long row_lo,
                    long long row_hi, long long vec_lo, long long vec_hi,
                    RouteDesc route) {
  route_window<kRows, kTable, kPacked4>(frow, leaf_id, row_lo, row_hi,
                                        vec_lo, vec_hi, route);
}

// bin_rows: the bin matrix's byte rows (the columns, or half the logical
// columns packed)
template <int kRows, bool kTable, bool kPacked4>
__global__ void __launch_bounds__(kRouteThreads)
route_step_kernel(const uint8_t* __restrict__ bins, int* __restrict__ leaf_id,
                  long long npad, int bin_rows, int block_rows,
                  const int* __restrict__ step) {
  const StepArgs a = read_step(step, npad, block_rows, bin_rows);
  const uint8_t* frow = bins + (long long)a.route.w[2] * npad;
  long long vec_lo, vec_hi;
  route_span<kRows>(frow, leaf_id, a.row_lo, a.row_hi, &vec_lo, &vec_hi);
  route_window<kRows, kTable, kPacked4>(frow, leaf_id, a.row_lo, a.row_hi,
                                        vec_lo, vec_hi, a.route);
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

// Dynamic shared memory a K6/K7 block may take: an equal share of the
// SM's (less the 1 KB the card reserves for each block), at most the
// block opt-in limit, less the kernel's static shared memory.
int frontier_smem_budget() {
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
    int b = per_sm / kFrontierBlocksPerSm - reserved;
    if (b > optin) b = optin;
    budget = b - kFrontierStaticSmem;
  }
  return budget;
}

// Opts the kernel in to the budget of dynamic shared memory (once), then
// launches one wave: kFrontierBlocksPerSm blocks an SM (the budget and
// the launch bounds let that many in), split over the tiles (fewer when
// the rows are few), so each block flushes its shared histogram once.
// Makes no call that a CUDA graph's capture refuses.  Returns a CUDA
// error.
template <bool kRouted, bool kPacked4, bool kAcc>
int launch_frontier(int tiles_y, int tiles_z, size_t smem, cudaStream_t s,
                    const uint8_t* bins, const uint16_t* w8, int* leaf_id,
                    long long npad, int num_features, int num_bins, int ft,
                    int tt, const int* block_list, long long n_blocks,
                    int block_rows, const float* scales, long long* acc,
                    const FrontierParams& p, float* out) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        frontier_hist_kernel<kRouted, kPacked4, kAcc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, frontier_smem_budget());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const long long tiles = (long long)tiles_y * tiles_z;
  const long long steps = n_blocks * div_up(block_rows, kFrontierThreads);
  long long bx = steps;
  const long long wave = (long long)kFrontierBlocksPerSm * sm_count();
  const long long cap = wave / tiles > 0 ? wave / tiles : 1;
  if (bx > cap) bx = cap;
  bx = acc_blocks<kAcc>(bx, steps, kFrontierThreads);
  if (bx < 1) bx = 1;   // no rows: one block a tile writes the zeros
  // the tiles' arrival counters follow the histogram cells in the scratch
  const long long cells3 = 3ll * p.n_targets * num_features * num_bins;
  dim3 grid((unsigned)bx, (unsigned)tiles_y, (unsigned)tiles_z);
  frontier_hist_kernel<kRouted, kPacked4, kAcc><<<grid, kFrontierThreads,
                                                   smem, s>>>(
      bins, w8, leaf_id, npad, num_features, num_bins, ft, tt, block_list,
      n_blocks, block_rows, scales,
      reinterpret_cast<unsigned long long*>(acc),
      reinterpret_cast<unsigned int*>(acc + cells3), out, p);
  return 0;
}

// Opts K1's or K3's kernel in to the shared-memory budget (once), then
// launches, for each feature tile, one block per kSegMinRows rows of the
// window, at most one wave over the tiles (one block a tile when the
// window is empty: it writes the zeros).  Makes no call that a CUDA
// graph's capture refuses.  kAcc launches more blocks where a block
// would walk more than kAccMaxRows rows.  Returns a CUDA error.
template <bool kRouted, bool kPacked4, bool kAcc>
int launch_segment(int tiles, int ft, size_t smem, cudaStream_t s,
                   const uint8_t* bins, const uint16_t* w8,
                   int* leaf_id, long long npad, int num_features,
                   int num_bins, long long row_lo, long long row_hi,
                   int target, const float* scales, const RouteDesc& route,
                   long long* scratch, float* out) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_window_kernel<kRouted, kPacked4, kAcc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, frontier_smem_budget());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  long long bx = div_up(row_hi - row_lo, kSegMinRows);
  const long long cap = sm_count() / tiles > 0 ? sm_count() / tiles : 1;
  if (bx > cap) bx = cap;
  bx = acc_blocks<kAcc>(bx, div_up(row_hi - row_lo, kSegThreads),
                        kSegThreads);
  if (bx < 1) bx = 1;
  // the tiles' arrival counters follow the histogram cells in the scratch
  const long long cells3 = 3ll * num_features * num_bins;
  dim3 grid((unsigned)bx, (unsigned)tiles);
  segment_window_kernel<kRouted, kPacked4, kAcc><<<grid, kSegThreads, smem,
                                                   s>>>(
      bins, w8, leaf_id, npad, num_features, num_bins, ft, row_lo, row_hi,
      target, scales, route,
      reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<unsigned int*>(scratch + cells3), out);
  return 0;
}

// Launches K2: the threads the window's steps and edge rows need, at most
// one wave (the blocks an SM that fit, once asked, on every SM), and one
// block for an empty window, so a call is always one launch.  Makes no
// call that a CUDA graph's capture refuses.  Returns a CUDA error.
template <int kRows, bool kTable, bool kPacked4>
int launch_route(const uint8_t* frow, int* leaf_id, long long row_lo,
                 long long row_hi, const RouteDesc& route, cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_window_kernel<kRows, kTable, kPacked4>,
        kRouteThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  long long vec_lo, vec_hi;
  route_span<kRows>(frow, leaf_id, row_lo, row_hi, &vec_lo, &vec_hi);
  const long long steps = (vec_hi - vec_lo) / kRows;
  const long long edge = (vec_lo - row_lo) + (row_hi - vec_hi);
  long long blocks = div_up(steps > edge ? steps : edge, kRouteThreads);
  const long long wave = (long long)per_sm * sm_count();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  route_window_kernel<kRows, kTable, kPacked4><<<(unsigned)blocks,
                                                 kRouteThreads, 0, s>>>(
      frow, leaf_id, row_lo, row_hi, vec_lo, vec_hi, route);
  return 0;
}

// Launches K1's or K3's step kernel: the grid does not depend on the
// window, which only the device knows, so it is the wave cap of
// launch_segment (sm_count() / tiles blocks a tile) at every window.  The
// blocks stride over the window they read; one with no rows flushes
// nothing and still arrives at its tile's counter, so an empty window
// writes zeros.  kAcc: at least the blocks the whole layout would need
// (acc_blocks).  Makes no call that a CUDA graph's capture refuses.
template <bool kRouted, bool kPacked4, bool kAcc>
int launch_segment_step(int tiles, int ft, size_t smem, cudaStream_t s,
                        const uint8_t* bins, const uint16_t* w8,
                        int* leaf_id, long long npad, int num_features,
                        int num_bins, int block_rows, const int* step,
                        const float* scales, long long* scratch, float* out) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_step_kernel<kRouted, kPacked4, kAcc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, frontier_smem_budget());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const long long cap = acc_blocks<kAcc>(
      sm_count() / tiles > 0 ? sm_count() / tiles : 1,
      div_up(npad, kSegThreads), kSegThreads);
  const long long cells3 = 3ll * num_features * num_bins;
  dim3 grid((unsigned)cap, (unsigned)tiles);
  segment_step_kernel<kRouted, kPacked4, kAcc><<<grid, kSegThreads, smem,
                                                 s>>>(
      bins, w8, leaf_id, npad, num_features, num_bins, ft, block_rows, step,
      scales, reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<unsigned int*>(scratch + cells3), out);
  return 0;
}

// Launches K2's step kernel over the occupancy wave (launch_route's cap),
// whatever the window.
template <int kRows, bool kTable, bool kPacked4>
int launch_route_step(const uint8_t* bins, int* leaf_id, long long npad,
                      int bin_rows, int block_rows, const int* step,
                      cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_step_kernel<kRows, kTable, kPacked4>, kRouteThreads,
        0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  const long long wave = (long long)per_sm * sm_count();
  route_step_kernel<kRows, kTable, kPacked4><<<(unsigned)wave, kRouteThreads,
                                               0, s>>>(
      bins, leaf_id, npad, bin_rows, block_rows, step);
  return 0;
}

// Features a tile of `units` feature units of `per_unit` bytes each within
// `budget` bytes: as many as fit, spread evenly over the fewest tiles, in
// features (unit features a unit).  0 when not even one unit fits.
long long even_tile(long long units, long long per_unit, long long budget,
                    int unit) {
  if (units < 1 || per_unit < 1 || budget < per_unit) return 0;
  long long most = budget / per_unit;
  if (most > units) most = units;
  return div_up(units, div_up(units, most)) * unit;
}

// The feature unit of a tiling: a pair of columns (one byte row) packed, so
// that a tile starts on a byte; one column unpacked.
int feature_unit(int packed4) { return packed4 != 0 ? 2 : 1; }

// Calls fn(r, p, a) with std::true_type / std::false_type for the three
// runtime flags, so fn instantiates the kernel whose template arguments
// match them; returns fn's result.
template <typename Fn>
int dispatch(bool r, bool p, bool a, Fn&& fn) {
  using T = std::true_type;
  using F = std::false_type;
  auto rest = [&](auto R) {
    auto last = [&](auto P) { return a ? fn(R, P, T{}) : fn(R, P, F{}); };
    return p ? last(T{}) : last(F{});
  };
  return r ? rest(T{}) : rest(F{});
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1/K3 tiling: out[0] features a tile, out[1] dynamic shared memory a
// block (bytes): as many features as fit the budget (K6/K7's: one block
// an SM), spread evenly over the fewest tiles; packed4 (two columns a
// byte: num_features are the logical columns, an even count) cuts them
// in pairs; packed_acc takes its 12-byte cells.  Returns 0, or
// cudaErrorInvalidValue when not even one feature (pair) fits.
int lgbt_segment_tiling(int num_features, int num_bins, int packed4,
                        int packed_acc, int* out) {
  const int unit = feature_unit(packed4);
  const long long per_feature = (long long)num_bins
                                * cell_bytes(packed_acc != 0);
  const long long ft = even_tile(
      num_features < 1 || num_bins < 1 ? 0 : div_up(num_features, unit),
      per_feature * unit, frontier_smem_budget() - kSegQueueBytes, unit);
  if (ft == 0) return (int)cudaErrorInvalidValue;
  out[0] = (int)ft;
  out[1] = (int)(kSegQueueBytes + ft * per_feature);
  return 0;
}

// K1 (route == NULL) or K3 (route = host pointer to 19 ints), one kernel
// launch and no other operation on the stream.  bins [F, npad] u8, or
// packed4 != 0 [F / 2, npad] u8 of two columns a byte (F the logical
// columns, even), w8 [8, npad] bf16 bits (fixed_point_scales' scales
// [2]), or packed_acc != 0 the [2, npad] int32 packed-accumulator stream
// (quantize_pack's scales [2]), leaf_id [npad] i32 (updated in place by
// K3 over the window), scales f32 on the device; scratch = the wrapper's
// persistent i64 buffer, all zero, of F*B*3 words plus one u32 a feature
// tile, left all zero; out [F, B, 3] f32.  An empty window writes zeros.
// Returns a CUDA error code (0 on success).
int lgbt_histogram_segment(const uint8_t* bins, const uint16_t* w8,
                           int* leaf_id, long long npad, int num_features,
                           int num_bins, long long row_lo, long long row_hi,
                           int target, const float* scales, const int* route,
                           long long* scratch, float* out, int packed4,
                           int packed_acc, void* stream) {
  // the queue holds a row as an i32
  if (npad > 0x7fffffffll || row_lo < 0 || row_hi > npad
      || (packed4 != 0 && num_features % 2 != 0))
    return (int)cudaErrorInvalidValue;
  int tiling[2];
  const int rc = lgbt_segment_tiling(num_features, num_bins, packed4,
                                     packed_acc, tiling);
  if (rc != 0) return rc;
  const int tiles = (int)div_up(num_features, tiling[0]);
  if (row_hi < row_lo) row_hi = row_lo;
  cudaStream_t s = (cudaStream_t)stream;
  RouteDesc desc = {};
  if (route != nullptr)
    for (int k = 0; k < kRouteWords; ++k) desc.w[k] = route[k];
  const size_t smem = (size_t)tiling[1];
  const int ft = tiling[0];
  const int e = dispatch(
      route != nullptr, packed4 != 0, packed_acc != 0,
      [&](auto R, auto P, auto A) {
        return launch_segment<decltype(R)::value, decltype(P)::value,
                              decltype(A)::value>(
            tiles, ft, smem, s, bins, w8, leaf_id, npad, num_features,
            num_bins, row_lo, row_hi, target, scales, desc, scratch, out);
      });
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K1 (routed == 0) or K3 (routed != 0) with the window, target and route
// read from step, a device pointer to a step block of 22 int32 words
// (read_step: [start_block, n_blocks, target, route[19]]), one kernel
// launch and no other operation on the stream; the host reads none of it.
// The other arguments as lgbt_histogram_segment's; block_rows is the
// window's row block.  Bit for bit lgbt_histogram_segment's output and
// leaf ids on the same window, target and route.  Returns a CUDA error
// code (0 on success).
int lgbt_histogram_segment_step(const uint8_t* bins, const uint16_t* w8,
                                int* leaf_id, long long npad,
                                int num_features, int num_bins,
                                int block_rows, const int* step, int routed,
                                const float* scales, long long* scratch,
                                float* out, int packed4, int packed_acc,
                                void* stream) {
  if (npad > 0x7fffffffll || block_rows < 1
      || (packed4 != 0 && num_features % 2 != 0))
    return (int)cudaErrorInvalidValue;
  int tiling[2];
  const int rc = lgbt_segment_tiling(num_features, num_bins, packed4,
                                     packed_acc, tiling);
  if (rc != 0) return rc;
  const int tiles = (int)div_up(num_features, tiling[0]);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)tiling[1];
  const int ft = tiling[0];
  const int e = dispatch(
      routed != 0, packed4 != 0, packed_acc != 0,
      [&](auto R, auto P, auto A) {
        return launch_segment_step<decltype(R)::value, decltype(P)::value,
                                   decltype(A)::value>(
            tiles, ft, smem, s, bins, w8, leaf_id, npad, num_features,
            num_bins, block_rows, step, scales, scratch, out);
      });
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K5 tiling: out[0] features a tile, out[1] sets a tile, out[2] dynamic
// shared memory a block (bytes).  One set a block (the sets across
// gridDim.z) and as many of its features as fit the budget (K1's: one
// block an SM), spread evenly over the fewest tiles; in pairs packed4.
// Blocks of several sets read fewer bytes (a row's bins once for all
// their sets) but were slower: each set's adds take a row's bins from the
// cache again (tools/route_candidates.py, PERF.md).  packed_acc takes its
// 12-byte cells.  Returns 0, or cudaErrorInvalidValue when not even one
// feature (pair) of one set fits.
int lgbt_all_tiling(int num_features, int num_bins, int num_sets,
                    int packed4, int packed_acc, int* out) {
  const int unit = feature_unit(packed4);
  const long long per_feature = (long long)num_bins
                                * cell_bytes(packed_acc != 0);
  const long long ft = even_tile(
      num_features < 1 || num_bins < 1 || num_sets < 1
          ? 0 : div_up(num_features, unit),
      per_feature * unit, frontier_smem_budget(), unit);
  if (ft == 0) return (int)cudaErrorInvalidValue;
  out[0] = (int)ft;
  out[1] = 1;
  out[2] = (int)(per_feature * ft);
  return 0;
}

// K5, one kernel launch and no other operation on the stream.  bins [F,
// npad] u8 (packed4: [F / 2, npad], two columns a byte, F even), w8 [8 *
// sets, npad] bf16 bits (pad rows carry member 0) and scales [sets, 2] f32
// on the device, or packed_acc != 0 (sets == 1) the [2, npad] int32
// packed-accumulator stream and quantize_pack's scales [2]; scratch = the
// wrapper's persistent i64 buffer, all zero, of sets*F*B*3 words plus one
// u32 a tile, left all zero; out [sets, F, B, 3] f32.  Returns a CUDA
// error code (0 on success).
int lgbt_histogram_all(const uint8_t* bins, const uint16_t* w8,
                       long long npad, int num_features, int num_bins,
                       int sets, const float* scales, long long* scratch,
                       float* out, int packed4, int packed_acc,
                       void* stream) {
  if ((packed4 != 0 && num_features % 2 != 0)
      || (packed_acc != 0 && sets != 1))
    return (int)cudaErrorInvalidValue;
  int tiling[3];
  const int rc = lgbt_all_tiling(num_features, num_bins, sets, packed4,
                                 packed_acc, tiling);
  if (rc != 0) return rc;
  const int tiles_y = (int)div_up(num_features, tiling[0]);
  const int tiles_z = (int)div_up(sets, tiling[1]);
  const long long tiles = (long long)tiles_y * tiles_z;
  // the tiles' arrival counters follow the histogram cells in the scratch
  const long long cells3 = 3ll * sets * num_features * num_bins;
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* arrivals = reinterpret_cast<unsigned int*>(scratch + cells3);
  return dispatch(
      false, packed4 != 0, packed_acc != 0, [&](auto, auto P, auto A) {
        constexpr bool kP = decltype(P)::value, kA = decltype(A)::value;
        static bool opted_in = false;
        if (!opted_in) {
          const cudaError_t e = cudaFuncSetAttribute(
              all_hist_kernel<kP, kA>,
              cudaFuncAttributeMaxDynamicSharedMemorySize,
              frontier_smem_budget());
          if (e != cudaSuccess) return (int)e;
          opted_in = true;
        }
        // one block per 1,024-row step, at most one wave over the tiles
        // (one block a tile when there are no rows: it writes the zeros)
        long long bx = div_up(npad, kSegMinRows);
        const long long cap = sm_count() / tiles > 0 ? sm_count() / tiles
                                                     : 1;
        if (bx > cap) bx = cap;
        bx = acc_blocks<kA>(bx, div_up(npad, kSegThreads), kSegThreads);
        if (bx < 1) bx = 1;
        dim3 grid((unsigned)bx, (unsigned)tiles_y, (unsigned)tiles_z);
        all_hist_kernel<kP, kA><<<grid, kSegThreads, (size_t)tiling[2],
                                  (cudaStream_t)stream>>>(
            bins, w8, npad, num_features, num_bins, sets, tiling[0],
            tiling[1], scales, acc, arrivals, out);
        return (int)cudaGetLastError();
      });
}

// K6/K7 tiling: out[0] features per tile, out[1] target slots per tile,
// out[2] dynamic shared memory a block (bytes), for leaf tables of n_ids
// entries.  All n_targets slots of as many features as fit the budget,
// spread evenly over the fewest feature tiles; when one feature's slots do
// not fit, one feature a tile and the slots spread evenly over the fewest
// target tiles.  packed4 cuts the features in pairs (a pair where the
// rule says one); packed_acc takes its 12-byte cells.  Returns 0, or
// cudaErrorInvalidValue when not even one slot of one feature (pair) fits
// beside the tables.
int lgbt_frontier_tiling(int num_features, int num_bins, int n_targets,
                         int n_routes, int n_ids, int packed4,
                         int packed_acc, int* out) {
  const int unit = feature_unit(packed4);
  const int cell = cell_bytes(packed_acc != 0);
  const long long slot_bytes = (long long)unit * num_bins * cell;
  // ids that could not fit, checked before the table's size is computed
  if (n_ids < 0 || n_ids > frontier_smem_budget() / 4)
    return (int)cudaErrorInvalidValue;
  const long long fixed = (long long)frontier_table_bytes(n_ids)
                          + frontier_route_bytes(n_routes)
                          + kFrontierQueueBytes;
  const long long budget = frontier_smem_budget() - fixed;
  if (num_features < 1 || n_targets < 1 || n_routes < 0
      || budget < slot_bytes)
    return (int)cudaErrorInvalidValue;
  const long long units = div_up(num_features, unit);
  int ft, tt;
  if ((long long)n_targets * slot_bytes <= budget) {
    tt = n_targets;
    ft = (int)even_tile(units, (long long)n_targets * slot_bytes, budget,
                        unit);
  } else {
    ft = unit;
    const long long most = budget / slot_bytes;
    tt = (int)div_up(n_targets, div_up(n_targets, most));
  }
  out[0] = ft;
  out[1] = tt;
  out[2] = (int)(fixed + (long long)ft * tt * num_bins * cell);
  return 0;
}

// K6 (n_routes == 0) or K7 (n_routes > 0, KT = n_targets = K or 2K), one
// kernel launch and no other operation on the stream.  bins [F, npad] u8
// (packed4: [F / 2, npad], two columns a byte, F even), w8 [8, npad] bf16
// bits (packed_acc: the [2, npad] int32 stream), leaf_id [npad] i32 (K7
// updates it in place over the listed blocks), block_list [>= n_blocks]
// i32 on the device; params = host pointer to a FrontierParams of
// params_bytes bytes (ops/histogram.py:frontier_params), copied into the
// launch; scales [2] f32 on the device; scratch = the wrapper's persistent i64 buffer, all
// zero, of n_targets*F*B*3 words plus one u32 a tile, left all zero; out
// [n_targets, F, B, 3] f32.  n_blocks == 0 writes zero histograms and
// leaves leaf_id alone.  Returns a CUDA error code (0 on success).
int lgbt_histogram_frontier(const uint8_t* bins, const uint16_t* w8,
                            int* leaf_id, long long npad, int num_features,
                            int num_bins, int block_rows,
                            const int* block_list, long long n_blocks,
                            const void* params, long long params_bytes,
                            const float* scales, long long* scratch,
                            float* out, int packed4, int packed_acc,
                            void* stream) {
  if (params_bytes != (long long)sizeof(FrontierParams))
    return (int)cudaErrorInvalidValue;
  FrontierParams p;
  memcpy(&p, params, sizeof p);
  // the queue holds a row as an i32
  if (p.n_targets < 1 || p.n_targets > kFrontierMaxTargets
      || p.n_routes < 0 || p.n_routes > kFrontierMaxRoutes || p.n_ids < 0
      || block_rows < 1 || n_blocks < 0 || npad > 0x7fffffffll
      || (packed4 != 0 && num_features % 2 != 0))
    return (int)cudaErrorInvalidValue;
  int tiling[3];
  const int rc = lgbt_frontier_tiling(num_features, num_bins, p.n_targets,
                                      p.n_routes, p.n_ids, packed4,
                                      packed_acc, tiling);
  if (rc != 0) return rc;
  const int ft = tiling[0], tt = tiling[1];
  const size_t smem = (size_t)tiling[2];
  const int tiles_y = (int)div_up(num_features, ft);
  const int tiles_z = (int)div_up(p.n_targets, tt);
  cudaStream_t s = (cudaStream_t)stream;
  const int e = dispatch(
      p.n_routes > 0, packed4 != 0, packed_acc != 0,
      [&](auto R, auto P, auto A) {
        return launch_frontier<decltype(R)::value, decltype(P)::value,
                               decltype(A)::value>(
            tiles_y, tiles_z, smem, s, bins, w8, leaf_id, npad, num_features,
            num_bins, ft, tt, block_list, n_blocks, block_rows, scales,
            scratch, p, out);
      });
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K2, one kernel launch and no other operation on the stream.  bins [G,
// npad] u8 (packed4: two columns a byte), leaf_id [npad] i32 (updated in
// place over [row_lo, row_hi)), route = host pointer to 19 ints (its byte
// row w[2] holds the split feature's column w[3]).  Returns a CUDA error
// code (0 on success).
int lgbt_route_window(const uint8_t* bins, int* leaf_id, long long npad,
                      long long row_lo, long long row_hi, const int* route,
                      int packed4, void* stream) {
  if (row_lo < 0 || row_hi > npad) return (int)cudaErrorInvalidValue;
  if (row_hi < row_lo) row_hi = row_lo;
  RouteDesc desc;
  for (int k = 0; k < kRouteWords; ++k) desc.w[k] = route[k];
  const uint8_t* frow = bins + (long long)desc.w[2] * npad;
  cudaStream_t s = (cudaStream_t)stream;
  const int e = packed4 != 0
      ? launch_route<kRouteRows, kRouteTable, true>(frow, leaf_id, row_lo,
                                                    row_hi, desc, s)
      : launch_route<kRouteRows, kRouteTable, false>(frow, leaf_id, row_lo,
                                                     row_hi, desc, s);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K2 with the window and route read from step, a device pointer to a step
// block (lgbt_histogram_segment_step's), one kernel launch and no other
// operation on the stream; bin_rows the bin matrix's byte rows.  Bit for
// bit lgbt_route_window's leaf ids on the same window and route.  Returns
// a CUDA error code (0 on success).
int lgbt_route_window_step(const uint8_t* bins, int* leaf_id, long long npad,
                           int bin_rows, int block_rows, const int* step,
                           int packed4, void* stream) {
  if (bin_rows < 1 || block_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int e = packed4 != 0
      ? launch_route_step<kRouteRows, kRouteTable, true>(
            bins, leaf_id, npad, bin_rows, block_rows, step, s)
      : launch_route_step<kRouteRows, kRouteTable, false>(
            bins, leaf_id, npad, bin_rows, block_rows, step, s);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

}  // extern "C"
