// Ensemble routing for Hopper (sm_90a): P1 route_trees.
//
// Adds, per row and in tree order, the leaf value each tree gives the row
// into the score of the tree's class:
//   out[class[t]][row] += leaf_value[t][leaf_t(row)],  t = 0 .. T-1.
// It is the card's counterpart of the JAX package's stacked-tree route
// (lightgbm_tpu/models/device_predict.py _tree_leaves, :99-149, with the
// host's float64 gather of :2199-2207 in models/gbdt.py folded in).  JAX
// computes that route as XLA gathers, not as a Pallas kernel: there is no
// pl.pallas_call to replace.
//
// Bins of EFB-bundled data (lightgbm_tpu_torch/core/bundle.py): feature f
// lives in column feat_group[f] at feat_offset[f] + bin; a column value
// outside [offset, offset + num_bin) is f at its default bin, as the JAX
// route reconstructs it (_tree_leaves :117-125).  A feature of offset 0
// owns its column, which holds its bins as they are: the unbundled case,
// predict-time bins (identity tables, whose -1 sentinel must stay -1)
// and a singleton column of bundled data, whose values are always in
// range.
//
// Routing (tree.h NumericalDecisionInner / CategoricalDecisionInner): a
// numerical node sends a bin left when it is <= its threshold bin, except
// a missing bin (the default bin under missing-zero, the last bin under
// missing-NaN), which takes the node's default direction; a categorical
// node looks the bin up in at most 8 words of its bitset, and a bin of
// 256 or more (which no bitset holds: the host walk's FindInBitset) or a
// negative bin (predict-time binning's sentinel for a category training
// never saw) goes right.  A single-leaf tree starts at
// node -1, i.e. leaf 0.
//
// Exactness: each class's trees are added one after the other in tree
// order in float64, with no fused multiply: the same sequence of IEEE
// additions as the host's numpy `raw[k] += leaf_value[leaves]`, so the
// same bits.
//
// What bounds it: bytes, the lesser of two counts: the bins on each row's
// path (a read a node, the first design's count) or the row's G bin
// columns once; plus its 8-byte score read and written once a class and
// the stack.  The first design walked one row a thread through about
// nine dependent loads a step (feature, column, bin, tables, decision,
// threshold, child) and fetched a 32-byte sector for each
// one-byte bin of each step of each tree: 6-22% of its bound.  Once the
// bins come from shared memory, a step's time follows its instructions
// and its record load (PERF.md §6: tools/p1_time.py candidates), so
// this design cuts both:
//
//  * Node records.  The host (ops/predict.py pack_route_records) folds a
//    node and its feature's tables into one record that one load
//    fetches: 16 bytes with the bin column (the logical column; a 4-bit
//    packed column's byte row and nibble follow from it), the feature's
//    bin offset and the span of its bins in the column, the threshold
//    bin (a categorical node: its bitset's index in the tree), the
//    missing bin (the default bin under missing-zero, the last bin under
//    missing-NaN) where its default way differs from the threshold's,
//    which then flips the threshold test, flags (categorical, and the way
//    of a bin outside the span, which the plain route sends one way: the
//    default bin's under EFB, a negative bin's for a feature that owns
//    its column) and both children; 8 bytes in a tree of numerical
//    nodes on owned columns (kCompact below).  The host marks each tree
//    with the least record and step its nodes need.
//  * The stack in shared memory.  The host cuts the trees, grouped by
//    class and in tree order within a class, into chunks of at most
//    kStageBytes (records, leaf values, the categorical nodes' bitsets);
//    a block copies chunk c + 1 into one of two stages with cp.async
//    while it walks chunk c.  A tree larger than a stage is a chunk of
//    its own that the block reads from device memory in place (the
//    read-only cache), so a stack of any size routes.  The tree loop is
//    the outer loop: each thread keeps its rows' float64 sums of the
//    current class in registers.
//  * A row tile of bins in shared memory (kTiled).  Where the block's
//    [P, R] tile of u8 bin rows fits kMaxTileBytes (P byte rows: G, or
//    ceil(G / 2) packed), the block copies it once, coalesced (16-byte
//    cp.async where the matrix's row pitch allows), and every tree walks
//    from shared memory: a row costs its P bytes once.  Wider matrices
//    (the 100k-feature sparse gate) and i16 predict-time bins (whose
//    tile, twice the bytes, halved the blocks an SM and measured slower:
//    PERF.md §6) are read from device memory a node at a time.  The
//    wrapper picks the mode and R from the shapes alone (ops/predict.py
//    route_plan).
//  * kRowsPerThread rows a thread, stepped together through a tree with
//    the step written without branches, so that their loads overlap;
//    a thread leaves a tree when its rows are all at leaves.  (A
//    level-by-level walk over a compacted list of the rows still walking,
//    a barrier a level, was slower: PERF.md §6.)
//
// Bins are column-major [P, stride]: u8 (the training and valid sets'
// device bins, G EFB columns; kPacked4: two columns a byte, column 2i in
// the low nibble of byte row i and 2i + 1 in the high one,
// ops/histogram.py:pack_bins_4bit), i16 (predict-time bins, one column
// a feature, which carry the -1 sentinel) or u16 (two-byte bins: the
// device bins of a dataset with a column of more than 256 bins, and
// predict-time bins for its model, whose sentinel 0xFFFF is a bin of 256
// or more, so an unseen category still goes right).
//
// The stack (one device buffer, ops/predict.py pack_route_records):
//   chunks [C, 8] i32: offset and size in 16-byte units into data, first
//       and past-last tree, class, staged (0: read in place), 0, 0;
//   trees [T, 4] i32 in chunk order: the tree's first record (8-byte
//       units) and first leaf value (8-byte units) from its chunk's
//       start, its depth (0 for a single leaf) | its kind << 16, and its
//       first bitset (16-byte units from its chunk's start);
//   data: each chunk's records, a tree's after the other's in tree order
//       (16-byte [n, 4] u32 at 16 bytes, or 8-byte [n, 2] u32), its leaf
//       values f64, then the bitsets [k, 8] u32 of its categorical nodes
//       (a tree's in node order, the record's threshold field its index).
// A 16-byte record: w0 = column (24 bits) | flags << 24; w1 = feature
// offset | span << 16; w2 = threshold bin (or bitset index) | missing bin
// << 16; w3 = left child | right child << 16 (int16 each; a leaf is
// ~leaf).  An 8-byte record: column | has a missing bin << 15 |
// threshold << 16 | missing bin << 24, then the children as w3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 4;
constexpr int kStageBytes = 12288;       // ops/predict.py STAGE_BYTES
constexpr int kMaxTileBytes = 96 * 1024;  // ops/predict.py TILE_BUDGET
constexpr int kTilePad = 16;             // ops/predict.py TILE_PAD
constexpr int kChunkWords = 8;
constexpr int kCatWords = 8;
// a record's flags (ops/predict.py FLAG_*)
constexpr unsigned kFlagCat = 1u;
constexpr unsigned kFlagLeftOutside = 4u;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the most recent group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A chunk's bytes into a stage, 16 bytes a copy.
__device__ __forceinline__ void stage_chunk(unsigned char* stage,
                                            const uint4* data, int offset16,
                                            int size16) {
  for (int i = threadIdx.x; i < size16; i += blockDim.x)
    cp_async16(stage + 16 * i, data + offset16 + i);
}

// The block's [P, R] tile of bin rows, rows row0 .. row0 + R - 1 (those
// below stride), into shared memory at a pitch of R + kTilePad / es
// elements: 16-byte copies where the matrix allows them (vec), else one
// element at a time.
template <typename BinT>
__device__ __forceinline__ void load_tile(BinT* tile, const BinT* bins,
                                          long long stride, int byte_rows,
                                          long long row0, int R, int pitch,
                                          bool vec) {
  constexpr int kPer = 16 / (int)sizeof(BinT);
  if (vec) {
    const int units = R / kPer;
    const int total = byte_rows * units;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int g = i / units, u = i - g * units;
      const long long r = row0 + (long long)u * kPer;
      BinT* dst = tile + g * pitch + u * kPer;
      const BinT* src = bins + (long long)g * stride + r;
      if (r + kPer <= stride) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < kPer && r + e < stride; ++e) dst[e] = src[e];
      }
    }
  } else {
    const int total = byte_rows * R;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int g = i / R, lr = i - g * R;
      if (row0 + lr < stride)
        tile[g * pitch + lr] = bins[(long long)g * stride + row0 + lr];
    }
  }
}

// One step of one row (its column's bin at `lr` of the tile, or at `row`
// of the matrix) at node `node` >= 0 of a tree whose records start at
// `recs` (8-byte units): the next node (a leaf is ~leaf).  The tree's
// kind picks the record and the step.  kCompact: every node numerical on
// a column its feature owns, where the plain route compares the bin as
// it is (an i16 sentinel -1 is <= any threshold, as there), columns
// below 2^15 and at most 256 bins: an 8-byte record (column | has a
// missing bin << 15 | threshold << 16 | missing bin << 24, then the
// children), half the 16-byte one's bytes, and a threshold test.
// kCategorical: the 16-byte record on owned columns, a bitset test at
// categorical nodes (a negative bin goes right); kBundled: a feature that
// shares its column (EFB), the range test first.
constexpr int kCompact = 0;
constexpr int kCategorical = 1;
constexpr int kBundled = 2;

template <typename BinT, bool kPacked4, bool kTiled>
__device__ __forceinline__ int bin_of(int col, const BinT* tile, int pitch,
                                      int lr, const BinT* __restrict__ bins,
                                      long long stride, long long row) {
  const int brow = kPacked4 ? col >> 1 : col;
  int fv;
  if constexpr (kTiled) fv = (int)tile[brow * pitch + lr];
  else fv = (int)__ldg(bins + (long long)brow * stride + row);
  if (kPacked4) fv = (col & 1) ? fv >> 4 : fv & 15;
  return fv;
}

template <typename BinT, bool kPacked4, bool kTiled, bool kStaged, int kKind>
__device__ __forceinline__ int step(const uint2* recs, int node,
                                    const unsigned* bits, const BinT* tile,
                                    int pitch, int lr,
                                    const BinT* __restrict__ bins,
                                    long long stride, long long row) {
  if constexpr (kKind == kCompact) {
    uint2 r;
    if constexpr (kStaged) r = recs[node];
    else r = __ldg(recs + node);
    const int fv = bin_of<BinT, kPacked4, kTiled>(
        (int)(r.x & 0x7FFFu), tile, pitch, lr, bins, stride, row);
    const bool left = (fv <= (int)((r.x >> 16) & 0xFFu)) !=
                      ((r.x & 0x8000u) != 0 && fv == (int)(r.x >> 24));
    return (int)(left ? r.y << 16 : r.y) >> 16;
  } else {
    const uint4* recs16 = reinterpret_cast<const uint4*>(recs);
    uint4 r;
    if constexpr (kStaged) r = recs16[node];
    else r = __ldg(recs16 + node);
    const unsigned flags = r.x >> 24;
    const int fv = bin_of<BinT, kPacked4, kTiled>(
        (int)(r.x & 0xFFFFFFu), tile, pitch, lr, bins, stride, row);
    const int thr = (int)(r.z & 0xFFFFu);
    const int miss = (int)(r.z >> 16);
    // the missing bin is in the record only where its default way
    // differs from the threshold's (else NO_BIN): there it flips the
    // threshold test
    int x = fv;
    bool inside = x >= 0;
    if constexpr (kKind == kBundled) {
      x = fv - (int)(r.y & 0xFFFFu);
      inside = (unsigned)x < (r.y >> 16);
    }
    const bool is_cat = (flags & kFlagCat) != 0;
    unsigned word = 0u;
    if (is_cat && inside && x < 32 * kCatWords) {
      // a bin of 256 or more is in no bitset (word 0: right)
      const unsigned* at = bits + thr * kCatWords + (x >> 5);
      if constexpr (kStaged) word = *at;
      else word = __ldg(at);
    }
    const bool num_left = (x <= thr) != (x == miss);
    // an owned column's negative bin: right at a categorical node (word
    // 0), compared as it is at a numerical one
    bool left = is_cat ? ((word >> (x & 31)) & 1u) != 0 : num_left;
    if constexpr (kKind == kBundled)
      left = inside ? left : (flags & kFlagLeftOutside) != 0;
    return (int)(left ? r.w << 16 : r.w) >> 16;
  }
}

// One tree over the thread's rows: they step together; the thread leaves
// the tree when all of them are at leaves (a warp when all of its 32 x
// kRowsPerThread rows are); then each adds its leaf value.
template <typename BinT, bool kPacked4, bool kTiled, bool kStaged, int kKind>
__device__ __forceinline__ void walk_tree(
    const uint2* recs, const double* leaves, int steps, const unsigned* bits,
    const BinT* tile, int pitch, const BinT* __restrict__ bins,
    long long stride, long long row0,
    const bool (&valid)[kRowsPerThread], double (&acc)[kRowsPerThread]) {
  int node[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) node[j] = valid[j] ? 0 : -1;
  for (int s = 0; s < steps; ++s) {
    // every row steps (a row at a leaf or past n from the root, its
    // result dropped), without a branch, so the rows' loads overlap
    int done = -1;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int lr = threadIdx.x + j * blockDim.x;
      const int next = step<BinT, kPacked4, kTiled, kStaged, kKind>(
          recs, node[j] < 0 ? 0 : node[j], bits, tile, pitch, lr, bins,
          stride, valid[j] ? row0 + lr : row0);
      node[j] = node[j] < 0 ? node[j] : next;
      done &= node[j];
    }
    if (done < 0) break;   // this thread's rows are all at leaves
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (valid[j]) {
      const int leaf = node[j] < 0 ? ~node[j] : 0;
      acc[j] = __dadd_rn(acc[j], kStaged ? leaves[leaf]
                                         : __ldg(leaves + leaf));
    }
  }
}

// Every tree of one chunk (records and leaf values from `base`) over the
// thread's rows, each tree's leaf value added into the rows' sums.  A
// tree's kind (te.z >> 16) is the same for every thread.
template <typename BinT, bool kPacked4, bool kTiled, bool kStaged>
__device__ __forceinline__ void walk_chunk(
    const uint4* base, int tree_lo, int tree_hi,
    const int4* __restrict__ trees, const BinT* tile, int pitch,
    const BinT* __restrict__ bins, long long stride, long long row0,
    const bool (&valid)[kRowsPerThread], double (&acc)[kRowsPerThread]) {
  const double* leaf_base = reinterpret_cast<const double*>(base);
  for (int t = tree_lo; t < tree_hi; ++t) {
    const int4 te = __ldg(trees + t);
    const uint2* recs = reinterpret_cast<const uint2*>(base) + te.x;
    const double* leaves = leaf_base + te.y;
    const unsigned* bits = reinterpret_cast<const unsigned*>(base + te.w);
    const int steps = te.z & 0xFFFF;
    switch (te.z >> 16) {
      case kCompact:
        walk_tree<BinT, kPacked4, kTiled, kStaged, kCompact>(
            recs, leaves, steps, bits, tile, pitch, bins, stride, row0,
            valid, acc);
        break;
      case kCategorical:
        walk_tree<BinT, kPacked4, kTiled, kStaged, kCategorical>(
            recs, leaves, steps, bits, tile, pitch, bins, stride, row0,
            valid, acc);
        break;
      default:
        walk_tree<BinT, kPacked4, kTiled, kStaged, kBundled>(
            recs, leaves, steps, bits, tile, pitch, bins, stride, row0,
            valid, acc);
    }
  }
}

template <typename BinT, bool kPacked4, bool kTiled>
__global__ void __launch_bounds__(256)
route_trees_kernel(const BinT* __restrict__ bins, long long stride,
                   long long n, int byte_rows, int vec,
                   const int* __restrict__ chunks, int num_chunks,
                   const int4* __restrict__ trees,
                   const uint4* __restrict__ data,
                   double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinT* tile = reinterpret_cast<BinT*>(smem + 2 * kStageBytes);
  const int R = blockDim.x * kRowsPerThread;
  const int pitch = R + kTilePad / (int)sizeof(BinT);
  const long long row0 = (long long)blockIdx.x * R;
  if (kTiled) load_tile(tile, bins, stride, byte_rows, row0, R, pitch,
                        vec != 0);
  if (__ldg(chunks + 5))
    stage_chunk(smem, data, __ldg(chunks), __ldg(chunks + 1));
  cp_async_commit();
  // the first class's scores load while the tile and the first chunk do
  bool valid[kRowsPerThread];
  double acc[kRowsPerThread];
  int cur = __ldg(chunks + 4);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long row = row0 + threadIdx.x + j * blockDim.x;
    valid[j] = row < n;
    acc[j] = valid[j] ? out[(long long)cur * n + row] : 0.0;
  }
  for (int c = 0; c < num_chunks; ++c) {
    const int* ch = chunks + (long long)c * kChunkWords;
    if (c + 1 < num_chunks && __ldg(ch + kChunkWords + 5))
      stage_chunk(smem + ((c + 1) & 1) * kStageBytes, data,
                  __ldg(ch + kChunkWords), __ldg(ch + kChunkWords + 1));
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int cls = __ldg(ch + 4);
    if (cls != cur) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (valid[j]) {
          const long long row = row0 + threadIdx.x + j * blockDim.x;
          out[(long long)cur * n + row] = acc[j];
          acc[j] = out[(long long)cls * n + row];
        }
      }
      cur = cls;
    }
    const int lo = __ldg(ch + 2), hi = __ldg(ch + 3);
    if (__ldg(ch + 5)) {
      walk_chunk<BinT, kPacked4, kTiled, true>(
          reinterpret_cast<const uint4*>(smem + (c & 1) * kStageBytes), lo,
          hi, trees, tile, pitch, bins, stride, row0, valid, acc);
    } else {
      walk_chunk<BinT, kPacked4, kTiled, false>(
          data + __ldg(ch), lo, hi, trees, tile, pitch, bins, stride, row0,
          valid, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (valid[j])
      out[(long long)cur * n + row0 + threadIdx.x + j * blockDim.x] = acc[j];
  }
}

template <typename BinT, bool kPacked4, bool kTiled>
int launch(const void* bins, long long stride, long long n, int byte_rows,
           int rows_per_block, const int* chunks, int num_chunks,
           const void* trees, const void* data, double* out,
           cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_trees_kernel<BinT, kPacked4, kTiled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kStageBytes + kMaxTileBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int es = (int)sizeof(BinT);
  const size_t smem =
      2 * kStageBytes +
      (kTiled ? (size_t)byte_rows * (rows_per_block * es + kTilePad) : 0);
  const int vec = ((uintptr_t)bins % 16 == 0) && ((stride * es) % 16 == 0);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  route_trees_kernel<BinT, kPacked4, kTiled>
      <<<(unsigned)blocks, rows_per_block / kRowsPerThread, smem, st>>>(
          (const BinT*)bins, stride, n, byte_rows, vec, chunks, num_chunks,
          (const int4*)trees, (const uint4*)data, out);
  return (int)cudaGetLastError();
}

}  // namespace

// P1, one kernel launch.  bins [byte_rows, stride] (bin_bytes 1 or 2;
// packed4: u8, two columns a byte; wide: the two bytes unsigned, else
// signed); out [C, n] float64 in place; the
// stack's sections (chunks, trees, data) as the header describes them;
// rows_per_block (128, 256, 512 or 1024) and tiled (u8 bins only) as
// ops/predict.py route_plan chose them; stage_bytes, tile_budget and
// rows_per_thread are the wrapper's constants, checked against this
// file's.  Returns a CUDA error code (0 on success).
extern "C" int lgbt_route_trees(const void* bins, int bin_bytes,
                                int byte_rows, long long stride, long long n,
                                const int* chunks, int num_chunks,
                                const void* trees, const void* data,
                                int rows_per_block, int tiled,
                                int stage_bytes, int tile_budget,
                                int rows_per_thread, double* out,
                                int packed4, int wide, void* stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (packed4 != 0 && bin_bytes != 1)
      || (wide != 0 && bin_bytes != 2)
      || (tiled != 0 && bin_bytes != 1)
      || stage_bytes != kStageBytes || tile_budget != kMaxTileBytes
      || rows_per_thread != kRowsPerThread || n > stride
      || (rows_per_block != 128 && rows_per_block != 256
          && rows_per_block != 512 && rows_per_block != 1024)
      || (tiled != 0 && (long long)byte_rows *
              (rows_per_block + kTilePad) > kMaxTileBytes))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || num_chunks <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const auto args = [&](auto f) {
    return f(bins, stride, n, byte_rows, rows_per_block, chunks, num_chunks,
             trees, data, out, st);
  };
  if (bin_bytes == 2)
    return wide ? args(launch<uint16_t, false, false>)
                : args(launch<int16_t, false, false>);
  if (packed4 != 0)
    return tiled ? args(launch<uint8_t, true, true>)
                 : args(launch<uint8_t, true, false>);
  return tiled ? args(launch<uint8_t, false, true>)
               : args(launch<uint8_t, false, false>);
}
