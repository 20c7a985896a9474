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
// node looks the bin up in at most 8 words of its bitset (bins are at
// most 256), and a negative bin (predict-time binning's sentinel for a
// category training never saw) goes right.  A single-leaf tree starts at
// node -1, i.e. leaf 0.  A row takes at most max_depth + 1 steps, as the
// JAX route's fori_loop does.
//
// Exactness: each row is one thread, which keeps its class's sum in a
// register and adds the trees of that class one after the other in
// float64, with no fused multiply: the same sequence of IEEE additions
// as the host's numpy `raw[k] += leaf_value[leaves]`, so the same bits.
//
// What bounds it: bytes.  A row reads one bin a node on its path (at most
// max_depth bytes a tree, two for signed bins) and reads and writes its
// 8-byte score once a class; the tree arrays (a few KB a tree) and the
// [F] tables stay in L1/L2.  The simple design: a grid-stride loop over
// rows, the tree arrays read through the read-only cache.
//
// Bins are column-major [G, stride]: u8 (the training and valid sets'
// device bins, G EFB columns) or i16 (predict-time bins, one column a
// feature, which carry the -1 sentinel).  The training set's u8 bins may
// be 4-bit packed (kPacked4, a dataset whose bin axis is at most 16: two
// columns a byte, column 2i in the low nibble of byte row i and 2i + 1 in
// the high one, ops/histogram.py:pack_bins_4bit): feature f is then read
// from byte row feat_group[f] >> 1 and the nibble of feat_group[f]'s
// parity, before feat_offset applies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr int kCatWords = 8;

struct Stack {
  const int* split_feature;    // [T, M]
  const int* threshold_bin;    // [T, M]
  const int* decision_type;    // [T, M]
  const int* left_child;       // [T, M]
  const int* right_child;      // [T, M]
  const unsigned* cat_bitset;  // [T, M, 8]
  const double* leaf_value;    // [T, L]
  const int* num_leaves;       // [T]
  const int* tree_class;       // [T]
  int num_trees, max_nodes, max_leaves, max_depth;
};

template <typename BinT, bool kPacked4>
__device__ __forceinline__ int tree_leaf(const Stack& s, int t,
                                         const BinT* __restrict__ bins,
                                         long long stride, long long row,
                                         const int* __restrict__ num_bin,
                                         const int* __restrict__ default_bin,
                                         const int* __restrict__ feat_group,
                                         const int* __restrict__ feat_offset) {
  const long long base = (long long)t * s.max_nodes;
  int node = __ldg(s.num_leaves + t) <= 1 ? -1 : 0;
  for (int step = 0; step <= s.max_depth && node >= 0; ++step) {
    const long long i = base + node;
    const int f = __ldg(s.split_feature + i);
    const int col = __ldg(feat_group + f);
    int fv = (int)bins[(long long)(kPacked4 ? col >> 1 : col) * stride + row];
    if (kPacked4) fv = (col & 1) ? fv >> 4 : fv & 15;
    const int off = __ldg(feat_offset + f);
    if (off != 0) {
      const bool in_range = fv >= off && fv < off + __ldg(num_bin + f);
      fv = in_range ? fv - off : __ldg(default_bin + f);
    }
    const int d = __ldg(s.decision_type + i);
    bool left;
    if (d & 1) {
      if (fv < 0) {
        left = false;
      } else {
        const int w = (fv >> 5) < kCatWords - 1 ? (fv >> 5) : kCatWords - 1;
        left = (__ldg(s.cat_bitset + i * kCatWords + w) >> (fv & 31)) & 1u;
      }
    } else {
      const int mt = (d >> 2) & 3;
      const bool missing =
          (mt == kMissingZero && fv == __ldg(default_bin + f)) ||
          (mt == kMissingNan && fv == __ldg(num_bin + f) - 1);
      left = missing ? (d & 2) != 0 : fv <= __ldg(s.threshold_bin + i);
    }
    node = left ? __ldg(s.left_child + i) : __ldg(s.right_child + i);
  }
  return node < 0 ? ~node : 0;
}

template <typename BinT, bool kPacked4>
__global__ void __launch_bounds__(kThreads)
route_trees_kernel(const BinT* __restrict__ bins, long long stride,
                   long long n, Stack s, const int* __restrict__ num_bin,
                   const int* __restrict__ default_bin,
                   const int* __restrict__ feat_group,
                   const int* __restrict__ feat_offset, int num_class,
                   double* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += step) {
    for (int k = 0; k < num_class; ++k) {
      double acc = out[(long long)k * n + row];
      for (int t = 0; t < s.num_trees; ++t) {
        if (__ldg(s.tree_class + t) != k) continue;
        const int leaf = tree_leaf<BinT, kPacked4>(
            s, t, bins, stride, row, num_bin, default_bin, feat_group,
            feat_offset);
        acc = __dadd_rn(acc, __ldg(s.leaf_value +
                                   (long long)t * s.max_leaves + leaf));
      }
      out[(long long)k * n + row] = acc;
    }
  }
}

}  // namespace

extern "C" int lgbt_route_trees(
    const void* bins, int bin_bytes, long long stride, long long n,
    const int* split_feature, const int* threshold_bin,
    const int* decision_type, const int* left_child, const int* right_child,
    const unsigned* cat_bitset, const double* leaf_value,
    const int* num_leaves, const int* tree_class, int num_trees,
    int max_nodes, int max_leaves, int max_depth, const int* num_bin,
    const int* default_bin, const int* feat_group, const int* feat_offset,
    int num_class, double* out, int packed4, void* stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) || (packed4 != 0 && bin_bytes != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || num_trees <= 0) return (int)cudaGetLastError();
  Stack s{split_feature, threshold_bin, decision_type, left_child,
          right_child,   cat_bitset,    leaf_value,    num_leaves,
          tree_class,    num_trees,     max_nodes,     max_leaves,
          max_depth};
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 32ll * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  cudaStream_t st = (cudaStream_t)stream;
  if (packed4 != 0) {
    route_trees_kernel<uint8_t, true><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)bins, stride, n, s, num_bin, default_bin, feat_group,
        feat_offset, num_class, out);
  } else if (bin_bytes == 1) {
    route_trees_kernel<uint8_t, false><<<(unsigned)blocks, kThreads, 0,
                                         st>>>(
        (const uint8_t*)bins, stride, n, s, num_bin, default_bin, feat_group,
        feat_offset, num_class, out);
  } else {
    route_trees_kernel<int16_t, false><<<(unsigned)blocks, kThreads, 0,
                                         st>>>(
        (const int16_t*)bins, stride, n, s, num_bin, default_bin, feat_group,
        feat_offset, num_class, out);
  }
  return (int)cudaGetLastError();
}
