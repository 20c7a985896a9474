// A candidate design of B3, not shipped: the two-limb split (a q's low k
// bits and q >> k into two atomic planes a channel, five adds a pair with
// the count), a top word a cell in the registers of the thread that
// renormalises it, and a renormalising barrier every R rows, R from the
// call's largest |q| (4,095-5,113 rows at HIGGS's 10.5M rows).  Kept as it
// was measured, for tools/b3_candidates.py, which builds it beside the
// shipped lightgbm_tpu_torch/csrc/wide_hist.cu; the package never builds
// it.
//
// B3, the histogram of the second histogram path, for Hopper (sm_90a): two
// kernels, each behind an entry point with a plain C interface, loaded
// through ctypes by lightgbm_tpu_torch/ops/kernels.py:
//
//   lgbt_chunked_select     — pass 1, chunked_select_kernel: the leaf's
//       rows as a list, and the call's scales;
//   lgbt_histogram_chunked  — pass 2, chunked_hist_kernel: the histogram
//       of the listed rows.
//
// They replace lightgbm_tpu/ops/histogram.py histogram_chunked (:32,
// _hist_one_chunk :72): per (column, bin), the sums over every row of
// three f32 channels [grad * m, hess * m, m].  That function is not a
// Pallas kernel: XLA contracts a one-hot [rows, G, B] matrix against the
// channels at HIGHEST precision, in row chunks.  The JAX package takes it
// where the Pallas kernels cannot serve: a column of more than 256 bins
// (two-byte bins), gpu_use_dp / tpu_double_precision, or
// tpu_histogram_backend="onehot" (lightgbm_tpu/models/gbdt.py:436-462),
// always with its fused grower.  Here the fused grower
// (lightgbm_tpu_torch/models/grower_fused.py) calls it for the root (m =
// member) and for each split's smaller child (m = member where leaf_id is
// the child, else 0), handing over grad, hess, member and leaf_id: no
// channel tensor is built.
//
// Exactness.  The channels are f32, their full mantissa (what gpu_use_dp
// asks for).  Each row with m != 0 adds q = round(grad * m * scale) and
// round(hess * m * scale) as 64-bit integers and 1 to the count.  The
// scales are powers of two, ops/histogram.py channel_scales' rule (the
// largest at which |max| x Npad stays under 2^62, clamped to 2^+-126),
// so no sum can overflow; pass 1 computes them on the card, bit for bit
// the torch rule (the same f32 products, an exact max, log2 and ceil in
// f64).  Integer adds commute, so every launch gives the same bits in any
// order of the threads, and the plain versions (ops/histogram.py
// histogram_chunked_leaf_plain, histogram_chunked_plain) repeat the
// arithmetic bit for bit.
//
// What bounds it.  Bytes: the leaf id and member of every row (8 B, 4 at
// the root), a member row's gradient and hessian (8 B) and its bins (G or
// 2G B), the output once.  But the card's shared-memory atomic unit, not
// its memory, sets the time: 8-9 lanes of 32-bit atomics a clock an SM
// whatever the addresses, and a 64-bit or f32 shared add is a
// compare-and-swap loop (tools/b3_atomics_probe.cu), so an exact (row,
// column) pair costs what its 32-bit atomics cost.  The first design
// spent five atomics a pair, two returning the old low word for the high
// word's carry, on every row of Npad however small the leaf, re-read the
// channels in every column tile, and ran ~20 torch operations around each
// call (a [3, Npad] channel tensor, the scales, a scratch zero).
//
// The design:
//  (1) pass 1 reads each row's leaf id and member (16-byte loads, four
//      rows a thread) and, for a member row of the leaf, its gradient and
//      hessian; each block compacts its rows' members (a block prefix of
//      the counts) into its own segment of a list of (row, g * m, h * m),
//      in row order, and reduces max |g * m| and max |h * m|; the last
//      block to arrive writes the segments' prefix, the scales and the
//      renormalisation interval into a state block.  No global counter is
//      contended; the list is the same on every launch.
//  (2) pass 2 runs full warps of listed rows only: a block takes a slice
//      of the member list (a leaf costs its own rows) and one tile of
//      columns, reads each listed row's channels once and its tile's bins
//      from a row-major copy of the bins (ops/histogram.py chunked_rows:
//      a row's bins in one or two 16-byte loads, so a scattered small leaf
//      reads a sector a row and not one a column).  Blocks of one slice
//      and different tiles are neighbours in the grid and run together, so
//      the other tiles' reads of a slice hit L2.  Only as many slices run
//      as add kRowsPerCellPart rows into each of a block's cells: a small
//      leaf does not pay 132 blocks' flushes.
//  (3) no returning atomic: a q is split into a low part of k bits (q mod
//      2^k) and a high part (q >> k), added with non-returning 32-bit
//      atomics into a low and a high plane; the count is a third.  Every
//      R rows a block renormalises in place (a barrier, then each thread
//      its cells): the low plane's carry moves into the high plane and the
//      high plane's upper bits into a top word, so neither plane can wrap.
//      k and R come from the largest |q| of the call (pass 1): at HIGGS's
//      10.5M rows |q| < 2^38, k = 19 and R = 4095.  A pair is five atomics
//      and no dependent chain, against five with two returning before;
//      with a top word the low and high adds of 16 bits could run 65,535
//      rows between renormalisations but cost seven atomics a pair.
//  (4) where a shape leaves shared memory idle (B <= 256 on one-byte
//      bins: 28 columns of 64 bins take 50 KB), the planes are copied up
//      to kMaxCopies times and lane l adds into copy l mod copies, so
//      lanes of a warp on one bin (skewed columns) meet less often; the
//      copies are summed at the flush.
//  (5) a block flushes its cells' 64-bit sums into a persistent i64
//      scratch with global atomics; the last block of the tile to arrive
//      converts the tile to f32 (each sum over its scale in f64) and
//      zeroes the scratch again.  Where not one column's cells fit a block
//      (B of 8,192 and more on two-byte bins), the rows add straight into
//      the scratch with 64-bit global atomics (kGlobal), exact all the
//      same.
//
// Calls on one device share the state, the list and the scratch, so they
// must follow each other on one stream (the port's growers histogram on
// the current stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB3Threads = 1024;
constexpr int kSelectRows = 4;          // rows a thread takes a step, pass 1
constexpr int kMaxSegments = 512;       // pass 1's blocks
// a (column, bin) cell: g lo, g hi, h lo, h hi, count (u32 planes); its
// two top words live in the registers of the thread that renormalises it
constexpr int kPlanes = 5;
constexpr int kCellBytes = kPlanes * 4;
// the most cells (and copies) a thread renormalises: the shared budget
// (227 KB) over kCellBytes, over the block
constexpr int kMaxWordsPerThread = 12;
constexpr int kMaxCopies = 8;
constexpr int kRowsPerCellPart = 4;

// Pass 1's output and scratch, in device memory (ops/histogram.py
// _chunked_state: 2,048 int64 words, zero at first use).
struct B3State {
  unsigned max_bits[2];   // max |g * m|, |h * m| as bits; left zero
  unsigned arrivals;      // pass 1's arrival counter; left zero
  unsigned pad0;
  float scale[2];
  int kbits;              // bits of the low planes
  int interval;           // rows a block adds between renormalisations
  long long members;
  long long per;          // rows of a segment (a pass-1 block)
  int nseg;
  int pad1;
  long long count[kMaxSegments];
  long long prefix[kMaxSegments + 1];
};

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

// A block's max of v (as quantize.cu's block_max): thread 0 holds it.
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

// The exclusive prefix of v over the block's threads; *total their sum.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* sums,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nw ? sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sums[lane] = w;
  }
  __syncthreads();
  const unsigned ex = (warp == 0 ? 0u : sums[warp - 1]) + x - v;
  *total = sums[nw - 1];
  __syncthreads();
  return ex;
}

// channel_scales' rule for one channel whose max |value| has the bits
// `bits`: 2^clamp(61 - ceil(log2(max(|max| * n, 1e-30))), -126, 126),
// in f64 as torch computes it; NaN stays NaN.
__device__ float b3_scale(uint32_t bits, long long n) {
  const double x0 = (double)__uint_as_float(bits) * (double)(n > 1 ? n : 1);
  if (x0 != x0) return __uint_as_float(0x7FC00000u);
  const double x = x0 < 1e-30 ? 1e-30 : x0;
  const double e = fmin(fmax(61.0 - ceil(log2(x)), -126.0), 126.0);
  return (float)exp2(e);
}

// The low planes' bits k and the rows R between renormalisations for a
// largest |q| of qmax: a low plane starts under 2^k and takes R adds under
// 2^k ((R + 1)(2^k - 1) < 2^32); a high plane starts in [0, 2^(32-k)) and
// takes R adds of q >> k, |q >> k| <= ceil(qmax / 2^k) = H (R * H <= 2^31
// - 2^(32-k)).  The k of the largest R; R = 0 where no k holds a row
// (|q| >= 2^62, beyond the fixed point's range).
__device__ void b3_interval(double qmax, int* kbits, int* interval) {
  unsigned long long q = ~0ull;
  if (qmax < 9.0e18) q = (unsigned long long)qmax;
  long long best = -1;
  int bk = 16;
  for (int k = 1; k <= 31; ++k) {
    const long long r_lo = (long long)((0xFFFFFFFFull / ((1ull << k) - 1ull))
                                       - 1ull);
    const long long room = (1ll << 31) - (1ll << (32 - k));
    const unsigned long long h = (q >> k) + ((q & ((1ull << k) - 1)) != 0);
    const long long r_hi = h == 0 ? room
        : (h > (1ull << 40) ? 0 : room / (long long)h);
    const long long r = r_lo < r_hi ? r_lo : r_hi;
    if (r > best) {
      best = r;
      bk = k;
    }
  }
  *kbits = bk;
  *interval = (int)(best < (1ll << 30) ? best : (1ll << 30));
}

// Pass 1.  Block b takes rows [b * per, (b + 1) * per): a row is a member
// when m != 0, m = member (leaf_id == nullptr: the root) or member where
// leaf_id[row] == leaf and 0 elsewhere; its values are grad * m and hess *
// m in IEEE f32 (premultiplied: grad and hess as they are, the channels of
// a [3, npad] w3).  The members go, in row order, to the block's segment
// of the list (list_idx, list_g, list_h at b * per); the last block writes
// the state.
template <bool kVec>
__global__ void __launch_bounds__(kB3Threads)
chunked_select_kernel(const float* __restrict__ grad,
                      const float* __restrict__ hess,
                      const float* __restrict__ member,
                      const int* __restrict__ leaf_id, int leaf,
                      int premultiplied, long long npad, long long per,
                      const float* __restrict__ given_scales, B3State* st,
                      int* __restrict__ list_idx, float* __restrict__ list_g,
                      float* __restrict__ list_h) {
  __shared__ unsigned s_sums[32];
  __shared__ uint32_t s_red[2][32];
  __shared__ bool s_last;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = min(lo + per, npad);
  const long long span = hi > lo ? hi - lo : 0;
  constexpr long long kStep = (long long)kB3Threads * kSelectRows;
  const long long steps = (span + kStep - 1) / kStep;
  uint32_t mg = 0, mh = 0;
  long long written = 0;
  for (long long s = 0; s < steps; ++s) {
    const long long r0 = lo + s * kStep + (long long)threadIdx.x * kSelectRows;
    float m[kSelectRows], g[kSelectRows], h[kSelectRows];
    const bool whole = kVec && r0 + kSelectRows <= hi;
    if (whole) {
      const float4 m4 = __ldg(reinterpret_cast<const float4*>(member + r0));
      m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
      if (leaf_id != nullptr) {
        const int4 l4 = __ldg(reinterpret_cast<const int4*>(leaf_id + r0));
        if (l4.x != leaf) m[0] = 0.0f;
        if (l4.y != leaf) m[1] = 0.0f;
        if (l4.z != leaf) m[2] = 0.0f;
        if (l4.w != leaf) m[3] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSelectRows; ++j) {
        const long long r = r0 + j;
        m[j] = r < hi ? __ldg(member + r) : 0.0f;
        if (r < hi && leaf_id != nullptr && __ldg(leaf_id + r) != leaf)
          m[j] = 0.0f;
      }
    }
    unsigned n = 0;
#pragma unroll
    for (int j = 0; j < kSelectRows; ++j) n += m[j] != 0.0f ? 1u : 0u;
    if (n != 0u) {
      if (whole) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad + r0));
        const float4 h4 = __ldg(reinterpret_cast<const float4*>(hess + r0));
        g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
        h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
      } else {
#pragma unroll
        for (int j = 0; j < kSelectRows; ++j) {
          g[j] = m[j] != 0.0f ? __ldg(grad + r0 + j) : 0.0f;
          h[j] = m[j] != 0.0f ? __ldg(hess + r0 + j) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kSelectRows; ++j) {
        if (m[j] == 0.0f) continue;
        if (!premultiplied) {
          g[j] = __fmul_rn(g[j], m[j]);
          h[j] = __fmul_rn(h[j], m[j]);
        }
        mg = max(mg, abs_bits(g[j]));
        mh = max(mh, abs_bits(h[j]));
      }
    }
    unsigned total;
    long long pos = lo + written + block_scan(n, s_sums, &total);
#pragma unroll
    for (int j = 0; j < kSelectRows; ++j) {
      if (m[j] == 0.0f) continue;
      list_idx[pos] = (int)(r0 + j);
      list_g[pos] = g[j];
      list_h[pos] = h[j];
      ++pos;
    }
    written += total;
  }
  mg = block_max(mg, s_red[0]);
  mh = block_max(mh, s_red[1]);
  if (threadIdx.x == 0) {
    st->count[blockIdx.x] = written;
    atomicMax(&st->max_bits[0], mg);
    atomicMax(&st->max_bits[1], mh);
    __threadfence();
    s_last = atomicAdd(&st->arrivals, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x >= 32) return;
  __threadfence();
  // the last block's first warp: the segments' prefix (a lane a run of
  // consecutive segments, then a warp scan), then lane 0 the state
  const int lane = threadIdx.x;
  const int nseg = (int)gridDim.x;
  const int run = (nseg + 31) / 32;
  long long mine = 0;
  for (int i = 0; i < run; ++i) {
    const int b = lane * run + i;
    if (b < nseg) mine += __ldcg(&st->count[b]);
  }
  long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  long long acc = incl - mine;
  for (int i = 0; i < run; ++i) {
    const int b = lane * run + i;
    if (b >= nseg) break;
    st->prefix[b] = acc;
    acc += __ldcg(&st->count[b]);
  }
  const long long members = __shfl_sync(0xffffffffu, incl, 31);
  if (lane != 0) return;
  st->prefix[nseg] = members;
  const uint32_t gb = atomicAdd(&st->max_bits[0], 0u);
  const uint32_t hb = atomicAdd(&st->max_bits[1], 0u);
  float sg, sh;
  if (given_scales != nullptr) {
    sg = given_scales[0];
    sh = given_scales[1];
  } else {
    sg = b3_scale(gb, npad);
    sh = b3_scale(hb, npad);
  }
  // the largest |q| of the call, rounded as the rows round
  const double qg = rint((double)__uint_as_float(gb) * (double)sg);
  const double qh = rint((double)__uint_as_float(hb) * (double)sh);
  int kbits, interval;
  b3_interval(qg != qg || qh != qh ? 1e19 : fmax(qg, qh), &kbits,
              &interval);
  st->scale[0] = sg;
  st->scale[1] = sh;
  st->kbits = kbits;
  st->interval = interval;
  st->members = members;
  st->per = per;
  st->nseg = nseg;
  st->max_bits[0] = 0u;
  st->max_bits[1] = 0u;
  st->arrivals = 0u;
}

// Renormalise this thread's words k = threadIdx.x + j * blockDim.x: each
// channel's low carry into its high word, the high word's bits from 32 - k
// up into the thread's top word (wrapping: only the sum modulo 2^64 is
// kept), leaving low < 2^k and high in [0, 2^(32-k)).  A cell's sum is lo
// + hi * 2^k + top * 2^32 modulo 2^64 before and after.
__device__ __forceinline__ void b3_renorm(unsigned* planes, int words,
                                          int kbits, unsigned* top_g,
                                          unsigned* top_h) {
  const unsigned lomask = (1u << kbits) - 1u;
  const int m = 32 - kbits;
  const unsigned himask = (1u << m) - 1u;
#pragma unroll
  for (int j = 0; j < kMaxWordsPerThread; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    if (k >= words) break;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      unsigned* lo = planes + 2 * ch * words + k;
      const unsigned l = lo[0];
      const long long h = (long long)(int)lo[words] + (long long)(l >> kbits);
      lo[0] = l & lomask;
      lo[words] = (unsigned)h & himask;
      (ch == 0 ? top_g : top_h)[j] += (unsigned)(int)(h >> m);
    }
  }
}

// Pass 2.  Block i: tile i % tiles of tile_cols columns, slice i / tiles
// of the member list (of `used` slices); rows [npad, row_stride] the
// row-major bins.  kGlobal: one tile of every column, rows adding into
// the i64 scratch.  A thread takes one listed row a step; the next step's
// list entry loads while this step's adds run.
template <typename BinT, bool kGlobal>
__global__ void __launch_bounds__(kB3Threads, 1)
chunked_hist_kernel(const BinT* __restrict__ rows, int row_stride,
                    int num_cols, int num_bins, int tile_cols, int copies,
                    int parts, const B3State* __restrict__ st,
                    const int* __restrict__ list_idx,
                    const float* __restrict__ list_g,
                    const float* __restrict__ list_h,
                    unsigned long long* __restrict__ acc,
                    unsigned int* __restrict__ arrivals,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int tiles = (num_cols + tile_cols - 1) / tile_cols;
  const int tile = (int)(blockIdx.x % tiles);
  const int part = (int)(blockIdx.x / tiles);
  const int c0 = tile * tile_cols;
  const int c1 = min(c0 + tile_cols, num_cols);
  const long long members = st->members;
  const int cells = (c1 - c0) * num_bins;
  int used = parts;
  if (!kGlobal) {
    // enough rows a slice to add into each of its cells (each copy)
    // kRowsPerCellPart times a column
    const long long want =
        members / ((long long)kRowsPerCellPart * num_bins * copies);
    used = (int)max(1ll, min((long long)parts, want));
  }
  if (part >= used) return;
  const long long e0 = members * part / used;
  const long long e1 = members * (part + 1) / used;
  const int words = cells * copies;
  unsigned* planes = reinterpret_cast<unsigned*>(smem_raw);
  unsigned top_g[kMaxWordsPerThread], top_h[kMaxWordsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxWordsPerThread; ++j) top_g[j] = top_h[j] = 0u;
  if (!kGlobal) {
    for (int k = threadIdx.x; k < kPlanes * words; k += blockDim.x)
      planes[k] = 0u;
    __syncthreads();
  }
  const double sg = (double)st->scale[0], sh = (double)st->scale[1];
  const int kbits = st->kbits;
  const int interval = max(st->interval, 1);
  const int step = kGlobal ? kB3Threads : min(kB3Threads, interval);
  const long long per = st->per;
  const int nseg = st->nseg;
  const long long* prefix = st->prefix;
  const unsigned lomask = (1u << kbits) - 1u;
  const int copy = (int)(threadIdx.x & 31) & (copies - 1);
  const bool lane_on = (int)threadIdx.x < step;
  constexpr int kPerLoad = 16 / (int)sizeof(BinT);
  // the segment of this thread's first entry: the last s with prefix[s]
  // <= e (entries only grow, so later steps walk on from it)
  int seg = 0;
  {
    const long long e = e0 + threadIdx.x;
    int a = 0, b = nseg - 1;
    while (a < b) {
      const int mid = (a + b + 1) / 2;
      if (__ldg(prefix + mid) <= e) a = mid; else b = mid - 1;
    }
    seg = a;
  }
  // entry e's row (-1 past the slice) and values
  auto fetch = [&](long long e, int* row, float* g, float* h) {
    *row = -1;
    if (!lane_on || e >= e1) return;
    while (seg + 1 < nseg && e >= __ldg(prefix + seg + 1)) ++seg;
    const long long pos = seg * per + (e - __ldg(prefix + seg));
    *row = __ldg(list_idx + pos);
    *g = __ldg(list_g + pos);
    *h = __ldg(list_h + pos);
  };
  int row;
  float gv = 0.0f, hv = 0.0f;
  fetch(e0 + threadIdx.x, &row, &gv, &hv);
  long long since = 0;
  for (long long base = e0; base < e1; base += step) {
    if (!kGlobal && since + step > interval) {
      __syncthreads();
      b3_renorm(planes, words, kbits, top_g, top_h);
      __syncthreads();
      since = 0;
    }
    since += step;
    int nrow;
    float ngv = 0.0f, nhv = 0.0f;
    fetch(base + step + threadIdx.x, &nrow, &ngv, &nhv);
    if (row >= 0) {
      const long long qg = __double2ll_rn((double)gv * sg);
      const long long qh = __double2ll_rn((double)hv * sh);
      const unsigned a0 = (unsigned)qg & lomask;
      const unsigned a1 = (unsigned)(int)(qg >> kbits);
      const unsigned a2 = (unsigned)qh & lomask;
      const unsigned a3 = (unsigned)(int)(qh >> kbits);
      const uint4* vp = reinterpret_cast<const uint4*>(
          rows + (long long)row * row_stride);
      int j = c0 / kPerLoad;
      uint4 next = __ldg(vp + j);
      for (; j * kPerLoad < c1; ++j) {
        const uint4 cur = next;
        if ((j + 1) * kPerLoad < c1) next = __ldg(vp + j + 1);
        const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
        for (int i = 0; i < kPerLoad; ++i) {
          const int c = j * kPerLoad + i;
          if (c < c0 || c >= c1) continue;
          const int b = sizeof(BinT) == 1
              ? (int)((w[i >> 2] >> ((i & 3) * 8)) & 0xFFu)
              : (int)((w[i >> 1] >> ((i & 1) * 16)) & 0xFFFFu);
          // the JAX one-hot drops a bin >= num_bins
          if (b >= num_bins) continue;
          if (kGlobal) {
            unsigned long long* d = acc + 3 * ((long long)c * num_bins + b);
            atomicAdd(d, (unsigned long long)qg);
            atomicAdd(d + 1, (unsigned long long)qh);
            atomicAdd(d + 2, 1ull);
          } else {
            const int k = ((c - c0) * num_bins + b) * copies + copy;
            atomicAdd(planes + k, a0);
            atomicAdd(planes + words + k, a1);
            atomicAdd(planes + 2 * words + k, a2);
            atomicAdd(planes + 3 * words + k, a3);
            atomicAdd(planes + 4 * words + k, 1u);
          }
        }
      }
    }
    row = nrow;
    gv = ngv;
    hv = nhv;
  }
  unsigned long long* tile_acc = acc + 3ll * c0 * num_bins;
  if (!kGlobal) {
    // a last renormalisation, then each word's low 32 bits (lo + hi * 2^k
    // < 2^32) into its low plane and its top word into its high plane
    __syncthreads();
    b3_renorm(planes, words, kbits, top_g, top_h);
#pragma unroll
    for (int j = 0; j < kMaxWordsPerThread; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      if (k >= words) break;
      planes[k] += planes[words + k] << kbits;
      planes[words + k] = top_g[j];
      planes[2 * words + k] += planes[3 * words + k] << kbits;
      planes[3 * words + k] = top_h[j];
    }
    __syncthreads();
    for (int cell = threadIdx.x; cell < cells; cell += blockDim.x) {
      unsigned long long gsum = 0ull, hsum = 0ull;
      unsigned n = 0u;
      for (int cp = 0; cp < copies; ++cp) {
        const int k = cell * copies + cp;
        n += planes[4 * words + k];
        gsum += (unsigned long long)planes[k]
            + ((unsigned long long)planes[words + k] << 32);
        hsum += (unsigned long long)planes[2 * words + k]
            + ((unsigned long long)planes[3 * words + k] << 32);
      }
      if (n == 0u) continue;
      atomicAdd(tile_acc + 3 * cell, gsum);
      atomicAdd(tile_acc + 3 * cell + 1, hsum);
      atomicAdd(tile_acc + 3 * cell + 2, (unsigned long long)n);
    }
  }
  // the last block of the tile to arrive sees every block's adds
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + tile, 1u) == (unsigned)used - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* tile_out = out + 3ll * c0 * num_bins;
  for (long long k = threadIdx.x; k < cells; k += blockDim.x) {
    const long long s0 = (long long)__ldcg(tile_acc + 3 * k);
    const long long s1 = (long long)__ldcg(tile_acc + 3 * k + 1);
    const long long s2 = (long long)__ldcg(tile_acc + 3 * k + 2);
    tile_out[3 * k] = (float)((double)s0 / sg);
    tile_out[3 * k + 1] = (float)((double)s1 / sh);
    tile_out[3 * k + 2] = (float)s2;
    tile_acc[3 * k] = 0ull;
    tile_acc[3 * k + 1] = 0ull;
    tile_acc[3 * k + 2] = 0ull;
  }
  if (threadIdx.x == 0) arrivals[tile] = 0u;
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

bool b3_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

template <typename BinT, bool kGlobal>
int launch_chunked(const void* rows, int row_stride, int num_cols,
                   int num_bins, const int* tiling, const B3State* st,
                   const int* list, long long npad, unsigned long long* acc,
                   unsigned int* arrivals, float* out, cudaStream_t s) {
  static bool opted_in = false;
  if (!kGlobal && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_hist_kernel<BinT, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, b3_smem_budget());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int tiles = tiling[4];
  // one wave: a block an SM, the SMs shared out over the tiles
  const int parts = (int)(b3_sm_count() / tiles > 1 ? b3_sm_count() / tiles
                                                    : 1);
  const float* lg = reinterpret_cast<const float*>(list + npad);
  const float* lh = reinterpret_cast<const float*>(list + 2 * npad);
  chunked_hist_kernel<BinT, kGlobal>
      <<<(unsigned)(parts * tiles), kB3Threads, (size_t)tiling[1], s>>>(
          static_cast<const BinT*>(rows), row_stride, num_cols, num_bins,
          tiling[0], tiling[3], parts, st, list, lg, lh, acc, arrivals,
          out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3's tiling: out[0] columns a tile, out[1] dynamic shared memory a
// block (bytes), out[2] 1 where no column fits a block (the global-atomic
// mode, one tile of every column), out[3] copies of the planes, out[4]
// column tiles.  As many columns as fit the budget, spread evenly over the
// fewest tiles; then as many copies (a power of two up to kMaxCopies) as
// still fit.  Returns 0, or cudaErrorInvalidValue on an empty shape.
int lgbt_chunked_tiling(int num_cols, int num_bins, int* out) {
  if (num_cols < 1 || num_bins < 1) return (int)cudaErrorInvalidValue;
  const long long per_col = (long long)num_bins * kCellBytes;
  // a thread renormalises at most kMaxWordsPerThread words
  long long budget = b3_smem_budget();
  if (budget > (long long)kMaxWordsPerThread * kB3Threads * kCellBytes)
    budget = (long long)kMaxWordsPerThread * kB3Threads * kCellBytes;
  long long most = budget / per_col;
  if (most < 1) {
    out[0] = num_cols;
    out[1] = 0;
    out[2] = 1;
    out[3] = 1;
    out[4] = 1;
    return 0;
  }
  if (most > num_cols) most = num_cols;
  const long long tc = b3_div_up(num_cols, b3_div_up(num_cols, most));
  int copies = 1;
  while (copies * 2 <= kMaxCopies && tc * per_col * copies * 2 <= budget)
    copies *= 2;
  out[0] = (int)tc;
  out[1] = (int)(tc * per_col * copies);
  out[2] = 0;
  out[3] = copies;
  out[4] = (int)b3_div_up(num_cols, tc);
  return 0;
}

// Pass 1, one kernel launch and no other operation on the stream.  grad,
// hess, member [npad] f32 (premultiplied != 0: the channels grad * m, hess
// * m and m of a w3); leaf_id [npad] int32 or null (the root: every row
// with member != 0); scales: [2] f32 on the device, or null to compute
// channel_scales' rule on the card; state: 2,048 int64 words, zero at
// first use, left for pass 2; list: [3, npad] words (row, g * m, h * m).
// Returns a CUDA error code (0 on success).
int lgbt_chunked_select(const float* grad, const float* hess,
                        const float* member, const int* leaf_id, int leaf,
                        int premultiplied, long long npad,
                        const float* scales, long long* state, int* list,
                        void* stream) {
  if (npad < 0 || npad > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  long long nseg = b3_div_up(npad, (long long)kB3Threads * kSelectRows);
  const long long most = 2ll * b3_sm_count();
  if (nseg > most) nseg = most;
  if (nseg > kMaxSegments) nseg = kMaxSegments;
  if (nseg < 1) nseg = 1;
  const long long per = b3_div_up(b3_div_up(npad, nseg), kSelectRows)
      * kSelectRows;
  auto* st = reinterpret_cast<B3State*>(state);
  float* lg = reinterpret_cast<float*>(list + npad);
  float* lh = reinterpret_cast<float*>(list + 2 * npad);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = b3_aligned(grad) && b3_aligned(hess)
      && b3_aligned(member) && (leaf_id == nullptr || b3_aligned(leaf_id));
  if (vec)
    chunked_select_kernel<true><<<(unsigned)nseg, kB3Threads, 0, s>>>(
        grad, hess, member, leaf_id, leaf, premultiplied, npad, per, scales,
        st, list, lg, lh);
  else
    chunked_select_kernel<false><<<(unsigned)nseg, kB3Threads, 0, s>>>(
        grad, hess, member, leaf_id, leaf, premultiplied, npad, per, scales,
        st, list, lg, lh);
  return (int)cudaGetLastError();
}

// Pass 2, one kernel launch and no other operation on the stream.  rows
// [npad, row_stride] of bin_bytes 1 (u8) or 2 (u16): the row-major bins,
// row_stride a multiple of 16 bytes; state and list as pass 1 left them;
// scratch = the wrapper's persistent i64 buffer, all zero, of num_cols *
// num_bins * 3 words plus one u32 a column tile, left all zero; out
// [num_cols, num_bins, 3] f32.  Returns a CUDA error code (0 on success).
int lgbt_histogram_chunked(const void* rows, int bin_bytes, int row_stride,
                           long long npad, int num_cols, int num_bins,
                           const long long* state, const int* list,
                           long long* scratch, float* out, void* stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) || npad < 0 || num_bins > 65536
      || row_stride < num_cols || (row_stride * bin_bytes) % 16 != 0
      || !b3_aligned(rows))
    return (int)cudaErrorInvalidValue;
  int tiling[5];
  const int rc = lgbt_chunked_tiling(num_cols, num_bins, tiling);
  if (rc != 0) return rc;
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* arrivals = reinterpret_cast<unsigned int*>(
      scratch + 3ll * num_cols * num_bins);
  const auto* st = reinterpret_cast<const B3State*>(state);
  cudaStream_t s = (cudaStream_t)stream;
  if (tiling[2] != 0)
    return bin_bytes == 1
        ? launch_chunked<uint8_t, true>(rows, row_stride, num_cols, num_bins,
                                        tiling, st, list, npad, acc,
                                        arrivals, out, s)
        : launch_chunked<uint16_t, true>(rows, row_stride, num_cols,
                                         num_bins, tiling, st, list, npad,
                                         acc, arrivals, out, s);
  return bin_bytes == 1
      ? launch_chunked<uint8_t, false>(rows, row_stride, num_cols, num_bins,
                                       tiling, st, list, npad, acc,
                                       arrivals, out, s)
      : launch_chunked<uint16_t, false>(rows, row_stride, num_cols, num_bins,
                                        tiling, st, list, npad, acc,
                                        arrivals, out, s);
}

}  // extern "C"
