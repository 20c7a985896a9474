#!/usr/bin/env python3
"""Candidate designs of the segment histogram body (K1 histogram_segment,
K3 histogram_segment_routed: ``segment_window_kernel`` in
lightgbm_tpu_torch/csrc/histogram.cu), side by side on one NVIDIA card.

    python3 tools/segment_candidates.py [--reps N] [--out FILE]

Builds the shipped source and each candidate derived from it by a textual
change, prints each build's ptxas registers and spills and its atomic SASS
opcodes, checks that every candidate gives the shipped kernel's histograms
and leaf ids bit for bit, and times each call of these shapes:

  * ``higgs_root``   K1 over 10,502,144 rows x 28 features x 64 bins, every
                     row in the target (the unfused path's root);
  * ``higgs_root_null``  the same through K3 with the null route (the
                     fused path's root);
  * ``higgs_split``  K3, a numeric split of the root, the half that moves as
                     the target;
  * ``late_split``   K3 over a window of 3 row blocks (24,576 rows) of that
                     layout, a split that moves about a fifth of them, the
                     moved rows as the target;
  * ``mc_root``      K1 over 1,007,616 rows x 28 features x 256 bins;
  * ``mc_split``     K3, a categorical split of that root.

Candidates:

  * ``prefetch``     the shipped design: each warp adds 32 queued rows, a
                     row a lane, every lane the same feature at once into a
                     feature-major histogram, four features at a time while
                     the next four features' bins load from device memory;
  * ``no_prefetch``  four features' bins loaded, then their adds (K6/K7's
                     add loop);
  * ``prefetch2``    the bins of the next eight features in flight;
  * ``eight_prefetch``  eight features at a time, the next eight's bins
                     loading while these add;
  * ``hi_behind``    a group's high-word adds issued after the next
                     group's low adds, not right after its own;
  * ``prefetch_ids`` the next step's leaf id, split bin and member loaded
                     while this step's rows add;
  * ``eight``        eight features' bins loaded, then their adds;
  * ``stage``        each lane's bins of 32 features staged in shared memory
                     first (coalesced loads), then added;
  * ``rotate``       ``stage``, lane l adding feature slot (j + l) mod 32 at
                     step j into a bin-major histogram whose rows are 32
                     features wide: a warp's 32 adds fall in 32 banks;
  * ``replicas4``    ``stage`` with four copies of the histogram, warp w
                     adding to copy w mod 4, the flush summing them;
  * ``min_rows_4k``  the shipped body, a block walking at least 4,096 rows
                     of the window (one 1,024-row step shipped);
  * ``k6_body``      the frontier kernel (K6, and K7 for K3) unchanged,
                     called with one target slot over the window's blocks;
  * ``no_hi``, ``count_only``  diagnostics, not exact and not checked: the
                     shipped body without the two high-word adds (three
                     shared atomics a pair), or with the count alone (one).

``stage``, ``rotate`` and ``replicas4`` replace the shipped kernel and its
tiling with EXPLORE_KERNEL and EXPLORE_TILING below.

Each call is timed with CUDA events around the replay of a CUDA graph of
N calls (default 20; the device's time, with no host between calls), each
on its own copy of the leaf ids, in turns: shipped, candidate, candidate,
shipped.  Inputs are made on the card from a seed.  Needs a card and nvcc;
prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc", "histogram.cu")

# the shipped kernel's span in histogram.cu, which EXPLORE replaces
_KERNEL_FROM = "template <bool kRouted>\n__device__ __forceinline__ void" \
               "\nsegment_window("
_KERNEL_TO = "// K1's and K3's kernels: the window, target and route"
_TILING_FROM = "int lgbt_segment_tiling(int num_features, int num_bins, " \
               "int* out) {"
_TILING_TO = "// K1 (route == NULL) or K3 (route = host pointer to 19 ints)"

# the candidates that stage a chunk of 32 features' bins of each lane's row
# in shared memory (36 bytes a lane, so the lanes' stores fall in 32
# banks) before adding them: every lane the same feature at a step, or
# (@ROTATE@) lane l feature slot (j + l) mod 32 at step j into a bin-major
# histogram whose rows are 32 features wide, so a slot is a bank; warp w
# adds to copy w mod @REPLICAS@ of the histogram, and the flush sums them
EXPLORE_KERNEL = r"""template <bool kRouted>
__device__ __forceinline__ void
segment_window(const uint8_t* __restrict__ bins,
               const uint16_t* __restrict__ w8, int* leaf_id,
               long long npad, int num_features, int num_bins,
               int tile_features, long long row_lo, long long row_hi,
               int target, const float* __restrict__ scales,
               const RouteDesc& route, unsigned long long* __restrict__ acc,
               unsigned int* __restrict__ arrivals,
               float* __restrict__ out) {
  constexpr bool kRotate = @ROTATE@;
  constexpr int kReplicas = @REPLICAS@;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  const int f0 = blockIdx.y * tile_features;
  const int nf = min(tile_features, num_features - f0);
  const int rw = kRotate ? (nf + 31) / 32 * 32 : nf;
  const int cells = rw * num_bins;
  const unsigned lane = threadIdx.x & 31u;
  int* q_row = reinterpret_cast<int*>(smem_raw) + 2 * (threadIdx.x - lane);
  unsigned char* stage = smem_raw + kSegQueueBytes + threadIdx.x * 36;
  unsigned* planes = reinterpret_cast<unsigned*>(
      smem_raw + kSegQueueBytes + 36 * kSegThreads);
  for (int k = threadIdx.x; k < 5 * kReplicas * cells; k += blockDim.x)
    planes[k] = 0u;
  unsigned* g_lo = planes + ((threadIdx.x >> 5) % kReplicas) * 5 * cells;
  unsigned* g_hi = g_lo + cells;
  unsigned* h_lo = g_hi + cells;
  unsigned* h_hi = h_lo + cells;
  unsigned* cnt = h_hi + cells;
  __syncthreads();

  const double scale_g = (double)scales[0];
  const double scale_h = (double)scales[1];
  const uint8_t* tile = bins + (long long)f0 * npad;
  auto add_rows = [&](int n) {
    const bool active = (int)lane < n;
    const long long row = active ? q_row[lane] : 0;
    unsigned glo = 0u, ghi = 0u, hlo = 0u, hhi = 0u;
    if (active) {
      const unsigned long long qg = (unsigned long long)__double2ll_rn(
          (bf16_bits_to_double(w8[row]) + bf16_bits_to_double(w8[npad + row]))
          * scale_g);
      const unsigned long long qh = (unsigned long long)__double2ll_rn(
          (bf16_bits_to_double(w8[2 * npad + row])
           + bf16_bits_to_double(w8[3 * npad + row])) * scale_h);
      glo = (unsigned)qg;
      ghi = (unsigned)(qg >> 32);
      hlo = (unsigned)qh;
      hhi = (unsigned)(qh >> 32);
    }
    for (int c0 = 0; c0 < nf; c0 += 32) {
      const int cw = min(32, nf - c0);
      if (active) {
        const uint8_t* brow = tile + (long long)c0 * npad + row;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          unsigned word = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (4 * w + k < cw)
              word |= (unsigned)brow[(long long)(4 * w + k) * npad]
                      << (8 * k);
          }
          if (4 * w < cw) reinterpret_cast<unsigned*>(stage)[w] = word;
        }
      }
      __syncwarp();
      if (active) {
        const int steps = kRotate ? 32 : cw;
        for (int j = 0; j < steps; j += 4) {
          int k[4];
          unsigned og[4], oh[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int s = kRotate ? (j + u + (int)lane) & 31 : j + u;
            k[u] = -1;
            if (s < cw) {
              const int b = stage[s];
              if (b < num_bins)
                k[u] = kRotate ? b * rw + c0 + s : (c0 + s) * num_bins + b;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (k[u] < 0) continue;
            og[u] = atomicAdd(g_lo + k[u], glo);
            oh[u] = atomicAdd(h_lo + k[u], hlo);
            atomicAdd(cnt + k[u], 1u);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (k[u] < 0) continue;
            atomicAdd(g_hi + k[u], ghi + carry_of(og[u], glo));
            atomicAdd(h_hi + k[u], hhi + carry_of(oh[u], hlo));
          }
        }
      }
      __syncwarp();
    }
  };

  const uint8_t* frow = bins + (long long)route.w[2] * npad;
  const bool writer = blockIdx.y == 0;
  int queued = 0;
  const long long n_steps = (row_hi - row_lo + kSegThreads - 1) / kSegThreads;
  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long row = row_lo + c * kSegThreads + threadIdx.x;
    bool match = false;
    if (row < row_hi) {
      int lid = leaf_id[row];
      if (kRouted) {
        const int moved = routed_leaf(route, frow[row], lid);
        if (moved != lid && writer) leaf_id[row] = moved;
        lid = moved;
      }
      match = lid == target && w8[4 * npad + row] != 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, match);
    if (match) q_row[queued + __popc(m & ((1u << lane) - 1u))] = (int)row;
    queued += __popc(m);
    __syncwarp();
    if (queued >= 32) {
      add_rows(32);
      queued -= 32;
      if ((int)lane < queued) q_row[lane] = q_row[32 + lane];
      __syncwarp();
    }
  }
  add_rows(queued);
  __syncthreads();

  const long long tile_base = (long long)f0 * num_bins;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int f = kRotate ? k % rw : k / num_bins;
    const int b = kRotate ? k / rw : k % num_bins;
    if (f >= nf) continue;
    unsigned long long g = 0ull, h = 0ull, c = 0ull;
#pragma unroll
    for (int r = 0; r < kReplicas; ++r) {
      const unsigned* p = planes + r * 5 * cells;
      g += ((unsigned long long)p[cells + k] << 32) | p[k];
      h += ((unsigned long long)p[3 * cells + k] << 32) | p[2 * cells + k];
      c += p[4 * cells + k];
    }
    if (c == 0ull) continue;
    unsigned long long* dst = acc + 3 * (tile_base + (long long)f * num_bins
                                         + b);
    atomicAdd(dst + 0, g);
    atomicAdd(dst + 1, h);
    atomicAdd(dst + 2, c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < nf * num_bins; k += blockDim.x) {
    const long long cell = tile_base + k;
    const long long a0 = (long long)__ldcg(acc + 3 * cell);
    const long long a1 = (long long)__ldcg(acc + 3 * cell + 1);
    const long long a2 = (long long)__ldcg(acc + 3 * cell + 2);
    out[3 * cell + 0] = (float)((double)a0 / (double)scales[0]);
    out[3 * cell + 1] = (float)((double)a1 / (double)scales[1]);
    out[3 * cell + 2] = (float)a2;
    acc[3 * cell] = acc[3 * cell + 1] = acc[3 * cell + 2] = 0ull;
  }
  if (threadIdx.x == 0) arrivals[blockIdx.y] = 0u;
}

"""
# EXPLORE_KERNEL's tiling: the stages beside the queues, @REPLICAS@
# copies a feature, and with @ROTATE@ 32-feature rows
EXPLORE_TILING = r"""int lgbt_segment_tiling(int num_features, int num_bins, int* out) {
  const long long per_feature = (long long)num_bins * kSegCellBytes
                                * @REPLICAS@;
  const long long budget = frontier_smem_budget() - kSegQueueBytes
                           - 36 * kSegThreads;
  if (num_features < 1 || num_bins < 1 || budget < per_feature)
    return (int)cudaErrorInvalidValue;
  long long most = budget / per_feature;
  if (@ROTATE@) {
    if (most < 32) return (int)cudaErrorInvalidValue;
    most = most / 32 * 32;
  }
  if (most > num_features) most = num_features;
  const int ft = (int)div_up(num_features, div_up(num_features, most));
  const int rw = @ROTATE@ ? (int)div_up(ft, 32) * 32 : ft;
  out[0] = ft;
  out[1] = (int)(kSegQueueBytes + 36 * kSegThreads + rw * per_feature);
  return 0;
}

"""


def _explore(rotate: bool, replicas: int):
    def fill(t):
        return (t.replace("@ROTATE@", "true" if rotate else "false")
                .replace("@REPLICAS@", str(replicas)))
    return [(("SPAN", _KERNEL_FROM, _KERNEL_TO), fill(EXPLORE_KERNEL)),
            (("SPAN", _TILING_FROM, _TILING_TO), fill(EXPLORE_TILING))]


# the shipped add loop: the next four features' bins load while these add
_LOOP = """    // past the tile, a bin of num_bins: no cell
    int nb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nb[j] = j < nf ? brow[(long long)j * npad] : num_bins;
    for (int f = 0; f < nf; f += 4) {
      int k[4];
      unsigned og[4], oh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the TPU one-hot drops bins >= num_bins too
        k[j] = nb[j] < num_bins ? (f + j) * num_bins + nb[j] : -1;
        nb[j] = f + 4 + j < nf ? brow[(long long)(f + 4 + j) * npad]
                               : num_bins;
      }
"""
# the shipped loop's adds: the low adds, then the high adds that wait on
# their returns
_LO_HI = """#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k[j] < 0) continue;
        og[j] = atomicAdd(g_lo + k[j], glo);
        oh[j] = atomicAdd(h_lo + k[j], hlo);
        atomicAdd(cnt + k[j], 1u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k[j] < 0) continue;
        atomicAdd(g_hi + k[j], ghi + carry_of(og[j], glo));
        atomicAdd(h_hi + k[j], hhi + carry_of(oh[j], hlo));
      }
    }
"""
# hi_behind: a group's high adds issued after the next group's low adds,
# so their wait on the low adds' returns overlaps other work
_HI_BEHIND = """#pragma unroll
      for (int j = 0; j < 4; ++j) {
        og[j] = oh[j] = 0u;
        if (k[j] < 0) continue;
        og[j] = atomicAdd(g_lo + k[j], glo);
        oh[j] = atomicAdd(h_lo + k[j], hlo);
        atomicAdd(cnt + k[j], 1u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pk[j] >= 0) {
          atomicAdd(g_hi + pk[j], ghi + carry_of(pg[j], glo));
          atomicAdd(h_hi + pk[j], hhi + carry_of(ph[j], hlo));
        }
        pk[j] = k[j];
        pg[j] = og[j];
        ph[j] = oh[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (pk[j] < 0) continue;
      atomicAdd(g_hi + pk[j], ghi + carry_of(pg[j], glo));
      atomicAdd(h_hi + pk[j], hhi + carry_of(ph[j], hlo));
    }
"""
_HI_BEHIND_INIT = ("    int nb[4];\n",
                   "    int nb[4], pk[4] = {-1, -1, -1, -1};\n"
                   "    unsigned pg[4], ph[4];\n")
# no_prefetch (K6/K7's add loop): four features' bins loaded, then their
# adds
_NO_PREFETCH = """    for (int f = 0; f < nf; f += 4) {
      int k[4];
      unsigned og[4], oh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[j] = -1;
        if (f + j < nf) {
          const int b = brow[(long long)(f + j) * npad];
          if (b < num_bins) k[j] = (f + j) * num_bins + b;
        }
      }
"""
# prefetch2: the bins of the eight features after these in flight
_PREFETCH2 = """    int nb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      nb[j] = j < nf ? brow[(long long)j * npad] : num_bins;
    for (int f = 0; f < nf; f += 4) {
      int k[4];
      unsigned og[4], oh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[j] = nb[j] < num_bins ? (f + j) * num_bins + nb[j] : -1;
        nb[j] = nb[4 + j];
        nb[4 + j] = f + 8 + j < nf ? brow[(long long)(f + 8 + j) * npad]
                                   : num_bins;
      }
"""
_ADDS = """#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k[j] < 0) continue;
        og[j] = atomicAdd(g_lo + k[j], glo);
        oh[j] = atomicAdd(h_lo + k[j], hlo);
        atomicAdd(cnt + k[j], 1u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
"""
_HI_ADDS = """        atomicAdd(g_hi + k[j], ghi + carry_of(og[j], glo));
        atomicAdd(h_hi + k[j], hhi + carry_of(oh[j], hlo));
"""
_LO_ADDS = """        og[j] = atomicAdd(g_lo + k[j], glo);
        oh[j] = atomicAdd(h_lo + k[j], hlo);
"""
# prefetch_ids: the next step's leaf id, split bin and member load while
# this step's rows add
_STEP = """  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long row = row_lo + c * kSegThreads + threadIdx.x;
    bool match = false;
    if (row < row_hi) {
      int lid = leaf_id[row];
      if (kRouted) {
        const int moved = routed_leaf(route, frow[row], lid);
"""
_STEP_PREFETCH = """  const long long stride = (long long)gridDim.x * kSegThreads;
  long long next = row_lo + (long long)blockIdx.x * kSegThreads
                   + threadIdx.x;
  int n_lid = 0, n_bin = 0;
  bool n_member = false;
  if (next < row_hi) {
    n_lid = leaf_id[next];
    n_bin = frow[next];
    n_member = w8[4 * npad + next] != 0;
  }
  for (long long c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const long long row = next;
    int lid = n_lid;
    const int bin = n_bin;
    const bool member = n_member;
    next += stride;
    if (next < row_hi) {
      n_lid = leaf_id[next];
      n_bin = frow[next];
      n_member = w8[4 * npad + next] != 0;
    }
    bool match = false;
    if (row < row_hi) {
      if (kRouted) {
        const int moved = routed_leaf(route, bin, lid);
"""
_MEMBER = "      match = lid == target && w8[4 * npad + row] != 0;\n"
_MIN_ROWS = "constexpr int kSegMinRows = kSegThreads;"
CANDIDATES = {
    "prefetch": [],
    "no_prefetch": [(("KERNEL", _LOOP), _NO_PREFETCH)],
    "prefetch2": [(("KERNEL", _LOOP), _PREFETCH2)],
    "eight_prefetch": [(("KERNEL", _LOOP), _LOOP.replace("4", "8")),
                       (("KERNEL", _LO_HI), _LO_HI.replace("4", "8"))],
    "hi_behind": [(("KERNEL", _LO_HI), _HI_BEHIND),
                  (("KERNEL", _HI_BEHIND_INIT[0]), _HI_BEHIND_INIT[1])],
    "eight": [(("KERNEL", _LOOP), _NO_PREFETCH.replace("4", "8")),
              (("KERNEL", _ADDS), _ADDS.replace("4", "8"))],
    "stage": _explore(False, 1),
    "rotate": _explore(True, 1),
    "replicas4": _explore(False, 4),
    "prefetch_ids": [(("KERNEL", _STEP), _STEP_PREFETCH),
                     (("KERNEL", _MEMBER),
                      "      match = lid == target && member;\n")],
    "min_rows_4k": [(_MIN_ROWS,
                     "constexpr int kSegMinRows = 4 * kSegThreads;")],
    # diagnostics, not exact: the shipped body with fewer shared atomics
    "no_hi": [(("KERNEL", _HI_ADDS), "        (void)og[j]; (void)oh[j];\n")],
    "count_only": [(("KERNEL", _HI_ADDS),
                    "        (void)og[j]; (void)oh[j];\n"),
                   (("KERNEL", _LO_ADDS), "        og[j] = oh[j] = 0u;\n")],
}
DIAGNOSTIC = ("no_hi", "count_only")


def _variant(text: str, edits) -> str:
    """The source with each edit made: ``old`` replaced where it occurs
    once; ("KERNEL", old) replaced wherever it occurs in the shipped
    kernel's span (at least once); ("SPAN", from, to) the span from
    ``from`` up to ``to`` replaced; "APPEND" appended."""
    for old, new in edits:
        if old == "APPEND":
            text += new
            continue
        if isinstance(old, tuple) and old[0] == "SPAN":
            a, b = text.find(old[1]), text.find(old[2])
            if a < 0 or b < a:
                raise SystemExit(f"span not found: {old[1][:60]}")
            text = text[:a] + new + text[b:]
            continue
        if isinstance(old, tuple):
            a, b = text.find(_KERNEL_FROM), text.find(_KERNEL_TO)
            body = text[a:b]
            if a < 0 or b < a or old[1] not in body:
                raise SystemExit(f"kernel edit does not match:\n{old[1]}")
            text = text[:a] + body.replace(old[1], new) + text[b:]
            continue
        if text.count(old) != 1:
            raise SystemExit(f"candidate edit does not match the source "
                             f"once:\n{old}")
        text = text.replace(old, new)
    return text


def _build(src_text: str, out_dir: str, name: str):
    """nvcc as ops/kernels.py builds, into one shared library; returns
    (path, ptxas output)."""
    from lightgbm_tpu_torch.ops import kernels
    cu = os.path.join(out_dir, name + ".cu")
    with open(cu, "w") as fh:
        fh.write(src_text)
    lib = os.path.join(out_dir, name + ".so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-o", lib, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


class _Lib:
    """One build of histogram.cu, called as ops/histogram.py calls K1/K3,
    with a zeroed scratch of its own."""

    def __init__(self, path, torch, dev):
        from lightgbm_tpu_torch.ops import kernels
        self.lib = ctypes.CDLL(path)
        self.entry = self.lib.lgbt_histogram_segment
        self.entry.argtypes = kernels._SIGNATURES["lgbt_histogram_segment"]
        self.entry.restype = ctypes.c_int
        self.lib.lgbt_segment_tiling.argtypes = kernels._SIGNATURES[
            "lgbt_segment_tiling"]
        self.lib.lgbt_segment_tiling.restype = ctypes.c_int
        self.torch = torch
        self.scratch = torch.zeros(1 << 20, dtype=torch.int64, device=dev)

    def tiling(self, F, B):
        out = (ctypes.c_int * 2)()
        rc = self.lib.lgbt_segment_tiling(F, B, ctypes.addressof(out))
        return list(out) if rc == 0 else None

    def call(self, binsT, w8, ids, lo, hi, target, route, B, scales):
        F, npad = binsT.shape
        out = self.torch.empty((F, B, 3), dtype=self.torch.float32,
                               device=binsT.device)
        rc = self.entry(
            binsT.data_ptr(), w8.data_ptr(), ids.data_ptr(), npad, F, B, lo,
            hi, target, scales.data_ptr(),
            None if route is None else route.data_ptr(),
            self.scratch.data_ptr(), out.data_ptr(),
            self.torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out


def _layout(torch, th, npad, F, B, seed, dev):
    """Bins uniform over B - 1 bins, gradients and hessians from a seed,
    every row a member."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    gen = torch.Generator(device=dev).manual_seed(seed)
    binsT = torch.randint(0, B - 1, (F, npad), generator=gen, device=dev,
                          dtype=torch.uint8)
    grad = torch.randn(npad, generator=gen, device=dev)
    hess = torch.rand(npad, generator=gen, device=dev) * 0.25
    w8 = th.pack_channels(grad, hess, torch.ones(npad, device=dev))
    fm = FeatureMeta(np.full(F, B - 1, np.int32), np.zeros(F, np.int32),
                     np.zeros(F, np.int32))
    return binsT, w8, th.fixed_point_scales(w8), fm


def _shapes(torch, th, dev):
    """(shape, (binsT, w8, scales, leaf ids, row_lo, row_hi, target, route
    or None, bins)), one layout at a time."""
    import numpy as np
    rb = 8192
    none = np.zeros(8, np.uint32)
    binsT, w8, scales, fm = _layout(torch, th, 1282 * rb, 28, 64, 3, dev)
    npad = binsT.shape[1]
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    split = th.pack_route(0, 1, 0, 31, False, False, none, fm)
    late = lid0.clone()
    late[500 * rb:503 * rb] = 7
    yield "higgs_root", (binsT, w8, scales, lid0, 0, npad, 0, None, 64)
    yield "higgs_root_null", (binsT, w8, scales, lid0, 0, npad, 0,
                              th.null_route(), 64)
    yield "higgs_split", (binsT, w8, scales, lid0, 0, npad, 1, split, 64)
    yield "late_split", (binsT, w8, scales, late, 500 * rb, 503 * rb, 8,
                         th.pack_route(7, 8, 3, 50, False, False, none, fm),
                         64)
    del binsT, w8, lid0, late
    torch.cuda.empty_cache()
    binsT, w8, scales, fm = _layout(torch, th, 123 * rb, 28, 256, 4, dev)
    npad = binsT.shape[1]
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    every_other = np.full(8, 0x55555555, np.uint32)
    yield "mc_root", (binsT, w8, scales, lid0, 0, npad, 0, None, 256)
    yield "mc_split", (binsT, w8, scales, lid0, 0, npad, 1,
                       th.pack_route(0, 1, 20, 0, False, True, every_other,
                                     fm), 256)


def _k6_call(th, torch, binsT, w8, ids, lo, hi, target, route, B, scales):
    """K6 (no route) or K7 routed with one target over the window's
    blocks."""
    rb = 8192
    blocks = torch.arange(lo // rb, hi // rb, dtype=torch.int32,
                          device=binsT.device)
    t = torch.tensor([target], dtype=torch.int32)
    if route is None:
        return th.histogram_frontier(binsT, w8, ids, blocks, blocks.numel(),
                                     t, B, rb, scales)[0]
    return th.histogram_frontier_routed(binsT, w8, ids, blocks,
                                        blocks.numel(), t, route[None], B,
                                        rb, scales)[1][0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("segment_candidates: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with open(SOURCE) as fh:
        base = fh.read()
    work = tempfile.mkdtemp(prefix="segment_cand_")
    libs = {}
    for name, edits in CANDIDATES.items():
        path, log = _build(_variant(base, edits), work, name)
        libs[name] = _Lib(path, torch, dev)
        body = "segment_window_kernel"
        sass = kernels.sass_opcodes(body, path)
        print(json.dumps({"candidate": name, "ptxas": kernels.ptxas_lines(
            body, log), "atomics": {fn: {k: v for k, v in sorted(ops.items())
                                         if k.startswith(("ATOMS", "ATOM",
                                                          "RED"))}
                                    for fn, ops in sass.items()}}),
              flush=True)
    shipped = libs["prefetch"]
    records = []
    for shape, (binsT, w8, scales, ids0, lo, hi, target, route,
                B) in _shapes(torch, th, dev):
        F = binsT.shape[0]
        calls = {name: (lambda lib: lambda ids: lib.call(
            binsT, w8, ids, lo, hi, target, route, B, scales))(lib)
            for name, lib in libs.items()}
        calls["k6_body"] = lambda ids: _k6_call(th, torch, binsT, w8, ids, lo,
                                                hi, target, route, B, scales)
        ref_ids = ids0.clone()
        ref = calls["prefetch"](ref_ids)
        for name, call in calls.items():
            if name in DIAGNOSTIC:
                continue
            ids = ids0.clone()
            got = call(ids)
            torch.cuda.synchronize()
            if not (torch.equal(got, ref) and torch.equal(ids, ref_ids)):
                raise SystemExit(f"{name} differs from the shipped kernel "
                                 f"at {shape}")

        def time_ms(call):
            # reps calls, each on its own copy of the ids, in one CUDA
            # graph: the device's time, with no host between calls
            ids = [ids0.clone() for _ in range(args.reps)]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for x in ids:
                    call(x)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            for _ in range(2):       # a warm-up replay, a timed one
                for x in ids:
                    x.copy_(ids0)
                a.record()
                graph.replay()
                b.record()
                torch.cuda.synchronize()
            del graph, ids
            return a.elapsed_time(b) / args.reps

        matched = int(((ref_ids[lo:hi] == target)
                       & (w8[4, lo:hi] != 0)).sum().item())
        for name, call in calls.items():
            if name == "prefetch":
                continue
            t = [time_ms(calls["prefetch"]), time_ms(call), time_ms(call),
                 time_ms(calls["prefetch"])]
            rec = {"shape": shape, "kernel": ("histogram_segment"
                                              if route is None else
                                              "histogram_segment_routed"),
                   "candidate": name, "exact": name not in DIAGNOSTIC,
                   "ms": (t[1] + t[2]) / 2,
                   "shipped_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                   "rows": hi - lo, "target_rows": matched,
                   "features": F, "bins": B,
                   "tiling": libs.get(name, shipped).tiling(F, B),
                   "shipped_tiling": shipped.tiling(F, B),
                   "reps": args.reps, "card": card}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
