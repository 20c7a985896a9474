"""Segment grower: leaf-wise growth with per-split cost proportional to
leaf size.

Counterpart of lightgbm_tpu/models/grower_seg.py (make_grow_tree_segment
:449).  The reference pays O(leaf size) per split by keeping each leaf's
rows contiguous (DataPartition, src/treelearner/data_partition.hpp:111).
This grower uses *epoch compaction*, as the TPU one does:

  * rows live in a permuted order (``order[pos] -> original row``); when
    the histogram kernels have scanned more than COMPACT_WASTE x N rows
    since the last compaction, the whole layout is stable-sorted by leaf
    id (``compact_state``);
  * between compactions rows never move, so each leaf's rows stay
    confined to the block window ``[leaf_lo, leaf_hi)`` its nearest
    compacted ancestor occupied;
  * each split runs one kernel pass over the parent's window: K3 routes
    the parent's rows and histograms the smaller child (``fused_route``),
    or K2 routes and K1 histograms (``fused_route=False``); the larger
    child is parent minus smaller.  A categorical split routes by the
    bitset of its left-going bins, in the same kernels;
  * the root's histogram is one full-window pass, unless the caller gives
    it (``root``: the multiclass loop packs all C class trees' channels
    and histograms their roots in one K5 launch).

The split loop is driven from the host: a Python loop over splits, with
the best-split records of every leaf kept on the host (one device->host
fetch per split).  The reference's own GPU learner drives its splits the
same way.  Histograms, routing, split search and compaction stay on the
device.  The per-tree state, a split's host bookkeeping
(``record_split``) and the batched scan (``HostGrower``) are shared with
the frontier grower (grower_frontier.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.histogram import (fixed_point_scales, histogram_segment,
                             histogram_segment_routed, null_route,
                             pack_channels, pack_route, route_window)
from ..ops.split import NEG_INF, FeatureMeta, best_split
from .grower import GrowerParams, TreeArrays

# Re-sort the layout once the histogram kernels have scanned more than
# COMPACT_WASTE x N rows of confinement windows since the last sort
# (the TPU grower's default, grower_seg.py:74).
COMPACT_WASTE = 9.0

class _SegState:
    """Per-tree state: device tensors in permuted row order, host
    bookkeeping of windows, leaf sums and best splits."""

    def __init__(self, binsT, w8, L: int, max_blocks: int, G0, H0, C0,
                 F: int, B: int):
        dev = binsT.device
        n = binsT.shape[1]
        self.binsT = binsT                      # [F, Npad] u8, permuted
        self.w8 = w8                            # [8, Npad] bf16, permuted
        self.order = torch.arange(n, dtype=torch.int64, device=dev)
        self.leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
        self.leaf_lo = [0] * L                  # window start block
        self.leaf_hi = [0] * L                  # window end block (excl.)
        self.leaf_hi[0] = max_blocks
        self.scanned_since = 0
        self.scanned_total = 0
        self.num_sorts = 0
        self.num_leaves = 1
        self.leaf_hist = torch.zeros((L, F, B, 3), dtype=torch.float32,
                                     device=dev)
        f32 = np.float32
        self.leaf_g = np.zeros(L, f32)
        self.leaf_h = np.zeros(L, f32)
        self.leaf_c = np.zeros(L, f32)
        self.leaf_g[0], self.leaf_h[0], self.leaf_c[0] = G0, H0, C0
        # best-split cache (best_split_per_leaf_, serial_tree_learner.h:153)
        self.best_gain = np.full(L, NEG_INF, f32)
        self.best_feature = np.full(L, -1, np.int32)
        self.best_threshold = np.zeros(L, np.int32)
        self.best_dl = np.zeros(L, bool)
        self.best_is_cat = np.zeros(L, bool)
        self.best_bitset = np.zeros((L, 8), np.uint32)
        self.best_left = np.zeros((L, 3), f32)   # (left_g, left_h, left_c)
        self.best_out = np.zeros((L, 2), f32)    # (left_out, right_out)
        self.tree = TreeArrays(L)
        self.tree.leaf_weight[0] = H0
        self.tree.leaf_count[0] = C0


def compact_state(st: _SegState, L: int, rb: int) -> None:
    """Stable-sort the whole layout by leaf id; leaves become contiguous
    segments and their windows reset to them."""
    lid, perm = torch.sort(st.leaf_id, stable=True)
    st.binsT = st.binsT.index_select(1, perm)
    st.w8 = st.w8.index_select(1, perm)
    st.order = st.order[perm]
    st.leaf_id = lid
    leaves = torch.arange(L, dtype=lid.dtype, device=lid.device)
    starts = torch.searchsorted(lid, leaves, side="left")
    ends = torch.searchsorted(lid, leaves, side="right")
    # block-granular bounds; empty leaves get an empty window
    nonempty = ends > starts
    zero = torch.zeros_like(starts)
    lo = torch.where(nonempty, starts // rb, zero)
    hi = torch.where(nonempty, -(-ends // rb), zero)
    st.leaf_lo = lo.tolist()
    st.leaf_hi = hi.tolist()
    st.scanned_since = 0
    st.num_sorts += 1


def _unpermute(order: torch.Tensor, leaf_id: torch.Tensor) -> torch.Tensor:
    """leaf_id (permuted space) -> original row order: ``order`` is a
    permutation, so one scatter inverts it."""
    return torch.empty_like(leaf_id).index_copy_(0, order, leaf_id)


def split_route(st: _SegState, leaf: int, new_leaf: int,
                fm_host: FeatureMeta) -> torch.Tensor:
    """The route descriptor of the cached best split of ``leaf``."""
    return pack_route(leaf, new_leaf, int(st.best_feature[leaf]),
                      int(st.best_threshold[leaf]), bool(st.best_dl[leaf]),
                      bool(st.best_is_cat[leaf]), st.best_bitset[leaf],
                      fm_host)


def record_split(st: _SegState, leaf: int, new_leaf: int, node: int) -> None:
    """Host bookkeeping of the cached best split of ``leaf`` (Tree::Split,
    tree.h:407-445): the new leaf inherits the parent's window (routing
    touches only it), the tree arrays and the two children's sums."""
    st.leaf_lo[new_leaf], st.leaf_hi[new_leaf] = (st.leaf_lo[leaf],
                                                  st.leaf_hi[leaf])
    Gl, Hl, Cl = st.best_left[leaf]
    Gp, Hp, Cp = st.leaf_g[leaf], st.leaf_h[leaf], st.leaf_c[leaf]
    Gr, Hr, Cr = Gp - Gl, Hp - Hl, Cp - Cl
    tr = st.tree
    parent = int(tr.leaf_parent[leaf])
    if parent >= 0:
        if tr.left_child[parent] == ~leaf:
            tr.left_child[parent] = node
        if tr.right_child[parent] == ~leaf:
            tr.right_child[parent] = node
    tr.left_child[node] = ~leaf
    tr.right_child[node] = ~new_leaf
    tr.split_feature[node] = st.best_feature[leaf]
    tr.threshold_bin[node] = st.best_threshold[leaf]
    tr.default_left[node] = st.best_dl[leaf]
    tr.is_cat[node] = st.best_is_cat[leaf]
    tr.cat_bitset[node] = st.best_bitset[leaf]
    tr.split_gain[node] = st.best_gain[leaf]
    tr.internal_value[node] = tr.leaf_value[leaf]
    tr.internal_weight[node] = Hp
    tr.internal_count[node] = Cp
    tr.leaf_value[leaf], tr.leaf_value[new_leaf] = st.best_out[leaf]
    tr.leaf_weight[leaf], tr.leaf_weight[new_leaf] = Hl, Hr
    tr.leaf_count[leaf], tr.leaf_count[new_leaf] = Cl, Cr
    tr.leaf_parent[leaf] = tr.leaf_parent[new_leaf] = node
    tr.leaf_depth[leaf] = tr.leaf_depth[new_leaf] = tr.leaf_depth[leaf] + 1
    st.num_leaves += 1
    tr.num_leaves = st.num_leaves
    st.leaf_g[leaf], st.leaf_g[new_leaf] = Gl, Gr
    st.leaf_h[leaf], st.leaf_h[new_leaf] = Hl, Hr
    st.leaf_c[leaf], st.leaf_c[new_leaf] = Cl, Cr


class HostGrower:
    """What the segment and frontier growers share: the per-tree state,
    the batched best-split scan into the host cache, the stop rule.
    ``grow(binsT, grad, hess, member, fmeta, root=None)`` takes
    feature-major bins [F, Npad] (Npad a multiple of ``block_rows``; pad
    rows must carry member == 0) and returns ``(TreeArrays, leaf_id)``
    with leaf ids in the original row order.

    ``root``, when given, is ``(w8, scales, root_hist)``: this tree's
    channels as pack_channels packs them, their fixed_point_scales, and
    the root histogram [F, B, 3] at those scales, which takes the place of
    the root's own pass (K5's slice of this class is, bit for bit, what
    that pass gives).  The splits' kernels use the same ``w8`` and
    ``scales``."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int):
        self.B = num_bins
        self.p = params
        self.rb = block_rows
        self.last_stats = {}

    def _start(self, binsT, grad, hess, member, root):
        """-> (state, scales, root histogram or None)."""
        F, n = binsT.shape
        if n % self.rb:
            raise ValueError(f"Npad {n} is not a multiple of {self.rb}")
        if root is None:
            w8 = pack_channels(grad, hess, member)
            scales = fixed_point_scales(w8)
            root_hist = None
        else:
            w8, scales, root_hist = root
        G0, H0, C0 = torch.stack([torch.sum(grad * member),
                                  torch.sum(hess * member),
                                  torch.sum(member)]).cpu().numpy()
        st = _SegState(binsT, w8, self.p.num_leaves, n // self.rb, G0, H0,
                       C0, F, self.B)
        return st, scales, root_hist

    def _scan(self, st: _SegState, leaves, hists, fmeta: FeatureMeta) -> None:
        """Best split of each leaf in ``leaves`` from its histogram and its
        sums; one device->host fetch writes the host cache (in float64
        when it carries categorical bitsets, whose 32-bit words float32
        would round).  A leaf at max_depth gets gain -inf."""
        dev = hists.device
        g, h, c = (torch.from_numpy(v[leaves]).to(dev)
                   for v in (st.leaf_g, st.leaf_h, st.leaf_c))
        info = best_split(hists, g, h, c, fmeta, self.p.split)
        cols = [info.gain, info.feature, info.threshold, info.default_left,
                info.left_g, info.left_h, info.left_c, info.left_out,
                info.right_out]
        dtype = torch.float32
        if info.is_cat is not None:
            cols += [info.is_cat, *info.cat_bitset.unbind(1)]
            dtype = torch.float64
        rec = torch.stack([x.to(dtype) for x in cols], dim=1).cpu().numpy()
        for k, leaf in enumerate(leaves):
            gain = rec[k, 0]
            if (self.p.max_depth > 0
                    and st.tree.leaf_depth[leaf] >= self.p.max_depth):
                gain = np.float32(NEG_INF)
            st.best_gain[leaf] = gain
            st.best_feature[leaf] = int(rec[k, 1])
            st.best_threshold[leaf] = int(rec[k, 2])
            st.best_dl[leaf] = bool(rec[k, 3])
            st.best_left[leaf] = rec[k, 4:7]
            st.best_out[leaf] = rec[k, 7:9]
            if info.is_cat is not None:
                st.best_is_cat[leaf] = bool(rec[k, 9])
                st.best_bitset[leaf] = rec[k, 10:18].astype(np.uint32)

    def _can_grow(self, st: _SegState) -> bool:
        return (st.num_leaves < self.p.num_leaves
                and float(st.best_gain.max()) > 0.0)


class SegmentGrower(HostGrower):
    """Strict best-first: one split at a time (HostGrower has the call
    contract).  ``fused_route`` (default) runs each split's route and
    smaller-child histogram as one kernel (K3); False runs the unfused
    pair (K2, K1)."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int, fused_route: bool = True):
        super().__init__(num_bins, params, block_rows)
        self.fused_route = fused_route

    def _hist_leaf(self, st: _SegState, leaf: int, scales) -> torch.Tensor:
        lo = st.leaf_lo[leaf]
        n_blk = st.leaf_hi[leaf] - lo
        if self.fused_route:
            # the split path's kernel with a match-nothing route
            _, out = histogram_segment_routed(
                st.binsT, st.w8, st.leaf_id, lo, n_blk, leaf, null_route(),
                self.B, self.rb, scales)
            return out
        return histogram_segment(st.binsT, st.w8, st.leaf_id, lo, n_blk,
                                 leaf, self.B, self.rb, scales)

    def _do_split(self, st: _SegState, fmeta: FeatureMeta, fm_host,
                  scales) -> None:
        leaf = int(np.argmax(st.best_gain))
        new_leaf = st.num_leaves
        lo, hi = st.leaf_lo[leaf], st.leaf_hi[leaf]
        Cl, Cp = st.best_left[leaf, 2], st.leaf_c[leaf]
        smaller_is_left = bool(Cl <= Cp - Cl)
        smaller = leaf if smaller_is_left else new_leaf
        route = split_route(st, leaf, new_leaf, fm_host)
        if self.fused_route:
            # route + smaller-child histogram in ONE pass over the window;
            # leaf_id is updated in place
            _, hist_small = histogram_segment_routed(
                st.binsT, st.w8, st.leaf_id, lo, hi - lo, smaller, route,
                self.B, self.rb, scales)
        else:
            route_window(st.binsT, st.leaf_id, lo, hi - lo, route, self.rb)
        record_split(st, leaf, new_leaf, new_leaf - 1)
        if not self.fused_route:
            hist_small = self._hist_leaf(st, smaller, scales)
        hist_large = st.leaf_hist[leaf] - hist_small
        hist_left, hist_right = ((hist_small, hist_large) if smaller_is_left
                                 else (hist_large, hist_small))
        st.scanned_since += hi - lo
        st.scanned_total += hi - lo
        st.leaf_hist[leaf] = hist_left
        st.leaf_hist[new_leaf] = hist_right
        self._scan(st, [leaf, new_leaf], torch.stack([hist_left, hist_right]),
                   fmeta)

    # ---------------------------------------------------------------- grow
    def grow(self, binsT: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, member: torch.Tensor, fmeta: FeatureMeta,
             root: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        L, rb = self.p.num_leaves, self.rb
        st, scales, root_hist = self._start(binsT, grad, hess, member, root)
        max_blocks = binsT.shape[1] // rb
        fm_host = FeatureMeta(*(t.cpu().numpy() for t in fmeta[:3]))
        if root_hist is None:
            root_hist = self._hist_leaf(st, 0, scales)
        st.leaf_hist[0] = root_hist
        st.scanned_since = st.scanned_total = max_blocks
        self._scan(st, [0], root_hist[None], fmeta)

        # adaptive compaction: amortize the sort against the scans it saves
        limit_blocks = min(max(1, int(COMPACT_WASTE * max_blocks)),
                           2**31 - 1)
        while self._can_grow(st):
            if st.scanned_since >= limit_blocks:
                compact_state(st, L, rb)
            self._do_split(st, fmeta, fm_host, scales)
        self.last_stats = {"scanned_blocks": st.scanned_total,
                           "compactions": st.num_sorts,
                           "max_blocks": max_blocks}
        return st.tree, _unpermute(st.order, st.leaf_id)
