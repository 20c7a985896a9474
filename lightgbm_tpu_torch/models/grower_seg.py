"""Segment grower: leaf-wise growth with per-split cost proportional to
leaf size, the whole tree grown on the device.

Counterpart of lightgbm_tpu/models/grower_seg.py (make_grow_tree_segment
:449).  The reference pays O(leaf size) per split by keeping each leaf's
rows contiguous (DataPartition, src/treelearner/data_partition.hpp:111).
This grower uses *epoch compaction*, as the TPU one does:

  * rows live in a permuted order (``order[pos] -> original row``); when
    the histogram kernels have scanned more than COMPACT_WASTE x N rows
    since the last compaction, the whole layout is stable-sorted by leaf
    id (``_compact``);
  * between compactions rows never move, so each leaf's rows stay
    confined to the block window ``[lo, hi)`` its nearest compacted
    ancestor occupied;
  * each split runs one kernel pass over the parent's window: K3 routes
    the parent's rows and histograms the smaller child (``fused_route``),
    or K2 routes and K1 histograms (``fused_route=False``); the larger
    child is parent minus smaller.  A categorical split routes by the
    bitset of its left-going bins, in the same kernels;
  * the root's histogram is one full-window pass, unless the caller gives
    it (``root``: the multiclass loop packs all C class trees' channels
    and histograms their roots in one K5 launch);
  * with ``params.packed_acc`` the kernels read the packed-accumulator
    stream (JAX grower_seg.py:474-491, :615-620): Q1 quantizes the tree's
    gradients once (quantize_pack), the state holds the [2, Npad] int32
    stream and its scales, and the histograms come back in real units, so
    the rest of the step is unchanged.  A given root keeps its f32
    channels' histogram while the splits quantize, as in JAX (the first
    subtraction mixes the two, as JAX's does).

The split loop runs on the device, as the JAX grower's one jitted loop
does (the epoch loop at :802-830):

  * a tree's whole state (the permuted layout, the windows, the leaf sums
    and histograms, the best-split cache, the tree arrays and the
    counters) lives in tensors on the grower's device (``_DeviceState``),
    allocated once a grower and reused by every tree and class;
  * one split is one ``_step`` (do_split, :630): the argmax of the cached
    gains (ties to the lower leaf), the split's step block built on the
    device (``pack_step``, ``pack_route_device``), K3 (or K2 then K1)
    reading it from device memory, parent minus smaller, the split's
    record as masked tensor writes, both children scanned by best_split.
    A step whose predicate (the JAX inner loop's, :806-808) is false runs
    its kernels on an empty window and writes nothing, so the state does
    not change: growth stops exactly where the JAX epoch stops, and every
    number of steps a replay grows the same model;
  * with a feature mask (feature fraction by tree, ``feature_mask``) the
    tree's start draws the masks of all 2L + 1 node numbers from the
    tree's mask and key at once (``node_feature_mask``: by node when
    ``feature_fraction_bynode`` < 1, else the tree's mask; 2L the root,
    2s and 2s + 1 the children of split s), and a step gathers its two
    children's rows by the split ordinal it reads from the counters on
    the device;
  * on a card, ``steps`` steps are captured once in a CUDA graph and
    replayed; after each replay one small status tensor comes to the
    host, which compacts the layout on the device when growth can go on
    and the scan budget is spent; at the tree's end the tree arrays come
    to the host in one fetch.  A tree's start (the state reset, the
    root's pass and its best split) is a second graph, replayed after the
    tree's inputs are copied into the state's buffers.  On the CPU the
    same start and steps run eagerly through the kernels' plain versions;
  * the split features (JAX grower_seg.py:426-429, :534-541, :680-692)
    live in the state too: each leaf's monotone output bounds
    (``mono_lo``/``mono_hi`` [L]), handed to the children by
    ``mono_handoff`` in the step, and CEGB's ``feat_used`` [F], the
    features split on so far, which a tree starts from the model's
    (``fmeta.cegb_used0``) and each step marks; the scans take the bounds
    and CEGB's split and coupled costs (``cegb_split_coupled_adjust``).
    All of it is tensors the graphs hold, written in place.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.histogram import (STEP_WORDS, SPLIT_WORDS, fixed_point_scales,
                             histogram_segment, histogram_segment_routed,
                             histogram_segment_routed_step,
                             histogram_segment_step, logical_columns,
                             null_route, pack_channels, pack_route_device,
                             pack_step, quantize_pack, route_window_step)
from ..ops.split import (NEG_INF, FeatureMeta, SplitInfo, best_split,
                         expand_group_hist)
from .grower import (GrowerParams, TreeArrays, cegb_split_coupled_adjust,
                     grower_columns, mono_handoff, node_feature_mask)

# Re-sort the layout once the histogram kernels have scanned more than
# COMPACT_WASTE x N rows of confinement windows since the last sort
# (the TPU grower's default, grower_seg.py:74).
COMPACT_WASTE = 9.0
# Split steps a CUDA graph replay runs (SegmentGrower's ``steps``), from
# the measurements in PERF.md (tools/profile_torch_iter.py --steps).
DEFAULT_STEPS = 4

# the status after a replay: num_leaves, growth can go on, the scan budget
# is spent
_STATUS = 3
# a node's int32 row: the split's SPLIT_WORDS, then its two children
_NODE_WORDS = SPLIT_WORDS + 2


def _unpermute(order: torch.Tensor, leaf_id: torch.Tensor) -> torch.Tensor:
    """leaf_id (permuted space) -> original row order: ``order`` is a
    permutation, so one scatter inverts it."""
    return torch.empty_like(leaf_id).index_copy_(0, order, leaf_id)


def _cache_rows(info: SplitInfo, gain: torch.Tensor):
    """The best-split cache's rows of K scanned leaves: f32 [K, 6] (gain,
    left_g, left_h, left_c, left_out, right_out) and int32 [K,
    SPLIT_WORDS] (feature, threshold, default_left, is_cat, the bitset's
    8 words), the JAX grower's packed cache (grower_seg.py:147-154)."""
    f32 = torch.stack([gain, info.left_g, info.left_h, info.left_c,
                       info.left_out, info.right_out], dim=1).float()
    K = gain.shape[0]
    if info.is_cat is None:
        is_cat = torch.zeros_like(info.feature)
        words = torch.zeros((K, 8), dtype=torch.int32, device=gain.device)
    else:
        is_cat = info.is_cat.to(torch.int32)
        b = info.cat_bitset
        # 32-bit words as int32, the bits unchanged
        words = torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)
    head = torch.stack([info.feature, info.threshold,
                        info.default_left.to(torch.int32), is_cat], dim=1)
    return f32, torch.cat([head.to(torch.int32), words], dim=1)


class _DeviceState:
    """One tree's state, in tensors on the grower's device that keep their
    storage from tree to tree (a CUDA graph holds their addresses).
    ``STATE`` names them; ``root_sums`` and ``root_hist`` hold a tree's
    inputs, ``step``, ``hist_small`` and ``status`` are the step's own
    buffers; ``quant_clips`` the tree's clipped quantized values.  ``w8``
    is the weights the kernels read: pack_channels' [8, Npad] bf16, or
    with ``packed_acc`` the [2, Npad] int32 packed-accumulator stream."""

    STATE = ("binsT", "w8", "scales", "order", "leaf_id", "window",
             "leaf_sum", "leaf_hist", "best_f32", "best_i32", "node_i32",
             "node_f32", "leaf_i32", "leaf_value", "counters")

    def __init__(self, rows: int, H: int, npad: int, B: int, L: int, dev,
                 fmeta: FeatureMeta, masked: bool = False,
                 packed_acc: bool = False):
        """A bin matrix of ``rows`` byte rows whose kernels' histograms have
        ``H`` columns (EFB groups, or the features; packed, 2 x rows) of
        ``B`` bins; the scan and the masks are over fmeta's F features."""
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        F = fmeta.num_bin.shape[0]
        self.binsT = zeros(rows, npad, dtype=torch.uint8)    # permuted
        self.w8 = (zeros(2, npad, dtype=torch.int32) if packed_acc
                   else zeros(8, npad, dtype=torch.bfloat16))   # permuted
        # ones: the capture's warm-up step converts its sums by them
        self.scales = torch.ones(2, dtype=torch.float32, device=dev)
        self.order = zeros(npad, dtype=torch.int64)   # pos -> original row
        self.leaf_id = zeros(npad, dtype=torch.int32)
        self.fmeta = FeatureMeta(*(None if t is None else t.clone()
                                   for t in fmeta))
        self.window = zeros(L, 2, dtype=torch.int64)    # [lo, hi) blocks
        # (sum_grad, sum_hess, count): the tree's leaf weight and count too
        self.leaf_sum = zeros(L, 3)
        # the kernels' histograms, over the columns
        self.leaf_hist = zeros(L, H, B, 3)
        # best-split cache (best_split_per_leaf_, serial_tree_learner.h:153)
        self.best_f32 = zeros(L, 6)
        self.best_i32 = zeros(L, SPLIT_WORDS, dtype=torch.int32)
        # tree arrays: node rows (the split, left_child, right_child) and
        # (split_gain, internal_value, internal_weight, internal_count);
        # leaf rows (leaf_parent, leaf_depth) and leaf_value
        self.node_i32 = zeros(L - 1, _NODE_WORDS, dtype=torch.int32)
        self.node_f32 = zeros(L - 1, 4)
        self.leaf_i32 = zeros(L, 2, dtype=torch.int32)
        self.leaf_value = zeros(L)
        # num_leaves, scanned_since, scanned_total, num_sorts
        self.counters = zeros(4, dtype=torch.int64)
        # a tree's inputs besides the layout: the root's sums and, when
        # the caller gives it, its histogram
        self.root_sums = zeros(3)
        self.root_hist = zeros(H, B, 3)
        self.quant_clips = zeros(1, dtype=torch.int64)
        self.step = zeros(STEP_WORDS, dtype=torch.int32)
        self.hist_small = zeros(H, B, 3)
        self.status = zeros(_STATUS, dtype=torch.int64)
        # the split features: each leaf's monotone output bounds, and the
        # features split on so far (CEGB's coupled cost)
        self.mono_lo = torch.full((L,), NEG_INF, dtype=torch.float32,
                                  device=dev)
        self.mono_hi = torch.full((L,), float("inf"), dtype=torch.float32,
                                  device=dev)
        self.feat_used = zeros(F)
        # feature fraction: the tree's mask and key, and the masks of the
        # node numbers 0 .. 2L drawn from them at the tree's start
        if masked:
            self.fmask = torch.ones(F, dtype=torch.float32, device=dev)
            self.key = zeros(2, dtype=torch.int64)
            self.node_steps = torch.arange(2 * L + 1, dtype=torch.int64,
                                           device=dev)
            self.node_masks = zeros(2 * L + 1, F)

    def load(self, binsT, w8, scales, fmeta: FeatureMeta, root_sums,
             root_hist=None, feature_mask=None, key=None,
             clips=None) -> None:
        """Copy a tree's inputs into the state's buffers, in place."""
        if feature_mask is not None:
            self.fmask.copy_(feature_mask)
        if key is not None:
            self.key.copy_(key)
        self.binsT.copy_(binsT)
        self.w8.copy_(w8)
        self.scales.copy_(scales)
        for dst, src in zip(self.fmeta, fmeta):
            if dst is not None:
                dst.copy_(src)
        self.root_sums.copy_(root_sums)
        if root_hist is not None:
            self.root_hist.copy_(root_hist)
        if clips is None:
            self.quant_clips.zero_()
        else:
            self.quant_clips.copy_(clips.reshape(1))

    def reset(self, max_blocks: int) -> None:
        """A new tree from the loaded inputs (fresh_state,
        grower_seg.py:386): every write in place, none a host-to-device
        copy or a read on the host (a scalar goes in by fill_: assigning
        one copies it from the host)."""
        torch.arange(self.order.shape[0], out=self.order)
        self.leaf_id.zero_()
        self.window.zero_()
        self.window[0, 1:].fill_(max_blocks)
        self.leaf_sum.zero_()
        self.leaf_sum[0].copy_(self.root_sums)
        self.leaf_hist.zero_()
        self.best_f32.zero_()
        self.best_f32[:, 0].fill_(NEG_INF)
        self.best_i32.zero_()
        self.best_i32[:, 0].fill_(-1)
        self.node_i32.zero_()
        self.node_i32[:, SPLIT_WORDS:].fill_(-1)
        self.node_f32.zero_()
        self.leaf_i32.zero_()
        self.leaf_i32[:, 0].fill_(-1)
        self.leaf_value.zero_()
        self.counters.fill_(max_blocks)
        self.counters[:1].fill_(1)
        self.counters[3:].zero_()
        self.mono_lo.fill_(NEG_INF)
        self.mono_hi.fill_(float("inf"))
        if self.fmeta.cegb_used0 is None:
            self.feat_used.zero_()
        else:
            self.feat_used.copy_(self.fmeta.cegb_used0)

    def tree(self) -> Tuple[TreeArrays, dict]:
        """The tree arrays and the counters, in one device-to-host fetch."""
        parts = (self.node_i32, self.node_f32, self.leaf_i32,
                 self.leaf_value, self.leaf_sum, self.counters,
                 self.quant_clips)
        flat = torch.cat([p.reshape(-1).view(torch.int32)
                          for p in parts]).cpu().numpy()
        out, at = [], 0
        for p in parts:
            n = p.numel() * p.element_size() // 4
            dtype = {torch.int32: np.int32, torch.float32: np.float32,
                     torch.int64: np.int64}[p.dtype]
            out.append(flat[at:at + n].view(dtype).reshape(p.shape))
            at += n
        node_i, node_f, leaf_i, leaf_value, leaf_sum, counters, clips = out
        L = leaf_value.shape[0]
        tr = TreeArrays(L)
        tr.num_leaves = int(counters[0])
        tr.split_feature = node_i[:, 0].copy()
        tr.threshold_bin = node_i[:, 1].copy()
        tr.default_left = node_i[:, 2] != 0
        tr.is_cat = node_i[:, 3] != 0
        tr.cat_bitset = node_i[:, 4:SPLIT_WORDS].view(np.uint32).copy()
        tr.left_child = node_i[:, SPLIT_WORDS].copy()
        tr.right_child = node_i[:, SPLIT_WORDS + 1].copy()
        (tr.split_gain, tr.internal_value, tr.internal_weight,
         tr.internal_count) = (node_f[:, k].copy() for k in range(4))
        tr.leaf_value = leaf_value.copy()
        tr.leaf_weight = leaf_sum[:, 1].copy()
        tr.leaf_count = leaf_sum[:, 2].copy()
        tr.leaf_parent = leaf_i[:, 0].copy()
        tr.leaf_depth = leaf_i[:, 1].copy()
        return tr, {"scanned_blocks": int(counters[2]),
                    "compactions": int(counters[3]),
                    "quant_clips": int(clips[0])}


def _put(t: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
         active: torch.Tensor) -> None:
    """t[idx] = rows where ``active`` ([1] bool), else unchanged: rows at
    one or two indices, written in place without a value on the host."""
    old = t.index_select(0, idx)
    keep = active.reshape((1,) * old.dim())
    t.index_copy_(0, idx, torch.where(keep, rows.reshape(old.shape), old))


def _check_key(feature_mask, key, p: GrowerParams) -> None:
    """By-node masks (``feature_fraction_bynode`` < 1) are drawn from the
    tree's key: a tree mask without one raises."""
    if (feature_mask is not None and p.feature_fraction_bynode < 1.0
            and key is None):
        raise ValueError("feature_fraction_bynode < 1 needs the tree's key")


class SegmentGrower:
    """Strict best-first: one split at a time.  ``fused_route`` (default)
    runs each split's route and smaller-child histogram as one kernel
    (K3); False runs the unfused pair (K2, K1).  ``steps`` is the number of
    split steps one CUDA graph replay runs.  ``params.packed_acc`` feeds
    every kernel of the tree the packed-accumulator stream.

    ``grow(binsT, grad, hess, member, fmeta, root=None, feature_mask=None,
    key=None)`` takes column-major bins [G, Npad] (the G columns of the
    dataset: EFB groups, or its F features; Npad a multiple of
    ``block_rows``; pad rows must carry member == 0), or with
    ``params.packed4`` [ceil(G / 2), Npad] of two columns a byte (G =
    ``params.num_columns``), and returns ``(TreeArrays, leaf_id)`` with
    leaf ids in the original row order.  The kernels' histograms have the
    logical columns of the bins (2 x the byte rows packed); the scan reads
    the first G.  ``root``, when given, is
    ``(w8, scales, root_hist)``: this tree's channels as pack_channels
    packs them, their fixed_point_scales, and the root histogram [H, B,
    3] (H the kernels' columns) at those scales, which takes the place of
    the root's own pass (K5's slice of this class is, bit for bit, what
    that pass gives).  The
    splits' kernels use the same ``w8`` and ``scales``, or with
    ``packed_acc`` the tree's own quantized stream (only root_hist is
    read).
    ``feature_mask`` ([F] float32, nonzero = usable), when given, is the
    tree's feature fraction; with ``feature_fraction_bynode`` < 1 each
    node's mask is drawn from the tree's threefry ``key`` ([2] int64,
    utils/random.py) as ``node_feature_mask`` draws it.  Both are copied
    into the state's buffers, which the graphs read.

    ``last_stats`` holds the last tree's counters: blocks scanned,
    compactions, splits, the replays (or eager rounds of ``steps`` steps
    on the CPU) and the host fetches, the graph's capture time, and
    ``quant_clips``, the values the quantizer clipped (0 without
    packed_acc; the JAX growers' stats slot, grower_seg.py:79-87)."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int, fused_route: bool = True,
                 steps: int = DEFAULT_STEPS):
        if steps < 1:
            raise ValueError(f"steps must be at least 1, got {steps}")
        self.B = num_bins
        self.p = params
        self.rb = block_rows
        self.fused_route = fused_route
        self.steps = int(steps)
        self.last_stats = {}
        self.s: Optional[_DeviceState] = None
        self._key = None
        self._graph = None
        self._graph_launches = {}
        # the tree's start, with and without a given root: (graph, launches)
        self._start_graphs = {}
        self._capture_s = 0.0
        self._child_cols = None
        self._root = None
        self._src = None
        self.G = 0
        self.limit = 1
        self._masked = False

    # ---------------------------------------------------------- the step
    def _step(self) -> None:
        """One split (do_split), or nothing when the predicate is false."""
        s, p, L = self.s, self.p, self.p.num_leaves
        gain = s.best_f32[:, 0]
        leaf = torch.argmax(gain).reshape(1)
        n_leaves = s.counters[:1]
        active = ((n_leaves < L) & (gain.index_select(0, leaf) > 0.0)
                  & (s.counters[1:2] < self.limit))
        # real rows when inactive too (the writes to them are masked)
        new_leaf = n_leaves.clamp(max=L - 1)
        node = (n_leaves - 1).clamp(0, L - 2)
        pair = torch.cat([leaf, new_leaf])
        split = s.best_i32.index_select(0, leaf)[0]
        best = s.best_f32.index_select(0, leaf)[0]
        window = s.window.index_select(0, leaf)[0]
        parent = s.leaf_sum.index_select(0, leaf)[0]
        sums = torch.stack([best[1:4], parent - best[1:4]])   # left, right
        smaller_is_left = sums[0, 2:] <= sums[1, 2:]
        smaller = torch.where(smaller_is_left, leaf, new_leaf)
        n_blk = torch.where(active, window[1:] - window[:1], 0)
        packed4 = p.packed4
        route = pack_route_device(torch.where(active, leaf, -1), new_leaf,
                                  split, s.fmeta, packed4)
        s.step.copy_(pack_step(window[:1], n_blk, smaller, route))
        if self.fused_route:
            histogram_segment_routed_step(s.binsT, s.w8, s.leaf_id, s.step,
                                          self.B, self.rb, s.scales,
                                          out=s.hist_small, packed4=packed4)
        else:
            route_window_step(s.binsT, s.leaf_id, s.step, self.rb, packed4)
            histogram_segment_step(s.binsT, s.w8, s.leaf_id, s.step, self.B,
                                   self.rb, s.scales, out=s.hist_small,
                                   packed4=packed4)
        small = s.hist_small
        large = s.leaf_hist.index_select(0, leaf)[0] - small
        sel = smaller_is_left.reshape(1, 1, 1)
        hists = torch.stack([torch.where(sel, small, large),
                             torch.where(sel, large, small)])
        _put(s.leaf_hist, pair, hists, active)
        _put(s.leaf_sum, pair, sums, active)
        # the new leaf inherits the parent's window (routing touched only it)
        _put(s.window, new_leaf, window, active)
        # the tree (Tree::Split, tree.h:407-445): the parent's child that
        # was this leaf becomes the new node
        not_leaf = (~leaf).to(torch.int32)
        up = s.leaf_i32.index_select(0, leaf)[0]      # parent, depth
        pidx = up[:1].clamp(min=0).long()
        prow = s.node_i32.index_select(0, pidx)[0]
        is_child = (prow == not_leaf) & (up[:1] >= 0) & self._child_cols
        _put(s.node_i32, pidx, torch.where(is_child, node.to(torch.int32),
                                           prow), active)
        _put(s.node_i32, node, torch.cat([split, not_leaf,
                                          (~new_leaf).to(torch.int32)]),
             active)
        _put(s.node_f32, node, torch.cat([best[:1], s.leaf_value.index_select(
            0, leaf), parent[1:]]), active)
        _put(s.leaf_value, pair, best[4:6], active)
        depth = up[1:] + 1
        _put(s.leaf_i32, pair, torch.cat([node.to(torch.int32), depth]
                                         ).expand(2, 2), active)
        s.counters.add_(torch.cat([active.long(), n_blk, n_blk,
                                   torch.zeros_like(n_blk)]))
        f = split[:1].clamp(min=0).long()
        if p.use_monotone:
            lo_l, hi_l, lo_r, hi_r = mono_handoff(
                s.mono_lo.index_select(0, leaf),
                s.mono_hi.index_select(0, leaf), best[4:5], best[5:6],
                s.fmeta.monotone.index_select(0, f), split[3:4] != 0)
            _put(s.mono_lo, pair, torch.cat([lo_l, lo_r]), active)
            _put(s.mono_hi, pair, torch.cat([hi_l, hi_r]), active)
        if p.use_cegb_coupled:
            _put(s.feat_used, f, torch.ones(1, device=f.device), active)
        # both children's best splits (under their node masks, numbered 2s
        # and 2s + 1 for split s), from their per-feature histograms; a
        # child at max_depth gets -inf
        mask = None
        if self._masked:
            mask = s.node_masks.index_select(0, torch.cat([2 * node,
                                                           2 * node + 1]))
        g, h, c = sums[:, 0], sums[:, 1], sums[:, 2]
        info = best_split(expand_group_hist(hists[:, :self.G], s.fmeta, g, h,
                                            c), g, h, c, s.fmeta, p.split,
                          mask, *self._scan_extras(pair, c))
        gain2 = info.gain
        if p.max_depth > 0:
            gain2 = torch.where(depth >= p.max_depth, NEG_INF, gain2)
        f32, i32 = _cache_rows(info, gain2)
        _put(s.best_f32, pair, f32, active)
        _put(s.best_i32, pair, i32, active)

    def _scan_extras(self, leaves: torch.Tensor, c: torch.Tensor):
        """The scan's split-feature arguments for ``leaves`` of counts
        ``c``: (mono_lo, mono_hi, gain_adjust), each None when unused."""
        s, p = self.s, self.p
        lo = hi = adjust = None
        if p.use_monotone:
            lo = s.mono_lo.index_select(0, leaves)
            hi = s.mono_hi.index_select(0, leaves)
        if p.cegb_adjusts:
            adjust = cegb_split_coupled_adjust(s.feat_used, c, s.fmeta, p)
        return lo, hi, adjust

    def _write_status(self) -> None:
        s, L = self.s, self.p.num_leaves
        n_leaves = s.counters[:1]
        can_grow = (n_leaves < L) & (s.best_f32[:, 0].max() > 0.0)
        spent = s.counters[1:2] >= self.limit
        s.status.copy_(torch.cat([n_leaves, can_grow.long(), spent.long()]))

    def _run_steps(self) -> None:
        """``steps`` split steps and the status: a graph replay on a card,
        the steps themselves on the CPU."""
        if self._graph is not None:
            self._graph.replay()
            kernels.count_replay(self._graph_launches)
            return
        for _ in range(self.steps):
            self._step()
        self._write_status()

    def _fetch_status(self) -> Tuple[bool, bool]:
        """(growth can go on, the scan budget is spent), one fetch."""
        _, can_grow, spent = self.s.status.tolist()
        return bool(can_grow), bool(spent)

    def _compact(self) -> None:
        """Stable-sort the whole layout by leaf id (compact_state,
        grower_seg.py:331), in place: leaves become contiguous segments and
        their windows reset to them."""
        s, L, rb = self.s, self.p.num_leaves, self.rb
        lid, perm = torch.sort(s.leaf_id, stable=True)
        s.order.copy_(s.order.index_select(0, perm))
        # the layout is the tree's own inputs in ``order`` (a packed byte
        # holds two columns of one row, so it moves as it is)
        torch.index_select(self._src[0], 1, s.order, out=s.binsT)
        torch.index_select(self._src[1], 1, s.order, out=s.w8)
        s.leaf_id.copy_(lid)
        leaves = torch.arange(L, dtype=lid.dtype, device=lid.device)
        starts = torch.searchsorted(lid, leaves, side="left")
        ends = torch.searchsorted(lid, leaves, side="right")
        # block-granular bounds; empty leaves get an empty window
        nonempty = ends > starts
        s.window.copy_(torch.stack([torch.where(nonempty, starts // rb, 0),
                                    torch.where(nonempty, -(-ends // rb), 0)],
                                   dim=1))
        s.counters[1:2].zero_()
        s.counters[3:].add_(1)

    # ----------------------------------------------------- state, graph
    def _state_for(self, binsT: torch.Tensor, fmeta: FeatureMeta,
                   masked: bool = False):
        """The grower's device state for this shape and feature masks:
        allocated once (and, on a card, its steps captured in a CUDA
        graph), then reused."""
        rows, npad = binsT.shape
        L = self.p.num_leaves
        key = (rows, fmeta.num_bin.shape[0], npad, L, binsT.device,
               tuple(t is None for t in fmeta), self.steps, masked)
        if key != self._key:
            # the key is kept only once the state is whole: after a capture
            # that raised, the next grow captures (and raises) again
            self._key = None
            self._graph = None
            self._start_graphs = {}
            self._masked = masked
            self.G = grower_columns(self.p, binsT)
            self.s = _DeviceState(rows, logical_columns(binsT, self.p.packed4),
                                  npad, self.B, L, binsT.device, fmeta,
                                  masked, self.p.packed_acc)
            self._child_cols = torch.arange(
                _NODE_WORDS, device=binsT.device) >= SPLIT_WORDS
            self._root = torch.zeros(1, dtype=torch.int64,
                                     device=binsT.device)
            self.limit = min(max(1, int(COMPACT_WASTE * (npad // self.rb))),
                             2**31 - 1)
            if binsT.device.type == "cuda":
                self._capture()
            self._key = key
        return self.s

    def _capture_graph(self, warm, record) -> Tuple[torch.cuda.CUDAGraph,
                                                     dict]:
        """Run ``warm`` on a side stream (the warm-up a capture needs), then
        capture ``record`` in a CUDA graph: (graph, its kernel launches).
        A capture that fails raises."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.CAPTURED.clear()
        with torch.cuda.graph(graph):
            record()
        launches = dict(kernels.CAPTURED)
        torch.cuda.synchronize()
        self._capture_s += time.perf_counter() - t0
        return graph, launches

    def _capture(self) -> None:
        """Capture ``steps`` steps and the status in one CUDA graph.  The
        freshly zeroed state has no gain, so the warm-up step is inactive
        and changes nothing."""
        def steps():
            for _ in range(self.steps):
                self._step()
            self._write_status()

        self._capture_s = 0.0
        self._graph, self._graph_launches = self._capture_graph(self._step,
                                                                steps)

    def _begin(self, given_root: bool, max_blocks: int) -> None:
        """The tree's start from its loaded inputs: on a card, the replay
        of its CUDA graph (one for a given root, one for the root's own
        pass); the first tree of each kind starts in the capture's
        warm-up.  On the CPU, the start itself."""
        if self.s.binsT.device.type != "cuda":
            self._start(given_root, max_blocks)
            return
        if given_root in self._start_graphs:
            graph, launches = self._start_graphs[given_root]
            graph.replay()
            kernels.count_replay(launches)
            return
        start = lambda: self._start(given_root, max_blocks)  # noqa: E731
        self._start_graphs[given_root] = self._capture_graph(start, start)

    def _start(self, given_root: bool, max_blocks: int) -> None:
        """A new tree: the state reset, the root's histogram (given, or one
        full-window pass of the by-value kernel) and its best split."""
        s = self.s
        s.reset(max_blocks)
        if given_root:
            root_hist = s.root_hist
        elif self.fused_route:
            # the split path's kernel with a match-nothing route
            root_hist = histogram_segment_routed(
                s.binsT, s.w8, s.leaf_id, 0, max_blocks, 0, null_route(),
                self.B, self.rb, s.scales, self.p.packed4)[1]
        else:
            root_hist = histogram_segment(s.binsT, s.w8, s.leaf_id, 0,
                                          max_blocks, 0, self.B, self.rb,
                                          s.scales, self.p.packed4)
        s.leaf_hist[0].copy_(root_hist)
        mask = None
        if self._masked:
            s.node_masks.copy_(node_feature_mask(s.fmask, s.key,
                                                 s.node_steps, self.p))
            mask = s.node_masks[-1:]          # the root's number, 2L
        g, h, c = s.leaf_sum[:1, 0], s.leaf_sum[:1, 1], s.leaf_sum[:1, 2]
        info = best_split(expand_group_hist(s.leaf_hist[:1, :self.G],
                                            s.fmeta, g, h, c), g, h, c,
                          s.fmeta, self.p.split, mask,
                          *self._scan_extras(self._root, c))
        f32, i32 = _cache_rows(info, info.gain)
        s.best_f32[:1].copy_(f32)
        s.best_i32[:1].copy_(i32)

    # ---------------------------------------------------------------- grow
    def grow(self, binsT: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, member: torch.Tensor, fmeta: FeatureMeta,
             root: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None,
             feature_mask: Optional[torch.Tensor] = None,
             key: Optional[torch.Tensor] = None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        n = binsT.shape[1]
        if n % self.rb:
            raise ValueError(f"Npad {n} is not a multiple of {self.rb}")
        max_blocks = n // self.rb
        clips = None
        root_hist = None if root is None else root[2]
        if self.p.packed_acc:
            # once a tree, a given root too (JAX grower_seg.py:615-620)
            w8, scales, clips = quantize_pack(grad, hess, member,
                                              self.p.packed_acc_bits)
        elif root is None:
            w8 = pack_channels(grad, hess, member)
            scales = fixed_point_scales(w8)
        else:
            w8, scales, _ = root
        _check_key(feature_mask, key, self.p)
        s = self._state_for(binsT, fmeta, feature_mask is not None)
        self._src = (binsT, w8)
        s.load(binsT, w8, scales, fmeta,
               torch.stack([torch.sum(grad * member),
                            torch.sum(hess * member), torch.sum(member)]),
               root_hist, feature_mask,
               None if feature_mask is None else key, clips)
        self._begin(root_hist is not None, max_blocks)
        replays = fetches = 0
        while True:
            self._run_steps()
            replays += 1
            can_grow, spent = self._fetch_status()
            fetches += 1
            if not can_grow:
                break
            if spent:
                self._compact()
        tree, counts = s.tree()
        fetches += 1
        self._src = None
        self.last_stats = dict(counts, max_blocks=max_blocks,
                               splits=tree.num_leaves - 1, steps=self.steps,
                               replays=replays, fetches=fetches,
                               graph=self._graph is not None,
                               capture_s=self._capture_s)
        return tree, _unpermute(s.order, s.leaf_id)
