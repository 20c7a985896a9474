"""Fused grower: leaf-wise growth over every row, one K5 histogram a split.

Counterpart of lightgbm_tpu/models/grower.py make_grow_tree (:355-710),
the grower the JAX package takes for forced splits and CEGB-lazy
(lightgbm_tpu/models/gbdt.py:637-648) and for ``tpu_tree_impl="fused"``.
Rows never move: ``leaf_id`` [Npad] stays in row order, and

  * the root's histogram and each split's smaller child's are K5
    (``leaf_histogram``: histogram_all over every row, the member channel
    selecting the leaf's rows; with ``packed_acc`` quantized for that
    leaf, so each leaf has its own scales, grower.py:370-385); the larger
    child is its parent minus the smaller;
  * a split's partition is K2 (``route_window``) over the whole block
    range with the split's route descriptor: JAX's ``routed_left``
    partition (grower.py:515-536), K2 folding EFB columns, 4-bit bins and
    category bitsets;
  * a tree starts with the forced plan (``GrowerParams.forced_plan``,
    breadth-first), each forced split's sums read off its leaf's retained
    histogram (grower.py:473-512), then grows best-first while a leaf has
    a positive gain, to num_leaves - 1 splits in all;
  * CEGB-lazy charges a scan tradeoff x a feature's cost x the leaf's
    rows not yet "seen" on it, a row being seen on a feature once it
    passed a split on it (grower.py:268-281, :550-553; JAX keeps the bits
    as seen [F, N]).  As in JAX every row whose id is the leaf's counts,
    out-of-bag and pad rows too.  A split marks the parent's rows seen on
    its feature, and the parent's rows are all of its descendants' rows,
    so a leaf's rows are either all seen on a feature (some split on its
    path from the root used it) or none: the unseen count is the leaf's
    rows where the feature is off its path, else 0.  The grower keeps
    each leaf's path features [L, F] and row count [L] (one count of
    the left child's ids a split) in place of the [F, Npad] bits, and its
    counts are JAX's in exact integers.

The loop runs from the host, as the frontier grower's does (HostGrower:
the best splits of every leaf on the host, one fetch a scan), eager on the
card.  ``last_stats`` holds the tree's splits, forced splits and K5
launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.binning import MISSING_ZERO
from ..ops.histogram import leaf_histogram, pack_route, route_window
from ..ops.split import (FeatureMeta, clip_output, expand_group_hist,
                         leaf_gain, leaf_output)
from .grower import (GrowerParams, TreeArrays, cegb_split_coupled_adjust,
                     grower_columns)
from .grower_frontier import HostGrower, _SegState, host_meta, record_split


class FusedGrower(HostGrower):
    """The fused grower (module docstring); HostGrower has the call
    contract, but for ``root``, which this grower does not take (JAX
    batches multiclass roots only for the segment and frontier growers,
    gbdt.py:1121-1123)."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int):
        super().__init__(num_bins, params, block_rows)
        # CEGB-lazy: each leaf's path features [L, F] and rows [L]
        self._path = None
        self._leaf_rows = None

    def _hist(self, binsT, grad, hess, member) -> torch.Tensor:
        """K5 over every row, ``member`` selecting a leaf's rows."""
        p = self.p
        return leaf_histogram(binsT, grad, hess, member, self.B, p.packed4,
                              p.packed_acc, p.packed_acc_bits)

    # ------------------------------------------------------- CEGB-lazy
    def _gain_adjust(self, st: _SegState, leaves, c: torch.Tensor,
                     fmeta: FeatureMeta) -> Optional[torch.Tensor]:
        """The split and coupled costs, plus the lazy cost of the leaves'
        unseen rows (_cegb_gain_adjust, grower.py:268-281)."""
        p = self.p
        if not p.use_cegb_lazy:
            return super()._gain_adjust(st, leaves, c, fmeta)
        adjust = cegb_split_coupled_adjust(
            torch.from_numpy(st.feat_used).to(c.device), c, fmeta, p)
        idx = torch.tensor(leaves, device=c.device)
        unseen = self._leaf_rows[idx, None] * (~self._path[idx]).to(
            torch.int64)
        return adjust + (p.cegb_tradeoff * fmeta.cegb_lazy)[None, :] \
            * unseen.to(torch.float32)

    def _mark_seen(self, leaf_id: torch.Tensor, leaf: int, new_leaf: int,
                   f: int) -> None:
        """The split of ``leaf`` on ``f`` (leaf_id routed): both children's
        paths are the parent's and f, the left child's rows those whose
        id stayed the leaf's, the right's the rest of the parent's."""
        path, rows = self._path, self._leaf_rows
        path[leaf, f] = True
        path[new_leaf] = path[leaf]
        left = (leaf_id == leaf).sum()
        rows[new_leaf] = rows[leaf] - left
        rows[leaf] = left

    # ------------------------------------------------------ forced split
    def _force(self, st: _SegState, leaf: int, f: int, t: int,
               fmeta: FeatureMeta, fm_host: FeatureMeta) -> None:
        """Write forced split (leaf, f, t) into ``leaf``'s best-split
        record: its sums from the leaf's histogram at threshold bin t,
        the zero bin's mass dropped under MISSING_ZERO (it routes right:
        default_left is False), outputs clamped to the leaf's bounds, and
        the gain over the parent's (grower.py:473-516)."""
        sp, dev = self.p.split, st.leaf_hist.device
        G = grower_columns(self.p, st.binsT)
        g, h, c = (torch.tensor(v[leaf:leaf + 1], device=dev)
                   for v in (st.leaf_g, st.leaf_h, st.leaf_c))
        row = expand_group_hist(st.leaf_hist[leaf:leaf + 1, :G], fmeta,
                                g, h, c)[0, f]                 # [B, 3]
        left = torch.cumsum(row, dim=0)[t]
        db = int(fm_host.default_bin[f])
        if int(fm_host.missing_type[f]) == MISSING_ZERO and db <= t:
            left = left - row[db]
        Gl, Hl, Cl = left[0], left[1], left[2]
        Gp, Hp = g[0], h[0]
        Gr, Hr = Gp - Gl, Hp - Hl
        lo = hi = None
        if self.p.use_monotone:
            lo, hi = (torch.tensor(v[leaf], device=dev)
                      for v in (st.mono_lo, st.mono_hi))
        l1, l2, mds = sp.lambda_l1, sp.lambda_l2, sp.max_delta_step
        out_l = clip_output(leaf_output(Gl, Hl, l1, l2, mds), lo, hi)
        out_r = clip_output(leaf_output(Gr, Hr, l1, l2, mds), lo, hi)
        gain = (leaf_gain(Gl, Hl, l1, l2, mds) + leaf_gain(Gr, Hr, l1, l2, mds)
                - leaf_gain(Gp, Hp, l1, l2, mds))
        rec = torch.stack([gain, Gl, Hl, Cl, out_l, out_r]).float()
        gain, Gl, Hl, Cl, out_l, out_r = rec.cpu().numpy()
        st.best_gain[leaf] = gain
        st.best_feature[leaf] = f
        st.best_threshold[leaf] = t
        st.best_dl[leaf] = False
        st.best_is_cat[leaf] = False
        st.best_bitset[leaf] = 0
        st.best_left[leaf] = (Gl, Hl, Cl)
        st.best_out[leaf] = (out_l, out_r)

    # --------------------------------------------------------- one split
    def _split(self, st: _SegState, leaf: int, grad, hess, member,
               fmeta: FeatureMeta, fm_host: FeatureMeta, masks) -> None:
        """Apply ``leaf``'s recorded split (do_split, grower.py:453-636):
        the route, the split features' bookkeeping, the smaller child's K5
        histogram and the larger's by subtraction, the tree arrays, both
        children scanned."""
        p = self.p
        new_leaf, node = st.num_leaves, st.num_leaves - 1
        f = int(st.best_feature[leaf])
        route = pack_route(leaf, new_leaf, f, int(st.best_threshold[leaf]),
                           bool(st.best_dl[leaf]), bool(st.best_is_cat[leaf]),
                           st.best_bitset[leaf], fm_host, p.packed4)
        route_window(st.binsT, st.leaf_id, 0, st.binsT.shape[1] // self.rb,
                     route, self.rb, p.packed4)
        Cl = st.best_left[leaf, 2]
        smaller_is_left = Cl <= st.leaf_c[leaf] - Cl
        record_split(st, leaf, new_leaf, node, p, fm_host)
        if p.use_cegb_lazy:
            self._mark_seen(st.leaf_id, leaf, new_leaf, f)
        smaller = leaf if smaller_is_left else new_leaf
        small = self._hist(st.binsT, grad, hess,
                           (st.leaf_id == smaller).to(grad.dtype) * member)
        large = st.leaf_hist[leaf] - small
        left, right = (small, large) if smaller_is_left else (large, small)
        st.leaf_hist[leaf] = left
        st.leaf_hist[new_leaf] = right
        self.last_stats["k5_launches"] += 1
        self._scan(st, [leaf, new_leaf], torch.stack([left, right]), fmeta,
                   self._rows(masks, [2 * node, 2 * node + 1]))

    # ---------------------------------------------------------------- grow
    def grow(self, binsT: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, member: torch.Tensor, fmeta: FeatureMeta,
             root=None, feature_mask: Optional[torch.Tensor] = None,
             key: Optional[torch.Tensor] = None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        if root is not None:
            raise ValueError("the fused grower histograms its own root")
        n = binsT.shape[1]
        if n % self.rb:
            raise ValueError(f"Npad {n} is not a multiple of {self.rb}")
        p, L, dev = self.p, self.p.num_leaves, binsT.device
        self.last_stats = {"quant_clips": 0, "k5_launches": 1}
        st = self._state(binsT, None, grad, hess, member, fmeta)
        masks = self._node_masks(feature_mask, key, dev)
        fm_host = host_meta(fmeta)
        if p.use_cegb_lazy:
            F = fmeta.num_bin.shape[0]
            self._path = torch.zeros((L, F), dtype=torch.bool, device=dev)
            self._leaf_rows = torch.zeros(L, dtype=torch.int64, device=dev)
            self._leaf_rows[0] = n
        st.leaf_hist[0] = self._hist(binsT, grad, hess, member)
        self._scan(st, [0], st.leaf_hist[:1], fmeta,
                   self._rows(masks, [2 * L]))
        plan = p.forced_plan[:L - 1]
        for leaf, f, t in plan:
            self._force(st, leaf, f, t, fmeta, fm_host)
            self._split(st, leaf, grad, hess, member, fmeta, fm_host, masks)
        while self._can_grow(st):
            leaf = int(np.argmax(st.best_gain))
            self._split(st, leaf, grad, hess, member, fmeta, fm_host, masks)
        self.last_stats.update(splits=st.num_leaves - 1, forced=len(plan),
                               max_blocks=n // self.rb)
        self._path = self._leaf_rows = None
        return st.tree, st.leaf_id
