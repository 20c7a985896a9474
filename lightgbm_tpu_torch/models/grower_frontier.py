"""Frontier grower: the top-K leaves split in one round, their histograms
in one kernel launch.

Counterpart of lightgbm_tpu/models/grower_frontier.py
(make_grow_tree_frontier :141, round_body :420-625).  Each round takes the
K leaves of highest cached gain, applies their splits, histograms the
children in one batched launch over the union of the K parents' windows,
and scans all 2K children in one batched best_split with one
device-to-host fetch.  With K = 1 every round is one strict best-first
split, so the tree is the segment grower's; with K > 1 a round may split
a leaf that strict best-first would have left for a just-created child
("batched best-first"), the JAX package's semantics, which the port keeps
split for split.

The round's histogram launch has three tiers (JAX: fused_route_policy,
pallas_histogram.py:1500):

  * ``"off"``: K2 route_window per split inside the parent's window, then
    K6 histogram_frontier on the K smaller children; larger = parent -
    smaller;
  * ``"k1"``: K7 histogram_frontier_routed, the K routes applied in the
    histogram pass, then the subtraction;
  * ``"fusedk"``: K7 histogram_frontier_fusedk on all 2K children, with no
    parent histogram and no subtraction.

A round launches only its valid slots (the JAX kernels' static K pads
with -1 slots, which give zeros).  The rows stay in the segment grower's
epoch-compacted layout (``compact_state``), compacted after a round once
the kernels have scanned COMPACT_WASTE x the layout since the last sort.
The JAX grower's round-carry staging (``hist_stage``) is not ported: it
removes an XLA carry copy that a host-driven loop does not make.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import histogram
from ..ops.histogram import (histogram_frontier, histogram_frontier_fusedk,
                             histogram_frontier_routed, null_route,
                             route_window, union_block_list)
from ..ops.split import FeatureMeta
from .grower import GrowerParams, TreeArrays
from .grower_seg import (COMPACT_WASTE, HostGrower, _SegState, _unpermute,
                         compact_state, record_split, split_route)

TIERS = ("off", "k1", "fusedk")


class FrontierGrower(HostGrower):
    """Batched best-first growth, K splits a round (HostGrower has the
    call contract).  ``width`` is K (clamped to [1, num_leaves - 1]);
    ``gain_ratio`` batches only leaves whose gain is at least that share
    of the round's best; ``tier`` picks the histogram launch (module
    docstring), None = the JAX package's default: "k1" when K == 1, else
    "off"."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int, width: int, gain_ratio: float = 0.0,
                 tier: Optional[str] = None):
        super().__init__(num_bins, params, block_rows)
        self.K = max(1, min(int(width), params.num_leaves - 1))
        self.gain_ratio = min(max(float(gain_ratio), 0.0), 1.0)
        if tier is None:
            tier = "k1" if self.K == 1 else "off"
        if tier not in TIERS:
            raise ValueError(f"frontier tier must be one of {TIERS}, got "
                             f"{tier!r}")
        self.tier = tier

    def _hist_batch(self, st: _SegState, targets, windows, routes,
                    scales) -> Tuple[torch.Tensor, int]:
        """The tier's kernel for the round's K splits: ([len(targets), F,
        B, 3] with the targets in order, the number of distinct blocks in
        the splits' windows).  ``windows`` are the splits' (lo, hi)
        windows in blocks; "fusedk" has two targets a split (all left
        children, then all right ones), the other tiers one.  A launch
        takes at most FRONTIER_MAX_ROUTES splits with their targets, over
        the union of their own windows (a leaf's rows lie in its window),
        so a wider round is several launches."""
        K = len(windows)
        per = 2 if self.tier == "fusedk" else 1
        cap = histogram.FRONTIER_MAX_ROUTES
        out = []
        for a in range(0, K, cap):
            b = min(a + cap, K)
            tgt = targets[a:b] + (targets[K + a:K + b] if per == 2 else [])
            block_list, n_blocks = union_block_list(
                [w[0] for w in windows[a:b]], [w[1] for w in windows[a:b]],
                [True] * (b - a))
            args = (st.binsT, st.w8, st.leaf_id,
                    block_list.to(st.binsT.device), n_blocks,
                    torch.tensor(tgt, dtype=torch.int32))
            tail = (self.B, self.rb, scales)
            if self.tier == "off":
                out.append(histogram_frontier(*args, *tail))
                continue
            fn = (histogram_frontier_fusedk if self.tier == "fusedk"
                  else histogram_frontier_routed)
            out.append(fn(*args, torch.stack(routes[a:b]), *tail)[1])
        if len(out) == 1:
            return out[0], n_blocks
        n_blocks = union_block_list([w[0] for w in windows],
                                    [w[1] for w in windows], [True] * K)[1]
        if per == 1:
            return torch.cat(out), n_blocks
        # each launch holds its left children, then its right ones
        return torch.cat([h[:len(h) // 2] for h in out]
                         + [h[len(h) // 2:] for h in out]), n_blocks

    def _round(self, st: _SegState, fmeta: FeatureMeta, fm_host,
               scales) -> None:
        """One round (round_body)."""
        K, L, dev = self.K, self.p.num_leaves, st.leaf_hist.device
        base = st.num_leaves
        # top-K by cached gain, ties to the lower leaf as lax.top_k orders
        top = np.argsort(-st.best_gain, kind="stable")[:K]
        gains = st.best_gain[top]
        valid = (gains > 0.0) & (np.arange(len(top)) < L - base)
        if self.gain_ratio > 0.0:
            valid &= gains >= np.float32(self.gain_ratio) * gains[0]
        valid &= np.cumsum(~valid) == 0            # the longest true prefix
        nv = int(valid.sum())
        leaves = [int(x) for x in top[:nv]]
        new = [base + j for j in range(nv)]
        # the smaller child from the cache, before any split is applied
        Cl = st.best_left[leaves, 2]
        smaller_is_left = Cl <= st.leaf_c[leaves] - Cl
        routes = [split_route(st, a, b, fm_host) for a, b in zip(leaves, new)]
        parents = (None if self.tier == "fusedk"
                   else st.leaf_hist[torch.tensor(leaves, device=dev)])
        for j in range(nv):
            if self.tier == "off":
                lo, hi = st.leaf_lo[leaves[j]], st.leaf_hi[leaves[j]]
                route_window(st.binsT, st.leaf_id, lo, hi - lo, routes[j],
                             self.rb)
            record_split(st, leaves[j], new[j], base - 1 + j)
        windows = [(st.leaf_lo[x], st.leaf_hi[x]) for x in leaves]
        if self.tier == "fusedk":
            # left children keep the parents' ids, right ones take the new
            children, n_un = self._hist_batch(st, leaves + new, windows,
                                              routes, scales)
        else:
            smaller = [a if s else b
                       for a, b, s in zip(leaves, new, smaller_is_left)]
            small, n_un = self._hist_batch(st, smaller, windows, routes,
                                           scales)
            large = parents - small
            sel = torch.tensor(smaller_is_left, device=dev)[:, None, None,
                                                             None]
            children = torch.cat([torch.where(sel, small, large),
                                  torch.where(sel, large, small)])
            st.leaf_hist[torch.tensor(leaves + new, device=dev)] = children
        st.scanned_since += n_un
        st.scanned_total += n_un
        self._scan(st, leaves + new, children, fmeta)

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
            # the round kernel with one target (and a null route on the
            # fused tiers) over every block
            targets = [0, -1] if self.tier == "fusedk" else [0]
            root_hist = self._hist_batch(st, targets, [(0, max_blocks)],
                                         [null_route()], scales)[0][0]
        st.leaf_hist[0] = root_hist
        st.scanned_since = st.scanned_total = max_blocks
        self._scan(st, [0], root_hist[None], fmeta)

        limit_blocks = min(max(1, int(COMPACT_WASTE * max_blocks)),
                           2**31 - 1)
        rounds = 0
        while self._can_grow(st):
            self._round(st, fmeta, fm_host, scales)
            rounds += 1
            if st.scanned_since >= limit_blocks:
                compact_state(st, L, rb)
        self.last_stats = {"scanned_blocks": st.scanned_total,
                           "compactions": st.num_sorts,
                           "max_blocks": max_blocks, "rounds": rounds,
                           "K": self.K, "tier": self.tier}
        return st.tree, _unpermute(st.order, st.leaf_id)
