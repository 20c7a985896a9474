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

With ``params.packed_acc`` every launch reads the packed-accumulator
stream, quantized once a tree (JAX grower_frontier.py:173-201, :263-268),
and the default tier is "off" at any K (the JAX growers keep the unfused
pair unless LIGHTGBM_TPU_FUSED_PACKED opts the fused ones in; here an
explicit ``tier`` is that opt-in).

A round launches only its valid slots (the JAX kernels' static K pads
with -1 slots, which give zeros).  The rows stay in the segment grower's
epoch-compacted layout (``compact_state``), compacted after a round once
the kernels have scanned COMPACT_WASTE x the layout since the last sort.
The JAX grower's round-carry staging (``hist_stage``) is not ported: it
removes an XLA carry copy that a host-driven loop does not make.

The round loop is driven from the host: the best-split records of every
leaf are kept on the host (one device-to-host fetch a round), and each
round's targets and routes go to the kernels by value
(``frontier_params``).  The split features ride the same host records
(JAX grower_frontier.py:214-234, :357-367): a round applies its K splits,
handing each leaf's monotone bounds to its children and marking CEGB's
used features, then scans its 2K children with those bounds and costs.
The per-tree state (``_SegState``), a split's host bookkeeping
(``record_split``) and the batched scan (``HostGrower``) are this loop's
(and the fused grower's, grower_fused.py); the segment grower grows on
the device (grower_seg.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import histogram
from ..ops.histogram import (fixed_point_scales, histogram_frontier,
                             histogram_frontier_fusedk,
                             histogram_frontier_routed, logical_columns,
                             null_route, pack_channels, pack_route,
                             quantize_pack, route_window, union_block_list)
from ..ops.split import NEG_INF, FeatureMeta, best_split, expand_group_hist
from .grower import (GrowerParams, TreeArrays, cegb_split_coupled_adjust,
                     grower_columns, mono_handoff, node_feature_mask)
from .grower_seg import COMPACT_WASTE, _check_key, _unpermute

TIERS = ("off", "k1", "fusedk")


class _SegState:
    """Per-tree state of the host-driven loop: device tensors in permuted
    row order, host bookkeeping of windows, leaf sums and best splits."""

    def __init__(self, binsT, w8, L: int, max_blocks: int, G0, H0, C0,
                 B: int, H: int, feat_used: np.ndarray):
        dev = binsT.device
        n = binsT.shape[1]
        self.binsT = binsT                      # [G, Npad] u8, permuted
        # [8, Npad] bf16 or (packed_acc) [2, Npad] int32, permuted
        self.w8 = w8
        self.order = torch.arange(n, dtype=torch.int64, device=dev)
        self.leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
        self.leaf_lo = [0] * L                  # window start block
        self.leaf_hi = [0] * L                  # window end block (excl.)
        self.leaf_hi[0] = max_blocks
        self.scanned_since = 0
        self.scanned_total = 0
        self.num_sorts = 0
        self.num_leaves = 1
        # the kernels' histograms, over their H columns (packed: 2 x the
        # byte rows)
        self.leaf_hist = torch.zeros((L, H, B, 3), dtype=torch.float32,
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
        # the split features: each leaf's monotone output bounds, and the
        # features split on so far (CEGB's coupled cost), [F] 0/1
        self.mono_lo = np.full(L, -np.inf, f32)
        self.mono_hi = np.full(L, np.inf, f32)
        self.feat_used = feat_used


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


def split_route(st: _SegState, leaf: int, new_leaf: int,
                fm_host: FeatureMeta, packed4: bool) -> torch.Tensor:
    """The route descriptor of the cached best split of ``leaf``."""
    return pack_route(leaf, new_leaf, int(st.best_feature[leaf]),
                      int(st.best_threshold[leaf]), bool(st.best_dl[leaf]),
                      bool(st.best_is_cat[leaf]), st.best_bitset[leaf],
                      fm_host, packed4)


def record_split(st: _SegState, leaf: int, new_leaf: int, node: int,
                 p: GrowerParams, fm_host: FeatureMeta) -> None:
    """Host bookkeeping of the cached best split of ``leaf`` (Tree::Split,
    tree.h:407-445): the new leaf inherits the parent's window (routing
    touches only it), the tree arrays and the two children's sums; the
    children's monotone bounds (``mono_handoff``) and the split's feature
    marked used (CEGB's coupled cost)."""
    f = int(st.best_feature[leaf])
    if p.use_monotone:
        lo_l, hi_l, lo_r, hi_r = mono_handoff(
            st.mono_lo[leaf], st.mono_hi[leaf], st.best_out[leaf, 0],
            st.best_out[leaf, 1], fm_host.monotone[f], st.best_is_cat[leaf])
        st.mono_lo[leaf], st.mono_hi[leaf] = lo_l, hi_l
        st.mono_lo[new_leaf], st.mono_hi[new_leaf] = lo_r, hi_r
    if p.use_cegb_coupled:
        st.feat_used[f] = 1.0
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


def host_meta(fmeta: FeatureMeta) -> FeatureMeta:
    """What the host loop reads of ``fmeta`` as numpy: the route words'
    metadata and EFB tables (pack_route), and the monotone constraints."""
    return FeatureMeta(*(
        None if t is None else t.cpu().numpy()
        for t in fmeta._replace(is_cat=None, gather_idx=None, penalty=None,
                                cegb_coupled=None, cegb_lazy=None,
                                cegb_used0=None)))


class HostGrower:
    """The host-driven loop's pieces: the per-tree state, the batched
    best-split scan into the host cache, the stop rule.
    ``grow(binsT, grad, hess, member, fmeta, root=None, feature_mask=None,
    key=None)`` takes column-major bins [G, Npad] (EFB groups, or the
    features; Npad a multiple of ``block_rows``; pad rows must carry
    member == 0), or with ``params.packed4`` [ceil(G / 2), Npad] of two
    columns a byte, and returns ``(TreeArrays, leaf_id)`` with leaf ids in
    the original row order.  The scan reads the first G columns of the
    kernels' histograms (SegmentGrower's).

    ``root``, when given, is ``(w8, scales, root_hist)``: this tree's
    channels as pack_channels packs them, their fixed_point_scales, and
    the root histogram [H, B, 3] at those scales, which takes the place of
    the root's own pass (K5's slice of this class is, bit for bit, what
    that pass gives).  The splits' kernels use the same ``w8`` and
    ``scales``, or with ``params.packed_acc`` the tree's own quantized
    stream.  ``feature_mask`` and ``key`` are the tree's feature
    fraction and threefry key, as SegmentGrower takes them.
    ``last_stats["quant_clips"]`` counts the values the quantizer clipped
    (0 without packed_acc)."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int):
        self.B = num_bins
        self.p = params
        self.rb = block_rows
        self.last_stats = {}

    def _start(self, binsT, grad, hess, member, fmeta, root):
        """-> (state, scales, root histogram or None); the quantizer's
        clip count goes to ``last_stats``."""
        n = binsT.shape[1]
        if n % self.rb:
            raise ValueError(f"Npad {n} is not a multiple of {self.rb}")
        root_hist = None if root is None else root[2]
        self.last_stats = {"quant_clips": 0}
        if self.p.packed_acc:
            w8, scales, clips = quantize_pack(grad, hess, member,
                                              self.p.packed_acc_bits)
            self.last_stats["quant_clips"] = int(clips)
        elif root is None:
            w8 = pack_channels(grad, hess, member)
            scales = fixed_point_scales(w8)
        else:
            w8, scales, _ = root
        return self._state(binsT, w8, grad, hess, member, fmeta), scales, \
            root_hist

    def _state(self, binsT, w8, grad, hess, member,
               fmeta: FeatureMeta) -> _SegState:
        """A tree's state over ``binsT`` and the weights ``w8``: the
        root's sums, and CEGB's used features from the model's."""
        G0, H0, C0 = torch.stack([torch.sum(grad * member),
                                  torch.sum(hess * member),
                                  torch.sum(member)]).cpu().numpy()
        F = fmeta.num_bin.shape[0]
        used0 = (np.zeros(F, np.float32) if fmeta.cegb_used0 is None
                 else fmeta.cegb_used0.cpu().numpy().astype(np.float32))
        return _SegState(binsT, w8, self.p.num_leaves,
                         binsT.shape[1] // self.rb, G0, H0, C0, self.B,
                         logical_columns(binsT, self.p.packed4), used0)

    def _scan(self, st: _SegState, leaves, hists, fmeta: FeatureMeta,
              masks=None) -> None:
        """Best split of each leaf in ``leaves`` from its histogram (over
        the columns, expanded to the features) and its sums, under its
        feature mask (``masks``: [len(leaves) or 1, F], or None); one
        device->host fetch writes the host cache (in float64
        when it carries categorical bitsets, whose 32-bit words float32
        would round).  A leaf at max_depth gets gain -inf."""
        dev = hists.device
        g, h, c = (torch.from_numpy(v[leaves]).to(dev)
                   for v in (st.leaf_g, st.leaf_h, st.leaf_c))
        G = grower_columns(self.p, st.binsT)
        lo = hi = None
        if self.p.use_monotone:
            lo, hi = (torch.from_numpy(v[leaves]).to(dev)
                      for v in (st.mono_lo, st.mono_hi))
        info = best_split(expand_group_hist(hists[:, :G], fmeta, g, h, c),
                          g, h, c, fmeta, self.p.split, masks, lo, hi,
                          self._gain_adjust(st, leaves, c, fmeta))
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

    def _gain_adjust(self, st: _SegState, leaves, c: torch.Tensor,
                     fmeta: FeatureMeta) -> Optional[torch.Tensor]:
        """[len(leaves), F] CEGB costs of the leaves' scans (split and
        coupled), None when unused."""
        if not self.p.cegb_adjusts:
            return None
        return cegb_split_coupled_adjust(
            torch.from_numpy(st.feat_used).to(c.device), c, fmeta, self.p)

    def _node_masks(self, feature_mask, key, dev):
        """The masks of the tree's node numbers 0 .. 2L
        (``node_feature_mask``), drawn at once on the device; None without
        a feature mask."""
        if feature_mask is None:
            return None
        _check_key(feature_mask, key, self.p)
        steps = torch.arange(2 * self.p.num_leaves + 1, dtype=torch.int64,
                             device=dev)
        return node_feature_mask(feature_mask.to(dev),
                                 None if key is None else key.to(dev),
                                 steps, self.p)

    @staticmethod
    def _rows(masks, steps):
        """The mask rows of the node numbers ``steps``."""
        if masks is None:
            return None
        return masks[torch.tensor(steps, device=masks.device)]

    def _can_grow(self, st: _SegState) -> bool:
        return (st.num_leaves < self.p.num_leaves
                and float(st.best_gain.max()) > 0.0)


class FrontierGrower(HostGrower):
    """Batched best-first growth, K splits a round (HostGrower has the
    call contract).  ``width`` is K (clamped to [1, num_leaves - 1]);
    ``gain_ratio`` batches only leaves whose gain is at least that share
    of the round's best; ``tier`` picks the histogram launch (module
    docstring), None = the JAX package's default: "k1" when K == 1, else
    "off", and "off" with ``params.packed_acc``."""

    def __init__(self, num_bins: int, params: GrowerParams,
                 block_rows: int, width: int, gain_ratio: float = 0.0,
                 tier: Optional[str] = None):
        super().__init__(num_bins, params, block_rows)
        self.K = max(1, min(int(width), params.num_leaves - 1))
        self.gain_ratio = min(max(float(gain_ratio), 0.0), 1.0)
        if tier is None:
            tier = "k1" if self.K == 1 and not params.packed_acc else "off"
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
            tail = (self.B, self.rb, scales, self.p.packed4)
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
               scales, masks=None) -> None:
        """One round (round_body); split j of the round is node base - 1 +
        j, its children numbered 2 node and 2 node + 1 for their masks
        (lightgbm_tpu/models/grower_frontier.py:440, :610)."""
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
        routes = [split_route(st, a, b, fm_host, self.p.packed4)
                  for a, b in zip(leaves, new)]
        parents = (None if self.tier == "fusedk"
                   else st.leaf_hist[torch.tensor(leaves, device=dev)])
        for j in range(nv):
            if self.tier == "off":
                lo, hi = st.leaf_lo[leaves[j]], st.leaf_hi[leaves[j]]
                route_window(st.binsT, st.leaf_id, lo, hi - lo, routes[j],
                             self.rb, self.p.packed4)
            record_split(st, leaves[j], new[j], base - 1 + j, self.p,
                         fm_host)
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
        lefts = [2 * (base - 1 + j) for j in range(nv)]
        self._scan(st, leaves + new, children, fmeta,
                   self._rows(masks, lefts + [x + 1 for x in lefts]))

    # ---------------------------------------------------------------- grow
    def grow(self, binsT: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, member: torch.Tensor, fmeta: FeatureMeta,
             root: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None,
             feature_mask: Optional[torch.Tensor] = None,
             key: Optional[torch.Tensor] = None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        L, rb = self.p.num_leaves, self.rb
        st, scales, root_hist = self._start(binsT, grad, hess, member, fmeta,
                                            root)
        masks = self._node_masks(feature_mask, key, binsT.device)
        max_blocks = binsT.shape[1] // rb
        fm_host = host_meta(fmeta)
        if root_hist is None:
            # the round kernel with one target (and a null route on the
            # fused tiers) over every block
            targets = [0, -1] if self.tier == "fusedk" else [0]
            root_hist = self._hist_batch(st, targets, [(0, max_blocks)],
                                         [null_route()], scales)[0][0]
        st.leaf_hist[0] = root_hist
        st.scanned_since = st.scanned_total = max_blocks
        self._scan(st, [0], root_hist[None], fmeta,
                   self._rows(masks, [2 * L]))

        limit_blocks = min(max(1, int(COMPACT_WASTE * max_blocks)),
                           2**31 - 1)
        rounds = 0
        while self._can_grow(st):
            self._round(st, fmeta, fm_host, scales, masks)
            rounds += 1
            if st.scanned_since >= limit_blocks:
                compact_state(st, L, rb)
        self.last_stats.update(scanned_blocks=st.scanned_total,
                               compactions=st.num_sorts,
                               max_blocks=max_blocks, rounds=rounds,
                               K=self.K, tier=self.tier)
        return st.tree, _unpermute(st.order, st.leaf_id)
