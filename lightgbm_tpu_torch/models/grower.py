"""Shared pieces of the tree growers: parameters, the flat tree arrays,
the routing rule and the split features' bookkeeping.

Counterpart of lightgbm_tpu/models/grower.py (GrowerParams :42,
TreeArrays :81, routed_left :233, _node_feature_mask :245, the split
features :256-296).  TreeArrays are a grown tree's numpy arrays on the
host, in LightGBM's node numbering (Tree::Split, tree.h:407-445: new
internal node = num_leaves-1, right child leaf = num_leaves, leaf refs
stored as ~leaf).  The fused grower, JAX's make_grow_tree, is
grower_fused.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..core.binning import MISSING_NAN, MISSING_ZERO
from ..ops.split import FeatureMeta, SplitParams
from ..utils import random


class GrowerParams(NamedTuple):
    """Growth hyper-parameters, and the bin matrix's layout: ``packed4``,
    two <= 16-bin columns a byte (ops/histogram.py pack_bins_4bit), and
    ``num_columns``, its columns (EFB groups, or the features; 0 = its
    rows, which packing halves).  ``packed_acc``: the histogram kernels
    read the packed-accumulator stream, quantized once a tree at
    ``packed_acc_bits`` (ops/histogram.py quantize_pack), in place of the
    fixed-point channels (the JAX package's LIGHTGBM_TPU_PACKED_ACC=force
    and LIGHTGBM_TPU_PACKED_BITS).  ``onehot``: the fused grower's
    histograms are B3 (ops/histogram.py histogram_chunked, the JAX
    package's onehot path) in place of K5.

    The split features (lightgbm_tpu/models/grower.py:59-73):
    ``use_monotone``, some feature carries a monotone constraint, so each
    leaf keeps output bounds its children inherit (``mono_handoff``);
    CEGB's ``cegb_tradeoff`` and ``cegb_penalty_split`` (a split's cost a
    row), ``use_cegb_coupled`` (a feature's cost until the model first
    splits on it) and ``use_cegb_lazy`` (a feature's cost a row until
    that row first passes a split on it: the fused grower only); and
    ``forced_plan``, the (leaf, feature, threshold bin) splits every tree
    makes first, breadth-first (the fused grower only)."""
    num_leaves: int = 31
    max_depth: int = -1
    split: SplitParams = SplitParams()
    feature_fraction_bynode: float = 1.0
    packed4: bool = False
    num_columns: int = 0
    packed_acc: bool = False
    packed_acc_bits: int = 8
    use_monotone: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    use_cegb_coupled: bool = False
    use_cegb_lazy: bool = False
    forced_plan: tuple = ()
    onehot: bool = False

    @property
    def cegb_adjusts(self) -> bool:
        """Whether the split and coupled costs adjust the scans' gains
        (the segment and frontier growers' rule, grower_seg.py:534)."""
        return self.cegb_penalty_split > 0.0 or self.use_cegb_coupled


def grower_columns(p: GrowerParams, binsT: torch.Tensor) -> int:
    """The bin matrix's columns G (grower_seg.py's G_cols): the
    histograms' first columns, before the pad nibble of an odd G."""
    if p.num_columns:
        return p.num_columns
    return 2 * binsT.shape[0] if p.packed4 else binsT.shape[0]


def node_feature_mask(base_mask: torch.Tensor, key: torch.Tensor,
                      step: torch.Tensor, p: GrowerParams) -> torch.Tensor:
    """The feature masks of the nodes numbered ``step`` ([K] int64): each
    a bernoulli(feature_fraction_bynode) draw over the features from
    fold_in(key, step), times the tree's ``base_mask`` [F]; a draw that
    keeps no feature falls back to ``base_mask`` (JAX's semantics).  [K,
    F] float32, computed on ``key``'s device with no host read.  The
    growers number a tree's nodes as the JAX growers do: 2L for the root,
    2s and 2s + 1 for the children of split s."""
    base = base_mask.to(torch.float32)
    if p.feature_fraction_bynode >= 1.0:
        return base.expand(step.shape[0], -1)
    keys = random.fold_in(key, step)                          # [K, 2]
    m = random.bernoulli(keys, p.feature_fraction_bynode,
                         base.shape[0]).to(torch.float32) * base
    return torch.where(m.sum(dim=1, keepdim=True) > 0, m, base)


def mono_handoff(lo_p, hi_p, out_l, out_r, mono_f, cat):
    """The children's output bounds after a split whose outputs are
    ``out_l``/``out_r`` (serial_tree_learner.cpp:892-903;
    lightgbm_tpu/models/grower.py:284-295): mid = (out_l + out_r) / 2 in
    float32 becomes the left child's upper bound and the right child's
    lower one under an increasing constraint, the other way round under a
    decreasing one, and neither on a categorical split.  Tensors or numpy
    float32 values alike; returns (lo_l, hi_l, lo_r, hi_r)."""
    mid = (out_l + out_r) / 2
    pos = (mono_f > 0) & ~cat
    neg = (mono_f < 0) & ~cat
    if isinstance(mid, torch.Tensor):
        where = torch.where
    else:
        where = np.where
    return (where(neg, mid, lo_p), where(pos, mid, hi_p),
            where(pos, mid, lo_p), where(neg, mid, hi_p))


def cegb_split_coupled_adjust(feat_used: torch.Tensor, c: torch.Tensor,
                              fmeta: FeatureMeta,
                              p: GrowerParams) -> torch.Tensor:
    """[K, F] float32 CEGB cost of splitting each of K leaves of counts
    ``c`` [K] on each feature: tradeoff x penalty_split a row, plus, with
    ``use_cegb_coupled``, tradeoff x the feature's coupled cost where
    ``feat_used`` [F] (0/1) says the model has not split on it yet
    (serial_tree_learner.cpp:582-607; lightgbm_tpu/models/grower.py
    _cegb_split_coupled_adjust :256-265).  The float32 operands are those
    of the JAX package, so the sums round alike; no host value is read
    and none copied, so a CUDA graph can hold it."""
    F = feat_used.shape[0]
    split = torch.full((1, F), np.float32(p.cegb_tradeoff
                                          * p.cegb_penalty_split),
                       dtype=torch.float32, device=c.device)
    adjust = split * c.to(torch.float32)[:, None]
    if p.use_cegb_coupled:
        # a Python scalar meets a float32 tensor as a float32 (as JAX's
        # weak type does), and makes no host-to-device copy in a capture
        adjust = adjust + (p.cegb_tradeoff * fmeta.cegb_coupled
                           * (1.0 - feat_used))[None, :]
    return adjust


@dataclass
class TreeArrays:
    """Flat-array tree on the host; mirrors reference Tree storage
    (include/LightGBM/tree.h:330-404).  Internal nodes [L-1], leaves [L];
    a categorical node holds its left-going bins in ``cat_bitset``."""
    L: int
    num_leaves: int = 1
    split_feature: np.ndarray = field(init=False)
    threshold_bin: np.ndarray = field(init=False)
    default_left: np.ndarray = field(init=False)
    is_cat: np.ndarray = field(init=False)
    cat_bitset: np.ndarray = field(init=False)
    left_child: np.ndarray = field(init=False)
    right_child: np.ndarray = field(init=False)
    split_gain: np.ndarray = field(init=False)
    internal_value: np.ndarray = field(init=False)
    internal_weight: np.ndarray = field(init=False)
    internal_count: np.ndarray = field(init=False)
    leaf_value: np.ndarray = field(init=False)
    leaf_weight: np.ndarray = field(init=False)
    leaf_count: np.ndarray = field(init=False)
    leaf_parent: np.ndarray = field(init=False)
    leaf_depth: np.ndarray = field(init=False)

    def __post_init__(self):
        n, L = self.L - 1, self.L
        self.split_feature = np.zeros(n, np.int32)
        self.threshold_bin = np.zeros(n, np.int32)
        self.default_left = np.zeros(n, bool)
        self.is_cat = np.zeros(n, bool)
        # left-going bins of a categorical split: 8 words of 32 bits
        self.cat_bitset = np.zeros((n, 8), np.uint32)
        self.left_child = np.full(n, -1, np.int32)
        self.right_child = np.full(n, -1, np.int32)
        self.split_gain = np.zeros(n, np.float32)
        self.internal_value = np.zeros(n, np.float32)
        self.internal_weight = np.zeros(n, np.float32)
        self.internal_count = np.zeros(n, np.float32)
        self.leaf_value = np.zeros(L, np.float32)
        self.leaf_weight = np.zeros(L, np.float32)
        self.leaf_count = np.zeros(L, np.float32)
        self.leaf_parent = np.full(L, -1, np.int32)
        self.leaf_depth = np.zeros(L, np.int32)


def routed_left(fcol: torch.Tensor, threshold: int, default_left: bool,
                is_cat: bool, cat_bitset: torch.Tensor, missing_type: int,
                default_bin: int, num_bin: int) -> torch.Tensor:
    """Which side each row goes: numerical ``<= threshold`` with missing
    routing, or categorical bitset membership (``cat_bitset``: 8 words of
    32 bits as an int64 tensor; a bin of 256 or more is in none, and goes
    right, as the host walk sends it: the JAX package reads bit 255 for
    it, but cannot write such a split into its tree, ROADMAP C)."""
    fcol = fcol.to(torch.int64)
    is_missing = (((missing_type == MISSING_ZERO) & (fcol == default_bin))
                  | ((missing_type == MISSING_NAN) & (fcol == num_bin - 1)))
    num_left = torch.where(is_missing, torch.full_like(fcol, default_left,
                                                       dtype=torch.bool),
                           fcol <= threshold)
    if not is_cat:
        return num_left
    idx = torch.clamp(fcol, 0, 255)
    word = cat_bitset[idx // 32]
    return ((word >> (idx % 32)) & 1).to(torch.bool) & (fcol < 256)
