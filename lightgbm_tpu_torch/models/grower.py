"""Shared pieces of the tree growers: parameters, the flat tree arrays and
the routing rule.

Counterpart of lightgbm_tpu/models/grower.py (GrowerParams :42,
TreeArrays :81, routed_left :233, _node_feature_mask :245).  TreeArrays
are a grown tree's numpy arrays on the host, in LightGBM's node numbering
(Tree::Split, tree.h:407-445: new internal node = num_leaves-1, right
child leaf = num_leaves, leaf refs stored as ~leaf).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..core.binning import MISSING_NAN, MISSING_ZERO
from ..ops.split import SplitParams
from ..utils import random


class GrowerParams(NamedTuple):
    """Growth hyper-parameters, and the bin matrix's layout: ``packed4``,
    two <= 16-bin columns a byte (ops/histogram.py pack_bins_4bit), and
    ``num_columns``, its columns (EFB groups, or the features; 0 = its
    rows, which packing halves).  ``packed_acc``: the histogram kernels
    read the packed-accumulator stream, quantized once a tree at
    ``packed_acc_bits`` (ops/histogram.py quantize_pack), in place of the
    fixed-point channels (the JAX package's LIGHTGBM_TPU_PACKED_ACC=force
    and LIGHTGBM_TPU_PACKED_BITS)."""
    num_leaves: int = 31
    max_depth: int = -1
    split: SplitParams = SplitParams()
    feature_fraction_bynode: float = 1.0
    packed4: bool = False
    num_columns: int = 0
    packed_acc: bool = False
    packed_acc_bits: int = 8


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
    32 bits as an int64 tensor)."""
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
    return ((word >> (idx % 32)) & 1).to(torch.bool)
