"""Ensemble routing over binned rows: kernel P1 ``route_trees`` and its
plain version.

Counterpart of the JAX package's stacked-tree route
(lightgbm_tpu/models/device_predict.py ``_tree_leaves`` :99-149, which
XLA computes as gathers; there is no Pallas kernel behind it).  P1 is in
``csrc/predict.cu``.  Given a column-major bin matrix ``[G, S]`` (u8
device bins of a training or valid set, EFB-bundled or not, or i16
predict-time bins, one column a feature, that carry the -1 sentinel of
an unseen category), a stack of trees (models/device_predict.py
``TreeStack``), per-feature ``num_bin``, ``default_bin`` and EFB tables
``feat_group`` / ``feat_offset`` (feature f's bins are in column
``feat_group[f]`` at ``feat_offset[f] + bin``; a feature of offset 0 owns
its column) and an ``[C, n]`` float64 ``out`` (n <= S) holding each
class's starting values, it adds, per row and in tree order, each tree's
leaf value into the row of the tree's class (``TreeStack.tree_class``),
in place.  The additions are the host walk's, in its order, so the
result has the host walk's bits.

The training set's u8 bins may be 4-bit packed (``packed4``: two columns
a byte, ops/histogram.py pack_bins_4bit, the layout of a dataset whose bin
axis is at most 16): feature f is then the nibble of column
``feat_group[f]`` in byte row ``feat_group[f] >> 1``, before
``feat_offset`` applies.

A CPU ``out`` goes to the plain version (the JAX route's gather loop in
torch); a CUDA one to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from . import kernels
from .histogram import unpack_nibble

MISSING_ZERO = 1
MISSING_NAN = 2
CAT_WORDS = 8


def identity_tables(num_features: int, device) -> tuple:
    """(feat_group, feat_offset) of bins with one column a feature."""
    return (torch.arange(num_features, dtype=torch.int32, device=device),
            torch.zeros(num_features, dtype=torch.int32, device=device))


def route_leaves_plain(bins: torch.Tensor, stack, t: int,
                       num_bin: torch.Tensor, default_bin: torch.Tensor,
                       n: int, feat_group: torch.Tensor = None,
                       feat_offset: torch.Tensor = None,
                       packed4: bool = False) -> torch.Tensor:
    """Leaf index of each of the first ``n`` rows under tree ``t`` of
    ``stack``: [n] int64 (the JAX route's ``_tree_leaves``, with its
    ``feat_group`` / ``feat_offset`` reconstruction; None: one column a
    feature; ``packed4``: two columns a byte)."""
    if feat_group is None:
        feat_group, feat_offset = identity_tables(num_bin.shape[0],
                                                  bins.device)
    sf = stack.split_feature[t].long()
    tb = stack.threshold_bin[t]
    dt = stack.decision_type[t]
    lc = stack.left_child[t]
    rc = stack.right_child[t]
    cb = stack.cat_bitset[t]
    rows = torch.arange(n, device=bins.device)
    start = -1 if int(stack.num_leaves[t]) <= 1 else 0
    node = torch.full((n,), start, dtype=torch.int32, device=bins.device)
    for _ in range(stack.max_depth + 1):
        internal = node >= 0
        safe = node.clamp(min=0).long()
        f = sf[safe]
        col = feat_group[f].long()
        if packed4:
            fv = unpack_nibble(bins[col >> 1, rows], col)
        else:
            fv = bins[col, rows].to(torch.int32)
        off = feat_offset[f]
        fv = torch.where((off == 0) | ((fv >= off) & (fv < off + num_bin[f])),
                         fv - off, default_bin[f])
        d = dt[safe]
        is_cat = (d & 1) > 0
        mt = (d >> 2) & 3
        dl = (d & 2) > 0
        is_missing = (((mt == MISSING_ZERO) & (fv == default_bin[f]))
                      | ((mt == MISSING_NAN) & (fv == num_bin[f] - 1)))
        num_left = torch.where(is_missing, dl, fv <= tb[safe])
        # a negative bin (an unseen category) goes right
        word = cb[safe, torch.div(fv, 32, rounding_mode="floor")
                  .clamp(0, CAT_WORDS - 1).long()]
        cat_left = (((word >> torch.remainder(fv, 32)) & 1) > 0) & (fv >= 0)
        go_left = torch.where(is_cat, cat_left, num_left)
        nxt = torch.where(go_left, lc[safe], rc[safe])
        node = torch.where(internal, nxt, node)
    return (~node).clamp(min=0).long()


def route_trees_plain(bins: torch.Tensor, stack, num_bin: torch.Tensor,
                      default_bin: torch.Tensor, out: torch.Tensor,
                      feat_group: torch.Tensor = None,
                      feat_offset: torch.Tensor = None,
                      packed4: bool = False) -> torch.Tensor:
    n = out.shape[1]
    for t in range(stack.num_trees):
        leaf = route_leaves_plain(bins, stack, t, num_bin, default_bin, n,
                                  feat_group, feat_offset, packed4)
        k = int(stack.tree_class[t])
        out[k] += stack.leaf_value[t][leaf]
    return out


def route_trees(bins: torch.Tensor, stack, num_bin: torch.Tensor,
                default_bin: torch.Tensor, out: torch.Tensor,
                feat_group: torch.Tensor = None,
                feat_offset: torch.Tensor = None,
                packed4: bool = False) -> torch.Tensor:
    """P1: ``out[tree_class[t]][row] += leaf_value[t][leaf_t(row)]`` for
    every tree t of ``stack`` in order and every row < out.shape[1] of the
    column-major ``bins`` [G, S] (u8 or i16; ``packed4``: u8 [ceil(G /
    2), S], two columns a byte), each feature read out of its column by
    the [F] tables ``feat_group`` / ``feat_offset`` (None: one column a
    feature, G = F); ``out`` [C, n] float64, updated in place and
    returned."""
    if out.device.type == "cpu":
        return route_trees_plain(bins, stack, num_bin, default_bin, out,
                                 feat_group, feat_offset, packed4)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    dev = out.device
    if bins.dtype not in (torch.uint8, torch.int16) or bins.dim() != 2 \
            or not bins.is_contiguous() or bins.device != dev \
            or (packed4 and bins.dtype != torch.uint8):
        raise ValueError(f"bins must be a contiguous [F, S] uint8 or int16 "
                         f"tensor on {dev} (uint8 when packed4)")
    C, n = out.shape
    if out.dtype != torch.float64 or not out.is_contiguous() \
            or n > bins.shape[1]:
        raise ValueError(f"out must be a contiguous [C, n] float64 tensor "
                         f"with n <= {bins.shape[1]} rows")
    T, M = stack.split_feature.shape
    F = num_bin.shape[0]
    if feat_group is None:
        feat_group, feat_offset = identity_tables(F, dev)
    for name, t, dtype, shape in (
            ("split_feature", stack.split_feature, torch.int32, (T, M)),
            ("threshold_bin", stack.threshold_bin, torch.int32, (T, M)),
            ("decision_type", stack.decision_type, torch.int32, (T, M)),
            ("left_child", stack.left_child, torch.int32, (T, M)),
            ("right_child", stack.right_child, torch.int32, (T, M)),
            ("cat_bitset", stack.cat_bitset, torch.int32, (T, M, CAT_WORDS)),
            ("leaf_value", stack.leaf_value, torch.float64,
             (T, stack.leaf_value.shape[1])),
            ("num_leaves", stack.num_leaves, torch.int32, (T,)),
            ("tree_class", stack.tree_class, torch.int32, (T,)),
            ("num_bin", num_bin, torch.int32, (F,)),
            ("default_bin", default_bin, torch.int32, (F,)),
            ("feat_group", feat_group, torch.int32, (F,)),
            ("feat_offset", feat_offset, torch.int32, (F,))):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on {dev}")
    if T == 0 or n == 0:
        return out
    rc = kernels.library().lgbt_route_trees(
        bins.data_ptr(), bins.element_size(), bins.shape[1], n,
        stack.split_feature.data_ptr(), stack.threshold_bin.data_ptr(),
        stack.decision_type.data_ptr(), stack.left_child.data_ptr(),
        stack.right_child.data_ptr(), stack.cat_bitset.data_ptr(),
        stack.leaf_value.data_ptr(), stack.num_leaves.data_ptr(),
        stack.tree_class.data_ptr(), T, M, stack.leaf_value.shape[1],
        stack.max_depth, num_bin.data_ptr(), default_bin.data_ptr(),
        feat_group.data_ptr(), feat_offset.data_ptr(), C, out.data_ptr(),
        int(packed4), kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant("route_trees", packed4), rc)
    return out
