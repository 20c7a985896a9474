"""The stacked-tree route: trees as device tensors, routed by kernel P1.

Counterpart of lightgbm_tpu/models/device_predict.py (``stack_trees_host``
:40, ``stack_trees`` :87, ``predict_binned_ensemble`` :152,
``predict_binned_leaves`` :176).  Every tree's flat arrays are stacked
into [T, ...] arrays on the host, and ``TreeStack`` folds each node with
the feature tables of the bins it will route into one 16-byte record
(ops/predict.py ``pack_route_records``), uploaded as one buffer; P1
(ops/predict.py ``route_trees``) routes every row through every tree and
adds the leaf values in float64, in tree order, into the score of each
tree's class: the host walk's bits.  The JAX package fetched [T, N] leaf
indices and gathered on the host; the kernel adds where it routes, so
nothing of size [T, N] is written.

Users (models/gbdt.py): ``GBDT.predict`` under ``predict_device`` (on
i16 bins of raw rows, ``bin_rows``, one column a feature: P1 gets
identity tables), and the training loop's walks of a card booster (valid
scores, ``add_valid``'s replay, rollback, DART's drops, ``init_model``'s
seeding) on the u8 device bins of the training and valid sets, in their
EFB column layout: P1 reads feature f out of column ``feat_group[f]`` at
``feat_offset[f] + bin``, as the JAX route does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.binning import MISSING_NAN
from ..core.dataset import TorchDataset, _per_feature
from ..ops.predict import RouteTables, pack_route_records, route_tables
from ..utils.log import LightGBMError
from .tree import Tree


def leaf_depths(tree: Tree) -> np.ndarray:
    """[num_leaves] the internal nodes on each leaf's path from the root
    (the bins the route reads for a row that ends there), from the
    children arrays, so that a tree loaded from a model text, which has
    no leaf depths, counts too."""
    depth = np.zeros(max(tree.num_leaves, 1), dtype=np.int64)
    todo = [(0, 1)] if tree.num_leaves > 1 else []
    while todo:
        node, d = todo.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                depth[~child] = d
            else:
                todo.append((int(child), d + 1))
    return depth


def tree_depth(tree: Tree) -> int:
    """The most internal nodes on a path from the root to a leaf (the JAX
    Tree's ``max_depth`` for a grown tree)."""
    return int(leaf_depths(tree).max())


def _stack_arrays(trees: Sequence[Tree], num_features: int):
    """stack_trees_host's arrays, with each tree's depth ([T] i64, 0 for
    a single leaf) in place of their maximum."""
    T = len(trees)
    for i, t in enumerate(trees):
        if not t.bins_aligned:
            raise LightGBMError(
                f"tree {i} was loaded from a model file and its bin "
                f"thresholds are not aligned with any dataset; remap "
                f"before binned prediction")
    M = max([max(t.num_leaves - 1, 1) for t in trees], default=1)
    L = max([max(t.num_leaves, 1) for t in trees], default=1)
    sf = np.zeros((T, M), dtype=np.int32)
    tb = np.zeros((T, M), dtype=np.int32)
    dt = np.zeros((T, M), dtype=np.int32)
    lc = np.full((T, M), -1, dtype=np.int32)
    rc = np.full((T, M), -1, dtype=np.int32)
    cb = np.zeros((T, M, 8), dtype=np.uint32)
    lv = np.zeros((T, L), dtype=np.float64)
    nl = np.ones(T, dtype=np.int32)
    depths = np.zeros(T, dtype=np.int64)
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        nl[i] = t.num_leaves
        lv[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        if n <= 0:
            continue
        top = int(np.max(t.split_feature_inner[:n]))
        if num_features >= 0 and top >= num_features:
            raise LightGBMError(
                f"tree {i} splits on feature {top} but the bin matrix has "
                f"only {num_features} features")
        sf[i, :n] = t.split_feature_inner[:n]
        tb[i, :n] = t.threshold_in_bin[:n]
        dt[i, :n] = t.decision_type[:n].astype(np.int32)
        lc[i, :n] = t.left_child[:n]
        rc[i, :n] = t.right_child[:n]
        for node in range(n):
            if dt[i, node] & 1:
                words = t.cat_threshold_inner[int(t.threshold_in_bin[node])]
                cb[i, node, :min(len(words), 8)] = words[:8]
                tb[i, node] = 0
        depths[i] = tree_depth(t)
    return sf, tb, dt, lc, rc, cb, lv, nl, depths


def stack_trees_host(trees: Sequence[Tree], num_features: int = -1):
    """(split_feature, threshold_bin, decision_type, left_child,
    right_child, cat_bitset, leaf_value, num_leaves, max_depth) of
    ``trees``: [T, M] i32 arrays (M = the most internal nodes, at least 1),
    [T, M, 8] u32 inner bitsets, [T, L] float64 leaf values, [T] i32 leaf
    counts.  The JAX package's ``stack_trees_host`` with float64 leaf
    values (its are float32).  Raises on a tree whose bin thresholds are
    not aligned with a dataset, and, given ``num_features``, on a split of
    a feature outside the bin matrix."""
    *arrays, depths = _stack_arrays(trees, num_features)
    return (*arrays, int(max(1, depths.max(initial=0))))


# the plain version's fields of a TreeStack, uploaded at first use
_PLAIN_FIELDS = ("split_feature", "threshold_bin", "decision_type",
                 "left_child", "right_child", "cat_bitset", "leaf_value",
                 "num_leaves", "tree_class")


class TreeStack:
    """An ensemble for P1: each tree's class (``classes``, host; the score
    row P1 adds it into), the routing bound ``max_depth``, and two device
    forms, each made at first use.  ``records(F)``: the kernel's buffer
    (ops/predict.py ``pack_route_records``: the trees' nodes folded with
    ``tables``, the per-feature RouteTables of the bins they will route,
    into 16-byte records), one upload.  The plain version's tensors
    (``stack_trees_host``'s arrays, the bitsets as int32 bit patterns, and
    ``tree_class``) as attributes of those names."""

    def __init__(self, trees: Sequence[Tree], classes: Sequence[int],
                 num_features: int, device: torch.device,
                 tables: Optional[RouteTables] = None):
        *arrays, self._depths = _stack_arrays(trees, num_features)
        self.classes = np.asarray(classes, dtype=np.int64)
        if self.classes.shape != (len(trees),):
            raise ValueError(f"{len(self.classes)} classes for "
                             f"{len(trees)} trees")
        self._host = dict(zip(_PLAIN_FIELDS, arrays),
                          tree_class=self.classes.astype(np.int32))
        self.num_trees = len(trees)
        self.max_depth = int(max(1, self._depths.max(initial=0)))
        self.device = device
        self.tables = tables
        self._records = None

    def __getattr__(self, name):
        if name in _PLAIN_FIELDS:
            a = self._host[name]
            if name == "cat_bitset":
                a = a.view(np.int32)
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            setattr(self, name, t)
            return t
        raise AttributeError(name)

    def records(self, num_features: int):
        """(int32 buffer on the device, RecordLayout): the stack packed
        with its tables, which must cover ``num_features`` features."""
        if self.tables is None:
            raise ValueError("the stack was built without its feature "
                             "tables (TreeStack(..., tables=)): P1 cannot "
                             "route it on the card")
        if self.tables.num_bin.shape[0] != num_features:
            raise ValueError(f"the stack's tables cover "
                             f"{self.tables.num_bin.shape[0]} features, "
                             f"the call {num_features}")
        if self._records is None:
            h = self._host
            buf, layout = pack_route_records(
                h["split_feature"], h["threshold_bin"], h["decision_type"],
                h["left_child"], h["right_child"], h["cat_bitset"],
                h["leaf_value"],
                h["num_leaves"], self._depths, self.classes, self.tables)
            self._records = (torch.from_numpy(buf).to(self.device), layout)
        return self._records


def dataset_tables(dataset: TorchDataset):
    """The RouteTables of ``dataset``'s bins: (its EFB columns and
    offsets, for the device bins of the set and of valid sets in its
    layout; one column a feature, for predict-time ``bin_rows``)."""
    infos = dataset.feature_infos()

    def col(name):
        return np.array([getattr(i, name) for i in infos], dtype=np.int64)

    nb, db = col("num_bin"), col("default_bin")
    own = route_tables(nb, db)
    if dataset.bundle is None:
        return own, own
    return route_tables(nb, db, col("group"), col("offset")), own


def bin_rows(dataset: TorchDataset, X: np.ndarray) -> np.ndarray:
    """Feature-major [F_used, N] int16 bins of raw rows ``X`` by
    ``dataset``'s bin mappers (``value_to_bin``), a category the mapper
    never saw (or a negative one) as -1, which P1 sends right as the
    host's raw walk does (lightgbm_tpu/models/gbdt.py:2170-2186).  A NaN
    category is category 0, as the raw walk reads it, unless the feature
    is NaN-missing (then -1); the JAX package's route sends every NaN
    category right, and so differs from its own host walk there.
    Past PARALLEL_ROWS rows, one feature a thread."""
    used = dataset.used_feature_indices
    out = np.empty((len(used), X.shape[0]), dtype=np.int16)

    def bin_feature(j):
        m = dataset.bin_mappers[int(used[j])]
        col = np.asarray(X[:, int(used[j])], dtype=np.float64)
        if m.is_categorical and m.missing_type != MISSING_NAN:
            # a NaN category counts as category 0 unless NaN is the
            # feature's missing value (CategoricalDecision, tree.h)
            col = np.where(np.isnan(col), 0.0, col)
        b = m.value_to_bin(col)
        if m.is_categorical:
            iv = np.where(np.isfinite(col), col, -1).astype(np.int64)
            if m.categorical_2_bin:
                cats = np.fromiter(m.categorical_2_bin.keys(),
                                   dtype=np.int64)
                seen = np.isin(iv, cats) & (iv >= 0)
            else:
                seen = np.zeros(len(iv), dtype=bool)
            b = np.where(seen, b, -1)
        out[j] = b

    _per_feature(bin_feature, range(len(used)), X.shape[0])
    return out
