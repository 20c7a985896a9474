"""Host-side decision tree: prediction and the fields serialization needs.

Counterpart of lightgbm_tpu/models/tree.py (reference
include/LightGBM/tree.h:25-470 + src/io/tree.cpp).  Flat-array binary tree
with LightGBM's node numbering (internal node i created by the i+1-th
split; leaves referenced as ``~leaf``), decision_type bit flags (bit0
categorical, bit1 default-left, bits2-3 missing type), numerical
``value <= threshold`` splits with missing routing, and categorical
splits whose left-going set is a bitset over category values (outer, for
raw data) and over bin ids (inner, for binned data).

Prediction is vectorized numpy level-by-level routing, over raw feature
matrices (``predict_raw``, leaf indices ``apply_raw``) or over a
feature-major binned matrix aligned with the training bins
(``predict_binned``).
"""

from __future__ import annotations

import copy
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..utils.log import LightGBMError

K_ZERO_THRESHOLD = 1e-35
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


def bitset_contains(words: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Vectorized Common::FindInBitset (utils/common.h:893-906)."""
    ok = (vals >= 0) & (vals < len(words) * 32)
    safe = np.where(ok, vals, 0)
    return ok & (((words[safe // 32] >> (safe % 32)) & 1) > 0)


def bitset_from_values(values: List[int]) -> np.ndarray:
    """The shortest bitset (words of 32 bits) holding ``values``."""
    if not values:
        return np.zeros(1, dtype=np.uint32)
    out = np.zeros(max(values) // 32 + 1, dtype=np.uint32)
    for v in values:
        if v >= 0:
            out[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out


# a walk of more rows than this is split over the cores (Tree._walk)
PARALLEL_ROWS = 1 << 17


def _walk_workers() -> int:
    """The cores this process may run on (at most 16)."""
    cores = (len(os.sched_getaffinity(0))
             if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1)
    return min(cores, 16)


class Tree:
    """One trained decision tree (host copy)."""

    def __init__(self, num_leaves: int):
        n = max(num_leaves - 1, 0)
        self.num_leaves = num_leaves
        self.shrinkage = 1.0
        self.split_feature_inner = np.zeros(n, dtype=np.int32)
        self.split_feature = np.zeros(n, dtype=np.int32)   # real feature idx
        self.threshold_in_bin = np.zeros(n, dtype=np.int32)
        self.threshold = np.zeros(n, dtype=np.float64)     # real-valued
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.left_child = np.full(n, -1, dtype=np.int32)
        self.right_child = np.full(n, -1, dtype=np.int32)
        self.split_gain = np.zeros(n, dtype=np.float32)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_weight = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int64)
        # categorical node i: threshold_in_bin[i] indexes cat_boundaries
        self.num_cat = 0
        self.cat_boundaries = [0]
        self.cat_threshold: List[np.ndarray] = []         # category values
        self.cat_boundaries_inner = [0]
        self.cat_threshold_inner: List[np.ndarray] = []   # bin ids
        self.leaf_value = np.zeros(max(num_leaves, 1), dtype=np.float64)
        self.leaf_weight = np.zeros(max(num_leaves, 1), dtype=np.float64)
        self.leaf_count = np.zeros(max(num_leaves, 1), dtype=np.int64)
        self.leaf_parent = np.full(max(num_leaves, 1), -1, dtype=np.int32)
        self.leaf_depth = np.zeros(max(num_leaves, 1), dtype=np.int32)
        # whether threshold_in_bin, split_feature_inner and the inner
        # bitsets hold a live dataset's bins: a tree parsed from a model
        # text has real thresholds only, until ``aligned_to`` aligns it
        # with a dataset
        self.bins_aligned = True

    @classmethod
    def from_arrays(cls, arrays, dataset) -> "Tree":
        """Finalize grown TreeArrays into a Tree: real thresholds come from
        the BinMapper upper bounds (Dataset::RealThreshold); a categorical
        node's bin bitset is also written over category values
        (BinMapper bin_2_categorical)."""
        nl = int(arrays.num_leaves)
        t = cls(nl)
        n = nl - 1
        sf = np.asarray(arrays.split_feature)[:n]
        t.split_feature_inner = sf.astype(np.int32)
        used = np.asarray(dataset.used_feature_indices)
        t.split_feature = used[sf].astype(np.int32)
        t.threshold_in_bin = np.asarray(arrays.threshold_bin)[:n].astype(
            np.int32)
        t.left_child = np.asarray(arrays.left_child)[:n].astype(np.int32)
        t.right_child = np.asarray(arrays.right_child)[:n].astype(np.int32)
        t.split_gain = np.asarray(arrays.split_gain)[:n].astype(np.float32)
        t.internal_value = np.asarray(arrays.internal_value)[:n].astype(
            np.float64)
        t.internal_weight = np.asarray(arrays.internal_weight)[:n].astype(
            np.float64)
        t.internal_count = np.rint(
            np.asarray(arrays.internal_count)[:n]).astype(np.int64)
        t.leaf_value = np.asarray(arrays.leaf_value)[:nl].astype(np.float64)
        t.leaf_weight = np.asarray(arrays.leaf_weight)[:nl].astype(
            np.float64)
        t.leaf_count = np.rint(np.asarray(arrays.leaf_count)[:nl]).astype(
            np.int64)
        t.leaf_parent = np.asarray(arrays.leaf_parent)[:nl].astype(np.int32)
        t.leaf_depth = np.asarray(arrays.leaf_depth)[:nl].astype(np.int32)
        infos = dataset.feature_infos()
        dl = np.asarray(arrays.default_left)[:n]
        is_cat = np.asarray(arrays.is_cat)[:n]
        bitsets = np.asarray(arrays.cat_bitset)[:n].astype(np.uint32)
        for i in range(n):
            info = infos[int(sf[i])]
            dt = 0
            if is_cat[i]:
                dt |= K_CATEGORICAL_MASK
                bins = [b for b in range(int(info.num_bin))
                        if bitsets[i][b // 32] >> (b % 32) & 1]
                mapper = dataset.bin_mappers[int(used[sf[i]])]
                cats = [mapper.bin_2_categorical[b] for b in bins
                        if b < len(mapper.bin_2_categorical)]
                t.threshold_in_bin[i] = t.num_cat
                t.threshold[i] = float(t.num_cat)
                t.num_cat += 1
                t.cat_threshold_inner.append(bitset_from_values(bins))
                t.cat_boundaries_inner.append(
                    t.cat_boundaries_inner[-1]
                    + len(t.cat_threshold_inner[-1]))
                t.cat_threshold.append(bitset_from_values(cats))
                t.cat_boundaries.append(t.cat_boundaries[-1]
                                        + len(t.cat_threshold[-1]))
            else:
                if dl[i]:
                    dt |= K_DEFAULT_LEFT_MASK
                t.threshold[i] = dataset.real_threshold(
                    int(sf[i]), int(t.threshold_in_bin[i]))
            dt |= (int(info.missing_type) & 3) << 2
            t.decision_type[i] = dt
        return t

    def aligned_to(self, dataset) -> "Tree":
        """A copy whose bin-space split data holds ``dataset``'s bins
        (lightgbm_tpu/models/serialization.py _remap_tree_to_bins):
        numerical thresholds through BinMapper.value_to_bin of the real
        threshold (exact: a threshold is a bin's upper bound); a
        categorical node keeps its bitset index, and where the model text
        had no inner bitsets (stock LightGBM files) they are rebuilt over
        ``dataset``'s category bins, categories it never saw skipped."""
        t = copy.copy(self)
        n = self.num_leaves - 1
        t.split_feature_inner = np.asarray(
            [dataset.inner_feature_index(int(f)) for f in self.split_feature],
            dtype=np.int32)
        thr = np.zeros(n, dtype=np.int32)
        rebuild_inner = self.num_cat > 0 and not self.cat_threshold_inner
        if rebuild_inner:
            t.cat_threshold_inner = [None] * self.num_cat
        for i in range(n):
            mapper = dataset.bin_mappers[int(self.split_feature[i])]
            if not self.decision_type[i] & K_CATEGORICAL_MASK:
                thr[i] = int(mapper.value_to_bin(
                    np.asarray([self.threshold[i]]))[0])
                continue
            cat_idx = int(self.threshold_in_bin[i])
            thr[i] = cat_idx
            if rebuild_inner:
                words = self.cat_threshold[cat_idx]
                inner = np.zeros(max(1, -(-mapper.num_bin // 32)),
                                 dtype=np.uint32)
                for c in range(len(words) * 32):
                    if words[c // 32] >> (c % 32) & 1:
                        b = mapper.categorical_2_bin.get(c)
                        if b is not None:
                            inner[b // 32] |= np.uint32(1 << (b % 32))
                t.cat_threshold_inner[cat_idx] = inner
        if rebuild_inner:
            t.cat_threshold_inner = [
                w if w is not None else np.zeros(1, dtype=np.uint32)
                for w in t.cat_threshold_inner]
            # the offsets of the rebuilt words, which a save slices by
            t.cat_boundaries_inner = list(itertools.accumulate(
                (len(w) for w in t.cat_threshold_inner), initial=0))
        t.threshold_in_bin = thr
        t.bins_aligned = True
        return t

    @classmethod
    def from_grown(cls, arrays, dataset, shrinkage: float) -> "Tree":
        """Finalize one freshly-grown tree, learning rate applied."""
        t = cls.from_arrays(arrays, dataset)
        t.apply_shrinkage(shrinkage)
        return t

    # ------------------------------------------------------------ prediction
    def _walk(self, n: int, go_left_at) -> np.ndarray:
        """Leaf index of each of ``n`` rows: from the root down, each
        internal node's rows split by ``go_left_at(node, rows)`` (the
        reference's DataPartition order), so a row is looked at once for
        each node on its path.  Past PARALLEL_ROWS rows, one chunk of rows
        a core is walked in a thread (numpy's array work releases the
        GIL); a row's leaf does not depend on the chunks."""
        leaf = np.empty(n, dtype=np.int32)

        def walk(rows):
            stack = [(0, rows)]
            while stack:
                node, rows = stack.pop()
                go = go_left_at(node, rows)
                for child, sub in ((self.left_child[node], rows[go]),
                                   (self.right_child[node], rows[~go])):
                    if child < 0:
                        leaf[sub] = ~child
                    elif len(sub):
                        stack.append((child, sub))

        workers = _walk_workers()
        if n < PARALLEL_ROWS or workers == 1:
            walk(np.arange(n))
            return leaf
        bounds = np.linspace(0, n, workers + 1).astype(np.int64)
        with ThreadPoolExecutor(workers) as pool:
            # reading each result raises a chunk's exception here
            list(pool.map(walk, [np.arange(a, b) for a, b in
                                 zip(bounds[:-1], bounds[1:])]))
        return leaf

    def apply_raw(self, X: np.ndarray) -> np.ndarray:
        """Leaf index of each row of a raw feature matrix
        (NumericalDecision / CategoricalDecision, tree.h:221-278)."""
        if self.num_leaves <= 1:
            return np.zeros(X.shape[0], dtype=np.int32)

        def go_left_at(node, rows):
            fv = np.asarray(X[rows, self.split_feature[node]],
                            dtype=np.float64)
            dt = int(self.decision_type[node])
            mt = (dt >> 2) & 3
            dl = bool(dt & K_DEFAULT_LEFT_MASK)
            nan = np.isnan(fv)
            if mt != 2:
                # NaN of a feature that is not NaN-missing counts as 0
                fv = np.where(nan, 0.0, fv)
            if dt & K_CATEGORICAL_MASK:
                # NaN of a NaN-missing feature goes right; values truncate
                # to int like the reference (negative ones are in no
                # bitset)
                iv = np.where(np.isnan(fv), -1, fv).astype(np.int64)
                return bitset_contains(
                    self.cat_threshold[int(self.threshold_in_bin[node])], iv)
            go = fv <= self.threshold[node]
            if mt == 2:
                return go | nan if dl else go
            if mt == 1:
                zero = (fv > -K_ZERO_THRESHOLD) & (fv <= K_ZERO_THRESHOLD)
                return np.where(zero, dl, go)
            return go

        return self._walk(X.shape[0], go_left_at)

    def apply_binned(self, bins_t: np.ndarray, feature_infos) -> np.ndarray:
        """Leaf index of each row of a feature-major [F_used, N] binned
        matrix aligned with the training bins (NumericalDecisionInner /
        CategoricalDecisionInner,
        tree.h:243-288)."""
        n = bins_t.shape[1]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        if not self.bins_aligned:
            raise LightGBMError(
                "tree loaded from a model text has no bin thresholds; align "
                "it with a dataset first (Tree.aligned_to)")

        def go_left_at(node, rows):
            f = int(self.split_feature_inner[node])
            fv = bins_t[f][rows].astype(np.int32)
            dt = int(self.decision_type[node])
            if dt & K_CATEGORICAL_MASK:
                return bitset_contains(
                    self.cat_threshold_inner[int(self.threshold_in_bin[node])],
                    fv)
            go = fv <= self.threshold_in_bin[node]
            mt = (dt >> 2) & 3
            if mt in (1, 2):
                info = feature_infos[f]
                missing = fv == (info.default_bin if mt == 1
                                 else info.num_bin - 1)
                go = np.where(missing, bool(dt & K_DEFAULT_LEFT_MASK), go)
            return go

        return self._walk(n, go_left_at)

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.full(X.shape[0], self.leaf_value[0])
        return self.leaf_value[self.apply_raw(X)]

    def predict_binned(self, bins_t: np.ndarray,
                       feature_infos) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.full(bins_t.shape[1], self.leaf_value[0])
        return self.leaf_value[self.apply_binned(bins_t, feature_infos)]

    def apply_shrinkage(self, rate: float) -> None:
        """tree.h:149: scale leaf outputs by the learning rate."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
