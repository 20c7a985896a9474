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
matrices (``predict_raw``) or over a feature-major binned matrix aligned
with the training bins (``predict_binned``).
"""

from __future__ import annotations

from typing import List

import numpy as np

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

    @classmethod
    def from_grown(cls, arrays, dataset, shrinkage: float) -> "Tree":
        """Finalize one freshly-grown tree, learning rate applied."""
        t = cls.from_arrays(arrays, dataset)
        t.apply_shrinkage(shrinkage)
        return t

    # ------------------------------------------------------------ prediction
    def _categorical_left(self, vals: np.ndarray, nodes: np.ndarray,
                          bitsets: List[np.ndarray]) -> np.ndarray:
        """Whether each integer ``vals[k]`` is in the bitset of categorical
        node ``nodes[k]`` (negative values are in none)."""
        go = np.zeros(len(nodes), dtype=bool)
        idx = self.threshold_in_bin[nodes]
        for c in np.unique(idx):
            sel = idx == c
            go[sel] = bitset_contains(bitsets[int(c)], vals[sel])
        return go

    def _walk(self, go_left_fn, n: int) -> np.ndarray:
        cur = np.zeros(n, dtype=np.int32)     # internal node index
        leaf = np.full(n, -1, dtype=np.int32)
        active = np.arange(n)
        for _ in range(2 * self.num_leaves + 2):
            if not len(active):
                break
            nodes = cur[active]
            go_left = go_left_fn(active, nodes)
            nxt = np.where(go_left, self.left_child[nodes],
                           self.right_child[nodes])
            done = nxt < 0
            leaf[active[done]] = ~nxt[done]
            cur[active] = nxt
            active = active[~done]
        return leaf

    def apply_raw(self, X: np.ndarray) -> np.ndarray:
        """Leaf index of each row of a raw feature matrix
        (NumericalDecision / CategoricalDecision, tree.h:221-278)."""
        if self.num_leaves <= 1:
            return np.zeros(X.shape[0], dtype=np.int32)

        def go_left(rows, nodes):
            fv = X[rows, self.split_feature[nodes]].astype(np.float64)
            dt = self.decision_type[nodes]
            mt = (dt.astype(np.int32) >> 2) & 3
            dl = (dt & K_DEFAULT_LEFT_MASK) > 0
            nan = np.isnan(fv)
            fv = np.where(nan & (mt != 2), 0.0, fv)
            is_zero = (fv > -K_ZERO_THRESHOLD) & (fv <= K_ZERO_THRESHOLD)
            use_default = ((mt == 1) & is_zero) | ((mt == 2) & np.isnan(fv))
            go = np.where(use_default, dl, fv <= self.threshold[nodes])
            cat = (dt & K_CATEGORICAL_MASK) > 0
            if cat.any():
                # NaN of a NaN-missing feature goes right; other NaN were
                # zeroed above; values truncate to int like the reference
                # (negative ones are in no bitset)
                c = np.nonzero(cat)[0]
                iv = np.where(np.isnan(fv[c]), -1, fv[c]).astype(np.int64)
                go[c] = self._categorical_left(iv, nodes[c],
                                               self.cat_threshold)
            return go

        return self._walk(go_left, X.shape[0])

    def apply_binned(self, bins_t: np.ndarray, feature_infos) -> np.ndarray:
        """Leaf index of each row of a feature-major [F_used, N] binned
        matrix aligned with the training bins (NumericalDecisionInner /
        CategoricalDecisionInner,
        tree.h:243-288)."""
        n = bins_t.shape[1]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        nb = np.asarray([fi.num_bin for fi in feature_infos], np.int32)
        db = np.asarray([fi.default_bin for fi in feature_infos], np.int32)

        def go_left(rows, nodes):
            f = self.split_feature_inner[nodes]
            fv = bins_t[f, rows].astype(np.int32)
            dt = self.decision_type[nodes]
            mt = (dt.astype(np.int32) >> 2) & 3
            dl = (dt & K_DEFAULT_LEFT_MASK) > 0
            is_missing = (((mt == 1) & (fv == db[f]))
                          | ((mt == 2) & (fv == nb[f] - 1)))
            go = np.where(is_missing, dl, fv <= self.threshold_in_bin[nodes])
            cat = (dt & K_CATEGORICAL_MASK) > 0
            if cat.any():
                c = np.nonzero(cat)[0]
                go[c] = self._categorical_left(fv[c], nodes[c],
                                               self.cat_threshold_inner)
            return go

        return self._walk(go_left, n)

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
