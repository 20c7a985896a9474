"""Host-side decision tree: prediction and the fields serialization needs.

Counterpart of lightgbm_tpu/models/tree.py (reference
include/LightGBM/tree.h:25-470 + src/io/tree.cpp).  Flat-array binary tree
with LightGBM's node numbering (internal node i created by the i+1-th
split; leaves referenced as ``~leaf``), decision_type bit flags (bit0
categorical, bit1 default-left, bits2-3 missing type) and numerical
``value <= threshold`` splits with missing routing.  The port grows
numerical splits only.

Prediction is vectorized numpy level-by-level routing, over raw feature
matrices (``predict_raw``) or over a feature-major binned matrix aligned
with the training bins (``predict_binned``).
"""

from __future__ import annotations

import numpy as np

K_ZERO_THRESHOLD = 1e-35
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


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
        self.leaf_value = np.zeros(max(num_leaves, 1), dtype=np.float64)
        self.leaf_weight = np.zeros(max(num_leaves, 1), dtype=np.float64)
        self.leaf_count = np.zeros(max(num_leaves, 1), dtype=np.int64)
        self.leaf_parent = np.full(max(num_leaves, 1), -1, dtype=np.int32)
        self.leaf_depth = np.zeros(max(num_leaves, 1), dtype=np.int32)

    @classmethod
    def from_arrays(cls, arrays, dataset) -> "Tree":
        """Finalize grown TreeArrays into a Tree: real thresholds come from
        the BinMapper upper bounds (Dataset::RealThreshold)."""
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
        for i in range(n):
            info = infos[int(sf[i])]
            dt = K_DEFAULT_LEFT_MASK if dl[i] else 0
            dt |= (int(info.missing_type) & 3) << 2
            t.decision_type[i] = dt
            t.threshold[i] = dataset.real_threshold(
                int(sf[i]), int(t.threshold_in_bin[i]))
        return t

    @classmethod
    def from_grown(cls, arrays, dataset, shrinkage: float) -> "Tree":
        """Finalize one freshly-grown tree, learning rate applied."""
        t = cls.from_arrays(arrays, dataset)
        t.apply_shrinkage(shrinkage)
        return t

    # ------------------------------------------------------------ prediction
    def _check_numerical(self) -> None:
        if np.any(self.decision_type[: self.num_leaves - 1]
                  & K_CATEGORICAL_MASK):
            raise NotImplementedError(
                "categorical splits are not supported by lightgbm_tpu_torch")

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
        (NumericalDecision, tree.h:221-241)."""
        if self.num_leaves <= 1:
            return np.zeros(X.shape[0], dtype=np.int32)
        self._check_numerical()

        def go_left(rows, nodes):
            fv = X[rows, self.split_feature[nodes]].astype(np.float64)
            dt = self.decision_type[nodes]
            mt = (dt.astype(np.int32) >> 2) & 3
            dl = (dt & K_DEFAULT_LEFT_MASK) > 0
            nan = np.isnan(fv)
            fv = np.where(nan & (mt != 2), 0.0, fv)
            is_zero = (fv > -K_ZERO_THRESHOLD) & (fv <= K_ZERO_THRESHOLD)
            use_default = ((mt == 1) & is_zero) | ((mt == 2) & np.isnan(fv))
            return np.where(use_default, dl, fv <= self.threshold[nodes])

        return self._walk(go_left, X.shape[0])

    def apply_binned(self, bins_t: np.ndarray, feature_infos) -> np.ndarray:
        """Leaf index of each row of a feature-major [F_used, N] binned
        matrix aligned with the training bins (NumericalDecisionInner,
        tree.h:243-262)."""
        n = bins_t.shape[1]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        self._check_numerical()
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
            return np.where(is_missing, dl,
                            fv <= self.threshold_in_bin[nodes])

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
