"""SHAP feature contributions (TreeSHAP), on the host.

Counterpart of lightgbm_tpu/models/shap.py (reference Tree::PredictContrib
/ TreeSHAP in src/io/tree.cpp, the ``predict_contrib`` path of c_api
predict, tree.h:128): the polynomial-time TreeSHAP algorithm (Lundberg et
al.) over the host Tree arrays.  Output layout as LightGBM's: per row,
num_features + 1 values (the last the expected value, the bias), the
classes' blocks one after the other for multiclass.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tree import Tree


class _PathElem:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index, zero_fraction, one_fraction, pweight):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight


def _extend_path(path: List[_PathElem], zero_fraction, one_fraction,
                 feature_index):
    path.append(_PathElem(feature_index, zero_fraction, one_fraction,
                          1.0 if len(path) == 0 else 0.0))
    d = len(path) - 1
    for i in range(d - 1, -1, -1):
        path[i + 1].pweight += (one_fraction * path[i].pweight * (i + 1)
                                / (d + 1))
        path[i].pweight = zero_fraction * path[i].pweight * (d - i) / (d + 1)


def _unwind_path(path: List[_PathElem], path_index):
    d = len(path) - 1
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[d].pweight
    for i in range(d - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = (next_one_portion * (d + 1)
                               / ((i + 1) * one_fraction))
            next_one_portion = (tmp - path[i].pweight * zero_fraction
                                * (d - i) / (d + 1))
        else:
            path[i].pweight = (path[i].pweight * (d + 1)
                               / (zero_fraction * (d - i)))
    for i in range(path_index, d):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElem], path_index):
    d = len(path) - 1
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[d].pweight
    total = 0.0
    for i in range(d - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (d + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = (path[i].pweight - tmp * zero_fraction
                                * ((d - i) / (d + 1)))
        else:
            total += path[i].pweight / (zero_fraction * ((d - i) / (d + 1)))
    return total


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               path: List[_PathElem], parent_zero_fraction: float,
               parent_one_fraction: float, parent_feature_index: int):
    path = [_PathElem(p.feature_index, p.zero_fraction, p.one_fraction,
                      p.pweight) for p in path]
    _extend_path(path, parent_zero_fraction, parent_one_fraction,
                 parent_feature_index)
    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, len(path)):
            w = _unwound_path_sum(path, i)
            el = path[i]
            phi[el.feature_index] += (w * (el.one_fraction - el.zero_fraction)
                                      * tree.leaf_value[leaf])
        return
    hot, cold = _decide_children(tree, x, node)
    hot_count = _node_count(tree, hot)
    cold_count = _node_count(tree, cold)
    node_count = float(tree.internal_count[node])
    feature = int(tree.split_feature[node])
    incoming_zero, incoming_one = 1.0, 1.0
    path_index = next((i for i, el in enumerate(path)
                       if el.feature_index == feature), -1)
    if path_index >= 0:
        incoming_zero = path[path_index].zero_fraction
        incoming_one = path[path_index].one_fraction
        _unwind_path(path, path_index)
    _tree_shap(tree, x, phi, hot, path,
               hot_count / node_count * incoming_zero, incoming_one, feature)
    _tree_shap(tree, x, phi, cold, path,
               cold_count / node_count * incoming_zero, 0.0, feature)


def _node_count(tree: Tree, node: int) -> float:
    if node < 0:
        return float(tree.leaf_count[~node])
    return float(tree.internal_count[node])


def _decide_children(tree: Tree, x: np.ndarray, node: int):
    """(the child ``x`` goes to, the other one) at internal ``node``."""
    if bool(tree.go_left_raw(node, [x[tree.split_feature[node]]])[0]):
        return int(tree.left_child[node]), int(tree.right_child[node])
    return int(tree.right_child[node]), int(tree.left_child[node])


def expected_value(tree: Tree) -> float:
    """The leaves' outputs weighted by their counts (the SHAP base
    value)."""
    w = tree.leaf_count[:tree.num_leaves].astype(np.float64)
    tot = w.sum()
    if tot <= 0:
        return float(tree.leaf_value[0])
    return float((tree.leaf_value[:tree.num_leaves] * w).sum() / tot)


def tree_predict_contrib(tree: Tree, X: np.ndarray,
                         num_features: int) -> np.ndarray:
    out = np.zeros((X.shape[0], num_features + 1))
    if tree.num_leaves <= 1:
        out[:, -1] += tree.leaf_value[0]
        return out
    expected = expected_value(tree)
    for r in range(X.shape[0]):
        phi = np.zeros(num_features + 1)
        phi[-1] += expected
        _tree_shap(tree, X[r], phi, 0, [], 1.0, 1.0, -1)
        out[r] += phi
    return out


def predict_contrib(gbdt, X: np.ndarray,
                    num_iteration: int = -1) -> np.ndarray:
    """[N, F + 1] (C = 1) or [N, C x (F + 1)] contributions of the first
    ``num_iteration`` iterations (<= 0: every one); each class's block
    sums to the row's raw score."""
    C = gbdt.num_tree_per_iteration
    n_iter = gbdt.iter_ if num_iteration <= 0 else min(num_iteration,
                                                       gbdt.iter_)
    nf = gbdt.max_feature_idx + 1
    out = np.zeros((C, X.shape[0], nf + 1))
    for k in range(C):
        out[k, :, -1] += gbdt.init_scores[k]
    for it in range(n_iter):
        for k in range(C):
            out[k] += tree_predict_contrib(gbdt.models[it * C + k], X, nf)
    if C == 1:
        return out[0]
    return out.transpose(1, 0, 2).reshape(X.shape[0], C * (nf + 1))
