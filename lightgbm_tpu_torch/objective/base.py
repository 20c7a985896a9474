"""Objective function interface.

Counterpart of lightgbm_tpu/objective/base.py; reference
include/LightGBM/objective_function.h:20-80.  Objectives map the current
raw score to per-example (gradient, hessian) pairs, and give a
boost-from-average initial score (BoostFromScore), an output link
(ConvertOutput) and, for the percentile losses, leaf-output renewal
(IsRenewTreeOutput / RenewTreeOutput).  ``get_gradients`` is a function
of tensors on the training device; labels and weights are moved there at
``init``.  Sample weights multiply the gradient and the hessian, never
the row count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class ObjectiveFunction:
    name = "custom"
    num_tree_per_iteration = 1
    is_renew_tree_output = False
    need_group = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        self.num_data = num_data
        self.device = device
        self.label_np = np.asarray(metadata.label)
        self.label = torch.from_numpy(
            np.asarray(metadata.label, dtype=np.float32)).to(device)
        self.weights_np: Optional[np.ndarray] = metadata.weights
        self.weights = (torch.from_numpy(
            np.asarray(metadata.weights, dtype=np.float32)).to(device)
            if metadata.weights is not None else None)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """Initial raw score of class ``class_id``'s trees (gbdt.cpp:420
        BoostFromAverage)."""
        return 0.0

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Link function applied for human-facing predictions."""
        return score

    def renew_tree_output(self, leaf_values: np.ndarray,
                          leaf_ids: torch.Tensor,
                          score: torch.Tensor) -> np.ndarray:
        """New leaf outputs of a tree from residual percentiles:
        ``leaf_ids`` [N] is each row's leaf in the new tree, ``score``
        [N] f32 the raw score before it; both on the training device."""
        return leaf_values

    def _apply_weights(self, grad, hess):
        if self.weights is not None:
            return grad * self.weights, hess * self.weights
        return grad, hess

    def _weighted_mean(self, values: np.ndarray) -> float:
        """The (weighted) mean of ``values``, as the JAX objectives'
        boost_from_score computes it: a numpy scalar of the arrays' type
        with weights (the callers' logs then run in that type), a float
        without."""
        if self.weights_np is not None:
            return np.sum(values * self.weights_np) / np.sum(self.weights_np)
        return float(np.mean(values))

    def __str__(self):
        return self.name


def percentile(values: np.ndarray, alpha: float) -> float:
    """Unweighted percentile (regression_objective.hpp:19-44
    PercentileFun): position (1-alpha)*n counted from the top of the
    sorted order, interpolated linearly by the fractional part."""
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    s = np.sort(values)[::-1]  # descending: pos counts from the max
    float_pos = (1.0 - alpha) * n
    pos = int(float_pos)
    if pos < 1:
        return float(s[0])
    if pos >= n:
        return float(s[-1])
    bias = float_pos - pos
    v1, v2 = float(s[pos - 1]), float(s[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(values: np.ndarray, weights: np.ndarray,
                        alpha: float) -> float:
    """Weighted percentile (regression_objective.hpp:46-75
    WeightedPercentileFun)."""
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    order = np.argsort(values, kind="stable")
    v = values[order]
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(v[pos])
    v1, v2 = float(v[pos - 1]), float(v[pos])
    if pos + 1 < n and cdf[pos + 1] - cdf[pos] >= 1.0:
        return ((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                * (v2 - v1) + v1)
    return v2
