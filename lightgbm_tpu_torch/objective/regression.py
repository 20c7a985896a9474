"""Regression objective family.

Counterpart of lightgbm_tpu/objective/regression.py, after the
reference's src/objective/regression_objective.hpp: L2 (:78, with
reg_sqrt; the default objective), L1 (:189, weighted-median leaf
renewal), Huber (:275), Fair (:337), Poisson (:384, log link), Quantile
(:464, quantile leaf renewal), MAPE (:562), Gamma (:661) and Tweedie
(:696).  Each GetGradients formula as the JAX package has it, on device
tensors; leaf renewal uses the reference's (weighted) percentiles
(regression_objective.hpp:19-75).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import ObjectiveFunction, percentile, weighted_percentile


def _renew_by_percentile(leaf_values: np.ndarray, leaf_ids: torch.Tensor,
                         residual: torch.Tensor,
                         weights: Optional[torch.Tensor],
                         alpha: float) -> np.ndarray:
    """Each leaf's output refit to a (weighted) percentile of its rows'
    residuals (RenewTreeOutput of the L1 family).

    The rows are grouped by leaf on ``residual``'s device: one stable
    sort by residual, then one stable sort by leaf id, so each leaf's rows
    arrive sorted by residual with ties in row order.  The host then takes
    each leaf's percentile over its contiguous run: the same values, in the
    order the JAX package's per-leaf ``leaf_ids == leaf`` mask and stable
    argsort give them, so the result is bit for bit its own."""
    out = np.array(leaf_values, dtype=np.float64)
    # + 0.0: -0.0 sorts with +0.0, as numpy compares them
    by_value = torch.sort(residual + 0.0, stable=True).indices
    leaf = leaf_ids.long()
    order = by_value[torch.sort(leaf[by_value], stable=True).indices]
    counts = torch.bincount(leaf, minlength=len(out)).cpu().numpy()
    r = residual[order].cpu().numpy()
    w = weights[order].cpu().numpy() if weights is not None else None
    ends = np.cumsum(counts)
    for k in range(len(out)):
        if counts[k] == 0:
            continue
        run = slice(ends[k] - counts[k], ends[k])
        out[k] = (percentile(r[run], alpha) if w is None
                  else weighted_percentile(r[run], w[run], alpha))
    return out


class RegressionL2Loss(ObjectiveFunction):
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.trans_label_np = (np.sign(self.label_np)
                                   * np.sqrt(np.abs(self.label_np)))
            self.trans_label = torch.from_numpy(np.asarray(
                self.trans_label_np, dtype=np.float32)).to(device)
        else:
            self.trans_label_np = self.label_np
            self.trans_label = self.label

    def get_gradients(self, score):
        return self._apply_weights(score - self.trans_label,
                                   torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(self._weighted_mean(self.trans_label_np))

    def convert_output(self, score):
        if self.sqrt:
            return np.sign(score) * score * score
        return score


class _PercentileLoss(ObjectiveFunction):
    """A loss whose leaves are refit to a percentile of their residuals:
    ``alpha`` the percentile, ``renew_weights`` the rows' weights in it."""
    is_renew_tree_output = True
    alpha = 0.5

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.renew_weights = self.weights

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self.label_np.astype(np.float64)
        if self.weights_np is not None:
            return weighted_percentile(label, self.weights_np, self.alpha)
        return percentile(label, self.alpha)

    def renew_tree_output(self, leaf_values, leaf_ids, score):
        residual = self.label.double() - score.double()
        return _renew_by_percentile(leaf_values, leaf_ids, residual,
                                    self.renew_weights, self.alpha)


class RegressionL1Loss(_PercentileLoss):
    name = "regression_l1"

    def get_gradients(self, score):
        return self._apply_weights(torch.sign(score - self.label),
                                   torch.ones_like(score))


class RegressionHuberLoss(RegressionL2Loss):
    """Huber loss (regression_objective.hpp:275); L2's boost-from-average."""
    name = "huber"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.alpha = float(self.config.alpha)

    def get_gradients(self, score):
        diff = score - self.label
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return self._apply_weights(grad, torch.ones_like(score))

    def convert_output(self, score):
        return score


class RegressionFairLoss(RegressionL2Loss):
    """Fair loss (regression_objective.hpp:337)."""
    name = "fair"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.c = float(self.config.fair_c)

    def get_gradients(self, score):
        x = score - self.label
        c = self.c
        grad = c * x / (torch.abs(x) + c)
        hess = c * c / (torch.abs(x) + c) ** 2
        return self._apply_weights(grad, hess)


class _LogLinkLoss(ObjectiveFunction):
    """Poisson, Gamma and Tweedie: exp link, boost from the log of the
    (weighted) mean label."""

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(self._weighted_mean(self.label_np), 1e-20)))

    def convert_output(self, score):
        return np.exp(score)


class RegressionPoissonLoss(_LogLinkLoss):
    name = "poisson"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(self.label_np < 0):
            raise ValueError(
                "[poisson]: at least one target label is negative")
        self.max_delta_step = float(self.config.poisson_max_delta_step)

    def get_gradients(self, score):
        return self._apply_weights(torch.exp(score) - self.label,
                                   torch.exp(score + self.max_delta_step))


class RegressionQuantileLoss(_PercentileLoss):
    name = "quantile"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.alpha = float(self.config.alpha)

    def get_gradients(self, score):
        grad = torch.where(score - self.label >= 0,
                           torch.full_like(score, 1.0 - self.alpha),
                           torch.full_like(score, -self.alpha))
        return self._apply_weights(grad, torch.ones_like(score))


class RegressionMAPELoss(_PercentileLoss):
    """MAPE: each row weighted by 1 / max(1, |label|) (times its sample
    weight) in the gradient, the start and the renewal."""
    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.label_weight_np = 1.0 / np.maximum(1.0, np.abs(self.label_np))
        if self.weights_np is not None:
            self.label_weight_np = self.label_weight_np * self.weights_np
        self.label_weight = torch.from_numpy(np.asarray(
            self.label_weight_np, dtype=np.float32)).to(device)
        # the renewal's cumulative weights keep the host array's type
        self.renew_weights = torch.from_numpy(
            np.ascontiguousarray(self.label_weight_np)).to(device)

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        hess = (torch.ones_like(score) if self.weights is None
                else self.weights * torch.ones_like(score))
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self.label_np.astype(np.float64),
                                   self.label_weight_np, 0.5)


class RegressionGammaLoss(_LogLinkLoss):
    name = "gamma"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(self.label_np <= 0):
            raise ValueError("[gamma]: labels must be positive")

    def get_gradients(self, score):
        e = torch.exp(-score)
        return self._apply_weights(1.0 - self.label * e, self.label * e)


class RegressionTweedieLoss(_LogLinkLoss):
    name = "tweedie"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.rho = float(self.config.tweedie_variance_power)

    def get_gradients(self, score):
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._apply_weights(grad, hess)
