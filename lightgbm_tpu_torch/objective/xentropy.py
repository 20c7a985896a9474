"""Cross-entropy objectives for probabilistic labels in [0, 1].

Counterpart of lightgbm_tpu/objective/xentropy.py; reference
src/objective/xentropy_objective.hpp:44-146 (CrossEntropy: logistic link,
weights scale the gradients) and :148-260 (CrossEntropyLambda: the
log(1 + exp) link with weight-aware gradients).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction


class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label_np.min() < 0 or self.label_np.max() > 1:
            raise ValueError(f"[{self.name}]: labels must be in [0, 1]")

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        return self._apply_weights(z - self.label, z * (1.0 - z))

    def boost_from_score(self, class_id: int = 0) -> float:
        p = min(max(self._weighted_mean(self.label_np), 1e-10), 1 - 1e-10)
        return float(np.log(p / (1.0 - p)))

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-score))


class CrossEntropyLambda(CrossEntropy):
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        """Weight-aware log(1+exp) link (xentropy_objective.hpp:185-213);
        without weights, CrossEntropy's gradients."""
        if self.weights is None:
            return super().get_gradients(score)
        w = self.weights
        y = self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        return grad, a * (1.0 + y * b)

    def boost_from_score(self, class_id: int = 0) -> float:
        """initscore = log(exp(havg) - 1) (xentropy_objective.hpp:254-257)."""
        return float(np.log(max(np.expm1(self._weighted_mean(
            self.label_np)), 1e-20)))

    def convert_output(self, score):
        return np.log1p(np.exp(score))
