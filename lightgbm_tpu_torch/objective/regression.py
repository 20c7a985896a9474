"""L2 regression objective, the default objective.

Counterpart of lightgbm_tpu/objective/regression.py (RegressionL2Loss),
after the reference's src/objective/regression_objective.hpp:78:
grad = score - label, hess = 1; with ``reg_sqrt`` the label is replaced by
sign(y) sqrt(|y|) and predictions are squared back; boost-from-average
starts from the mean (transformed) label.  The port has no sample
weights, so the hessian is always constant.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction


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
        else:
            self.trans_label_np = self.label_np
        self.trans_label = torch.from_numpy(
            np.asarray(self.trans_label_np, dtype=np.float32)).to(device)

    def get_gradients(self, score):
        return score - self.trans_label, torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.mean(self.trans_label_np))

    def convert_output(self, score):
        if self.sqrt:
            return np.sign(score) * score * score
        return score
