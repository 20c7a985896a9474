"""Binary log-loss objective.

Counterpart of lightgbm_tpu/objective/binary.py; reference
src/objective/binary_objective.hpp:21-180: labels converted to +-1,
sigmoid-scaled logistic gradients, is_unbalance / scale_pos_weight label
weighting (sample weights multiplied after it), boost-from-average in
log-odds of the (weighted) positive rate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import check, log_info
from .base import ObjectiveFunction


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        check(self.sigmoid > 0, "sigmoid parameter must be positive")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        # positive <=> label > 0 (binary_objective.hpp:35 is_pos default)
        is_pos = self.label_np > 0
        cnt_pos = int(is_pos.sum())
        cnt_neg = int(self.num_data - cnt_pos)
        if cnt_neg == 0 or cnt_pos == 0:
            log_info("Contains only one class")
        # is_unbalance: weight each class by the other's frequency
        # (binary_objective.hpp:60-80)
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg, w_pos = 1.0, cnt_pos / cnt_neg
            else:
                w_neg, w_pos = cnt_neg / cnt_pos, 1.0
        else:
            w_neg, w_pos = 1.0, float(self.config.scale_pos_weight)
        self.cnt_pos = cnt_pos
        self.sign_label = torch.from_numpy(
            np.where(is_pos, 1.0, -1.0).astype(np.float32)).to(device)
        self.label_weight = torch.from_numpy(
            np.where(is_pos, w_pos, w_neg).astype(np.float32)).to(device)

    def get_gradients(self, score):
        s = self.sigmoid
        y = self.sign_label
        response = -y * s / (1.0 + torch.exp(y * s * score))
        abs_response = torch.abs(response)
        grad = response * self.label_weight
        hess = abs_response * (s - abs_response) * self.label_weight
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0):
        """log-odds of the (weighted) positive rate / sigmoid
        (binary_objective.hpp:131-150)."""
        if self.weights_np is not None:
            suml = float(np.sum((self.label_np > 0) * self.weights_np))
            sumw = float(np.sum(self.weights_np))
        else:
            suml = float(self.cnt_pos)
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, 1e-10), 1e-10), 1.0 - 1e-10)
        init = np.log(pavg / (1.0 - pavg)) / self.sigmoid
        log_info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={init:.6f}")
        return float(init)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))
