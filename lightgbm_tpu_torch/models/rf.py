"""Random forest mode.

Counterpart of lightgbm_tpu/models/rf.py (reference
src/boosting/rf.hpp:25-218): bagging is required, the shrinkage is 1,
every tree fits the gradients computed once from the constant
boost-from-average score, each tree takes that score as a bias into its
leaves (AddBias) and into both scores, and a prediction averages the
iterations' trees (``average_output``), as the metrics do.
"""

from __future__ import annotations

import torch

from ..utils.log import check, log_fatal
from .gbdt import GBDT


class RF(GBDT):

    average_output = True

    def __init__(self, config, train_set, objective, **kwargs):
        check(config.bagging_freq > 0 and 0.0 < config.bagging_fraction < 1.0,
              "RF mode requires bagging "
              "(bagging_freq > 0 and bagging_fraction in (0, 1))")
        if objective is None:
            log_fatal("RF mode does not support custom objective functions")
        super().__init__(config, train_set, objective, **kwargs)
        self.shrinkage_rate = 1.0

    def reset_config(self, config) -> None:
        super().reset_config(config)
        self.shrinkage_rate = 1.0

    def reset_train_data(self, train_set) -> None:
        super().reset_train_data(train_set)
        # the fixed gradients belong to the training rows
        self._fixed_grads = None
        self._rf_init = None

    def _boost_from_average(self) -> None:
        # the init score goes into each tree (AddBias), never into the
        # score buffers
        self._boosted_from_average = True

    def _gradients(self):
        """The gradients at the constant score boost_from_score, computed
        once ([C, Npad], pad rows 0)."""
        if self._fixed_grads is None:
            C = self.num_tree_per_iteration
            self._rf_init = [self.objective.boost_from_score(k)
                             for k in range(C)]
            const = torch.stack([
                torch.full((self.num_data,), v, dtype=torch.float32,
                           device=self.device) for v in self._rf_init])
            g, h = self.objective.get_gradients(const if C > 1 else const[0])
            if C == 1:
                g, h = g[None], h[None]
            pad = self.bins.shape[1] - self.num_data
            self._fixed_grads = (torch.nn.functional.pad(g, (0, pad)),
                                 torch.nn.functional.pad(h, (0, pad)))
        return self._fixed_grads

    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is not None or hess is not None:
            log_fatal("RF mode does not support custom gradients")
        if super().train_one_iter():
            return True
        # fold the init score into the new trees' leaves (rf.hpp:140-146)
        C = self.num_tree_per_iteration
        for k in range(C):
            bias = self._rf_init[k]
            if abs(bias) < 1e-15:
                continue
            tree = self.models[(self.iter_ - 1) * C + k]
            if tree.num_leaves > 1:
                tree.leaf_value = tree.leaf_value + bias
                self.train_score[k] += bias
                for vscore in self.valid_scores:
                    vscore.reshape(C, -1)[k] += bias
        return False

    def _eval_score(self, score, metrics):
        # the scores hold sums over the iterations
        return super()._eval_score(score / max(self.iter_, 1), metrics)
