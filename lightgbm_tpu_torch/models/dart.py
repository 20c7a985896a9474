"""DART: dropouts meet multiple additive regression trees.

Counterpart of lightgbm_tpu/models/dart.py (reference
src/boosting/dart.hpp:23-211).  Each iteration drops trees of earlier
iterations (uniformly, or in proportion to their weights; at most
``max_drop``; none with chance ``skip_drop``) from a numpy
RandomState(drop_seed), takes their predictions out of the scores, grows
the new trees with shrinkage lr / (1 + k) (xgboost mode: lr / (lr + k)),
then applies Normalize's net effect: each dropped tree scaled by k / (k +
1) (k / (k + lr)) and that share of its prediction added back.  A dropped
tree's training prediction is the host walk over the training bins, as
in the JAX package (on a card booster P1 over the device bins, the same
bits); its f32 cast leaves the device training score and its f64 value
the valid scores.  ``drop_seconds`` holds each iteration's walks and
score updates.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .gbdt import GBDT


class DART(GBDT):

    def __init__(self, config, train_set, objective, **kwargs):
        super().__init__(config, train_set, objective, **kwargs)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_seconds: List[float] = []

    def _select_drop(self) -> List[int]:
        """The iterations to drop (DroppingTrees, dart.hpp:96-140)."""
        cfg = self.config
        if self._drop_rng.rand() < cfg.skip_drop:
            return []
        drop: List[int] = []
        if not cfg.uniform_drop and self.sum_weight > 0:
            inv_avg = len(self.tree_weight) / self.sum_weight
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop * inv_avg / self.sum_weight)
            for i in range(self.iter_):
                p_drop = rate * self.tree_weight[i] * inv_avg
                if self._drop_rng.rand() < p_drop:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop > 0:
                        break
        else:
            rate = cfg.drop_rate
            if cfg.max_drop > 0 and self.iter_ > 0:
                rate = min(rate, cfg.max_drop / self.iter_)
            for i in range(self.iter_):
                if self._drop_rng.rand() < rate:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop > 0:
                        break
        return drop

    def _tree_predictions(self, it: int):
        """Iteration ``it``'s trees' current predictions: per class, the
        training rows' and each valid set's.  A card booster walks the
        device bins with P1 (the training rows' [C, N] float64 stay on the
        card); a CPU booster walks the host bins."""
        C = self.num_tree_per_iteration
        trees = self.models[it * C:(it + 1) * C]
        if self._walks_on_card():
            classes = list(range(C))
            train = self._card_delta(self.train_set, trees, classes)
            valid = [self._card_delta(vset, trees, classes).cpu().numpy()
                     for (_, vset) in self.valid_sets]
            return ([train[k] for k in range(C)],
                    [[v[k] for v in valid] for k in range(C)])
        infos = self.train_set.feature_infos()
        train_preds, valid_preds = [], []
        for tree in trees:
            train_preds.append(tree.predict_binned(self.train_set.bins_t,
                                                   infos))
            valid_preds.append([tree.predict_binned(vset.bins_t, infos)
                                for (_, vset) in self.valid_sets])
        return train_preds, valid_preds

    def _add(self, k: int, train_delta, valid_deltas) -> None:
        """Class ``k``'s scores += the deltas: the training delta (a host
        array, or a tensor on the card) cast to f32 and added on the
        device, the f64 ones to the valid sets."""
        C = self.num_tree_per_iteration
        if isinstance(train_delta, torch.Tensor):
            self.train_score[k] += train_delta.to(torch.float32)
        else:
            self.train_score[k] += torch.from_numpy(
                train_delta.astype(np.float32)).to(self.device)
        for vscore, d in zip(self.valid_scores, valid_deltas):
            vscore.reshape(C, -1)[k] += d

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.config
        t0 = time.perf_counter()
        self._boost_from_average()
        C = self.num_tree_per_iteration
        drop = self._select_drop()
        k = float(len(drop))
        # the dropped trees' whole contribution leaves the scores before
        # the gradients
        dropped = []
        for it in drop:
            tp, vp = self._tree_predictions(it)
            dropped.append((it, tp, vp))
            for ki in range(C):
                self._add(ki, -tp[ki], [-v for v in vp[ki]])
        self._sync()
        drop_s = time.perf_counter() - t0
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
            scale = k / (k + 1.0)
            sub = 1.0 / (k + 1.0)
        else:
            self.shrinkage_rate = (cfg.learning_rate if not drop else
                                   cfg.learning_rate / (cfg.learning_rate + k))
            scale = k / (k + cfg.learning_rate)
            sub = cfg.learning_rate / (k + cfg.learning_rate)

        ret = super().train_one_iter(grad, hess)
        t1 = time.perf_counter()
        if ret:
            # training stopped: the dropped trees' contribution comes back
            for it, tp, vp in dropped:
                for ki in range(C):
                    self._add(ki, tp[ki], vp[ki])
            return ret
        # normalize: each dropped tree shrinks by ``scale``, and that share
        # of its prediction returns to the scores
        for it, tp, vp in dropped:
            for ki in range(C):
                self.models[it * C + ki].apply_shrinkage(scale)
                self._add(ki, tp[ki] * scale,
                          [v * scale for v in vp[ki]])
            if not cfg.uniform_drop:
                self.sum_weight -= self.tree_weight[it] * sub
                self.tree_weight[it] *= scale
        if not cfg.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        self._sync()
        self.drop_seconds.append(drop_s + time.perf_counter() - t1)
        return False
