"""Multiclass objectives: softmax (C trees an iteration) and one-vs-all.

Counterpart of lightgbm_tpu/objective/multiclass.py, after the
reference's src/objective/multiclass_objective.hpp: MulticlassSoftmax
(:24-178: softmax over the per-class scores, grad = p - 1{y=k}, hess =
2 p (1-p), boost-from-average with the log of each class's (weighted)
prior) and MulticlassOVA (:180-260: C independent binary objectives).
Plain tensor code: the JAX package computes it outside any Pallas kernel
too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import LightGBMError
from .base import ObjectiveFunction
from .binary import BinaryLogloss


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = self.label_np.astype(np.int32)
        if num_data and (lab.min() < 0 or lab.max() >= self.num_class):
            raise LightGBMError(
                f"Label must be in [0, {self.num_class}) for multiclass")
        onehot = np.zeros((self.num_class, num_data), dtype=np.float32)
        onehot[lab, np.arange(num_data)] = 1.0
        self.label_onehot = torch.from_numpy(onehot).to(device)
        if self.weights_np is not None:
            probs = np.array([float(np.sum((lab == k) * self.weights_np))
                              for k in range(self.num_class)])
            probs /= float(np.sum(self.weights_np))
        else:
            probs = (np.bincount(lab, minlength=self.num_class)
                     / max(num_data, 1))
        self.class_init_probs = probs

    def get_gradients(self, score):
        """score [C, N] -> grad, hess [C, N]."""
        p = torch.exp(score - torch.max(score, dim=0, keepdim=True).values)
        p = p / torch.sum(p, dim=0, keepdim=True)
        grad = p - self.label_onehot
        hess = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            grad = grad * self.weights[None, :]
            hess = hess * self.weights[None, :]
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        """log of the class prior (multiclass_objective.hpp:150-152): the
        softmax of the initial scores is the priors."""
        return float(np.log(max(1e-15, self.class_init_probs[class_id])))

    def convert_output(self, score):
        """Softmax over the class axis of a [C, N] score."""
        e = np.exp(score - np.max(score, axis=0, keepdims=True))
        return e / np.sum(e, axis=0, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """One binary log-loss a class, on the labels 1{y = k}."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = self.label_np.astype(np.int32)
        self.binary_objs = []
        for k in range(self.num_class):
            sub = BinaryLogloss(self.config)
            sub.init(_BinaryView(np.where(lab == k, 1.0, 0.0).astype(
                np.float32), self.weights_np), num_data, device)
            self.binary_objs.append(sub)

    def get_gradients(self, score):
        """score [C, N] -> grad, hess [C, N]."""
        gh = [self.binary_objs[k].get_gradients(score[k])
              for k in range(self.num_class)]
        return (torch.stack([g for g, _ in gh]),
                torch.stack([h for _, h in gh]))

    def boost_from_score(self, class_id: int = 0) -> float:
        return self.binary_objs[class_id].boost_from_score()

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))


class _BinaryView:
    """The metadata a class's binary objective sees."""

    def __init__(self, label, weights):
        self.label = label
        self.weights = weights
