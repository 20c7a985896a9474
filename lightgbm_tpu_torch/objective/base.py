"""Objective function interface.

Reference: include/LightGBM/objective_function.h:20-80.  Objectives map
the current raw score to per-example (gradient, hessian) pairs, and give
a boost-from-average initial score (BoostFromScore) and an output link
(ConvertOutput).  ``get_gradients`` is a function of tensors on the
training device; label arrays are moved there at ``init``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ObjectiveFunction:
    name = "custom"
    num_tree_per_iteration = 1

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        self.num_data = num_data
        self.device = device
        self.label_np = np.asarray(metadata.label)

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
