"""Refit: new leaf outputs for an existing model's trees on new data.

Counterpart of lightgbm_tpu/models/refit.py (reference GBDT::RefitTree,
src/boosting/gbdt.cpp, and the python package's Booster.refit): the trees
in order, each with the objective's gradients at the score the refitted
trees before it give; each leaf blends its old output with the
gradient-optimal one, new = decay x old + (1 - decay) x opt, opt =
-sum_g / (sum_h + lambda_l2) x the tree's shrinkage.  The port's
objective computes the gradients on the given device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..objective import create_objective
from ..ops.split import K_EPSILON


def snapshot_leaf_values(gbdt) -> List[np.ndarray]:
    """Float64 copies of every tree's leaf values, to undo a refit."""
    return [np.array(t.leaf_value, dtype=np.float64) for t in gbdt.models]


def restore_leaf_values(gbdt, snapshot) -> None:
    """Undo an in-place refit: the leaf values ``snapshot_leaf_values``
    took, bit for bit (the trees' structure is untouched)."""
    if len(snapshot) != len(gbdt.models):
        raise ValueError(
            f"leaf-value snapshot holds {len(snapshot)} trees but the "
            f"model has {len(gbdt.models)}")
    for tree, vals in zip(gbdt.models, snapshot):
        tree.leaf_value = np.array(vals, dtype=np.float64)


def refit_model(gbdt, metadata, leaf_preds: np.ndarray, config,
                device: torch.device) -> None:
    """Refit ``gbdt``'s trees in place from ``leaf_preds`` ([N, trees],
    each row's leaf in each tree) and ``metadata`` (labels, weights,
    query boundaries); the objective is ``config``'s, or the model's when
    the config names none."""
    objective = create_objective(config)
    if objective is None:
        objective = gbdt.objective
    label = np.asarray(metadata.label)
    objective.init(metadata, len(label), device)
    C = gbdt.num_tree_per_iteration
    decay = float(config.refit_decay_rate)
    lam = float(config.lambda_l2)
    score = np.zeros((C, len(label)), dtype=np.float64)
    for k in range(C):
        score[k] += gbdt.init_scores[k]
    for t in range(leaf_preds.shape[1]):
        k = t % C
        s = torch.from_numpy(score.astype(np.float32)).to(device)
        g, h = objective.get_gradients(s if C > 1 else s[k])
        g = (g if C == 1 else g[k]).cpu().numpy().astype(np.float64)
        h = (h if C == 1 else h[k]).cpu().numpy().astype(np.float64)
        tree = gbdt.models[t]
        leaves = leaf_preds[:, t]
        new_values = np.array(tree.leaf_value, dtype=np.float64)
        for leaf in range(tree.num_leaves):
            sel = leaves == leaf
            if not sel.any():
                continue
            sum_g, sum_h = g[sel].sum(), h[sel].sum()
            opt = -sum_g / (sum_h + lam + K_EPSILON) * tree.shrinkage
            new_values[leaf] = decay * new_values[leaf] + (1 - decay) * opt
        tree.leaf_value = new_values
        score[k] += new_values[leaves]
