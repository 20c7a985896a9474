"""Model text serialization, LightGBM format.

Counterpart of lightgbm_tpu/models/serialization.py (save_model_to_string
:101, tree_to_string :48); reference src/boosting/gbdt_model_text.cpp
SaveModelToString and src/io/tree.cpp Tree::ToString.  The text is the
same format, so ``lightgbm_tpu.Booster(model_file=...)`` and stock
LightGBM load a model the port saved.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np

from .tree import Tree

MODEL_VERSION = "v2"


def _fmt(x: float) -> str:
    """Shortest round-trip float formatting (Common::ArrayToString)."""
    return np.format_float_positional(
        float(x), unique=True, trim="0") if np.isfinite(x) else str(x)


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(x) for x in arr)


def _objective_to_string(config) -> str:
    if config.objective == "multiclass":
        return f"multiclass num_class:{config.num_class}"
    if config.objective == "binary":
        return f"binary sigmoid:{_fmt(config.sigmoid)}"
    return config.objective


def tree_to_string(tree: Tree) -> str:
    nl = tree.num_leaves
    lines = [f"num_leaves={nl}", f"num_cat={tree.num_cat}"]
    if nl > 1:
        lines += [
            "split_feature=" + _join(tree.split_feature),
            "split_gain=" + _join(tree.split_gain, _fmt),
            "threshold=" + _join(tree.threshold, _fmt),
            "decision_type=" + _join(tree.decision_type.astype(np.int64)),
            "left_child=" + _join(tree.left_child),
            "right_child=" + _join(tree.right_child),
            "leaf_value=" + _join(tree.leaf_value, _fmt),
            "leaf_weight=" + _join(tree.leaf_weight, _fmt),
            "leaf_count=" + _join(tree.leaf_count),
            "internal_value=" + _join(tree.internal_value, _fmt),
            "internal_weight=" + _join(tree.internal_weight, _fmt),
            "internal_count=" + _join(tree.internal_count),
        ]
        if tree.num_cat > 0:
            flat = np.concatenate(tree.cat_threshold)
            flat_inner = np.concatenate(tree.cat_threshold_inner)
            lines += [
                "cat_boundaries=" + _join(tree.cat_boundaries),
                "cat_threshold=" + _join(flat.astype(np.int64)),
                # the JAX package's extension: bin-id bitsets, so binned
                # prediction survives a round trip
                "cat_boundaries_inner=" + _join(tree.cat_boundaries_inner),
                "cat_threshold_inner=" + _join(flat_inner.astype(np.int64)),
            ]
    else:
        lines += ["leaf_value=" + _join(tree.leaf_value, _fmt)]
    lines.append(f"shrinkage={_fmt(tree.shrinkage)}")
    return "\n".join(lines) + "\n"


def _feature_infos_strings(gbdt) -> List[str]:
    out = []
    for m in gbdt.train_set.bin_mappers:
        if m.is_trivial:
            out.append("none")
        elif m.is_categorical:
            out.append(":".join(str(c) for c in sorted(m.bin_2_categorical)))
        else:
            out.append(f"[{_fmt(m.min_val)}:{_fmt(m.max_val)}]")
    return out


def save_model_to_string(gbdt, config, num_iteration: int = -1) -> str:
    """The model text; the trees of a multiclass model are saved class by
    class within each iteration (tree i is class i % C)."""
    C = gbdt.num_tree_per_iteration
    total_iter = len(gbdt.models) // C
    end_iter = (min(num_iteration, total_iter) if num_iteration > 0
                else total_iter)
    lines = ["tree", f"version={MODEL_VERSION}", f"num_class={C}",
             f"num_tree_per_iteration={C}", "label_index=0",
             f"max_feature_idx={gbdt.max_feature_idx}",
             f"objective={_objective_to_string(config)}",
             "feature_names=" + " ".join(gbdt.feature_names),
             "feature_infos=" + " ".join(_feature_infos_strings(gbdt))]

    def tree_for_save(i: int) -> Tree:
        """Boost-from-average is a bias folded into the leaves of the
        first iteration's trees, one per class (gbdt.cpp:503 AddBias,
        shrinkage forced to 1.0), so the file is self-contained; in memory
        the bias stays separate (GBDT.init_scores) and is added at predict
        time."""
        t = gbdt.models[i]
        init = gbdt.init_scores[i % C]
        if i >= C or abs(init) < 1e-35:
            return t
        biased = copy.copy(t)
        biased.leaf_value = t.leaf_value + init
        biased.shrinkage = 1.0
        return biased

    tree_strs = [f"Tree={i}\n" + tree_to_string(tree_for_save(i)) + "\n"
                 for i in range(end_iter * C)]
    lines.append("tree_sizes=" + _join(len(s) for s in tree_strs))
    lines.append("")
    body = "\n".join(lines) + "\n" + "".join(tree_strs) + "end of trees\n"

    imps = gbdt.feature_importance(end_iter)
    pairs = sorted([(int(v), gbdt.feature_names[i])
                    for i, v in enumerate(imps) if v > 0],
                   key=lambda p: -p[0])
    body += "\nfeature importances:\n"
    for v, name in pairs:
        body += f"{name}={v}\n"
    body += "\nparameters:\n"
    for k, v in config.raw.items():
        body += f"[{k}: {v}]\n"
    body += "end of parameters\n"
    return body
