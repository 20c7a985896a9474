"""Model text serialization, LightGBM format: save, load, dump.

Counterpart of lightgbm_tpu/models/serialization.py (save_model_to_string
:101, tree_to_string :48, tree_from_block, load_model :284,
load_trees_into :339, dump_model_dict :449); reference
src/boosting/gbdt_model_text.cpp SaveModelToString / LoadModelFromString
/ DumpModel and src/io/tree.cpp Tree::ToString.  The text is the same
format, so ``lightgbm_tpu.Booster(model_file=...)`` and stock LightGBM
load a model the port saved, and the port loads theirs.  Loading does no
device work: a loaded model predicts by the host tree walk.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..objective import create_objective
from ..utils.log import LightGBMError
from .gbdt import TreeEnsemble
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
    ds = getattr(gbdt, "train_set", None)
    if ds is None:
        return ["none"] * (gbdt.max_feature_idx + 1)
    out = []
    for m in ds.bin_mappers:
        if m.is_trivial:
            out.append("none")
        elif m.is_categorical:
            out.append(":".join(str(c) for c in sorted(m.bin_2_categorical)))
        else:
            out.append(f"[{_fmt(m.min_val)}:{_fmt(m.max_val)}]")
    return out


def save_model_to_string(gbdt, config, num_iteration: int = -1,
                         start_iteration: int = 0) -> str:
    """The model text of ``num_iteration`` iterations (<= 0: all) from
    ``start_iteration``; the trees of a multiclass model are saved class
    by class within each iteration (tree i is class i % C)."""
    C = gbdt.num_tree_per_iteration
    total_iter = len(gbdt.models) // C
    start = min(max(start_iteration, 0), total_iter)
    end_iter = (min(start + num_iteration, total_iter) if num_iteration > 0
                else total_iter)
    lines = ["tree", f"version={MODEL_VERSION}", f"num_class={C}",
             f"num_tree_per_iteration={C}", "label_index=0",
             f"max_feature_idx={gbdt.max_feature_idx}",
             f"objective={_objective_to_string(config)}",
             "feature_names=" + " ".join(gbdt.feature_names),
             "feature_infos=" + " ".join(_feature_infos_strings(gbdt))]

    def tree_for_save(i: int) -> Tree:
        """Boost-from-average is a bias folded into the leaves of the
        first saved iteration's trees, one per class (gbdt.cpp:503
        AddBias, shrinkage forced to 1.0), so each file is its trees plus
        the init score; in memory the bias stays separate
        (GBDT.init_scores) and is added at predict time."""
        t = gbdt.models[i]
        init = gbdt.init_scores[i % C] if i - start * C < C else 0.0
        if abs(init) < 1e-35:
            return t
        biased = copy.copy(t)
        biased.leaf_value = t.leaf_value + init
        biased.shrinkage = 1.0
        return biased

    tree_strs = [f"Tree={i - start * C}\n" + tree_to_string(tree_for_save(i))
                 + "\n" for i in range(start * C, end_iter * C)]
    lines.append("tree_sizes=" + _join(len(s) for s in tree_strs))
    lines.append("")
    body = "\n".join(lines) + "\n" + "".join(tree_strs) + "end of trees\n"

    imps = gbdt.feature_importance("split")
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


# ------------------------------------------------------------------- load
def tree_from_block(block: str) -> Tree:
    """One ``Tree=`` block's key=value lines -> a Tree with real
    thresholds only (``bins_aligned`` False until ``Tree.aligned_to``)."""
    kv: Dict[str, str] = {}
    for line in block.strip().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip()
    nl = int(kv["num_leaves"])
    t = Tree(nl)
    t.shrinkage = float(kv.get("shrinkage", 1.0))
    t.num_cat = int(kv.get("num_cat", 0))

    def arr(key, dtype, size):
        if not kv.get(key):
            return np.zeros(size, dtype=dtype)
        return np.asarray(kv[key].split(), dtype=np.float64).astype(dtype)

    t.leaf_value = arr("leaf_value", np.float64, nl)
    n = nl - 1
    if n <= 0:
        return t
    t.split_feature = arr("split_feature", np.int32, n)
    t.split_feature_inner = t.split_feature.copy()
    t.split_gain = arr("split_gain", np.float32, n)
    t.threshold = arr("threshold", np.float64, n)
    t.decision_type = arr("decision_type", np.int8, n)
    t.left_child = arr("left_child", np.int32, n)
    t.right_child = arr("right_child", np.int32, n)
    t.leaf_weight = arr("leaf_weight", np.float64, nl)
    t.leaf_count = arr("leaf_count", np.int64, nl)
    t.internal_value = arr("internal_value", np.float64, n)
    t.internal_weight = arr("internal_weight", np.float64, n)
    t.internal_count = arr("internal_count", np.int64, n)
    t.threshold_in_bin = np.zeros(n, dtype=np.int32)
    t.bins_aligned = False
    if t.num_cat > 0:
        def bitsets(bkey, wkey):
            bounds = arr(bkey, np.int64, t.num_cat + 1)
            words = arr(wkey, np.int64, 0).astype(np.uint32)
            return ([int(b) for b in bounds],
                    [words[bounds[i]:bounds[i + 1]]
                     for i in range(t.num_cat)])

        t.cat_boundaries, t.cat_threshold = bitsets("cat_boundaries",
                                                    "cat_threshold")
        # the JAX package's extension: bin-id bitsets
        if "cat_boundaries_inner" in kv:
            t.cat_boundaries_inner, t.cat_threshold_inner = bitsets(
                "cat_boundaries_inner", "cat_threshold_inner")
        # a categorical node's threshold is its bitset's index
        for i in range(n):
            if t.decision_type[i] & 1:
                t.threshold_in_bin[i] = int(t.threshold[i])
    return t


class LoadedBoosting(TreeEnsemble):
    """A model read from a model text: it predicts and reports
    importances, with no dataset and no device."""

    def __init__(self):
        self.models: List[Tree] = []
        self.num_tree_per_iteration = 1
        self.init_scores: List[float] = [0.0]
        self.feature_names: List[str] = []
        self.max_feature_idx = 0
        self.objective = None
        self.iter_ = 0


def _parse_objective_string(s: str) -> Tuple[str, Dict[str, str]]:
    parts = s.split()
    args = dict(tok.split(":", 1) for tok in parts[1:] if ":" in tok)
    return parts[0], args


def load_model(model_str: str):
    """A model text -> (LoadedBoosting, Config, objective or None).  The
    objective keeps its link only: it is not bound to any data."""
    header, _, rest = model_str.partition("\nTree=0")
    if not rest:
        raise LightGBMError("Model format error: no trees found")
    kv: Dict[str, str] = {}
    for line in header.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip()
        elif line.strip() == "average_output":
            raise NotImplementedError(
                "an averaged-output (random forest) model is not supported "
                "by lightgbm_tpu_torch")
    out = LoadedBoosting()
    C = int(kv.get("num_tree_per_iteration", 1))
    out.num_tree_per_iteration = C
    out.max_feature_idx = int(kv.get("max_feature_idx", 0))
    out.feature_names = kv.get("feature_names", "").split()
    # the JAX package's extension: init scores kept apart from the trees
    out.init_scores = ([float(x) for x in kv["init_scores"].split()]
                       if kv.get("init_scores") else [0.0] * C)
    obj_name, obj_args = _parse_objective_string(
        kv.get("objective", "regression"))
    params = {"objective": obj_name}
    if "num_class" in obj_args:
        params["num_class"] = int(obj_args["num_class"])
    if "sigmoid" in obj_args:
        params["sigmoid"] = float(obj_args["sigmoid"])
    config = Config.from_params(params)
    objective = create_objective(config)
    for block in ("Tree=0" + rest).split("end of trees")[0].split("Tree="):
        block = block.strip()
        if block:
            out.models.append(tree_from_block(block.partition("\n")[2]))
    out.iter_ = len(out.models) // C
    out.objective = objective
    return out, config, objective


def load_trees_into(gbdt, src: TreeEnsemble, raw_data=None) -> None:
    """Continued training: seed a fresh GBDT with ``src``'s trees
    (boosting.cpp:53-74, lightgbm_tpu/models/serialization.py:339-378).
    The device training score gets, in the JAX package's order, the init
    scores, then each class's trees summed in f64 over the raw rows
    (``raw_data``; else over the training bins, each tree aligned) and
    cast to f32.  The trees are kept aligned with the training bins (a
    tree grown on other data is realigned too, where the JAX package keeps
    it as it was), and the model counts as boosted from its average.
    Records the host walk and the device adds in
    ``gbdt.init_model_seconds``."""
    C = gbdt.num_tree_per_iteration
    if src.num_tree_per_iteration != C:
        raise LightGBMError("init model has different num_tree_per_iteration")
    ds = gbdt.train_set
    t0 = time.perf_counter()
    models = [t.aligned_to(ds) for t in src.models[:src.iter_ * C]]
    if raw_data is not None:
        # feature-major: a tree node reads one contiguous column
        raw = np.asfortranarray(raw_data, dtype=np.float64)
        deltas = [sum(src.models[it * C + k].predict_raw(raw)
                      for it in range(src.iter_)) for k in range(C)]
    else:
        infos = ds.feature_infos()
        deltas = []
        for k in range(C):
            total = np.zeros(gbdt.num_data)
            for tree in models[k::C]:
                total += tree.predict_binned(ds.bins_t, infos)
            deltas.append(total)
    t1 = time.perf_counter()
    gbdt.init_scores = list(src.init_scores)
    for k in range(C):
        gbdt.train_score[k] += float(src.init_scores[k])
    for k in range(C):
        gbdt.train_score[k] += torch.from_numpy(
            np.asarray(deltas[k], dtype=np.float32)).to(gbdt.device)
    if gbdt.device.type == "cuda":
        torch.cuda.synchronize(gbdt.device)
    gbdt.models.extend(models)
    gbdt.iter_ += src.iter_
    gbdt._boosted_from_average = True
    gbdt.init_model_seconds = {"host_walk": t1 - t0,
                               "device_add": time.perf_counter() - t1}


# ------------------------------------------------------------------- dump
def dump_model_dict(gbdt, config, num_iteration: int = -1) -> Dict:
    """The JSON model dump (GBDT::DumpModel, gbdt_model_text.cpp:19-64)."""
    C = gbdt.num_tree_per_iteration
    n_iter = (gbdt.iter_ if num_iteration <= 0
              else min(num_iteration, gbdt.iter_))

    def cats_of(tree: Tree, node: int) -> List[int]:
        words = tree.cat_threshold[int(tree.threshold_in_bin[node])]
        return [b for b in range(len(words) * 32)
                if words[b // 32] >> (b % 32) & 1]

    def node_dict(tree: Tree, node: int) -> Dict:
        if node < 0:
            leaf = ~node
            return {
                "leaf_index": int(leaf),
                "leaf_value": float(tree.leaf_value[leaf]),
                "leaf_weight": float(tree.leaf_weight[leaf])
                if leaf < len(tree.leaf_weight) else 0.0,
                "leaf_count": int(tree.leaf_count[leaf])
                if leaf < len(tree.leaf_count) else 0,
            }
        dt = int(tree.decision_type[node])
        is_cat = bool(dt & 1)
        return {
            "split_index": int(node),
            "split_feature": int(tree.split_feature[node]),
            "split_gain": float(tree.split_gain[node]),
            "threshold": ("||".join(str(c) for c in cats_of(tree, node))
                          if is_cat else float(tree.threshold[node])),
            "decision_type": "==" if is_cat else "<=",
            "default_left": bool(dt & 2),
            "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
            "internal_value": float(tree.internal_value[node]),
            "internal_weight": float(tree.internal_weight[node]),
            "internal_count": int(tree.internal_count[node]),
            "left_child": node_dict(tree, int(tree.left_child[node])),
            "right_child": node_dict(tree, int(tree.right_child[node])),
        }

    trees = []
    for i in range(n_iter * C):
        t = gbdt.models[i]
        trees.append({
            "tree_index": i, "num_leaves": int(t.num_leaves),
            "num_cat": int(t.num_cat), "shrinkage": float(t.shrinkage),
            "tree_structure": (node_dict(t, 0) if t.num_leaves > 1 else
                               {"leaf_value": float(t.leaf_value[0])})})
    return {
        "name": "tree",
        "version": MODEL_VERSION,
        "num_class": config.num_class,
        "num_tree_per_iteration": C,
        "label_index": 0,
        "max_feature_idx": gbdt.max_feature_idx,
        "objective": _objective_to_string(config),
        "average_output": False,
        "feature_names": list(gbdt.feature_names),
        "feature_importances": {
            name: int(v) for name, v in zip(
                gbdt.feature_names, gbdt.feature_importance("split"))
            if v > 0},
        "tree_info": trees,
    }
