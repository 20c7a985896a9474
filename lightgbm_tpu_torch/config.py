"""Training parameters of the port.

The same registry shape as the reference's Config (include/LightGBM/
config.h, src/io/config_auto.cpp): name, default, aliases.  The port runs
one path — L2 regression (the default objective, as in the JAX package),
binary or multiclass-softmax GBDT, or a caller's own gradients (objective
"none", ``train(fobj=...)``), with the serial segment or frontier grower
on dense data, numeric or categorical — so the registry holds only the
parameters that path honours.  A
parameter of a feature the port does not have raises NotImplementedError
unless it is given at the value that switches the feature off; an
unknown parameter raises too.  Nothing is silently ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .utils.log import LightGBMError


class _P:
    """One parameter spec: (default, aliases)."""

    __slots__ = ("default", "aliases", "ptype")

    def __init__(self, default, aliases=(), ptype=None):
        self.default = default
        self.aliases = tuple(aliases)
        self.ptype = ptype if ptype is not None else type(default)


# Parameters the port honours.
_PARAMS: Dict[str, _P] = {
    "objective": _P("regression", ["objective_type", "app", "application"]),
    "num_class": _P(1, ["num_classes"]),
    "num_iterations": _P(100, ["num_iteration", "n_iter", "num_tree",
                               "num_trees", "num_round", "num_rounds",
                               "num_boost_round", "n_estimators"]),
    "learning_rate": _P(0.1, ["shrinkage_rate", "eta"]),
    "num_leaves": _P(31, ["num_leaf", "max_leaves", "max_leaf"]),
    # "cuda" or "cpu"; the card path never falls back to the CPU
    "device_type": _P("cuda", ["device"]),
    # the slice draws no random numbers; the seed is kept for the model text
    "seed": _P(0, ["random_seed", "random_state"]),
    "max_depth": _P(-1),
    "min_data_in_leaf": _P(20, ["min_data_per_leaf", "min_data",
                                "min_child_samples"]),
    "min_sum_hessian_in_leaf": _P(1e-3, ["min_sum_hessian_per_leaf",
                                         "min_sum_hessian", "min_hessian",
                                         "min_child_weight"]),
    "max_delta_step": _P(0.0, ["max_tree_output", "max_leaf_output"]),
    "lambda_l1": _P(0.0, ["reg_alpha"]),
    "lambda_l2": _P(0.0, ["reg_lambda", "lambda"]),
    "min_gain_to_split": _P(0.0, ["min_split_gain"]),
    "verbosity": _P(1, ["verbose"]),
    "max_bin": _P(255),
    "min_data_in_bin": _P(3),
    "bin_construct_sample_cnt": _P(200000, ["subsample_for_bin"]),
    "data_random_seed": _P(1, ["data_seed"]),
    "use_missing": _P(True),
    "zero_as_missing": _P(False),
    "is_unbalance": _P(False, ["unbalance", "unbalanced_sets"]),
    "scale_pos_weight": _P(1.0),
    "sigmoid": _P(1.0),
    # L2 regression on sign(y) sqrt(|y|), predictions squared back
    "reg_sqrt": _P(False),
    # categorical columns, as indices or feature names ("0,3" or a list);
    # Dataset(categorical_feature=...) takes precedence
    "categorical_feature": _P("", ["cat_feature", "categorical_column",
                                   "cat_column"], ptype=str),
    # categorical split search (lightgbm_tpu/ops/split.py SplitParams)
    "max_cat_threshold": _P(32),
    "cat_smooth": _P(10.0),
    "cat_l2": _P(10.0),
    "max_cat_to_onehot": _P(4),
    "min_data_per_group": _P(100),
    # metric parameters (lightgbm_tpu/config.py): quantile and huber's
    # alpha, fair's c, tweedie's rho, multi_error's k
    "alpha": _P(0.9),
    "fair_c": _P(1.0),
    "tweedie_variance_power": _P(1.5),
    "multi_error_top_k": _P(1),
    # accepted as the JAX package accepts it: train() stops early only on
    # its early_stopping_rounds argument (lightgbm_tpu/engine.py:119-122)
    "early_stopping_round": _P(0, ["early_stopping_rounds",
                                   "early_stopping"]),
    # early stopping watches only the first metric
    "first_metric_only": _P(False),
    "boost_from_average": _P(True),
    # exclusive feature bundling (core/bundle.py): the grouping is
    # computed; a multi-feature group raises until its histogram expansion
    # is ported
    "enable_bundle": _P(True, ["is_enable_bundle", "bundle"]),
    "max_conflict_rate": _P(0.0),
    "sparse_threshold": _P(0.8),
    "metric": _P([], ["metrics", "metric_types"], ptype=list),
    # row block: the granularity of the growers' confinement intervals
    # (0 = DEFAULT_BLOCK_ROWS, capped at the row count)
    "tpu_row_chunk": _P(0),
    # tree grower: "auto" (= "segment", as the JAX package grows on an
    # accelerator), "segment" (strict best-first) or "frontier" (the
    # top-K leaves a round); the JAX package's "fused" grower is not
    # ported
    "tpu_tree_impl": _P("auto"),
    # frontier width K (0 = auto: models/gbdt.py _auto_frontier_k)
    "tpu_frontier_width": _P(0),
    # a frontier round splits only leaves whose gain is at least this
    # share of the round's best (0 = no gate)
    "tpu_frontier_gain_ratio": _P(0.0),
}

# Parameters of features the port does not have, with the value that
# switches each feature off.  Any other value raises NotImplementedError.
_OFF_VALUES: Dict[str, Any] = {
    "boosting": "gbdt",
    "tree_learner": "serial",
    "num_machines": 1,
    "num_threads": 0,
    "bagging_fraction": 1.0,
    "pos_bagging_fraction": 1.0,
    "neg_bagging_fraction": 1.0,
    "bagging_freq": 0,
    "feature_fraction": 1.0,
    "feature_fraction_bynode": 1.0,
    "monotone_constraints": [],
    "feature_contri": [],
    "forcedsplits_filename": "",
    "cegb_penalty_split": 0.0,
    "cegb_penalty_feature_lazy": [],
    "cegb_penalty_feature_coupled": [],
    "max_bin_by_feature": [],
    "tpu_double_precision": False,
    "gpu_use_dp": False,
}

_OFF_ALIASES = {
    "boosting_type": "boosting", "boost": "boosting",
    "tree": "tree_learner", "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_machine": "num_machines",
    "num_thread": "num_threads", "nthread": "num_threads",
    "nthreads": "num_threads", "n_jobs": "num_threads",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction", "subsample_freq": "bagging_freq",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri",
    "fp": "feature_contri", "feature_penalty": "feature_contri",
}

ALIAS_TABLE: Dict[str, str] = dict(_OFF_ALIASES)
for _name, _spec in _PARAMS.items():
    ALIAS_TABLE[_name] = _name
    for _a in _spec.aliases:
        ALIAS_TABLE[_a] = _name

DEVICE_TYPES = ("cuda", "cpu")
TREE_IMPLS = {"auto": "segment", "segment": "segment",
              "frontier": "frontier"}
OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "binary": "binary", "multiclass": "multiclass", "softmax": "multiclass",
    # no objective: the caller gives the gradients (train(fobj=...))
    "none": "none", "null": "none", "custom": "none", "na": "none"}
# lightgbm_tpu/metric/__init__.py metric_canonical_name, without the
# ranking metrics (they need query groups)
METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
}
# objective -> its metric when none is named ("none" has none)
DEFAULT_METRIC = {"regression": "l2", "binary": "binary_logloss",
                  "multiclass": "multi_logloss"}
_TRUE_SET = {"true", "1", "yes", "+", "on"}
_FALSE_SET = {"false", "0", "no", "-", "off"}


def resolve_alias(key: str) -> str:
    k = key.strip().lower()
    return ALIAS_TABLE.get(k, k)


def _coerce(name: str, value: Any, ptype: type) -> Any:
    if ptype is str and isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    if ptype is list:
        if isinstance(value, (list, tuple)):
            return list(value)
        if isinstance(value, str):
            return [v.strip() for v in value.replace(";", ",").split(",")
                    if v.strip()]
        return [value]
    if ptype is bool:
        if isinstance(value, (bool, int, float)):
            return bool(value)
        s = str(value).strip().lower()
        if s in _TRUE_SET:
            return True
        if s in _FALSE_SET:
            return False
        raise ValueError(f"cannot parse bool parameter {name}={value!r}")
    if ptype is int:
        return int(float(value))
    if ptype is float:
        return float(value)
    return str(value)


def _is_off(name: str, value: Any) -> bool:
    off = _OFF_VALUES[name]
    if isinstance(off, list):
        return not _coerce(name, value, list)
    try:
        return _coerce(name, value, type(off)) == off
    except (TypeError, ValueError):
        return False


class Config:
    """Resolved training configuration of the port."""

    def __init__(self, **kwargs):
        for name, spec in _PARAMS.items():
            v = spec.default
            setattr(self, name, list(v) if isinstance(v, list) else v)
        self.raw: Dict[str, Any] = {}
        self.update(kwargs)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]] = None,
                    **kwargs) -> "Config":
        merged = dict(params or {})
        merged.update(kwargs)
        return cls(**merged)

    def update(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            name = resolve_alias(k)
            if name in _OFF_VALUES:
                if not _is_off(name, v):
                    raise NotImplementedError(
                        f"parameter {k}={v!r} is not supported by "
                        f"lightgbm_tpu_torch (only {name}="
                        f"{_OFF_VALUES[name]!r})")
            elif name in _PARAMS:
                setattr(self, name, _coerce(name, v, _PARAMS[name].ptype))
            else:
                raise NotImplementedError(
                    f"parameter {k!r} is not supported by lightgbm_tpu_torch")
            self.raw[k] = v
        self._post_process()

    def _post_process(self) -> None:
        obj = str(self.objective).strip().lower()
        if obj not in OBJECTIVE_ALIASES:
            raise NotImplementedError(
                f"objective {obj!r} is not supported by lightgbm_tpu_torch "
                "(only regression, binary, multiclass and none)")
        self.objective = OBJECTIVE_ALIASES[obj]
        if self.objective == "multiclass" and self.num_class <= 1:
            raise LightGBMError("num_class must be > 1 for multiclass")
        if (self.objective not in ("multiclass", "none")
                and self.num_class != 1):
            raise LightGBMError("num_class must be 1 for non-multiclass "
                                "objectives")
        self.device_type = str(self.device_type).strip().lower()
        if self.device_type not in DEVICE_TYPES:
            raise LightGBMError(
                f"device_type must be one of {DEVICE_TYPES}, got "
                f"{self.device_type!r}")
        metrics = []
        for m in self.metric:
            m = str(m).strip().lower()
            if m in ("", "none", "null", "na", "custom"):
                continue
            if m not in METRIC_ALIASES:
                raise NotImplementedError(
                    f"metric {m!r} is not supported by lightgbm_tpu_torch")
            # each metric once, in the order named (the JAX Booster's
            # _setup_metrics)
            if METRIC_ALIASES[m] not in metrics:
                metrics.append(METRIC_ALIASES[m])
        self.metric = metrics
        if self.num_leaves < 2:
            raise LightGBMError("num_leaves must be >= 2")
        if not 2 <= self.max_bin <= 256:
            raise LightGBMError("max_bin must be in [2, 256] (one byte a bin)")
        if self.tpu_row_chunk < 0:
            raise LightGBMError("tpu_row_chunk must be >= 0")
        impl = str(self.tpu_tree_impl).strip().lower()
        if impl == "fused":
            raise NotImplementedError(
                "tpu_tree_impl='fused' is not supported by lightgbm_tpu_torch "
                "(only auto, segment and frontier)")
        if impl not in TREE_IMPLS:
            raise LightGBMError(f"tpu_tree_impl must be one of "
                                f"{sorted(TREE_IMPLS)}, got {impl!r}")
        # "auto" resolves to the grower it names, so the model text and
        # the growers see one spelling
        self.tpu_tree_impl = TREE_IMPLS[impl]
        if self.tpu_frontier_width < 0:
            raise LightGBMError("tpu_frontier_width must be >= 0")
        if not 0.0 <= self.tpu_frontier_gain_ratio <= 1.0:
            # above 1 no leaf, not even the round's best, could split
            raise LightGBMError("tpu_frontier_gain_ratio must be in [0, 1]")
