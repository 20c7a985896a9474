"""User-facing Dataset and Booster.

Counterpart of lightgbm_tpu/basic.py (Dataset :103, Booster :334), after
the reference python package's basic.py: training (gbdt, goss, dart or
rf, models/boosting_factory.py), evaluation, predict, rollback, refit,
importances, model text save/load/dump and pickling through the model
text.  A Booster loaded from a model text does no device work:
it predicts by the host tree walk.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import PREDICT_PARAMS, Config, resolve_alias
from .core.dataset import TorchDataset
from .core.metadata import Metadata
from .models.boosting_factory import create_boosting
from .models.gbdt import GBDT, resolve_device
from .models.refit import refit_model
from .models.serialization import (dump_model_dict, load_model,
                                   save_model_to_string)
from .models.shap import predict_contrib
from .objective import create_objective
from .utils.log import LightGBMError, set_verbosity


def _pandas_categories(data) -> Optional[List[list]]:
    """The category lists of a DataFrame's category columns, in column
    order (None for a frame without any, or for other data)."""
    if not (hasattr(data, "dtypes") and hasattr(data, "columns")):
        return None
    out = [list(data[c].cat.categories) for c in data.columns
           if str(data[c].dtype) == "category"]
    return out or None


def _as_2d_float(data, num_features: Optional[int] = None,
                 pandas_categorical: Optional[List[list]] = None
                 ) -> np.ndarray:
    """A 2-D float matrix of ``data`` (lightgbm_tpu/basic.py _as_2d_float):
    a DataFrame's category columns become their codes (missing or unseen
    ones NaN), in the order ``pandas_categorical`` pins where given; a
    scipy matrix is densified; a 1-D vector is one row when its length is
    ``num_features``, else one column.  A float array keeps its type
    (binning and the walks read it as float64)."""
    if hasattr(data, "dtypes") and hasattr(data, "columns") and any(
            str(dt) == "category" for dt in data.dtypes):
        n_cat = sum(1 for dt in data.dtypes if str(dt) == "category")
        if (pandas_categorical is not None
                and n_cat != len(pandas_categorical)):
            # positional matching would mis-align the mappings
            raise LightGBMError(
                f"train and predict/valid DataFrames have different "
                f"category-column counts ({len(pandas_categorical)} at "
                f"train, {n_cat} now)")
        cols = []
        cat_i = 0
        for c in data.columns:
            col = data[c]
            if str(col.dtype) == "category":
                if pandas_categorical is not None:
                    # re-code into the training frame's category order
                    col = col.cat.set_categories(pandas_categorical[cat_i])
                codes = col.cat.codes.to_numpy().astype(np.float64)
                codes[codes < 0] = np.nan
                cols.append(codes)
                cat_i += 1
            else:
                cols.append(col.to_numpy(dtype=np.float64))
        data = np.stack(cols, axis=1)
    if hasattr(data, "values"):       # pandas
        data = data.values
    if hasattr(data, "toarray"):      # scipy sparse
        data = data.toarray()
    arr = np.asarray(data)
    if arr.dtype.kind != "f":
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        if num_features is not None and len(arr) == num_features:
            arr = arr[None, :]
        else:
            arr = arr[:, None]
    return arr


_PANDAS_CAT_KEY = "pandas_categorical:"


def _split_pandas_categorical(model_str: str):
    """(the model text without its trailing ``pandas_categorical:<json>``
    line, the category lists or None): the reference python package's
    trailer, so that either package reads the other's files
    (lightgbm_tpu/basic.py:83-100)."""
    idx = model_str.rfind("\n" + _PANDAS_CAT_KEY)
    if idx < 0:
        return model_str, None
    line = model_str[idx + 1 + len(_PANDAS_CAT_KEY):].strip()
    try:
        cats = json.loads(line)
    except json.JSONDecodeError:
        return model_str, None
    return model_str[:idx + 1], cats


class Dataset:
    """Lazily-constructed training dataset.  ``data`` is a raw [N, F]
    float matrix, or an already-binned TorchDataset (convert.py).
    ``weight`` [N] are sample weights, ``group`` the sizes of consecutive
    query groups (lambdarank, ndcg, map), ``init_score`` [N] or [C * N]
    (class-major) raw scores to boost from.  ``categorical_feature``
    lists the categorical columns by index or feature name; "auto" takes
    the ``categorical_feature`` parameter and a DataFrame's category
    columns.  A DataFrame gives its column names as feature names and
    its category columns as codes (``pandas_categorical``: the category
    lists, a valid set takes its reference's).  ``free_raw_data`` is kept
    as the JAX Dataset keeps it; the raw matrix is only read at
    construction.  A scipy sparse matrix (CSR, CSC, ...) is binned from
    its nonzeros without densifying it (TorchDataset.from_scipy;
    lightgbm_tpu/basic.py:143-147)."""

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature: Union[str, List[int], List[str]] =
                 "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self._handle: Optional[TorchDataset] = (
            data if isinstance(data, TorchDataset) else None)
        self.free_raw_data = free_raw_data
        # rows of ``reference`` this dataset is a subset of (``subset``)
        self.used_indices: Optional[np.ndarray] = None
        # the training frame's category lists (set at construction)
        self.pandas_categorical: Optional[List[list]] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._handle is not None:
            return self
        if self.used_indices is not None:
            self._handle = self.reference.construct(config)._handle.subset(
                self.used_indices)
            self.pandas_categorical = self.reference.pandas_categorical
            return self
        is_sparse = (hasattr(self.data, "tocsr")
                     and not hasattr(self.data, "values"))
        cfg = config or Config.from_params(self.params, device_type="cpu")
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(cfg)._handle
        self.pandas_categorical = (
            self.reference.pandas_categorical
            if self.reference is not None
            and self.reference.pandas_categorical is not None
            else _pandas_categories(self.data))
        if self.feature_name != "auto":
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        else:
            names = None
        cat_idx = self._categorical_indices(cfg, names)
        if self.categorical_feature == "auto" and hasattr(self.data,
                                                          "dtypes"):
            cat_idx += [i for i, dt in enumerate(self.data.dtypes)
                        if str(dt) == "category" and i not in cat_idx]
        make = TorchDataset.from_scipy if is_sparse else \
            TorchDataset.from_numpy
        self._handle = make(
            self.data if is_sparse else _as_2d_float(
                self.data, pandas_categorical=self.pandas_categorical),
            label=self.label, config=cfg,
            feature_names=names, reference=ref,
            categorical_features=cat_idx,
            weights=_as_f64(self.weight),
            group=(np.asarray(self.group) if self.group is not None
                   else None),
            init_score=_as_f64(self.init_score))
        return self

    def _categorical_indices(self, cfg: Config,
                             names: Optional[List[str]]) -> List[int]:
        spec = self.categorical_feature
        if isinstance(spec, str):
            if spec != "auto":
                raise LightGBMError("categorical_feature must be 'auto' or "
                                    "a list of column indices or names")
            spec = [t.strip() for t in
                    str(cfg.categorical_feature).strip("[]() ").split(",")
                    if t.strip()]
        out = []
        for c in spec:
            name = c[5:] if isinstance(c, str) and c.startswith("name:") \
                else c
            if names and name in names:
                out.append(names.index(name))
            else:
                try:
                    out.append(int(name))
                except ValueError:
                    raise LightGBMError(
                        f"categorical_feature entry {c!r} is neither a "
                        "column index nor a feature name")
        return out

    def create_valid(self, data, label=None, **kwargs) -> "Dataset":
        """A valid set binned by this dataset's bin mappers; ``kwargs``
        are Dataset's (weight, group, init_score, ...)."""
        return Dataset(data, label=label, reference=self, **kwargs)

    def subset(self, used_indices: Sequence[int],
               params: Optional[Dict] = None) -> "Dataset":
        """The rows ``used_indices`` (sorted), binned by this dataset's bin
        mappers (Dataset::CopySubset, dataset.cpp:503), with their
        metadata (TorchDataset.subset)."""
        ds = Dataset(self.data, label=self.label, reference=self,
                     weight=self.weight, group=self.group,
                     feature_name=self.feature_name,
                     categorical_feature=self.categorical_feature,
                     params=params or self.params)
        # built from this dataset's handle, even where ``data`` is one
        ds._handle = None
        ds.used_indices = np.asarray(sorted(used_indices), dtype=np.int64)
        return ds

    # ------------------------------------------------------------- fields
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(_as_f64(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weights(_as_f64(weight))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._handle is not None and group is not None:
            self._handle.metadata.set_query(np.asarray(group))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(_as_f64(init_score))
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group,
                  "init_score": self.set_init_score}.get(field_name)
        if setter is None:
            raise LightGBMError(f"Unknown field name {field_name}")
        return setter(data)

    def get_field(self, field_name: str):
        """The constructed dataset's field: label, weight, group (query
        sizes) or init_score; None where it has none."""
        md = self.construct()._handle.metadata
        if field_name == "label":
            return md.label
        if field_name == "weight":
            return md.weights
        if field_name == "group":
            return (np.diff(md.query_boundaries)
                    if md.query_boundaries is not None else None)
        if field_name == "init_score":
            return md.init_score
        raise LightGBMError(f"Unknown field name {field_name}")

    def get_label(self) -> np.ndarray:
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_group(self):
        return self.get_field("group")

    def get_init_score(self):
        return self.get_field("init_score")

    def num_data(self) -> int:
        return self.construct()._handle.num_data

    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features


def _as_f64(a) -> Optional[np.ndarray]:
    return None if a is None else np.asarray(a, dtype=np.float64).ravel()


class Booster:
    """Model handle: training-capable from a ``train_set``, or a model read
    from ``model_file`` / ``model_str`` (prediction only, no device).
    ``fused_route=False`` grows with the segment grower's unfused
    route/histogram kernel pair instead of the fused one (None: fused,
    unfused under ``packed_acc``);
    ``frontier_tier`` ("off", "k1" or "fusedk"; None = the default for the
    frontier width) picks the frontier grower's histogram launch under
    ``tpu_tree_impl=frontier``; ``packed4`` the training bins' layout
    (None: two columns a byte where the bin axis is at most 16; False or
    True forces it, models/gbdt.py GBDT); ``packed_acc=True`` trains on
    the packed-accumulator stream (gradients and hessians quantized once a
    tree to ``packed_acc_bits`` in [2, 15], integer histogram sums; the
    JAX package's LIGHTGBM_TPU_PACKED_ACC=force)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 fused_route: Optional[bool] = None,
                 frontier_tier: Optional[str] = None,
                 packed4: Optional[bool] = None,
                 packed_acc: bool = False, packed_acc_bits: int = 8):
        self.params = dict(params or {})
        # the iteration predict uses by default; -1 = none (engine.train
        # sets it: the early stop's best, else every iteration)
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._valid_names: List[str] = []
        self._valid_sets: List[Dataset] = []
        if train_set is not None:
            # the dataset's params under the booster's (the JAX Booster)
            self.config = Config.from_params({**train_set.params,
                                              **self.params})
            set_verbosity(self.config.verbosity)
            train_set.construct(self.config)
            self.train_set = train_set
            self.pandas_categorical = train_set.pandas_categorical
            self.objective = create_objective(self.config)
            self.gbdt = create_boosting(self.config, train_set._handle,
                                        self.objective,
                                        fused_route=fused_route,
                                        frontier_tier=frontier_tier,
                                        packed4=packed4,
                                        packed_acc=packed_acc,
                                        packed_acc_bits=packed_acc_bits)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._load(model_str)
        else:
            raise LightGBMError(
                "Booster needs train_set, model_file or model_str")

    def _load(self, model_str: str) -> None:
        model_str, self.pandas_categorical = _split_pandas_categorical(
            model_str)
        self.gbdt, self.config, self.objective = load_model(model_str)
        self.train_set = None

    def _trainable(self) -> GBDT:
        if self.train_set is None:
            raise LightGBMError("this Booster was loaded from a model text; "
                                "it predicts but does not train")
        return self.gbdt

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """A valid set, scored by the trees grown so far."""
        gbdt = self._trainable()
        if data.used_indices is None:
            data.reference = self.train_set
        data.construct(self.config)
        gbdt.add_valid(name, data._handle)
        self._valid_names.append(name)
        self._valid_sets.append(data)
        return self

    # ------------------------------------------------------------ training
    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True when training cannot continue.
        A new ``train_set`` (binned by the training set's mappers: made
        with it as ``reference``) is swapped in first
        (LGBM_BoosterResetTrainingData; lightgbm_tpu/basic.py:405-425):
        the model's scores are replayed on its rows, and the objective
        and metrics bound to it.  ``fobj(preds, train_set) -> (grad,
        hess)`` gives the gradients from the raw training score (flat,
        class-major)."""
        gbdt = self._trainable()
        if train_set is not None and train_set is not self.train_set:
            train_set.construct(self.config)
            gbdt.reset_train_data(train_set._handle)
            self.train_set = train_set
            gbdt.setup_metrics()
        if fobj is None:
            return gbdt.train_one_iter()
        score = gbdt.train_score.cpu().numpy().ravel()
        grad, hess = fobj(score, self.train_set)
        return gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Merge ``params`` into the booster's and train on from the new
        configuration (LGBM_BoosterResetParameter; the semantics of
        lightgbm_tpu/capi.py:433-443 booster_reset_parameter): the
        learning rate and what each iteration reads (sampling, the
        metrics) change; the grower keeps its tree shape."""
        gbdt = self._trainable()
        self.params = {**self.params, **params}
        self.config = Config.from_params({**self.train_set.params,
                                          **self.params})
        set_verbosity(self.config.verbosity)
        gbdt.reset_config(self.config)
        return self

    def rollback_one_iter(self) -> "Booster":
        self._trainable().rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self.gbdt.current_iteration()

    def num_trees(self) -> int:
        return len(self.gbdt.models)

    def num_model_per_iteration(self) -> int:
        return self.gbdt.num_tree_per_iteration

    # ---------------------------------------------------------------- eval
    def _feval_preds(self, score: np.ndarray) -> np.ndarray:
        """What ``feval`` gets: the objective's output (raw scores without
        an objective), flat and class-major."""
        if self.objective is not None:
            score = self.objective.convert_output(score)
        return np.asarray(score).ravel()

    def eval_train(self, feval: Optional[Callable] = None) -> List:
        """[("training", metric, value, higher_better)], then ``feval``'s
        (name, value, higher_better) on the training set."""
        gbdt = self._trainable()
        out = [("training", name, val, hb)
               for name, val, hb in gbdt.eval_train()]
        if feval is not None:
            # the f32 device score, as the JAX Booster hands it over
            name, val, hb = feval(
                self._feval_preds(gbdt.train_score.cpu().numpy()),
                self.train_set)
            out.append(("training", name, val, hb))
        return out

    def eval_valid(self, feval: Optional[Callable] = None) -> List:
        """[(valid set, metric, value, higher_better)] for each valid set,
        each followed by ``feval``'s."""
        gbdt = self._trainable()
        out = []
        for i, name in enumerate(self._valid_names):
            out.extend((name, m, val, hb)
                       for m, val, hb in gbdt.eval_valid(i))
            if feval is not None:
                m, val, hb = feval(self._feval_preds(gbdt.valid_scores[i]),
                                   self._valid_sets[i])
                out.append((name, m, val, hb))
        return out

    # ------------------------------------------------------------- predict
    def predict(self, data, num_iteration: Optional[int] = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                **kwargs) -> np.ndarray:
        """Raw scores, the objective's output, (``pred_leaf``) leaf
        indices, or (``pred_contrib``) SHAP contributions ([N, F + 1] a
        class, models/shap.py) of a feature matrix — an array, a
        DataFrame (its category columns coded by ``pandas_categorical``)
        or a scipy matrix — over ``num_iteration`` iterations from
        ``start_iteration``.  ``num_iteration`` None or negative means
        ``best_iteration`` when one is set, else every iteration
        (lightgbm_tpu/basic.py:528); 0 means every iteration too.
        ``kwargs`` are prediction parameters for this call
        (``predict_device``, ``pred_early_stop``,
        ``pred_early_stop_freq``, ``pred_early_stop_margin``,
        ``predict_contrib``); any other raises.  A booster's predict
        routes as ``predict_device`` says (GBDT.predict); the route taken
        is ``gbdt.last_predict_route``."""
        if num_iteration is None or num_iteration < 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        n_feat = self.gbdt.max_feature_idx + 1
        X = _as_2d_float(data, n_feat,
                         pandas_categorical=self.pandas_categorical)
        if X.shape[1] != n_feat:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not the "
                f"same as it was in training data ({n_feat})")
        config = self._predict_config(kwargs)
        if pred_contrib or config.predict_contrib:
            return predict_contrib(self.gbdt,
                                   np.asarray(X, dtype=np.float64),
                                   num_iteration)
        return self.gbdt.predict(X, num_iteration=num_iteration,
                                 raw_score=raw_score, pred_leaf=pred_leaf,
                                 start_iteration=start_iteration,
                                 config=config)

    def _predict_config(self, kwargs: Dict[str, Any]) -> Config:
        """The booster's configuration with ``kwargs``' prediction
        parameters applied (a copy; the booster's stays)."""
        if not kwargs:
            return self.config
        bad = [k for k in kwargs if resolve_alias(k) not in PREDICT_PARAMS]
        if bad:
            raise NotImplementedError(
                f"predict takes no parameter {bad[0]!r} in "
                f"lightgbm_tpu_torch (prediction parameters: "
                f"{', '.join(PREDICT_PARAMS)})")
        config = copy.copy(self.config)
        config.raw = dict(config.raw)
        config.update(kwargs)
        return config

    def refit(self, data, label, weight=None,
              decay_rate: Optional[float] = None) -> "Booster":
        """New leaf outputs for every tree from (data, label[, weight]),
        the trees' structure kept (reference ``Booster.refit``,
        lightgbm_tpu/basic.py:545-570): each leaf blends its old output
        with the gradient-optimal one, new = decay x old + (1 - decay) x
        opt, ``decay_rate`` (default ``refit_decay_rate``).  The
        objective's gradients run on the booster's device (a loaded
        Booster's: its ``device_type`` parameter, "cuda" by default).
        Returns self."""
        if not self.gbdt.models:
            raise LightGBMError("cannot refit a model with no trees")
        leaf_preds = np.asarray(self.predict(data, pred_leaf=True),
                                dtype=np.int32)
        if leaf_preds.ndim == 1:
            leaf_preds = leaf_preds[:, None]
        n = leaf_preds.shape[0]
        md = Metadata(n)
        md.set_label(_as_f64(label))
        if weight is not None:
            md.set_weights(_as_f64(weight))
        config = self.config
        if decay_rate is not None:
            config = copy.copy(config)
            config.refit_decay_rate = float(decay_rate)
        device = (self.gbdt.device if self.train_set is not None else
                  resolve_device(Config.from_params(
                      {k: v for k, v in self.params.items()
                       if resolve_alias(k) == "device_type"})))
        refit_model(self.gbdt, md, leaf_preds, config, device)
        return self

    # --------------------------------------------------------------- model
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """The model text; a DataFrame's category lists follow it on a
        ``pandas_categorical:`` line, as the reference python package
        writes them."""
        text = save_model_to_string(self.gbdt, self.config,
                                    num_iteration or -1, start_iteration)
        if self.pandas_categorical:
            text += ("\n" + _PANDAS_CAT_KEY
                     + json.dumps(self.pandas_categorical) + "\n")
        return text

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text atomically (tmp file + os.replace)."""
        text = self.model_to_string(num_iteration, start_iteration)
        d = os.path.dirname(os.path.abspath(filename))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".model.")
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, filename)
        return self

    def dump_model(self, num_iteration: Optional[int] = None) -> Dict:
        return dump_model_dict(self.gbdt, self.config, num_iteration or -1)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self.gbdt.feature_importance(importance_type, iteration)

    def feature_name(self) -> List[str]:
        return list(self.gbdt.feature_names)

    # ------------------------------------------------------------ pickling
    def __getstate__(self):
        """Pickled as its model text (as the reference Booster is): the
        restored Booster predicts from the trees and does not train."""
        return {"model_str": self.model_to_string(), "params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.params = state.get("params", {})
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        self._valid_names = []
        self._valid_sets = []
        self._load(state["model_str"])
