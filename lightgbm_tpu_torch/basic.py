"""User-facing Dataset and Booster.

Counterpart of lightgbm_tpu/basic.py (Dataset :103, Booster :334), after
the reference python package's basic.py: training, evaluation, predict,
rollback, importances, model text save/load/dump and pickling through
the model text.  A Booster loaded from a model text does no device work:
it predicts by the host tree walk.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config
from .core.dataset import TorchDataset
from .models.gbdt import GBDT
from .models.serialization import (dump_model_dict, load_model,
                                   save_model_to_string)
from .objective import create_objective
from .utils.log import LightGBMError, set_verbosity


class Dataset:
    """Lazily-constructed training dataset.  ``data`` is a raw [N, F]
    float matrix, or an already-binned TorchDataset (convert.py).
    ``categorical_feature`` lists the categorical columns by index or
    feature name; "auto" takes the ``categorical_feature`` parameter."""

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None,
                 feature_name="auto",
                 categorical_feature: Union[str, List[int], List[str]] =
                 "auto",
                 params: Optional[Dict[str, Any]] = None):
        self.data = data
        self.label = label
        self.reference = reference
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self._handle: Optional[TorchDataset] = (
            data if isinstance(data, TorchDataset) else None)
        # rows of ``reference`` this dataset is a subset of (``subset``)
        self.used_indices: Optional[np.ndarray] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._handle is not None:
            return self
        if self.used_indices is not None:
            self._handle = self.reference.construct(config)._handle.subset(
                self.used_indices)
            return self
        cfg = config or Config.from_params(self.params, device_type="cpu")
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(cfg)._handle
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        self._handle = TorchDataset.from_numpy(
            np.asarray(self.data), label=self.label, config=cfg,
            feature_names=names, reference=ref,
            categorical_features=self._categorical_indices(cfg, names))
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

    def create_valid(self, data, label=None) -> "Dataset":
        return Dataset(data, label=label, reference=self)

    def subset(self, used_indices: Sequence[int],
               params: Optional[Dict] = None) -> "Dataset":
        """The rows ``used_indices`` (sorted), binned by this dataset's bin
        mappers (Dataset::CopySubset, dataset.cpp:503)."""
        ds = Dataset(self.data, label=self.label, reference=self,
                     feature_name=self.feature_name,
                     categorical_feature=self.categorical_feature,
                     params=params or self.params)
        # built from this dataset's handle, even where ``data`` is one
        ds._handle = None
        ds.used_indices = np.asarray(sorted(used_indices), dtype=np.int64)
        return ds

    def get_label(self) -> np.ndarray:
        return self.construct()._handle.metadata.label

    def num_data(self) -> int:
        return self.construct()._handle.num_data

    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features


class Booster:
    """Model handle: training-capable from a ``train_set``, or a model read
    from ``model_file`` / ``model_str`` (prediction only, no device).
    ``fused_route=False`` grows with the segment grower's unfused
    route/histogram kernel pair instead of the fused one;
    ``frontier_tier`` ("off", "k1" or "fusedk"; None = the default for the
    frontier width) picks the frontier grower's histogram launch under
    ``tpu_tree_impl=frontier``."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 fused_route: bool = True,
                 frontier_tier: Optional[str] = None):
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
            self.objective = create_objective(self.config)
            self.gbdt = GBDT(self.config, train_set._handle, self.objective,
                             fused_route=fused_route,
                             frontier_tier=frontier_tier)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._load(model_str)
        else:
            raise LightGBMError(
                "Booster needs train_set, model_file or model_str")

    def _load(self, model_str: str) -> None:
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
    def update(self, fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True when training cannot continue.
        ``fobj(preds, train_set) -> (grad, hess)`` gives the gradients
        from the raw training score (flat, class-major)."""
        gbdt = self._trainable()
        if fobj is None:
            return gbdt.train_one_iter()
        score = gbdt.train_score.cpu().numpy().ravel()
        grad, hess = fobj(score, self.train_set)
        return gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

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
                start_iteration: int = 0) -> np.ndarray:
        """Raw scores, the objective's output, or (``pred_leaf``) leaf
        indices of a raw feature matrix, over ``num_iteration``
        iterations from ``start_iteration``.  ``num_iteration`` None or
        negative means ``best_iteration`` when one is set, else every
        iteration (lightgbm_tpu/basic.py:528); 0 means every iteration
        too."""
        if num_iteration is None or num_iteration < 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        X = np.asarray(data, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        n_feat = self.gbdt.max_feature_idx + 1
        if X.shape[1] != n_feat:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not the "
                f"same as it was in training data ({n_feat})")
        return self.gbdt.predict(X, num_iteration=num_iteration,
                                 raw_score=raw_score, pred_leaf=pred_leaf,
                                 start_iteration=start_iteration)

    # --------------------------------------------------------------- model
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return save_model_to_string(self.gbdt, self.config,
                                    num_iteration or -1, start_iteration)

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
