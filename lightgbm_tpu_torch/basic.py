"""User-facing Dataset and Booster.

Counterpart of lightgbm_tpu/basic.py (Dataset, Booster.predict :525,
save_model :589, model_to_string :599), after the reference python
package's basic.py.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .core.dataset import TorchDataset
from .models.gbdt import GBDT
from .models.serialization import save_model_to_string
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

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._handle is not None:
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


class Booster:
    """Training-capable model handle.  ``fused_route=False`` grows with
    the segment grower's unfused route/histogram kernel pair instead of
    the fused one; ``frontier_tier`` ("off", "k1" or "fusedk"; None = the
    default for the frontier width) picks the frontier grower's histogram
    launch under ``tpu_tree_impl=frontier``."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 fused_route: bool = True,
                 frontier_tier: Optional[str] = None):
        self.params = dict(params or {})
        # the iteration predict uses by default; 0 = none set (the port
        # has no early stopping, so only a caller sets it)
        self.best_iteration = 0
        self.config = Config.from_params(self.params)
        set_verbosity(self.config.verbosity)
        if train_set is None:
            raise LightGBMError("Booster needs a train_set (loading a model "
                                "file is not part of lightgbm_tpu_torch)")
        train_set.construct(self.config)
        self.train_set = train_set
        self.gbdt = GBDT(self.config, train_set._handle,
                         create_objective(self.config),
                         fused_route=fused_route,
                         frontier_tier=frontier_tier)

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.reference = self.train_set
        data.construct(self.config)
        self.gbdt.add_valid(name, data._handle)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training cannot continue."""
        return self.gbdt.train_one_iter()

    def eval_train(self) -> List:
        return self.gbdt.eval_train()

    def eval_valid(self) -> List:
        return self.gbdt.eval_valid()

    def predict(self, data, num_iteration: Optional[int] = -1,
                raw_score: bool = False) -> np.ndarray:
        """Raw scores or the objective's output of a raw feature matrix.
        ``num_iteration`` None or negative means ``best_iteration`` when
        one is set, else every iteration (lightgbm_tpu/basic.py:528); 0
        means every iteration too."""
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
                                 raw_score=raw_score)

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return save_model_to_string(self.gbdt, self.config,
                                    num_iteration or -1)

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        """Write the model text atomically (tmp file + os.replace)."""
        text = self.model_to_string(num_iteration)
        d = os.path.dirname(os.path.abspath(filename))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".model.")
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, filename)
        return self
