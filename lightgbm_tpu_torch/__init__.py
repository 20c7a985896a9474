"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains GBDT models with the JAX package's fifteen objectives (the
regression family, binary, multiclass softmax and one-vs-all,
cross-entropy, lambdarank) on dense data, numeric or categorical, with
sample weights, init scores and query groups, on an NVIDIA card
(``device_type="cuda"``, the
default) through hand-written CUDA kernels (``csrc/``), or on the CPU
(``device_type="cpu"``) through the kernels' plain PyTorch versions.  The
API follows the LightGBM python package: ``Dataset``, ``train`` (valid
sets, callbacks, early stopping, custom objective and metric, continued
training), ``cv``, ``Booster`` (predict, save/load, rollback,
importances).
"""

from . import callback
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

__all__ = ["Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "LightGBMError", "callback", "cv",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
