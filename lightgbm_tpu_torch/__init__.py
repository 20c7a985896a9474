"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains binary GBDT models on dense numeric data on an NVIDIA card
(``device_type="cuda"``, the default) through hand-written CUDA kernels
(``csrc/``), or on the CPU (``device_type="cpu"``) through the kernels'
plain PyTorch versions.  The API follows the LightGBM python package:
``Dataset``, ``train``, ``Booster.predict`` / ``save_model``.
"""

from .basic import Booster, Dataset
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
