"""The boosting type's class (reference Boosting::CreateBoosting,
src/boosting/boosting.cpp:36-77; lightgbm_tpu/models/boosting_factory.py).
"""

from __future__ import annotations


def create_boosting(config, train_set, objective, **kwargs):
    """A GBDT, GOSS, DART or RF booster for ``config.boosting`` (the
    config has resolved its aliases); ``kwargs`` go to GBDT
    (``fused_route``, ``frontier_tier``, ``packed4``, ``packed_acc``,
    ``packed_acc_bits``)."""
    if config.boosting == "goss":
        from .goss import GOSS as cls
    elif config.boosting == "dart":
        from .dart import DART as cls
    elif config.boosting == "rf":
        from .rf import RF as cls
    else:
        from .gbdt import GBDT as cls
    return cls(config, train_set, objective, **kwargs)
