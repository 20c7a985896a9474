"""Objective functions of the port: the JAX package's fifteen
(lightgbm_tpu/objective/__init__.py) — the regression family, binary,
multiclass softmax and one-vs-all, the two cross-entropies and
lambdarank; "none" has none (the caller gives the gradients)."""

from typing import Optional

from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG
from .regression import (RegressionFairLoss, RegressionGammaLoss,
                         RegressionHuberLoss, RegressionL1Loss,
                         RegressionL2Loss, RegressionMAPELoss,
                         RegressionPoissonLoss, RegressionQuantileLoss,
                         RegressionTweedieLoss)
from .xentropy import CrossEntropy, CrossEntropyLambda

_REGISTRY = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config) -> Optional[ObjectiveFunction]:
    """Objective factory (reference ObjectiveFunction::
    CreateObjectiveFunction); Config has resolved the name's aliases."""
    if config.objective == "none":
        return None
    return _REGISTRY[config.objective](config)


__all__ = ["ObjectiveFunction", "create_objective"] + \
    [c.__name__ for c in _REGISTRY.values()]
