"""Objective functions of the port: L2 regression (the default), binary
log-loss and multiclass softmax; "none" has none (the caller gives the
gradients)."""

from typing import Optional

from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassSoftmax
from .regression import RegressionL2Loss


def create_objective(config) -> Optional[ObjectiveFunction]:
    """Objective factory (reference ObjectiveFunction::CreateObjectiveFunction);
    Config already refuses every other objective."""
    if config.objective == "none":
        return None
    if config.objective == "multiclass":
        return MulticlassSoftmax(config)
    if config.objective == "binary":
        return BinaryLogloss(config)
    return RegressionL2Loss(config)


__all__ = ["ObjectiveFunction", "BinaryLogloss", "MulticlassSoftmax",
           "RegressionL2Loss", "create_objective"]
