"""Objective functions of the port: binary log-loss and multiclass
softmax."""

from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassSoftmax


def create_objective(config) -> ObjectiveFunction:
    """Objective factory (reference ObjectiveFunction::CreateObjectiveFunction);
    Config already refuses every other objective."""
    if config.objective == "multiclass":
        return MulticlassSoftmax(config)
    return BinaryLogloss(config)


__all__ = ["ObjectiveFunction", "BinaryLogloss", "MulticlassSoftmax",
           "create_objective"]
