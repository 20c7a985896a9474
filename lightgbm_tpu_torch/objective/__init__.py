"""Objective functions of the port (binary log-loss only)."""

from .base import ObjectiveFunction
from .binary import BinaryLogloss


def create_objective(config) -> ObjectiveFunction:
    """Objective factory (reference ObjectiveFunction::CreateObjectiveFunction);
    Config already refuses every objective but binary."""
    return BinaryLogloss(config)


__all__ = ["ObjectiveFunction", "BinaryLogloss", "create_objective"]
