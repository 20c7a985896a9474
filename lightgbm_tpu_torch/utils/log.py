"""Logging with LightGBM-style levels gated by verbosity.

Reference: include/LightGBM/utils/log.h:30-120 (`Log` static class with
Fatal/Warning/Info/Debug).
"""

from __future__ import annotations

import sys

_WARNING, _INFO = 0, 1

_verbosity = 1


class LightGBMError(Exception):
    """Raised on fatal errors (reference Log::Fatal throws std::runtime_error)."""


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def _write(level_str: str, msg: str) -> None:
    sys.stdout.write(f"[LightGBM-Torch] [{level_str}] {msg}\n")
    sys.stdout.flush()


def log_info(msg: str) -> None:
    if _verbosity >= _INFO:
        _write("Info", msg)


def log_warning(msg: str) -> None:
    if _verbosity >= _WARNING:
        _write("Warning", msg)


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)


def check(cond: bool, msg: str = "check failed") -> None:
    if not cond:
        log_fatal(msg)
