"""DCG/NDCG computation shared by the lambdarank objective and the rank
metrics.

The port's own copy of lightgbm_tpu/utils/dcg.py (reference
src/metric/dcg_calculator.cpp: label gains 2^l - 1, position discounts
1/log2(2+i), DCG@k, max DCG@k).  Host numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

DEFAULT_LABEL_GAIN_SIZE = 31


def default_label_gain(size: int = DEFAULT_LABEL_GAIN_SIZE) -> np.ndarray:
    return (2.0 ** np.arange(size)) - 1.0


class DCGCalculator:
    def __init__(self, label_gain: Optional[Sequence[float]] = None):
        if label_gain is None or len(label_gain) == 0:
            self.label_gain = default_label_gain()
        else:
            self.label_gain = np.asarray(label_gain, dtype=np.float64)

    def check_labels(self, labels: np.ndarray) -> None:
        lab = labels.astype(np.int64)
        if lab.min() < 0 or lab.max() >= len(self.label_gain):
            raise ValueError(
                f"Rank labels must be in [0, {len(self.label_gain)}); "
                "set label_gain to extend")

    def discount(self, positions: np.ndarray) -> np.ndarray:
        return 1.0 / np.log2(2.0 + positions)

    def cal_dcg_at_k(self, k: int, labels: np.ndarray,
                     scores: np.ndarray) -> float:
        """DCG@k of the documents ranked by score, descending (stable)."""
        order = np.argsort(-scores, kind="stable")
        top = labels[order[:k]].astype(np.int64)
        pos = np.arange(len(top))
        return float(np.sum(self.label_gain[top] * self.discount(pos)))

    def cal_maxdcg_at_k(self, k: int, labels: np.ndarray) -> float:
        top = np.sort(labels.astype(np.int64))[::-1][:k]
        pos = np.arange(len(top))
        return float(np.sum(self.label_gain[top] * self.discount(pos)))
