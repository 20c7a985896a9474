"""Host-side metrics: l2, binary log-loss, AUC, multiclass log-loss and
error.

Reference: src/metric/regression_metric.hpp (l2), binary_metric.hpp
(binary_logloss:115, AUC:159),
src/metric/multiclass_metric.hpp (multi_logloss, multi_error with top-k).
Metrics are numpy over the raw score ([N], or [C, N] for multiclass);
``eval`` applies the objective's link where the reference does
(Metric::Eval's ConvertOutput hook).
"""

from __future__ import annotations

import numpy as np

from ..utils.log import log_warning


class Metric:
    name: str = ""
    higher_better = False

    def __init__(self, config=None):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)

    def eval(self, score: np.ndarray, objective=None) -> float:
        raise NotImplementedError


class L2Metric(Metric):
    name = "l2"

    def eval(self, score, objective=None):
        """Mean squared error of the objective's output (the port has no
        sample weights)."""
        p = score if objective is None else objective.convert_output(score)
        return float(np.mean((self.label - p) ** 2))


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective=None):
        p = score if objective is None else objective.convert_output(score)
        p = np.clip(p, 1e-15, 1 - 1e-15)
        y = (self.label > 0).astype(np.float64)
        return float(np.mean(-(y * np.log(p) + (1 - y) * np.log(1 - p))))


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, score, objective=None):
        """Rank-sum AUC with half credit inside tied-score groups
        (binary_metric.hpp:159-240)."""
        order = np.argsort(score, kind="stable")
        y = self.label[order]
        s = score[order]
        pos = float(np.sum(y > 0))
        neg = float(np.sum(y <= 0))
        if pos <= 0 or neg <= 0:
            log_warning("AUC is undefined with a single class")
            return 1.0
        _, first_idx, inv = np.unique(s, return_index=True,
                                      return_inverse=True)
        grp_neg = np.add.reduceat((y <= 0).astype(np.float64), first_idx)
        cum_before = np.concatenate([[0], np.cumsum(grp_neg)[:-1]])
        auc_sum = np.sum((cum_before[inv] + 0.5 * grp_neg[inv]) * (y > 0))
        return float(auc_sum / (pos * neg))


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective=None):
        """score [C, N]; softmax through the objective's link."""
        p = score if objective is None else objective.convert_output(score)
        p = np.clip(p, 1e-15, 1 - 1e-15)
        lab = self.label.astype(np.int64)
        return float(np.mean(-np.log(p[lab, np.arange(self.num_data)])))


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective=None):
        """Share of rows whose label is not among the top
        ``multi_error_top_k`` raw scores."""
        lab = self.label.astype(np.int64)
        k = max(1, int(getattr(self.config, "multi_error_top_k", 1)))
        if k == 1:
            err = (np.argmax(score, axis=0) != lab).astype(np.float64)
        else:
            target = score[lab, np.arange(self.num_data)]
            rank = np.sum(score > target[None, :], axis=0)
            err = (rank >= k).astype(np.float64)
        return float(np.mean(err))


_METRICS = {"l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
            "auc": AUCMetric,
            "multi_logloss": MultiLoglossMetric,
            "multi_error": MultiErrorMetric}


def create_metric(name: str, config=None) -> Metric:
    return _METRICS[name](config)
