"""Host-side metrics: every metric of the JAX package.

Counterpart of lightgbm_tpu/metric/__init__.py; reference
src/metric/regression_metric.hpp (l2/rmse/l1/quantile/huber/fair/poisson/
mape/gamma/gamma_deviance/tweedie), binary_metric.hpp (binary_logloss:115,
binary_error:139, AUC:159), multiclass_metric.hpp (multi_logloss,
multi_error with top-k), xentropy_metric.hpp (cross_entropy,
cross_entropy_lambda, kullback_leibler), rank_metric.hpp (NDCG@k) and
map_metric.hpp (MAP@k).  Metrics are numpy over the raw score ([N], or
[C, N] for multiclass); ``eval`` applies the objective's link where the
reference does (Metric::Eval's ConvertOutput hook).  A metric is the
sample-weighted mean of its losses where the data has weights (the rank
metrics weight each query by its average member weight); the ranking
metrics give one value at each ``eval_at`` position (``eval_multi``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.dcg import DCGCalculator
from ..utils.log import log_fatal, log_warning


class Metric:
    name: str = ""
    higher_better = False
    weights = None      # [N] float64 sample weights; set by ``init``

    def __init__(self, config=None):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        weights = getattr(metadata, "weights", None)
        self.weights = (np.asarray(weights, dtype=np.float64)
                        if weights is not None else None)
        self.sum_weights = (float(self.weights.sum())
                            if self.weights is not None else float(num_data))

    def eval(self, score: np.ndarray, objective=None) -> float:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        """The (sample-weighted) mean of per-row losses."""
        if self.weights is None:
            return float(np.mean(losses))
        return float(np.sum(losses * self.weights) / self.sum_weights)


def _convert(score, objective):
    if objective is not None:
        return objective.convert_output(score)
    return score


# ------------------------------------------------------------------ regression
class L2Metric(Metric):
    name = "l2"

    def eval(self, score, objective=None):
        p = _convert(score, objective)
        return self._avg((self.label - p) ** 2)


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective=None):
        return float(np.sqrt(super().eval(score, objective)))


class L1Metric(Metric):
    name = "l1"

    def eval(self, score, objective=None):
        p = _convert(score, objective)
        return self._avg(np.abs(self.label - p))


class QuantileMetric(Metric):
    name = "quantile"

    def eval(self, score, objective=None):
        a = float(self.config.alpha)
        d = self.label - _convert(score, objective)
        return self._avg(np.where(d >= 0, a * d, (a - 1) * d))


class HuberMetric(Metric):
    name = "huber"

    def eval(self, score, objective=None):
        a = float(self.config.alpha)
        d = np.abs(self.label - _convert(score, objective))
        return self._avg(np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a)))


class FairMetric(Metric):
    name = "fair"

    def eval(self, score, objective=None):
        c = float(self.config.fair_c)
        x = np.abs(self.label - _convert(score, objective))
        return self._avg(c * c * (x / c - np.log1p(x / c)))


class PoissonMetric(Metric):
    name = "poisson"

    def eval(self, score, objective=None):
        p = np.maximum(_convert(score, objective), 1e-15)
        return self._avg(p - self.label * np.log(p))


class MAPEMetric(Metric):
    name = "mape"

    def eval(self, score, objective=None):
        p = _convert(score, objective)
        return self._avg(np.abs((self.label - p))
                     / np.maximum(1.0, np.abs(self.label)))


class GammaMetric(Metric):
    name = "gamma"

    def eval(self, score, objective=None):
        """Negative log-likelihood of a Gamma of shape 1."""
        p = np.maximum(_convert(score, objective), 1e-15)
        x = self.label / p
        return self._avg(x + np.log(p) - np.log(np.maximum(self.label, 1e-15)))


class GammaDevianceMetric(Metric):
    name = "gamma_deviance"

    def eval(self, score, objective=None):
        p = np.maximum(_convert(score, objective), 1e-15)
        x = self.label / p
        return self._avg(2.0 * (np.log(np.maximum(1.0 / np.maximum(x, 1e-15),
                                              1e-15)) + x - 1.0))


class TweedieMetric(Metric):
    name = "tweedie"

    def eval(self, score, objective=None):
        rho = float(self.config.tweedie_variance_power)
        p = np.maximum(_convert(score, objective), 1e-15)
        a = self.label * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return self._avg(-a + b)


# -------------------------------------------------------------------- binary
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective=None):
        p = np.clip(_convert(score, objective), 1e-15, 1 - 1e-15)
        # positive <=> label > 0 (the reference's is_pos rule)
        y = (self.label > 0).astype(np.float64)
        return self._avg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective=None):
        pred = (_convert(score, objective) > 0.5).astype(np.float64)
        y = (self.label > 0).astype(np.float64)
        return self._avg((pred != y).astype(np.float64))


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, score, objective=None):
        """Weighted rank-sum AUC with half credit inside tied-score
        groups (binary_metric.hpp:159-240)."""
        order = np.argsort(score, kind="stable")
        y = self.label[order]
        w = (self.weights[order] if self.weights is not None
             else np.ones_like(y))
        s = score[order]
        pos_w = np.sum(w * (y > 0))
        neg_w = np.sum(w * (y <= 0))
        if pos_w <= 0 or neg_w <= 0:
            log_warning("AUC is undefined with a single class")
            return 1.0
        _, first_idx, inv = np.unique(s, return_index=True,
                                      return_inverse=True)
        grp_neg = np.add.reduceat(w * (y <= 0), first_idx)
        cum_before = np.concatenate([[0], np.cumsum(grp_neg)[:-1]])
        auc_sum = np.sum((cum_before[inv] + 0.5 * grp_neg[inv])
                         * w * (y > 0))
        return float(auc_sum / (pos_w * neg_w))


# ----------------------------------------------------------------- multiclass
class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective=None):
        """score [C, N]; softmax through the objective's link."""
        p = np.clip(_convert(score, objective), 1e-15, 1 - 1e-15)
        lab = self.label.astype(np.int64)
        return self._avg(-np.log(p[lab, np.arange(self.num_data)]))


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective=None):
        """Share of rows whose label is not among the top
        ``multi_error_top_k`` raw scores."""
        lab = self.label.astype(np.int64)
        k = max(1, int(self.config.multi_error_top_k))
        if k == 1:
            err = (np.argmax(score, axis=0) != lab).astype(np.float64)
        else:
            target = score[lab, np.arange(self.num_data)]
            rank = np.sum(score > target[None, :], axis=0)
            err = (rank >= k).astype(np.float64)
        return self._avg(err)


# ----------------------------------------------------------------- xentropy
class CrossEntropyMetric(BinaryLoglossMetric):
    name = "cross_entropy"


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        """The raw score is the lambda parameter: p = 1 - exp(-w log1p(
        exp(score))), the weight as exposure; an unweighted mean, as the
        JAX package takes it."""
        hhat = np.log1p(np.exp(np.asarray(score, dtype=np.float64)))
        w = self.weights if self.weights is not None else 1.0
        z = np.clip(1.0 - np.exp(-w * hhat), 1e-15, 1 - 1e-15)
        return float(np.mean(-(self.label * np.log(z)
                               + (1 - self.label) * np.log(1 - z))))


class KLDivMetric(Metric):
    name = "kullback_leibler"

    def eval(self, score, objective=None):
        p = np.clip(_convert(score, objective), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        return self._avg(y * np.log(y / p)
                         + (1 - y) * np.log((1 - y) / (1 - p)))


# ----------------------------------------------------------------------- rank
class _RankMetric(Metric):
    """A metric of each query's ranking at the ``eval_at`` positions,
    averaged over the queries weighted by their query weights.  The sums
    run scalar by scalar in the JAX package's order and types (a float32
    query weight makes a float32 product), so the values are its own."""
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log_fatal(f"The {self.name.upper()} metric requires query "
                      "information")
        self.boundaries = np.asarray(metadata.query_boundaries)
        self.eval_at = [int(k) for k in (self.config.eval_at
                                         or [1, 2, 3, 4, 5])]
        self.query_weights = metadata.query_weights

    def _queries(self):
        """(start, end, weight) of each query."""
        for q in range(len(self.boundaries) - 1):
            yield (self.boundaries[q], self.boundaries[q + 1],
                   self.query_weights[q] if self.query_weights is not None
                   else 1.0)

    def eval(self, score, objective=None):
        return self.eval_multi(score, objective)[0]


class NDCGMetric(_RankMetric):
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.calc = DCGCalculator(self.config.label_gain)

    def eval_multi(self, score, objective=None) -> List[float]:
        out = np.zeros(len(self.eval_at))
        sumw = 0.0
        for s, e, qw in self._queries():
            lab, sc = self.label[s:e], score[s:e]
            sumw += qw
            for i, k in enumerate(self.eval_at):
                maxdcg = self.calc.cal_maxdcg_at_k(k, lab)
                if maxdcg <= 0:
                    out[i] += qw  # no relevant document counts as perfect
                else:
                    out[i] += qw * self.calc.cal_dcg_at_k(k, lab, sc) / maxdcg
        return list(out / max(sumw, 1e-20))


class MAPMetric(_RankMetric):
    name = "map"

    def eval_multi(self, score, objective=None) -> List[float]:
        out = np.zeros(len(self.eval_at))
        sumw = 0.0
        for s, e, qw in self._queries():
            lab = (self.label[s:e] > 0).astype(np.float64)
            rel = lab[np.argsort(-score[s:e], kind="stable")]
            prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            sumw += qw
            for i, k in enumerate(self.eval_at):
                top = slice(0, min(k, len(rel)))
                out[i] += qw * (np.sum(prec[top] * rel[top])
                                / max(min(k, int(lab.sum())), 1))
        return list(out / max(sumw, 1e-20))


_METRICS = {
    "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric, "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric, "ndcg": NDCGMetric, "map": MAPMetric,
}


def create_metric(name: str, config=None) -> Metric:
    """A metric by its canonical name (config.METRIC_ALIASES)."""
    return _METRICS[name](config)
