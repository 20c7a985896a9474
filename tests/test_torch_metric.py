"""The port's metrics (lightgbm_tpu_torch.metric) against the JAX
package's (lightgbm_tpu.metric) on the same seeded scores and labels,
with no training: every metric but the ranking ones (ndcg and map need
query groups), each through the raw score and, where it has one, through
an objective's link.  Held to 1e-9 relative: both are float64 numpy
over the same formula.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu import metric as jax_metric
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import metric as port_metric
from lightgbm_tpu_torch.config import METRIC_ALIASES
from lightgbm_tpu_torch.objective import create_objective

N = 500
C = 4
# metric -> the score it reads: "real" (any value), "pos" (a positive
# prediction), "prob" (a probability) or "class" ([C, N] raw)
METRICS = {
    "l2": "real", "rmse": "real", "l1": "real", "quantile": "real",
    "huber": "real", "fair": "real", "poisson": "pos", "mape": "real",
    "gamma": "pos", "gamma_deviance": "pos", "tweedie": "pos",
    "binary_logloss": "prob", "binary_error": "prob", "auc": "real",
    "multi_logloss": "class", "multi_error": "class",
    "cross_entropy": "prob", "cross_entropy_lambda": "real",
    "kullback_leibler": "prob",
}
PARAMS = dict(alpha=0.7, fair_c=1.3, tweedie_variance_power=1.2,
              multi_error_top_k=2)


def _case(kind, seed=3):
    rng = np.random.RandomState(seed)
    if kind == "class":
        return (rng.normal(size=(C, N)),
                rng.randint(0, C, size=N).astype(np.float64))
    if kind == "prob":
        # soft labels in [0, 1] for the cross-entropy family
        return rng.uniform(0.02, 0.98, size=N), rng.uniform(size=N).round(1)
    if kind == "pos":
        return rng.uniform(0.1, 4.0, size=N), rng.poisson(1.5, size=N) * 1.0
    score = rng.normal(size=N)
    # ties in the score, as a model's leaves make them
    score[::7] = score[1::7][:len(score[::7])]
    return score, np.round(rng.normal(size=N) + score, 1)


def _pair(name, label, port_cfg=None):
    md = SimpleNamespace(label=label, weights=None, query_boundaries=None)
    jm = jax_metric.create_metric(name, JaxConfig(**PARAMS))
    pm = port_metric.create_metric(
        name, port_cfg or lt.Config(device_type="cpu", **PARAMS))
    jm.init(md, N)
    pm.init(md, N)
    assert (pm.name, pm.higher_better) == (jm.name, jm.higher_better)
    return jm, pm


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax_on_raw_scores(name):
    score, label = _case(METRICS[name])
    jm, pm = _pair(name, label)
    want = jm.eval(score, None)
    assert np.isfinite(want)
    assert pm.eval(score, None) == pytest.approx(want, rel=1e-9, abs=0)


@pytest.mark.parametrize("name,objective", [
    ("binary_logloss", "binary"), ("binary_error", "binary"),
    ("cross_entropy", "binary"), ("kullback_leibler", "binary"),
    ("l2", "regression"), ("huber", "regression"),
    ("multi_logloss", "multiclass"),
])
def test_metric_matches_jax_through_the_objective_link(name, objective):
    kind = "class" if objective == "multiclass" else "real"
    score, label = _case(kind, seed=5)
    if objective == "binary":
        label = (label > 0).astype(np.float64)
    extra = {"num_class": C} if objective == "multiclass" else {}
    cfg = lt.Config(device_type="cpu", objective=objective, **extra,
                    **PARAMS)
    jm, pm = _pair(name, label, cfg)
    jobj = jax_objective(JaxConfig(objective=objective, **extra))
    want = jm.eval(score, jobj)
    assert pm.eval(score, create_objective(cfg)) == pytest.approx(
        want, rel=1e-9, abs=0)


def test_metric_aliases_are_jax_without_ranking():
    want = {k: v for k, v in jax_metric._ALIASES.items()
            if v not in ("ndcg", "map")}
    assert METRIC_ALIASES == want
    assert set(METRIC_ALIASES.values()) == set(METRICS)
    cfg = lt.Config(device_type="cpu",
                    metric=["mae", "rmse", "l1", "xentropy"])
    assert cfg.metric == ["l1", "rmse", "cross_entropy"]
