"""Parity of parameters no other port test names, against the JAX package
on the CPU (3000 x 6, 3 iterations, identical bins): ``lambda_l1``,
``min_gain_to_split``, ``max_delta_step``, ``max_cat_to_onehot`` (with
categorical columns), ``is_unbalance``, ``scale_pos_weight`` and
``first_metric_only`` (early stopping on the first of two metrics through
``train``).  Each case grows JAX's model text (tests/split_parity.py) and
differs from the model without the parameter.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.serialization import save_model_to_string

import split_parity as sp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


def _cat_data(seed=12):
    """Columns 4 and 5 categorical, of 3 and 9 categories."""
    X, y = sp.data(seed=seed)
    rng = np.random.RandomState(seed)
    a, b = rng.randint(0, 3, size=len(X)), rng.randint(0, 9, size=len(X))
    X[:, 4], X[:, 5] = a, b
    y = ((X[:, 0] + 0.8 * (a == 1) - 0.6 * np.isin(b, [2, 5, 7])
          + 0.3 * rng.normal(size=len(X))) > 0).astype(np.float64)
    return X, y


CASES = {
    "lambda_l1": dict(lambda_l1=2.0),
    "min_gain_to_split": dict(min_gain_to_split=3.0),
    "max_delta_step": dict(max_delta_step=0.3),
    "max_cat_to_onehot": dict(max_cat_to_onehot=10),
    "is_unbalance": dict(is_unbalance=True),
    "scale_pos_weight": dict(scale_pos_weight=2.5),
}


@pytest.fixture(scope="module")
def cat_xy():
    return _cat_data()


@pytest.mark.parametrize("case", list(CASES))
def test_parameter_matches_jax(case, cat_xy):
    cat = (4, 5) if case == "max_cat_to_onehot" else ()
    X, y = cat_xy if cat else sp.data(seed=13)
    if case == "is_unbalance":
        y = (np.random.RandomState(1).uniform(size=len(y)) < 0.25 + 0.5 * y
             * (X[:, 0] > 1)).astype(np.float64)
    params = dict(sp.BASE, **CASES[case])
    jds, jgb = sp.jax_trained(params, X, y, categorical=cat)
    bst = sp.port_trained(params, jds, y)
    text = sp.assert_same_model(jgb, bst, min_splits=10)
    base_jds = TpuDataset.from_numpy(X, y, config=JaxConfig(**sp.BASE),
                                     categorical_features=list(cat))
    base = sp.port_trained(sp.BASE, base_jds, y)
    assert base.model_to_string().split("parameters:")[0] != \
        text.split("parameters:")[0]
    if cat:
        assert any(t.num_cat > 0 for t in bst.gbdt.models)


def test_first_metric_only_matches_jax():
    """Early stopping watches only the first metric: the same best
    iteration and trees as JAX's ``train``."""
    X, y = sp.data(seed=14)
    params = dict(sp.BASE, learning_rate=0.6, first_metric_only=True,
                  metric=["binary_logloss", "auc"])
    out = {}
    for name, pkg, extra in (("jax", lgb, {"tpu_histogram_backend":
                                           "pallas",
                                           "tpu_tree_impl": "segment"}),
                             ("port", lt, {"tpu_tree_impl": "segment"})):
        ds = pkg.Dataset(X[:2400], y[:2400])
        va = ds.create_valid(X[2400:], y[2400:])
        kw = {"verbose_eval": False} if pkg is lgb else {}
        out[name] = pkg.train(dict(params, **extra), ds, 40,
                              valid_sets=[va], early_stopping_rounds=2,
                              **kw)
    jb, pb = out["jax"], out["port"]
    assert 1 < pb.best_iteration == jb.best_iteration < 40
    jtext = save_model_to_string(jb.gbdt, jb.config)
    assert sp._structure(pb.model_to_string()) == sp._structure(jtext)
    # the parameter lines but the JAX-only histogram backend's
    jparams = [line for line in jtext.split("parameters:")[1].splitlines()
               if not line.startswith("[tpu_histogram_backend")]
    assert pb.model_to_string().split("parameters:")[1].splitlines() == \
        jparams
