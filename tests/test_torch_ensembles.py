"""DART, random forests, refit and the modes through cv in the port,
against the JAX package on the CPU.

  * DART in both modes: the drop lists (numpy RandomState(drop_seed)),
    the tree weights and shrinkages, and the model, JAX's splits up to a
    near-tie with leaf values within 1e-5 and the same model text
    structure;
  * RF: the biased leaves, the averaged predictions and metrics, and the
    RF model text (``average_output``) loaded by either package predicting
    bit for bit; RF without bagging raises in both;
  * refit: leaf values within 1e-9 of JAX's on the same trees, and its
    snapshot/restore;
  * cv with bagging within 1e-5 of JAX's means; early stopping under
    DART warns and trains on.

Both packages train from identical bins and labels (convert.py), JAX in
interpret mode.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.boosting_factory import \
    create_boosting as jax_boosting
from lightgbm_tpu.models.serialization import save_model_to_string
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.refit import (restore_leaf_values,
                                             snapshot_leaf_values)

N, NF = 3000, 8
TRAIN = dict(num_leaves=15, max_bin=63, tpu_row_chunk=256, learning_rate=0.3,
             verbosity=-1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(objective, seed=7, n=N):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, NF))
    f = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] ** 2
    if objective == "binary":
        return X, (f + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return X, 3.0 * f + rng.normal(size=n)


def _pair(params, objective, valid=False):
    """(X, JAX booster, port Booster), untrained, from identical bins; with
    ``valid`` both score the first 500 rows as a valid set."""
    X, label = _data(objective)
    params = dict(TRAIN, objective=objective, **params)
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl="segment",
                    **params)
    jds = TpuDataset.from_numpy(X, label, config=cfg)
    jobj = jax_objective(cfg)
    jobj.init(jds.metadata, N)
    jgb = jax_boosting(cfg, jds, jobj)
    pds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], label)
    bst = lt.Booster(dict(params, device_type="cpu"), pds)
    if valid:
        jv = jds.create_valid(X[:500], label[:500])
        jgb.add_valid_data("v", jv)
        bst.add_valid(convert.dataset_from_arrays(
            jv.binned, [m.to_dict() for m in jds.bin_mappers],
            label[:500]), "v")
    return X, jgb, bst


def _same_models(jtrees, ptrees):
    """Every split the same (feature, bin) at gain > 1e-2 up to a near-tie
    (gains within 1e-4); trees grown alike have leaf values within 1e-5 +
    1e-4 relative.  Returns True when every split agreed."""
    assert len(jtrees) == len(ptrees)
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        assert a.num_leaves == b.num_leaves, f"tree {i}"
        for k in range(a.num_leaves - 1):
            ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
            if (a.split_feature[k], a.threshold_in_bin[k]) != (
                    b.split_feature[k], b.threshold_in_bin[k]):
                assert abs(ga - gb) <= 1e-4 * max(ga, gb), (i, k, ga, gb)
                return False
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5, err_msg=f"tree {i}")
    return True


def _structure(text):
    """A model text's tree lines that hold no float: the structure."""
    keys = ("Tree=", "num_leaves=", "split_feature=", "decision_type=",
            "left_child=", "right_child=", "leaf_count=", "internal_count=")
    return [line for line in text.split("end of trees")[0].splitlines()
            if line.startswith(keys)]


def _recorded_drops(booster):
    """Wrap ``booster._select_drop`` to record each iteration's list."""
    drops, select = [], booster._select_drop

    def record():
        d = select()
        drops.append(list(d))
        return d

    booster._select_drop = record
    return drops


@pytest.mark.parametrize("xgboost_mode", [False, True])
def test_dart_matches_jax(xgboost_mode):
    params = dict(boosting="dart", drop_rate=0.5, skip_drop=0.2, max_drop=3,
                  xgboost_dart_mode=xgboost_mode,
                  uniform_drop=xgboost_mode)
    X, jgb, bst = _pair(params, "regression", valid=True)
    gb = bst.gbdt
    jdrops, pdrops = _recorded_drops(jgb), _recorded_drops(gb)
    for _ in range(7):
        jgb.train_one_iter()
        bst.update()
    assert pdrops == jdrops
    assert sum(len(d) for d in pdrops) >= 3
    assert gb.tree_weight == pytest.approx(jgb.tree_weight, rel=1e-12)
    assert gb.sum_weight == pytest.approx(jgb.sum_weight, rel=1e-12)
    assert [t.shrinkage for t in gb.models] == pytest.approx(
        [t.shrinkage for t in jgb.models], rel=1e-12)
    assert len(gb.drop_seconds) == 7
    assert _same_models(jgb.models, gb.models)
    assert _structure(bst.model_to_string()) == _structure(
        save_model_to_string(jgb, jgb.config))
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jgb._raw_predict(X)[0], atol=1e-4)
    np.testing.assert_allclose(gb.train_score.numpy(),
                               np.asarray(jgb.train_score), atol=1e-4)
    np.testing.assert_allclose(gb.valid_scores[0], jgb.valid_scores[0][0],
                               atol=1e-4)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_rf_matches_jax(objective):
    params = dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
                  feature_fraction=0.8, metric=["l2"])
    X, jgb, bst = _pair(params, objective, valid=True)
    gb = bst.gbdt
    for _ in range(4):
        jgb.train_one_iter()
        bst.update()
    jgb._flush_pending()
    assert gb.init_scores == [0.0]
    # the bias is in the leaves, and the scores hold sums of 4 trees
    assert _same_models(jgb.models, gb.models)
    assert gb._rf_init == pytest.approx(jgb._rf_init, rel=1e-6)
    np.testing.assert_allclose(gb.train_score.numpy(),
                               np.asarray(jgb.train_score), atol=1e-4)
    np.testing.assert_allclose(bst.predict(X), np.asarray(jgb.predict(X)),
                               atol=1e-5)
    # metrics on the averaged score, as JAX's
    jgb.setup_metrics(["l2"])
    for got, want in ((gb.eval_valid(0), jgb.eval_valid(0)),
                      (gb.eval_train(), jgb.eval_train())):
        assert got[0][1] == pytest.approx(want[0][1], rel=1e-5)
    # the RF text, loaded by either package, predicts bit for bit
    text = bst.model_to_string()
    assert "\naverage_output\n" in text
    assert lt.Booster(model_str=text).gbdt.average_output
    np.testing.assert_array_equal(lt.Booster(model_str=text).predict(X),
                                  bst.predict(X))
    np.testing.assert_array_equal(lgb.Booster(model_str=text).predict(X),
                                  bst.predict(X))
    jtext = save_model_to_string(jgb, jgb.config)
    np.testing.assert_array_equal(lt.Booster(model_str=jtext).predict(X),
                                  lgb.Booster(model_str=jtext).predict(X))
    np.testing.assert_array_equal(
        lt.Booster(model_str=text).predict(X, num_iteration=2),
        lgb.Booster(model_str=text).predict(X, num_iteration=2))
    assert bst.dump_model()["average_output"] is True


def test_rf_without_bagging_raises_in_both():
    X, y = _data("binary", n=500)
    with pytest.raises(Exception):
        lgb.train({"objective": "binary", "boosting": "rf", "verbose": -1},
                  lgb.Dataset(X, y), 3, verbose_eval=False)
    with pytest.raises(lt.LightGBMError, match="bagging"):
        lt.train({"objective": "binary", "boosting": "rf", "verbose": -1,
                  "device_type": "cpu"}, lt.Dataset(X, y), 3)


@pytest.mark.parametrize("decay", [None, 0.3])
def test_refit_matches_jax(decay):
    """The same trees (the port's bagged model text, loaded by each
    package) refitted on new weighted rows; then the trained booster's own
    refit, undone by its snapshot."""
    X, y = _data("regression")
    params = dict(TRAIN, bagging_fraction=0.7, bagging_freq=1,
                  lambda_l2=0.5, device_type="cpu")
    bst = lt.train(params, lt.Dataset(X, y), 4)
    text = bst.model_to_string()
    X2, y2 = _data("regression", seed=21, n=1200)
    w2 = np.random.RandomState(3).uniform(0.5, 2.0, size=1200)
    jbst = lgb.Booster(model_str=text)
    pld = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    for b in (jbst, pld):
        b.config.lambda_l2 = 0.5
        b.refit(X2, y2, weight=w2, decay_rate=decay)
    for a, b in zip(jbst.gbdt.models, pld.gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-9)
    before = snapshot_leaf_values(bst.gbdt)
    bst.refit(X2, y2, weight=w2, decay_rate=decay)
    assert all(not np.array_equal(a, t.leaf_value)
               for a, t in zip(before, bst.gbdt.models))
    restore_leaf_values(bst.gbdt, before)
    for a, t in zip(before, bst.gbdt.models):
        np.testing.assert_array_equal(t.leaf_value, a)
    with pytest.raises(ValueError):
        restore_leaf_values(bst.gbdt, before[:-1])


def test_cv_with_bagging_matches_jax():
    X, y = _data("binary")
    params = dict(objective="binary", num_leaves=15, max_bin=63,
                  bagging_fraction=0.6, bagging_freq=1,
                  feature_fraction=0.75, metric=["binary_logloss"],
                  verbose=-1)
    want = lgb.cv(dict(params, tpu_histogram_backend="pallas",
                       tpu_tree_impl="segment"), lgb.Dataset(X, y), 3,
                  nfold=3, seed=5)
    got = lt.cv(dict(params, device_type="cpu"), lt.Dataset(X, y), 3,
                nfold=3, seed=5)
    np.testing.assert_allclose(got["valid binary_logloss-mean"],
                               want["valid binary_logloss-mean"], atol=1e-5)


def test_early_stopping_under_dart_warns_and_trains_on(capsys):
    X, y = _data("binary")
    params = dict(TRAIN, objective="binary", boosting="dart",
                  drop_rate=0.5, learning_rate=1.0, device_type="cpu",
                  metric=["binary_logloss"], verbosity=0)
    ds = lt.Dataset(X[:2000], y[:2000])
    bst = lt.train(params, ds, 8, valid_sets=[ds.create_valid(X[2000:],
                                                              y[2000:])],
                   early_stopping_rounds=1, verbose_eval=False)
    assert bst.current_iteration() == 8
    assert bst.best_iteration == 8
    assert "not available in dart mode" in capsys.readouterr().out
