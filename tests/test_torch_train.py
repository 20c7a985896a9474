"""Slice-level parity of the PyTorch port (lightgbm_tpu_torch) with the
JAX package on the CPU: binary GBDT through the segment grower.

Both packages grow from identical bins (the JAX dataset handed to the port
through lightgbm_tpu_torch.convert).  JAX runs its Pallas kernels in
interpret mode, the port the kernels' plain PyTorch versions.  Held to the
rule of the JAX package's own segment-vs-fused tests
(tests/test_grower_seg.py): the same split feature and bin threshold for
every split whose gain is above 1e-2 (below that, float32 summation order
may break ties differently), raw predictions within 1e-3.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.core.dataset import TorchDataset

N, NF, ITERS = 2000, 6, 3
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              tpu_row_chunk=256, verbosity=-1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=42):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < 0.05] = np.nan
    X[:, 3] = np.where(rng.uniform(size=N) < 0.3, 0.0, X[:, 3])
    Xn = np.nan_to_num(X)
    y = (Xn[:, 0] + 0.5 * Xn[:, 1] - 0.3 * Xn[:, 2] ** 2
         + 0.2 * rng.normal(size=N) > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def pair():
    """(X, JAX GBDT, port Booster) trained on identical bins."""
    X, y = _data()
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl="segment",
                    **PARAMS)
    jds = TpuDataset.from_numpy(X, y, config=cfg)
    assert jds.bundle is None
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = JaxGBDT(cfg, jds, obj)
    assert jgb._use_segment
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    ds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y)
    bst = lt.Booster(dict(PARAMS, device_type="cpu"), ds)
    for _ in range(ITERS):
        bst.update()
    return X, jgb, bst


def test_slice_trees_match_jax(pair):
    X, jgb, bst = pair
    jt, pt = jgb.models, bst.gbdt.models
    assert len(jt) == len(pt) == ITERS
    compared = 0
    for i, (a, b) in enumerate(zip(jt, pt)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while (k < nf and a.split_gain[k] > 1e-2
               and b.split_gain[k] > 1e-2):
            k += 1
        np.testing.assert_array_equal(a.split_feature[:k],
                                      b.split_feature[:k], f"tree {i}")
        np.testing.assert_array_equal(a.threshold_in_bin[:k],
                                      b.threshold_in_bin[:k], f"tree {i}")
        compared += k
    assert compared >= 20
    assert np.abs(jgb._raw_predict(X)[0]
                  - bst.predict(X, raw_score=True)).max() < 1e-3


def test_saved_model_loads_in_jax_package(pair, tmp_path):
    X, _, bst = pair
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    loaded = lightgbm_tpu.Booster(model_file=path)
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))


def test_port_predicts_jax_grown_trees(pair):
    X, jgb, _ = pair
    trees = convert.trees_from_arrays([vars(t) for t in jgb.models])
    raw = np.zeros(len(X)) + jgb.init_scores[0]
    for t in trees:
        raw += t.predict_raw(X)
    np.testing.assert_array_equal(raw, jgb._raw_predict(X)[0])


def test_predict_num_iteration_none_matches_jax(pair, tmp_path):
    """num_iteration None or negative means best_iteration when one is
    set, else every iteration; 0 means every iteration: the port's
    predictions equal the JAX booster's on the same model text."""
    X, _, bst = pair
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    loaded = lightgbm_tpu.Booster(model_file=path)
    try:
        for best in (0, 2):
            bst.best_iteration = loaded.best_iteration = best
            for it in (None, -1, 0, 1, ITERS):
                np.testing.assert_array_equal(
                    bst.predict(X, num_iteration=it, raw_score=True),
                    loaded.predict(X, num_iteration=it, raw_score=True))
        bst.best_iteration = 1
        np.testing.assert_array_equal(bst.predict(X, num_iteration=None),
                                      bst.predict(X, num_iteration=1))
    finally:
        bst.best_iteration = 0


def test_objective_omitted_is_regression_in_both_packages():
    assert JaxConfig().objective == "regression"
    assert lt.Config(device_type="cpu").objective == "regression"
    X, y = _data(8)
    bst = lt.Booster({"device_type": "cpu", "verbosity": -1,
                      "num_leaves": 4}, lt.Dataset(X, y))
    assert type(bst.gbdt.objective).__name__ == "RegressionL2Loss"
    assert bst.gbdt.metric_names == ["l2"]


@pytest.mark.parametrize("reg_sqrt", [False, True])
def test_regression_trees_match_jax(reg_sqrt):
    """L2 regression (the default objective) from identical bins: the
    same trees, split for split, and predictions within 1e-5; with
    reg_sqrt the label is sign(y) sqrt(|y|) and predictions square back.
    The l2 metric agrees with the JAX package's."""
    from lightgbm_tpu.metric import L2Metric as JaxL2
    X, _ = _data(9)
    Xn = np.nan_to_num(X)
    rng = np.random.RandomState(9)
    y = 3.0 * Xn[:, 0] + Xn[:, 1] - Xn[:, 2] ** 2 + 0.1 * rng.normal(size=N)
    params = dict(num_leaves=7, max_bin=63, tpu_row_chunk=256, verbosity=-1,
                  reg_sqrt=reg_sqrt)
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl="segment",
                    **params)
    jds = TpuDataset.from_numpy(X, y, config=cfg)
    jobj = jax_objective(cfg)
    jobj.init(jds.metadata, jds.num_data)
    jgb = JaxGBDT(cfg, jds, jobj)
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    ds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y)
    bst = lt.Booster(dict(params, device_type="cpu"), ds)
    for _ in range(ITERS):
        bst.update()
    assert bst.config.objective == cfg.objective == "regression"
    assert bst.gbdt.init_scores[0] == pytest.approx(jgb.init_scores[0],
                                                    abs=1e-6)
    for a, b in zip(jgb.models, bst.gbdt.models, strict=True):
        assert a.num_leaves == b.num_leaves
        n = a.num_leaves - 1
        for f in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:n],
                                          getattr(b, f)[:n], f)
    jraw = jgb._raw_predict(X)[0]
    np.testing.assert_allclose(bst.predict(X, raw_score=True), jraw,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bst.predict(X), jobj.convert_output(jraw),
                               rtol=0, atol=1e-4 if reg_sqrt else 1e-5)
    jm = JaxL2(cfg)
    jm.init(jds.metadata, jds.num_data)
    assert bst.eval_train()[0][:2] == ("training", "l2")
    assert bst.eval_train()[0][2] == pytest.approx(
        jm.eval(np.asarray(jgb.train_score[0], dtype=np.float64), jobj),
        rel=1e-5)


def test_binning_matches_jax():
    X, y = _data(7)
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(max_bin=63,
                                                       verbosity=-1))
    pds = TorchDataset.from_numpy(X, y, config=lt.Config(
        max_bin=63, device_type="cpu"))
    np.testing.assert_array_equal(pds.used_feature_indices,
                                  jds.used_feature_indices)
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    for a, b in zip(pds.bin_mappers, jds.bin_mappers):
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
        assert (a.missing_type, a.default_bin) == (b.missing_type,
                                                   b.default_bin)


def test_fused_and_unfused_paths_grow_the_same_trees():
    X, y = _data(3)
    params = dict(PARAMS, device_type="cpu", num_leaves=7)
    out = []
    for fused in (True, False):
        bst = lt.Booster(params, lt.Dataset(X, y), fused_route=fused)
        for _ in range(2):
            bst.update()
        out.append(bst)
    assert out[0].model_to_string() == out[1].model_to_string()


def test_train_records_metrics_and_valid_scores():
    X, y = _data(5)
    ds = lt.Dataset(X[:1500], y[:1500])
    valid = ds.create_valid(X[1500:], y[1500:])
    evals = {}
    bst = lt.train(dict(PARAMS, device_type="cpu",
                        metric=["auc", "binary_logloss"]),
                   ds, 3, valid_sets=[ds, valid],
                   valid_names=["train", "valid"], evals_result=evals)
    assert len(evals["training"]["auc"]) == 3
    assert evals["training"]["auc"][-1] > evals["training"]["auc"][0]
    assert evals["training"]["binary_logloss"][-1] \
        < evals["training"]["binary_logloss"][0]
    raw = bst.predict(X[1500:], raw_score=True)
    vscore = bst.gbdt.valid_scores[0]
    np.testing.assert_allclose(vscore, raw, rtol=0, atol=1e-12)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(1)
    with pytest.raises(lt.LightGBMError, match="cuda"):
        lt.train({"objective": "binary", "verbosity": -1},
                 lt.Dataset(X, y), 1)


@pytest.mark.parametrize("params", [
    {"num_machines": 2},
    {"tpu_boost_chunk": 4},
    {"snapshot_freq": 5},
    {"pre_partition": True},
    {"tree_learner": "data"},
    {"tree": "voting"},
    {"no_such_parameter": 1},
    {"nthread": 4},
])
def test_unsupported_parameter_raises(params):
    with pytest.raises(NotImplementedError):
        lt.Config(device_type="cpu", **params)


def test_bad_device_type_raises():
    with pytest.raises(lt.LightGBMError):
        lt.Config(device_type="tpu")


def test_port_imports_no_jax():
    root = os.path.join(os.path.dirname(__file__), os.pardir,
                        "lightgbm_tpu_torch")
    bad, scanned = [], set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            scanned.add(os.path.relpath(os.path.join(dirpath, name), root))
            with open(os.path.join(dirpath, name)) as fh:
                for line in fh:
                    s = line.strip()
                    if (s.startswith(("import jax", "from jax"))
                            or s.startswith("from lightgbm_tpu.")
                            or s.startswith("from lightgbm_tpu import")
                            or s == "import lightgbm_tpu"
                            or s.startswith("import lightgbm_tpu.")):
                        bad.append(f"{name}: {s}")
    assert not bad, bad
    # the prediction modules are among those read
    assert {os.path.join("models", "device_predict.py"),
            os.path.join("models", "shap.py"),
            os.path.join("ops", "predict.py")} <= scanned
