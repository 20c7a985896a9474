"""Subsampled training in the port against the JAX package on the CPU:
bagging, balanced bagging, feature fraction by tree and by node on both
growers, and GOSS; then the JAX package's own quality thresholds on the
port (tests/test_engine_reference_thresholds.py).

Both packages train from identical bins and labels (the port's dataset
through convert.dataset_from_arrays' hand-over), JAX with its Pallas
kernels in interpret mode, the port with the kernels' plain versions.
The same seeds draw the same bags (numpy RandomState(bagging_seed)), the
same tree masks (RandomState(feature_fraction_seed)) and the same node
masks and GOSS keys (threefry from PRNGKey(seed), utils/random.py), so a
model grows JAX's splits up to a near-tie (two gains within 1e-4, as the
port's other parity tests compare), with leaf values within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.boosting_factory import \
    create_boosting as jax_boosting
from lightgbm_tpu.models.goss import _goss_select
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.goss import goss_select
from lightgbm_tpu_torch.utils import random


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests: the CPU tests
    share the cores with other pytest workers, and torch's parallel
    regions on oversubscribed cores ran these tests 20-80 times slower
    than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

N, NF = 3000, 8
TRAIN = dict(num_leaves=15, max_bin=63, tpu_row_chunk=256, learning_rate=0.3,
             verbosity=-1, tpu_frontier_width=4)
GROWERS = ["segment", "frontier"]
MODES = {
    "bagging": (dict(bagging_fraction=0.5, bagging_freq=1), "regression"),
    "balanced": (dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.9,
                      bagging_freq=2), "binary"),
    "feature_fraction": (dict(feature_fraction=0.5), "regression"),
    "bynode": (dict(feature_fraction=0.75, feature_fraction_bynode=0.5,
                    bagging_fraction=0.8, bagging_freq=1, seed=11),
               "regression"),
}


def _data(objective, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    f = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] ** 2
    if objective == "binary":
        return X, (f + 0.5 * rng.normal(size=N) > 0).astype(np.float64)
    return X, 3.0 * f + rng.normal(size=N)


def _train_pair(params, objective, iters, grower="segment"):
    """(X, JAX booster, port Booster) after ``iters`` iterations each."""
    X, label = _data(objective)
    params = dict(TRAIN, objective=objective, **params)
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl=grower,
                    **params)
    jds = TpuDataset.from_numpy(X, label, config=cfg)
    jobj = jax_objective(cfg)
    jobj.init(jds.metadata, N)
    jgb = jax_boosting(cfg, jds, jobj)
    for _ in range(iters):
        jgb.train_one_iter()
    jgb._flush_pending()
    pds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], label)
    bst = lt.Booster(dict(params, device_type="cpu", tpu_tree_impl=grower),
                     pds)
    for _ in range(iters):
        bst.update()
    return X, jgb, bst


def _same_models(jtrees, ptrees, min_compared):
    """The same split feature and bin at gain > 1e-2 up to a near-tie
    (gains within 1e-4: the rest of the model is not compared); a tree
    grown alike has leaf values within 1e-5 + 1e-4 relative.  Returns the
    splits compared."""
    assert len(jtrees) == len(ptrees)
    compared = 0
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        same = a.num_leaves == b.num_leaves
        for k in range(min(a.num_leaves, b.num_leaves) - 1):
            ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
            if ga <= 1e-2 or gb <= 1e-2:
                same = False
                break
            if (a.split_feature[k], a.threshold_in_bin[k]) != (
                    b.split_feature[k], b.threshold_in_bin[k]):
                assert abs(ga - gb) <= 1e-4 * max(ga, gb), (
                    f"tree {i}, split {k}: gains {ga} and {gb}")
                return compared
            compared += 1
        if same:
            np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"tree {i}")
    assert compared >= min_compared
    return compared


def _all_splits(trees):
    return sum(t.num_leaves - 1 for t in trees)


@pytest.mark.parametrize("grower", GROWERS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_subsampling_grows_jax_trees(mode, grower):
    params, objective = MODES[mode]
    X, jgb, bst = _train_pair(params, objective, 3, grower)
    gb = bst.gbdt
    # the same bag, pad rows out of it
    np.testing.assert_array_equal(gb.member[:N].numpy(),
                                  np.asarray(jgb.bag_weight))
    assert not gb.member[N:].any()
    # the streams stand at the same place: the next draws agree
    if gb._masked:
        np.testing.assert_array_equal(gb._tree_feature_mask().numpy(),
                                      np.asarray(jgb._tree_feature_mask()))
    if params.get("feature_fraction_bynode", 1.0) < 1.0:
        np.testing.assert_array_equal(gb._key.numpy(),
                                      np.asarray(jgb._key).astype(np.int64))
    compared = _same_models(jgb.models, gb.models, 20)
    if compared == _all_splits(jgb.models):
        np.testing.assert_allclose(bst.predict(X, raw_score=True),
                                   jgb._raw_predict(X)[0], rtol=0, atol=1e-3)


def test_bynode_model_is_the_same_for_every_steps():
    """The device loop's steps a round do not change a by-node model: each
    step gathers its children's masks by the split ordinal it reads from
    the state, not from the host."""
    X, y = _data("regression")
    texts = set()
    for steps in (1, 3, 14):
        bst = lt.Booster(dict(TRAIN, device_type="cpu",
                              **MODES["bynode"][0]), lt.Dataset(X, y))
        bst.gbdt.grower.steps = steps
        for _ in range(2):
            bst.update()
        texts.add(bst.model_to_string())
    assert len(texts) == 1


def test_feature_fraction_uses_only_the_drawn_features():
    """feature_fraction 0.25 of 8 features: each tree splits on at most
    its two drawn features."""
    X, y = _data("regression")
    bst = lt.train(dict(TRAIN, feature_fraction=0.25, device_type="cpu"),
                   lt.Dataset(X, y), 4)
    rng = np.random.RandomState(2)       # feature_fraction_seed's default
    for tree in bst.gbdt.models:
        drawn = set(rng.choice(NF, 2, replace=False))
        assert set(tree.split_feature[:tree.num_leaves - 1]) <= drawn


@pytest.mark.parametrize("C", [1, 3])
def test_goss_select_matches_jax(C):
    """The selection and the amplified gradients, bit for bit, on L2
    gradients (score - label, hessian 1) with ties in |g|: the stable
    descending rank, the top_k, and the rows whose uniform key is at
    most the other_k-th (ties at that key kept, as JAX keeps them)."""
    rng = np.random.RandomState(C)
    n = 5001
    score = np.round(rng.normal(size=(C, n)), 2).astype(np.float32)
    label = np.round(rng.normal(size=n), 1).astype(np.float32)
    g = (score - label).astype(np.float32)
    h = np.ones((C, n), np.float32)
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    for it in (3, 17):
        jkey = jax.random.fold_in(jax.random.PRNGKey(0), 0x60550000 + it)
        pkey = random.fold_in(random.prng_key(0), 0x60550000 + it)
        jg, jh, jm = _goss_select(jnp.asarray(g), jnp.asarray(h), jkey,
                                  jnp.int32(top_k), jnp.int32(other_k))
        pg, ph, pm = goss_select(torch.from_numpy(g), torch.from_numpy(h),
                                 pkey, top_k, other_k)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
        assert pm.sum() >= top_k + other_k


def test_goss_regression_grows_jax_trees():
    """lr 0.5: two warm-up iterations on every row, then three GOSS
    iterations; the bag after the last is JAX's, pad rows out."""
    X, jgb, bst = _train_pair(dict(boosting="goss", learning_rate=0.5,
                                   top_rate=0.3, other_rate=0.2),
                              "regression", 5)
    gb = bst.gbdt
    m = gb.member[:N].numpy()
    np.testing.assert_array_equal(m, np.asarray(jgb.bag_weight))
    assert int(N * 0.3) + int(N * 0.2) <= m.sum() < N
    assert not gb.member[N:].any()
    np.testing.assert_array_equal(gb._key.numpy(),
                                  np.asarray(jgb._key).astype(np.int64))
    compared = _same_models(jgb.models, gb.models, 40)
    assert compared == _all_splits(jgb.models)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jgb._raw_predict(X)[0], rtol=0, atol=1e-3)


def test_goss_binary_grows_jax_splits_up_to_a_near_tie():
    """Under an exp-link objective one ulp in a gradient can swap two rows
    at the top_k boundary: the bags differ in a handful of rows at most,
    the splits agree up to a near-tie."""
    X, jgb, bst = _train_pair(dict(boosting="goss", learning_rate=0.5),
                              "binary", 5, "frontier")
    diff = (bst.gbdt.member[:N].numpy() != np.asarray(jgb.bag_weight)).sum()
    assert diff <= 8
    _same_models(jgb.models, bst.gbdt.models, 14)


def test_goss_rate_checks():
    X, y = _data("regression")
    for rates in (dict(top_rate=0.7, other_rate=0.5),
                  dict(top_rate=0.0, other_rate=0.1)):
        with pytest.raises(lt.LightGBMError):
            lt.train(dict(TRAIN, boosting="goss", device_type="cpu",
                          **rates), lt.Dataset(X, y), 1)


@pytest.mark.parametrize("alias", [
    {"boosting_type": "goss"}, {"boost": "gbrt"},
    {"boosting": "random_forest", "subsample": 0.5, "subsample_freq": 1},
    {"colsample_bytree": 0.5, "colsample_bynode": 0.5, "random_state": 3},
    {"sub_row": 0.5, "bagging": 0.5, "bagging_fraction_seed": 9},
])
def test_mode_aliases_resolve(alias):
    cfg = lt.Config(device_type="cpu", **alias)
    want = JaxConfig(**alias)
    for name in ("boosting", "bagging_fraction", "bagging_freq",
                 "bagging_seed", "feature_fraction",
                 "feature_fraction_bynode", "seed"):
        jv, pv = getattr(want, name), getattr(cfg, name)
        if name == "boosting":
            jv = {"gbrt": "gbdt", "random_forest": "rf"}.get(jv, jv)
        assert pv == jv, name


# --------------------------------------------- the JAX package's gates
def _log_loss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


@pytest.fixture(scope="module")
def bc_split():
    sklearn = pytest.importorskip("sklearn")
    from sklearn.datasets import load_breast_cancer
    from sklearn.model_selection import train_test_split
    X, y = load_breast_cancer(return_X_y=True)
    assert sklearn
    return train_test_split(X, y, test_size=0.1, random_state=42)


# (params, rounds, logloss gate): the JAX package's test of each mode
GATES = {
    "rf": ({"boosting_type": "rf", "bagging_freq": 1,
            "bagging_fraction": 0.5, "feature_fraction": 0.5,
            "num_leaves": 50}, 50, 0.25),
    "bynode": ({"feature_fraction_bynode": 0.8}, 25, 0.13),
    "dart": ({"boosting": "dart", "drop_rate": 0.1}, 50, 0.20),
    "goss": ({"boosting": "goss"}, 50, 0.16),
}


@pytest.mark.parametrize("mode", sorted(GATES))
def test_reference_quality_gate(bc_split, mode):
    X_train, X_test, y_train, y_test = bc_split
    params, rounds, gate = GATES[mode]
    params = dict(params, objective="binary", metric="binary_logloss",
                  verbose=-1, device_type="cpu")
    bst = lt.train(params, lt.Dataset(X_train, y_train), rounds,
                   verbose_eval=False)
    ret = _log_loss(y_test, bst.predict(X_test))
    assert ret < gate
    if mode == "bynode":
        # feature_fraction changes the model
        bst2 = lt.train(dict(params, feature_fraction=0.5),
                        lt.Dataset(X_train, y_train), rounds,
                        verbose_eval=False)
        assert _log_loss(y_test, bst2.predict(X_test)) != ret
