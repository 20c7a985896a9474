"""Model text I/O of the port (lightgbm_tpu_torch.Booster(model_file= /
model_str=), save_model, dump_model, pickling) against the JAX package's
on the CPU.

Prediction from a model text is the host tree walk in both packages, so
a text read by either predicts bit for bit as the other: binary numeric
models and multiclass models with categorical bitsets, a stock
LightGBM-format model (tests/test_model_interop.py's golden model), leaf
indices, importances, the JSON dump and iteration slices.  A loaded
Booster resolves no device: it works with no card.
"""

import pickle

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

N, NF = 2000, 6
CAT = [4, 5]


def _data(seed=11):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < 0.05] = np.nan
    X[:, CAT] = rng.randint(0, 9, size=(N, len(CAT)))
    Xn = np.nan_to_num(X)
    logit = Xn[:, 0] + 0.5 * Xn[:, 1] + np.isin(X[:, 4], (1, 3, 7))
    y_bin = (logit + 0.3 * rng.normal(size=N) > 0.5).astype(np.float64)
    y_mc = np.digitize(logit + 0.3 * rng.normal(size=N), (0.0, 1.0))
    return X, y_bin, y_mc.astype(np.float64)


X, Y_BIN, Y_MC = _data()

# tests/test_model_interop.py's stock LightGBM 2.2.4-format model: binary,
# 3 features, 2 trees:
#   tree 0: x0<=0.5 ? (x1<=-0.25 ? -0.4 : 0.55) : 0.3
#   tree 1: x2<=1.25 ? -0.2 : 0.1
GOLDEN_MODEL = """tree
version=v2
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=2
objective=binary sigmoid:1
feature_names=f0 f1 f2
feature_infos=[-5:5] [-5:5] [-5:5]
tree_sizes=480 340

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=0.5 -0.25
decision_type=2 2
left_child=1 -1
right_child=-2 -3
leaf_value=-0.4 0.3 0.55
leaf_weight=100 120 80
leaf_count=100 120 80
internal_value=0 0.1
internal_weight=300 180
internal_count=300 180
shrinkage=0.1

Tree=1
num_leaves=2
num_cat=0
split_feature=2
split_gain=4
threshold=1.25
decision_type=2
left_child=-1
right_child=-2
leaf_value=-0.2 0.1
leaf_weight=150 150
leaf_count=150 150
internal_value=0
internal_weight=300
internal_count=300
shrinkage=0.1

end of trees

feature importances:
f0=1
f1=1
f2=1

parameters:
end of parameters
"""


def _golden_raw(X):
    t0 = np.where(X[:, 0] <= 0.5,
                  np.where(X[:, 1] <= -0.25, -0.4, 0.55), 0.3)
    t1 = np.where(X[:, 2] <= 1.25, -0.2, 0.1)
    return t0 + t1

CONFIGS = {
    "binary": (dict(objective="binary", num_leaves=15, max_bin=63,
                    learning_rate=0.3), Y_BIN, []),
    "multiclass_cat": (dict(objective="multiclass", num_class=3,
                            num_leaves=7, max_bin=63, learning_rate=0.3,
                            min_data_per_group=20, cat_smooth=1.0),
                       Y_MC, CAT),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    """(name, JAX Booster, port Booster), each trained 4 iterations, and
    each one's model text."""
    params, y, cat = CONFIGS[request.param]
    common = dict(params, verbosity=-1, tpu_row_chunk=256)
    jb = lgb.train(dict(common, tpu_histogram_backend="pallas",
                        tpu_tree_impl="segment"),
                   lgb.Dataset(X, y, categorical_feature=cat), 4,
                   verbose_eval=False)
    pb = lt.train(dict(common, device_type="cpu"),
                  lt.Dataset(X, y, categorical_feature=cat), 4,
                  verbose_eval=False)
    return request.param, jb, pb


def test_round_trip_predicts_bit_for_bit(models):
    """The port's text -> port Booster -> text -> port Booster: the same
    predictions, raw and converted, as the training Booster."""
    name, _, pb = models
    b1 = lt.Booster(model_str=pb.model_to_string())
    b2 = lt.Booster(model_str=b1.model_to_string())
    assert b1.model_to_string() == b2.model_to_string()
    for bst in (b1, b2):
        assert bst.train_set is None
        assert bst.num_trees() == pb.num_trees()
        assert bst.current_iteration() == 4
        np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                      pb.predict(X, raw_score=True))
        np.testing.assert_array_equal(bst.predict(X), pb.predict(X))
    if name == "multiclass_cat":
        text = pb.model_to_string()
        assert "cat_threshold=" in text and "cat_threshold_inner=" in text


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_text_of_one_package_predicts_in_the_other(models, direction,
                                                   tmp_path):
    _, jb, pb = models
    path = str(tmp_path / "model.txt")
    src, dst_pkg = ((jb, lt) if direction == "jax_to_port" else (pb, lgb))
    src.save_model(path)
    loaded = dst_pkg.Booster(model_file=path)
    for raw in (True, False):
        np.testing.assert_array_equal(loaded.predict(X, raw_score=raw),
                                      src.predict(X, raw_score=raw))
    # both packages read the text alike: leaves, importances, the dump,
    # slices
    mine = (loaded if dst_pkg is lt else lt.Booster(model_file=path))
    theirs = (loaded if dst_pkg is lgb else lgb.Booster(model_file=path))
    np.testing.assert_array_equal(mine.predict(X, pred_leaf=True),
                                  theirs.predict(X, pred_leaf=True))
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(mine.feature_importance(kind),
                                      theirs.feature_importance(kind))
    assert mine.dump_model() == theirs.dump_model()
    assert mine.feature_name() == theirs.feature_name()
    for start, num in ((0, None), (1, 2), (3, 5)):
        assert (mine.model_to_string(num, start)
                == theirs.model_to_string(num, start))


def test_trained_booster_surface_matches_jax(models):
    """On the models each package trained: leaf indices of the same
    shape, split importances of the same splits, gains within 1e-3
    relative, and a dump of the same keys."""
    _, jb, pb = models
    lp, lj = pb.predict(X, pred_leaf=True), jb.predict(X, pred_leaf=True)
    assert lp.shape == lj.shape == (N, pb.num_trees())
    assert (lp < 15).all() and (lp >= 0).all()
    np.testing.assert_allclose(pb.feature_importance("gain"),
                               jb.feature_importance("gain"), rtol=1e-3)
    assert pb.dump_model().keys() == jb.dump_model().keys()
    with pytest.raises(lt.LightGBMError):
        pb.feature_importance("cover")


def test_pickle_restores_a_predicting_booster(models):
    _, _, pb = models
    pb.best_iteration = 3
    try:
        b = pickle.loads(pickle.dumps(pb))
    finally:
        pb.best_iteration = 4
    assert b.best_iteration == 3 and b.train_set is None
    np.testing.assert_array_equal(b.predict(X, num_iteration=3),
                                  pb.predict(X, num_iteration=3))
    with pytest.raises(lt.LightGBMError):
        b.update()


def test_start_iteration_slice_predicts_its_iterations(models):
    """A text of iterations [1, 3) carries the init score in its first
    trees and predicts as the in-memory model over those iterations."""
    _, _, pb = models
    sliced = lt.Booster(model_str=pb.model_to_string(2, start_iteration=1))
    assert sliced.current_iteration() == 2
    np.testing.assert_array_equal(
        sliced.predict(X, raw_score=True),
        pb.predict(X, raw_score=True, start_iteration=1, num_iteration=2))
    leaves = pb.predict(X, pred_leaf=True)
    C = pb.num_model_per_iteration()
    np.testing.assert_array_equal(
        pb.predict(X, pred_leaf=True, start_iteration=1, num_iteration=2),
        leaves[:, C:3 * C])


def test_loading_needs_no_card(models, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pb = models
    b = lt.Booster(model_str=pb.model_to_string())
    np.testing.assert_array_equal(b.predict(X), pb.predict(X))


def test_golden_stock_model_predicts():
    """The stock LightGBM-format model."""
    bst = lt.Booster(model_str=GOLDEN_MODEL)
    assert bst.num_trees() == 2 and bst.feature_name() == ["f0", "f1", "f2"]
    Xg = np.random.RandomState(42).normal(size=(500, 3)) * 2
    raw = bst.predict(Xg, raw_score=True)
    np.testing.assert_allclose(raw, _golden_raw(Xg), rtol=1e-12)
    np.testing.assert_allclose(bst.predict(Xg),
                               1.0 / (1.0 + np.exp(-_golden_raw(Xg))),
                               rtol=1e-9)
    np.testing.assert_array_equal(
        raw, lgb.Booster(model_str=GOLDEN_MODEL).predict(Xg, raw_score=True))
    again = lt.Booster(model_str=bst.model_to_string())
    np.testing.assert_array_equal(again.predict(Xg, raw_score=True), raw)
    # a loaded tree routes binned rows only once aligned with a dataset,
    # and then as the JAX package's remap routes them
    from lightgbm_tpu.models.serialization import _remap_tree_to_bins
    yg = (Xg[:, 0] > 0).astype(float)
    ds = lt.Dataset(Xg, yg).construct()._handle
    jds = lgb.Dataset(Xg, yg).construct()._handle
    jbst = lgb.Booster(model_str=GOLDEN_MODEL)
    for tree, jtree in zip(bst.gbdt.models, jbst.gbdt.models):
        assert not tree.bins_aligned
        with pytest.raises(lt.LightGBMError):
            tree.predict_binned(ds.bins_t, ds.feature_infos())
        np.testing.assert_array_equal(
            tree.aligned_to(ds).predict_binned(ds.bins_t,
                                               ds.feature_infos()),
            _remap_tree_to_bins(jtree, jds).predict_binned(
                jds.binned, jds.feature_infos()))


def test_walk_split_over_threads_finds_the_same_leaves(models, monkeypatch):
    """The host walk of a large row set runs one chunk a worker in
    threads (more workers than cores here), each writing its own rows of
    one leaf array: the leaves are the single walk's."""
    from lightgbm_tpu_torch.models import tree as tree_mod
    _, _, pb = models
    rows = np.tile(X, (8, 1))
    single = pb.predict(rows, pred_leaf=True)
    monkeypatch.setattr(tree_mod, "PARALLEL_ROWS", 1000)
    monkeypatch.setattr(tree_mod, "_walk_workers", lambda: 37)
    np.testing.assert_array_equal(pb.predict(rows, pred_leaf=True), single)
    ds = pb.train_set._handle
    for t in pb.gbdt.models:
        monkeypatch.setattr(tree_mod, "PARALLEL_ROWS", 1 << 40)
        want = t.apply_binned(ds.bins_t, ds.feature_infos())
        monkeypatch.setattr(tree_mod, "PARALLEL_ROWS", 1000)
        np.testing.assert_array_equal(
            t.apply_binned(ds.bins_t, ds.feature_infos()), want)
