"""Prediction of the port against the JAX package on the CPU.

The same trees (trained by the JAX package, handed over with convert.py
to a port booster over the same bins) predict four ways, which agree bit
for bit: the port's stacked-tree route (``predict_device="on"``: the
plain version of kernel P1 on the CPU), the JAX package's jitted
stacked-tree route (``predict_device="on"``), and both host walks.
Cases: numeric features with missing-NaN and with none, a model trained
with zero_as_missing (missing-zero), a categorical feature with unseen,
negative, NaN and fractional categories, a single-leaf tree, multiclass
(C = 3), a random forest (``average_output``), ``num_iteration`` and
``start_iteration``, values exactly on the split thresholds and +-0.0.
Also: ``stack_trees_host`` array for array, ``pred_early_stop``'s raw
scores for binary and multiclass models, ``pred_contrib`` (TreeSHAP)
within 1e-12 of JAX's, each class's block summing to the raw score, and
init_model's seeding from a model grown on the same or on other rows:
the card's logic (P1's plain version) = the raw walk = JAX's, bit for
bit.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.device_predict import \
    stack_trees_host as jax_stack_trees_host
from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.device_predict import (TreeStack, bin_rows,
                                                      stack_trees_host)
from lightgbm_tpu_torch.ops.predict import route_leaves_plain

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests: the CPU tests
    share the cores with other pytest workers, and torch's parallel
    regions on oversubscribed cores slow them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, NF, CAT = 2000, 6, 5
BASE = dict(num_leaves=15, learning_rate=0.3, verbosity=-1,
            min_data_per_group=5, cat_smooth=1.0)
MODELS = {
    "nan": dict(objective="binary"),
    "zero": dict(objective="binary", zero_as_missing=True),
    "multiclass": dict(objective="multiclass", num_class=3),
    "rf": dict(objective="binary", boosting="rf", bagging_fraction=0.6,
               bagging_freq=1),
}
ITERS = 6


def _data(seed=3):
    """Column 1 with NaN, column 2 with exact zeros, column 5 categorical
    (0-19)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.rand(N) < 0.1, 1] = np.nan
    X[rng.rand(N) < 0.2, 2] = 0.0
    X[:, CAT] = rng.randint(0, 20, size=N)
    f = X[:, 0] + np.nan_to_num(X[:, 1]) + (X[:, CAT] % 3 == 1)
    y = (f + 0.3 * rng.normal(size=N) > 0.3).astype(np.float64)
    return X, y, (X[:, CAT] % 3).astype(np.float64)


X, Y, Y_MC = _data()
_PAIRS = {}


def _pair(name):
    """(JAX booster, port Booster with the JAX booster's trees over the
    same bins); tree 2 (of class 2 % C) made a single leaf in both."""
    if name not in _PAIRS:
        params = dict(BASE, **MODELS[name])
        y = Y_MC if name == "multiclass" else Y
        jb = lgb.train(params, lgb.Dataset(X, y, categorical_feature=[CAT]),
                       ITERS)
        const = JaxTree(1)
        const.leaf_value = np.asarray([0.0625])
        jb.gbdt.models[2] = const
        jds = jb.train_set._handle
        pds = convert.dataset_from_arrays(
            jds.binned, [m.to_dict() for m in jds.bin_mappers], y)
        pb = lt.Booster(dict(params, device_type="cpu"), pds)
        pb.gbdt.models = convert.trees_from_arrays(
            [dict(vars(t), num_leaves=t.num_leaves)
             for t in jb.gbdt.models])
        pb.gbdt.iter_ = jb.gbdt.iter_
        pb.gbdt.init_scores = list(jb.gbdt.init_scores)
        _PAIRS[name] = (jb, pb)
    return _PAIRS[name]


def _queries(pb):
    """Rows of X, then rows with a feature exactly on each numeric split
    threshold, rows of +0.0 and -0.0, NaN where training had none, and
    unseen (97), negative, NaN and fractional categories."""
    rng = np.random.RandomState(5)
    rows = [X[rng.choice(N, 300, replace=False)]]
    for tree in pb.gbdt.models:
        for k in range(tree.num_leaves - 1):
            if not tree.decision_type[k] & 1:
                r = X[rng.randint(N)].copy()
                r[tree.split_feature[k]] = tree.threshold[k]
                rows.append(r[None])
    special = X[:12].copy()
    special[0:2, [0, 2, 3]] = 0.0
    special[2:4, [0, 2, 3]] = -0.0
    special[4, 0] = np.nan
    special[5:7, CAT] = 97.0
    special[7, CAT] = -3.0
    special[8, CAT] = np.nan
    special[9, CAT] = 2.5
    special[10:12, 1] = np.nan
    rows.append(special)
    return np.concatenate(rows)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stack_trees_host_equals_jax(name):
    jb, pb = _pair(name)
    jds = jb.train_set._handle
    F = len(jds.used_feature_indices)
    want = jax_stack_trees_host(jb.gbdt.models, F)
    got = stack_trees_host(pb.gbdt.models, F)
    assert len(got) == len(want) == 9
    for i in (0, 1, 2, 3, 4, 5, 7):
        np.testing.assert_array_equal(got[i], want[i])
    # the port keeps float64 leaf values; JAX's are their float32 cast
    assert got[6].dtype == np.float64
    np.testing.assert_array_equal(got[6].astype(np.float32), want[6])
    assert got[8] == want[8]


def _jax_predict(jb, Xq, device, **kw):
    jb.config.predict_device = device
    try:
        return jb.predict(Xq, **kw)
    finally:
        jb.config.predict_device = "auto"


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("num_iteration", [-1, 3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_device_route_equals_jax_and_host_walks(name, num_iteration, raw):
    jb, pb = _pair(name)
    Xq = _queries(pb)
    on = pb.predict(Xq, num_iteration=num_iteration, raw_score=raw,
                    predict_device="on")
    assert pb.gbdt.last_predict_route == "device"
    off = pb.predict(Xq, num_iteration=num_iteration, raw_score=raw,
                     predict_device="off")
    assert pb.gbdt.last_predict_route == "host"
    # "auto" on a CPU booster is the host walk
    pb.predict(Xq[:5])
    assert pb.gbdt.last_predict_route == "host"
    jax_on = _jax_predict(jb, Xq, "on", num_iteration=num_iteration,
                          raw_score=raw)
    jax_off = _jax_predict(jb, Xq, "off", num_iteration=num_iteration,
                           raw_score=raw)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, jax_off)
    # JAX's route sends a NaN category right, where both host walks read
    # it as category 0 (test_nan_category_follows_the_host_walk)
    known = ~np.isnan(Xq[:, CAT])
    np.testing.assert_array_equal(on[known], jax_on[known])


def test_nan_category_follows_the_host_walk():
    """A NaN category of a feature that is not NaN-missing is category 0
    in the host walks of both packages (CategoricalDecision, tree.h) and
    in the port's route; the JAX package's route sends it right, so there
    it differs from its own host walk (not carried over)."""
    jb, pb = _pair("multiclass")
    row = X[:40].copy()
    row[:, CAT] = np.nan
    on = pb.predict(row, raw_score=True, predict_device="on")
    np.testing.assert_array_equal(on, _jax_predict(jb, row, "off",
                                                   raw_score=True))
    zero = row.copy()
    zero[:, CAT] = 0.0
    np.testing.assert_array_equal(on, pb.predict(zero, raw_score=True))
    jax_on = _jax_predict(jb, row, "on", raw_score=True)
    assert not np.array_equal(jax_on, on)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_start_iteration_routes_equal_jax_host_walk(name):
    jb, pb = _pair(name)
    Xq = _queries(pb)
    on = pb.predict(Xq, start_iteration=2, num_iteration=3, raw_score=True,
                    predict_device="on")
    off = pb.predict(Xq, start_iteration=2, num_iteration=3, raw_score=True,
                     predict_device="off")
    want = jb.gbdt._raw_predict(Xq, 5, 2)
    if name == "rf":
        want = want / 3
    want = want[0] if want.shape[0] == 1 else want.T
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, want)


@pytest.mark.parametrize("name", ["nan", "multiclass"])
def test_leaves_of_the_plain_route_equal_the_host_walk(name):
    """Each tree's leaves under the plain route over predict-time bins
    (unseen categories -1) = the host raw walk's."""
    jb, pb = _pair(name)
    Xq = _queries(pb)
    ds = pb.train_set._handle
    bins = torch.from_numpy(bin_rows(ds, Xq))
    trees = pb.gbdt.models
    stack = TreeStack(trees, [0] * len(trees), ds.num_used_features,
                      torch.device("cpu"))
    fm = pb.gbdt.fmeta
    for t, tree in enumerate(trees):
        got = route_leaves_plain(bins, stack, t, fm.num_bin, fm.default_bin,
                                 len(Xq)).numpy()
        np.testing.assert_array_equal(got, tree.apply_raw(
            np.asfortranarray(Xq)))


@pytest.mark.parametrize("name,margin", [("nan", 1.0), ("multiclass", 0.5)])
def test_pred_early_stop_equals_jax(name, margin):
    jb, pb = _pair(name)
    Xq = _queries(pb)
    full = pb.predict(Xq, raw_score=True)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=margin)
    got = pb.predict(Xq, raw_score=True, predict_device="on", **kw)
    # per-row early stop is host-only, whatever predict_device says
    assert pb.gbdt.last_predict_route == "host"
    cfg = jb.gbdt.config
    for k, v in kw.items():
        setattr(cfg, k, v)
    try:
        want = jb.predict(Xq, raw_score=True)
    finally:
        cfg.pred_early_stop = False
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, full)    # some rows did stop


@pytest.mark.parametrize("name", ["nan", "multiclass"])
def test_pred_contrib_equals_jax(name):
    jb, pb = _pair(name)
    Xq = _queries(pb)[::9]
    got = pb.predict(Xq, pred_contrib=True)
    want = jb.predict(Xq, pred_contrib=True)
    assert got.shape == want.shape == (
        len(Xq), jb.gbdt.num_tree_per_iteration * (NF + 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    raw = pb.predict(Xq, raw_score=True).reshape(len(Xq), -1)
    sums = got.reshape(len(Xq), -1, NF + 1).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=0, atol=1e-9)
    # the parameter form: predict_contrib (alias contrib)
    np.testing.assert_array_equal(pb.predict(Xq, contrib=True), got)


def test_predict_keywords_are_prediction_parameters():
    _, pb = _pair("nan")
    with pytest.raises(NotImplementedError, match="learning_rate"):
        pb.predict(X[:3], learning_rate=0.5)
    with pytest.raises(ValueError, match="predict_device"):
        pb.predict(X[:3], predict_device="sometimes")
    # a call's keywords leave the booster's configuration as it was
    assert pb.config.predict_device == "auto"
    assert not pb.config.pred_early_stop


def test_card_walk_logic_equals_host_walks(monkeypatch):
    """The training loop's walks as a card booster makes them (P1, here
    its plain version: valid scores each iteration, DART's drops with
    their f32 train deltas, rollback, init_model's seeding over the bins,
    a late add_valid's replay) = the host walks, bit for bit: model
    texts, training scores, valid scores (multiclass DART on a
    categorical feature with NaN and zeros)."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    params = dict(BASE, objective="multiclass", num_class=3,
                  boosting="dart", drop_rate=0.5, skip_drop=0.0,
                  device_type="cpu", num_leaves=7)

    def run():
        ds = lt.Dataset(X[:1200], Y_MC[:1200], categorical_feature=[CAT])
        va = ds.create_valid(X[1200:], Y_MC[1200:])
        bst = lt.train(params, ds, 4, valid_sets=[va], verbose_eval=False)
        bst.rollback_one_iter()
        bst.update()
        ds2 = lt.Dataset(X[:1200], Y_MC[:1200], categorical_feature=[CAT])
        cont = lt.train(dict(params, boosting="gbdt"), ds2, 2,
                        init_model=bst, verbose_eval=False)
        cont.add_valid(ds2.create_valid(X[1200:], Y_MC[1200:]), "late")
        return [bst.model_to_string(), bst.gbdt.train_score.numpy(),
                *bst.gbdt.valid_scores, cont.model_to_string(),
                cont.gbdt.train_score.numpy(), *cont.gbdt.valid_scores]

    host = run()
    monkeypatch.setattr(GBDT, "_walks_on_card", lambda self: True)
    card = run()
    for a, b in zip(card, host):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows", ["same", "other"])
def test_seeding_walks_the_raw_rows_as_jax_does(rows, monkeypatch):
    """init_model's seeding from a model grown on the same rows or on
    other rows (other bin bounds, category bins in another order,
    category 19 unseen): the training score as a card booster seeds it
    (P1, here its plain version, or the raw walk where a realigned tree
    is not bins_exact) = the host's raw walk = the JAX package's, bit for
    bit; then predict "on" = "off", on P1 only where every tree is
    exact."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    params = dict(BASE, objective="multiclass", num_class=3)
    src = lt.train(dict(params, device_type="cpu"),
                   lt.Dataset(X[:1000], Y_MC[:1000],
                              categorical_feature=[CAT]), 4)
    text = src.model_to_string()
    Xb, yb = (X[:1000], Y_MC[:1000]) if rows == "same" else (
        X[1000:].copy(), Y_MC[1000:])
    if rows == "other":
        Xb[Xb[:, CAT] == 19, CAT] = 18
        Xb[:, CAT] = (Xb[:, CAT] * 7) % 19

    def seeded(pkg, **kw):
        init = pkg.Booster(model_str=text)
        return pkg.train(dict(params, **kw), pkg.Dataset(
            Xb, yb, categorical_feature=[CAT]), 0, init_model=init)

    host = seeded(lt, device_type="cpu")
    monkeypatch.setattr(GBDT, "_walks_on_card", lambda self: True)
    card = seeded(lt, device_type="cpu")
    jax_score = np.asarray(seeded(lgb).gbdt.train_score)
    exact = all(t.bins_exact for t in card.gbdt.models)
    assert exact == (rows == "same")
    assert set(card.gbdt.init_model_seconds) == {
        "card_walk" if exact else "host_walk", "device_add"}
    np.testing.assert_array_equal(card.gbdt.train_score.numpy(),
                                  host.gbdt.train_score.numpy())
    np.testing.assert_array_equal(host.gbdt.train_score.numpy(), jax_score)
    Xq = np.concatenate([Xb[:300], _queries(host)[-12:]])
    off = card.predict(Xq, raw_score=True, predict_device="off")
    on = card.predict(Xq, raw_score=True, predict_device="on")
    assert card.gbdt.last_predict_route == ("device" if exact else "host")
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(off, src.predict(Xq, raw_score=True))
