"""The port's training session (lightgbm_tpu_torch.train / cv, callbacks,
continued training, rollback) against the JAX package's on the CPU.

Both packages bin the same raw rows (their binning agrees byte for byte,
tests/test_torch_train.py::test_binning_matches_jax).  JAX runs its
Pallas kernels in interpret mode, the port the kernels' plain PyTorch
versions.  Held to tests/test_torch_train.py's rule: the same split
feature and bin for every split with gain > 1e-2, raw predictions within
1e-3; here also the same best iteration and metric values within 1e-6
relative.  Also the port's repairs of C5 (a valid set added after
training is scored by the trees grown), C6 (best_iteration as JAX sets
it) and C7 (early_stopping_round accepted, as JAX accepts it).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

N, NF, NTRAIN = 2000, 6, 1500
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              tpu_row_chunk=256, learning_rate=0.3, verbosity=-1,
              metric=["binary_logloss", "auc"])
JAX_PARAMS = dict(PARAMS, tpu_histogram_backend="pallas",
                  tpu_tree_impl="segment")
PORT_PARAMS = dict(PARAMS, device_type="cpu")
ROUNDS = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=42, nan_share=0.05):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < nan_share] = np.nan
    Xn = np.nan_to_num(X)
    y = (Xn[:, 0] + 0.5 * Xn[:, 1] - 0.3 * Xn[:, 2] ** 2
         + 0.4 * rng.normal(size=N) > 0).astype(np.float64)
    return X, y


X, Y = _data()
# Without NaN.  A NaN-missing split of a leaf whose training rows hold no
# NaN has two equal gains (NaN left, NaN right); float rounding of the
# histogram sums picks one, and the two packages round differently.  Only
# rows with NaN that were not in training (a cv fold's test rows) see the
# difference, so cv is held to 1e-6 on data without NaN.
X_DENSE, Y_DENSE = _data(nan_share=0.0)


def _sets(pkg):
    ds = pkg.Dataset(X[:NTRAIN], Y[:NTRAIN])
    return ds, ds.create_valid(X[NTRAIN:], Y[NTRAIN:])


def _train(pkg, rounds, params=None, **kw):
    """(booster, evals_result) of ``pkg``.train over the train rows, the
    held-out rows as the valid set "valid"."""
    params = dict(JAX_PARAMS if pkg is lgb else PORT_PARAMS, **(params or {}))
    ds, va = _sets(pkg)
    evals = {}
    bst = pkg.train(params, ds, rounds, valid_sets=[va],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, **kw)
    return bst, evals


def assert_same_trees(jtrees, ptrees, min_compared=10):
    assert len(jtrees) == len(ptrees)
    compared = 0
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
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
    assert compared >= min_compared


def assert_same_curves(jev, pev):
    assert jev.keys() == pev.keys()
    for d in jev:
        assert jev[d].keys() == pev[d].keys()
        for m in jev[d]:
            np.testing.assert_allclose(pev[d][m], jev[d][m], rtol=1e-6,
                                       atol=0, err_msg=f"{d} {m}")


def assert_same_predictions(jbst, pbst, rows=X):
    np.testing.assert_allclose(pbst.predict(rows, raw_score=True),
                               jbst.predict(rows, raw_score=True),
                               rtol=0, atol=1e-3)


# --------------------------------------------------------- early stopping
@pytest.fixture(scope="module")
def early_stop():
    out = {}
    for pkg in (lgb, lt):
        recorded = {}
        bst, evals = _train(pkg, ROUNDS, early_stopping_rounds=3,
                            callbacks=[pkg.callback.record_evaluation(
                                recorded)])
        out[pkg.__name__] = (bst, evals, recorded)
    return out["lightgbm_tpu"], out["lightgbm_tpu_torch"]


def test_early_stopping_matches_jax(early_stop):
    (jb, jev, _), (pb, pev, _) = early_stop
    assert 0 < jb.best_iteration < ROUNDS
    assert pb.best_iteration == jb.best_iteration
    assert pb.current_iteration() == jb.current_iteration()
    assert pb.best_iteration + 3 == pb.current_iteration()
    assert pb.best_score.keys() == jb.best_score.keys() == {"valid"}
    for m, v in jb.best_score["valid"].items():
        assert pb.best_score["valid"][m] == pytest.approx(v, rel=1e-6)
    assert_same_curves(jev, pev)
    assert len(pev["valid"]["auc"]) == pb.current_iteration()
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    assert_same_predictions(jb, pb)
    # predict defaults to the best iteration
    np.testing.assert_array_equal(
        pb.predict(X), pb.predict(X, num_iteration=pb.best_iteration))


def test_record_evaluation_is_evals_result(early_stop):
    (_, jev, jrec), (_, pev, prec) = early_stop
    assert prec == pev
    assert_same_curves(jrec, prec)


# ------------------------------------------------------- fobj and feval
def _logloss_grad(preds, train_set):
    """Binary log-loss gradients of the raw score."""
    p = 1.0 / (1.0 + np.exp(-preds))
    y = train_set.get_label()
    return p - y, p * (1.0 - p)


def _error_rate(preds, data):
    """fobj leaves the raw score: its sign is the class."""
    return "error", float(np.mean((preds > 0) != (data.get_label() > 0))), \
        False


def _mean_prob(preds, data):
    return "mean_prob", float(np.mean(preds)), True


@pytest.mark.parametrize("custom", ["fobj", "feval"])
def test_custom_objective_and_metric_match_jax(custom):
    kw = ({"fobj": _logloss_grad, "feval": _error_rate} if custom == "fobj"
          else {"feval": _mean_prob})
    (jb, jev), (pb, pev) = (_train(pkg, 8, **kw) for pkg in (lgb, lt))
    if custom == "fobj":
        assert pb.config.objective == "none" and pb.objective is None
    assert list(pev["valid"]) == ["binary_logloss", "auc",
                                  kw["feval"](np.zeros(1), _sets(lt)[1])[0]]
    assert_same_curves(jev, pev)
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    assert_same_predictions(jb, pb)
    # the training set's metrics and feval come from the training score
    jt, pt = jb.eval_train(kw["feval"]), pb.eval_train(kw["feval"])
    assert [r[:2] for r in pt] == [r[:2] for r in jt]
    np.testing.assert_allclose([r[2] for r in pt], [r[2] for r in jt],
                               rtol=1e-6)


# --------------------------------------------------- continued training
@pytest.fixture(scope="module")
def first_half(tmp_path_factory):
    """Each package's 5-iteration model, in memory and saved."""
    d = tmp_path_factory.mktemp("init_model")
    out = {}
    for pkg in (lgb, lt):
        bst, _ = _train(pkg, 5)
        path = str(d / f"{pkg.__name__}.txt")
        bst.save_model(path)
        out[pkg.__name__] = (bst, path)
    return out


@pytest.mark.parametrize("source", ["booster", "jax_file", "port_file"])
def test_init_model_continues_as_jax_does(first_half, source):
    """Continued for 5 more iterations: from each package's own Booster,
    or both from one model file (a JAX model continued in the port, a
    port model continued in JAX)."""
    out = {}
    for pkg in (lgb, lt):
        if source == "booster":
            init = first_half[pkg.__name__][0]
        else:
            init = first_half["lightgbm_tpu" if source == "jax_file"
                              else "lightgbm_tpu_torch"][1]
        out[pkg.__name__] = _train(pkg, 5, init_model=init)
    (jb, jev), (pb, pev) = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    assert pb.current_iteration() == jb.current_iteration() == 10
    assert pb.best_iteration == 10
    # the seeded training score: the JAX package's adds, in its order
    jscore = np.asarray(jb.gbdt.train_score, dtype=np.float64)[0]
    pscore = pb.gbdt.train_score.numpy()[0].astype(np.float64)
    np.testing.assert_allclose(pscore, jscore, rtol=0, atol=1e-3)
    assert_same_curves(jev, pev)
    assert_same_trees(jb.gbdt.models[5:], pb.gbdt.models[5:], 5)
    assert_same_predictions(jb, pb)


def test_init_model_seeds_the_score_of_the_loaded_trees(first_half):
    """Zero iterations from a model file: the training and valid scores
    are the loaded model's raw predictions, and the next tree grows from
    them (the model counts as boosted from its average)."""
    bst0, path = first_half["lightgbm_tpu_torch"]
    pb, _ = _train(lt, 0, init_model=path)
    raw = bst0.predict(X, raw_score=True, num_iteration=5)
    np.testing.assert_allclose(pb.gbdt.train_score.numpy()[0],
                               raw[:NTRAIN], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb.gbdt.valid_scores[0], raw[NTRAIN:],
                               rtol=0, atol=1e-12)
    assert pb.gbdt._boosted_from_average
    assert all(t.bins_aligned for t in pb.gbdt.models)
    assert pb.gbdt.init_model_seconds.keys() == {"host_walk", "device_add"}


# ---------------------------------------------------------------- rollback
def test_rollback_one_iter_matches_jax():
    out = {}
    for pkg in (lgb, lt):
        bst, _ = _train(pkg, 6)
        bst.rollback_one_iter()
        out[pkg.__name__] = bst
    jb, pb = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    ref, _ = _train(lt, 5)
    assert pb.current_iteration() == jb.current_iteration() == 5
    assert pb.num_trees() == jb.num_trees() == 5
    np.testing.assert_allclose(pb.gbdt.train_score.numpy(),
                               ref.gbdt.train_score.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pb.gbdt.valid_scores[0],
                               ref.gbdt.valid_scores[0], rtol=0, atol=1e-6)
    assert [r[:2] for r in pb.eval_valid()] == [r[:2]
                                                for r in jb.eval_valid()]
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    assert_same_predictions(jb, pb)
    # training goes on from the rolled-back state
    pb.update()
    ref.update()
    assert pb.model_to_string() == ref.model_to_string()


# ---------------------------------------------------------------------- cv
def assert_same_cv_results(jr, pr):
    """Means within 1e-6 relative; a spread within 1e-6 of its mean (a
    spread near 0 has no relative precision of its own)."""
    assert jr.keys() == pr.keys()
    for k in jr:
        mean = np.abs(jr[k.replace("-stdv", "-mean")])
        np.testing.assert_array_less(np.abs(np.subtract(pr[k], jr[k])),
                                     1e-6 * mean, err_msg=k)


@pytest.mark.parametrize("stratified,shuffle", [(True, True),
                                                (False, True),
                                                (False, False)])
def test_cv_folds_match_jax(stratified, shuffle):
    from lightgbm_tpu.engine import _make_n_folds as jax_folds
    from lightgbm_tpu_torch.engine import _make_n_folds as port_folds
    jds, pds = lgb.Dataset(X, Y), lt.Dataset(X, Y)
    for a, b in zip(jax_folds(jds, 3, {}, 5, stratified, shuffle),
                    port_folds(pds, 3, 5, stratified, shuffle), strict=True):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_subset_shares_the_bins_of_its_dataset():
    """A subset (cv's folds) is its rows of the parent's bins and labels,
    from raw rows or from a binned dataset (convert.py)."""
    from lightgbm_tpu_torch import convert
    rows = np.array([5, 1, 7, 1999])
    raw = lt.Dataset(X, Y).construct()
    jds = lgb.Dataset(X, Y).construct()._handle
    binned = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], Y)
    for parent in (raw, binned):
        sub = parent.subset(rows).construct()
        assert sub.num_data() == 4 and sub.num_feature() == NF
        h, ph = sub._handle, parent._handle
        assert h.bin_mappers is ph.bin_mappers
        np.testing.assert_array_equal(h.bins_t, ph.bins_t[:, np.sort(rows)])
        np.testing.assert_array_equal(sub.get_label(), Y[np.sort(rows)])


def test_cv_matches_jax():
    """Stratified folds (binary), 3 folds x 5 rounds."""
    res = {}
    for pkg in (lgb, lt):
        params = dict(JAX_PARAMS if pkg is lgb else PORT_PARAMS)
        # continuous metrics: AUC jumps where two leaves' scores tie in
        # one package and differ by an ulp in the other
        res[pkg.__name__] = pkg.cv(params, pkg.Dataset(X_DENSE, Y_DENSE), 5,
                                   nfold=3, seed=5,
                                   metrics=["binary_logloss", "l2"],
                                   return_cvbooster=True)
    jr, pr = res["lightgbm_tpu"], res["lightgbm_tpu_torch"]
    jcv, pcv = jr.pop("cvbooster"), pr.pop("cvbooster")
    assert jr.keys() == pr.keys() == {
        f"valid {m}-{s}" for m in ("binary_logloss", "l2")
        for s in ("mean", "stdv")}
    assert_same_cv_results(jr, pr)
    for jb, pb in zip(jcv.boosters, pcv.boosters, strict=True):
        assert_same_trees(jb.gbdt.models, pb.gbdt.models, 5)


def test_cv_early_stopping_cuts_the_results():
    res = {}
    for pkg in (lgb, lt):
        params = dict(JAX_PARAMS if pkg is lgb else PORT_PARAMS,
                      learning_rate=1.0, metric=["binary_logloss"])
        res[pkg.__name__] = pkg.cv(params, pkg.Dataset(X_DENSE, Y_DENSE),
                                   15, nfold=2,
                                   early_stopping_rounds=2,
                                   return_cvbooster=True)
    jr, pr = res["lightgbm_tpu"], res["lightgbm_tpu_torch"]
    jb, pb = jr.pop("cvbooster"), pr.pop("cvbooster")
    assert 0 < pb.best_iteration == jb.best_iteration < 15
    for k in jr:
        assert len(pr[k]) == len(jr[k]) == pb.best_iteration
    assert_same_cv_results(jr, pr)


# ------------------------------------------------------------ C5, C6, C7
def test_add_valid_after_training_replays_the_trees():
    """C5: a valid set added after 5 updates is scored by those trees,
    as the JAX package's add_valid_data replays them."""
    out = {}
    for pkg in (lgb, lt):
        ds, va = _sets(pkg)
        params = dict(JAX_PARAMS if pkg is lgb else PORT_PARAMS)
        bst = pkg.Booster(params, ds)
        for _ in range(5):
            bst.update()
        bst.add_valid(va, "late")
        out[pkg.__name__] = bst
    jb, pb = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    raw = pb.predict(X[NTRAIN:], raw_score=True)
    np.testing.assert_allclose(pb.gbdt.valid_scores[0], raw, rtol=0,
                               atol=1e-12)
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
    y = Y[NTRAIN:]
    logloss = -np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))
    (_, name, value, _), _ = pb.eval_valid()
    assert name == "binary_logloss"
    assert value == pytest.approx(logloss, rel=1e-9)
    for (jn, jm, jv, _), (pn, pm, pv, _) in zip(jb.eval_valid(),
                                                pb.eval_valid()):
        assert (pn, pm) == (jn, jm)
        assert pv == pytest.approx(jv, rel=1e-5)


def test_best_iteration_is_set_as_jax_sets_it():
    """C6: -1 on a new Booster; after train without an early stop, the
    number of iterations."""
    for pkg in (lgb, lt):
        params = dict(JAX_PARAMS if pkg is lgb else PORT_PARAMS)
        assert pkg.Booster(params, _sets(pkg)[0]).best_iteration == -1
        bst = pkg.train(params, _sets(pkg)[0], 3)
        assert bst.best_iteration == 3 == len(bst.gbdt.models)


def test_early_stopping_round_parameter_is_accepted_as_in_jax():
    """C7: accepted in params under each alias; as in the JAX package,
    train stops early only on its early_stopping_rounds argument."""
    from lightgbm_tpu.config import Config as JaxConfig
    for alias in ("early_stopping_round", "early_stopping_rounds",
                  "early_stopping"):
        assert (lt.Config(device_type="cpu", **{alias: 2})
                .early_stopping_round == JaxConfig(**{alias: 2})
                .early_stopping_round == 2)
    params = {"early_stopping_round": 1, "learning_rate": 1.0}
    (jb, _), (pb, _) = (_train(pkg, 6, params) for pkg in (lgb, lt))
    assert pb.current_iteration() == jb.current_iteration() == 6
    assert pb.best_iteration == jb.best_iteration == 6
    assert "[early_stopping_round: 1]" in pb.model_to_string()


# ------------------------------------------------- C9-C12: the surface
def _frame(n=1000):
    """A DataFrame: five numeric columns a-e and a category column c of
    strings (category codes in the order of first appearance)."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(9)
    df = pd.DataFrame(rng.normal(size=(n, 5)), columns=list("abcde"))
    df = df.rename(columns={"c": "x"})
    words = np.array(["red", "green", "blue", "cyan", "gray", "pink"])
    df["c"] = pd.Categorical(words[rng.randint(0, 6, n)],
                             categories=["red", "green", "blue", "cyan",
                                         "gray", "pink"])
    y = (df["a"].to_numpy() + (df["c"].cat.codes.to_numpy() % 2)
         + 0.3 * rng.normal(size=n) > 0.5).astype(np.float64)
    return df, y


def test_dataframe_names_and_categories_match_jax():
    """C9: a DataFrame trains with its column names as feature names and
    its category column as codes (pinned by ``pandas_categorical``); the
    model text carries the ``pandas_categorical:`` trailer as JAX's does,
    and either package loads the other's text and predicts a frame whose
    category order differs as the trained booster does."""
    df, y = _frame()
    params = dict(min_data_per_group=5, cat_smooth=1.0)
    jb = lgb.train(dict(JAX_PARAMS, **params), lgb.Dataset(df, y), 3)
    pb = lt.train(dict(PORT_PARAMS, **params), lt.Dataset(df, y), 3)
    jt, pt = jb.model_to_string(), pb.model_to_string()
    line = [s for s in pt.splitlines() if s.startswith("feature_names=")]
    assert line == ["feature_names=a b x d e c"]
    assert line == [s for s in jt.splitlines()
                    if s.startswith("feature_names=")]
    assert pt.splitlines()[-1] == jt.splitlines()[-1] == (
        'pandas_categorical:[["red", "green", "blue", "cyan", "gray", '
        '"pink"]]')
    assert any(t.num_cat > 0 for t in pb.gbdt.models)
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    shuffled = df.copy()
    shuffled["c"] = shuffled["c"].cat.reorder_categories(
        ["pink", "gray", "cyan", "blue", "green", "red"])
    want = pb.predict(df, raw_score=True)
    np.testing.assert_array_equal(pb.predict(shuffled, raw_score=True), want)
    np.testing.assert_array_equal(
        lt.Booster(model_str=pt).predict(shuffled, raw_score=True), want)
    loaded = lt.Booster(model_str=jt)
    assert loaded.pandas_categorical == pb.pandas_categorical
    np.testing.assert_array_equal(loaded.predict(shuffled, raw_score=True),
                                  jb.predict(df, raw_score=True))
    assert lgb.Booster(model_str=pt).pandas_categorical == \
        pb.pandas_categorical


def test_sparse_predict_and_single_rows():
    """C9: a scipy CSR matrix predicts as its dense rows; a 1-D vector of
    the feature count is one row."""
    sparse = pytest.importorskip("scipy.sparse")
    bst, _ = _train(lt, 3)
    dense = np.nan_to_num(X[:200])
    np.testing.assert_array_equal(bst.predict(sparse.csr_matrix(dense)),
                                  bst.predict(dense))
    np.testing.assert_array_equal(bst.predict(dense[7]),
                                  bst.predict(dense[7:8]))


def test_update_with_a_new_train_set_matches_jax():
    """C10: update(train_set=...) swaps in rows binned by the training
    set's mappers (LGBM_BoosterResetTrainingData): the model's scores are
    replayed on them, and training goes on there, as in JAX."""
    out = {}
    for pkg in (lgb, lt):
        params = JAX_PARAMS if pkg is lgb else PORT_PARAMS
        ds = pkg.Dataset(X[:NTRAIN], Y[:NTRAIN])
        bst = pkg.Booster(params, ds)
        for _ in range(3):
            bst.update()
        swap = pkg.Dataset(X[NTRAIN:], Y[NTRAIN:], reference=ds)
        bst.update(train_set=swap)
        bst.update()
        out[pkg] = bst
    jb, pb = out[lgb], out[lt]
    assert pb.current_iteration() == jb.current_iteration() == 5
    assert pb.train_set.num_data() == N - NTRAIN
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    np.testing.assert_allclose(pb.gbdt.train_score.numpy(),
                               np.asarray(jb.gbdt.train_score), rtol=0,
                               atol=1e-3)
    assert [r[:2] for r in pb.eval_train()] == [r[:2]
                                                for r in jb.eval_train()]
    other = lt.Dataset(X[NTRAIN:] * 2.0, Y[NTRAIN:])
    with pytest.raises(lt.basic.LightGBMError, match="bin mappers"):
        pb.update(train_set=other)


def test_free_raw_data_and_pred_contrib_are_accepted():
    """C11: Dataset(free_raw_data=...) and predict(pred_contrib=...) as
    in JAX; the contributions sum to the raw score."""
    ds = lt.Dataset(X[:NTRAIN], Y[:NTRAIN], free_raw_data=False)
    assert ds.free_raw_data is False
    bst = lt.train(PORT_PARAMS, ds, 3)
    raw = bst.predict(X[:30], raw_score=True, pred_contrib=False)
    contrib = bst.predict(X[:30], pred_contrib=True)
    assert contrib.shape == (30, NF + 1)
    np.testing.assert_allclose(contrib.sum(axis=1), raw, rtol=0, atol=1e-9)


def test_reset_parameter_callback_matches_jax_capi():
    """C12: train(callbacks=[reset_parameter(learning_rate=[...])]) in the
    port = the JAX booster driven through capi.booster_reset_parameter
    before each update (the JAX package's own callback cannot call it)."""
    from lightgbm_tpu import capi
    rates = [0.5, 0.2, 0.05]
    pb = lt.train(PORT_PARAMS, lt.Dataset(X[:NTRAIN], Y[:NTRAIN]),
                  len(rates), callbacks=[lt.reset_parameter(
                      learning_rate=rates)])
    jb = lgb.Booster(JAX_PARAMS, lgb.Dataset(X[:NTRAIN], Y[:NTRAIN]))
    hid = capi._register(jb)
    try:
        for lr in rates:
            capi.booster_reset_parameter(hid, f"learning_rate={lr}")
            jb.update()
    finally:
        capi._handles.pop(hid)
    assert [t.shrinkage for t in pb.gbdt.models] == rates
    assert [t.shrinkage for t in jb.gbdt.models] == rates
    assert pb.config.learning_rate == rates[-1]
    assert_same_trees(jb.gbdt.models, pb.gbdt.models)
    assert_same_predictions(jb, pb)
