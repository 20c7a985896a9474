"""The port's objectives (lightgbm_tpu_torch.objective) against the JAX
package's on the CPU: all fifteen, with and without sample weights.

  * gradients and hessians on the same seeded scores within 1e-6 x
    max(1, |value|), and boost_from_score and convert_output as well;
  * leaf renewal (L1, quantile, MAPE) bit for bit in float64;
  * for each objective a 3-iteration, 15-leaf model on 3000 rows x 8
    features, with weights (and init scores for some), from identical
    bins and metadata (both packages' datasets through
    convert.dataset_from_arrays' hand-over): the same splits up to a
    near-tie (two gains within 1e-4, as tests/test_torch_cuda.py compares
    card and CPU), leaf values within 1e-5;
  * rows of weight 0 count toward min_data_in_leaf in both packages;
  * init scores seed the train and valid scores, and the model is then
    not boosted from its average, as in the JAX package.

JAX runs its Pallas kernels in interpret mode, the port the kernels'
plain PyTorch versions.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.objective import create_objective

N, NF, C = 3000, 8, 4
OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie", "binary",
              "multiclass", "multiclassova", "cross_entropy",
              "cross_entropy_lambda", "lambdarank"]
RENEWING = ["regression_l1", "quantile", "mape"]
OBJ_PARAMS = dict(alpha=0.7, fair_c=1.3, tweedie_variance_power=1.3,
                  poisson_max_delta_step=0.6)
TRAIN_PARAMS = dict(num_leaves=15, max_bin=63, tpu_row_chunk=256,
                    learning_rate=0.3, verbosity=-1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, NF))
    return X, X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] ** 2


def _labels(objective, f, seed=1):
    """Labels the objective accepts, made from the features ``f``."""
    rng = np.random.RandomState(seed)
    n = len(f)
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.4 * f)).astype(np.float64)
    if objective == "gamma":
        return rng.gamma(2.0, np.exp(0.3 * f) / 2.0) + 1e-3
    if objective == "binary":
        return (f + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    if objective in ("multiclass", "multiclassova"):
        return np.digitize(f + 0.3 * rng.normal(size=n),
                           [-1.0, 0.0, 0.8]).astype(np.float64)
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-2.0 * f + 0.3 * rng.normal(size=n)))
    if objective == "lambdarank":
        return np.clip(np.round(f + 1.5 + 0.5 * rng.normal(size=n)), 0, 4)
    return 3.0 * f + rng.normal(size=n)


def _groups(n, seed=2):
    """Query sizes 1..40 covering ``n`` rows (buckets of 8, 16, 32, 64)."""
    rng = np.random.RandomState(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(1, 41)))
    sizes[-1] -= sum(sizes) - n
    return np.asarray([s for s in sizes if s > 0])


def _weights(kind, n, seed=3):
    rng = np.random.RandomState(seed)
    if kind is None:
        return None
    w = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), n))
    if kind == "heavy0":
        w[::13] = 0.0
    return w


def _extra(objective):
    return {"num_class": C} if objective.startswith("multiclass") else {}


def _num_class(objective):
    return C if objective.startswith("multiclass") else 1


# ------------------------------------------------------------- gradients
def _pair(objective, weights, n=N):
    """(JAX objective, port objective, scores) over the same metadata."""
    _, f = _features(n=n)
    label = _labels(objective, f)
    group = _groups(n) if objective == "lambdarank" else None
    jmd = TpuDataset()  # only its metadata is used
    jmd.metadata.init(n)
    jmd.metadata.set_label(label)
    jmd.metadata.set_weights(weights)
    jmd.metadata.set_query(group)
    jobj = jax_objective(JaxConfig(objective=objective, **_extra(objective),
                                   **OBJ_PARAMS))
    jobj.init(jmd.metadata, n)
    pobj = create_objective(lt.Config(device_type="cpu", objective=objective,
                                      **_extra(objective), **OBJ_PARAMS))
    pobj.init(jmd.metadata, n, CPU)
    rng = np.random.RandomState(4)
    k = _num_class(objective)
    score = rng.normal(size=(k, n) if k > 1 else n).astype(np.float32)
    return jobj, pobj, score


def _close(got, want, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.maximum(1.0, np.abs(want) if scale is None else scale)
    bad = ~(np.abs(got - want) <= 1e-6 * scale)
    bad &= ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), (what, got[bad][:5], want[bad][:5])


def _xentlambda64(score, label, w):
    """cross_entropy_lambda's weighted gradients and hessians (the JAX
    package's formula, xentropy.py:61-74) in float64."""
    epf = np.exp(score.astype(np.float64))
    z = 1.0 - np.exp(-w * np.log1p(epf))
    grad = (1.0 - label / z) * w / (1.0 + 1.0 / epf)
    c = 1.0 / (1.0 - z)
    d = 1.0 + epf
    a = w * epf / (d * d)
    d = c - 1.0
    return grad, a * (1.0 + label * (c / (d * d)) * (1.0 + w * epf - c))


@pytest.mark.parametrize("weights", [None, "heavy0"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_match_jax(objective, weights):
    """Within 1e-6 of each value's scale: max(1, |value|), and for the
    gradient also |hessian|, which is the size of the terms an exp-link
    gradient cancels (poisson's exp(s) - y, gamma's 1 - y exp(-s)); a
    float32 exp differs by an ulp between XLA and torch.  Lambdarank's
    sums of pair terms within 1e-5 of the largest |lambda| (and
    |hessian|).  cross_entropy_lambda with weights computes 1 - exp(-w h)
    in float32, which at w ~ 1e-3 keeps 2-4 digits in either package:
    there each value's relative distance from the formula in float64 is
    at most the largest of JAX's values' (+ 1e-6), so the port is no less
    accurate than the reference."""
    jobj, pobj, score = _pair(objective, _weights(weights, N))
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    jg, jh = np.asarray(jg, np.float64), np.asarray(jh, np.float64)
    pg, ph = pobj.get_gradients(torch.from_numpy(score))
    pg, ph = pg.numpy(), ph.numpy()
    if objective == "lambdarank":
        for got, want in ((pg, jg), (ph, jh)):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    elif objective == "cross_entropy_lambda" and weights is not None:
        w = pobj.weights_np.astype(np.float64)
        for got, want, exact in zip((pg, ph), (jg, jh), _xentlambda64(
                score, pobj.label_np.astype(np.float64), w)):
            live = np.isfinite(want) & np.isfinite(exact)
            rel = np.abs(want - exact)[live] / np.abs(exact)[live]
            assert rel.max() < 1e-2
            assert (np.abs(got - exact)[live] <= (rel.max() + 1e-6)
                    * np.abs(exact)[live]).all()
            # 0 / 0 at weight 0 and inf / inf at large weights, in both
            assert np.array_equal(np.isnan(got), np.isnan(want))
    else:
        _close(pg, jg, f"{objective} grad", np.maximum(np.abs(jg),
                                                       np.abs(jh)))
        _close(ph, jh, f"{objective} hess")
    for k in range(_num_class(objective)):
        _close(pobj.boost_from_score(k), jobj.boost_from_score(k),
               f"{objective} boost_from_score({k})")
    raw = score.astype(np.float64)
    _close(pobj.convert_output(raw), jobj.convert_output(raw),
           f"{objective} convert_output")
    assert pobj.is_renew_tree_output == jobj.is_renew_tree_output
    assert pobj.need_group == jobj.need_group


@pytest.mark.parametrize("weights", [None, "heavy0"])
@pytest.mark.parametrize("objective", RENEWING)
def test_renew_tree_output_is_jax_bit_for_bit(objective, weights):
    jobj, pobj, score = _pair(objective, _weights(weights, N))
    rng = np.random.RandomState(5)
    leaves = 15
    leaf_ids = rng.randint(0, leaves - 1, size=N).astype(np.int32)  # 14 empty
    # ties among the residuals, as leaves of one tree make them
    score = np.round(score, 1).astype(np.float32)
    leaf_values = rng.normal(size=leaves)
    want = jobj.renew_tree_output(leaf_values, leaf_ids,
                                  score.astype(np.float64))
    got = pobj.renew_tree_output(leaf_values, torch.from_numpy(leaf_ids),
                                 torch.from_numpy(score))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[leaves - 1] == leaf_values[leaves - 1]


# --------------------------------------------------------------- training
def _train_pair(objective, init_score=False, iters=3, **params):
    """(X, JAX GBDT, port Booster): ``iters`` iterations from identical bins
    and metadata: weights log-uniform over 0.1..10, groups for lambdarank,
    init scores if asked."""
    X, f = _features(seed=7)
    label = _labels(objective, f, seed=8)
    rng = np.random.RandomState(9)
    w = np.exp(rng.uniform(np.log(0.1), np.log(10.0), N))
    group = _groups(N) if objective == "lambdarank" else None
    init = (0.3 * rng.normal(size=_num_class(objective) * N)
            if init_score else None)
    params = dict(TRAIN_PARAMS, objective=objective, **_extra(objective),
                  **OBJ_PARAMS, **params)
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl="segment",
                    **params)
    jds = TpuDataset.from_numpy(X, label, config=cfg, weights=w,
                                group=group, init_score=init)
    assert jds.bundle is None
    jobj = jax_objective(cfg)
    jobj.init(jds.metadata, N)
    jgb = JaxGBDT(cfg, jds, jobj)
    for _ in range(iters):
        jgb.train_one_iter()
    jgb._flush_pending()
    pds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], label,
        weights=w, group=group, init_score=init)
    bst = lt.Booster(dict(params, device_type="cpu"), pds)
    for _ in range(iters):
        bst.update()
    return X, jgb, bst


def assert_same_models(jtrees, ptrees, min_compared):
    """The same split feature and bin at gain > 1e-2, up to a near-tie
    (gains within 1e-4: the rest of the model is not compared, its scores
    differ from there on); a tree grown alike has leaf values within
    1e-5 + 1e-4 relative.  The relative part is the JAX package's: its
    histogram sums the bf16 hi + lo channels in float32 (the port's plain
    version in float64), and a leaf whose gradients cancel to ~1/100 of
    their absolute sum shows that float32 sum's error at ~4e-5 of its
    value (fair, tree 1 here)."""
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


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_training_grows_jax_trees(objective):
    init = objective in ("regression", "regression_l1", "poisson", "binary",
                         "multiclassova", "lambdarank")
    X, jgb, bst = _train_pair(objective, init_score=init)
    k = _num_class(objective)
    assert bst.gbdt.init_scores == pytest.approx(jgb.init_scores, rel=1e-6)
    compared = assert_same_models(jgb.models, bst.gbdt.models, 14)
    if compared == sum(t.num_leaves - 1 for t in jgb.models):
        # one model: the same scores (init scores included) within
        # tests/test_torch_train.py's 1e-3
        jraw = jgb._raw_predict(X)
        praw = bst.predict(X, raw_score=True)
        np.testing.assert_allclose(praw, jraw[0] if k == 1 else jraw.T,
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(bst.gbdt.train_score.numpy(),
                                   np.asarray(jgb.train_score),
                                   rtol=0, atol=1e-3)


def test_weight_zero_rows_count_toward_min_data_in_leaf():
    """Rows of weight 0 carry no gradient but count as rows: a leaf may
    hold fewer than min_data_in_leaf rows of nonzero weight, never fewer
    rows; both packages count alike."""
    X, f = _features(seed=11)
    label = _labels("regression", f, seed=12)
    w = np.where(X[:, 0] > 0.5, 0.0, 1.0)     # a third of the rows
    params = dict(TRAIN_PARAMS, objective="regression",
                  min_data_in_leaf=100)
    jbst = lgb.train(dict(params, tpu_histogram_backend="pallas",
                          tpu_tree_impl="segment"),
                     lgb.Dataset(X, label, weight=w), 1)
    pbst = lt.train(dict(params, device_type="cpu"),
                    lt.Dataset(X, label, weight=w), 1)
    jt, pt = jbst.gbdt.models[0], pbst.gbdt.models[0]
    np.testing.assert_array_equal(pt.leaf_count, jt.leaf_count)
    assert pt.leaf_count.min() >= 100
    leaves = pbst.predict(X, pred_leaf=True)[:, 0]
    weighted = np.bincount(leaves, weights=(w > 0), minlength=pt.num_leaves)
    assert weighted.min() < 100
    np.testing.assert_array_equal(np.bincount(leaves), pt.leaf_count)
