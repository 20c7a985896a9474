"""Learning to rank in the port against the JAX package on the CPU:
lambdarank's gradients, the ndcg and map metrics, and cv over query
groups.

  * lambdarank gradients and hessians within 1e-5 of the largest |value|
    of JAX's: all scores 0 (the ranks are the stable sort's tie order),
    queries in every padded length 8..128, lambdamart_norm on and off, a
    custom label_gain, with weights;
  * the chunk size (``PAIR_BUDGET``) does not change them;
  * ndcg and map at eval_at within 1e-9 of JAX's, with and without
    weights (queries weighted by their average member weight);
  * cv over a grouped dataset deals JAX's folds of whole queries and,
    for an objective JAX can cross-validate there, gives its results.
    The port's folds keep their query groups (JAX's lose them, so its cv
    cannot run lambdarank or ndcg: ROADMAP C8), and a lambdarank fold
    booster grows the model the fold grows alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import metric as jax_metric
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.metadata import Metadata as JaxMetadata
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import metric as port_metric
from lightgbm_tpu_torch.core.metadata import Metadata
from lightgbm_tpu_torch.objective import create_objective

CPU = torch.device("cpu")
# one query of each padded length 8, 16, 32, 64 and 128, then a mix
SIZES = [1, 2, 7, 8, 9, 16, 17, 31, 33, 64, 65, 100, 128] + [5, 40, 12] * 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metadata(sizes, seed=0, weights=False, max_label=4):
    """(JAX metadata, port metadata) of the same labels, groups and
    weights."""
    rng = np.random.RandomState(seed)
    n = int(np.sum(sizes))
    label = rng.randint(0, max_label + 1, size=n).astype(np.float64)
    w = np.exp(rng.uniform(-2.0, 2.0, size=n)) if weights else None
    out = []
    for cls in (JaxMetadata, Metadata):
        md = cls(n)
        md.init(n)
        md.set_label(label)
        md.set_weights(w)
        md.set_query(np.asarray(sizes))
        out.append(md)
    return out


def _lambdas(sizes, score_kind, params, weights=False, max_label=4):
    jmd, pmd = _metadata(sizes, weights=weights, max_label=max_label)
    n = jmd.num_data
    jobj = jax_objective(JaxConfig(objective="lambdarank", **params))
    jobj.init(jmd, n)
    pobj = create_objective(lt.Config(device_type="cpu",
                                      objective="lambdarank", **params))
    pobj.init(pmd, n, CPU)
    rng = np.random.RandomState(1)
    score = (np.zeros(n, np.float32) if score_kind == "zero" else
             np.round(rng.normal(size=n), 1).astype(np.float32))  # ties
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    pg, ph = pobj.get_gradients(torch.from_numpy(score))
    return (np.asarray(jg), np.asarray(jh)), (pg.numpy(), ph.numpy()), pobj


CASES = {
    "zero_scores": ("zero", {}, False, 4),
    "scores": ("normal", {}, False, 4),
    "no_norm": ("normal", {"lambdamart_norm": False}, False, 4),
    "label_gain": ("normal", {"label_gain": [0, 1, 3, 7, 20, 50, 90]},
                   False, 6),
    "max_position": ("normal", {"max_position": 5, "sigmoid": 1.5},
                     False, 4),
    "weights": ("normal", {}, True, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lambdarank_gradients_match_jax(case):
    kind, params, weights, max_label = CASES[case]
    (jg, jh), (pg, ph), pobj = _lambdas(SIZES, kind, params, weights,
                                        max_label)
    assert [b["P"] for b in pobj.buckets] == [8, 16, 32, 64, 128]
    assert np.abs(jg).max() > 0
    for got, want in ((pg, jg), (ph, jh)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lambdarank_first_iteration_ranks_by_the_tie_order():
    """All scores 0: a document's lambda depends on its position in its
    query (the stable sort's order), not only on its label."""
    (jg, _), (pg, _), _ = _lambdas([8] * 4, "zero", {})
    np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    md = _metadata([8] * 4)[1]
    lab = md.label[:8]
    same = [(i, j) for i in range(8) for j in range(i + 1, 8)
            if lab[i] == lab[j]]
    assert any(pg[i] != pg[j] for i, j in same)


def test_chunk_size_does_not_change_the_lambdas(monkeypatch):
    from lightgbm_tpu_torch.objective import rank
    _, (g0, h0), p0 = _lambdas(SIZES, "normal", {})
    monkeypatch.setattr(rank, "PAIR_BUDGET", 1 << 12)
    _, (g1, h1), p1 = _lambdas(SIZES, "normal", {})
    assert max(b["idx"].shape[0] // b["C"] for b in p1.buckets) > 1
    assert all(b["C"] == b["idx"].shape[0] for b in p0.buckets)
    np.testing.assert_array_equal(g1, g0)
    np.testing.assert_array_equal(h1, h0)


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_match_jax(name, weights):
    jmd, pmd = _metadata(SIZES, seed=3, weights=weights)
    params = dict(eval_at=[1, 3, 5, 10], label_gain=[0, 1, 3, 7, 15])
    jm = jax_metric.create_metric(name, JaxConfig(**params))
    pm = port_metric.create_metric(name, lt.Config(device_type="cpu",
                                                   **params))
    jm.init(jmd, jmd.num_data)
    pm.init(pmd, pmd.num_data)
    assert pm.higher_better and pm.eval_at == [1, 3, 5, 10]
    rng = np.random.RandomState(4)
    score = np.round(rng.normal(size=jmd.num_data), 1)      # ties
    want = jm.eval_multi(score)
    got = pm.eval_multi(score)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert pm.eval(score) == pytest.approx(jm.eval(score), rel=1e-9)


def test_train_reports_rank_metrics_at_each_position():
    jmd, _ = _metadata(SIZES, seed=5)
    X = np.random.RandomState(6).normal(size=(jmd.num_data, 5))
    ds = lt.Dataset(X, jmd.label, group=SIZES)
    evals = {}
    lt.train({"objective": "lambdarank", "device_type": "cpu",
              "verbosity": -1, "num_leaves": 7, "metric": ["ndcg", "map"],
              "eval_at": "1,3"}, ds, 2, valid_sets=[ds],
             evals_result=evals, verbose_eval=False)
    assert list(evals["training"]) == ["ndcg@1", "ndcg@3", "map@1", "map@3"]


# ---------------------------------------------------------------------- cv
def _grouped(seed=7):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 30, size=60)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 6))
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 1.5
                         + 0.5 * rng.normal(size=n)), 0, 4)
    return X, y, sizes


@pytest.mark.parametrize("shuffle", [True, False])
def test_cv_folds_of_groups_match_jax(shuffle):
    from lightgbm_tpu.engine import _make_n_folds as jax_folds
    from lightgbm_tpu_torch.engine import _make_n_folds as port_folds
    X, y, sizes = _grouped()
    jds = lgb.Dataset(X, y, group=sizes)
    pds = lt.Dataset(X, y, group=sizes)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for a, b in zip(jax_folds(jds, 4, {}, 3, True, shuffle),
                    port_folds(pds, 4, 3, True, shuffle), strict=True):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        # whole queries: every boundary a test row crosses is a query's
        cut = np.searchsorted(bounds, b[1], side="right")
        assert np.isin(np.unique(cut), np.arange(1, len(bounds))).all()


def test_cv_with_groups_matches_jax():
    """An objective both packages cross-validate over groups."""
    X, y, sizes = _grouped()
    res = {}
    for pkg in (lgb, lt):
        params = {"objective": "regression", "num_leaves": 7,
                  "verbosity": -1, "metric": ["l2", "l1"]}
        params.update({"device_type": "cpu"} if pkg is lt else
                      {"tpu_histogram_backend": "pallas",
                       "tpu_tree_impl": "segment"})
        res[pkg.__name__] = pkg.cv(params, pkg.Dataset(X, y, group=sizes),
                                   3, nfold=3, seed=2)
    jr, pr = res["lightgbm_tpu"], res["lightgbm_tpu_torch"]
    assert jr.keys() == pr.keys()
    for k in jr:
        np.testing.assert_allclose(pr[k], jr[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_lambdarank_cv_folds_keep_their_queries():
    X, y, sizes = _grouped()
    params = {"objective": "lambdarank", "num_leaves": 7, "verbosity": -1,
              "device_type": "cpu", "eval_at": [3]}
    ds = lt.Dataset(X, y, group=sizes)
    res = lt.cv(params, ds, 3, nfold=3, return_cvbooster=True)
    assert list(res)[:2] == ["valid ndcg@3-mean", "valid ndcg@3-stdv"]
    from lightgbm_tpu_torch.engine import _make_n_folds
    tr, te = next(_make_n_folds(ds, 3, 0, False, True))
    sub = ds.subset(tr)
    assert sub.get_group().sum() == len(tr)
    solo = lt.Booster(params, sub)
    solo.add_valid(ds.subset(te), "valid")
    for _ in range(3):
        solo.update()
    assert (solo.model_to_string()
            == res["cvbooster"].boosters[0].model_to_string())
