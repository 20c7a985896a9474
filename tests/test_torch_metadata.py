"""The port's dataset metadata (weights, query groups, init scores)
against the JAX package's on the CPU.

  * Dataset fields round trip: set and get before and after
    ``construct``, through set_field/get_field and the named getters;
    ``subset`` keeps the rows' weights and init scores; ``create_valid``
    passes its keyword arguments on;
  * query boundaries from group sizes and from query ids, and query
    weights (the average member weight), as the JAX Metadata has them;
  * init scores seed the training and valid scores, and a model with a
    train set's init scores is not boosted from its average.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.core.metadata import Metadata as JaxMetadata
from lightgbm_tpu_torch.core.metadata import Metadata

N, NF = 600, 5
SIZES = [10, 40, 50, 100, 200, 200]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    y = X[:, 0] + 0.3 * rng.normal(size=N)
    w = rng.uniform(0.1, 3.0, size=N)
    init = 0.2 * rng.normal(size=N)
    return X, y, w, init


FIELDS = ("label", "weight", "group", "init_score")


def _fields(ds):
    return {f: ds.get_field(f) for f in FIELDS}


def _assert_same_fields(a, b):
    for f in FIELDS:
        if a[f] is None or b[f] is None:
            assert a[f] is None and b[f] is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a[f]),
                                          np.asarray(b[f]), f)
            assert np.asarray(a[f]).dtype == np.asarray(b[f]).dtype, f


@pytest.mark.parametrize("when", ["before", "after"])
def test_fields_round_trip_as_jax(when):
    X, y, w, init = _data()
    out = {}
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, y)
        if when == "after":
            ds.construct()
        ds.set_weight(w).set_group(SIZES).set_init_score(init)
        ds.set_field("label", 2 * y)
        got = _fields(ds)
        assert ds.get_weight() is got["weight"] or np.array_equal(
            ds.get_weight(), got["weight"])
        np.testing.assert_array_equal(ds.get_group(), SIZES)
        np.testing.assert_array_equal(ds.get_init_score(), init)
        np.testing.assert_array_equal(ds.get_label(), (2 * y).astype(
            np.float32))
        out[pkg.__name__] = got
        ds.set_weight(None)
        assert ds.get_weight() is None
        with pytest.raises(Exception):
            ds.set_field("no_such_field", y)
    _assert_same_fields(out["lightgbm_tpu"], out["lightgbm_tpu_torch"])


def test_constructor_fields_and_create_valid():
    X, y, w, init = _data()
    ds = lt.Dataset(X, y, weight=w, group=SIZES, init_score=init)
    jds = lgb.Dataset(X, y, weight=w, group=SIZES, init_score=init)
    _assert_same_fields(_fields(jds), _fields(ds))
    va = ds.create_valid(X[:100], y[:100], weight=w[:100], group=[40, 60],
                         init_score=init[:100])
    jva = jds.create_valid(X[:100], y[:100], weight=w[:100], group=[40, 60],
                           init_score=init[:100])
    _assert_same_fields(_fields(jva), _fields(va))
    assert va._handle.bin_mappers is ds._handle.bin_mappers


def test_subset_keeps_weights_init_scores_and_whole_queries():
    X, y, w, init = _data()
    ds = lt.Dataset(X, y, weight=w, group=SIZES, init_score=init)
    jds = lgb.Dataset(X, y, weight=w, group=SIZES, init_score=init)
    rows = np.arange(50, 200)              # queries 2 and 3, whole
    sub, jsub = ds.subset(rows), jds.subset(rows)
    for f in ("label", "weight"):
        np.testing.assert_array_equal(sub.get_field(f), jsub.get_field(f))
    np.testing.assert_array_equal(sub.get_weight(), w[rows].astype(
        np.float32))
    # the port keeps the rows' init scores and whole queries, as the JAX
    # Metadata.subset means to; the JAX Dataset.subset drops both (it
    # rebuilds the rows from the raw data without them: ROADMAP C8)
    assert jsub.get_init_score() is None and jsub.get_group() is None
    np.testing.assert_array_equal(sub.get_init_score(), init[rows])
    np.testing.assert_array_equal(sub.get_group(), [50, 100])
    assert ds.subset(np.arange(55, 200)).get_group() is None


def test_query_boundaries_and_weights_match_jax():
    rng = np.random.RandomState(3)
    w = rng.uniform(0.1, 3.0, size=N).astype(np.float32)
    qids = np.repeat(np.arange(len(SIZES)) * 7, SIZES)
    for setter in ("set_query", "set_query_from_ids"):
        mds = []
        for cls in (JaxMetadata, Metadata):
            md = cls(N)
            md.init(N)
            md.set_weights(w)
            getattr(md, setter)(np.asarray(SIZES) if setter == "set_query"
                                else qids)
            mds.append(md)
        jmd, pmd = mds
        np.testing.assert_array_equal(pmd.query_boundaries,
                                      jmd.query_boundaries)
        np.testing.assert_array_equal(pmd.query_weights, jmd.query_weights)
        assert pmd.num_queries == jmd.num_queries == len(SIZES)
    with pytest.raises(lt.LightGBMError):
        Metadata(N).set_query([N + 1])


# ------------------------------------------------------------ init scores
PARAMS = dict(objective="binary", num_leaves=7, max_bin=63, verbosity=-1,
              learning_rate=0.3, tpu_row_chunk=256)


@pytest.fixture(scope="module")
def seeded():
    """JAX and port boosters with init scores on the train and valid
    sets, before and after 2 iterations."""
    X, y, w, init = _data(5)
    y = (y > 0).astype(np.float64)
    out = {}
    for pkg in (lgb, lt):
        params = dict(PARAMS, **({"device_type": "cpu"} if pkg is lt else
                                 {"tpu_histogram_backend": "pallas",
                                  "tpu_tree_impl": "segment"}))
        ds = pkg.Dataset(X[:400], y[:400], init_score=init[:400])
        va = ds.create_valid(X[400:], y[400:], init_score=init[400:])
        bst = pkg.Booster(params, ds)
        bst.add_valid(va, "valid")
        start = (np.asarray(bst.gbdt.train_score).copy(),
                 np.asarray(bst.gbdt.valid_scores[0]).copy())
        for _ in range(2):
            bst.update()
        out[pkg.__name__] = (bst, start, init)
    return out


def test_init_scores_seed_the_scores_as_jax(seeded):
    jbst, (jtrain, jvalid), init = seeded["lightgbm_tpu"]
    pbst, (ptrain, pvalid), _ = seeded["lightgbm_tpu_torch"]
    np.testing.assert_array_equal(ptrain, jtrain)
    np.testing.assert_array_equal(ptrain[0], init[:400].astype(np.float32))
    np.testing.assert_array_equal(np.ravel(pvalid), np.ravel(jvalid))
    np.testing.assert_array_equal(np.ravel(pvalid), init[400:])


def test_init_scores_skip_the_boost_from_average_as_jax(seeded):
    jbst, _, init = seeded["lightgbm_tpu"]
    pbst, _, _ = seeded["lightgbm_tpu_torch"]
    assert pbst.gbdt.init_scores == jbst.gbdt.init_scores == [0.0]
    np.testing.assert_allclose(pbst.gbdt.train_score.numpy(),
                               np.asarray(jbst.gbdt.train_score),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.ravel(pbst.gbdt.valid_scores[0]),
                               np.ravel(jbst.gbdt.valid_scores[0]),
                               rtol=0, atol=1e-5)
    # the valid scores are the init scores plus the trees
    X = _data(5)[0]
    np.testing.assert_allclose(
        np.ravel(pbst.gbdt.valid_scores[0]),
        init[400:] + pbst.predict(X[400:], raw_score=True), rtol=0,
        atol=1e-12)


# ---------------------------------------------------------------- binning
def _column(kind, n, rng):
    return {0: lambda: rng.normal(size=n),
            1: lambda: rng.randint(0, 300, n).astype(float),
            2: lambda: np.round(rng.exponential(size=n), 2),
            3: lambda: np.where(rng.uniform(size=n) < 0.6, 0.0,
                                rng.normal(size=n)),
            4: lambda: np.where(rng.uniform(size=n) < 0.2, np.nan,
                                np.round(rng.normal(size=n), 1)),
            5: lambda: rng.zipf(1.5, n) * rng.choice([-1.0, 1.0], n),
            6: lambda: np.concatenate([np.full(n // 2, 1.5),
                                       rng.normal(size=n - n // 2)]),
            7: lambda: rng.choice([-2.0, 0.0, 3.0, 7.0], n,
                                  p=[0.1, 0.6, 0.2, 0.1])}[kind]()


@pytest.mark.parametrize("kind", range(8))
def test_bin_bounds_match_jax(kind):
    """The port's greedy bin search (its cuts found by searchsorted on
    the counts' prefix sums) gives the JAX package's bins over
    distributions with many distinct values, heavy duplicates, zeros and
    NaN, at several max_bin and min_data_in_bin."""
    from lightgbm_tpu.core.binning import BinMapper as JaxBinMapper
    from lightgbm_tpu_torch.core.binning import BinMapper
    rng = np.random.RandomState(kind)
    for n in (300, 20_000):
        x = _column(kind, n, rng)
        for max_bin, min_data in ((3, 3), (16, 0), (63, 3), (255, 10)):
            for zero_as_missing in (False, True):
                kw = dict(total_sample_cnt=n, max_bin=max_bin,
                          min_data_in_bin=min_data, min_split_data=20,
                          bin_type=0, use_missing=True,
                          zero_as_missing=zero_as_missing)
                a = JaxBinMapper().find_bin(x.copy(), **kw)
                b = BinMapper().find_bin(x.copy(), **kw)
                np.testing.assert_array_equal(b.bin_upper_bound,
                                              a.bin_upper_bound)
                assert (b.num_bin, b.missing_type, b.default_bin,
                        b.is_trivial) == (a.num_bin, a.missing_type,
                                          a.default_bin, a.is_trivial)


def test_binning_in_threads_is_binning_in_one(monkeypatch):
    """Past PARALLEL_ROWS rows the features are binned one a thread: the
    same mappers and bins as one thread."""
    from lightgbm_tpu_torch.core import dataset as dataset_mod
    from lightgbm_tpu_torch.core.dataset import TorchDataset
    rng = np.random.RandomState(9)
    n = dataset_mod.PARALLEL_ROWS + 5000
    X = np.stack([_column(k, n, rng) for k in (0, 3, 4, 7)], axis=1)
    cfg = lt.Config(device_type="cpu", max_bin=63)
    out = []
    for workers in (1, 4):
        monkeypatch.setattr(dataset_mod, "_walk_workers", lambda: workers)
        out.append(TorchDataset.from_numpy(X, config=cfg))
    one, threads = out
    np.testing.assert_array_equal(threads.bins_t, one.bins_t)
    for a, b in zip(one.bin_mappers, threads.bin_mappers):
        assert repr(a.to_dict()) == repr(b.to_dict())   # NaN bounds too
