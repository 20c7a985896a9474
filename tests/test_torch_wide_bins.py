"""The port's second histogram path against the JAX package's, on the CPU.

  * B3's plain version (``histogram_chunked_plain``) against JAX's XLA
    ``histogram_chunked`` on the same numpy bins and channels, one- and
    two-byte bins at 64, 1,024 and 65,536 bins: counts exact, sums within
    1e-6 of the bin's sum of |value| (JAX sums f32 in XLA's order, the
    port in 64-bit fixed point);
  * datasets of two-byte bins (max_bin 511), of ``max_bin_by_feature`` and
    of a categorical column of more than 256 bins: bin mappers and bins
    byte for byte ``TpuDataset``'s;
  * the fused grower on the onehot path (max_bin 511, gpu_use_dp,
    tpu_double_precision, tpu_histogram_backend="onehot", an EFB group
    beside two-byte columns): JAX's model
    text (tests/split_parity.py), JAX on its own CPU default, the onehot
    path; packed_acc there changes nothing; on a categorical column of
    more than 256 bins, where the JAX package raises writing the tree,
    the port trains;
  * segment or frontier asked for on that path: the JAX package's
    warning, and the fused grower;
  * a categorical split's bitset keeps JAX's 8 words: no bin of 256 or
    more joins the left set, and prediction sends such a bin right;
  * a wide model's predictions = JAX's Booster.predict bit for bit, and
    the stacked-tree route (P1's plain version, u16 mode) = the host walk.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lt
import split_parity as sp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.boosting_factory import \
    create_boosting as jax_boosting
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops.histogram import histogram_chunked as jax_hist
from lightgbm_tpu_torch.models.tree import bitset_contains
from lightgbm_tpu_torch.ops import histogram as th


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


@pytest.mark.parametrize("B,wide,G,n", [(64, False, 6, 3000),
                                        (1024, True, 5, 3000),
                                        (65536, True, 2, 1024)])
def test_histogram_chunked_plain_matches_jax(B, wide, G, n):
    rng = np.random.RandomState(B)
    bins = rng.randint(0, B, size=(n, G)).astype(
        np.uint16 if wide else np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0, 0.25, size=n).astype(np.float32)
    member = (rng.uniform(size=n) < 0.8).astype(np.float32)
    w3 = th.chunked_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                             torch.from_numpy(member))
    host = bins.T.copy()
    binsT = torch.from_numpy(host.view(np.int16) if wide else host)
    got = th.histogram_chunked(binsT, w3, B).numpy()
    want = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(w3.numpy()),
                               B))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    abs_sums = th.histogram_chunked(binsT, w3.abs(), B).numpy()
    for c in range(2):
        assert np.all(np.abs(got[..., c] - want[..., c])
                      <= 1e-6 * abs_sums[..., c] + 1e-30)
    assert int(want[..., 2].sum()) == int(member.sum()) * G


def _wide_cat_data(seed=3, n=8000):
    """Numerical columns and a 700-category column whose frequent
    categories pass 256 (Zipf-like), the label from both."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 4))
    cat = np.minimum((rng.pareto(0.7, size=n) * 3).astype(np.int64), 699)
    X = np.concatenate([X, cat[:, None].astype(np.float64)], axis=1)
    z = X[:, 0] - 0.6 * X[:, 1] + 0.8 * (cat % 7 == 3) - 0.3 * X[:, 2] ** 2
    y = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


DATASETS = {
    "max_bin_511": (dict(max_bin=511), ()),
    "by_feature": (dict(max_bin_by_feature=[600, 7, 300, 2, 1023, 40]), ()),
    "wide_cat": (dict(max_bin=255, min_data_in_bin=1), (4,)),
}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_wide_datasets_bin_as_in_jax(case):
    extra, cats = DATASETS[case]
    X, y = _wide_cat_data() if case == "wide_cat" else sp.data(seed=2)
    params = dict(sp.BASE, **extra)
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(**params),
                                categorical_features=list(cats))
    pds = lt.Dataset(X, y, params=params,
                     categorical_feature=list(cats)).construct()._handle
    # as JSON: a NaN bound equals a NaN bound there
    assert json.dumps([m.to_dict() for m in pds.bin_mappers]) == json.dumps(
        [m.to_dict() for m in jds.bin_mappers])
    assert pds.bins_t.dtype == jds.binned.dtype == np.uint16
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    assert pds.max_num_bin > 256


def _jax_onehot(params, X, y, iters=sp.ITERS, categorical=()):
    """JAX trained on its CPU default, the onehot path and fused grower."""
    cfg = JaxConfig(**params)
    jds = TpuDataset.from_numpy(X, y, config=cfg,
                                categorical_features=list(categorical))
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = jax_boosting(cfg, jds, obj)
    for _ in range(iters):
        jgb.train_one_iter()
    jgb._flush_pending()
    assert jgb._resolve_hist_backend(False) == "onehot"
    return jds, jgb


MODELS = {
    "max_bin_511": (dict(max_bin=511), ()),
    "gpu_use_dp": (dict(gpu_use_dp=True), ()),
    "tpu_double_precision": (dict(tpu_double_precision=True), ()),
    "onehot": (dict(tpu_histogram_backend="onehot"), ()),
    # a 10-way one-hot block (an EFB group) beside two-byte columns
    "efb_wide": (dict(max_bin=511), ()),
}
WIDE_CAT = dict(sp.BASE, max_bin=255, min_data_in_bin=1,
                min_data_per_group=20, cat_smooth=1.0)


@pytest.fixture(scope="module")
def trained():
    """Each MODELS case: (X, JAX booster, the port's booster)."""
    out = {}
    for case, (extra, cats) in MODELS.items():
        X, y = sp.one_hot_data() if case == "efb_wide" else sp.data(seed=4)
        params = dict(sp.BASE, **extra)
        jds, jgb = _jax_onehot(params, X, y, categorical=cats)
        out[case] = (X, jgb, sp.port_trained(params, jds, y))
    return out


@pytest.fixture(scope="module")
def wide_cat():
    """(X, the port's booster) on the 700-category column, whose split
    the JAX package cannot write into a tree."""
    X, y = _wide_cat_data()
    bst = lt.train(WIDE_CAT, lt.Dataset(X, y, params=WIDE_CAT,
                                        categorical_feature=[4]), sp.ITERS)
    return X, bst


@pytest.mark.parametrize("case", sorted(MODELS))
def test_onehot_models_match_jax(trained, case):
    X, jgb, bst = trained[case]
    assert bst.gbdt.hist_backend == "onehot"
    assert bst.gbdt.tree_impl == "fused" and not bst.gbdt.packed4
    if case == "efb_wide":
        ds = bst.gbdt.train_set
        assert ds.bundle is not None and ds.wide
    sp.assert_same_model(jgb, bst, min_splits=10 if case == "efb_wide"
                         else 20)


def test_wide_predictions_match_jax(trained):
    """JAX's wide model in the port (its trees on the port's booster of the
    same bins): raw scores = JAX's Booster.predict (the host walk on raw
    rows) bit for bit, by the host walk and by the stacked-tree route over
    predict-time bins in u16 (P1's plain version)."""
    from lightgbm_tpu_torch import convert
    X, jgb, bst = trained["max_bin_511"]
    bst.gbdt.models = convert.trees_from_arrays(
        [dict(vars(t), num_leaves=t.num_leaves) for t in jgb.models])
    bst.gbdt.init_scores = list(jgb.init_scores)
    want = jgb.predict(X, raw_score=True)
    got = bst.predict(X, raw_score=True)
    assert np.array_equal(got, want)
    on = bst.predict(X, raw_score=True, predict_device="on")
    assert bst.gbdt.last_predict_route == "device"
    assert np.array_equal(on, want)


def test_wide_categorical_trains_where_jax_raises(wide_cat):
    """A categorical column of more than 256 bins: the JAX package's
    onehot grower splits on it, then raises writing the split into its
    tree (lightgbm_tpu/models/tree.py:127-128 reads the 8-word bitset at
    every bin; ROADMAP C); the port trains, a categorical split on it
    leads its trees, and the stacked-tree route (u16, unseen categories
    as 0xFFFF) = the host walk."""
    X, y = _wide_cat_data()
    with pytest.raises(IndexError):
        _jax_onehot(WIDE_CAT, X, y, categorical=(4,))
    _, bst = wide_cat
    assert bst.gbdt.hist_backend == "onehot"
    assert any(t.num_cat > 0 for t in bst.gbdt.models)
    Xq = X.copy()
    Xq[:30, 4] = 5000.0         # unseen categories
    off = bst.predict(Xq, raw_score=True)
    on = bst.predict(Xq, raw_score=True, predict_device="on")
    assert bst.gbdt.last_predict_route == "device"
    assert np.array_equal(on, off)


def test_packed_acc_is_ignored_on_the_onehot_path():
    X, y = sp.data(seed=4)
    params = dict(sp.BASE, max_bin=511)
    ds = lt.Dataset(X, y, params=params)
    texts = []
    for kw in ({}, {"packed_acc": True}):
        bst = lt.Booster(params, ds, **kw)
        for _ in range(2):
            bst.update()
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("impl", ["segment", "frontier"])
def test_segment_or_frontier_request_warns_and_takes_fused(impl, capsys):
    X, y = sp.data(seed=4)
    params = dict(sp.BASE, max_bin=511, tpu_tree_impl=impl, verbosity=1)
    bst = lt.Booster(params, lt.Dataset(X, y, params=params))
    assert bst.gbdt.tree_impl == "fused"
    assert (f"tpu_tree_impl={impl} requires the pallas histogram backend"
            in capsys.readouterr().out)


def test_pallas_request_on_wide_bins_warns(capsys):
    X, y = sp.data(seed=4)
    params = dict(sp.BASE, max_bin=511, tpu_histogram_backend="pallas",
                  verbosity=1)
    bst = lt.Booster(params, lt.Dataset(X, y, params=params))
    assert bst.gbdt.hist_backend == "onehot"
    assert "tpu_histogram_backend=pallas unsupported" in (
        capsys.readouterr().out)


def test_categorical_bitset_keeps_eight_words(wide_cat):
    """A categorical split's left set holds only bins below 256 (the
    bitset's 8 words, JAX's: ROADMAP C), and a row whose category sits in
    a bin of 256 or more goes right at such a node."""
    X, bst = wide_cat
    ds = bst.gbdt.train_set
    m = ds.bin_mappers[4]
    assert m.num_bin > 256
    nodes = 0
    for t in bst.gbdt.models:
        for words in t.cat_threshold_inner:
            assert len(words) <= 8
            nodes += 1
    assert nodes > 0
    # a bin past 255 is in no node's left set: such a row goes right
    far = np.asarray([b for b in m.categorical_2_bin.values() if b >= 256])
    assert len(far)
    for t in bst.gbdt.models:
        for words in t.cat_threshold_inner:
            assert not bitset_contains(np.asarray(words), far).any()
