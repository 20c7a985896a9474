"""Parity of the PyTorch port (lightgbm_tpu_torch) with the JAX package on
the CPU for multiclass softmax with categorical features.

Kernel K5 (``histogram_all``), categorical binning, the categorical split
search, the softmax objective and its metrics, and the slice as a whole
(the segment grower, C trees per iteration from one batched K5 pass of
the class roots) go through both packages on the same numpy-seeded
inputs.  JAX runs its Pallas kernels in interpret mode, the port the
kernels' plain PyTorch versions.  Tolerances:

  * counts, bins, bitsets, split features and thresholds exact;
  * histogram sums within 1e-5 x the bin's sum of |value| (the TPU kernel
    sums bf16 channels in float32 through its matmul, the port in
    float64);
  * split gains within 1e-5 relative, objective values within 1e-6,
    metrics within 1e-9 (float32 against float32 arithmetic);
  * trees: splits with gain > 1e-2 agree (below that, float32 summation
    order may break ties differently), raw predictions within 1e-3.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.binning import BIN_TYPE_CATEGORICAL
from lightgbm_tpu.core.binning import BinMapper as JaxBinMapper
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.metric import create_metric as jax_metric
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.core.binning import BinMapper
from lightgbm_tpu_torch.core.dataset import TorchDataset
from lightgbm_tpu_torch.metric import create_metric
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split as ts

N, NF, C, ITERS = 2000, 6, 3, 3
CAT_COLS = [4, 5]
PARAMS = dict(objective="multiclass", num_class=C, num_leaves=15,
              max_bin=63, tpu_row_chunk=256, verbosity=-1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=42):
    """Numeric columns 0-3 with NaN; column 4 categorical with 12
    categories (sorted-subset splits) plus NaN and negative values;
    column 5 categorical with 3 (one-hot splits)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < 0.05] = np.nan
    c0 = rng.randint(0, 12, size=N).astype(np.float64)
    c0[rng.uniform(size=N) < 0.03] = -1.0
    c0[rng.uniform(size=N) < 0.03] = np.nan
    c1 = rng.randint(0, 3, size=N).astype(np.float64)
    X[:, 4], X[:, 5] = c0, c1
    Xn = np.nan_to_num(X)
    logits = np.stack([Xn[:, 0] + 1.5 * (np.nan_to_num(c0) % 3 == k)
                       + 0.8 * (c1 == k) - 0.5 * Xn[:, 1] * (k - 1)
                       for k in range(C)], axis=1)
    y = np.argmax(2 * logits + rng.gumbel(size=(N, C)), axis=1)
    return X, y.astype(np.float64)


# ------------------------------------------------------------------ K5
F5, RB, NPAD = 5, 256, 2048


def _channel_sets(seed, B):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F5, NPAD)).astype(np.uint8)
    grads = rng.normal(size=(C, NPAD)).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=(C, NPAD)).astype(np.float32)
    member = np.ones(NPAD, np.float32)
    member[-100:] = 0.0                                  # pad rows
    return bins, grads, hess, member


def test_pack_channel_sets_and_class_scales():
    _, grads, hess, member = _channel_sets(0, 16)
    w8C = th.pack_channel_sets(torch.from_numpy(grads),
                               torch.from_numpy(hess),
                               torch.from_numpy(member))
    want = np.concatenate([np.asarray(jph.pack_channels(
        jnp.asarray(grads[c]), jnp.asarray(hess[c]), jnp.asarray(member)))
        for c in range(C)]).view(np.int16)
    np.testing.assert_array_equal(w8C.view(torch.int16).numpy(), want)
    scales = th.class_scales(w8C)
    assert scales.shape == (C, 2)
    for c in range(C):
        w8 = th.pack_channels(torch.from_numpy(grads[c]),
                              torch.from_numpy(hess[c]),
                              torch.from_numpy(member))
        assert torch.equal(scales[c], th.fixed_point_scales(w8))


@pytest.mark.parametrize("B", [16, 256])
def test_histogram_all_matches_jax(B):
    bins, grads, hess, member = _channel_sets(B, B)
    w8C = th.pack_channel_sets(torch.from_numpy(grads),
                               torch.from_numpy(hess),
                               torch.from_numpy(member))
    out = jph.histogram_all(jnp.asarray(bins),
                            jnp.asarray(w8C.float().numpy(), jnp.bfloat16),
                            B, RB, interpret=True)
    want = np.stack([np.asarray(jph.unpack_hist(out[c]), np.float64)
                     for c in range(C)])
    tb = torch.from_numpy(bins)
    got = th.histogram_all(tb, w8C, B, th.class_scales(w8C))
    assert got.shape == (C, F5, B, 3) and got.dtype == torch.float32
    gotd = got.numpy().astype(np.float64)
    ch = w8C.float().numpy().astype(np.float64)
    lid0 = torch.zeros(NPAD, dtype=torch.int32)
    for c in range(C):
        g_abs = np.abs(ch[8 * c] + ch[8 * c + 1])
        h_abs = np.abs(ch[8 * c + 2] + ch[8 * c + 3])
        for f in range(F5):
            ga = np.bincount(bins[f], weights=g_abs, minlength=B)
            ha = np.bincount(bins[f], weights=h_abs, minlength=B)
            np.testing.assert_array_equal(gotd[c, f, :, 2],
                                          want[c, f, :, 2])
            assert np.all(np.abs(gotd[c, f, :, 0] - want[c, f, :, 0])
                          <= 1e-5 * ga + 1e-30)
            assert np.all(np.abs(gotd[c, f, :, 1] - want[c, f, :, 1])
                          <= 1e-5 * ha + 1e-30)
        # class c's slice is the K1 root of class c, bit for bit
        w8 = w8C[8 * c:8 * c + 8].contiguous()
        root = th.histogram_segment(tb, w8, lid0, 0, NPAD // RB, 0, B, RB,
                                    th.fixed_point_scales(w8))
        assert torch.equal(got[c], root)
    # pad rows carry no count
    assert gotd[..., 2].sum() == C * F5 * (NPAD - 100)


# ------------------------------------------------------------- binning
def _cat_columns(seed=3):
    """Categorical columns: NaN, negative and rare categories; a column
    dominated by category 0; more categories than max_bin (63) that still
    fit the port's one-byte bins; a column with one category."""
    rng = np.random.RandomState(seed)
    n = 3000
    a = rng.randint(0, 20, size=n).astype(np.float64)
    a[rng.uniform(size=n) < 0.05] = np.nan
    a[rng.uniform(size=n) < 0.03] = -2.0
    a[:4] = [41.0, 41.0, 57.0, 99.0]                     # rare categories
    b = np.where(rng.uniform(size=n) < 0.8, 0.0,
                 rng.randint(1, 5, size=n)).astype(np.float64)
    c = rng.randint(0, 200, size=n).astype(np.float64)
    d = np.full(n, 7.0)
    e = rng.normal(size=n)                               # numerical
    return np.stack([a, b, c, d, e], axis=1)


def test_categorical_binning_matches_jax():
    X = _cat_columns()
    y = np.zeros(len(X))
    jds = TpuDataset.from_numpy(
        X, y, config=JaxConfig(max_bin=63, verbosity=-1),
        categorical_features=[0, 1, 2, 3])
    pds = TorchDataset.from_numpy(
        X, y, config=lt.Config(max_bin=63, device_type="cpu"),
        categorical_features=[0, 1, 2, 3])
    np.testing.assert_array_equal(pds.used_feature_indices,
                                  jds.used_feature_indices)
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    for a, b in zip(pds.bin_mappers, jds.bin_mappers):
        assert a.is_categorical == b.is_categorical
        assert (a.num_bin, a.default_bin, a.missing_type, a.is_trivial) \
            == (b.num_bin, b.default_bin, b.missing_type, b.is_trivial)
        assert a.bin_2_categorical == list(b.bin_2_categorical)
        assert a.categorical_2_bin == b.categorical_2_bin
    # hand-over both ways keeps every field
    for a, b in zip(pds.bin_mappers, jds.bin_mappers):
        back = JaxBinMapper.from_dict(dict(a.to_dict(), sparse_rate=0.0))
        assert back.bin_2_categorical == b.bin_2_categorical
        assert BinMapper.from_dict(b.to_dict()).to_dict() == a.to_dict()
    infos = pds.feature_infos()
    assert [i.is_cat for i in infos] == [
        pds.bin_mappers[f].is_categorical for f in pds.used_feature_indices]
    assert max(i.num_bin for i in infos) > 63


def test_more_than_256_bins_raises():
    """Categories are not capped at max_bin (bin.cpp's 99% mass rule): a
    feature of more than 256 bins no longer raises; its bins take two
    bytes, as the JAX package stores them, bin for bin its matrix."""
    X = np.random.RandomState(0).randint(0, 400, size=(5000, 1)).astype(
        np.float64)
    pds = TorchDataset.from_numpy(X, np.zeros(len(X)),
                                  config=lt.Config(device_type="cpu"),
                                  categorical_features=[0])
    jds = TpuDataset.from_numpy(X, np.zeros(len(X)), config=JaxConfig(),
                                categorical_features=[0])
    assert pds.max_num_bin > 256 and pds.bins_t.dtype == np.uint16
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)


def test_categorical_value_to_bin_matches_jax():
    X = _cat_columns(5)
    vals = np.array([np.nan, -1.0, -0.0, 0.0, 1.0, 2.9, 41.0, 1e6, 299.0,
                     np.inf])
    for col in range(4):
        jm = JaxBinMapper().find_bin(X[:, col], len(X), 63,
                                     bin_type=BIN_TYPE_CATEGORICAL)
        pm = BinMapper().find_bin(X[:, col], len(X), 63,
                                  bin_type=BIN_TYPE_CATEGORICAL)
        np.testing.assert_array_equal(pm.value_to_bin(vals),
                                      jm.value_to_bin(vals))
        if not pm.is_trivial:
            for b in range(pm.num_bin):
                assert pm.bin_to_value(b) == jm.bin_to_value(b)


# ---------------------------------------------------------- split search
# feature 0 numerical; 1 categorical with 3 bins (one-hot); 2 and 3
# categorical with 20 bins, the last one NaN (sorted subset)
SPLIT_NUM_BIN = np.array([32, 3, 20, 20], np.int32)
SPLIT_MISSING = np.array([0, 0, 2, 2], np.int32)
SPLIT_DEFAULT = np.array([0, 1, 1, 1], np.int32)
SPLIT_IS_CAT = np.array([False, True, True, True])


def _split_hists(seed, strong):
    """[K=2, 4, 32, 3] histograms of synthetic rows whose gradient
    depends most on feature ``strong``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        n = 3000
        bins = np.stack([rng.randint(0, nb, size=n) for nb in SPLIT_NUM_BIN])
        effect = rng.normal(size=(4, 32)) * 0.05
        effect[strong] = rng.normal(size=32) * 1.0
        g = (effect[np.arange(4)[:, None], bins].sum(0)
             + 0.3 * rng.normal(size=n)).astype(np.float32)
        h = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        hist = np.zeros((4, 32, 3), np.float32)
        for f in range(4):
            hist[f, :, 0] = np.bincount(bins[f], weights=g, minlength=32)
            hist[f, :, 1] = np.bincount(bins[f], weights=h, minlength=32)
            hist[f, :, 2] = np.bincount(bins[f], minlength=32)
        out.append(hist)
    return np.stack(out)


@pytest.mark.parametrize("strong,family", [(1, 1), (2, 2), (3, 2), (0, 0)])
def test_best_split_categorical_matches_jax(strong, family):
    hists = _split_hists(10 + strong, strong)
    sp = dict(min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
              lambda_l2=0.5)
    jfm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(SPLIT_NUM_BIN),
        missing_type=jnp.asarray(SPLIT_MISSING),
        default_bin=jnp.asarray(SPLIT_DEFAULT),
        is_cat=jnp.asarray(SPLIT_IS_CAT), monotone=jnp.zeros(4, jnp.int32),
        penalty=jnp.ones(4, jnp.float32))
    pfm = ts.FeatureMeta(torch.from_numpy(SPLIT_NUM_BIN),
                         torch.from_numpy(SPLIT_MISSING),
                         torch.from_numpy(SPLIT_DEFAULT),
                         torch.from_numpy(SPLIT_IS_CAT))
    parent = hists[:, 0].sum(axis=1)                      # [K, 3]
    got = ts.best_split(torch.from_numpy(hists),
                        *(torch.from_numpy(parent[:, j].copy())
                          for j in range(3)),
                        pfm, ts.SplitParams(has_cat=True, **sp))
    fams = []
    for k in range(2):
        want = jsplit.best_split(
            jnp.asarray(hists[k]), *(jnp.float32(parent[k, j])
                                     for j in range(3)),
            jfm, jsplit.SplitParams(has_cat=True, **sp),
            jnp.ones(4, jnp.float32))
        assert int(got.feature[k]) == int(want.feature) == strong
        assert int(got.threshold[k]) == int(want.threshold)
        assert bool(got.is_cat[k]) == bool(want.is_cat)
        assert bool(got.default_left[k]) == bool(want.default_left)
        np.testing.assert_array_equal(
            got.cat_bitset[k].numpy(),
            np.asarray(want.cat_bitset).astype(np.int64))
        np.testing.assert_allclose(float(got.gain[k]), float(want.gain),
                                   rtol=1e-5)
        for name in ("left_c", "left_out", "right_out"):
            np.testing.assert_allclose(float(getattr(got, name)[k]),
                                       float(getattr(want, name)),
                                       rtol=1e-5)
        bits = int(np.unpackbits(np.asarray(want.cat_bitset).view(
            np.uint8)).sum())
        fams.append(0 if not bool(want.is_cat) else (1 if bits == 1 else 2))
    assert family in fams


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirrored_sorted_subset_candidates_tie_exactly(seed):
    """Where the unusable bins hold no rows, the suffix from j and the
    prefix up to j - 1 are one partition, mirrored: their gains are equal
    bit for bit, so the device's rounding cannot choose between them."""
    rng = np.random.RandomState(seed)
    B = 16
    hist = np.zeros((1, 1, B, 3), np.float32)
    hist[0, 0, :12, 2] = rng.randint(20, 400, size=12)
    hist[0, 0, :12, 0] = rng.normal(size=12) * hist[0, 0, :12, 2] * 0.1
    hist[0, 0, :12, 1] = rng.uniform(0.1, 0.25, size=12) * hist[0, 0, :12, 2]
    parent = torch.from_numpy(hist[:, 0].sum(axis=1))        # [1, 3]
    fm = ts.FeatureMeta(torch.tensor([B], dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32),
                        torch.tensor([True]))
    used = ts._cat_used_bin_mask(B, fm)
    gain, _, _ = ts._categorical_sorted_candidates(
        torch.from_numpy(hist), parent, fm,
        ts.SplitParams(has_cat=True, max_cat_threshold=64), used)
    # at most (12 + 1) // 2 categories go left, so the one mirrored pair
    # both sides allow is the prefix of 6 and the suffix of 6
    pre, suf = gain[0, 0, :11, 0], gain[0, 0, 1:12, 1]
    both = torch.isfinite(pre) & torch.isfinite(suf)
    assert int(both.sum()) == 1
    assert torch.equal(pre[both], suf[both])


def test_best_split_without_categorical_adds_nothing():
    hists = _split_hists(4, 0)
    pfm = ts.FeatureMeta(*(torch.from_numpy(a) for a in
                           (SPLIT_NUM_BIN, SPLIT_MISSING, SPLIT_DEFAULT)))
    parent = hists[:, 0].sum(axis=1)
    info = ts.best_split(torch.from_numpy(hists),
                         *(torch.from_numpy(parent[:, j].copy())
                           for j in range(3)), pfm, ts.SplitParams())
    assert info.is_cat is None and info.cat_bitset is None


def test_build_cat_bitset_matches_jax():
    rng = np.random.RandomState(0)
    for B in (3, 32, 200, 256):
        mask = rng.uniform(size=(4, B)) < 0.4
        got = ts.build_cat_bitset(torch.from_numpy(mask)).numpy()
        for k in range(4):
            want = np.asarray(jsplit.build_cat_bitset(jnp.asarray(mask[k])))
            np.testing.assert_array_equal(got[k], want.astype(np.int64))


# ------------------------------------------------- objective and metrics
def _scores(seed=0, n=500):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, C, size=n).astype(np.float64)
    score = (rng.normal(size=(C, n)) * 2).astype(np.float32)
    return y, score


def test_multiclass_objective_matches_jax():
    y, score = _scores()
    meta = types.SimpleNamespace(label=y.astype(np.float32), weights=None)
    jobj = jax_objective(JaxConfig(objective="multiclass", num_class=C,
                                   verbosity=-1))
    jobj.init(meta, len(y))
    pobj = create_objective(lt.Config(objective="softmax", num_class=C,
                                      device_type="cpu"))
    pobj.init(meta, len(y), torch.device("cpu"))
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    pg, ph = pobj.get_gradients(torch.from_numpy(score))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    for k in range(C):
        assert abs(pobj.boost_from_score(k) - jobj.boost_from_score(k)) \
            <= 1e-6
    s64 = score.astype(np.float64)
    np.testing.assert_allclose(pobj.convert_output(s64),
                               jobj.convert_output(s64), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,top_k", [("multi_logloss", 1),
                                        ("multi_error", 1),
                                        ("multi_error", 2)])
def test_multiclass_metrics_match_jax(name, top_k):
    y, score = _scores(1)
    meta = types.SimpleNamespace(label=y, weights=None)
    jcfg = JaxConfig(objective="multiclass", num_class=C,
                     multi_error_top_k=top_k, verbosity=-1)
    pcfg = lt.Config(objective="multiclass", num_class=C,
                     multi_error_top_k=top_k, device_type="cpu")
    jobj = jax_objective(jcfg)
    jobj.init(types.SimpleNamespace(label=y.astype(np.float32),
                                    weights=None), len(y))
    pobj = create_objective(pcfg)
    pobj.init(meta, len(y), torch.device("cpu"))
    jm, pm = jax_metric(name, jcfg), create_metric(name, pcfg)
    jm.init(meta, len(y))
    pm.init(meta, len(y))
    s64 = score.astype(np.float64)
    assert abs(pm.eval(s64, pobj) - jm.eval(s64, jobj)) <= 1e-9


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def pair():
    """(X, JAX GBDT, port Booster) trained on identical bins."""
    X, y = _data()
    cfg = JaxConfig(tpu_histogram_backend="pallas", tpu_tree_impl="segment",
                    **PARAMS)
    jds = TpuDataset.from_numpy(X, y, config=cfg,
                                categorical_features=CAT_COLS)
    assert jds.bundle is None
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = JaxGBDT(cfg, jds, obj)
    assert jgb._use_segment
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    # the JAX run histogrammed its class roots in one batched pass
    assert jgb._fused_fns is not None and jgb._fused_fns[2] is not None
    ds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y)
    bst = lt.Booster(dict(PARAMS, device_type="cpu"), ds)
    for _ in range(ITERS):
        bst.update()
    return X, jgb, bst


def test_slice_trees_match_jax(pair):
    X, jgb, bst = pair
    jt, pt = jgb.models, bst.gbdt.models
    assert len(jt) == len(pt) == ITERS * C
    compared = cat_compared = 0
    for i, (a, b) in enumerate(zip(jt, pt)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while (k < nf and a.split_gain[k] > 1e-2
               and b.split_gain[k] > 1e-2):
            k += 1
        np.testing.assert_array_equal(a.split_feature[:k],
                                      b.split_feature[:k], f"tree {i}")
        # categorical or not; default_left of a NaN-free leaf is a float
        # tie between the two scan directions, so it is not compared
        np.testing.assert_array_equal(a.decision_type[:k] & 1,
                                      b.decision_type[:k] & 1, f"tree {i}")
        np.testing.assert_array_equal(a.threshold_in_bin[:k],
                                      b.threshold_in_bin[:k], f"tree {i}")
        for j in range(k):
            if a.decision_type[j] & 1:
                c = int(a.threshold_in_bin[j])
                np.testing.assert_array_equal(a.cat_threshold_inner[c],
                                              b.cat_threshold_inner[c])
                np.testing.assert_array_equal(a.cat_threshold[c],
                                              b.cat_threshold[c])
                cat_compared += 1
        compared += k
    assert compared >= 20 and cat_compared >= 5
    raw = bst.predict(X, raw_score=True)
    assert raw.shape == (N, C)
    assert np.abs(jgb._raw_predict(X).T - raw).max() < 1e-3


def test_saved_model_loads_in_jax_package(pair, tmp_path):
    X, _, bst = pair
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    text = open(path).read()
    assert f"num_class={C}" in text and "cat_threshold=" in text
    loaded = lightgbm_tpu.Booster(model_file=path)
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))


def test_port_predicts_jax_grown_trees(pair):
    X, jgb, _ = pair
    trees = convert.trees_from_arrays([vars(t) for t in jgb.models])
    assert any(t.num_cat > 0 for t in trees)
    raw = np.zeros((C, len(X))) + np.asarray(jgb.init_scores)[:, None]
    for i, t in enumerate(trees):
        raw[i % C] += t.predict_raw(X)
    np.testing.assert_array_equal(raw, jgb._raw_predict(X))


def test_train_multiclass_categorical_end_to_end():
    """User path: lt.train with Dataset(categorical_feature=...), valid
    sets and the multiclass metrics."""
    X, y = _data(5)
    ds = lt.Dataset(X[:1500], y[:1500], categorical_feature=CAT_COLS)
    valid = ds.create_valid(X[1500:], y[1500:])
    evals = {}
    bst = lt.train(dict(PARAMS, device_type="cpu",
                        metric=["multi_logloss", "multi_error"]),
                   ds, 3, valid_sets=[ds, valid],
                   valid_names=["train", "valid"], evals_result=evals)
    ll = evals["training"]["multi_logloss"]
    assert len(ll) == 3 and ll[-1] < ll[0]
    assert len(bst.gbdt.models) == 3 * C
    assert any(t.num_cat > 0 for t in bst.gbdt.models)
    raw = bst.predict(X[1500:], raw_score=True)
    np.testing.assert_allclose(bst.gbdt.valid_scores[0], raw.T, rtol=0,
                               atol=1e-12)
    prob = bst.predict(X[1500:])
    assert prob.shape == (500, C)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    # the parameter spelling of the categorical columns bins the same
    ds2 = lt.Dataset(X[:1500], y[:1500],
                     params={"categorical_feature": "4,5",
                             "max_bin": 63}).construct()
    np.testing.assert_array_equal(ds2._handle.bins_t,
                                  ds.construct()._handle.bins_t)


def test_root_hist_grows_the_same_tree():
    """The grower given K5's root slice grows what it grows from its own
    root pass."""
    X, y = _data(9)
    ds = lt.Dataset(X, y, categorical_feature=CAT_COLS)
    bst = lt.Booster(dict(PARAMS, device_type="cpu"), ds)
    g = bst.gbdt
    g._boost_from_average()
    grad, hess = g._gradients()
    w8C = th.pack_channel_sets(grad, hess, g.member)
    scales = th.class_scales(w8C)
    roots = th.histogram_all(g.bins, w8C, g.num_bins, scales)
    for k in range(C):
        a, la = g.grower.grow(g.bins, grad[k], hess[k], g.member, g.fmeta,
                              root=(w8C[8 * k:8 * k + 8], scales[k],
                                    roots[k]))
        b, lb = g.grower.grow(g.bins, grad[k], hess[k], g.member, g.fmeta)
        assert torch.equal(la, lb)
        for name in ("split_feature", "threshold_bin", "is_cat",
                     "cat_bitset", "leaf_value"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))


@pytest.mark.parametrize("params", [
    {"objective": "multiclass"},
    {"objective": "binary", "num_class": 3},
])
def test_bad_num_class_raises(params):
    with pytest.raises(lt.LightGBMError):
        lt.Config(device_type="cpu", **params)
