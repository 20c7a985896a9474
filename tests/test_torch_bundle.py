"""Exclusive feature bundling (EFB) in the PyTorch port against the JAX
package, on the CPU.

The port packs the JAX Dataset's groups from the same binning sample into
the same bundled bin columns (lightgbm_tpu_torch/core/bundle.py), byte for
byte, expands a group histogram into per-feature ones as the JAX scan
does (ops/split.expand_group_hist), routes a split by its feature's column
and bin offset (the route words of ops/histogram.pack_route) and walks
trees over bundled bins (Tree.apply_binned, P1's twin).  Trees are held
to the JAX package's on identical bins, with the rule of
tests/test_torch_train.py: the same split feature and bin threshold for
every split whose gain is above 1e-2, raw predictions within 1e-3.  On
the generators of the port's dense configurations (chip_smoke.py:
HIGGS-shaped data, multiclass_cat) no multi-feature group forms in either
package, and the default enable_bundle=True trains on the unbundled bins.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models import device_predict as jdp
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.models.gbdt import build_feature_meta as jax_fmeta
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.core.dataset import TorchDataset
from lightgbm_tpu_torch.models.device_predict import TreeStack
from lightgbm_tpu_torch.models.gbdt import GBDT, build_feature_meta
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.ops.split import (expand_group_hist,
                                          reconstruct_feature_column)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke  # noqa: E402  (the configurations' data generators)

ITERS = 3
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              tpu_row_chunk=256, min_data_in_leaf=5, verbosity=-1)
MC_PARAMS = dict(PARAMS, objective="multiclass", num_class=3,
                 tpu_tree_impl="frontier", tpu_frontier_width=2)


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


def _one_hot(n=3000, seed=0, cat=False):
    """Two dense columns, then a 12-way one-hot block and a 6-way one:
    every one-hot column is 1 on a twelfth (a sixth) of the rows.  With
    ``cat`` a last column holds a sparse categorical (0 on 90% of the
    rows, else 1-4)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 12, size=n)
    b = rng.randint(0, 6, size=n)
    cols = [rng.normal(size=(n, 2)), np.eye(12)[a], np.eye(6)[b]]
    if cat:
        cols.append(np.where(rng.uniform(size=n) < 0.9, 0,
                             rng.randint(1, 5, size=n))[:, None])
    X = np.concatenate(cols, axis=1)
    y = X[:, 0] + (a % 3 == 0) + 0.1 * rng.normal(size=n)
    return X, y


def _expo(n=3000, seed=3):
    X, y = chip_smoke.expo_like(n, seed)
    return X, y


def _groups(X, y, cat=()):
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(verbosity=-1),
                                categorical_features=cat)
    pds = TorchDataset.from_numpy(X, y, config=lt.Config(device_type="cpu"),
                                  categorical_features=cat)
    np.testing.assert_array_equal(pds.used_feature_indices,
                                  jds.used_feature_indices)
    return (None if jds.bundle is None else jds.bundle.groups,
            None if pds.bundle is None else pds.bundle.groups)


@pytest.mark.parametrize("config", ["higgs", "multiclass_cat"])
def test_no_group_forms_on_the_configurations_data(config):
    if config == "higgs":
        X, y = chip_smoke.higgs_like(3000, 42)
        cat = ()
    else:
        X, y = chip_smoke.multiclass_cat(3000, 7)
        cat = chip_smoke.MC_CAT
    want, got = _groups(X, y, cat)
    assert want is None and got is None
    # the default enable_bundle=True builds the unbundled matrix
    ds = TorchDataset.from_numpy(X, y, config=lt.Config(device_type="cpu"),
                                 categorical_features=cat)
    plain = TorchDataset.from_numpy(
        X, y, config=lt.Config(device_type="cpu", enable_bundle=False),
        categorical_features=cat)
    np.testing.assert_array_equal(ds.bins_t, plain.bins_t)


def test_one_hot_columns_group_as_in_jax_and_train():
    X, y = _one_hot()
    want, got = _groups(X, y)
    assert want is not None and any(len(g) > 1 for g in want)
    assert got == want
    # the default parameters train on the bundled columns
    ds = lt.Dataset(X, y)
    bst = lt.train({"device_type": "cpu", "verbosity": -1}, ds, 2)
    h = ds._handle
    assert h.bundle is not None and h.bins_t.shape[0] == len(want) < 20
    assert bst.gbdt.models[0].num_leaves > 1
    # off, the same data trains on one column a feature
    off = lt.Dataset(X, y, params={"enable_bundle": False})
    lt.train({"device_type": "cpu", "verbosity": -1,
              "enable_bundle": False}, off, 1)
    assert off._handle.bundle is None and off._handle.bins_t.shape[0] == 20


# ----------------------------------------------------------- the matrix
@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
@pytest.mark.parametrize("case", ["default", "conflicts", "sample500",
                                  "categorical"])
def test_bundled_matrix_equals_jax(fmt, case):
    """The bundled bin matrix and its BundleSpec, byte for byte the JAX
    Dataset's, from dense and from sparse input: with the default
    max_conflict_rate 0, with real conflicts (0.1), with a binning
    sample smaller than the rows, and with a categorical member."""
    X, y = _one_hot(cat=case == "categorical", seed=len(case))
    cat = [20] if case == "categorical" else []
    kw = {"conflicts": {"max_conflict_rate": 0.1},
          "sample500": {"bin_construct_sample_cnt": 500}}.get(case, {})
    if case == "conflicts":
        # a dense-ish column that conflicts with the one-hot blocks
        X[:, 1] = np.where(np.random.RandomState(1).uniform(size=len(X))
                           < 0.85, 0.0, X[:, 1])
    data = X if fmt == "dense" else getattr(sp, f"{fmt}_matrix")(X)
    make_j = TpuDataset.from_numpy if fmt == "dense" else \
        TpuDataset.from_scipy
    make_p = TorchDataset.from_numpy if fmt == "dense" else \
        TorchDataset.from_scipy
    jds = make_j(data, y, config=JaxConfig(verbosity=-1, **kw),
                 categorical_features=cat)
    pds = make_p(data, y, config=lt.Config(device_type="cpu", **kw),
                 categorical_features=cat)
    assert jds.bundle is not None
    assert pds.bundle.groups == jds.bundle.groups
    for name in ("feat_group", "feat_offset", "group_num_bin"):
        np.testing.assert_array_equal(getattr(pds.bundle, name),
                                      getattr(jds.bundle, name))
    assert pds.bins_t.dtype == jds.binned.dtype == np.uint8
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    assert pds.num_columns == jds.num_columns
    assert pds.max_column_bin == jds.max_column_bin
    np.testing.assert_array_equal(pds.column_bins, jds.column_bins)
    for a, b in zip(pds.feature_infos(), jds.feature_infos()):
        assert (a.group, a.offset, a.num_bin, a.default_bin) == (
            b.group, b.offset, b.num_bin, b.default_bin)
    if case == "conflicts":
        # a row where two members of a group are off their default
        assert any(len(g) > 1 and 1 in g for g in pds.bundle.groups)
    if case == "categorical":
        assert any(len(g) > 1 and 18 in g for g in pds.bundle.groups)


@pytest.mark.parametrize("max_bin", [15, 63])
def test_columns_of_few_values_bin_as_in_jax(max_bin):
    """Sparse columns of 20 to 400 distinct nonzero values (the greedy
    bin search walks up to 256 distinct values in Python, more by numpy
    searches): the bin bounds and the bin matrix = JAX's."""
    rng = np.random.RandomState(max_bin)
    n = 3000
    cols = []
    for k in (20, 70, 200, 256, 257, 400):
        vals = np.round(rng.uniform(1.0, 5.0, k), 3)
        col = np.where(rng.uniform(size=n) < 0.15, rng.choice(vals, n), 0.0)
        cols.append(col)
    X = sp.csr_matrix(np.stack(cols, axis=1))
    y = rng.uniform(size=n)
    jds = TpuDataset.from_scipy(X, y, config=JaxConfig(verbosity=-1,
                                                       max_bin=max_bin))
    pds = TorchDataset.from_scipy(X, y, config=lt.Config(
        device_type="cpu", max_bin=max_bin))
    for a, b in zip(pds.bin_mappers, jds.bin_mappers):
        assert a.num_bin == b.num_bin
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)


@pytest.fixture(scope="module")
def expo_ds():
    """(X, y, JAX dataset, its FeatureMeta, the port's dataset) of 3000
    Expo-shaped rows: a 255-bin group beside 63-bin numeric columns."""
    X, y = _expo()
    jds = TpuDataset.from_scipy(X, y, config=JaxConfig(**PARAMS))
    pds = TorchDataset.from_scipy(X, y, config=lt.Config(
        device_type="cpu", **PARAMS))
    assert jds.max_column_bin > 128 and jds.max_num_bin <= 64
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    return X, y, jds, jax_fmeta(jds), pds


def test_expand_group_hist_equals_jax(expo_ds):
    _, _, jds, jfm, pds = expo_ds
    fm = build_feature_meta(pds, torch.device("cpu"))
    np.testing.assert_array_equal(fm.gather_idx.numpy(),
                                  np.asarray(jfm.gather_idx))
    G, Bg = pds.num_columns, 256
    rng = np.random.RandomState(0)
    hist = rng.normal(size=(G, Bg, 3)).astype(np.float32)
    hist[..., 2] = rng.randint(0, 50, size=(G, Bg))
    g, h, c = np.float32(3.5), np.float32(120.25), np.float32(3000.0)
    want = np.asarray(jsplit.expand_group_hist(jnp.asarray(hist), jfm, g, h,
                                               c))
    got = expand_group_hist(torch.from_numpy(hist)[None], fm,
                            torch.tensor([g]), torch.tensor([h]),
                            torch.tensor([c]))[0].numpy()
    assert got.shape == want.shape == (pds.num_used_features, 64, 3)
    # slot sums in float32: the order of the adds may differ by an ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # a stored slot is gathered exactly
    info = pds.feature_infos()[10]
    np.testing.assert_array_equal(
        got[10, info.default_bin + 1], hist[info.group,
                                            info.offset + info.default_bin
                                            + 1])


def test_reconstruct_feature_column_equals_jax(expo_ds):
    """A feature's bins read out of its column, for group members and
    for features that own their column."""
    _, _, jds, jfm, pds = expo_ds
    fm = build_feature_meta(pds, torch.device("cpu"))
    infos = pds.feature_infos()
    for f in [0, 3] + [j for j, i in enumerate(infos) if i.offset > 0][:5]:
        col = pds.bins_t[infos[f].group]
        got = reconstruct_feature_column(torch.from_numpy(col), f, fm)
        want = jsplit.reconstruct_feature_column(jnp.asarray(col), f, jfm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_route_words_equal_jax(expo_ds):
    """Route words on the host and on the device = JAX's pack_route for
    features in groups (offset > 0) and in their own columns."""
    _, _, jds, jfm, pds = expo_ds
    fm = build_feature_meta(pds, torch.device("cpu"))
    host = fm._replace(gather_idx=None)
    bitset = np.array([0x80000001, 5, 0, 0xFFFFFFFF, 0, 0, 0, 1], np.uint32)
    infos = pds.feature_infos()
    feats = [0, 3, 10, len(infos) - 1] + [
        j for j, i in enumerate(infos) if i.offset > 0][:3]
    for f in feats:
        want = np.asarray(jph.pack_route(2, 9, f, 1, True, False,
                                         jnp.asarray(bitset), jfm, False))
        got = th.pack_route(2, 9, f, 1, True, False, bitset, host).numpy()
        np.testing.assert_array_equal(got, want)
        split = torch.tensor([f, 1, 1, 0, *bitset.view(np.int32)],
                             dtype=torch.int32)
        dev = th.pack_route_device(torch.tensor([2]), torch.tensor([9]),
                                   split, fm)
        np.testing.assert_array_equal(dev.numpy(), want)
    assert any(infos[f].offset > 0 for f in feats)


def _bundled_inputs(pds, seed):
    rng = np.random.RandomState(seed)
    n = pds.num_data - pds.num_data % 256
    bins = np.ascontiguousarray(pds.bins_t[:, :n])
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=n).astype(np.float32)
    member = np.ones(n, np.float32)
    lid = rng.randint(0, 4, size=n).astype(np.int32)
    w8 = th.pack_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                          torch.from_numpy(member))
    return bins, w8, lid


@pytest.mark.parametrize("kernel", ["K2", "K3", "K7"])
def test_route_twins_over_bundled_columns_equal_jax(expo_ds, kernel):
    """K2/K3/K7's plain versions route a split of a group member by its
    column and offset as the JAX kernels do in interpret mode: leaf ids
    bit for bit, counts exact, sums within the kernel tests' 1e-5."""
    _, _, jds, jfm, pds = expo_ds
    bins, w8, lid = _bundled_inputs(pds, len(kernel))
    B, RB = 256, 256
    infos = pds.feature_infos()
    f = next(j for j, i in enumerate(infos) if i.offset > 20)
    none = jnp.zeros(8, jnp.uint32)
    # rows of leaf 1 at f's non-default bin go right
    jroute = jph.pack_route(1, 6, f, infos[f].default_bin, True, False,
                            none, jfm, False)
    route = torch.from_numpy(np.array(jroute))
    jw8 = jnp.asarray(w8.float().numpy(), jnp.bfloat16)
    tl = torch.from_numpy(lid.copy())
    nblk = bins.shape[1] // RB
    if kernel == "K2":
        want = np.asarray(jph.route_window(
            jnp.asarray(bins), jnp.asarray(lid), jnp.int32(1),
            jnp.int32(nblk - 1), jroute, RB, interpret=True))
        got = th.route_window(torch.from_numpy(bins), tl, 1, nblk - 1, route,
                              RB).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got != lid).any()
        return
    if kernel == "K3":
        jl, jh = jph.histogram_segment_routed(
            jnp.asarray(bins), jw8, jnp.asarray(lid), jnp.int32(0),
            jnp.int32(nblk), jnp.int32(6), jroute, B, RB, interpret=True)
        gl, gh = th.histogram_segment_routed(
            torch.from_numpy(bins), w8, tl, 0, nblk, 6, route, B, RB,
            th.fixed_point_scales(w8))
        slots = [6]
    else:
        targets = [6, 2, -1]
        jroutes = jnp.stack([jroute, jph.pack_route(
            2, 7, 0, 20, False, False, none, jfm, False), jph.null_route()])
        blocks = np.zeros(nblk, np.int32)
        blocks[:nblk - 1] = np.arange(1, nblk)
        jl, jh = jph.histogram_frontier_routed(
            jnp.asarray(bins), jw8, jnp.asarray(lid), jnp.asarray(blocks),
            jnp.int32(nblk - 1), jnp.asarray(targets, jnp.int32), jroutes,
            B, RB, interpret=True)
        gl, gh = th.histogram_frontier_routed(
            torch.from_numpy(bins), w8, tl,
            torch.from_numpy(blocks[:nblk - 1]), nblk - 1,
            torch.tensor(targets, dtype=torch.int32),
            torch.from_numpy(np.array(jroutes)), B, RB,
            th.fixed_point_scales(w8))
        slots = targets
    np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
    assert (gl.numpy() != lid).any()
    got = gh.numpy().reshape(len(slots), -1, B, 3)
    want = np.asarray(jph.unpack_hist(jh)).reshape(got.shape)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    scale = np.abs(w8[:2].float().numpy()).sum()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-5 * scale)


# ----------------------------------------------------------- the trees
def _jax_trained(X, y, params, sparse=True):
    cfg = JaxConfig(tpu_histogram_backend="pallas", **params)
    make = TpuDataset.from_scipy if sparse else TpuDataset.from_numpy
    jds = make(X, y, config=cfg)
    assert jds.bundle is not None
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = JaxGBDT(cfg, jds, obj)
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    return jds, jgb


def _port_trained(jds, y, params, **kw):
    ds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y,
        bundle_groups=jds.bundle.groups)
    bst = lt.Booster(dict(params, device_type="cpu"), ds, **kw)
    for _ in range(ITERS):
        bst.update()
    return bst


def _trees_text(bst):
    """The model text up to its parameters (the trees)."""
    text = bst.model_to_string()
    return text[:text.index("parameters:")]


def _assert_same_trees(jt, pt, min_compared=20):
    assert len(jt) == len(pt)
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
    assert compared >= min_compared


@pytest.fixture(scope="module")
def seg_pair(expo_ds):
    """(X dense, JAX GBDT, port Booster) of the segment grower on the
    bundled Expo-shaped bins."""
    X, y, _, _, _ = expo_ds
    jds, jgb = _jax_trained(X, y, dict(PARAMS, tpu_tree_impl="segment"))
    assert jgb._use_segment
    return X.toarray(), jds, jgb, _port_trained(jds, y, PARAMS)


def test_segment_trees_match_jax(seg_pair):
    X, _, jgb, bst = seg_pair
    assert bst.gbdt.fmeta.gather_idx is not None
    assert bst.gbdt.num_bins == 256
    _assert_same_trees(jgb.models, bst.gbdt.models)
    assert np.abs(jgb._raw_predict(X)[0]
                  - bst.predict(X, raw_score=True)).max() < 1e-3


def test_unfused_and_frontier_tiers_grow_the_fused_model(seg_pair):
    """K2 + K1 (unfused) and the frontier grower at width 1 grow the fused
    segment model's trees on bundled bins; at width 4 "off" and "k1"
    (which share the subtraction) grow one model text, and "fusedk",
    which histograms both children from the rows, the same splits."""
    _, jds, _, bst = seg_pair
    y = jds.metadata.label
    text = _trees_text(bst)
    assert _trees_text(_port_trained(jds, y, PARAMS,
                                     fused_route=False)) == text
    fr = dict(PARAMS, tpu_tree_impl="frontier", tpu_frontier_width=1)
    assert _trees_text(_port_trained(jds, y, fr,
                                     frontier_tier="k1")) == text
    fr4 = dict(fr, tpu_frontier_width=4)
    bsts = {tier: _port_trained(jds, y, fr4, frontier_tier=tier)
            for tier in ("off", "k1", "fusedk")}
    assert bsts["off"].gbdt.grower.K == 4
    assert _trees_text(bsts["off"]) == _trees_text(bsts["k1"])
    for a, b in zip(bsts["off"].gbdt.models, bsts["fusedk"].gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)


def test_multiclass_frontier_matches_jax(expo_ds):
    """A 3-class model through the frontier grower at width 2 (class
    roots by K5 in group space) = the JAX package's."""
    X, _, _, _, _ = expo_ds
    dense = X.toarray()
    y = (np.argmax(dense[:, 4:16], axis=1) % 3).astype(np.float64)
    jds, jgb = _jax_trained(X, y, MC_PARAMS)
    bst = _port_trained(jds, y, MC_PARAMS)
    assert bst.gbdt.grower.K == 2
    _assert_same_trees(jgb.models, bst.gbdt.models)
    assert np.abs(jgb._raw_predict(dense).T
                  - bst.predict(dense, raw_score=True)).max() < 1e-3


# ----------------------------------------------------------- the walks
def test_route_twin_with_group_tables_equals_jax(seg_pair):
    """P1's twin over bundled bins with the group tables: each tree's leaf
    of each row = JAX's predict_binned_leaves with feat_group, bit for
    bit, and the f64 sum = the host walk's."""
    _, jds, jgb, bst = seg_pair
    ds = bst.gbdt.train_set
    trees = bst.gbdt.models
    fm = bst.gbdt.fmeta
    stack = TreeStack(trees, [0] * len(trees), ds.num_used_features,
                      torch.device("cpu"))
    bins = torch.from_numpy(ds.bins_t)
    jstack = jdp.stack_trees([t for t in jgb.models], ds.num_used_features)
    jfm = jax_fmeta(jds)
    want = np.asarray(jdp.predict_binned_leaves(
        jstack, jnp.asarray(jds.binned), jfm.num_bin, jfm.default_bin,
        jfm.feat_group, jfm.feat_offset))
    for t in range(len(trees)):
        got = tp.route_leaves_plain(bins, stack, t, fm.num_bin,
                                    fm.default_bin, ds.num_data,
                                    fm.feat_group, fm.feat_offset)
        np.testing.assert_array_equal(got.numpy(), want[t])
    out = torch.zeros((1, ds.num_data), dtype=torch.float64)
    tp.route_trees(bins, stack, fm.num_bin, fm.default_bin, out,
                   fm.feat_group, fm.feat_offset)
    host = np.zeros(ds.num_data)
    infos = ds.feature_infos()
    for tree in trees:
        host += tree.predict_binned(ds.bins_t, infos)
    np.testing.assert_array_equal(out[0].numpy(), host)


def test_apply_binned_equals_jax(seg_pair):
    _, jds, jgb, bst = seg_pair
    infos = bst.gbdt.train_set.feature_infos()
    for jt, pt in zip(jgb.models, bst.gbdt.models):
        np.testing.assert_array_equal(
            pt.apply_binned(bst.gbdt.train_set.bins_t, infos),
            jt.apply_binned(jds.binned, jds.feature_infos()))


def test_card_walks_equal_host_walks_on_bundled_bins(expo_ds, monkeypatch):
    """A CPU booster with the card's walk logic (P1's twin over the
    bundled training and valid bins with the group tables): valid
    scores, a late add_valid, rollback and init_model's seeding from CSR
    rows = the host walks, bit for bit."""
    X, y, _, _, _ = expo_ds
    params = dict(PARAMS, device_type="cpu")
    runs = []
    for card in (False, True):
        if card:
            monkeypatch.setattr(GBDT, "_walks_on_card", lambda self: True)
        ds = lt.Dataset(X[:2000], y[:2000], params=params)
        va = ds.create_valid(X[2000:], y[2000:])
        bst = lt.Booster(params, ds)
        bst.add_valid(va, "v")
        for _ in range(ITERS):
            bst.update()
        late = ds.create_valid(X[2500:], y[2500:])
        bst.add_valid(late, "late")
        bst.rollback_one_iter()
        g = bst.gbdt
        assert va._handle.bundle is ds._handle.bundle
        cont = lt.train(params, lt.Dataset(X[:2000], y[:2000],
                                           params=params), 1,
                        init_model=bst, verbose_eval=False)
        runs.append([s.copy() for s in g.valid_scores]
                    + [g.train_score.numpy().copy(),
                       cont.gbdt.train_score.numpy().copy()])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- the layout
def test_check_align_refuses_another_layout_and_subset_keeps_it():
    X, y = _one_hot()
    cfg = lt.Config(device_type="cpu")
    ds = TorchDataset.from_numpy(X, y, config=cfg)
    same = TorchDataset.from_numpy(X[:500], y[:500], reference=ds)
    ds.check_align(same)
    other = TorchDataset.from_numpy(X, y, config=lt.Config(
        device_type="cpu", max_conflict_rate=0.1))
    other.bin_mappers = ds.bin_mappers
    assert other.bundle.groups != ds.bundle.groups
    with pytest.raises(lt.LightGBMError, match="EFB column layout"):
        ds.check_align(other)
    plain = TorchDataset.from_numpy(X, y, config=lt.Config(
        device_type="cpu", enable_bundle=False))
    plain.bin_mappers = ds.bin_mappers
    with pytest.raises(lt.LightGBMError, match="EFB column layout"):
        ds.check_align(plain)
    rows = np.arange(0, len(X), 3)
    sub = lt.Dataset(X, y).construct().subset(rows).construct()._handle
    assert sub.bundle is not None and sub.bins_t.shape[0] == len(
        sub.bundle.groups)
    np.testing.assert_array_equal(sub.bins_t, ds.bins_t[:, rows])
