"""The 4-bit packed bin layout (two <= 16-bin columns a byte) in the
PyTorch port against the JAX package, on the CPU.

A dataset whose bin axis is at most 16 (``max_bin`` <= 15) trains on bins
packed two columns a byte (ops/histogram.py pack_bins_4bit: column 2i in
the low nibble of byte row i, 2i + 1 in the high one), as the JAX package
packs them (lightgbm_tpu/models/gbdt.py:547-565).  Here: the packed bytes
and the route words equal JAX's; each kernel's plain version on packed
bins (K1, K3, K2, K5, K6, K7 and P1) equals the JAX kernel run with
``packed4=True`` in interpret mode, leaf ids bit for bit, counts exact and
sums within the kernel tests' 1e-5 x the bin's sum of |value|; trees of
the segment grower (fused and unfused), the frontier grower (K = 4) and
3-class multiclass (K5 roots) on an odd column count, the frontier's
with an EFB group of <= 16 bins, equal JAX's split for split (gain >
1e-2) and equal the port's unpacked model text bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.models.gbdt import build_feature_meta as jax_fmeta
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.core.dataset import TorchDataset
from lightgbm_tpu_torch.models.device_predict import TreeStack
from lightgbm_tpu_torch.models.gbdt import build_feature_meta
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.utils.log import LightGBMError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke  # noqa: E402  (the HIGGS-shaped generator)

ITERS = 3
N, NF, B, RB = 3000, 7, 16, 256
PARAMS = dict(objective="binary", num_leaves=15, max_bin=15,
              tpu_row_chunk=RB, min_data_in_leaf=5, verbosity=-1)
CASES = {
    "segment": (dict(PARAMS, tpu_tree_impl="segment"), {}),
    "segment_unfused": (dict(PARAMS, tpu_tree_impl="segment"),
                        {"fused_route": False}),
    "frontier": (dict(PARAMS, tpu_tree_impl="frontier",
                      tpu_frontier_width=4), {}),
    "multiclass": (dict(PARAMS, objective="multiclass", num_class=3,
                        tpu_tree_impl="segment"), {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_jax_env(monkeypatch):
    """The JAX package's kernel-choice variables unset: its defaults."""
    for k in ("LIGHTGBM_TPU_FUSED_K", "LIGHTGBM_TPU_FUSED_ROUTE",
              "LIGHTGBM_TPU_DYN_GRID", "LIGHTGBM_TPU_HIST_STAGE",
              "LIGHTGBM_TPU_PACKED_ACC", "LIGHTGBM_TPU_ROUTE_KERNEL"):
        monkeypatch.delenv(k, raising=False)


def _higgs(n=N, seed=42):
    """HIGGS-shaped rows cut to NF columns (an odd count)."""
    X, y = chip_smoke.higgs_like(n, seed)
    return X[:, :NF], y


def _one_hot(n=N, seed=5):
    """Two dense columns, then 7-way and 5-way one-hot blocks: at max_bin
    15 each block bundles into one column of <= 16 bins."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 7, size=n)
    b = rng.randint(0, 5, size=n)
    X = np.concatenate([rng.normal(size=(n, 2)), np.eye(7)[a], np.eye(5)[b]],
                       axis=1)
    y = (X[:, 0] + (a % 3 == 0) - 0.5 * (b == 2)
         + 0.3 * rng.normal(size=n) > 0.4).astype(np.float64)
    return X, y


def _jax_trained(X, y, params):
    cfg = JaxConfig(tpu_histogram_backend="pallas", **params)
    jds = TpuDataset.from_numpy(X, y, config=cfg)
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = JaxGBDT(cfg, jds, obj)
    assert jgb.grower_params.packed4, "JAX did not pack the bins"
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    return jds, jgb


def _port_dataset(jds, y):
    return convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y,
        bundle_groups=None if jds.bundle is None else jds.bundle.groups)


def _port_trained(jds, y, params, **kw):
    bst = lt.Booster(dict(params, device_type="cpu"), _port_dataset(jds, y),
                     **kw)
    for _ in range(ITERS):
        bst.update()
    return bst


def _trees_text(bst):
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


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("G", [6, 7])
def test_packed_bytes_equal_jax(G):
    rng = np.random.RandomState(G)
    bins = rng.randint(0, 16, size=(G, 500)).astype(np.uint8)
    got = th.pack_bins_4bit(bins)
    np.testing.assert_array_equal(got, jph.pack_bins_4bit(bins))
    assert got.shape == (-(-G // 2), 500)
    t = torch.from_numpy(got)
    back = th.unpack_bins_4bit(t)
    assert back.shape == (2 * got.shape[0], 500)
    np.testing.assert_array_equal(back[:G].numpy(), bins)
    assert not back[G:].any()
    for col in range(G):
        np.testing.assert_array_equal(
            th.slice_packed_column(t, col).numpy(),
            np.asarray(jph.slice_packed_column(jnp.asarray(got), col)))


def test_device_bins_equal_jax_host_binned_t():
    """The training bins the port uploads packed are, byte for byte, JAX's
    host_binned_T(rb, packed4=True); unpacked they are JAX's unpacked."""
    X, y = _higgs()
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(max_bin=15,
                                                       verbosity=-1))
    pds = TorchDataset.from_numpy(X, y, config=lt.Config(
        device_type="cpu", max_bin=15))
    assert pds.num_columns == NF and pds.max_column_bin <= 16
    cpu = torch.device("cpu")
    for packed4 in (True, False):
        got = pds.device_bins(RB, cpu, packed4).numpy()
        np.testing.assert_array_equal(got, jds.host_binned_T(RB, packed4))
    assert pds.device_bins(RB, cpu, True).shape == (4, 3072)


def test_packed4_follows_the_bin_axis():
    X, y = _higgs(1000)
    p = dict(PARAMS, device_type="cpu")
    bst = lt.Booster(p, lt.Dataset(X, y))
    assert bst.gbdt.packed4 and bst.gbdt.num_bins == 16
    assert bst.gbdt.grower.p.packed4 and bst.gbdt.grower.p.num_columns == NF
    assert tuple(bst.gbdt.bins.shape) == (4, 1024)
    assert not lt.Booster(p, lt.Dataset(X, y), packed4=False).gbdt.packed4
    wide = dict(p, max_bin=63)
    assert not lt.Booster(wide, lt.Dataset(X, y)).gbdt.packed4
    with pytest.raises(LightGBMError):
        lt.Booster(wide, lt.Dataset(X, y), packed4=True)


def test_route_words_equal_jax():
    """Host and device route words = JAX's pack_route(..., packed4=True)
    for even and odd columns, unbundled and in an EFB group."""
    bitset = np.array([0x80000001, 5, 0, 0xFFFFFFFF, 0, 0, 0, 1], np.uint32)
    for X, y in (_higgs(), _one_hot()):
        jds = TpuDataset.from_numpy(X, y, config=JaxConfig(max_bin=15,
                                                           verbosity=-1))
        jfm = jax_fmeta(jds)
        pds = _port_dataset(jds, y)._handle
        fm = build_feature_meta(pds, torch.device("cpu"))
        host = fm._replace(gather_idx=None)
        for f in range(pds.num_used_features):
            want = np.asarray(jph.pack_route(2, 9, f, 1, True, False,
                                             jnp.asarray(bitset), jfm, True))
            got = th.pack_route(2, 9, f, 1, True, False, bitset, host,
                                packed4=True).numpy()
            np.testing.assert_array_equal(got, want)
            split = torch.tensor([f, 1, 1, 0, *bitset.view(np.int32)],
                                 dtype=torch.int32)
            dev = th.pack_route_device(torch.tensor([2]), torch.tensor([9]),
                                       split, fm, packed4=True)
            np.testing.assert_array_equal(dev.numpy(), want)
            assert got[2] == got[3] // 2


# ------------------------------------------------------------ the kernels
def _kernel_inputs(seed, G=NF, npad=2048):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, npad)).astype(np.uint8)
    bins[1] = rng.randint(0, 5, size=npad)          # a few-bin column
    grad = rng.normal(size=npad).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=npad).astype(np.float32)
    member = np.ones(npad, np.float32)
    member[-100:] = 0.0                              # pad rows
    lid = rng.randint(0, 4, size=npad).astype(np.int32)
    w8 = th.pack_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                          torch.from_numpy(member))
    return bins, th.pack_bins_4bit(bins), w8, lid


def _jfm(G=NF):
    from lightgbm_tpu.ops import split as jsplit
    num_bin = np.full(G, B, np.int32)
    num_bin[1] = 5
    return jsplit.FeatureMeta(
        num_bin=jnp.asarray(num_bin),
        missing_type=jnp.asarray((np.arange(G) % 3).astype(np.int32)),
        default_bin=jnp.asarray((num_bin // 3).astype(np.int32)),
        is_cat=jnp.asarray(np.arange(G) == 4),
        monotone=jnp.zeros(G, jnp.int32), penalty=jnp.ones(G, jnp.float32))


def _jroutes():
    """A numeric split of leaf 1 on column 3 (a high nibble), a NaN-missing
    one of leaf 2 on column 2 (a low nibble), a categorical one of leaf 3
    on column 4, and the null route."""
    fm = _jfm()
    none = jnp.zeros(8, jnp.uint32)
    cat = jnp.asarray(np.array([0b1010110101, 0, 0, 0, 0, 0, 0, 0],
                               np.uint32))
    return jnp.stack([
        jph.pack_route(1, 6, 3, 7, True, False, none, fm, True),
        jph.pack_route(2, 7, 2, 4, False, False, none, fm, True),
        jph.pack_route(3, 8, 4, 0, False, True, cat, fm, True),
        jph.null_route()])


def _assert_close(got, want, bins, w8, lid, slot_rows):
    """Counts exact; g/h within 1e-5 x the bin's sum of |value| over the
    slot's rows (``slot_rows``: one [npad] bool mask a slot)."""
    got = np.asarray(got, np.float64).reshape(len(slot_rows), -1, B, 3)
    want = np.asarray(want, np.float64).reshape(got.shape)
    logical = th.unpack_bins_4bit(torch.from_numpy(
        th.pack_bins_4bit(bins))).numpy()
    ch = w8[:4].float().numpy().astype(np.float64)
    for k, sel in enumerate(slot_rows):
        for f in range(got.shape[1]):
            ga = np.bincount(logical[f], np.abs(ch[0] + ch[1]) * sel,
                             minlength=B)
            ha = np.bincount(logical[f], np.abs(ch[2] + ch[3]) * sel,
                             minlength=B)
            np.testing.assert_array_equal(got[k, f, :, 2], want[k, f, :, 2])
            assert np.all(np.abs(got[k, f, :, 0] - want[k, f, :, 0])
                          <= 1e-5 * ga + 1e-30)
            assert np.all(np.abs(got[k, f, :, 1] - want[k, f, :, 1])
                          <= 1e-5 * ha + 1e-30)


def _jw8(w8):
    return jnp.asarray(w8.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K5", "K6",
                                    "K7_routed", "K7_fusedk"])
def test_packed_twins_equal_jax(kernel):
    """Each plain version on the packed bins (an odd column count: the pad
    nibble's column is histogrammed too, as JAX's F_log) = the JAX kernel
    with packed4=True in interpret mode, and = itself on the unpacked
    bins over the real columns."""
    bins, packed, w8, lid = _kernel_inputs(len(kernel))
    npad = bins.shape[1]
    nblk = npad // RB
    jb, tb, tu = jnp.asarray(packed), torch.from_numpy(packed), \
        torch.from_numpy(bins)
    scales = th.fixed_point_scales(w8)
    jroutes = _jroutes()
    routes = torch.from_numpy(np.array(jroutes))
    valid = np.ones(npad, bool)
    valid[-100:] = False
    if kernel == "K1":
        want = jph.unpack_hist(jph.histogram_segment(
            jb, _jw8(w8), jnp.asarray(lid), jnp.int32(1), jnp.int32(5),
            jnp.int32(2), B, RB, interpret=True, packed4=True))
        got = th.histogram_segment(tb, w8, torch.from_numpy(lid), 1, 5, 2, B,
                                   RB, scales, packed4=True)
        rows = np.zeros(npad, bool)
        rows[RB:6 * RB] = True
        assert got.shape == (2 * packed.shape[0], B, 3)
        _assert_close(got.numpy(), want, bins, w8, lid,
                      [rows & (lid == 2) & valid])
        assert torch.equal(got[:NF], th.histogram_segment(
            tu, w8, torch.from_numpy(lid), 1, 5, 2, B, RB, scales))
        return
    if kernel == "K2":
        for j in range(3):
            want = np.asarray(jph.route_window(
                jb, jnp.asarray(lid), jnp.int32(1), jnp.int32(nblk - 2),
                jroutes[j], RB, interpret=True, packed4=True))
            got = th.route_window(tb, torch.from_numpy(lid.copy()), 1,
                                  nblk - 2, routes[j], RB, packed4=True)
            np.testing.assert_array_equal(got.numpy(), want)
            assert (want != lid).any()
            unpacked = routes[j].clone()
            unpacked[2] = unpacked[3]
            assert torch.equal(got, th.route_window(
                tu, torch.from_numpy(lid.copy()), 1, nblk - 2, unpacked, RB))
        return
    if kernel == "K3":
        for j in range(3):
            jl, jh = jph.histogram_segment_routed(
                jb, _jw8(w8), jnp.asarray(lid), jnp.int32(0), jnp.int32(nblk),
                jnp.int32(6 + j), jroutes[j], B, RB, interpret=True,
                packed4=True)
            tl = torch.from_numpy(lid.copy())
            gl, gh = th.histogram_segment_routed(
                tb, w8, tl, 0, nblk, 6 + j, routes[j], B, RB, scales,
                packed4=True)
            np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
            assert (gl.numpy() != lid).any()
            _assert_close(gh.numpy(), jph.unpack_hist(jh), bins, w8, lid,
                          [(np.asarray(jl) == 6 + j) & valid])
        return
    if kernel == "K5":
        C = 3
        rng = np.random.RandomState(9)
        grads = torch.from_numpy(rng.normal(size=(C, npad)).astype(
            np.float32))
        hess = torch.from_numpy(rng.uniform(0.01, 0.25, (C, npad)).astype(
            np.float32))
        member = w8[4].float()
        w8C = th.pack_channel_sets(grads, hess, member)
        out = jph.histogram_all(jb, _jw8(w8C), B, RB, interpret=True,
                                packed4=True)
        got = th.histogram_all(tb, w8C, B, th.class_scales(w8C),
                               packed4=True)
        assert got.shape == (C, 2 * packed.shape[0], B, 3)
        for c in range(C):
            _assert_close(got[c].numpy(), jph.unpack_hist(out[c]), bins,
                          w8C[8 * c:8 * c + 8], lid, [valid])
        assert torch.equal(got[:, :NF], th.histogram_all(
            tu, w8C, B, th.class_scales(w8C)))
        return
    bl, n = th.union_block_list([0, 1, 5], [3, 4, 7], [True] * 3)
    jbl = np.zeros(nblk, np.int32)
    jbl[:n] = bl.numpy()
    rows = np.zeros(npad, bool)
    for b in bl.tolist():
        rows[b * RB:(b + 1) * RB] = True
    if kernel == "K6":
        targets = [2, 0, -1, 3]
        want = jph.unpack_hist(jph.histogram_frontier(
            jb, _jw8(w8), jnp.asarray(lid), jnp.asarray(jbl), jnp.int32(n),
            jnp.asarray(targets, jnp.int32), B, RB, interpret=True,
            packed4=True))
        got = th.histogram_frontier(tb, w8, torch.from_numpy(lid), bl, n,
                                    torch.tensor(targets, dtype=torch.int32),
                                    B, RB, scales, packed4=True)
        _assert_close(got.numpy(), want, bins, w8, lid,
                      [rows & (lid == t) & valid for t in targets])
        return
    if kernel == "K7_routed":
        targets, fn, jfn = [6, 2, 8, -1], th.histogram_frontier_routed, \
            jph.histogram_frontier_routed
    else:
        targets, fn, jfn = [1, 2, 3, -1, 6, 7, 8, -1], \
            th.histogram_frontier_fusedk, jph.histogram_frontier_fusedk
    jl, jh = jfn(jb, _jw8(w8), jnp.asarray(lid), jnp.asarray(jbl),
                 jnp.int32(n), jnp.asarray(targets, jnp.int32), jroutes, B,
                 RB, interpret=True, packed4=True)
    gl, gh = fn(tb, w8, torch.from_numpy(lid.copy()), bl, n,
                torch.tensor(targets, dtype=torch.int32), routes, B, RB,
                scales, packed4=True)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(gl.numpy(), jl)
    assert (jl != lid).any()
    _assert_close(gh.numpy(), jph.unpack_hist(jh), bins, w8, lid,
                  [rows & (jl == t) & valid for t in targets])


def test_step_twins_read_packed_routes():
    """K1, K2 and K3 from a step block on packed bins = their by-value
    twins; a route whose byte row lies past the bins routes nothing."""
    bins, packed, w8, lid = _kernel_inputs(3)
    tb = torch.from_numpy(packed)
    routes = torch.from_numpy(np.array(_jroutes()))
    nblk = bins.shape[1] // RB
    for r in routes[:3]:
        step = th.pack_step(1, nblk - 1, 6, r)
        want_l, want = th.histogram_segment_routed(
            tb, w8, torch.from_numpy(lid.copy()), 1, nblk - 1, 6, r, B, RB,
            None, packed4=True)
        tl = torch.from_numpy(lid.copy())
        _, got = th.histogram_segment_routed_step(tb, w8, tl, step, B, RB,
                                                  None, packed4=True)
        assert torch.equal(tl, want_l) and torch.equal(got, want)
        k2 = th.route_window_step(tb, torch.from_numpy(lid.copy()), step, RB,
                                  packed4=True)
        assert torch.equal(k2, want_l)
        k1 = th.histogram_segment_step(tb, w8, want_l, step, B, RB, None,
                                       packed4=True)
        assert torch.equal(k1, want)
    past = routes[0].clone()
    past[2] = packed.shape[0]                  # the byte row past the bins
    tl = torch.from_numpy(lid.copy())
    th.route_window_step(tb, tl, th.pack_step(0, nblk, 6, past), RB,
                         packed4=True)
    np.testing.assert_array_equal(tl.numpy(), lid)


def test_route_trees_twin_on_packed_bins():
    """P1's plain version over packed training bins (EFB group tables
    included) = over the unpacked ones, leaf for leaf and bit for bit."""
    X, y = _one_hot()
    bst = lt.train(dict(PARAMS, device_type="cpu"), lt.Dataset(X, y), 4)
    g = bst.gbdt
    assert g.packed4 and g.fmeta.feat_group is not None
    ds = g.train_set
    stack = TreeStack(g.models, [0] * len(g.models), ds.num_used_features,
                      torch.device("cpu"))
    fm = g.fmeta
    plain = torch.from_numpy(ds.bins_t)
    packed = torch.from_numpy(th.pack_bins_4bit(ds.bins_t))
    for t in range(len(g.models)):
        np.testing.assert_array_equal(
            tp.route_leaves_plain(packed, stack, t, fm.num_bin,
                                  fm.default_bin, ds.num_data, fm.feat_group,
                                  fm.feat_offset, packed4=True).numpy(),
            tp.route_leaves_plain(plain, stack, t, fm.num_bin,
                                  fm.default_bin, ds.num_data, fm.feat_group,
                                  fm.feat_offset).numpy())
    out = torch.zeros((1, ds.num_data), dtype=torch.float64)
    tp.route_trees(packed, stack, fm.num_bin, fm.default_bin, out,
                   fm.feat_group, fm.feat_offset, packed4=True)
    host = np.zeros(ds.num_data)
    for tree in g.models:
        host += tree.predict_binned(ds.bins_t, ds.feature_infos())
    np.testing.assert_array_equal(out[0].numpy(), host)


def test_card_walks_on_packed_bins_equal_host_walks(monkeypatch):
    """The training loop's card walks (P1 over the packed training bins:
    rollback; valid sets keep one column a byte) through the twin = the
    same booster's host walks, bit for bit."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    X, y = _higgs()
    out = {}
    for card in (True, False):
        monkeypatch.setattr(GBDT, "_walks_on_card", lambda self: card)
        ds = lt.Dataset(X[:2500], y[:2500])
        bst = lt.Booster(dict(PARAMS, device_type="cpu"), ds)
        bst.add_valid(ds.create_valid(X[2500:], y[2500:]), "v")
        for _ in range(ITERS):
            bst.update()
        assert bst.gbdt.packed4
        bst.rollback_one_iter()
        out[card] = (bst.gbdt.train_score.clone(),
                     bst.gbdt.valid_scores[0].copy())
    assert torch.equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])


# ------------------------------------------------------------- the trees
@pytest.fixture(scope="module")
def jax_runs():
    """{(data, case): (JAX dataset, JAX GBDT, labels)}, trained lazily."""
    return {}


def _jax_run(jax_runs, data, case):
    key = (data, CASES[case][0].get("tpu_tree_impl"),
           CASES[case][0]["objective"])
    if key not in jax_runs:
        X, y = _higgs() if data == "higgs" else _one_hot()
        if CASES[case][0]["objective"] == "multiclass":
            y = np.digitize(X[:, 0] + 0.5 * X[:, 1],
                            [-0.5, 0.5]).astype(np.float64)
        jax_runs[key] = _jax_trained(X, y, CASES[case][0]) + (y,)
    return jax_runs[key]


# the segment grower and multiclass on HIGGS-shaped columns, the frontier
# grower on one-hot data whose 7 columns hold a bundled group of 15 bins
# (each JAX configuration costs ~9 s of compiling on one core)
@pytest.mark.parametrize("data,case", [
    ("higgs", "segment"), ("higgs", "segment_unfused"),
    ("higgs", "multiclass"), ("bundled", "frontier")])
def test_packed_trees_equal_jax_and_unpacked(jax_runs, data, case):
    jds, jgb, y = _jax_run(jax_runs, data, case)
    params, kw = CASES[case]
    if data == "bundled":
        assert jds.bundle is not None and any(
            len(g) > 1 for g in jds.bundle.groups)
        assert jds.num_columns == NF
    bst = _port_trained(jds, y, params, **kw)
    g = bst.gbdt
    assert g.packed4 and g.bins.shape[0] == -(-g.train_set.num_columns // 2)
    assert np.asarray(jgb.bins).shape == tuple(g.bins.shape)
    _assert_same_trees(jgb.models, g.models,
                       min_compared=30 if case == "multiclass" else 15)
    assert _trees_text(bst) == _trees_text(
        _port_trained(jds, y, params, packed4=False, **kw))
