"""The segment grower's device loop (lightgbm_tpu_torch.models.grower_seg)
against the JAX segment grower and against itself, on the CPU.

What the loop is made of: the device pack_route (the route's words built
from the best-split cache and FeatureMeta tensors), and K1, K2 and K3
reading their window, target and route from a step block (their plain
versions here; tests/test_torch_cuda.py holds the CUDA entries to their
by-value entries on the card).  What it must keep: a step whose predicate
is false leaves the state as it was, so the model and the compaction
schedule do not depend on the number of steps a replay runs; the trees
and the scan counters of the JAX grower (make_grow_tree_segment, its
Pallas kernels in interpret mode).  Tolerances:

  * route words, step-entry histograms and leaf ids, model texts and the
    state tensors of an inactive step: exact (bit for bit);
  * grown trees against JAX: structure, leaf ids, categorical bitsets and
    the counters exact; split gains within rtol 1e-5 plus 1e-6 x the
    largest gain, as in tests/test_torch_frontier.py; leaf values within
    rtol 1e-4 plus 1e-6 absolute.  A leaf's sums come from float32
    histograms in the reference (float64 in the port's plain version)
    through one parent-minus-child subtraction in float32 for each split
    on its path, up to 8 here, each rounding at the parent's magnitude;
    the frontier test's rtol of 1e-5 is for trees of a few levels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.models.grower_seg import make_grow_tree_segment
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.models.grower import GrowerParams
from lightgbm_tpu_torch.models.grower_seg import SegmentGrower
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split as ts

F, B, RB, NPAD = 5, 32, 256, 4096
NUM_BIN = np.array([32, 20, 17, 32, 12], dtype=np.int32)
MISSING = np.array([0, 2, 1, 0, 0], dtype=np.int32)     # none/nan/zero
DEFAULT_BIN = np.array([0, 7, 5, 0, 0], dtype=np.int32)
IS_CAT = np.array([False, False, False, False, True])


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
              "LIGHTGBM_TPU_PACKED_ACC", "LIGHTGBM_TPU_ROUTE_KERNEL",
              "LIGHTGBM_TPU_COMPACT_WASTE"):
        monkeypatch.delenv(k, raising=False)


def _fmeta(cat=True):
    is_cat = torch.from_numpy(IS_CAT) if cat else None
    return ts.FeatureMeta(torch.from_numpy(NUM_BIN),
                          torch.from_numpy(MISSING),
                          torch.from_numpy(DEFAULT_BIN), is_cat)


def _host_fmeta():
    return ts.FeatureMeta(NUM_BIN, MISSING, DEFAULT_BIN)


# ---------------------------------------------------------- route words
@pytest.mark.parametrize("f,t,dl,cat,bitset", [
    (0, 20, False, False, None),          # missing none
    (2, 3, True, False, None),            # missing zero
    (1, 9, True, False, None),            # missing NaN
    (1, 9, False, False, None),
    (4, 0, False, True, [0x80000001, 5, 0, 0xFFFFFFFF, 0, 0, 0, 1]),
    (4, 0, False, True, [0x0000F00F, 0, 0, 0, 0, 0, 0x80000000, 0]),
])
def test_pack_route_device_equals_host(f, t, dl, cat, bitset):
    """The device pack_route, from a best-split cache row and FeatureMeta
    tensors, gives the host pack_route's 19 words, the bitset as int32."""
    bits = np.asarray(bitset or [0] * 8, dtype=np.uint32)
    want = th.pack_route(2, 9, f, t, dl, cat, bits, _host_fmeta())
    split = torch.from_numpy(np.concatenate(
        [np.array([f, t, int(dl), int(cat)], np.int32),
         bits.view(np.int32)]))
    got = th.pack_route_device(torch.tensor([2]), torch.tensor([9]), split,
                               _fmeta())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    step = th.pack_step(torch.tensor([3]), torch.tensor([5]),
                        torch.tensor([9]), got)
    np.testing.assert_array_equal(step.numpy()[:3], [3, 5, 9])
    np.testing.assert_array_equal(step.numpy()[3:], want.numpy())


def test_pack_route_device_of_no_split_is_a_valid_route():
    """Feature -1 (a leaf with no split) reads feature 0's metadata."""
    split = torch.zeros(th.SPLIT_WORDS, dtype=torch.int32)
    split[0] = -1
    got = th.pack_route_device(torch.tensor([-1]), torch.tensor([4]), split,
                               _fmeta())
    want = th.pack_route(-1, 4, 0, 0, False, False, np.zeros(8, np.uint32),
                         _host_fmeta())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --------------------------------------------------------- step entries
def _layout(seed):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(np.stack(
        [rng.randint(0, nb, size=NPAD) for nb in NUM_BIN]).astype(np.uint8))
    member = torch.ones(NPAD)
    member[-100:] = 0.0
    w8 = th.pack_channels(torch.from_numpy(rng.normal(size=NPAD).astype(
        np.float32)), torch.from_numpy(rng.uniform(0.01, 0.25, size=NPAD)
                                       .astype(np.float32)), member)
    lid = torch.from_numpy(rng.randint(0, 4, size=NPAD).astype(np.int32))
    return bins, w8, lid


def _routes():
    fm = _host_fmeta()
    bits = np.array([0x5A5A5A5A, 0xFFFF0000, 1, 0, 7, 0, 0, 0x80000000],
                    np.uint32)
    none = np.zeros(8, np.uint32)
    return [th.pack_route(1, 6, 0, 16, False, False, none, fm),
            th.pack_route(2, 6, 1, 3, True, False, none, fm),
            th.pack_route(0, 6, 2, 2, True, False, none, fm),
            th.pack_route(3, 6, 4, 0, False, True, bits, fm),
            th.null_route()]


# whole layout (a first split), partial, a late window of one block, empty
WINDOWS = ((0, NPAD // RB), (3, 6), (15, 1), (4, 0))


@pytest.mark.parametrize("lo,nblk", WINDOWS)
def test_step_plain_versions_equal_by_value(lo, nblk):
    """K1, K2 and K3 from a step block give their by-value versions'
    histograms and leaf ids bit for bit, on every route kind."""
    bins, w8, lid = _layout(lo + nblk)
    scales = th.fixed_point_scales(w8)
    for route in _routes():
        for target in (6, int(route[0])):
            step = th.pack_step(lo, nblk, target, route)
            want_lid, want = th.histogram_segment_routed(
                bins, w8, lid.clone(), lo, nblk, target, route, B, RB,
                scales)
            ids = lid.clone()
            out = torch.full((F, B, 3), 7.0)
            got_lid, got = th.histogram_segment_routed_step(
                bins, w8, ids, step, B, RB, scales, out=out)
            assert got_lid is ids and got is out
            assert torch.equal(ids, want_lid) and torch.equal(got, want)
            k2 = th.route_window_step(bins, lid.clone(), step, RB)
            assert torch.equal(k2, want_lid)
            k1 = th.histogram_segment_step(bins, w8, want_lid, step, B, RB,
                                           scales)
            assert torch.equal(k1, th.histogram_segment(
                bins, w8, want_lid, lo, nblk, target, B, RB, scales))
            if nblk == 0:
                assert not got.any() and torch.equal(ids, lid)


def test_step_route_row_outside_the_bins_routes_nothing():
    bins, w8, lid = _layout(5)
    route = _routes()[0].clone()
    route[2] = F
    step = th.pack_step(0, NPAD // RB, 1, route)
    ids = lid.clone()
    _, got = th.histogram_segment_routed_step(bins, w8, ids, step, B, RB,
                                              th.fixed_point_scales(w8))
    assert torch.equal(ids, lid)
    assert torch.equal(got, th.histogram_segment_plain(
        bins, w8, lid, 0, NPAD // RB, 1, B, RB))
    with pytest.raises(ValueError):
        th.route_window_step(bins, lid, step[:-1].clone(), RB)


# ------------------------------------------------------------ the grower
def _grower_inputs(kind, seed=0):
    """Bins, gradients and hessians of one tree: "binary" (logistic at
    random scores), "regression" (L2), or "mc" (class 0 of a 3-class
    softmax whose classes follow the categorical column 4)."""
    rng = np.random.RandomState(seed)
    bins = np.stack([rng.randint(0, nb, size=NPAD) for nb in NUM_BIN]
                    ).astype(np.uint8)
    member = np.ones(NPAD, np.float32)
    member[-96:] = 0.0
    signal = (bins[0] / 32.0 - 0.5) + 0.8 * (bins[2] < 6) \
        + 0.6 * np.isin(bins[4], [1, 4, 7, 9])
    if kind == "regression":
        grad = (rng.normal(size=NPAD) * 0.3 - signal).astype(np.float32)
        hess = np.ones(NPAD, np.float32)
    elif kind == "binary":
        y = (signal + rng.normal(size=NPAD) * 0.5 > 0.4).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-rng.normal(size=NPAD) * 0.3))
        grad, hess = (p - y).astype(np.float32), (p * (1 - p)).astype(
            np.float32)
    else:
        cls = np.where(np.isin(bins[4], [1, 4, 7, 9]), 0,
                       np.where(bins[0] < 12, 1, 2))
        cls = np.where(rng.uniform(size=NPAD) < 0.2,
                       rng.randint(0, 3, size=NPAD), cls)
        p = 1.0 / 3.0
        grad = (p - (cls == 0)).astype(np.float32)
        hess = np.full(NPAD, 2 * p * (1 - p), np.float32)
    return bins, grad * member, hess * member, member


def _jax_grow(bins, grad, hess, member, L, max_depth, sp):
    jfm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(NUM_BIN), missing_type=jnp.asarray(MISSING),
        default_bin=jnp.asarray(DEFAULT_BIN), is_cat=jnp.asarray(IS_CAT),
        monotone=jnp.zeros(F, jnp.int32), penalty=jnp.ones(F, jnp.float32))
    grow = make_grow_tree_segment(B, JaxGrowerParams(
        num_leaves=L, max_depth=max_depth, hist_backend="pallas",
        split=jsplit.SplitParams(**sp, has_cat=True)), RB)
    return grow(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                jnp.asarray(member), jfm, jnp.ones(F, jnp.float32),
                jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind,L,max_depth", [("binary", 31, -1),
                                              ("regression", 31, -1),
                                              ("binary", 31, 4),
                                              ("mc", 15, -1)])
def test_trees_and_counters_match_jax_segment_grower(kind, L, max_depth):
    """The tree, the leaf ids and the JAX stats vector's scanned-blocks
    and compactions slots; the multiclass tree grows from its K5 root."""
    bins, grad, hess, member = _grower_inputs(kind, L + max_depth)
    sp = dict(min_data_in_leaf=5.0, lambda_l2=0.5)
    jt, jl, jstats = _jax_grow(bins, grad, hess, member, L, max_depth, sp)
    g = SegmentGrower(B, GrowerParams(num_leaves=L, max_depth=max_depth,
                                      split=ts.SplitParams(**sp,
                                                           has_cat=True)),
                      RB, steps=4)
    tb, tg, th_, tm = (torch.from_numpy(a) for a in (bins, grad, hess,
                                                     member))
    root = None
    if kind == "mc":
        w8C = th.pack_channel_sets(tg[None], th_[None], tm)
        scales = th.class_scales(w8C)
        root = (w8C, scales[0], th.histogram_all(tb, w8C, B, scales)[0])
    pt, pl = g.grow(tb, tg, th_, tm, _fmeta(), root=root)
    n = int(jt.num_leaves)
    assert pt.num_leaves == n and n > 8
    for name, m in (("split_feature", n - 1), ("threshold_bin", n - 1),
                    ("default_left", n - 1), ("is_cat", n - 1),
                    ("cat_bitset", n - 1), ("left_child", n - 1),
                    ("right_child", n - 1), ("leaf_parent", n),
                    ("leaf_depth", n)):
        np.testing.assert_array_equal(getattr(pt, name)[:m],
                                      np.asarray(getattr(jt, name))[:m], name)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(pt.leaf_value[:n], np.asarray(jt.leaf_value)
                               [:n], rtol=1e-4, atol=1e-6)
    jgain = np.asarray(jt.split_gain)[:n - 1]
    np.testing.assert_allclose(pt.split_gain[:n - 1], jgain, rtol=1e-5,
                               atol=1e-6 * float(jgain.max()))
    stats = np.asarray(jstats)
    assert g.last_stats["scanned_blocks"] == int(stats[0])
    assert g.last_stats["compactions"] == int(stats[1])
    if kind == "mc":
        assert pt.is_cat[:n - 1].any()
    if max_depth > 0:
        assert pt.leaf_depth[:n].max() <= max_depth


def _loop_params():
    return GrowerParams(num_leaves=31, split=ts.SplitParams(
        min_data_in_leaf=5.0, has_cat=True))


def _started(fused=True, at_root=True):
    """A grower whose state holds a whole tree, or (``at_root``) a tree at
    its root, ready to split."""
    bins, grad, hess, member = (torch.from_numpy(a) for a in
                                _grower_inputs("binary", 3))
    g = SegmentGrower(B, _loop_params(), RB, fused_route=fused, steps=2)
    tree, _ = g.grow(bins, grad, hess, member, _fmeta())
    if not at_root:
        assert tree.num_leaves == g.p.num_leaves
        g._src = (bins, th.pack_channels(grad, hess, member))
        return g, g.s
    w8 = th.pack_channels(grad, hess, member)
    s = g._state_for(bins, _fmeta())
    g._src = (bins, w8)
    s.load(bins, w8, th.fixed_point_scales(w8), _fmeta(),
           torch.stack([grad.sum(), hess.sum(), member.sum()]))
    g._start(False, NPAD // RB)
    return g, s


def _snapshot(s):
    return {k: getattr(s, k).clone() for k in s.STATE}


def _assert_unchanged(s, before):
    """Every state tensor bit for bit as it was."""
    for k, v in before.items():
        assert torch.equal(getattr(s, k).view(torch.uint8),
                           v.view(torch.uint8)), k


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("why", ["full", "budget", "no_gain"])
def test_inactive_step_leaves_the_state_unchanged(fused, why):
    """A step whose predicate is false (the tree has its L leaves, the
    scan budget is spent, or no leaf has a positive gain) launches its
    kernels on an empty window and changes no state tensor, bit for bit;
    an active step from the same state changes it."""
    g, s = _started(fused, at_root=why != "full")
    if why == "budget":
        s.counters[1] = g.limit
    else:
        s.best_f32[:, 0] = torch.where(s.best_f32[:, 0] > 0, 0.0,
                                       s.best_f32[:, 0])
    before = _snapshot(s)
    for _ in range(3):
        g._step()
    _assert_unchanged(s, before)
    g._write_status()
    n_leaves, can_grow, spent = s.status.tolist()
    assert n_leaves == int(s.counters[0])
    assert bool(can_grow) == (why == "budget")
    assert bool(spent) == (why == "budget")
    if why == "budget":
        s.counters[1] = 0
        g._step()
        assert int(s.counters[0]) == 2
        assert not torch.equal(s.leaf_hist, before["leaf_hist"])


def _model(bst):
    return bst.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("fused", [True, False])
def test_model_text_is_the_same_for_every_steps(fused):
    """steps = 1, 3 and L - 1 grow one model text, with the same scan
    counters, on data whose trees compact at least twice."""
    rng = np.random.RandomState(1)
    X = rng.normal(size=(3000, 7))
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) ** 2
         > 0.5).astype(np.float64)
    params = dict(objective="binary", num_leaves=63, tpu_row_chunk=256,
                  min_data_in_leaf=3, device_type="cpu", verbosity=-1)
    texts, stats = {}, {}
    for steps in (1, 3, 62):
        bst = lt.Booster(params, lt.Dataset(X, y), fused_route=fused)
        g = bst.gbdt.grower
        g.steps = steps
        seen = []
        grow = g.grow

        def recorded(*a, **k):
            out = grow(*a, **k)
            seen.append({k: g.last_stats[k] for k in (
                "scanned_blocks", "compactions", "splits")})
            bound = (math.ceil((g.p.num_leaves - 1) / steps)
                     + g.last_stats["compactions"] + 2)
            assert g.last_stats["fetches"] <= bound
            return out

        g.grow = recorded
        for _ in range(3):
            bst.update()
        texts[steps], stats[steps] = _model(bst), seen
    assert max(s["compactions"] for s in stats[1]) >= 2
    assert texts[1] == texts[3] == texts[62]
    assert stats[1] == stats[3] == stats[62]
