"""Parity of the PyTorch port's frontier grower (lightgbm_tpu_torch,
``tpu_tree_impl=frontier``) with the JAX package on the CPU.

Kernels K6 (``histogram_frontier``) and K7 (``histogram_frontier_routed``
/ ``histogram_frontier_fusedk``), the frontier width, the grower itself
(default tier and fused-K, the leaf budget and the gain-ratio gate), and
the slice as a whole (binary and multiclass with K5 roots) go through
both packages on the same numpy-seeded inputs.  JAX runs its Pallas
kernels in interpret mode, the port the kernels' plain PyTorch versions.
Tolerances:

  * counts, leaf ids, split features, thresholds and widths exact;
  * histogram sums within 1e-5 x the bin's sum of |value| (the TPU kernel
    sums bf16 channels in float32 through its matmul, the port in
    float64);
  * grown trees: leaf values within rtol 1e-5 plus 1e-6 absolute
    (float32 leaf outputs from sums that differ in the last bits; the
    absolute term covers leaves whose gradient sum nearly cancels), split
    gains within rtol 1e-5 plus 1e-6 x the largest gain (a gain is a
    float32 difference of leaf scores as large as the root's);
  * whole training runs: splits with gain > 1e-2 identical (below that,
    float32 summation order may break ties differently), raw predictions
    within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.models.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.models.grower_frontier import make_grow_tree_frontier
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.gbdt import _auto_frontier_k
from lightgbm_tpu_torch.models.grower import GrowerParams
from lightgbm_tpu_torch.models.grower_frontier import FrontierGrower
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split as ts

F, B, RB, NPAD = 5, 32, 256, 2048
NUM_BIN = np.array([32, 20, 17, 32, 3], dtype=np.int32)
MISSING = np.array([0, 2, 1, 2, 0], dtype=np.int32)     # none/nan/zero
DEFAULT_BIN = np.array([0, 7, 5, 0, 1], dtype=np.int32)
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
              "LIGHTGBM_TPU_PACKED_ACC", "LIGHTGBM_TPU_ROUTE_KERNEL"):
        monkeypatch.delenv(k, raising=False)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    bins = np.stack([rng.randint(0, nb, size=NPAD) for nb in NUM_BIN]
                    ).astype(np.uint8)
    grad = rng.normal(size=NPAD).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=NPAD).astype(np.float32)
    member = np.ones(NPAD, np.float32)
    member[-100:] = 0.0                                  # pad rows
    lid = rng.randint(0, 6, size=NPAD).astype(np.int32)
    w8 = th.pack_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                          torch.from_numpy(member))
    return bins, w8, lid


def _jax_w8(w8):
    return jnp.asarray(w8.float().numpy(), jnp.bfloat16)


def _jax_fmeta():
    return jsplit.FeatureMeta(
        num_bin=jnp.asarray(NUM_BIN), missing_type=jnp.asarray(MISSING),
        default_bin=jnp.asarray(DEFAULT_BIN), is_cat=jnp.asarray(IS_CAT),
        monotone=jnp.zeros(F, jnp.int32), penalty=jnp.ones(F, jnp.float32))


def _padded(block_list):
    """JAX's block list layout: the union first, zeros to max_blocks."""
    out = np.zeros(NPAD // RB, np.int32)
    out[:len(block_list)] = block_list.numpy()
    return jnp.asarray(out)


def _assert_slots_close(got, want, bins, w8, lid, block_list, targets):
    """Slot by slot: counts exact; g/h within 1e-5 x the bin's sum of
    |value| over the slot's rows."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rows = np.zeros(NPAD, bool)
    for b in block_list.tolist():
        rows[b * RB:(b + 1) * RB] = True
    ch = w8[:4].float().numpy().astype(np.float64)
    assert got.shape == want.shape == (len(targets), F, B, 3)
    for k, t in enumerate(targets):
        sel = rows & (lid == t) if t >= 0 else np.zeros(NPAD, bool)
        for f in range(F):
            ga = np.bincount(bins[f], weights=np.abs(ch[0] + ch[1]) * sel,
                             minlength=B)
            ha = np.bincount(bins[f], weights=np.abs(ch[2] + ch[3]) * sel,
                             minlength=B)
            np.testing.assert_array_equal(got[k, f, :, 2], want[k, f, :, 2])
            assert np.all(np.abs(got[k, f, :, 0] - want[k, f, :, 0])
                          <= 1e-5 * ga + 1e-30)
            assert np.all(np.abs(got[k, f, :, 1] - want[k, f, :, 1])
                          <= 1e-5 * ha + 1e-30)
        if t < 0:
            assert not got[k].any()


# ------------------------------------------------------------------ K6
# (lo, hi, valid) windows of a round's slots: overlapping siblings, a
# window that is not listed, and an empty round
UNIONS = {
    "siblings": ([0, 1, 5, 2], [3, 4, 6, 8], [True, True, True, False]),
    "one_block": ([7], [8], [True]),
    "empty": ([3], [5], [False]),
}


def test_union_block_list():
    bl, n = th.union_block_list(*UNIONS["siblings"])
    assert bl.dtype == torch.int32 and n == 5
    assert bl.tolist() == [0, 1, 2, 3, 5]
    assert th.union_block_list(*UNIONS["empty"])[1] == 0


@pytest.mark.parametrize("case,targets", [("siblings", [2, 0, -1, 4]),
                                          ("one_block", [-1, 5, 1]),
                                          ("empty", [1, 3])])
def test_histogram_frontier_matches_jax(case, targets):
    bins, w8, lid = _inputs(len(case))
    bl, n = th.union_block_list(*UNIONS[case])
    tg = torch.tensor(targets, dtype=torch.int32)
    want = np.asarray(jph.unpack_hist(jph.histogram_frontier(
        jnp.asarray(bins), _jax_w8(w8), jnp.asarray(lid), _padded(bl),
        jnp.int32(n), jnp.asarray(targets, jnp.int32), B, RB,
        interpret=True)))
    got = th.histogram_frontier(torch.from_numpy(bins), w8,
                                torch.from_numpy(lid), bl, n, tg, B, RB,
                                th.fixed_point_scales(w8))
    assert got.dtype == torch.float32
    _assert_slots_close(got.numpy(), want, bins, w8, lid, bl, targets)
    if n == 0:
        assert not got.any()


def test_histogram_frontier_slot_is_k1():
    """Slot k is the plain K1 of target k over the listed rows."""
    bins, w8, lid = _inputs(4)
    tb, tl = torch.from_numpy(bins), torch.from_numpy(lid)
    bl = torch.tensor([2, 3, 4], dtype=torch.int32)
    got = th.histogram_frontier(tb, w8, tl, bl, 3, torch.tensor(
        [5, -1, 0], dtype=torch.int32), B, RB, th.fixed_point_scales(w8))
    for k, t in ((0, 5), (2, 0)):
        k1 = th.histogram_segment(tb, w8, tl, 2, 3, t, B, RB,
                                  th.fixed_point_scales(w8))
        assert torch.equal(got[k], k1)


# ------------------------------------------------------------------ K7
def _jax_routes():
    """[3, 19]: a numeric split of leaf 1, a categorical one of leaf 3
    (feature 4, a 3-bin categorical), and the null route."""
    fm = _jax_fmeta()
    none = jnp.zeros(8, jnp.uint32)
    cat = jnp.asarray(np.array([0b101, 0, 0, 0, 0, 0, 0, 0], np.uint32))
    return jnp.stack([
        jph.pack_route(1, 6, 1, 9, True, False, none, fm, False),
        jph.pack_route(3, 7, 4, 0, False, True, cat, fm, False),
        jph.null_route()])


@pytest.mark.parametrize("variant", ["routed", "fusedk"])
@pytest.mark.parametrize("case", ["siblings", "one_block"])
def test_histogram_frontier_k7_matches_jax(variant, case):
    bins, w8, lid = _inputs(7 + len(case))
    bl, n = th.union_block_list(*UNIONS[case])
    jroutes = _jax_routes()
    if variant == "routed":
        targets, fn, jfn = [6, 3, -1], th.histogram_frontier_routed, \
            jph.histogram_frontier_routed
    else:
        targets, fn, jfn = [1, 3, -1, 6, 7, -1], \
            th.histogram_frontier_fusedk, jph.histogram_frontier_fusedk
    jl, jh = jfn(jnp.asarray(bins), _jax_w8(w8), jnp.asarray(lid),
                 _padded(bl), jnp.int32(n), jnp.asarray(targets, jnp.int32),
                 jroutes, B, RB, interpret=True)
    tl = torch.from_numpy(lid.copy())
    gl, gh = fn(torch.from_numpy(bins), w8, tl, bl, n,
                torch.tensor(targets, dtype=torch.int32),
                torch.from_numpy(np.array(jroutes)), B, RB,
                th.fixed_point_scales(w8))
    assert gl.data_ptr() == tl.data_ptr(), "leaf_id is updated in place"
    np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
    assert (gl.numpy() != lid).any()
    _assert_slots_close(gh.numpy(), np.asarray(jph.unpack_hist(jh)), bins,
                        w8, np.asarray(jl), bl, targets)


def test_frontier_wrappers_check_arguments():
    bins, w8, lid = _inputs(1)
    tb, tl = torch.from_numpy(bins), torch.from_numpy(lid)
    bl = torch.tensor([0, 1], dtype=torch.int32)
    routes = torch.stack([th.null_route(), th.null_route()])
    s = th.fixed_point_scales(w8)
    with pytest.raises(ValueError):     # fused-K takes 2K targets
        th.histogram_frontier_fusedk(tb, w8, tl, bl, 2, torch.tensor(
            [0, 1, 2], dtype=torch.int32), routes, B, RB, s)
    with pytest.raises(ValueError):     # routed takes K targets
        th.histogram_frontier_routed(tb, w8, tl, bl, 2, torch.tensor(
            [0], dtype=torch.int32), routes, B, RB, s)
    with pytest.raises(ValueError):     # targets are an int32 tensor
        th.histogram_frontier(tb, w8, tl, bl, 2, [0, 1], B, RB, s)
    with pytest.raises(ValueError):     # routes are [K, 19]
        th.histogram_frontier_routed(tb, w8, tl, bl, 2, torch.tensor(
            [0], dtype=torch.int32), th.null_route(), B, RB, s)


# ------------------------------------------ the card launch's parameters
PARAM_WORDS = 4 + th.FRONTIER_MAX_TARGETS + th.FRONTIER_MAX_ROUTES * 19
ROUTES_AT = 4 + th.FRONTIER_MAX_TARGETS


@pytest.mark.parametrize("variant", ["k6", "routed", "fusedk"])
def test_frontier_params_layout(variant):
    """K6/K7's parameter block holds the head, the targets and the JAX
    package's pack_route words where csrc/histogram.cu's FrontierParams
    reads them, zeros after each, and n_ids one past the largest target
    or routed leaf."""
    jroutes = np.array(_jax_routes())            # leaves 1, 3 and -1
    targets = {"k6": [5, -1, 0, 2], "routed": [6, 3, -1],
               "fusedk": [1, 3, -1, 6, 7, 0]}[variant]
    routes = None if variant == "k6" else torch.from_numpy(jroutes)
    block = th.frontier_params(torch.tensor(targets, dtype=torch.int32),
                               routes)
    K = 0 if routes is None else len(jroutes)
    ids = [t for t in targets if t >= 0] + ([1, 3] if K else [])
    assert block.dtype == np.int32 and block.shape == (PARAM_WORDS,)
    assert block[:4].tolist() == [len(targets), K, max(ids) + 1, 0]
    np.testing.assert_array_equal(block[4:4 + len(targets)], targets)
    assert not block[4 + len(targets):ROUTES_AT].any()
    np.testing.assert_array_equal(
        block[ROUTES_AT:ROUTES_AT + K * 19].reshape(K, 19), jroutes[:K])
    assert not block[ROUTES_AT + K * 19:].any()


def test_frontier_params_first_match_wins():
    """A repeated target, or a route whose leaf repeats, is -1 in the
    block, so the kernel's leaf tables keep the first: what the plain
    version's first match gives (a repeated slot is zeros)."""
    bins, w8, lid = _inputs(3)
    targets = torch.tensor([2, 0, 2, -1, 0, 4], dtype=torch.int32)
    block = th.frontier_params(targets, None)
    assert block[4:10].tolist() == [2, 0, -1, -1, -1, 4] and block[2] == 5
    args = (torch.from_numpy(bins), w8, torch.from_numpy(lid),
            torch.tensor([0, 2, 5], dtype=torch.int32), 3)
    a = th.histogram_frontier_plain(*args, targets, B, RB)
    b = th.histogram_frontier_plain(*args, torch.from_numpy(
        block[4:10].copy()), B, RB)
    assert torch.equal(a, b) and a[0].any() and not a[2].any()
    routes = torch.stack([th.null_route()] * 3)
    routes[:, 0] = torch.tensor([1, 3, 1])
    routes[:, 1] = torch.tensor([6, 7, 8])
    block = th.frontier_params(torch.tensor([6, 7, 8], dtype=torch.int32),
                               routes)
    words = block[ROUTES_AT:ROUTES_AT + 3 * 19].reshape(3, 19)
    assert words[:, 0].tolist() == [1, 3, -1] and block[2] == 9
    np.testing.assert_array_equal(words[:, 1:], routes.numpy()[:, 1:])


@pytest.mark.parametrize("K,KT,fits", [(256, 512, True), (257, 257, False),
                                       (1, 513, False), (0, 513, False)])
def test_frontier_params_capacity(K, KT, fits):
    """The block holds 256 routes and 512 targets; a wider frontier
    raises with the reason."""
    routes = torch.stack([th.null_route()] * K) if K else None
    targets = torch.arange(KT, dtype=torch.int32)
    if fits:
        assert th.frontier_params(targets, routes)[:3].tolist() == [KT, K,
                                                                    KT]
    else:
        with pytest.raises(ValueError, match="parameter block"):
            th.frontier_params(targets, routes)


@pytest.mark.parametrize("tier", ["off", "k1", "fusedk"])
def test_frontier_params_of_the_grower_rounds(grower_data, monkeypatch,
                                              tier):
    """Every launch the frontier grower asks (K = 4, 15 leaves) packs with
    its targets in slot order, its routes' words as pack_route wrote
    them, and n_ids one past its largest leaf id, within num_leaves."""
    import lightgbm_tpu_torch.models.grower_frontier as gf
    calls = []
    for name in ("histogram_frontier", "histogram_frontier_routed",
                 "histogram_frontier_fusedk"):
        def spy(*a, _fn=getattr(gf, name)):
            routes = a[6] if isinstance(a[6], torch.Tensor) else None
            calls.append((a[5].clone(), routes,
                          th.frontier_params(a[5], routes)))
            return _fn(*a)
        monkeypatch.setattr(gf, name, spy)
    bins, grad, hess, member = grower_data
    pfm = ts.FeatureMeta(torch.full((GF,), GB, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32))
    g = FrontierGrower(GB, GrowerParams(
        num_leaves=15, split=ts.SplitParams(min_data_in_leaf=5.0)),
        GRB, 4, tier=tier)
    g.grow(torch.from_numpy(bins), torch.from_numpy(grad),
           torch.from_numpy(hess), torch.from_numpy(member), pfm)
    assert len(calls) == g.last_stats["rounds"] + 1
    for targets, routes, block in calls:
        t = targets.numpy()
        K = 0 if routes is None else routes.shape[0]
        np.testing.assert_array_equal(block[4:4 + len(t)], t)
        if K:
            np.testing.assert_array_equal(
                block[ROUTES_AT:ROUTES_AT + K * 19].reshape(K, 19),
                routes.numpy())
        leaves = np.concatenate([t, routes.numpy()[:, 0] if K else []])
        assert block[:3].tolist() == [len(t), K, int(leaves.max()) + 1]
        assert block[2] <= 15


# ------------------------------------------------------------ the width
@pytest.mark.parametrize("nf", [1, 5, 28, 130, 700])
def test_frontier_width_matches_jax(nf):
    for nb in (2, 16, 64, 256):
        assert th.frontier_width(nf, nb) == jph.frontier_width(nf, nb)


@pytest.mark.parametrize("leaves,width", [(2, 0), (15, 0), (31, 0),
                                          (63, 0), (255, 0), (255, 3),
                                          (31, 40)])
def test_auto_frontier_k_matches_jax(leaves, width):
    for nf, nb in ((28, 64), (28, 256), (300, 256), (5, 16)):
        want = jgbdt._auto_frontier_k(
            JaxConfig(num_leaves=leaves, tpu_frontier_width=width,
                      verbosity=-1), nf, nb)
        got = _auto_frontier_k(lt.Config(num_leaves=leaves,
                                         tpu_frontier_width=width,
                                         device_type="cpu"), nf, nb)
        assert got == want


# ----------------------------------------------------------- the grower
GN, GF, GB, GRB = 4096, 5, 32, 256


def _grower_data():
    """Bins and a gradient with clear structure, so that no two candidate
    splits nearly tie."""
    rng = np.random.RandomState(23)
    bins = rng.randint(0, GB, size=(GF, GN)).astype(np.uint8)
    grad = (-(bins[0] >= GB // 2).astype(np.float32)
            - 0.5 * (bins[1] % 3 == 0) + 0.7 * (bins[2] < 5)
            - 0.3 * (bins[3] > 20) + 0.1 * rng.standard_normal(GN)
            ).astype(np.float32)
    hess = rng.uniform(0.5, 1.5, size=GN).astype(np.float32)
    member = np.ones(GN, np.float32)
    member[-150:] = 0.0
    return bins, grad, hess, member


@pytest.fixture(scope="module")
def grower_data():
    return _grower_data()


@pytest.mark.parametrize("L,K,ratio,tier", [(15, 3, 0.0, None),
                                            (15, 3, 0.0, "fusedk"),
                                            (6, 4, 0.0, None),
                                            (15, 4, 0.6, None)])
def test_frontier_grower_matches_jax(grower_data, L, K, ratio, tier):
    """Default tier, fused-K, a leaf budget smaller than K, and the
    gain-ratio gate: the JAX grower's tree and leaf ids."""
    bins, grad, hess, member = grower_data
    sp = dict(min_data_in_leaf=5.0, lambda_l2=0.5)
    jfm = jsplit.FeatureMeta(
        num_bin=jnp.full(GF, GB, jnp.int32),
        missing_type=jnp.zeros(GF, jnp.int32),
        default_bin=jnp.zeros(GF, jnp.int32), is_cat=jnp.zeros(GF, bool),
        monotone=jnp.zeros(GF, jnp.int32), penalty=jnp.ones(GF, jnp.float32))
    grow = make_grow_tree_frontier(
        GB, JaxGrowerParams(num_leaves=L, hist_backend="pallas",
                            split=jsplit.SplitParams(**sp)),
        GRB, batch_k=K, gain_ratio=ratio,
        fused_k=(True if tier == "fusedk" else None))
    jt, jl, jstats = grow(jnp.asarray(bins), jnp.asarray(grad),
                          jnp.asarray(hess), jnp.asarray(member), jfm,
                          jnp.ones(GF, jnp.float32), jax.random.PRNGKey(0))
    pfm = ts.FeatureMeta(torch.full((GF,), GB, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32))
    g = FrontierGrower(GB, GrowerParams(num_leaves=L,
                                        split=ts.SplitParams(**sp)),
                       GRB, K, ratio, tier=tier)
    pt, pl = g.grow(torch.from_numpy(bins), torch.from_numpy(grad),
                    torch.from_numpy(hess), torch.from_numpy(member), pfm)
    n = int(jt.num_leaves)
    assert pt.num_leaves == n and n == L
    for name, m in (("split_feature", n - 1), ("threshold_bin", n - 1),
                    ("left_child", n - 1), ("right_child", n - 1),
                    ("leaf_parent", n), ("leaf_depth", n)):
        np.testing.assert_array_equal(getattr(pt, name)[:m],
                                      np.asarray(getattr(jt, name))[:m], name)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    # atol for leaves whose gradient sum nearly cancels (|value| ~ 1e-2):
    # there the sums' last-bit differences are a larger share of the value
    np.testing.assert_allclose(pt.leaf_value[:n], np.asarray(jt.leaf_value)
                               [:n], rtol=1e-5, atol=1e-6)
    jgain = np.asarray(jt.split_gain)[:n - 1]
    np.testing.assert_allclose(pt.split_gain[:n - 1], jgain, rtol=1e-5,
                               atol=1e-6 * float(jgain.max()))
    assert g.last_stats["K"] == min(K, L - 1)
    # the scanned-blocks count follows JAX's rule (stats slot 0)
    assert g.last_stats["scanned_blocks"] == int(np.asarray(jstats)[0])


def test_frontier_tiers_grow_the_same_tree(grower_data):
    """"off" and "k1" share the subtraction and grow the same bits;
    "fusedk" histograms both children from the data, so its sums differ
    in the last bits but its splits do not."""
    bins, grad, hess, member = grower_data
    pfm = ts.FeatureMeta(torch.full((GF,), GB, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32),
                         torch.zeros(GF, dtype=torch.int32))
    out = {}
    for tier in ("off", "k1", "fusedk"):
        g = FrontierGrower(GB, GrowerParams(
            num_leaves=15, split=ts.SplitParams(min_data_in_leaf=5.0)),
            GRB, 4, tier=tier)
        out[tier] = g.grow(torch.from_numpy(bins), torch.from_numpy(grad),
                           torch.from_numpy(hess), torch.from_numpy(member),
                           pfm)
        assert g.last_stats["rounds"] >= 4
    for tier in ("k1", "fusedk"):
        a, b = out["off"], out[tier]
        assert torch.equal(a[1], b[1])
        for name in ("split_feature", "threshold_bin", "left_child"):
            np.testing.assert_array_equal(getattr(a[0], name),
                                          getattr(b[0], name))
    np.testing.assert_array_equal(out["off"][0].leaf_value,
                                  out["k1"][0].leaf_value)


# ------------------------------------------------------------ the slice
N, NF, ITERS = 2000, 6, 3
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              tpu_row_chunk=256, verbosity=-1)


def _binary_data(seed=42):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < 0.05] = np.nan
    Xn = np.nan_to_num(X)
    y = (Xn[:, 0] + 0.5 * Xn[:, 1] - 0.3 * Xn[:, 2] ** 2
         + 0.2 * rng.normal(size=N) > 0).astype(np.float64)
    return X, y


def _trained(params, ds, iters=ITERS, **kw):
    bst = lt.Booster(dict(params, device_type="cpu"), ds, **kw)
    for _ in range(iters):
        bst.update()
    return bst


def _model(bst):
    return bst.model_to_string().split("parameters:")[0]


def test_width_one_grows_the_segment_trees():
    """K = 1: every round is one strict best-first split."""
    X, y = _binary_data(3)
    seg = _trained(PARAMS, lt.Dataset(X, y))
    fro = _trained(dict(PARAMS, tpu_tree_impl="frontier",
                        tpu_frontier_width=1), lt.Dataset(X, y))
    assert fro.gbdt.grower.tier == "k1" and fro.gbdt.grower.K == 1
    assert _model(seg) == _model(fro)


def test_tree_impl_auto_is_segment():
    """tpu_tree_impl="auto", the JAX package's default, is accepted and
    grows the segment grower's model."""
    X, y = _binary_data(4)
    auto = _trained(dict(PARAMS, tpu_tree_impl="auto"), lt.Dataset(X, y), 2)
    seg = _trained(dict(PARAMS, tpu_tree_impl="segment"),
                   lt.Dataset(X, y), 2)
    assert type(auto.gbdt.grower).__name__ == "SegmentGrower"
    assert _model(auto) == _model(seg)


@pytest.mark.parametrize("tier", ["off", "k1", "fusedk"])
def test_rounds_wider_than_a_launch_grow_the_same_model(monkeypatch, tier):
    """A round of more splits than one launch takes goes out as several
    launches, each over its own splits' windows, and grows the same model
    text: the capacity patched to 2 routes, width 4."""
    from lightgbm_tpu_torch.models import grower_frontier
    X, y = _binary_data(6)
    params = dict(PARAMS, tpu_tree_impl="frontier", tpu_frontier_width=4)
    whole = _trained(params, lt.Dataset(X, y), 2, frontier_tier=tier)
    kname = {"off": "histogram_frontier", "k1": "histogram_frontier_routed",
             "fusedk": "histogram_frontier_fusedk"}[tier]
    widths = []
    fn = getattr(grower_frontier, kname)

    def counted(*a, **k):
        widths.append(int(a[5].shape[0]))
        return fn(*a, **k)

    monkeypatch.setattr(grower_frontier.histogram, "FRONTIER_MAX_ROUTES", 2)
    monkeypatch.setattr(grower_frontier, kname, counted)
    chunked = _trained(params, lt.Dataset(X, y), 2, frontier_tier=tier)
    per = 2 if tier == "fusedk" else 1
    assert max(widths) == 2 * per and widths.count(2 * per) > 2
    assert _model(chunked) == _model(whole)


@pytest.mark.parametrize("params", [{"tpu_frontier_gain_ratio": 1.5},
                                    {"tpu_frontier_gain_ratio": -0.1},
                                    {"tpu_frontier_width": -1},
                                    {"tpu_tree_impl": "levelwise"}])
def test_bad_frontier_parameters_raise(params):
    with pytest.raises(lt.LightGBMError):
        lt.Config(device_type="cpu", **params)


def test_frontier_tier_needs_the_frontier_grower():
    X, y = _binary_data(5)
    with pytest.raises(lt.LightGBMError):
        lt.Booster(dict(PARAMS, device_type="cpu"), lt.Dataset(X, y),
                   frontier_tier="fusedk")
    with pytest.raises(ValueError):
        lt.Booster(dict(PARAMS, device_type="cpu", tpu_tree_impl="frontier"),
                   lt.Dataset(X, y), frontier_tier="k2")


# multiclass_cat-shaped data, as tests/test_torch_multiclass.py makes it
MC_C = 3
MC_CAT = [4, 5]
MC_PARAMS = dict(objective="multiclass", num_class=MC_C, num_leaves=15,
                 max_bin=63, tpu_row_chunk=256, verbosity=-1,
                 tpu_tree_impl="frontier", tpu_frontier_width=2)


def _mc_data(seed=42):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, NF))
    X[rng.uniform(size=(N, NF)) < 0.05] = np.nan
    c0 = rng.randint(0, 12, size=N).astype(np.float64)
    c0[rng.uniform(size=N) < 0.03] = np.nan
    c1 = rng.randint(0, 3, size=N).astype(np.float64)
    X[:, 4], X[:, 5] = c0, c1
    Xn = np.nan_to_num(X)
    logits = np.stack([Xn[:, 0] + 1.5 * (np.nan_to_num(c0) % 3 == k)
                       + 0.8 * (c1 == k) - 0.5 * Xn[:, 1] * (k - 1)
                       for k in range(MC_C)], axis=1)
    y = np.argmax(2 * logits + rng.gumbel(size=(N, MC_C)), axis=1)
    return X, y.astype(np.float64)


@pytest.fixture(scope="module")
def mc_pair():
    """(X, JAX GBDT, port Booster): multiclass softmax with categorical
    features through the frontier grower, K5 roots, identical bins."""
    X, y = _mc_data()
    cfg = JaxConfig(tpu_histogram_backend="pallas", **MC_PARAMS)
    jds = TpuDataset.from_numpy(X, y, config=cfg,
                                categorical_features=MC_CAT)
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = jgbdt.GBDT(cfg, jds, obj)
    assert jgb._use_segment
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    ds = convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y)
    bst = _trained(MC_PARAMS, ds)
    return X, jgb, bst


def test_multiclass_frontier_matches_jax(mc_pair):
    X, jgb, bst = mc_pair
    g = bst.gbdt.grower
    assert isinstance(g, FrontierGrower) and g.K == 2 and g.tier == "off"
    jt, pt = jgb.models, bst.gbdt.models
    assert len(jt) == len(pt) == ITERS * MC_C
    compared = cats = 0
    for i, (a, b) in enumerate(zip(jt, pt)):
        assert a.num_leaves == b.num_leaves, f"tree {i}"
        nf = a.num_leaves - 1
        k = 0
        while (k < nf and a.split_gain[k] > 1e-2
               and b.split_gain[k] > 1e-2):
            k += 1
        np.testing.assert_array_equal(a.split_feature[:k],
                                      b.split_feature[:k], f"tree {i}")
        np.testing.assert_array_equal(a.decision_type[:k] & 1,
                                      b.decision_type[:k] & 1, f"tree {i}")
        np.testing.assert_array_equal(a.threshold_in_bin[:k],
                                      b.threshold_in_bin[:k], f"tree {i}")
        cats += int(np.sum(a.decision_type[:k] & 1))
        compared += k
    assert compared >= 20 and cats >= 3
    assert np.abs(jgb._raw_predict(X).T
                  - bst.predict(X, raw_score=True)).max() < 1e-3


def test_frontier_model_loads_in_jax_package(mc_pair, tmp_path):
    X, _, bst = mc_pair
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    loaded = lightgbm_tpu.Booster(model_file=path)
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))


def test_binary_frontier_matches_jax():
    """Binary training through the frontier grower, K = 2 (auto at 15
    leaves would be 1), against the JAX package's frontier run."""
    X, y = _binary_data()
    params = dict(PARAMS, tpu_tree_impl="frontier", tpu_frontier_width=2)
    cfg = JaxConfig(tpu_histogram_backend="pallas", **params)
    jds = TpuDataset.from_numpy(X, y, config=cfg)
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = jgbdt.GBDT(cfg, jds, obj)
    for _ in range(ITERS):
        jgb.train_one_iter()
    jgb._flush_pending()
    bst = _trained(params, convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y))
    for i, (a, b) in enumerate(zip(jgb.models, bst.gbdt.models)):
        assert a.num_leaves == b.num_leaves == 15, f"tree {i}"
        np.testing.assert_array_equal(a.split_feature[:14],
                                      b.split_feature[:14], f"tree {i}")
        np.testing.assert_array_equal(a.threshold_in_bin[:14],
                                      b.threshold_in_bin[:14], f"tree {i}")
    assert np.abs(jgb._raw_predict(X)[0]
                  - bst.predict(X, raw_score=True)).max() < 1e-3
