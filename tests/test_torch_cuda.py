"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1-K7 at small shapes (K6/K7 with 16 routes and 32 target slots, at 64
and 256 bins), a categorical route taken from a real categorical split,
and binary and multiclass training, segment and frontier, with their
launch counts.  K1/K3 also over whole, short and empty windows with
targets that all, half, a few or no rows match, each K1 bit-identical to
K6's single slot, back to back at other shapes, and in a CUDA graph.
K6/K7 also: each call captured in a CUDA graph and
replayed (one launch, no synchronising copy), calls back to back at other
widths and shapes (the scratch they share is left zero), a frontier whose
slots tile across the grid, and the raises past the kernel's capacity.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: leaf ids and score updates bit-identical; counts exact;
gradient/hessian sums within 1e-5 x the bin's sum of |value| (the kernel
sums in 64-bit fixed point, the plain version in float64, both rounded to
float32 at the end); a second launch bit-identical to the first.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import kernels
from lightgbm_tpu_torch.ops import score as ts
from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitParams, best_split

RB = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(F, B, npad, seed):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, size=F).astype(np.int32)
    num_bin[0] = B
    fm = FeatureMeta(num_bin, (np.arange(F) % 3).astype(np.int32),
                     (num_bin // 3).astype(np.int32))
    bins = np.stack([rng.randint(0, nb, size=npad) for nb in num_bin]
                    ).astype(np.uint8)
    grad = rng.normal(size=npad).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=npad).astype(np.float32)
    member = np.ones(npad, np.float32)
    member[-77:] = 0.0
    lid = rng.randint(0, 4, size=npad).astype(np.int32)
    w8 = th.pack_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                          torch.from_numpy(member))
    return fm, torch.from_numpy(bins), w8, torch.from_numpy(lid)


def _routes(fm, F):
    bitset = np.array([0x5A5A5A5A, 0xFFFF0000, 1, 0, 7, 0, 0, 0x80000000],
                      np.uint32)
    none = np.zeros(8, np.uint32)
    # feature f has missing type f % 3: 1 zero-missing, 2 NaN-missing
    return [th.pack_route(1, 6, 0, int(fm.num_bin[0]) // 2, False, False,
                          none, fm),
            th.pack_route(2, 6, 1 % F, 3, True, False, none, fm),
            th.pack_route(0, 6, 2 % F, 2, True, False, none, fm),
            th.pack_route(3, 6, F - 1, 0, False, True, bitset, fm),
            th.null_route()]


def _assert_hist(got, want, w8, binsT, lid, lo, nblk, target, B):
    g = (w8[0].float() + w8[1].float()).abs()
    h = (w8[2].float() + w8[3].float()).abs()
    z = torch.zeros_like(g)
    scale = th.histogram_segment_plain(
        binsT, torch.stack([g, z, h, z, w8[4].float(), z, z, z]), lid, lo,
        nblk, target, B, RB).double()
    got, want = got.cpu().double(), want.double()
    assert torch.equal(got[..., 2], want[..., 2])
    assert ((got - want).abs()[..., :2]
            <= 1e-5 * scale[..., :2] + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(5, 64), (40, 64), (12, 256), (3, 16)])
def test_histogram_kernels_match_plain(dev, F, B):
    """K1 and K3 on every route case, including shapes whose shared
    histogram needs several feature tiles (40 x 64, 12 x 256)."""
    npad = 8 * RB
    fm, binsT, w8, lid = _inputs(F, B, npad, F + B)
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_scales = binsT.to(dev), w8.to(dev), scales.to(dev)
    for lo, nblk, target in ((0, 8, 1), (2, 3, 0), (5, 0, 2)):
        want = th.histogram_segment_plain(binsT, w8, lid, lo, nblk, target,
                                          B, RB)
        runs = [th.histogram_segment(d_bins, d_w8, lid.to(dev), lo, nblk,
                                     target, B, RB, d_scales)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
        _assert_hist(runs[0], want, w8, binsT, lid, lo, nblk, target, B)
    for route in _routes(fm, F):
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid.clone(), 1, 6, 6, route, B, RB)
        runs = []
        for _ in range(2):
            d_lid = lid.to(dev)
            got_lid, got = th.histogram_segment_routed(
                d_bins, d_w8, d_lid, 1, 6, 6, route, B, RB, d_scales)
            assert got_lid.data_ptr() == d_lid.data_ptr()
            runs.append((got_lid.cpu(), got.cpu()))
        assert torch.equal(runs[0][0], want_lid)
        assert torch.equal(runs[1][0], want_lid)
        assert torch.equal(runs[0][1], runs[1][1])
        _assert_hist(runs[0][1], want, w8, binsT, want_lid, 1, 6, 6, B)


def _segment_layout(F, B, seed):
    """16 row blocks: leaf 0 in blocks 0-7 (a target every row matches),
    then leaf 1 in about half the rows, leaf 2 in about 2% and leaf 3 in
    the rest; leaf 9 in none."""
    fm, binsT, w8, _ = _inputs(F, B, 16 * RB, seed)
    rng = np.random.RandomState(seed + 1)
    u = rng.uniform(size=8 * RB)
    tail = np.where(u < 0.5, 1, np.where(u < 0.52, 2, 3))
    lid = torch.from_numpy(np.concatenate(
        [np.zeros(8 * RB), tail]).astype(np.int32))
    return fm, binsT, w8, lid


# (start block, blocks): all of leaf 0, the mixed half, the whole layout,
# a few blocks, none
_SEG_WINDOWS = ((0, 8), (8, 8), (0, 16), (10, 3), (4, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(6, 64), (28, 64), (28, 256), (50, 256)])
def test_segment_kernels_windows_and_targets(dev, F, B):
    """K1 over windows of the whole layout, a few blocks and none, for
    targets that every row, half the rows, a sparse few or no row match;
    K3 on every route kind over the whole layout and a few blocks.  Each
    against its plain version, a relaunch bit-identical, and K1 of target
    t bit-identical to K6's single slot [t] over the same blocks.  40
    features at 256 bins take two feature tiles, 28 one."""
    fm, binsT, w8, lid = _segment_layout(F, B, F + B)
    tiling = th.segment_tiling(F, B)
    assert tiling["feature_tiles"] == (2 if F == 50 else 1)
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_lid = binsT.to(dev), w8.to(dev), lid.to(dev)
    d_scales = scales.to(dev)
    for lo, nblk in _SEG_WINDOWS:
        for target in (0, 1, 2, 9):
            want = th.histogram_segment_plain(binsT, w8, lid, lo, nblk,
                                              target, B, RB)
            runs = [th.histogram_segment(d_bins, d_w8, d_lid, lo, nblk,
                                         target, B, RB, d_scales)
                    for _ in range(2)]
            assert torch.equal(runs[0], runs[1])
            _assert_hist(runs[0], want, w8, binsT, lid, lo, nblk, target, B)
            blocks = torch.arange(lo, lo + nblk, dtype=torch.int32,
                                  device=dev)
            k6 = th.histogram_frontier(
                d_bins, d_w8, d_lid, blocks, nblk,
                torch.tensor([target], dtype=torch.int32), B, RB, d_scales)
            assert torch.equal(k6[0], runs[0]), (lo, nblk, target)
    for route in _routes(fm, F):
        for lo, nblk in ((0, 16), (10, 3)):
            for target in (6, int(route[0])):
                want_lid, want = th.histogram_segment_routed_plain(
                    binsT, w8, lid.clone(), lo, nblk, target, route, B, RB)
                runs = []
                for _ in range(2):
                    ids = d_lid.clone()
                    got_lid, got = th.histogram_segment_routed(
                        d_bins, d_w8, ids, lo, nblk, target, route, B, RB,
                        d_scales)
                    assert got_lid.data_ptr() == ids.data_ptr()
                    runs.append((got_lid.cpu(), got.cpu()))
                for got_lid, _ in runs:
                    assert torch.equal(got_lid, want_lid)
                assert torch.equal(runs[0][1], runs[1][1])
                _assert_hist(runs[0][1], want, w8, binsT, want_lid, lo, nblk,
                             target, B)


@pytest.mark.cuda
def test_segment_back_to_back_calls_and_cuda_graph(dev):
    """K1 and K3 one after another at other shapes (one and two feature
    tiles, 16 to 256 bins) share the scratch with K6: each equals its
    plain version and an empty window writes zeros, so the scratch and
    the arrival counters are zero again after every launch.  Then a K1
    and a K3 call are each captured in a CUDA graph (one launch, nothing
    that synchronises) and replayed bit for bit, leaf ids included."""
    for F, B in ((28, 64), (50, 256), (3, 16), (28, 256), (28, 64)):
        fm, binsT, w8, lid = _segment_layout(F, B, 7 * F + B)
        scales = th.fixed_point_scales(w8)
        d_bins, d_w8, d_lid = binsT.to(dev), w8.to(dev), lid.to(dev)
        d_scales = scales.to(dev)
        for lo, nblk in ((0, 16), (9, 2)):
            got = th.histogram_segment(d_bins, d_w8, d_lid, lo, nblk, 1, B,
                                       RB, d_scales)
            want = th.histogram_segment_plain(binsT, w8, lid, lo, nblk, 1, B,
                                              RB)
            _assert_hist(got, want, w8, binsT, lid, lo, nblk, 1, B)
            route = _routes(fm, F)[0]
            want_lid, want = th.histogram_segment_routed_plain(
                binsT, w8, lid.clone(), lo, nblk, 6, route, B, RB)
            got_lid, got = th.histogram_segment_routed(
                d_bins, d_w8, d_lid.clone(), lo, nblk, 6, route, B, RB,
                d_scales)
            assert torch.equal(got_lid.cpu(), want_lid)
            _assert_hist(got, want, w8, binsT, want_lid, lo, nblk, 6, B)
            empty = th.histogram_segment(d_bins, d_w8, d_lid, lo, 0, 1, B,
                                         RB, d_scales)
            assert empty.shape == (F, B, 3) and not empty.any()

    F, B = 28, 64
    fm, binsT, w8, lid = _segment_layout(F, B, 3)
    d_bins, d_w8 = binsT.to(dev), w8.to(dev)
    scales = th.fixed_point_scales(w8).to(dev)
    route = _routes(fm, F)[3]
    calls = {
        "histogram_segment": lambda ids: th.histogram_segment(
            d_bins, d_w8, ids, 0, 16, 1, B, RB, scales),
        "histogram_segment_routed": lambda ids: th.histogram_segment_routed(
            d_bins, d_w8, ids, 2, 12, 6, route, B, RB, scales)[1],
    }
    for name, call in calls.items():
        start = lid.to(dev)
        eager_ids = start.clone()
        eager = call(eager_ids)
        ids = start.clone()
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launches()
        kernels.CAPTURED.clear()
        with torch.cuda.graph(graph):
            got = call(ids)
        # a capture records one launch, which the card runs at a replay
        assert kernels.CAPTURED == {name: 1}
        assert kernels.LAUNCHES[name] == 0
        for _ in range(2):
            ids.copy_(start)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, eager), name
            assert torch.equal(ids, eager_ids), name


@pytest.mark.cuda
def test_route_window_matches_plain(dev):
    F, B, npad = 6, 64, 8 * RB
    fm, binsT, _, lid = _inputs(F, B, npad, 3)
    for route in _routes(fm, F)[:4]:
        for lo, nblk in ((0, 8), (1, 5), (7, 1)):
            want = th.route_window_plain(binsT, lid.clone(), lo, nblk, route,
                                         RB)
            got = th.route_window(binsT.to(dev), lid.to(dev), lo, nblk,
                                  route, RB).cpu()
            assert torch.equal(got, want)
            outside = torch.ones(npad, dtype=torch.bool)
            outside[lo * RB:(lo + nblk) * RB] = False
            assert torch.equal(got[outside], lid[outside])


def _offset_copy(t, offset, dev):
    """``t`` on the card as a contiguous view that starts ``offset``
    elements into a larger buffer (a data pointer off 16-byte
    alignment)."""
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
    flat[offset:] = t.reshape(-1).to(dev)
    return flat[offset:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("rb,offsets", [(256, (0, 0)), (20, (0, 0)),
                                        (256, (3, 1)), (20, (5, 2))])
def test_route_window_windows_and_alignments(dev, rb, offsets):
    """K2 bit for bit against the plain version on every route kind over
    whole, partial, single-block and empty windows, at row blocks whose
    windows start 16-byte aligned (256) or not (20), and with bins and
    leaf ids whose data starts off alignment (the rows before the aligned
    span, or every row when the two cannot align together, go one a
    thread); rows outside the window unchanged; one launch a call, even
    for an empty window, replayed identically from a CUDA graph."""
    F, B = 6, 64
    npad = 37 * rb
    fm, binsT, _, lid = _inputs(F, B, npad, 7)
    d_bins = _offset_copy(binsT, offsets[0], dev)
    nblk = npad // rb
    for route in _routes(fm, F):
        for lo, nb in ((0, nblk), (3, 17), (nblk - 1, 1), (5, 0),
                       (nblk - 2, 9)):
            want = th.route_window_plain(binsT, lid.clone(), lo, nb, route,
                                         rb)
            d_lid = _offset_copy(lid, offsets[1], dev)
            kernels.reset_launches()
            got = th.route_window(d_bins, d_lid, lo, nb, route, rb)
            assert kernels.LAUNCHES["route_window"] == 1
            assert got.data_ptr() == d_lid.data_ptr()
            assert torch.equal(got.cpu(), want), (route.tolist(), lo, nb)
    route = _routes(fm, F)[0]
    want = th.route_window_plain(binsT, lid.clone(), 2, 20, route, rb)
    d_lid = _offset_copy(lid, offsets[1], dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        th.route_window(d_bins, d_lid, 2, 20, route, rb)
    for _ in range(2):
        d_lid.copy_(lid.to(dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(d_lid.cpu(), want)


@pytest.mark.cuda
def test_route_table_equals_routed_leaf_on_every_bin_value(dev):
    """K2's route table against routed_leaf (K3's per-row route) on all
    256 bin values, for numeric, zero- and NaN-missing and categorical
    routes, split features of 256 bins and of fewer (values past a
    feature's bins map to its default bin): rows of every value, half of
    them in the routed leaf, give the same ids through K2, through K3 and
    through the plain version."""
    F, B, npad = 4, 256, 8 * RB
    rng = np.random.RandomState(12)
    num_bin = np.array([256, 40, 200, 17], np.int32)
    for missing in (0, 1, 2):
        fm = FeatureMeta(num_bin, np.full(F, missing, np.int32),
                         np.array([0, 7, 100, 16], np.int32))
        binsT = torch.from_numpy(np.tile(np.arange(256, dtype=np.uint8),
                                         (F, npad // 256)))
        w8 = th.pack_channels(torch.ones(npad), torch.ones(npad),
                              torch.ones(npad))
        lid = torch.from_numpy((np.arange(npad) // 256 % 2 * 3).astype(
            np.int32))
        d_bins, d_w8 = binsT.to(dev), w8.to(dev)
        scales = th.fixed_point_scales(w8).to(dev)
        for f in range(F):
            bitset = rng.randint(0, 2**32, size=8,
                                 dtype=np.uint64).astype(np.uint32)
            for cat, thr, dl in ((False, int(num_bin[f]) // 2, True),
                                 (False, 0, False), (True, 0, False)):
                route = th.pack_route(0, 9, f, thr, dl, cat, bitset, fm)
                want = th.route_window_plain(binsT, lid.clone(), 0, 8, route,
                                             RB)
                k2 = th.route_window(d_bins, lid.to(dev), 0, 8, route, RB)
                k3, _ = th.histogram_segment_routed(
                    d_bins, d_w8, lid.to(dev), 0, 8, -5, route, B, RB,
                    scales)
                assert torch.equal(k2.cpu(), want)
                assert torch.equal(k3.cpu(), want)
                assert int((want == 9).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("F,B,C", [(28, 256, 5), (30, 256, 3), (3, 16, 1),
                                   (50, 64, 12), (7, 256, 40)])
def test_histogram_all_tilings_and_cuda_graph(dev, F, B, C):
    """K5 at shapes that take one tile, several feature tiles, several
    set tiles or both (all_tiling): each class slice bit-identical to K1
    on a root of that class, the plain version within tolerance, a
    relaunch and a CUDA graph's replay bit-identical, one launch a call,
    and K1 after it unchanged (the scratch they share is left zero)."""
    npad = 5 * RB
    rng = np.random.RandomState(F + B + C)
    binsT = torch.from_numpy(rng.randint(0, B, size=(F, npad)).astype(
        np.uint8))
    grads = torch.from_numpy(rng.normal(size=(C, npad)).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.01, 0.25, size=(C, npad)).astype(
        np.float32))
    member = torch.ones(npad)
    member[-77:] = 0.0
    w8C = th.pack_channel_sets(grads, hess, member)
    scales = th.class_scales(w8C)
    d_bins, d_w8C, d_scales = binsT.to(dev), w8C.to(dev), scales.to(dev)
    tiling = th.all_tiling(F, B, C)
    assert tiling["smem_bytes"] == 20 * B * tiling["tile_features"] \
        * tiling["tile_sets"]
    kernels.reset_launches()
    a = th.histogram_all(d_bins, d_w8C, B, d_scales)
    assert kernels.LAUNCHES["histogram_all"] == 1
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    roots = [th.histogram_segment(d_bins, d_w8C[8 * c:8 * c + 8], lid0, 0,
                                  5, 0, B, RB, d_scales[c].contiguous())
             for c in range(C)]
    out = torch.empty_like(a)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(th.histogram_all(d_bins, d_w8C, B, d_scales))
    graph.replay()
    b = th.histogram_all(d_bins, d_w8C, B, d_scales)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, out)
    for c in range(C):
        assert torch.equal(a[c], roots[c]), c
    want = th.histogram_all_plain(binsT, w8C, B)
    for c in range(0, C, max(1, C // 4)):
        _assert_hist(a[c].cpu(), want[c], w8C[8 * c:8 * c + 8], binsT,
                     lid0.cpu(), 0, 5, 0, B)
    again = th.histogram_segment(d_bins, d_w8C[:8], lid0, 0, 5, 0, B, RB,
                                 d_scales[0].contiguous())
    assert torch.equal(again, roots[0])


@pytest.mark.cuda
def test_frontier_wider_than_a_launch_trains_and_matches_cpu(dev):
    """Rounds of more splits than one launch takes (FRONTIER_MAX_ROUTES
    routes, FRONTIER_MAX_TARGETS targets) go out as several launches:
    num_leaves=600 at tpu_frontier_width=300, and 1100 leaves, whose tenth
    round splits 300 leaves (fused-K: 600 targets).  The card grows the
    CPU path's tree, model text for model text: L2 regression on integer
    labels from a zero start, so every gradient sum is an exact integer on
    both paths and no split is decided by rounding."""
    rng = np.random.RandomState(3)
    n = 60_000
    X = rng.normal(size=(n, 8))
    y = np.clip(np.round(4 * X[:, 0] + 3 * X[:, 1] * X[:, 2]
                         + rng.normal(size=n)), -20, 20)
    kernel = {"off": "histogram_frontier",
              "fusedk": "histogram_frontier_fusedk"}
    for leaves, tier in ((600, "off"), (1100, "off"), (1100, "fusedk")):
        params = dict(objective="regression", boost_from_average=False,
                      num_leaves=leaves, max_bin=63, min_data_in_leaf=5,
                      verbosity=-1, tpu_tree_impl="frontier",
                      tpu_frontier_width=300)
        texts = {}
        for device in ("cuda", "cpu"):
            bst = lt.Booster(dict(params, device_type=device),
                             lt.Dataset(X, y), frontier_tier=tier)
            total = _count_rounds(bst)
            kernels.reset_launches()
            bst.update()
            assert bst.gbdt.models[0].num_leaves == leaves
            texts[device] = bst.model_to_string().split("parameters:")[0]
            if device == "cuda":
                launched = kernels.LAUNCHES[kernel[tier]]
                assert launched >= total["rounds"] + 1
                if leaves == 1100:
                    assert launched > total["rounds"] + 1
        assert texts["cuda"] == texts["cpu"], (leaves, tier)


@pytest.mark.cuda
def test_score_gather_add_bit_identical(dev):
    rng = np.random.RandomState(5)
    n, L = 100_003, 255
    score = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    lid = torch.from_numpy(rng.randint(-2, L + 3, size=n).astype(np.int32))
    table = torch.from_numpy(rng.normal(size=L).astype(np.float32))
    want = ts.score_gather_add_plain(score, lid, table)
    got = ts.score_gather_add(score.to(dev), lid.to(dev), table.to(dev))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_score_gather_add_in_place_row(dev):
    """K4 in place into one row of a [C, N] score, as the multiclass loop
    calls it; the other rows stay as they were."""
    rng = np.random.RandomState(6)
    C, n, L = 5, 100_003, 31
    score = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    lid = torch.from_numpy(rng.randint(0, L, size=n).astype(np.int32))
    table = torch.from_numpy(rng.normal(size=L).astype(np.float32))
    want = ts.score_gather_add_plain(score[3], lid, table)
    got = score.to(dev)
    row = got[3]
    ret = ts.score_gather_add(row, lid.to(dev), table.to(dev), out=row)
    assert ret.data_ptr() == row.data_ptr()
    got = got.cpu()
    assert torch.equal(got[3].view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[[0, 1, 2, 4]], score[[0, 1, 2, 4]])


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    fm, binsT, w8, lid = _inputs(4, 64, 4 * RB, 1)
    d_bins, d_w8 = binsT.to(dev), w8.to(dev)
    scales = th.fixed_point_scales(w8).to(dev)
    with pytest.raises(TypeError):
        th.histogram_segment(d_bins, d_w8, lid.long().to(dev), 0, 4, 0, 64,
                             RB, scales)
    with pytest.raises(ValueError):
        th.histogram_segment(d_bins, d_w8, lid, 0, 4, 0, 64, RB, scales)
    with pytest.raises(ValueError):
        th.route_window(d_bins, lid.to(dev), 0, 4, th.null_route().to(dev),
                        RB)


def _count_replays(bst):
    """Wraps the booster's segment grower to sum its replays over trees
    and keep each tree's stats."""
    g = bst.gbdt.grower
    grow, total = g.grow, {"replays": 0, "stats": []}

    def counted(*a, **k):
        out = grow(*a, **k)
        total["replays"] += g.last_stats["replays"]
        total["stats"].append(dict(g.last_stats))
        return out

    g.grow = counted
    return total


@pytest.mark.cuda
def test_training_on_card_counts_launches_and_matches_cpu(dev):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(20_000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=20_000)
         > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  verbosity=-1)
    texts, raws = {}, {}
    for device, fused in (("cuda", True), ("cuda", False), ("cpu", True)):
        bst = lt.Booster(dict(params, device_type=device), lt.Dataset(X, y),
                         fused_route=fused)
        total = _count_replays(bst)
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        n = dict(kernels.LAUNCHES)
        # the roots by value; the splits' steps in graph replays, and the
        # one step the capture runs first
        steps = bst.gbdt.grower.steps * total["replays"] + 1
        if device == "cuda" and fused:
            assert n["histogram_segment_routed"] == 3
            assert n["histogram_segment_routed_step"] == steps
            assert (n["histogram_segment"] == n["route_window"]
                    == n["histogram_segment_step"]
                    == n["route_window_step"] == 0)
        elif device == "cuda":
            assert n["histogram_segment"] == 3
            assert n["route_window_step"] == n["histogram_segment_step"] \
                == steps
            assert (n["histogram_segment_routed"] == n["route_window"]
                    == n["histogram_segment_routed_step"] == 0)
        else:
            assert sum(n.values()) == 0
        if device == "cuda":
            assert n["score_gather_add"] == 3
        texts[(device, fused)] = bst.model_to_string().split("parameters:")[0]
        raws[(device, fused)] = bst.predict(X, raw_score=True)
    assert texts[("cuda", True)] == texts[("cuda", False)]
    assert np.abs(raws[("cuda", True)] - raws[("cpu", True)]).max() < 1e-3


@pytest.mark.cuda
def test_histogram_all_matches_plain_and_k1_roots(dev):
    """K5 with C = 3 sets at 256 bins: counts exact,
    sums within tolerance, a relaunch bit-identical, and each class slice
    bit-identical to K1 and to K3 with the null route on a root of that
    class at the class's scale."""
    F, B, C, npad = 30, 256, 3, 8 * RB
    rng = np.random.RandomState(11)
    binsT = torch.from_numpy(rng.randint(0, B, size=(F, npad)).astype(
        np.uint8))
    grads = torch.from_numpy(rng.normal(size=(C, npad)).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.01, 0.25, size=(C, npad)).astype(
        np.float32))
    member = torch.ones(npad)
    member[-77:] = 0.0
    w8C = th.pack_channel_sets(grads, hess, member)
    scales = th.class_scales(w8C)
    want = th.histogram_all_plain(binsT, w8C, B)
    d_bins, d_w8C, d_scales = binsT.to(dev), w8C.to(dev), scales.to(dev)
    runs = [th.histogram_all(d_bins, d_w8C, B, d_scales) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    lid0 = torch.zeros(npad, dtype=torch.int32)
    for c in range(C):
        w8 = w8C[8 * c:8 * c + 8].contiguous()
        _assert_hist(runs[0][c], want[c], w8, binsT, lid0, 0, 8, 0, B)
        k1 = th.histogram_segment(d_bins, w8.to(dev), lid0.to(dev), 0, 8, 0,
                                  B, RB, d_scales[c].contiguous())
        _, k3 = th.histogram_segment_routed(
            d_bins, w8.to(dev), lid0.to(dev), 0, 8, 0, th.null_route(), B,
            RB, d_scales[c].contiguous())
        assert torch.equal(runs[0][c], k1) and torch.equal(runs[0][c], k3)


@pytest.mark.cuda
def test_categorical_route_from_best_split(dev):
    """K3 routes by the bitset a categorical best_split chose, at 256
    bins."""
    F, B, npad = 4, 256, 8 * RB
    rng = np.random.RandomState(2)
    num_bin = np.array([256, 40, 200, 3], np.int32)
    fm = FeatureMeta(num_bin, np.array([0, 2, 0, 0], np.int32),
                     np.array([0, 1, 1, 1], np.int32))
    binsT = torch.from_numpy(np.stack(
        [rng.randint(0, nb, size=npad) for nb in num_bin]).astype(np.uint8))
    effect = rng.normal(size=256).astype(np.float32)
    grad = torch.from_numpy(effect[binsT[2].numpy()]
                            + 0.1 * rng.normal(size=npad).astype(np.float32))
    hess = torch.ones(npad)
    member = torch.ones(npad)
    w8 = th.pack_channels(grad, hess, member)
    lid = torch.zeros(npad, dtype=torch.int32)
    root = th.histogram_segment_plain(binsT, w8, lid, 0, 8, 0, B, RB)
    tfm = FeatureMeta(*(torch.from_numpy(a) for a in fm[:3]),
                      torch.tensor([False, True, True, True]))
    info = best_split(root[None], grad.sum()[None], hess.sum()[None],
                      member.sum()[None], tfm, SplitParams(has_cat=True))
    assert bool(info.is_cat[0]) and int(info.feature[0]) == 2
    bitset = info.cat_bitset[0].numpy().astype(np.uint32)
    route = th.pack_route(0, 1, 2, int(info.threshold[0]), False, True,
                          bitset, fm)
    want_lid, want = th.histogram_segment_routed_plain(
        binsT, w8, lid.clone(), 0, 8, 1, route, B, RB)
    d_lid = lid.to(dev)
    got_lid, got = th.histogram_segment_routed(
        binsT.to(dev), w8.to(dev), d_lid, 0, 8, 1, route, B, RB,
        th.fixed_point_scales(w8).to(dev))
    assert torch.equal(got_lid.cpu(), want_lid)
    assert 0 < int((want_lid == 1).sum()) < npad
    _assert_hist(got.cpu(), want, w8, binsT, want_lid, 0, 8, 1, B)


@pytest.mark.cuda
def test_multiclass_training_on_card_counts_launches_and_matches_cpu(dev):
    rng = np.random.RandomState(1)
    n, C = 20_000, 3
    X = rng.normal(size=(n, 6))
    X[:, 5] = rng.randint(0, 10, size=n)
    logits = np.stack([X[:, 0] * (k - 1) + (X[:, 5] % 3 == k)
                       for k in range(C)], axis=1)
    y = np.argmax(2 * logits + rng.gumbel(size=(n, C)), axis=1)
    params = dict(objective="multiclass", num_class=C, num_leaves=15,
                  verbosity=-1)
    raws = {}
    for device in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=device),
                         lt.Dataset(X, y, categorical_feature=[5]))
        total = _count_replays(bst)
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        n_l = dict(kernels.LAUNCHES)
        trees = bst.gbdt.models
        assert len(trees) == 3 * C and any(t.num_cat for t in trees)
        if device == "cuda":
            # the roots come from K5; the splits are graph-replayed steps
            assert n_l["histogram_all"] == 3
            assert n_l["histogram_segment_routed"] == 0
            assert n_l["histogram_segment_routed_step"] == (
                bst.gbdt.grower.steps * total["replays"] + 1)
            assert n_l["score_gather_add"] == sum(
                t.num_leaves > 1 for t in trees)
        else:
            assert sum(n_l.values()) == 0
        raws[device] = bst.predict(X, raw_score=True)
    assert np.abs(raws["cuda"] - raws["cpu"]).max() < 1e-3


def _frontier_round(F, B, K, npad, seed):
    """A frontier round's inputs: leaf ids 0..2K-1 laid out in runs, the
    K routes of leaves 0..K-1 (new leaves 2K..3K-1; numeric, NaN- and
    zero-missing, categorical, and a null route in the last slot), and
    the union of a few block windows."""
    fm, binsT, w8, _ = _inputs(F, B, npad, seed)
    rng = np.random.RandomState(seed)
    lid = torch.from_numpy(np.sort(rng.randint(0, 2 * K, size=npad)).astype(
        np.int32))
    routes = []
    for k in range(K):
        f = k % F
        cat = k % 4 == 3
        bitset = rng.randint(0, 2**32, size=8, dtype=np.uint64).astype(
            np.uint32)
        routes.append(th.pack_route(k, 2 * K + k, f, int(fm.num_bin[f]) // 2,
                                    k % 2 == 1, cat, bitset, fm)
                      if k < K - 1 else th.null_route())
    nblk = npad // RB
    bl, n = th.union_block_list([0, 2, nblk // 2, nblk - 3],
                                [3, 5, nblk // 2 + 2, nblk],
                                [True] * 4)
    return binsT, w8, lid, torch.stack(routes), bl, n


def _assert_frontier(got, want, w8, binsT, lid, bl, n, targets, B):
    g = (w8[0].float() + w8[1].float()).abs()
    h = (w8[2].float() + w8[3].float()).abs()
    z = torch.zeros_like(g)
    scale = th.histogram_frontier_plain(
        binsT, torch.stack([g, z, h, z, w8[4].float(), z, z, z]), lid, bl, n,
        targets, B, RB).double()
    got, want = got.cpu().double(), want.double()
    assert torch.equal(got[..., 2], want[..., 2])
    assert ((got - want).abs()[..., :2]
            <= 1e-5 * scale[..., :2] + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 256])
def test_frontier_kernels_match_plain(dev, B):
    """K6, K7 routed (KT = K = 16) and K7 fused-K (KT = 32) against their
    plain versions; at 256 bins the 32 slots of one feature (160 KB) fill
    most of a block's shared memory, one feature a tile."""
    F, K, npad = 6, 16, 16 * RB
    binsT, w8, lid, routes, bl, n = _frontier_round(F, B, K, npad, B)
    tiling = th.frontier_tiling(F, B, 2 * K, K, 3 * K)
    assert tiling["target_tiles"] == 1
    assert tiling["smem_bytes"] > 48 * 1024
    scales = th.fixed_point_scales(w8)
    d = dict(binsT=binsT.to(dev), w8=w8.to(dev), bl=bl.to(dev),
             scales=scales.to(dev))
    smaller = torch.tensor([k if k % 3 else 2 * K + k for k in range(K - 1)]
                           + [-1], dtype=torch.int32)
    targets2 = torch.tensor(list(range(K - 1)) + [-1]
                            + list(range(2 * K, 3 * K - 1)) + [-1],
                            dtype=torch.int32)
    # K6 on ids already routed (the "off" tier's K2 ran first)
    routed_lid, _ = th.histogram_frontier_routed_plain(
        binsT, w8, lid.clone(), bl, n, smaller, routes, B, RB)
    want = th.histogram_frontier_plain(binsT, w8, routed_lid, bl, n, smaller,
                                       B, RB)
    runs = [th.histogram_frontier(d["binsT"], d["w8"], routed_lid.to(dev),
                                  d["bl"], n, smaller, B, RB, d["scales"])
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _assert_frontier(runs[0], want, w8, binsT, routed_lid, bl, n, smaller, B)
    assert not runs[0][K - 1].any()
    for fn, targets in ((th.histogram_frontier_routed, smaller),
                        (th.histogram_frontier_fusedk, targets2)):
        want_lid, want = th.histogram_frontier_routed_plain(
            binsT, w8, lid.clone(), bl, n, targets, routes, B, RB)
        assert not torch.equal(want_lid, lid)
        runs = []
        for _ in range(2):
            d_lid = lid.to(dev)
            got_lid, got = fn(d["binsT"], d["w8"], d_lid, d["bl"], n,
                              targets, routes, B, RB, d["scales"])
            assert got_lid.data_ptr() == d_lid.data_ptr()
            runs.append((got_lid.cpu(), got.cpu()))
        for got_lid, _ in runs:
            assert torch.equal(got_lid, want_lid)
        assert torch.equal(runs[0][1], runs[1][1])
        _assert_frontier(runs[0][1], want, w8, binsT, want_lid, bl, n,
                         targets, B)
    # n_blocks == 0: zero histograms, leaf ids untouched
    d_lid = lid.to(dev)
    _, empty = th.histogram_frontier_fusedk(
        d["binsT"], d["w8"], d_lid, d["bl"], 0, targets2, routes, B, RB,
        d["scales"])
    assert not empty.any() and torch.equal(d_lid.cpu(), lid)


@pytest.mark.cuda
def test_frontier_wrappers_reject_bad_inputs(dev):
    binsT, w8, lid, routes, bl, n = _frontier_round(4, 64, 4, 8 * RB, 2)
    d_bins, d_w8, d_lid, d_bl = (binsT.to(dev), w8.to(dev), lid.to(dev),
                                 bl.to(dev))
    scales = th.fixed_point_scales(w8).to(dev)
    t4 = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        th.histogram_frontier(d_bins, d_w8, lid.long().to(dev), d_bl, n, t4,
                              64, RB, scales)
    with pytest.raises(TypeError):
        th.histogram_frontier(d_bins, d_w8, d_lid, bl.long().to(dev), n, t4,
                              64, RB, scales)
    with pytest.raises(ValueError):       # block list on the host
        th.histogram_frontier(d_bins, d_w8, d_lid, bl, n, t4, 64, RB, scales)
    with pytest.raises(ValueError):       # more blocks than listed
        th.histogram_frontier(d_bins, d_w8, d_lid, d_bl, n + 1, t4, 64, RB,
                              scales)
    with pytest.raises(ValueError):       # fused-K takes 2K targets
        th.histogram_frontier_fusedk(d_bins, d_w8, d_lid, d_bl, n, t4,
                                     routes, 64, RB, scales)
    with pytest.raises(ValueError):       # w8 [8, Npad]
        th.histogram_frontier_routed(d_bins, d_w8[:5].contiguous(), d_lid,
                                     d_bl, n, t4, routes, 64, RB, scales)


def _frontier_targets(K):
    """The smaller children of _frontier_round's K splits (the last slot
    empty), and all 2K children for fused-K."""
    smaller = torch.tensor([k if k % 3 else 2 * K + k for k in range(K - 1)]
                           + [-1], dtype=torch.int32)
    targets2 = torch.tensor(list(range(K - 1)) + [-1]
                            + list(range(2 * K, 3 * K - 1)) + [-1],
                            dtype=torch.int32)
    return smaller, targets2


@pytest.mark.cuda
def test_frontier_kernels_replay_in_a_cuda_graph(dev):
    """A K6 call and a K7 call (routed and fused-K) are each one kernel
    launch with no synchronising copy: each is captured in a CUDA graph
    (a stream sync or a pageable copy would make the capture fail), and
    its replays equal the eager call, leaf ids included."""
    F, B, K, npad = 6, 64, 8, 16 * RB
    binsT, w8, lid, routes, bl, n = _frontier_round(F, B, K, npad, 5)
    smaller, targets2 = _frontier_targets(K)
    d_bins, d_w8, d_bl = binsT.to(dev), w8.to(dev), bl.to(dev)
    scales = th.fixed_point_scales(w8).to(dev)
    routed_lid, _ = th.histogram_frontier_routed_plain(
        binsT, w8, lid.clone(), bl, n, smaller, routes, B, RB)
    calls = {
        "histogram_frontier": (routed_lid, lambda ids: th.histogram_frontier(
            d_bins, d_w8, ids, d_bl, n, smaller, B, RB, scales)),
        "histogram_frontier_routed": (lid, lambda ids: (
            th.histogram_frontier_routed(d_bins, d_w8, ids, d_bl, n, smaller,
                                         routes, B, RB, scales)[1])),
        "histogram_frontier_fusedk": (lid, lambda ids: (
            th.histogram_frontier_fusedk(d_bins, d_w8, ids, d_bl, n, targets2,
                                         routes, B, RB, scales)[1])),
    }
    for name, (start, call) in calls.items():
        start = start.to(dev)
        eager_ids = start.clone()
        eager = call(eager_ids)   # first use: build, scratch, opt-in
        ids = start.clone()
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launches()
        kernels.CAPTURED.clear()
        with torch.cuda.graph(graph):
            got = call(ids)
        # a capture records one launch, which the card runs at a replay
        assert kernels.CAPTURED == {name: 1}
        assert kernels.LAUNCHES[name] == 0
        for _ in range(2):
            ids.copy_(start)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, eager), name
            assert torch.equal(ids, eager_ids), name


@pytest.mark.cuda
def test_frontier_back_to_back_calls_match_plain(dev):
    """Launches one after another at other widths, shapes and block lists
    share the scratch: each equals its plain version, so the scratch and
    the tiles' arrival counters are zero again after every launch.  The
    widths include K = 16 at 256 bins (32 slots of 160 KB in one block)
    and 48 routes, whose 96 slots at 256 bins tile across the grid; after
    each width a launch over no blocks writes zeros and leaves the leaf
    ids alone."""
    cases = ((6, 64, 16, 0), (5, 256, 16, 1), (3, 256, 48, 2),
             (9, 16, 4, 3), (6, 64, 16, 4))
    for F, B, K, seed in cases:
        binsT, w8, lid, routes, bl, n = _frontier_round(F, B, K, 16 * RB,
                                                        seed)
        smaller, targets2 = _frontier_targets(K)
        tiling = th.frontier_tiling(F, B, 2 * K, K, 3 * K)
        assert (tiling["target_tiles"] > 1) == (K == 48)
        d = dict(binsT=binsT.to(dev), w8=w8.to(dev), bl=bl.to(dev),
                 scales=th.fixed_point_scales(w8).to(dev))
        routed_lid, _ = th.histogram_frontier_routed_plain(
            binsT, w8, lid.clone(), bl, n, smaller, routes, B, RB)
        want = th.histogram_frontier_plain(binsT, w8, routed_lid, bl, n,
                                           smaller, B, RB)
        got = th.histogram_frontier(d["binsT"], d["w8"], routed_lid.to(dev),
                                    d["bl"], n, smaller, B, RB, d["scales"])
        _assert_frontier(got, want, w8, binsT, routed_lid, bl, n, smaller, B)
        for fn, targets in ((th.histogram_frontier_routed, smaller),
                            (th.histogram_frontier_fusedk, targets2)):
            want_lid, want = th.histogram_frontier_routed_plain(
                binsT, w8, lid.clone(), bl, n, targets, routes, B, RB)
            got_lid, got = fn(d["binsT"], d["w8"], lid.to(dev), d["bl"], n,
                              targets, routes, B, RB, d["scales"])
            assert torch.equal(got_lid.cpu(), want_lid)
            _assert_frontier(got, want, w8, binsT, want_lid, bl, n, targets,
                             B)
            d_lid = lid.to(dev)
            _, empty = fn(d["binsT"], d["w8"], d_lid, d["bl"], 0, targets,
                          routes, B, RB, d["scales"])
            assert not empty.any() and torch.equal(d_lid.cpu(), lid)


@pytest.mark.cuda
def test_frontier_wrappers_raise_past_their_capacity(dev):
    """More routes or targets than the launch's parameter block holds, or
    leaf ids whose tables leave no room for a slot, raise with the
    reason."""
    binsT, w8, lid, routes, bl, n = _frontier_round(4, 64, 4, 8 * RB, 2)
    d_bins, d_w8, d_lid, d_bl = (binsT.to(dev), w8.to(dev), lid.to(dev),
                                 bl.to(dev))
    scales = th.fixed_point_scales(w8).to(dev)
    K = th.FRONTIER_MAX_ROUTES + 1
    wide = torch.stack([th.null_route()] * K)
    with pytest.raises(ValueError, match="parameter block"):
        th.histogram_frontier_routed(d_bins, d_w8, d_lid, d_bl, n,
                                     torch.arange(K, dtype=torch.int32),
                                     wide, 64, RB, scales)
    with pytest.raises(ValueError, match="parameter block"):
        th.histogram_frontier(d_bins, d_w8, d_lid, d_bl, n, torch.arange(
            th.FRONTIER_MAX_TARGETS + 1, dtype=torch.int32), 64, RB, scales)
    with pytest.raises(ValueError, match="leaf tables"):
        th.histogram_frontier(d_bins, d_w8, d_lid, d_bl, n, torch.tensor(
            [0, 1 << 20], dtype=torch.int32), 64, RB, scales)
    assert torch.equal(d_lid.cpu(), lid)


def _count_rounds(bst):
    """Wraps the booster's frontier grower to sum its rounds over trees."""
    g = bst.gbdt.grower
    grow, total = g.grow, {"rounds": 0, "trees": 0}

    def counted(*a, **k):
        out = grow(*a, **k)
        total["rounds"] += g.last_stats["rounds"]
        total["trees"] += 1
        return out

    g.grow = counted
    return total


@pytest.mark.cuda
def test_frontier_training_on_card_counts_launches_and_matches_cpu(dev):
    """Binary training through the frontier grower on each tier (K = 4),
    and multiclass through it from K5 roots: launch counts, card against
    CPU, and "off" against "k1" (the same sums, the same bits)."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(20_000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=20_000)
         > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  verbosity=-1, tpu_tree_impl="frontier",
                  tpu_frontier_width=4)
    kernel = {"off": "histogram_frontier", "k1": "histogram_frontier_routed",
              "fusedk": "histogram_frontier_fusedk"}
    texts, raws = {}, {}
    for device, tier in (("cuda", "off"), ("cuda", "k1"), ("cuda", "fusedk"),
                         ("cpu", "off")):
        bst = lt.Booster(dict(params, device_type=device), lt.Dataset(X, y),
                         frontier_tier=tier)
        total = _count_rounds(bst)
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        n = dict(kernels.LAUNCHES)
        splits = sum(t.num_leaves - 1 for t in bst.gbdt.models)
        if device == "cuda":
            assert n[kernel[tier]] == total["rounds"] + total["trees"]
            assert n["route_window"] == (splits if tier == "off" else 0)
            assert n["score_gather_add"] == 3
            assert sum(n.values()) == (n[kernel[tier]] + n["route_window"]
                                       + 3)
        else:
            assert sum(n.values()) == 0
        texts[(device, tier)] = bst.model_to_string().split("parameters:")[0]
        raws[(device, tier)] = bst.predict(X, raw_score=True)
    assert texts[("cuda", "off")] == texts[("cuda", "k1")]
    for key in (("cuda", "off"), ("cuda", "fusedk")):
        assert np.abs(raws[key] - raws[("cpu", "off")]).max() < 1e-3

    X[:, 5] = rng.randint(0, 10, size=len(X))
    yc = np.argmax(np.stack([X[:, 0] * (k - 1) + (X[:, 5] % 3 == k)
                             for k in range(3)], axis=1)
                   + rng.gumbel(size=(len(X), 3)), axis=1)
    mc = dict(objective="multiclass", num_class=3, num_leaves=15,
              verbosity=-1, tpu_tree_impl="frontier", tpu_frontier_width=2)
    mraws = {}
    for device in ("cuda", "cpu"):
        bst = lt.Booster(dict(mc, device_type=device),
                         lt.Dataset(X, yc, categorical_feature=[5]))
        total = _count_rounds(bst)
        kernels.reset_launches()
        for _ in range(2):
            bst.update()
        n = dict(kernels.LAUNCHES)
        if device == "cuda":
            # the roots come from K5, so K6 runs once a round
            assert n["histogram_all"] == 2
            assert n["histogram_frontier"] == total["rounds"]
        mraws[device] = bst.predict(X, raw_score=True)
    assert np.abs(mraws["cuda"] - mraws["cpu"]).max() < 1e-3


# ------------------------------------------------ the device loop (K1-K3)
# the layout's windows: whole (a first split), a late window of a few
# blocks, the last block, none
_STEP_WINDOWS = ((0, 16), (10, 3), (15, 1), (4, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 64), (28, 256), (50, 256)])
def test_step_entries_equal_by_value_entries(dev, F, B):
    """K1, K2 and K3 reading their window, target and route from a step
    block in device memory give their by-value entries' histograms and
    leaf ids bit for bit, over whole, late, one-block and empty windows,
    on every route kind (a categorical bitset included) and a route whose
    bin row lies outside binsT (it routes nothing); and the plain
    versions' ids, counts and sums within tolerance."""
    fm, binsT, w8, lid = _segment_layout(F, B, 3 * F + B)
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_lid = binsT.to(dev), w8.to(dev), lid.to(dev)
    d_scales = scales.to(dev)
    outside = _routes(fm, F)[0].clone()
    outside[2] = F
    for route in _routes(fm, F) + [outside]:
        for lo, nblk in _STEP_WINDOWS:
            for target in (6, int(route[0]), 9):
                step = th.pack_step(lo, nblk, target, route).to(dev)
                by_ids = d_lid.clone()
                if int(route[2]) < F:
                    _, by_hist = th.histogram_segment_routed(
                        d_bins, d_w8, by_ids, lo, nblk, target, route, B,
                        RB, d_scales)
                else:
                    by_hist = th.histogram_segment(
                        d_bins, d_w8, by_ids, lo, nblk, target, B, RB,
                        d_scales)
                ids = d_lid.clone()
                out = torch.full((F, B, 3), 7.0, device=dev)
                got_ids, got = th.histogram_segment_routed_step(
                    d_bins, d_w8, ids, step, B, RB, d_scales, out=out)
                assert got_ids is ids and got is out
                assert torch.equal(ids, by_ids) and torch.equal(got, by_hist)
                k2 = th.route_window_step(d_bins, d_lid.clone(), step, RB)
                assert torch.equal(k2, by_ids)
                k1 = th.histogram_segment_step(d_bins, d_w8, by_ids, step, B,
                                               RB, d_scales)
                assert torch.equal(k1, th.histogram_segment(
                    d_bins, d_w8, by_ids, lo, nblk, target, B, RB, d_scales))
                want_ids, want = th.histogram_segment_routed_step_plain(
                    binsT, w8, lid.clone(), step.cpu(), B, RB)
                assert torch.equal(ids.cpu(), want_ids)
                _assert_hist(got, want, w8, binsT, want_ids, lo, nblk,
                             target, B)
                if nblk == 0:
                    assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("rb,offsets", [(256, (0, 0)), (20, (0, 0)),
                                        (256, (1, 0)), (256, (3, 2)),
                                        (20, (5, 1))])
def test_route_window_step_windows_and_alignments(dev, rb, offsets):
    """K2 from a step block computes its aligned span on the card from the
    row it read, over bins and ids at any alignment: bit for bit
    route_window's ids."""
    F, B = 6, 64
    npad = 37 * rb
    fm, binsT, _, lid = _inputs(F, B, npad, 7)
    d_bins = _offset_copy(binsT, offsets[0], dev)
    nblk = npad // rb
    for route in _routes(fm, F):
        for lo, nb in ((0, nblk), (3, 17), (nblk - 1, 1), (5, 0),
                       (nblk - 2, 9)):
            want = th.route_window(d_bins, _offset_copy(lid, offsets[1], dev),
                                   lo, nb, route, rb)
            d_lid = _offset_copy(lid, offsets[1], dev)
            step = th.pack_step(lo, nb, 0, route).to(dev)
            kernels.reset_launches()
            got = th.route_window_step(d_bins, d_lid, step, rb)
            assert kernels.LAUNCHES["route_window_step"] == 1
            assert got.data_ptr() == d_lid.data_ptr()
            assert torch.equal(got, want), (route.tolist(), lo, nb)


@pytest.mark.cuda
def test_step_entries_read_the_block_at_every_replay(dev):
    """A CUDA graph of K3 and K2 + K1 step calls, replayed after the step
    block is rewritten on the card: each replay follows the block it
    finds (another window, target and route), bit for bit the by-value
    entries."""
    F, B = 28, 64
    fm, binsT, w8, lid = _segment_layout(F, B, 5)
    d_bins, d_w8, d_lid = binsT.to(dev), w8.to(dev), lid.to(dev)
    scales = th.fixed_point_scales(w8).to(dev)
    routes = _routes(fm, F)
    step = torch.zeros(th.STEP_WORDS, dtype=torch.int32, device=dev)
    ids = d_lid.clone()
    out = torch.empty((2, F, B, 3), device=dev)
    th.histogram_segment_routed_step(d_bins, d_w8, ids, step, B, RB, scales,
                                     out=out[0])
    graph = torch.cuda.CUDAGraph()
    kernels.CAPTURED.clear()
    with torch.cuda.graph(graph):
        th.histogram_segment_routed_step(d_bins, d_w8, ids, step, B, RB,
                                         scales, out=out[0])
        th.route_window_step(d_bins, ids, step, RB)
        th.histogram_segment_step(d_bins, d_w8, ids, step, B, RB, scales,
                                  out=out[1])
    assert kernels.CAPTURED == {"histogram_segment_routed_step": 1,
                                "route_window_step": 1,
                                "histogram_segment_step": 1}
    for lo, nblk, target, route in ((0, 16, 6, routes[0]),
                                    (10, 3, 1, routes[3]),
                                    (4, 0, 0, routes[1])):
        step.copy_(th.pack_step(lo, nblk, target, route).to(dev))
        ids.copy_(d_lid)
        graph.replay()
        want_ids = d_lid.clone()
        _, want = th.histogram_segment_routed(d_bins, d_w8, want_ids, lo,
                                              nblk, target, route, B, RB,
                                              scales)
        torch.cuda.synchronize()
        assert torch.equal(ids, want_ids)
        assert torch.equal(out[0], want) and torch.equal(out[1], want)


def _loop_data(n=20_000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    X[rng.uniform(size=X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = (Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(size=n)
         > 0).astype(np.float64)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_device_loop_grows_the_cpu_splits(dev, fused):
    """The graph-driven grower on the card: the CPU's splits (gain > 1e-2)
    and raw predictions within 1e-3; one model text for steps 1, 5 and
    L - 1, on a row block small enough that trees compact; each tree at
    most ceil((L - 1) / steps) + compactions + 2 host fetches."""
    X, y = _loop_data()
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  tpu_row_chunk=1024, verbosity=-1)
    texts, models, raws = {}, {}, {}
    compactions = 0
    for device, steps in (("cpu", 16), ("cuda", 1), ("cuda", 5),
                          ("cuda", 30)):
        bst = lt.Booster(dict(params, device_type=device), lt.Dataset(X, y),
                         fused_route=fused)
        bst.gbdt.grower.steps = steps
        total = _count_replays(bst)
        for _ in range(3):
            bst.update()
        for st in total["stats"]:
            assert st["fetches"] <= -(-30 // steps) + st["compactions"] + 2
            assert st["graph"] == (device == "cuda")
            compactions = max(compactions, st["compactions"])
        texts[device, steps] = bst.model_to_string().split("parameters:")[0]
        models[device, steps] = bst.gbdt.models
        raws[device, steps] = bst.predict(X, raw_score=True)
    assert compactions >= 1
    assert texts["cuda", 1] == texts["cuda", 5] == texts["cuda", 30]
    compared = 0
    for a, b in zip(models["cuda", 5], models["cpu", 16]):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while k < nf and a.split_gain[k] > 1e-2 and b.split_gain[k] > 1e-2:
            k += 1
        np.testing.assert_array_equal(a.split_feature[:k],
                                      b.split_feature[:k])
        np.testing.assert_array_equal(a.threshold_in_bin[:k],
                                      b.threshold_in_bin[:k])
        compared += k
    assert compared >= 40
    assert np.abs(raws["cuda", 5] - raws["cpu", 16]).max() < 1e-3


@pytest.mark.cuda
def test_split_step_makes_no_synchronising_call(dev):
    """A tree's start (its state reset, the root's pass and scan), the
    split step, the status it writes and the compaction run under
    torch.cuda.set_sync_debug_mode("error"): none of them waits for the
    card, reads a device value on the host or copies from the host."""
    from lightgbm_tpu_torch.models.grower import GrowerParams
    from lightgbm_tpu_torch.models.grower_seg import SegmentGrower
    X, y = _loop_data(8192, 1)
    bst = lt.Booster(dict(objective="binary", num_leaves=31, max_bin=63,
                          tpu_row_chunk=512, verbosity=-1,
                          device_type="cuda"), lt.Dataset(X, y))
    gb = bst.gbdt
    gb._boost_from_average()
    grad, hess = gb._gradients()
    g = SegmentGrower(gb.num_bins, GrowerParams(
        num_leaves=31, split=gb.grower.p.split), gb.grower.rb, steps=4)
    g.grow(gb.bins, grad[0], hess[0], gb.member, gb.fmeta)
    w8 = th.pack_channels(grad[0], hess[0], gb.member)
    s = g._state_for(gb.bins, gb.fmeta)
    g._src = (gb.bins, w8)
    scales = th.fixed_point_scales(w8)
    sums = torch.stack([grad[0].sum(), hess[0].sum(), gb.member.sum()])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.load(gb.bins, w8, scales, gb.fmeta, sums)
        g._start(False, gb.bins.shape[1] // g.rb)
        for _ in range(6):
            g._step()
        g._write_status()
        g._compact()
        g._step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(s.counters[0]) == 8 and int(s.counters[3]) == 1


@pytest.mark.cuda
def test_capture_failure_raises(dev, monkeypatch):
    """A step that cannot be captured (here one that reads a device value
    on the host) makes grow raise, and again on the next call: nothing
    falls back to eager steps."""
    from lightgbm_tpu_torch.models import grower_seg
    X, y = _loop_data(4096, 2)
    bst = lt.Booster(dict(objective="binary", num_leaves=7, verbosity=-1,
                          device_type="cuda"), lt.Dataset(X, y))
    write = grower_seg.SegmentGrower._write_status

    def syncing(self):
        write(self)
        self.s.status.tolist()

    monkeypatch.setattr(grower_seg.SegmentGrower, "_write_status", syncing)
    for _ in range(2):
        with pytest.raises(Exception):
            bst.update()
        assert bst.gbdt.grower._graph is None
    torch.cuda.synchronize()


# ------------------------------------------------------------ the session
def _session_data(n=40_000, seed=21):
    """No NaN: a NaN-missing split of a leaf whose rows hold no NaN has
    two equal gains, and rounding picks one (PERF.md, PR 8)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
         > 0).astype(np.float64)
    return X, y


SESSION_PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
                      learning_rate=0.5, metric=["binary_logloss"],
                      verbosity=-1)


def _same_splits(a_trees, b_trees):
    """Card = CPU: the same split feature and bin at gain > 1e-2, up to a
    near-tie.  Where the two pick different splits whose gains are within
    1e-4 of each other (two leaves' or thresholds' equal gains, broken by
    the histogram sums, which agree to 1e-5 of a bin's sum of |value|:
    the card's exact fixed point, the CPU's float64), the rest of that
    tree is not compared.  Returns the splits compared."""
    assert len(a_trees) == len(b_trees)
    compared = 0
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        for k in range(min(a.num_leaves, b.num_leaves) - 1):
            ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
            if ga <= 1e-2 or gb <= 1e-2:
                break
            if (a.split_feature[k], a.threshold_in_bin[k]) != (
                    b.split_feature[k], b.threshold_in_bin[k]):
                assert abs(ga - gb) <= 1e-4 * max(ga, gb), (
                    f"tree {i}, split {k}: gains {ga} and {gb}")
                break
            compared += 1
    return compared


def _session_train(device, X, y, rounds, **kw):
    ds = lt.Dataset(X[:30_000], y[:30_000])
    return lt.train(dict(SESSION_PARAMS, device_type=device), ds, rounds,
                    valid_sets=[ds.create_valid(X[30_000:], y[30_000:])],
                    verbose_eval=False, **kw)


@pytest.mark.cuda
def test_early_stopping_on_card_equals_cpu(dev):
    """The same stop, the same splits (up to a near-tie), the same holdout
    curve within 1e-4 (chip_smoke's cv rule)."""
    X, y = _session_data()
    evals = {d: {} for d in ("cuda", "cpu")}
    out = {d: _session_train(d, X, y, 60, early_stopping_rounds=2,
                             evals_result=evals[d])
           for d in ("cuda", "cpu")}
    card, cpu = out["cuda"], out["cpu"]
    assert 0 < card.best_iteration == cpu.best_iteration < 60
    assert card.current_iteration() == cpu.current_iteration()
    assert _same_splits(card.gbdt.models, cpu.gbdt.models) >= 20
    np.testing.assert_allclose(evals["cuda"]["valid_0"]["binary_logloss"],
                               evals["cpu"]["valid_0"]["binary_logloss"],
                               rtol=1e-4)


@pytest.mark.cuda
def test_boosters_updated_in_turns_grow_their_solo_models(dev):
    """Three boosters on one card (each with its own device state and
    CUDA graphs, sharing the kernels' scratch) updated in turns, as cv
    updates its folds, each grow bit for bit the model text they grow
    alone."""
    X, y = _session_data()
    params = dict(SESSION_PARAMS, device_type="cuda")
    parts = [np.arange(len(X))[i::3] for i in range(3)]

    def booster(rows, seed_shift):
        # different sizes and leaves, so the graphs differ
        p = dict(params, num_leaves=15 + 8 * seed_shift)
        return lt.Booster(p, lt.Dataset(X[rows], y[rows]))

    solo = []
    for i, rows in enumerate(parts):
        b = booster(rows, i)
        for _ in range(4):
            b.update()
        solo.append(b.model_to_string())
        del b
    turns = [booster(rows, i) for i, rows in enumerate(parts)]
    for _ in range(4):
        for b in turns:
            b.update()
    assert [b.model_to_string() for b in turns] == solo


@pytest.mark.cuda
def test_continued_training_on_card_equals_cpu(dev, tmp_path):
    X, y = _session_data()
    first = _session_train("cpu", X, y, 4)
    path = str(tmp_path / "m.txt")
    first.save_model(path)
    out = {d: _session_train(d, X, y, 4, init_model=path)
           for d in ("cuda", "cpu")}
    card, cpu = out["cuda"], out["cpu"]
    # the seeded scores: the same f32 adds on either device
    seeded = {d: _session_train(d, X, y, 0, init_model=path)
              for d in ("cuda", "cpu")}
    np.testing.assert_array_equal(
        seeded["cuda"].gbdt.train_score.cpu().numpy(),
        seeded["cpu"].gbdt.train_score.numpy())
    assert card.current_iteration() == cpu.current_iteration() == 8
    assert _same_splits(card.gbdt.models[4:], cpu.gbdt.models[4:]) >= 10
    np.testing.assert_allclose(card.eval_valid()[0][2],
                               cpu.eval_valid()[0][2], rtol=1e-5)


@pytest.mark.cuda
def test_rollback_one_iter_on_card(dev):
    """A rolled-back card booster scores as one trained an iteration
    less (within 1e-6), and grows its next tree as that one does."""
    X, y = _session_data()
    ds = lt.Dataset(X, y)
    params = dict(SESSION_PARAMS, device_type="cuda")
    rolled, ref = lt.Booster(params, ds), lt.Booster(params, ds)
    for _ in range(5):
        rolled.update()
    for _ in range(4):
        ref.update()
    rolled.rollback_one_iter()
    assert rolled.current_iteration() == 4 == rolled.num_trees()
    np.testing.assert_allclose(rolled.gbdt.train_score.cpu().numpy(),
                               ref.gbdt.train_score.cpu().numpy(), rtol=0,
                               atol=1e-6)
    rolled.update()
    ref.update()
    assert _same_splits(rolled.gbdt.models, ref.gbdt.models) >= 20
