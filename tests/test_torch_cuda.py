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
P1 (``route_trees``) on u8 training bins and on i16 predict-time bins
with unseen, negative and NaN categories against its plain version; a
card booster's training walks through P1 (valid scores, DART's drops,
rollback, init_model's seeding, a late add_valid) against the host walks
of the same booster; init_model's seeding from a model grown on other
rows against a CPU booster's; and ``predict`` with ``predict_device``
"auto"/"on" against "off", all bit for bit.  On EFB-bundled Expo-shaped
bins (255-bin groups beside 63-bin columns): K1, K3, K2, K5, K6 and K7
against their plain versions with routes of group members (bin offset
not 0) bit for bit in the leaf ids, P1 with the group tables, and a
bundled booster and a CSR one against the CPU booster.  On 4-bit packed
bins (two <= 16-bin columns a byte): K1, K3, K2, their step entries, K5,
K6 and K7 bit for bit the same kernels on the unpacked bins at odd and
even column counts and at counts whose tiles split, P1 likewise, and
packed boosters (segment fused and unfused, frontier, multiclass,
bundled) = their unpacked model text = the CPU's splits.  The
packed-accumulator stream: Q1 (``quantize_pack``) at 10M rows and every
``_packed_acc`` kernel (K1, K3, their step entries, K5, K6, K7 routed and
fused-K, at G 7/28/41, with and without 4-bit bins) bit for bit their
plain versions; int32 planes exact when every row of 20M carries the
largest value into one bin; growers fed the same gradients = the CPU's
trees; packed_acc boosters (segment fused and unfused, the frontier's
three tiers, 3-class) launch only the ``_packed_acc`` histogram kernels,
their first iteration = the CPU's splits.  P1's node records in both of
its modes (a tile of u8 bins in shared memory, bins read in place: wide
matrices and i16 bins) on u8, i16, 4-bit and EFB bins with C = 5, a
stack of several stages and an in-place chunk; Q1 at every width, at a
row count the vector width divides and one it does not, with an
all-zero member and non-finite gradients, two kernels a call.  The split
features (monotone constraints, feature_contri, CEGB's costs, a forced
plan, CEGB-lazy) on the segment, frontier and fused growers: the card's
splits = the CPU's at 40k rows, predictions monotone, the segment
grower's graph grows one model text at steps 1 and 4, and the fused
grower launches K5 once for each root and split and K2 once a split.

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


# ------------------------------------------------ weights, ranks, renewal
def _weights(n, seed):
    """Sample weights log-uniform over 1e-3..1e3, every 13th row 0."""
    w = np.exp(np.random.RandomState(seed).uniform(
        np.log(1e-3), np.log(1e3), size=n)).astype(np.float32)
    w[::13] = 0.0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 64), (28, 256)])
def test_segment_kernels_with_heavy_tailed_weights(dev, F, B):
    """K1 and K3 on weighted gradients (weights over 1e-3..1e3, rows of
    weight 0 still members): the fixed-point scale is set by the largest
    |g w| and is coarse for the rest; the sums stay within 1e-5 of the
    bin's sum of |value|, the counts count every member row."""
    fm, binsT, _, lid = _segment_layout(F, B, F + B + 1)
    n = binsT.shape[1]
    rng = np.random.RandomState(F + B)
    w = torch.from_numpy(_weights(n, F + B))
    grad = torch.from_numpy(rng.normal(size=n).astype(np.float32)) * w
    hess = torch.from_numpy(rng.uniform(0.01, 0.25, size=n).astype(
        np.float32)) * w
    w8 = th.pack_channels(grad, hess, torch.ones(n))
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_scales = binsT.to(dev), w8.to(dev), scales.to(dev)
    for lo, nblk in _SEG_WINDOWS:
        for target in (0, 1, 2):
            want = th.histogram_segment_plain(binsT, w8, lid, lo, nblk,
                                              target, B, RB)
            got = th.histogram_segment(d_bins, d_w8, lid.to(dev), lo, nblk,
                                       target, B, RB, d_scales)
            _assert_hist(got, want, w8, binsT, lid, lo, nblk, target, B)
    for route in _routes(fm, F)[:4]:
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid.clone(), 0, 16, 6, route, B, RB)
        got_lid, got = th.histogram_segment_routed(
            d_bins, d_w8, lid.to(dev), 0, 16, 6, route, B, RB, d_scales)
        assert torch.equal(got_lid.cpu(), want_lid)
        _assert_hist(got, want, w8, binsT, want_lid, 0, 16, 6, B)


def _rank_data(n_queries=400, seed=31):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 120, size=n_queries)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 10))
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 1.5
                         + 0.5 * rng.normal(size=n)), 0, 4)
    return X, y, sizes


@pytest.mark.cuda
def test_lambdarank_gradients_on_card_equal_cpu(dev):
    """The same lambdas on the card as on the CPU (within 1e-5 of the
    largest), the same bits on a second call."""
    from lightgbm_tpu_torch.objective import create_objective
    X, y, sizes = _rank_data()
    md = lt.Dataset(X, y, group=sizes, weight=_weights(len(y), 3)
                    ).construct()._handle.metadata
    out = {}
    for d in ("cuda", "cpu"):
        obj = create_objective(lt.Config(device_type=d,
                                         objective="lambdarank"))
        obj.init(md, len(y), torch.device(d))
        score = torch.from_numpy(np.round(np.random.RandomState(4).normal(
            size=len(y)), 1).astype(np.float32)).to(d)
        runs = [obj.get_gradients(score) for _ in range(2)]
        out[d] = [(g.cpu(), h.cpu()) for g, h in runs]
    (g0, h0), (g1, h1) = out["cuda"]
    assert torch.equal(g0, g1) and torch.equal(h0, h1)
    gc, hc = out["cpu"][0]
    for a, b in ((g0, gc), (h0, hc)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _objective_data(objective, n=30_000, seed=41):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 12))
    f = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] ** 2
    if objective == "poisson":
        y = rng.poisson(np.exp(0.4 * f)).astype(np.float64)
    elif objective == "multiclassova":
        y = np.digitize(f + 0.3 * rng.normal(size=n), [-1.0, 0.0, 0.8])
    else:
        y = 3.0 * f + rng.normal(size=n)
    return X, y.astype(np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["regression", "regression_l1",
                                       "poisson", "multiclassova",
                                       "lambdarank"])
def test_weighted_offset_and_rank_boosters_on_card_equal_cpu(dev,
                                                             objective):
    """Weighted (with weight-0 rows), init-scored and lambdarank
    boosters: card = CPU splits up to a near-tie, raw predictions within
    1e-3; L1's renewed leaves are the host percentile of the card's own
    leaf ids and scores."""
    if objective == "lambdarank":
        X, y, group = _rank_data()
    else:
        X, y = _objective_data(objective)
        group = None
    n = len(y)
    C = 4 if objective == "multiclassova" else 1
    init = 0.2 * np.random.RandomState(5).normal(size=C * n)
    params = dict(objective=objective, num_leaves=15, verbosity=-1,
                  learning_rate=0.3, **({"num_class": C} if C > 1 else {}))
    w = np.exp(np.random.RandomState(6).uniform(-2.0, 2.0, size=n))
    w[::17] = 0.0
    out = {}
    for d in ("cuda", "cpu"):
        ds = lt.Dataset(X, y, weight=w, group=group, init_score=init)
        bst = lt.Booster(dict(params, device_type=d), ds)
        for _ in range(3):
            bst.update()
        out[d] = bst
    card, cpu = out["cuda"], out["cpu"]
    assert _same_splits(card.gbdt.models, cpu.gbdt.models) >= 10
    np.testing.assert_allclose(card.predict(X, raw_score=True),
                               cpu.predict(X, raw_score=True), rtol=0,
                               atol=1e-3)
    if objective == "regression_l1":
        assert len(card.gbdt.renew_seconds) == 3


@pytest.mark.cuda
def test_l1_renewal_on_card_is_the_host_percentile(dev):
    """The renewal groups rows by leaf on the card; each leaf's value is
    bit for bit the host percentile of its rows' residuals."""
    from lightgbm_tpu_torch.objective.base import weighted_percentile
    X, y = _objective_data("regression_l1")
    w = _weights(len(y), 7)
    bst = lt.Booster(dict(objective="regression_l1", num_leaves=31,
                          verbosity=-1, device_type="cuda"),
                     lt.Dataset(X, y, weight=w))
    bst.update()
    score = bst.gbdt.train_score[0].clone()
    leaf_values = np.random.RandomState(8).normal(size=31)
    leaf_id = torch.from_numpy(np.random.RandomState(9).randint(
        0, 30, size=len(y)).astype(np.int32)).to(dev)
    got = bst.gbdt.objective.renew_tree_output(leaf_values, leaf_id, score)
    lid = leaf_id.cpu().numpy()
    r = y.astype(np.float32).astype(np.float64) - score.cpu().numpy(
    ).astype(np.float64)
    want = leaf_values.copy()
    for k in range(31):
        sel = lid == k
        if sel.any():
            want[k] = weighted_percentile(r[sel], w[sel], 0.5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_weighted_and_unweighted_boosters_in_turns_grow_their_solo_models(
        dev):
    """A weighted booster and an unweighted one on one card, updated in
    turns, each grow bit for bit the model text they grow alone: the
    weighted gradients reach the device loop's graphs through the same
    in-place tensors."""
    X, y = _session_data()
    w = _weights(len(y), 11)
    params = dict(SESSION_PARAMS, device_type="cuda")

    def boosters():
        return [lt.Booster(params, lt.Dataset(X, y, weight=w)),
                lt.Booster(params, lt.Dataset(X, y))]

    solo = []
    for b in boosters():
        for _ in range(4):
            b.update()
        solo.append(b.model_to_string())
        del b
    turns = boosters()
    for _ in range(4):
        for b in turns:
            b.update()
    assert [b.model_to_string() for b in turns] == solo
    assert solo[0] != solo[1]


# ------------------------------------------------- boosting modes (PR 10)
@pytest.mark.cuda
def test_threefry_on_card_equals_cpu(dev):
    """Integer ops: the card's bits equal the CPU's, and so its uniforms,
    fold-ins and node masks."""
    from lightgbm_tpu_torch.models.grower import (GrowerParams,
                                                  node_feature_mask)
    from lightgbm_tpu_torch.utils import random
    for seed in (0, 3, 2**31 - 1):
        key = random.split(random.prng_key(seed))[1]
        kd = key.to(dev)
        for n in (1, 28, 100_003):
            assert torch.equal(random.random_bits(kd, n).cpu(),
                               random.random_bits(key, n))
            assert torch.equal(random.uniform(kd, n).cpu(),
                               random.uniform(key, n))
        steps = torch.arange(2 * 63 + 1)
        assert torch.equal(random.fold_in(kd, steps.to(dev)).cpu(),
                           random.fold_in(key, steps))
        base = (torch.arange(28) % 4 != 1).float()
        p = GrowerParams(num_leaves=63, feature_fraction_bynode=0.4)
        assert torch.equal(
            node_feature_mask(base.to(dev), kd, steps.to(dev), p).cpu(),
            node_feature_mask(base, key, steps, p))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3])
def test_goss_select_on_card_equals_cpu(dev, C):
    from lightgbm_tpu_torch.models.goss import goss_select
    from lightgbm_tpu_torch.utils import random
    rng = np.random.RandomState(C)
    n = 200_001
    g = torch.from_numpy(np.round(rng.normal(size=(C, n)), 3).astype(
        np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.25, size=(C, n)).astype(
        np.float32))
    key = random.fold_in(random.prng_key(0), 0x60550000 + 12)
    want = goss_select(g, h, key, n // 5, n // 10)
    got = goss_select(g.to(dev), h.to(dev), key.to(dev), n // 5, n // 10)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert want[2].sum() >= n // 5 + n // 10


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 64), (28, 256)])
def test_segment_kernels_with_goss_amplified_gradients(dev, F, B):
    """K1 and K3 on GOSS's amplified gradients, out-of-bag rows members 0:
    the fixed-point scale follows the largest amplified |g|; the sums
    stay within 1e-5 of the bin's sum of |value|."""
    from lightgbm_tpu_torch.models.goss import goss_select
    from lightgbm_tpu_torch.utils import random
    fm, binsT, _, lid = _segment_layout(F, B, F + B + 2)
    n = binsT.shape[1]
    rng = np.random.RandomState(F + B)
    grad = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.01, 0.25, size=(1, n)).astype(
        np.float32))
    key = random.fold_in(random.prng_key(1), 0x60550000 + 3)
    g, h, mask = goss_select(grad, hess, key, n // 5, n // 10)
    w8 = th.pack_channels(g[0], h[0], mask)
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_scales = binsT.to(dev), w8.to(dev), scales.to(dev)
    for lo, nblk in _SEG_WINDOWS:
        want = th.histogram_segment_plain(binsT, w8, lid, lo, nblk, 1, B, RB)
        got = th.histogram_segment(d_bins, d_w8, lid.to(dev), lo, nblk, 1,
                                   B, RB, d_scales)
        _assert_hist(got, want, w8, binsT, lid, lo, nblk, 1, B)
    for route in _routes(fm, F)[:4]:
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid.clone(), 0, 16, 6, route, B, RB)
        got_lid, got = th.histogram_segment_routed(
            d_bins, d_w8, lid.to(dev), 0, 16, 6, route, B, RB, d_scales)
        assert torch.equal(got_lid.cpu(), want_lid)
        _assert_hist(got, want, w8, binsT, want_lid, 0, 16, 6, B)


MODE_PARAMS = {
    "bagging_bynode": dict(bagging_fraction=0.6, bagging_freq=1,
                           feature_fraction=0.75,
                           feature_fraction_bynode=0.5),
    "goss": dict(boosting="goss", learning_rate=0.5),
    "dart": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODE_PARAMS))
def test_mode_boosters_on_card_equal_cpu(dev, mode):
    """5 iterations of each mode: the CPU's splits up to a near-tie, the
    same bag (GOSS: up to 8 rows), raw predictions within 1e-3 where no
    near-tie was met."""
    X, y = _session_data()
    params = dict(SESSION_PARAMS, **MODE_PARAMS[mode])
    out = {}
    for device in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=device), lt.Dataset(X, y))
        for _ in range(5):
            bst.update()
        out[device] = bst
    compared = _same_splits(out["cuda"].gbdt.models, out["cpu"].gbdt.models)
    assert compared >= 30
    if compared == sum(t.num_leaves - 1 for t in out["cpu"].gbdt.models):
        # numpy's bags are the same rows; GOSS's follow the scores, whose
        # last bits differ, so rows at the top_k boundary may swap
        diff = (out["cuda"].gbdt.member.cpu() != out["cpu"].gbdt.member)
        assert int(diff.sum()) <= (8 if mode == "goss" else 0)
        assert np.abs(out["cuda"].predict(X, raw_score=True)
                      - out["cpu"].predict(X, raw_score=True)).max() < 1e-3


@pytest.mark.cuda
def test_bynode_masks_in_the_device_loop_graph(dev):
    """The tree-start graph draws every node's mask on the card: its table
    equals the masks drawn on the CPU from the same tree key, and each
    step's split uses a feature its node's row keeps."""
    from lightgbm_tpu_torch.models.grower import node_feature_mask
    from lightgbm_tpu_torch.utils import random
    X, y = _session_data()
    bst = lt.Booster(dict(SESSION_PARAMS, device_type="cuda",
                          **MODE_PARAMS["bagging_bynode"]), lt.Dataset(X, y))
    g = bst.gbdt.grower
    keys = []
    split = random.split

    def recorded(key, num=2):
        out = split(key, num)
        keys.append(out[1])
        return out

    random.split = recorded
    try:
        for _ in range(3):
            bst.update()
    finally:
        random.split = split
    assert g.last_stats["graph"]
    L = g.p.num_leaves
    steps = torch.arange(2 * L + 1)
    fmask = g.s.fmask.cpu()
    want = node_feature_mask(fmask, keys[-1], steps, g.p)
    assert torch.equal(g.s.node_masks.cpu(), want)
    tree = bst.gbdt.models[-1]
    # split s went on the root (node number 2L) or on a child of its
    # parent node p: the left one numbered 2p, the right one 2p + 1
    assert tree.num_leaves > 2
    for s in range(tree.num_leaves - 1):
        row = 2 * L
        for p in range(s):
            if tree.left_child[p] == s:
                row = 2 * p
            elif tree.right_child[p] == s:
                row = 2 * p + 1
        assert want[row, tree.split_feature_inner[s]] > 0, s


@pytest.mark.cuda
def test_bagged_and_unbagged_boosters_in_turns_grow_their_solo_models(dev):
    """The bag, the tree mask and the key reach the device loop's graphs
    through the state's buffers, so two boosters on one card, updated in
    turns, each grow their solo text."""
    X, y = _session_data()
    params = dict(SESSION_PARAMS, device_type="cuda")
    bagged = dict(params, **MODE_PARAMS["bagging_bynode"])

    def boosters():
        return [lt.Booster(bagged, lt.Dataset(X, y)),
                lt.Booster(params, lt.Dataset(X, y))]

    solo = []
    for b in boosters():
        for _ in range(4):
            b.update()
        solo.append(b.model_to_string())
        del b
    turns = boosters()
    for _ in range(4):
        for b in turns:
            b.update()
    assert [b.model_to_string() for b in turns] == solo
    assert solo[0] != solo[1]


# ------------------------------------------------------ P1 and prediction
def _predict_data(n=20_000, seed=31):
    """Numeric columns with NaN (NaN-missing), with exact zeros
    (zero-missing under zero_as_missing), a categorical column of 40
    values, and a label from all of them."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.2, 2] = 0.0
    X[:, 5] = rng.randint(0, 40, size=n)
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) + (X[:, 5] % 7 == 3)
         + 0.3 * rng.normal(size=n) > 0.5).astype(np.float64)
    return X, y


PREDICT_PARAMS = dict(objective="binary", num_leaves=31, verbosity=-1,
                      min_data_per_group=5, cat_smooth=1.0)


def _predict_booster(device, X, y, **params):
    ds = lt.Dataset(X, y, categorical_feature=[5])
    return lt.train(dict(PREDICT_PARAMS, device_type=device, **params), ds,
                    8, verbose_eval=False)


@pytest.mark.cuda
@pytest.mark.parametrize("bins_of", ["train_u8", "raw_i16"])
def test_route_trees_equals_plain(dev, bins_of):
    """P1 on u8 training bins and on i16 predict-time bins (unseen and
    negative categories as -1, a NaN one as category 0's bin) = its plain
    version on the card, bit for bit, one launch a call; a second launch
    adds the same again; a call of no rows launches nothing."""
    from lightgbm_tpu_torch.models.device_predict import (TreeStack,
                                                          bin_rows)
    from lightgbm_tpu_torch.ops import predict as tp
    X, y = _predict_data()
    bst = _predict_booster("cpu", X, y, num_class=3, objective="multiclass")
    ds = bst.train_set._handle
    if bins_of == "train_u8":
        bins = torch.from_numpy(ds.bins_t).to(dev)
    else:
        Xq = X.copy()
        Xq[:50, 5] = 97.0       # unseen
        Xq[50:60, 5] = -3.0     # negative
        Xq[60:70, 5] = np.nan
        bins = torch.from_numpy(bin_rows(ds, Xq)).to(dev)
        cat = bins[ds.inner_feature_index(5)]
        zero = int(bin_rows(ds, np.zeros((1, X.shape[1])))[
            ds.inner_feature_index(5), 0])
        assert bool((cat[:60] == -1).all()) and zero >= 0
        assert bool((cat[60:70] == zero).all())
    trees = bst.gbdt.models
    nb, db = bst.gbdt.fmeta.num_bin.to(dev), bst.gbdt.fmeta.default_bin.to(
        dev)
    stack = TreeStack(trees, [i % 3 for i in range(len(trees))],
                      ds.num_used_features, dev, tp.route_tables(nb, db))
    n = bins.shape[1] - 3     # fewer rows than the matrix's stride
    start = torch.randn((3, n), dtype=torch.float64, device=dev)
    want = tp.route_trees_plain(bins, stack, nb, db, start.clone())
    kernels.reset_launches()
    got = tp.route_trees(bins, stack, nb, db, start.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["route_trees"] == 1
    assert torch.equal(got, want)
    again = tp.route_trees(bins, stack, nb, db, got.clone())
    assert torch.equal(again, tp.route_trees_plain(bins, stack, nb, db,
                                                   want.clone()))
    # no rows: nothing launched, none counted
    kernels.reset_launches()
    empty = torch.zeros((3, 0), dtype=torch.float64, device=dev)
    assert tp.route_trees(bins, stack, nb, db, empty).shape == (3, 0)
    assert kernels.LAUNCHES["route_trees"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_card_walks_equal_host_walks(dev, boosting, monkeypatch):
    """A card booster's training walks through P1 (valid scores each
    iteration, DART's drops, rollback, init_model's seeding, a late
    add_valid's replay) = the host walks on the same card booster, bit
    for bit: model text, training score, valid scores."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    X, y = _predict_data()
    params = dict(PREDICT_PARAMS, device_type="cuda", boosting=boosting,
                  drop_rate=0.5, skip_drop=0.0, num_class=3,
                  objective="multiclass")
    yc = (np.nan_to_num(X[:, 0] * 2) % 3 + 3) % 3 // 1

    def run():
        ds = lt.Dataset(X[:15_000], yc[:15_000], categorical_feature=[5])
        va = ds.create_valid(X[15_000:], yc[15_000:])
        bst = lt.train(params, ds, 6, valid_sets=[va], verbose_eval=False)
        bst.rollback_one_iter()
        bst.update()
        ds2 = lt.Dataset(X[:15_000], yc[:15_000], categorical_feature=[5])
        cont = lt.train(dict(params, boosting="gbdt"), ds2, 2,
                        init_model=bst, verbose_eval=False)
        cont.add_valid(ds2.create_valid(X[15_000:], yc[15_000:]), "late")
        return [bst.model_to_string(), bst.gbdt.train_score.cpu().numpy(),
                *bst.gbdt.valid_scores, cont.model_to_string(),
                cont.gbdt.train_score.cpu().numpy(),
                *cont.gbdt.valid_scores]

    kernels.reset_launches()
    card = run()
    assert kernels.LAUNCHES["route_trees"] > 0
    monkeypatch.setattr(GBDT, "_walks_on_card", lambda self: False)
    kernels.reset_launches()
    host = run()
    assert kernels.LAUNCHES["route_trees"] == 0
    for a, b in zip(card, host):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["same", "other"])
def test_card_seeding_equals_cpu_seeding(dev, rows):
    """init_model's seeding on a card booster = on a CPU booster (the raw
    walk), bit for bit, from a model grown on the same rows (P1 over
    bin_rows, as a tree splits a category) or on other rows (other bin
    bounds, category bins in another order, an unseen category: the
    raw walk, as a realigned tree is not bins_exact); then predict "on"
    = "off", on P1 only where every tree is exact."""
    X, y = _predict_data()
    params = dict(PREDICT_PARAMS, objective="multiclass", num_class=3)
    yc = X[:, 5] % 3
    src = lt.train(dict(params, device_type="cpu"), lt.Dataset(
        X[:8000], yc[:8000], categorical_feature=[5]), 4)
    Xb, yb = (X[:8000], yc[:8000]) if rows == "same" else (
        X[8000:].copy(), yc[8000:])
    if rows == "other":
        Xb[Xb[:, 5] == 39, 5] = 38
        Xb[:, 5] = (Xb[:, 5] * 7) % 39
    out = {}
    for d in ("cuda", "cpu"):
        kernels.reset_launches()
        out[d] = lt.train(dict(params, device_type=d), lt.Dataset(
            Xb, yb, categorical_feature=[5]), 0,
            init_model=lt.Booster(model_str=src.model_to_string()))
        if d == "cuda":
            launches = kernels.LAUNCHES["route_trees"]
    card, cpu = out["cuda"], out["cpu"]
    exact = all(t.bins_exact for t in card.gbdt.models)
    assert exact == (rows == "same") and launches == int(exact)
    np.testing.assert_array_equal(card.gbdt.train_score.cpu().numpy(),
                                  cpu.gbdt.train_score.numpy())
    on = card.predict(X, raw_score=True)
    assert card.gbdt.last_predict_route == ("device" if exact else "host")
    np.testing.assert_array_equal(
        on, card.predict(X, raw_score=True, predict_device="off"))
    np.testing.assert_array_equal(on, src.predict(X, raw_score=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["binary", "multiclass", "rf"])
def test_card_predict_on_equals_off(dev, case):
    """predict on a card booster: "auto" takes P1 (the recorded route
    says so), "on" the same, "off" the host walk; raw and converted
    output bit for bit, with num_iteration and start_iteration."""
    X, y = _predict_data()
    params = {"binary": {}, "multiclass": dict(objective="multiclass",
                                               num_class=3),
              "rf": dict(boosting="rf", bagging_fraction=0.6,
                         bagging_freq=1)}[case]
    yy = y if case != "multiclass" else (X[:, 5] % 3)
    bst = _predict_booster("cuda", X, yy, **params)
    Xq = X[::3].copy()
    Xq[:20, 5] = 99.0
    for kw in ({}, dict(num_iteration=3), dict(start_iteration=2,
                                               num_iteration=4)):
        for raw in (True, False):
            kernels.reset_launches()
            auto = bst.predict(Xq, raw_score=raw, **kw)
            assert bst.gbdt.last_predict_route == "device"
            assert kernels.LAUNCHES["route_trees"] == 1
            on = bst.predict(Xq, raw_score=raw, predict_device="on", **kw)
            off = bst.predict(Xq, raw_score=raw, predict_device="off", **kw)
            assert bst.gbdt.last_predict_route == "host"
            np.testing.assert_array_equal(auto, off)
            np.testing.assert_array_equal(on, off)


# ------------------------------------------------------------- EFB bundling
def _expo(n=12 * RB, seed=5):
    """Expo-shaped rows (chip_smoke.expo_like) binned and bundled on the
    CPU: (X, y, the dataset, its host FeatureMeta with the EFB tables)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke
    from lightgbm_tpu_torch.core.dataset import TorchDataset
    X, y = chip_smoke.expo_like(n, seed)
    h = TorchDataset.from_scipy(X, y, config=lt.Config(
        device_type="cpu", max_bin=63, min_data_in_leaf=5))
    assert h.bundle is not None and h.max_column_bin > 200
    return X, y, h, chip_smoke.host_meta(h)


def _member_routes(fm, K, leaf0=0, new0=6):
    """K routes of leaves leaf0.. into new0..: group members (offset not
    0, their category right) and, every fourth, a numeric column."""
    members = [j for j in range(len(fm.num_bin)) if fm.feat_offset[j] > 0]
    none = np.zeros(8, np.uint32)
    out = []
    for k in range(K):
        f = k % 4 if k % 4 == 3 else members[(k * 37) % len(members)]
        t = 0 if fm.num_bin[f] == 2 else int(fm.num_bin[f]) // 2
        out.append(th.pack_route(leaf0 + k, new0 + k, f, t, k % 2 == 1,
                                 False, none, fm))
    return out


@pytest.mark.cuda
def test_bundled_kernels_match_plain(dev):
    """K1, K3 and K2 (routes of group members at their bin offsets), K5
    and a K = 16 frontier round (K6, K7 routed, K7 fused-K) on bundled
    [G, N] bins of 256 bins: leaf ids bit for bit, counts exact, sums in
    tolerance, relaunches bit for bit."""
    _, _, h, fm = _expo()
    B = 256
    binsT = h.device_bins(RB, torch.device("cpu"))
    G, npad = binsT.shape
    nblk = npad // RB
    rng = np.random.RandomState(7)
    grad = torch.from_numpy(rng.normal(size=npad).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.01, 0.25, npad).astype(np.float32))
    member = torch.ones(npad)
    member[h.num_data:] = 0.0
    w8 = th.pack_channels(grad, hess, member)
    lid = torch.from_numpy(rng.randint(0, 4, size=npad).astype(np.int32))
    scales = th.fixed_point_scales(w8)
    d_bins, d_w8, d_scales = binsT.to(dev), w8.to(dev), scales.to(dev)
    want = th.histogram_segment_plain(binsT, w8, lid, 0, nblk, 2, B, RB)
    got = th.histogram_segment(d_bins, d_w8, lid.to(dev), 0, nblk, 2, B, RB,
                               d_scales)
    _assert_hist(got, want, w8, binsT, lid, 0, nblk, 2, B)
    routes = _member_routes(fm, 4, leaf0=0, new0=6)
    assert all(int(r[10]) > 0 for r in routes[:3])
    for route in routes:
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid.clone(), 1, nblk - 2, 6, route, B, RB)
        assert not torch.equal(want_lid, lid)
        runs = [th.histogram_segment_routed(d_bins, d_w8, lid.to(dev), 1,
                                            nblk - 2, 6, route, B, RB,
                                            d_scales) for _ in range(2)]
        for got_lid, got in runs:
            assert torch.equal(got_lid.cpu(), want_lid)
        assert torch.equal(runs[0][1], runs[1][1])
        _assert_hist(runs[0][1], want, w8, binsT, want_lid, 1, nblk - 2, 6,
                     B)
        k2 = th.route_window(d_bins, lid.to(dev), 1, nblk - 2, route, RB)
        assert torch.equal(k2.cpu(), want_lid)
    # K5: three class sets
    w8C = th.pack_channel_sets(torch.stack([grad, -grad, 0.5 * grad]),
                               torch.stack([hess, hess, 2 * hess]), member)
    sc = th.class_scales(w8C)
    want = th.histogram_all_plain(binsT, w8C, B)
    got = th.histogram_all(d_bins, w8C.to(dev), B, sc.to(dev))
    lid0 = torch.zeros(npad, dtype=torch.int32)
    for c in range(3):
        _assert_hist(got[c], want[c], w8C[8 * c:8 * c + 8], binsT, lid0, 0,
                     nblk, 0, B)
    # a K = 16 frontier round over bundled columns
    K = 16
    flid = torch.from_numpy(np.sort(rng.randint(0, 2 * K, size=npad)).astype(
        np.int32))
    froutes = torch.stack(_member_routes(fm, K, leaf0=0, new0=2 * K))
    bl, n = th.union_block_list([0, 3, nblk // 2], [2, 6, nblk], [True] * 3)
    smaller = torch.tensor([k if k % 3 else 2 * K + k for k in range(K)],
                           dtype=torch.int32)
    targets2 = torch.tensor(list(range(K)) + list(range(2 * K, 3 * K)),
                            dtype=torch.int32)
    routed, _ = th.histogram_frontier_routed_plain(
        binsT, w8, flid.clone(), bl, n, smaller, froutes, B, RB)
    assert not torch.equal(routed, flid)
    want = th.histogram_frontier_plain(binsT, w8, routed, bl, n, smaller, B,
                                       RB)
    got = th.histogram_frontier(d_bins, d_w8, routed.to(dev), bl.to(dev), n,
                                smaller, B, RB, d_scales)
    _assert_frontier(got, want, w8, binsT, routed, bl, n, smaller, B)
    for fn, targets in ((th.histogram_frontier_routed, smaller),
                        (th.histogram_frontier_fusedk, targets2)):
        want_lid, want = th.histogram_frontier_routed_plain(
            binsT, w8, flid.clone(), bl, n, targets, froutes, B, RB)
        got_lid, got = fn(d_bins, d_w8, flid.to(dev), bl.to(dev), n,
                          targets, froutes, B, RB, d_scales)
        assert torch.equal(got_lid.cpu(), want_lid)
        _assert_frontier(got, want, w8, binsT, want_lid, bl, n, targets, B)


@pytest.mark.cuda
def test_bundled_step_entries_route_members_bit_for_bit(dev):
    """K2 and K3's step entries (the route read from device memory, as
    the device loop's graph calls them) with routes of group members at
    bin offsets of 1 to 200+: the by-value entries' and the plain
    versions' leaf ids, bit for bit, over a whole and a partial window."""
    _, _, h, fm = _expo(seed=6)
    B = 256
    binsT = h.device_bins(RB, torch.device("cpu"))
    npad = binsT.shape[1]
    nblk = npad // RB
    rng = np.random.RandomState(8)
    w8 = th.pack_channels(torch.randn(npad), torch.rand(npad) + 0.01,
                          torch.ones(npad))
    scales = th.fixed_point_scales(w8).to(dev)
    lid = torch.from_numpy(rng.randint(0, 3, size=npad).astype(np.int32))
    offsets = sorted({int(fm.feat_offset[j]) for j in range(len(fm.num_bin))})
    assert offsets[0] == 0 and offsets[-1] > 200
    for route in _member_routes(fm, 8, leaf0=0, new0=5):
        for lo, nb in ((0, nblk), (2, nblk // 2)):
            want = th.route_window_plain(binsT, lid.clone(), lo, nb, route,
                                         RB)
            step = th.pack_step(lo, nb, 5, route).to(dev)
            k2 = th.route_window_step(binsT.to(dev), lid.to(dev), step, RB)
            ids = lid.to(dev)
            th.histogram_segment_routed_step(binsT.to(dev), w8.to(dev), ids,
                                             step, B, RB, scales)
            assert torch.equal(k2.cpu(), want)
            assert torch.equal(ids.cpu(), want)


@pytest.mark.cuda
def test_route_trees_with_group_tables_equals_plain(dev):
    """P1 over bundled training bins with the group tables = its plain
    version bit for bit, one launch counted, and = the host walk over the
    same bins."""
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.ops import predict as tp
    X, y, _, _ = _expo(n=8000, seed=9)
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  min_data_in_leaf=5, verbosity=-1, device_type="cpu")
    bst = lt.train(params, lt.Dataset(X, y), 6, verbose_eval=False)
    g = bst.gbdt
    ds = g.train_set
    assert g.fmeta.feat_group is not None
    bins = torch.from_numpy(ds.bins_t).to(dev)
    tables = [t.to(dev) for t in (g.fmeta.num_bin, g.fmeta.default_bin,
                                  g.fmeta.feat_group, g.fmeta.feat_offset)]
    stack = TreeStack(g.models, [0] * len(g.models), ds.num_used_features,
                      dev, tp.route_tables(*tables))
    start = torch.zeros((1, ds.num_data), dtype=torch.float64, device=dev)
    want = tp.route_trees_plain(bins, stack, tables[0], tables[1],
                                start.clone(), *tables[2:])
    kernels.reset_launches()
    got = tp.route_trees(bins, stack, tables[0], tables[1], start.clone(),
                         *tables[2:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["route_trees"] == 1
    assert torch.equal(got, want)
    host = np.zeros(ds.num_data)
    infos = ds.feature_infos()
    for tree in g.models:
        host += tree.predict_binned(ds.bins_t, infos)
    np.testing.assert_array_equal(got[0].cpu().numpy(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense_fused", "csr_unfused",
                                  "csr_frontier", "csr_multiclass"])
def test_bundled_boosters_on_card_equal_cpu(dev, case):
    """A card booster on bundled bins (from dense and from CSR input) =
    the CPU booster: the same splits up to a near-tie, training scores
    within 1e-3; its valid scores (P1 over the bundled valid bins) = the
    host walk's."""
    import scipy.sparse as sp
    X, y, _, _ = _expo(n=20_000, seed=11)
    if case == "csr_multiclass":
        y = (np.asarray(X[:, 4:16].argmax(axis=1)).ravel() % 3).astype(
            np.float64)
    data = X.toarray() if case == "dense_fused" else sp.csr_matrix(X)
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  min_data_in_leaf=5, verbosity=-1)
    kw = {}
    if case == "csr_unfused":
        kw = {"fused_route": False}
    elif case == "csr_frontier":
        params.update(tpu_tree_impl="frontier", tpu_frontier_width=16)
    elif case == "csr_multiclass":
        params.update(objective="multiclass", num_class=3)
    out = {}
    for device in ("cuda", "cpu"):
        ds = lt.Dataset(data[:16_000], y[:16_000])
        va = ds.create_valid(data[16_000:], y[16_000:])
        bst = lt.Booster(dict(params, device_type=device), ds, **kw)
        bst.add_valid(va, "v")
        for _ in range(3):
            bst.update()
        assert bst.gbdt.train_set.bundle is not None
        out[device] = bst.gbdt
    assert _same_splits(out["cuda"].models, out["cpu"].models) >= 30
    assert np.abs(out["cuda"].train_score.cpu().numpy()
                  - out["cpu"].train_score.numpy()).max() < 1e-3
    vh = out["cuda"].valid_sets[0][1]
    infos = out["cuda"].train_set.feature_infos()
    C = out["cuda"].num_tree_per_iteration
    host = np.zeros((C, vh.num_data)) + np.asarray(
        out["cuda"].init_scores)[:, None]
    for i, tree in enumerate(out["cuda"].models):
        if tree.num_leaves > 1:
            host[i % C] += tree.predict_binned(vh.bins_t, infos)
    np.testing.assert_array_equal(
        out["cuda"].valid_scores[0].reshape(C, -1), host)


# ------------------------------------------------------------ 4-bit packing
def _packed_case(G, seed):
    """Bins of G <= 16-bin columns, unpacked [G, N] and packed two a byte
    [ceil(G / 2), N]; K routes of leaves 0..K-1 on even and odd columns
    (numeric, NaN- and zero-missing, categorical; a null route last) in
    both layouts' words; the frontier round's block union."""
    npad = 8 * RB
    fm, binsT, w8, lid = _inputs(G, 16, npad, seed)
    packed = torch.from_numpy(th.pack_bins_4bit(binsT.numpy()))
    rng = np.random.RandomState(seed)
    K = 16
    routes = {False: [], True: []}
    for k in range(K - 1):
        f = (7 * k + 1) % G
        bitset = rng.randint(0, 2**32, size=8, dtype=np.uint64).astype(
            np.uint32)
        for p4 in (False, True):
            routes[p4].append(th.pack_route(
                k, 2 * K + k, f, int(fm.num_bin[f]) // 2, k % 2 == 1,
                k % 4 == 3, bitset, fm, packed4=p4))
    for p4 in (False, True):
        routes[p4] = torch.stack(routes[p4] + [th.null_route()])
    flid = torch.from_numpy(np.sort(rng.randint(0, 2 * K, size=npad)).astype(
        np.int32))
    nblk = npad // RB
    bl, n = th.union_block_list([0, 2, nblk // 2, nblk - 3],
                                [3, 5, nblk // 2 + 2, nblk], [True] * 4)
    return binsT, packed, w8, lid, routes, flid, bl, n


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 28, 41, 1401])
def test_packed_kernels_equal_unpacked_bit_for_bit(dev, G):
    """K1, K3, K2 (by value and from a step block), K5, K6 and K7 on bins
    packed two columns a byte = the same kernels on the unpacked bins,
    bit for bit (the sums are fixed-point integers: the layout cannot
    move them), over the G real columns; each packed kernel = its plain
    version (ids exact, counts exact over every column, the pad nibble's
    included, sums in tolerance).  G odd and even, 41 columns that tile
    K7 fused-K's shared memory, 1401 that tile K1's and K5's."""
    B = 16
    binsT, packed, w8, lid, routes, flid, bl, n = _packed_case(G, G)
    npad = binsT.shape[1]
    nblk = npad // RB
    scales = th.fixed_point_scales(w8)
    du, dp, dw, ds = binsT.to(dev), packed.to(dev), w8.to(dev), scales.to(dev)
    H = 2 * packed.shape[0]
    if G == 1401:
        til = th.segment_tiling(H, B, packed4=True)
        assert til["feature_tiles"] > 1 and til["tile_features"] % 2 == 0
        assert th.all_tiling(H, B, 3, packed4=True)["feature_tiles"] > 1
    if G == 41:
        til = th.frontier_tiling(H, B, 32, 16, 48, packed4=True)
        assert til["feature_tiles"] > 1 and til["tile_features"] % 2 == 0
    # K1 over whole, partial and empty windows
    for lo, nb, target in ((0, nblk, 1), (2, 3, 0), (5, 0, 2)):
        got = th.histogram_segment(dp, dw, lid.to(dev), lo, nb, target, B,
                                   RB, ds, packed4=True)
        unp = th.histogram_segment(du, dw, lid.to(dev), lo, nb, target, B,
                                   RB, ds)
        torch.cuda.synchronize()
        assert got.shape == (H, B, 3) and torch.equal(got[:G], unp)
        want = th.histogram_segment_plain(packed, w8, lid, lo, nb, target, B,
                                          RB, packed4=True)
        assert torch.equal(got[..., 2].cpu(), want[..., 2])
        _assert_hist(got[:G], want[:G], w8, binsT, lid, lo, nb, target, B)
    # K3, K2 and the step entries on every route
    for ru, rp in zip(routes[False][:-1], routes[True]):
        assert int(rp[2]) == int(ru[2]) // 2
        want_lid, want = th.histogram_segment_routed_plain(
            packed, w8, lid.clone(), 1, nblk - 2, 6, rp, B, RB, packed4=True)
        ul, uh = th.histogram_segment_routed(du, dw, lid.to(dev), 1, nblk - 2,
                                             6, ru, B, RB, ds)
        pl, ph = th.histogram_segment_routed(dp, dw, lid.to(dev), 1, nblk - 2,
                                             6, rp, B, RB, ds, packed4=True)
        k2 = th.route_window(dp, lid.to(dev), 1, nblk - 2, rp, RB,
                             packed4=True)
        step = th.pack_step(1, nblk - 2, 6, rp).to(dev)
        sl = lid.to(dev)
        _, sh = th.histogram_segment_routed_step(dp, dw, sl, step, B, RB, ds,
                                                 packed4=True)
        s2 = th.route_window_step(dp, lid.to(dev), step, RB, packed4=True)
        s1 = th.histogram_segment_step(dp, dw, want_lid.to(dev), step, B, RB,
                                       ds, packed4=True)
        k1 = th.histogram_segment(dp, dw, want_lid.to(dev), 1, nblk - 2, 6,
                                  B, RB, ds, packed4=True)
        torch.cuda.synchronize()
        for ids in (ul, pl, k2, sl, s2):
            assert torch.equal(ids.cpu(), want_lid)
        assert torch.equal(ph[:G], uh) and torch.equal(sh, ph)
        assert torch.equal(s1, k1) and torch.equal(k1, ph)
        assert torch.equal(ph[..., 2].cpu(), want[..., 2])
        _assert_hist(ph[:G], want[:G], w8, binsT, want_lid, 1, nblk - 2, 6,
                     B)
    # K5: three class sets
    member = w8[4].float()
    g = w8[0].float() + w8[1].float()
    h = w8[2].float() + w8[3].float()
    w8C = th.pack_channel_sets(torch.stack([g, -g, 0.5 * g]),
                               torch.stack([h, h, 2 * h]), member)
    sc = th.class_scales(w8C).to(dev)
    got = th.histogram_all(dp, w8C.to(dev), B, sc, packed4=True)
    unp = th.histogram_all(du, w8C.to(dev), B, sc)
    want = th.histogram_all_plain(packed, w8C, B, packed4=True)
    torch.cuda.synchronize()
    assert got.shape == (3, H, B, 3) and torch.equal(got[:, :G], unp)
    assert torch.equal(got[..., 2].cpu(), want[..., 2])
    lid0 = torch.zeros(npad, dtype=torch.int32)
    for c in range(3):
        _assert_hist(got[c, :G], want[c, :G], w8C[8 * c:8 * c + 8], binsT,
                     lid0, 0, nblk, 0, B)
    # a K = 16 frontier round: K6 on the routed ids, K7 routed and fused-K
    K = 16
    smaller = torch.tensor([k if k % 3 else 2 * K + k for k in range(K)],
                           dtype=torch.int32)
    targets2 = torch.tensor(list(range(K)) + list(range(2 * K, 3 * K)),
                            dtype=torch.int32)
    routed, _ = th.histogram_frontier_routed_plain(
        packed, w8, flid.clone(), bl, n, smaller, routes[True], B, RB,
        packed4=True)
    assert not torch.equal(routed, flid)
    got = th.histogram_frontier(dp, dw, routed.to(dev), bl.to(dev), n,
                                smaller, B, RB, ds, packed4=True)
    unp = th.histogram_frontier(du, dw, routed.to(dev), bl.to(dev), n,
                                smaller, B, RB, ds)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :G], unp)
    want = th.histogram_frontier_plain(packed, w8, routed, bl, n, smaller, B,
                                       RB, packed4=True)
    _assert_frontier(got[:, :G], want[:, :G], w8, binsT, routed, bl, n,
                     smaller, B)
    for fn, targets in ((th.histogram_frontier_routed, smaller),
                        (th.histogram_frontier_fusedk, targets2)):
        want_lid, want = th.histogram_frontier_routed_plain(
            packed, w8, flid.clone(), bl, n, targets, routes[True], B, RB,
            packed4=True)
        pl, ph = fn(dp, dw, flid.to(dev), bl.to(dev), n, targets,
                    routes[True], B, RB, ds, packed4=True)
        ul, uh = fn(du, dw, flid.to(dev), bl.to(dev), n, targets,
                    routes[False], B, RB, ds)
        torch.cuda.synchronize()
        assert torch.equal(pl.cpu(), want_lid)
        assert torch.equal(ul.cpu(), want_lid)
        assert torch.equal(ph[:, :G], uh)
        assert torch.equal(ph[..., 2].cpu(), want[..., 2])
        _assert_frontier(ph[:, :G], want[:, :G], w8, binsT, want_lid, bl, n,
                         targets, B)


@pytest.mark.cuda
def test_packed_wrappers_reject_wide_bins(dev):
    _, packed, w8, lid, _, _, _, _ = _packed_case(7, 3)
    with pytest.raises(ValueError):     # more than 16 bins cannot pack
        th.histogram_segment(packed.to(dev), w8.to(dev), lid.to(dev), 0, 8,
                             0, 32, RB, th.fixed_point_scales(w8).to(dev),
                             packed4=True)


def _packed_one_hot(n, seed):
    """Two dense columns and 7-way and 5-way one-hot blocks: at max_bin 15
    the 7-way block bundles into one column of 15 bins."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 7, size=n)
    b = rng.randint(0, 5, size=n)
    X = np.concatenate([rng.normal(size=(n, 2)), np.eye(7)[a], np.eye(5)[b]],
                       axis=1)
    y = (X[:, 0] + (a % 3 == 0) - 0.5 * (b == 2)
         + 0.3 * rng.normal(size=n) > 0.4).astype(np.float64)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("bundled", [False, True])
def test_route_trees_on_packed_bins_equals_unpacked(dev, bundled):
    """P1 over packed training bins (with the group tables of a bundled
    dataset) = P1 over the unpacked ones = its plain version, bit for
    bit."""
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.ops import predict as tp
    X, y = (_packed_one_hot(8000, 9) if bundled else _session_data(8000, 9))
    params = dict(objective="binary", num_leaves=31, max_bin=15,
                  min_data_in_leaf=5, verbosity=-1, device_type="cpu")
    bst = lt.train(params, lt.Dataset(X, y), 6, verbose_eval=False)
    g = bst.gbdt
    ds = g.train_set
    assert g.packed4 and (g.fmeta.feat_group is not None) == bundled
    tables = [None if t is None else t.to(dev) for t in (
        g.fmeta.num_bin, g.fmeta.default_bin, g.fmeta.feat_group,
        g.fmeta.feat_offset)]
    stack = TreeStack(g.models, [0] * len(g.models), ds.num_used_features,
                      dev, tp.route_tables(*tables))
    unpacked = torch.from_numpy(ds.bins_t).to(dev)
    packed = torch.from_numpy(th.pack_bins_4bit(ds.bins_t)).to(dev)
    start = torch.zeros((1, ds.num_data), dtype=torch.float64, device=dev)
    want = tp.route_trees(unpacked, stack, tables[0], tables[1],
                          start.clone(), *tables[2:])
    plain = tp.route_trees_plain(packed, stack, tables[0], tables[1],
                                 start.clone(), *tables[2:], packed4=True)
    kernels.reset_launches()
    got = tp.route_trees(packed, stack, tables[0], tables[1], start.clone(),
                         *tables[2:], packed4=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["route_trees_packed4"] == 1
    assert kernels.LAUNCHES["route_trees"] == 0
    assert torch.equal(got, want) and torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "unfused", "frontier",
                                  "multiclass", "bundled"])
def test_packed_boosters_on_card_equal_unpacked_and_cpu(dev, case):
    """At max_bin 15 a card booster trains on packed bins: its model text
    = the card's unpacked booster's, bit for bit; = the CPU booster up to
    a near-tie; its valid scores (P1 over the unpacked valid bins) = the
    host walk, and a rollback (P1 over the packed training bins) = the
    CPU's."""
    X, y = (_packed_one_hot(20_000, 11) if case == "bundled"
            else _session_data(20_000, 11))
    if case == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(
            np.float64)
    params = dict(objective="binary", num_leaves=31, max_bin=15,
                  min_data_in_leaf=5, verbosity=-1)
    kw = {}
    if case == "unfused":
        kw = {"fused_route": False}
    elif case == "frontier":
        params.update(tpu_tree_impl="frontier", tpu_frontier_width=4)
    elif case == "multiclass":
        params.update(objective="multiclass", num_class=3)
    # the kernel that histograms a split on this path
    split_kernel = {"unfused": "histogram_segment_step",
                    "frontier": "histogram_frontier"}.get(
        case, "histogram_segment_routed_step")
    out, launches = {}, {}
    for key, device, packed4 in (("card", "cuda", None),
                                 ("card_unpacked", "cuda", False),
                                 ("cpu", "cpu", None)):
        ds = lt.Dataset(X[:16_000], y[:16_000])
        va = ds.create_valid(X[16_000:], y[16_000:])
        bst = lt.Booster(dict(params, device_type=device), ds,
                         packed4=packed4, **kw)
        bst.add_valid(va, "v")
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        launches[key] = dict(kernels.LAUNCHES)
        assert bst.gbdt.packed4 == (packed4 is None)
        out[key] = bst
    assert launches["card"][split_kernel + "_packed4"] > 0
    assert launches["card"][split_kernel] == 0
    assert launches["card_unpacked"][split_kernel] > 0
    card = out["card"].gbdt
    assert tuple(card.bins.shape) == (-(-card.train_set.num_columns // 2),
                                      card.bins.shape[1])
    assert (card.fmeta.feat_group is not None) == (case == "bundled")
    text = out["card"].model_to_string()
    assert text == out["card_unpacked"].model_to_string()
    assert _same_splits(card.models, out["cpu"].gbdt.models) >= 30
    vh = card.valid_sets[0][1]
    infos = card.train_set.feature_infos()
    C = card.num_tree_per_iteration
    host = np.zeros((C, vh.num_data)) + np.asarray(card.init_scores)[:, None]
    for i, tree in enumerate(card.models):
        if tree.num_leaves > 1:
            host[i % C] += tree.predict_binned(vh.bins_t, infos)
    np.testing.assert_array_equal(card.valid_scores[0].reshape(C, -1), host)
    before = card.train_score.clone()
    out["card"].rollback_one_iter()
    out["card_unpacked"].rollback_one_iter()
    assert not torch.equal(card.train_score, before)
    assert torch.equal(card.train_score,
                       out["card_unpacked"].gbdt.train_score)


# -------------------------------------------- the packed-accumulator stream
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12, 15])
def test_quantize_pack_equals_plain(dev, bits):
    """Q1 at 10M rows = its plain version bit for bit: the stream, the
    scales and the clip count (one launch)."""
    n = 10_000_000
    gen = torch.Generator(device=dev).manual_seed(bits)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev) * 0.25
    member = (torch.rand(n, generator=gen, device=dev) > 0.2).float()
    member[-1000:] = 0.0
    kernels.reset_launches()
    w2, scales, clips = th.quantize_pack(grad, hess, member, bits)
    sc, seed = th.quantize_inputs(grad, hess, member, bits)
    want, want_clips = th.quantize_pack_plain(grad, hess, member, sc, seed,
                                              bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_pack"] == 1
    assert w2.shape == (2, n) and torch.equal(w2, want)
    assert torch.equal(scales, sc) and int(clips) == int(want_clips) > 0
    assert not w2[:, -1000:].any()


def _acc_case(G, packed4, seed):
    """A packed-accumulator case: bins of G columns (16 bins packed two a
    byte, or 64), the stream at 12 bits (bf16-rounded values), leaf ids,
    16 routes of leaves 0..15 (a null route last) and a frontier round's
    block union."""
    B = 16 if packed4 else 64
    npad = 8 * RB
    fm, binsT, w8, lid = _inputs(G, B, npad, seed)
    bins = (torch.from_numpy(th.pack_bins_4bit(binsT.numpy())) if packed4
            else binsT)
    grad = w8[0].float() + w8[1].float()
    hess = w8[2].float() + w8[3].float()
    w2, scales, _ = th.quantize_pack(grad, hess, w8[4].float(), 12)
    rng = np.random.RandomState(seed)
    K = 16
    routes = []
    for k in range(K - 1):
        f = (7 * k + 1) % G
        bitset = rng.randint(0, 2**32, size=8, dtype=np.uint64).astype(
            np.uint32)
        routes.append(th.pack_route(k, 2 * K + k, f, int(fm.num_bin[f]) // 2,
                                    k % 2 == 1, k % 4 == 3, bitset, fm,
                                    packed4=packed4))
    routes = torch.stack(routes + [th.null_route()])
    flid = torch.from_numpy(np.sort(rng.randint(0, 2 * K, size=npad)).astype(
        np.int32))
    nblk = npad // RB
    bl, n = th.union_block_list([0, 2, nblk // 2, nblk - 3],
                                [3, 5, nblk // 2 + 2, nblk], [True] * 4)
    return B, bins, w2, scales, lid, routes, flid, bl, n


@pytest.mark.cuda
@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("G", [7, 28, 41])
def test_packed_acc_kernels_equal_plain(dev, G, packed4):
    """Every packed-accumulator kernel = its plain version bit for bit
    (leaf ids and histograms: integer sums, dequantized in one order): K1
    over whole, partial and empty windows, K3 and both step entries on
    every route, K5, a K = 16 frontier round (K6, K7 routed and fused-K)
    and a 5-route fused-K call; each launch counted under its
    ``_packed_acc`` name.  41 columns tile K7 fused-K's shared memory."""
    B, bins, w2, scales, lid, routes, flid, bl, n = _acc_case(G, packed4, G)
    npad = bins.shape[1]
    nblk = npad // RB
    db, dw, ds = bins.to(dev), w2.to(dev), scales.to(dev)
    H = th.logical_columns(bins, packed4)
    kernels.reset_launches()
    for lo, nb, target in ((0, nblk, 1), (2, 3, 0), (5, 0, 2)):
        got = th.histogram_segment(db, dw, lid.to(dev), lo, nb, target, B,
                                   RB, ds, packed4=packed4)
        want = th.histogram_segment_plain(bins, w2, lid, lo, nb, target, B,
                                          RB, packed4, scales)
        assert got.shape == (H, B, 3) and torch.equal(got.cpu(), want)
    for r in routes[:-1]:
        want_lid, want = th.histogram_segment_routed_plain(
            bins, w2, lid.clone(), 1, nblk - 2, 6, r, B, RB, packed4, scales)
        kl, kh = th.histogram_segment_routed(db, dw, lid.to(dev), 1,
                                             nblk - 2, 6, r, B, RB, ds,
                                             packed4=packed4)
        step = th.pack_step(1, nblk - 2, 6, r).to(dev)
        sl = lid.to(dev)
        _, sh = th.histogram_segment_routed_step(db, dw, sl, step, B, RB, ds,
                                                 packed4=packed4)
        s1 = th.histogram_segment_step(db, dw, want_lid.to(dev), step, B, RB,
                                       ds, packed4=packed4)
        torch.cuda.synchronize()
        assert torch.equal(kl.cpu(), want_lid) and torch.equal(sl.cpu(),
                                                               want_lid)
        for h in (kh, sh, s1):
            assert torch.equal(h.cpu(), want)
    got = th.histogram_all(db, dw, B, ds, packed4)
    want = th.histogram_all_plain(bins, w2, B, packed4, scales)
    assert got.shape == (1, H, B, 3) and torch.equal(got.cpu(), want)
    K = 16
    smaller = torch.tensor([k if k % 3 else 2 * K + k for k in range(K)],
                           dtype=torch.int32)
    targets2 = torch.tensor(list(range(K)) + list(range(2 * K, 3 * K)),
                            dtype=torch.int32)
    if G == 41:
        til = th.frontier_tiling(H, B, 2 * K, K, 3 * K, packed4, True)
        assert til["feature_tiles"] > 1
    got = th.histogram_frontier(db, dw, flid.to(dev), bl.to(dev), n, smaller,
                                B, RB, ds, packed4)
    want = th.histogram_frontier_plain(bins, w2, flid, bl, n, smaller, B, RB,
                                       packed4, scales)
    assert torch.equal(got.cpu(), want)
    for fn, targets, rts in (
            (th.histogram_frontier_routed, smaller, routes),
            (th.histogram_frontier_fusedk, targets2, routes),
            (th.histogram_frontier_fusedk,
             torch.tensor([0, 1, 2, 3, 4, 32, 33, 34, 35, 36],
                          dtype=torch.int32), routes[:5])):
        want_lid, want = th.histogram_frontier_routed_plain(
            bins, w2, flid.clone(), bl, n, targets, rts, B, RB, packed4,
            scales)
        gl, gh = fn(db, dw, flid.to(dev), bl.to(dev), n, targets, rts, B,
                    RB, ds, packed4)
        torch.cuda.synchronize()
        assert torch.equal(gl.cpu(), want_lid) and torch.equal(gh.cpu(), want)
    for name, calls in (("histogram_segment", 3),
                        ("histogram_segment_routed", K - 1),
                        ("histogram_segment_routed_step", K - 1),
                        ("histogram_segment_step", K - 1),
                        ("histogram_all", 1), ("histogram_frontier", 1),
                        ("histogram_frontier_routed", 1),
                        ("histogram_frontier_fusedk", 2)):
        assert kernels.LAUNCHES[kernels.variant(name, packed4, True)] == calls
        assert kernels.LAUNCHES[kernels.variant(name, packed4)] == 0


@pytest.mark.cuda
def test_packed_acc_int32_planes_stay_exact(dev):
    """Every row carries the largest value (qmax 16383 at 15 bits, 2^14
    once bf16-rounded) into one bin, over 20M rows: more than one block's
    int32 plane could hold if a block walked its share of one wave, so the
    launches give each block at most kAccMaxRows rows.  K1, K3, the step
    entry, K5 and K6 give the exact sum, as the plain version does."""
    n, rb = 20_000_000, 1000
    bins = torch.zeros((1, n), dtype=torch.uint8, device=dev)
    one = torch.ones(n, device=dev)
    w2, scales, clips = th.quantize_pack(one, one, one, 15)
    assert int(clips) == 2 * n
    lid = torch.zeros(n, dtype=torch.int32, device=dev)
    want = th.histogram_segment_plain(bins, w2, lid, 0, n // rb, 0, 256, rb,
                                      False, scales)
    exact = np.float32(np.float32(n * 16384) * scales[0].item())
    assert want[0, 0, 0].item() == exact and want[0, 0, 2].item() == n
    step = th.pack_step(0, n // rb, 0, th.null_route()).to(dev)
    blocks = torch.arange(n // rb, dtype=torch.int32, device=dev)
    outs = [th.histogram_segment(bins, w2, lid, 0, n // rb, 0, 256, rb,
                                 scales),
            th.histogram_segment_routed(bins, w2, lid, 0, n // rb, 0,
                                        th.null_route(), 256, rb, scales)[1],
            th.histogram_segment_step(bins, w2, lid, step, 256, rb, scales),
            th.histogram_all(bins, w2, 256, scales)[0],
            th.histogram_frontier(bins, w2, lid, blocks, n // rb,
                                  torch.tensor([0], dtype=torch.int32), 256,
                                  rb, scales)[0]]
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, want)


ACC_CASES = {
    "segment_unfused": ({}, {}),
    "segment_fused": ({}, {"fused_route": True}),
    "frontier_off": ({"tpu_tree_impl": "frontier", "tpu_frontier_width": 4},
                     {}),
    "frontier_k1": ({"tpu_tree_impl": "frontier", "tpu_frontier_width": 4},
                    {"frontier_tier": "k1"}),
    "frontier_fusedk": ({"tpu_tree_impl": "frontier",
                         "tpu_frontier_width": 4},
                        {"frontier_tier": "fusedk"}),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, {}),
}


def _same_tree_arrays(a, b, tag):
    """Two grown trees (TreeArrays): the same splits at gain > 1e-2 up to
    a near-tie (two gains within 1e-4), the same leaf values within 1e-5
    where no near-tie was met.  Returns the splits compared."""
    assert a.num_leaves == b.num_leaves, tag
    for k in range(a.num_leaves - 1):
        ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
        if ga <= 1e-2 or gb <= 1e-2:
            return k
        if (a.split_feature[k], a.threshold_bin[k]) != (
                b.split_feature[k], b.threshold_bin[k]):
            assert abs(ga - gb) <= 1e-4 * max(ga, gb), (tag, k, ga, gb)
            return k
    np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                               b.leaf_value[:b.num_leaves], rtol=1e-5,
                               atol=1e-6)
    return a.num_leaves - 1


@pytest.mark.cuda
@pytest.mark.parametrize("grower", ["segment_unfused", "segment_fused",
                                    "frontier_off", "frontier_fusedk"])
def test_packed_acc_growers_on_card_equal_cpu(dev, grower):
    """Fed the same bins and gradient arrays, a packed_acc grower on the
    card grows the CPU's trees split for split (Q1 = its plain version
    and the kernels' integer sums = the plain ones, bit for bit), and the
    same quant_clips, at 200k rows."""
    from lightgbm_tpu_torch.models.grower import GrowerParams
    from lightgbm_tpu_torch.models.grower_frontier import FrontierGrower
    from lightgbm_tpu_torch.models.grower_seg import SegmentGrower
    npad, G, B = 200 * 1024, 8, 64
    fm, binsT, _, _ = _inputs(G, B, npad, 29)
    meta = {d: FeatureMeta(*(None if t is None else torch.from_numpy(
        np.asarray(t)).to(d) for t in fm)) for d in ("cpu", "cuda")}
    rng = np.random.RandomState(5)
    member = np.ones(npad, np.float32)
    member[-300:] = 0.0
    p = GrowerParams(num_leaves=31, packed_acc=True,
                     split=SplitParams(min_data_in_leaf=20.0))
    growers = {}
    for d in ("cpu", "cuda"):
        if grower.startswith("segment"):
            growers[d] = SegmentGrower(B, p, 1024,
                                       fused_route=grower == "segment_fused")
        else:
            growers[d] = FrontierGrower(B, p, 1024, 4,
                                        tier=grower.split("_")[1])
    compared = 0
    for t in range(3):
        signal = (binsT[0].numpy() / B + 0.5 * (binsT[3].numpy() > B // 2)
                  + 0.3 * rng.normal(size=npad))
        grad = ((0.5 - (signal > 0.8)) * member).astype(np.float32)
        hess = (rng.uniform(0.1, 0.3, size=npad) * member).astype(np.float32)
        out = {}
        for d in ("cpu", "cuda"):
            args = [x.to(d) for x in (binsT, torch.from_numpy(grad),
                                      torch.from_numpy(hess),
                                      torch.from_numpy(member))]
            kernels.reset_launches()
            tree, lid = growers[d].grow(*args, meta[d])
            out[d] = (tree, lid.cpu(), growers[d].last_stats["quant_clips"])
            if d == "cuda":
                assert kernels.LAUNCHES["quantize_pack"] == 1
        assert out["cuda"][2] == out["cpu"][2]
        compared += _same_tree_arrays(out["cuda"][0], out["cpu"][0],
                                      f"{grower} tree {t}")
    assert compared >= 60


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_packed_acc_boosters_on_card_equal_cpu(dev, case):
    """A packed_acc booster on the card at 200k rows: its histograms from
    the ``_packed_acc`` kernels only, fed by Q1 once a tree (multiclass
    roots on K5's f32 channels); its first iteration's trees = the CPU
    booster's split for split.  Later trees quantize gradients whose bits
    differ from the CPU's by the f32 rounding of the root sums (torch's
    reductions on the two devices), so their stochastic rounding draws
    other uniforms: the models are held to the JAX package's gate for a
    quantized model, predictions within 0.12."""
    X, y = _session_data(220_000, 13)
    if case == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(
            np.float64)
    extra, kw = ACC_CASES[case]
    params = dict(dict(objective="binary", num_leaves=31, max_bin=63,
                       min_data_in_leaf=20, verbosity=-1), **extra)
    split_kernel = {"segment_unfused": "histogram_segment_step",
                    "segment_fused": "histogram_segment_routed_step",
                    "frontier_off": "histogram_frontier",
                    "frontier_k1": "histogram_frontier_routed",
                    "frontier_fusedk": "histogram_frontier_fusedk",
                    "multiclass": "histogram_segment_step"}[case]
    out = {}
    preds = {}
    for device in ("cuda", "cpu"):
        ds = lt.Dataset(X[:200_000], y[:200_000])
        bst = lt.Booster(dict(params, device_type=device), ds,
                         packed_acc=True, **kw)
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        out[device] = bst.gbdt
        preds[device] = bst.predict(X[200_000:])
        if device == "cuda":
            run = dict(kernels.LAUNCHES)
    C = out["cuda"].num_tree_per_iteration
    assert run["quantize_pack"] == 3 * C
    assert run[split_kernel + "_packed_acc"] > 0 and run[split_kernel] == 0
    assert run["histogram_all"] == (3 if C > 1 else 0)
    assert run["histogram_all_packed_acc"] == 0
    for name in kernels.PACKED_ACC_KERNELS:
        if name != "histogram_all":
            assert run[name] == 0, name
    assert out["cuda"].grower.last_stats["quant_clips"] >= 0
    assert _same_splits(out["cuda"].models[:C], out["cpu"].models[:C]) >= 20
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], atol=0.12)


# ------------------------------------------ P1's node records and modes
def _random_tree(rng, leaves, num_bin, cat_features=(), chain=False):
    """A tree of ``leaves`` leaves in LightGBM's numbering, random splits
    (thresholds inside each feature's bins, missing types, default
    directions, bitsets on ``cat_features``); ``chain``: each split takes
    the newest leaf at threshold 0, so rows that never hold bin 0 walk
    all ``leaves - 1`` steps."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(leaves)
    t.leaf_value = rng.normal(size=max(leaves, 1))
    hang = {0: (-1, 0)}
    for i in range(leaves - 1):
        leaf = i if chain else int(rng.randint(0, i + 1))
        parent, side = hang[leaf]
        if parent >= 0:
            (t.left_child if side == 0 else t.right_child)[parent] = i
        t.left_child[i], t.right_child[i] = ~leaf, ~(i + 1)
        hang[leaf], hang[i + 1] = (i, 0), (i, 1)
        f = int(rng.randint(0, len(num_bin)))
        t.split_feature_inner[i] = f
        if f in cat_features and not chain:
            t.decision_type[i] = 1
            t.threshold_in_bin[i] = len(t.cat_threshold_inner)
            t.cat_threshold_inner.append(rng.randint(
                0, 2**32, size=8, dtype=np.uint64).astype(np.uint32))
        elif chain:
            t.threshold_in_bin[i] = 0
        else:
            t.decision_type[i] = (int(rng.randint(0, 3)) << 2) | (
                2 * int(rng.randint(0, 2)))
            t.threshold_in_bin[i] = int(rng.randint(0, num_bin[f]))
    return t


# 5 classes, interleaved: single leaves, 255 leaves, a chain of 100 (99
# steps, the stack's max_depth + 1 bound of the plain route is 100), a tree
# larger than a stage (read in place); about 60 KB of records and leaves,
# four stages
P1_LEAVES = (15, 1, 255, 31, 7, 255, 3, 63, 255, 1200, 2, 100)
P1_CHAIN = 11


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode", [
    ("u8", "tiled"), ("u8", "direct"), ("i16", "direct"),
    ("i16", "direct_wide"), ("packed4", "tiled"), ("packed4", "direct"),
    ("efb", "tiled"), ("efb", "direct")])
def test_route_trees_modes_equal_plain(dev, kind, mode):
    """P1 = its plain version bit for bit in the tiled mode (a row tile of
    u8 bins in shared memory) and the direct mode (bins read in place,
    where the matrix's columns are too many for a tile, and i16 bins: the
    shapes pick it), on u8, i16 (with the -1 sentinel), 4-bit packed and
    EFB-bundled bins, at
    5003 rows (not a multiple of a tile or of the rows a thread) of a
    matrix of 5100 (stride > n), C = 5 with interleaved classes and a
    stack of four stages and an in-place chunk; one launch a call."""
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.ops import predict as tp
    rng = np.random.RandomState(11)
    n, S, F, C = 5003, 5100, 24, 5
    packed4 = kind == "packed4"
    num_bin = rng.randint(2, 17 if packed4 else 64, size=F)
    if kind == "efb":
        num_bin[12:] = rng.randint(2, 40, size=F - 12)   # 6 a column
    cat = () if packed4 else (3, 9)
    trees = [_random_tree(rng, L, num_bin, cat, chain=i == P1_CHAIN)
             for i, L in enumerate(P1_LEAVES)]
    default_bin = np.array([int(rng.randint(0, b)) for b in num_bin])
    # the direct mode: the features' columns spread over a matrix whose
    # tile would not fit; else the features own columns 0..F-1 (EFB: the
    # last 12 share two columns at offsets)
    wide = mode == "direct_wide" or (mode == "direct" and kind != "i16")
    G = 7000 if wide else F
    group = rng.choice(G, F, replace=False) if wide else np.arange(F)
    offset = np.zeros(F, dtype=np.int64)
    if kind == "efb":
        for j, g in enumerate(range(12, F)):
            group[g] = group[12 + j % 2]
        for c in set(group[12:]):
            at = 1
            for j in np.nonzero(group == c)[0]:
                offset[j], at = at, at + num_bin[j]
    col_bins = np.full(G, 2)
    for j in range(F):
        col_bins[group[j]] = max(col_bins[group[j]],
                                 offset[j] + num_bin[j] + (kind == "efb"))
    bins = (rng.rand(G, S) * col_bins[:, None]).astype(np.int64)
    if kind == "i16":
        bins[:, rng.rand(S) < 0.1] = -1
        bins = torch.from_numpy(bins.astype(np.int16))
    elif packed4:
        bins = torch.from_numpy(th.pack_bins_4bit(bins.astype(np.uint8)))
    else:
        bins = torch.from_numpy(bins.astype(np.uint8))
    bins = bins.to(dev)
    assert tp.route_plan(bins.shape[0], bins.element_size())[1] == (
        mode == "tiled")
    tables = tp.route_tables(num_bin, default_bin, group, offset)
    dtab = [torch.from_numpy(a).int().to(dev) for a in tables]
    stack = TreeStack(trees, [i % C for i in range(len(trees))], F, dev,
                      tables)
    buf, layout = stack.records(F)
    assert layout.num_chunks >= 4
    start = torch.randn((C, n), dtype=torch.float64, device=dev)
    want = tp.route_trees_plain(bins, stack, dtab[0], dtab[1],
                                start.clone(), dtab[2], dtab[3], packed4)
    kernels.reset_launches()
    got = tp.route_trees(bins, stack, dtab[0], dtab[1], start.clone(),
                         dtab[2], dtab[3], packed4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernels.variant("route_trees", packed4)] == 1
    assert torch.equal(got, want)
    assert not torch.equal(got, start)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", list(range(2, 16)))
def test_quantize_pack_every_width_equals_plain(dev, bits):
    """Q1 at every width = its plain version bit for bit (stream, scales,
    clips), at a row count that is a multiple of the vector width (even
    widths: 16-byte loads and stores) and one that is not (odd widths),
    with gradients of both signs tied at the largest magnitude."""
    n = 1_000_004 if bits % 2 == 0 else 1_000_003
    gen = torch.Generator(device=dev).manual_seed(100 + bits)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev) * 0.25
    member = (torch.rand(n, generator=gen, device=dev) > 0.3).float()
    grad[[7, 500_001, n - 1]] = torch.tensor([9.5, -9.5, 9.5], device=dev)
    hess[[3, n - 2]] = 0.75
    member[[7, 500_001, n - 1, 3, n - 2]] = 1.0
    grad[11], member[11] = 50.0, 0.0          # out of the bag: not the max
    kernels.reset_launches()
    w2, scales, clips = th.quantize_pack(grad, hess, member, bits)
    sc, seed = th.quantize_inputs(grad, hess, member, bits)
    want, want_clips = th.quantize_pack_plain(grad, hess, member, sc, seed,
                                              bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_pack"] == 1
    qmax = 2 ** (bits - 1) - 1
    assert float(scales[0]) == np.float32(np.float32(9.5) / np.float32(qmax))
    assert torch.equal(w2, want) and torch.equal(scales, sc)
    assert int(clips) == int(want_clips) >= 3


@pytest.mark.cuda
def test_quantize_pack_zero_member_and_nonfinite_scales(dev):
    """An all-zero member gives the scales' 1e-30 floor and a zero stream
    (= the plain version); an inf gradient and a NaN hessian give
    non-finite scales exactly where the plain version does."""
    n = 100_003
    gen = torch.Generator(device=dev).manual_seed(3)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev)
    zero = torch.zeros(n, device=dev)
    w2, scales, clips = th.quantize_pack(grad, hess, zero, 8)
    sc, seed = th.quantize_inputs(grad, hess, zero, 8)
    want, _ = th.quantize_pack_plain(grad, hess, zero, sc, seed, 8)
    assert torch.equal(w2, want) and torch.equal(scales, sc)
    assert float(scales[0]) == np.float32(np.float32(1e-30) / np.float32(127))
    assert int(clips) == 0 and not w2[0].any()
    one = torch.ones(n, device=dev)
    for g_bad, h_bad in ((float("inf"), None), (None, float("nan")),
                         (float("-inf"), float("nan"))):
        g, h = grad.clone(), hess.clone()
        if g_bad is not None:
            g[n // 2] = g_bad
        if h_bad is not None:
            h[17] = h_bad
        _, scales, _ = th.quantize_pack(g, h, one, 8)
        sc, _ = th.quantize_inputs(g, h, one, 8)
        assert torch.equal(torch.isfinite(scales), torch.isfinite(sc))
        assert torch.equal(torch.isnan(scales), torch.isnan(sc))
        assert not bool(torch.isfinite(scales).all())


@pytest.mark.cuda
def test_quantize_pack_is_two_kernels_a_call(dev):
    """Q1 puts two kernels and no copy or memset on the stream a call
    (chip_smoke.device_ops_per_call, after a warm-up call); the scratch it
    shares across calls is left zero, so calls back to back at other
    sizes give the plain version's bits."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke
    gen = torch.Generator(device=dev).manual_seed(4)
    for n in (4_000_000, 123, 1):
        grad = torch.randn(n, generator=gen, device=dev)
        hess = torch.rand(n, generator=gen, device=dev)
        member = torch.ones(n, device=dev)
        ops = chip_smoke.device_ops_per_call(
            lambda: th.quantize_pack(grad, hess, member))
        if ops is not None:
            assert (ops["kernel"], ops["memcpy"], ops["memset"]) == (2, 0, 0)
        w2, scales, clips = th.quantize_pack(grad, hess, member)
        sc, seed = th.quantize_inputs(grad, hess, member, 8)
        want, want_clips = th.quantize_pack_plain(grad, hess, member, sc,
                                                  seed, 8)
        assert torch.equal(w2, want) and torch.equal(scales, sc)
        assert int(clips) == int(want_clips)
    assert not th._QUANT_SCRATCH[torch.cuda.current_device()].any()


# the split features: monotone constraints of both signs, feature_contri
# and CEGB's costs on the segment and frontier growers; a forced plan and
# CEGB-lazy on the fused grower (models/grower_fused.py)
SF_MONO = [1, -1, 0, 0, 1, 0, -1, 0]
SF_FEATURES = {
    "segment_monotone": ({}, {"monotone_constraints": SF_MONO}),
    "segment_contri_cegb": ({}, {
        "feature_contri": [1.0, 0.5, 1.0, 0.8, 1.0, 0.3, 1.0, 1.0],
        "cegb_penalty_split": 1e-4,
        "cegb_penalty_feature_coupled": [2.0] * 8}),
    "frontier_monotone": ({"tpu_tree_impl": "frontier",
                           "tpu_frontier_width": 4},
                          {"monotone_constraints": SF_MONO}),
    "frontier_contri_cegb": ({"tpu_tree_impl": "frontier",
                              "tpu_frontier_width": 4}, {
        "feature_contri": [0.6, 1.0, 1.0, 0.8, 1.0, 0.3, 1.0, 1.0],
        "cegb_penalty_split": 1e-4,
        "cegb_penalty_feature_coupled": [2.0] * 8}),
    "fused_forced": ({}, {"forcedsplits_filename": "PLAN",
                          "monotone_constraints": SF_MONO}),
    "fused_lazy": ({}, {"cegb_penalty_feature_lazy": [1e-3] * 8}),
}
SF_PLAN = {"feature": 0, "threshold": 0.0,
           "left": {"feature": 1, "threshold": 0.0,
                    "left": {"feature": 2, "threshold": 0.3}},
           "right": {"feature": 2, "threshold": -0.2}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SF_FEATURES))
def test_split_features_on_card_equal_cpu(dev, case, tmp_path):
    """Each split feature on its grower, on the card and the CPU at 40k
    rows: the same splits up to a near-tie, predictions monotone in every
    constrained feature; the segment grower's graph holds the bounds and
    the used features (one model text for steps 1 and 4 on the card); the
    fused grower launches K5 once for each tree's root and once a split,
    K2 once a split, and no other histogram kernel."""
    import json
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(SF_PLAN))
    X, y = _session_data(40_000, 27)
    base, feats = SF_FEATURES[case]
    feats = {k: (str(plan) if v == "PLAN" else v) for k, v in feats.items()}
    params = dict(objective="binary", num_leaves=31, max_bin=63,
                  min_data_in_leaf=20, verbosity=-1, **base, **feats)
    models, texts = {}, {}
    for device in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=device), lt.Dataset(X, y))
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        models[device] = bst.gbdt.models
        if device == "cuda":
            run = dict(kernels.LAUNCHES)
            card = bst
    assert _same_splits(models["cuda"], models["cpu"]) >= 30
    grower = type(card.gbdt.grower).__name__
    assert grower == {"segment": "SegmentGrower",
                      "frontier": "FrontierGrower",
                      "fused": "FusedGrower"}[case.split("_")[0]]
    if "monotone_constraints" in feats:
        grid = np.linspace(-3, 3, 200)
        for f, sign in enumerate(SF_MONO):
            if sign:
                Xs = np.repeat(X[:5], 200, axis=0)
                Xs[:, f] = np.tile(grid, 5)
                pred = card.predict(Xs, raw_score=True).reshape(5, 200)
                assert (sign * np.diff(pred, axis=1)).min() >= 0.0
    if grower == "FusedGrower":
        nodes = sum(t.num_leaves for t in card.gbdt.models)
        splits = nodes - len(card.gbdt.models)
        assert run["histogram_all"] == nodes
        assert run["route_window"] == splits
        assert not any(run[k] for k in (
            "histogram_segment", "histogram_segment_routed",
            "histogram_segment_step", "histogram_segment_routed_step",
            "histogram_frontier", "histogram_frontier_routed"))
    if grower == "SegmentGrower":
        assert card.gbdt.grower.last_stats["graph"]
        for steps in (1, 4):
            b = lt.Booster(dict(params, device_type="cuda"),
                           lt.Dataset(X, y))
            b.gbdt.grower.steps = steps
            for _ in range(3):
                b.update()
            texts[steps] = b.model_to_string()
        assert texts[1] == texts[4] == card.model_to_string()
