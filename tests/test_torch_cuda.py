"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
from lightgbm_tpu_torch.ops.split import FeatureMeta

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
        kernels.reset_launches()
        for _ in range(3):
            bst.update()
        leaves = sum(t.num_leaves for t in bst.gbdt.models)
        n = dict(kernels.LAUNCHES)
        if device == "cuda" and fused:
            assert n["histogram_segment_routed"] == leaves
            assert n["histogram_segment"] == n["route_window"] == 0
        elif device == "cuda":
            assert n["histogram_segment"] == leaves
            assert n["route_window"] == leaves - 3
            assert n["histogram_segment_routed"] == 0
        else:
            assert sum(n.values()) == 0
        if device == "cuda":
            assert n["score_gather_add"] == 3
        texts[(device, fused)] = bst.model_to_string().split("parameters:")[0]
        raws[(device, fused)] = bst.predict(X, raw_score=True)
    assert texts[("cuda", True)] == texts[("cuda", False)]
    assert np.abs(raws[("cuda", True)] - raws[("cpu", True)]).max() < 1e-3
