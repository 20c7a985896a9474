"""Kernel-level parity of the PyTorch port (lightgbm_tpu_torch) with the
JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function — its Pallas
kernels in interpret mode — and through the port's wrapper, which on CPU
tensors runs the kernel's plain PyTorch version.  Tolerances:

  * counts, leaf ids, route words, packed channels and score updates are
    exact (integer data, or one IEEE float add per element);
  * gradient/hessian sums agree within 1e-5 x (sum of |g| in the bin):
    both sides sum the same bf16 channel values, the TPU kernel in
    float32 through its matmul, the port's plain version in float64.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import pallas_score as jps
from lightgbm_tpu.ops.split import FeatureMeta as JaxFeatureMeta
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import score as ts
from lightgbm_tpu_torch.ops.split import FeatureMeta

F, B, RB, NPAD = 5, 64, 256, 2048
NUM_BIN = np.array([64, 40, 17, 64, 3], dtype=np.int32)
MISSING = np.array([0, 2, 1, 2, 0], dtype=np.int32)     # none/nan/zero
DEFAULT_BIN = np.array([0, 7, 5, 0, 1], dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    bins = np.stack([rng.randint(0, nb, size=NPAD) for nb in NUM_BIN]
                    ).astype(np.uint8)
    grad = rng.normal(size=NPAD).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=NPAD).astype(np.float32)
    member = np.ones(NPAD, np.float32)
    member[-100:] = 0.0                                  # pad rows
    lid = rng.randint(0, 4, size=NPAD).astype(np.int32)
    return bins, grad, hess, member, lid


def _w8(grad, hess, member):
    return th.pack_channels(torch.from_numpy(grad), torch.from_numpy(hess),
                            torch.from_numpy(member))


def _bits(t):
    return t.view(torch.int16).numpy()


def _jax_fmeta(efb=False):
    kw = {}
    if efb:
        kw = dict(feat_group=jnp.asarray([0, 1, 1, 2, 3], jnp.int32),
                  feat_offset=jnp.asarray([0, 0, 20, 0, 0], jnp.int32))
    return JaxFeatureMeta(
        num_bin=jnp.asarray(NUM_BIN), missing_type=jnp.asarray(MISSING),
        default_bin=jnp.asarray(DEFAULT_BIN),
        is_cat=jnp.zeros(F, bool), monotone=jnp.zeros(F, jnp.int32),
        penalty=jnp.ones(F, jnp.float32), **kw)


def _host_fmeta():
    return FeatureMeta(NUM_BIN, MISSING, DEFAULT_BIN)


def _assert_hist_close(got, want, bins, w8, lid, lo, hi, target):
    """counts exact; g/h within 1e-5 x the bin's sum of |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sel = np.zeros(NPAD, bool)
    sel[lo:hi] = lid[lo:hi] == target
    ch = w8[:4].float().numpy().astype(np.float64)
    g_abs = np.abs(ch[0] + ch[1]) * sel
    h_abs = np.abs(ch[2] + ch[3]) * sel
    for f in range(F):
        ga = np.bincount(bins[f], weights=g_abs, minlength=B)
        ha = np.bincount(bins[f], weights=h_abs, minlength=B)
        np.testing.assert_array_equal(got[f, :, 2], want[f, :, 2])
        assert np.all(np.abs(got[f, :, 0] - want[f, :, 0])
                      <= 1e-5 * ga + 1e-30)
        assert np.all(np.abs(got[f, :, 1] - want[f, :, 1])
                      <= 1e-5 * ha + 1e-30)


def test_pack_channels_bit_identical():
    _, grad, hess, member, _ = _inputs()
    grad[:4] = [1e-30, -3.5e7, 0.0, -0.0]
    got = _bits(_w8(grad, hess, member))
    want = np.asarray(jph.pack_channels(jnp.asarray(grad), jnp.asarray(hess),
                                        jnp.asarray(member))
                      ).view(np.int16)
    np.testing.assert_array_equal(got, want)


def test_unpack_hist_matches():
    rng = np.random.RandomState(1)
    out = rng.normal(size=(F, B, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        th.unpack_hist(torch.from_numpy(out)).numpy(),
        np.asarray(jph.unpack_hist(jnp.asarray(out))))


@pytest.mark.parametrize("f,t,dl,cat", [(0, 20, False, False),
                                        (1, 9, True, False),
                                        (2, 3, True, False),
                                        (3, 0, False, True)])
def test_pack_route_words_equal(f, t, dl, cat):
    bitset = np.array([0x80000001, 5, 0, 0xFFFFFFFF, 0, 0, 0, 1],
                      dtype=np.uint32)
    want = np.asarray(jph.pack_route(2, 9, f, t, dl, cat,
                                     jnp.asarray(bitset), _jax_fmeta(),
                                     False))
    got = th.pack_route(2, 9, f, t, dl, cat, bitset, _host_fmeta())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(th.null_route().numpy(),
                                  np.asarray(jph.null_route()))


@pytest.mark.parametrize("start,nblk,target", [(0, 8, 0), (2, 3, 1),
                                               (5, 0, 2), (7, 1, 3)])
def test_histogram_segment_matches_jax(start, nblk, target):
    bins, grad, hess, member, lid = _inputs(start)
    w8 = _w8(grad, hess, member)
    want = np.asarray(jph.unpack_hist(jph.histogram_segment(
        jnp.asarray(bins), jnp.asarray(w8.float().numpy(), jnp.bfloat16),
        jnp.asarray(lid), jnp.int32(start), jnp.int32(nblk),
        jnp.int32(target), B, RB, interpret=True)))
    got = th.histogram_segment(torch.from_numpy(bins), w8,
                               torch.from_numpy(lid), start, nblk, target,
                               B, RB, th.fixed_point_scales(w8))
    _assert_hist_close(got.numpy(), want, bins, w8, lid, start * RB,
                       (start + nblk) * RB, target)


def _routes():
    """(descriptor, jax fmeta) pairs: numeric, NaN-missing, zero-missing,
    categorical bitset, and an EFB offset column."""
    fm, efb = _jax_fmeta(), _jax_fmeta(efb=True)
    bitset = jnp.asarray(np.array([0b1011001, 0, 0, 0, 0, 0, 0, 0],
                                  np.uint32))
    none = jnp.zeros(8, jnp.uint32)
    return [jph.pack_route(1, 6, 0, 31, False, False, none, fm, False),
            jph.pack_route(2, 6, 1, 12, True, False, none, fm, False),
            jph.pack_route(0, 6, 2, 8, False, False, none, fm, False),
            jph.pack_route(0, 6, 2, 8, True, False, none, fm, False),
            jph.pack_route(3, 6, 4, 0, False, True, bitset, fm, False),
            jph.pack_route(1, 6, 2, 4, True, False, none, efb, False)]


@pytest.mark.parametrize("ri", range(6))
@pytest.mark.parametrize("start,nblk", [(0, 8), (1, 5)])
def test_route_window_matches_jax(ri, start, nblk):
    bins, _, _, _, lid = _inputs(ri)
    route = _routes()[ri]
    want = np.asarray(jph.route_window(
        jnp.asarray(bins), jnp.asarray(lid), jnp.int32(start),
        jnp.int32(nblk), route, RB, interpret=True))
    got = th.route_window(torch.from_numpy(bins),
                          torch.from_numpy(lid.copy()), start, nblk,
                          torch.from_numpy(np.array(route)), RB).numpy()
    np.testing.assert_array_equal(got, want)
    # rows outside the window keep their ids
    outside = np.ones(NPAD, bool)
    outside[start * RB:(start + nblk) * RB] = False
    np.testing.assert_array_equal(got[outside], lid[outside])
    assert (got != lid).any()


@pytest.mark.parametrize("ri", range(6))
def test_histogram_segment_routed_matches_jax(ri):
    bins, grad, hess, member, lid = _inputs(10 + ri)
    w8 = _w8(grad, hess, member)
    route = _routes()[ri]
    start, nblk, target = 1, 6, 6
    jl, jh = jph.histogram_segment_routed(
        jnp.asarray(bins), jnp.asarray(w8.float().numpy(), jnp.bfloat16),
        jnp.asarray(lid), jnp.int32(start), jnp.int32(nblk),
        jnp.int32(target), route, B, RB, interpret=True)
    tl = torch.from_numpy(lid.copy())
    gl, gh = th.histogram_segment_routed(
        torch.from_numpy(bins), w8, tl, start, nblk, target,
        torch.from_numpy(np.array(route)), B, RB,
        th.fixed_point_scales(w8))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
    assert gl.data_ptr() == tl.data_ptr(), "leaf_id is updated in place"
    _assert_hist_close(gh.numpy(), np.asarray(jph.unpack_hist(jh)), bins,
                       w8, np.asarray(jl), start * RB, (start + nblk) * RB,
                       target)


def test_histogram_segment_routed_null_route_is_k1():
    bins, grad, hess, member, lid = _inputs(3)
    w8 = _w8(grad, hess, member)
    args = (torch.from_numpy(bins), w8)
    k1 = th.histogram_segment(*args, torch.from_numpy(lid), 1, 4, 2, B, RB,
                              th.fixed_point_scales(w8))
    tl = torch.from_numpy(lid.copy())
    _, k3 = th.histogram_segment_routed(*args, tl, 1, 4, 2, th.null_route(),
                                        B, RB, th.fixed_point_scales(w8))
    np.testing.assert_array_equal(k1.numpy(), k3.numpy())
    np.testing.assert_array_equal(tl.numpy(), lid)


def test_score_gather_add_bit_identical():
    rng = np.random.RandomState(5)
    n, L = 5000, 255
    score = rng.normal(size=n).astype(np.float32)
    lid = rng.randint(0, L + 3, size=n).astype(np.int32)   # some >= L
    table = rng.normal(size=L).astype(np.float32)
    want = np.asarray(jps.score_gather_add(jnp.asarray(score),
                                           jnp.asarray(lid),
                                           jnp.asarray(table),
                                           interpret=True))
    got = ts.score_gather_add(torch.from_numpy(score), torch.from_numpy(lid),
                              torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_score_gather_add_in_place_row():
    """K4 as the boosting loop calls it: in place into one row of a
    [C, N] score; the other rows stay as they were."""
    rng = np.random.RandomState(6)
    C, n, L = 3, 5000, 31
    score = rng.normal(size=(C, n)).astype(np.float32)
    lid = rng.randint(0, L, size=n).astype(np.int32)
    table = rng.normal(size=L).astype(np.float32)
    want = np.asarray(jps.score_gather_add(jnp.asarray(score[1]),
                                           jnp.asarray(lid),
                                           jnp.asarray(table),
                                           interpret=True))
    got = torch.from_numpy(score.copy())
    row = got[1]
    ret = ts.score_gather_add(row, torch.from_numpy(lid),
                              torch.from_numpy(table), out=row)
    assert ret.data_ptr() == row.data_ptr()
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(got[[0, 2]].numpy(), score[[0, 2]])


def test_fixed_point_scales_bound_the_sums():
    _, grad, hess, member, _ = _inputs()
    w8 = _w8(grad * 1e3, hess, member)
    s = th.fixed_point_scales(w8).double().numpy()
    ch = w8[:4].float().double().numpy()
    assert np.all(np.log2(s) == np.round(np.log2(s)))
    assert np.abs(ch[0] + ch[1]).sum() * s[0] < 2.0**62
    assert np.abs(ch[2] + ch[3]).sum() * s[1] < 2.0**62
    assert np.abs(ch[0] + ch[1]).max() * NPAD * s[0] >= 2.0**60
