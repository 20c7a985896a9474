"""The packed-accumulator stream (quantized gradient/hessian, integer
histogram sums) in the PyTorch port against the JAX package, on the CPU.

The port's ``packed_acc=True`` is the JAX package's
LIGHTGBM_TPU_PACKED_ACC=force (LIGHTGBM_TPU_PACKED_BITS its ``bits``,
LIGHTGBM_TPU_FUSED_PACKED=1 its explicit fused kernels); those variables
are set here only for the JAX reference, by monkeypatch.  Held against
JAX, bit for bit: the quantizer (stream, scales, clip count) at 2, 8, 12
and 15 bits; the plain versions of K1, K3 (and the step entries of both),
K5, K6 and K7 (routed and fused-K), and leaf_histogram, on JAX's own
stream, against the JAX kernels in interpret mode at 64 bins, at 16 bins
packed4 and at 12 bits (where the values are bf16-rounded), at sizes
whose sums stay below 2^24, where the TPU kernels' f32 sums are exact.
Trained through GBDT, packed accuracy is within JAX's gates of the
unpacked model.  The growers against JAX's are in
test_torch_packed_acc_growers.py (each JAX grower configuration compiles
for ~13 s on one core, so they make a module of their own).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import histogram as th

NPAD, G, RB = 2048, 7, 256
# kernel modes: bins, packed4, bits
MODES = {"b64": (64, False, 8), "p4": (16, True, 8), "b64_bits12": (64, False,
                                                                    12)}


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
              "LIGHTGBM_TPU_PACKED_ACC", "LIGHTGBM_TPU_PACKED_BITS",
              "LIGHTGBM_TPU_FUSED_PACKED", "LIGHTGBM_TPU_ROUTE_KERNEL"):
        monkeypatch.delenv(k, raising=False)


def _stream(seed, n=NPAD):
    rng = np.random.RandomState(seed)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.01, 0.3, size=n).astype(np.float32)
    member = (rng.uniform(size=n) > 0.15).astype(np.float32)
    member[-100:] = 0.0                              # pad rows
    return grad, hess, member


# ------------------------------------------------------------ the quantizer
@pytest.mark.parametrize("bits", [2, 8, 12, 15])
def test_quantizer_equals_jax(bits):
    """w2, scales and clips bit for bit, on an N that is not a multiple of
    8, with zero-member rows (which quantize to zero)."""
    grad, hess, member = _stream(bits, 1003)
    jw, js, jc = jph.quantize_pack_channels(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(member), bits=bits)
    w2, scales, clips = th.quantize_pack(torch.from_numpy(grad),
                                         torch.from_numpy(hess),
                                         torch.from_numpy(member), bits)
    assert w2.dtype == torch.int32 and w2.shape == (2, 1003)
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert clips.shape == () and int(clips) == int(jc) > 0
    out = member == 0
    assert out.any() and not w2[:, torch.from_numpy(out)].any()


def test_quantizer_bits_out_of_range_raise():
    g = torch.ones(16)
    for bits in (1, 16, 0, 2.5, True):
        with pytest.raises(ValueError):
            th.quantize_pack(g, g, g, bits)


# ------------------------------------------------------------- the kernels
def _kernel_inputs(mode):
    B, packed4, bits = MODES[mode]
    rng = np.random.RandomState(B + bits)
    bins = rng.randint(0, B, size=(G, NPAD)).astype(np.uint8)
    bins[1] = rng.randint(0, 5, size=NPAD)           # a few-bin column
    grad, hess, member = _stream(B + bits)
    lid = rng.randint(0, 4, size=NPAD).astype(np.int32)
    jw, js, _ = jph.quantize_pack_channels(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(member), bits=bits)
    packed = th.pack_bins_4bit(bins) if packed4 else bins
    return (B, packed4, packed, jw, js, torch.from_numpy(np.array(jw)),
            torch.from_numpy(np.array(js)), lid, (grad, hess, member))


def _jroutes(B, packed4):
    """A numeric split of leaf 1 on column 3, a NaN-missing one of leaf 2
    on column 2, a categorical one of leaf 3 on column 4, and the null
    route."""
    num_bin = np.full(G, B, np.int32)
    num_bin[1] = 5
    fm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(num_bin),
        missing_type=jnp.asarray((np.arange(G) % 3).astype(np.int32)),
        default_bin=jnp.asarray((num_bin // 3).astype(np.int32)),
        is_cat=jnp.asarray(np.arange(G) == 4),
        monotone=jnp.zeros(G, jnp.int32), penalty=jnp.ones(G, jnp.float32))
    none = jnp.zeros(8, jnp.uint32)
    cat = jnp.asarray(np.array([0b1010110101, 0, 0, 0, 0, 0, 0, 0],
                               np.uint32))
    return jnp.stack([
        jph.pack_route(1, 6, 3, 7, True, False, none, fm, packed4),
        jph.pack_route(2, 7, 2, 4, False, False, none, fm, packed4),
        jph.pack_route(3, 8, 4, 0, False, True, cat, fm, packed4),
        jph.null_route()])


def _equal(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kernel", ["K1", "K3", "K5", "K6", "K7_routed",
                                    "K7_fusedk", "leaf"])
def test_packed_acc_twins_equal_jax(kernel, mode):
    """Each plain version on JAX's stream = the JAX kernel on it in
    interpret mode, dequantized by unpack_hist_packed, bit for bit (leaf
    ids too); K1's and K3's step entries = the by-value ones."""
    B, packed4, bins, jw, js, w2, scales, lid, gh = _kernel_inputs(mode)
    jb, tb = jnp.asarray(bins), torch.from_numpy(bins)
    nblk = NPAD // RB
    kw = dict(interpret=True, packed4=packed4)
    jroutes = _jroutes(B, packed4)
    routes = torch.from_numpy(np.array(jroutes))
    if kernel == "K1":
        want = jph.unpack_hist_packed(jph.histogram_segment(
            jb, jw, jnp.asarray(lid), jnp.int32(1), jnp.int32(5),
            jnp.int32(2), B, RB, **kw), js)
        got = th.histogram_segment(tb, w2, torch.from_numpy(lid), 1, 5, 2, B,
                                   RB, scales, packed4=packed4)
        _equal(got, want)
        step = th.pack_step(1, 5, 2, th.null_route())
        _equal(th.histogram_segment_step(tb, w2, torch.from_numpy(lid), step,
                                         B, RB, scales, packed4=packed4),
               want)
        return
    if kernel == "K3":
        for j in range(3):
            jl, jh = jph.histogram_segment_routed(
                jb, jw, jnp.asarray(lid), jnp.int32(0), jnp.int32(nblk),
                jnp.int32(6 + j), jroutes[j], B, RB, **kw)
            gl, gh_ = th.histogram_segment_routed(
                tb, w2, torch.from_numpy(lid.copy()), 0, nblk, 6 + j,
                routes[j], B, RB, scales, packed4=packed4)
            _equal(gl, jl)
            assert (np.asarray(jl) != lid).any()
            _equal(gh_, jph.unpack_hist_packed(jh, js))
            sl = torch.from_numpy(lid.copy())
            _, sh = th.histogram_segment_routed_step(
                tb, w2, sl, th.pack_step(0, nblk, 6 + j, routes[j]), B, RB,
                scales, packed4=packed4)
            assert torch.equal(sl, gl) and torch.equal(sh, gh_)
        return
    if kernel == "K5":
        want = jph.unpack_hist_packed(jph.histogram_all(jb, jw, B, RB, **kw),
                                      js)
        got = th.histogram_all(tb, w2, B, scales, packed4=packed4)
        assert got.shape[0] == 1
        _equal(got[0], want)
        return
    if kernel == "leaf":
        g, h, m = (jnp.asarray(a) for a in gh)
        for acc in (True, False):
            want = jph.leaf_histogram_pallas(jb, g, h, m, B, RB,
                                             packed4=packed4, packed_acc=acc,
                                             bits=MODES[mode][2])
            got = th.leaf_histogram(tb, *(torch.from_numpy(a) for a in gh),
                                    B, packed4=packed4, packed_acc=acc,
                                    bits=MODES[mode][2])
            if acc:
                _equal(got, want)
            else:
                # the fixed-point channels: counts exact, sums to f32
                np.testing.assert_array_equal(got[..., 2].numpy(),
                                              np.asarray(want)[..., 2])
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5)
        return
    bl, n = th.union_block_list([0, 1, 5], [3, 4, 7], [True] * 3)
    jbl = np.zeros(nblk, np.int32)
    jbl[:n] = bl.numpy()
    if kernel == "K6":
        targets = [2, 0, -1, 3]
        want = jph.unpack_hist_packed(jph.histogram_frontier(
            jb, jw, jnp.asarray(lid), jnp.asarray(jbl), jnp.int32(n),
            jnp.asarray(targets, jnp.int32), B, RB, **kw), js)
        got = th.histogram_frontier(tb, w2, torch.from_numpy(lid), bl, n,
                                    torch.tensor(targets, dtype=torch.int32),
                                    B, RB, scales, packed4=packed4)
        _equal(got, want)
        return
    if kernel == "K7_routed":
        targets, fn, jfn = [6, 2, 8, -1], th.histogram_frontier_routed, \
            jph.histogram_frontier_routed
    else:
        targets, fn, jfn = [1, 2, 3, -1, 6, 7, 8, -1], \
            th.histogram_frontier_fusedk, jph.histogram_frontier_fusedk
    jl, jh = jfn(jb, jw, jnp.asarray(lid), jnp.asarray(jbl), jnp.int32(n),
                 jnp.asarray(targets, jnp.int32), jroutes, B, RB, **kw)
    gl, gh_ = fn(tb, w2, torch.from_numpy(lid.copy()), bl, n,
                 torch.tensor(targets, dtype=torch.int32), routes, B, RB,
                 scales, packed4=packed4)
    _equal(gl, jl)
    assert (np.asarray(jl) != lid).any()
    _equal(gh_, jph.unpack_hist_packed(jh, js))


def test_packed_twin_needs_scales():
    _, _, bins, _, _, w2, _, lid, _ = _kernel_inputs("b64")
    with pytest.raises(ValueError):
        th.histogram_segment(torch.from_numpy(bins), w2,
                             torch.from_numpy(lid), 0, 1, 0, 64, RB, None)


# --------------------------------------------------------- through GBDT
@pytest.mark.parametrize("impl", ["segment", "frontier"])
def test_packed_trained_model_quality_parity(rng, impl):
    """JAX's test_packed_trained_model_quality_parity on the port: missing
    values, a categorical feature and bagging; the packed model's accuracy
    within 0.01 of the unpacked one's, predictions within 0.12."""
    n = 4000
    X = rng.normal(size=(n, 6))
    X[rng.random_sample(n) < 0.1, 3] = np.nan
    X[:, 5] = rng.randint(0, 10, size=n)
    p = (X[:, 0] + 0.5 * X[:, 1] > 0) | (X[:, 5] > 7)
    params = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
                  bagging_fraction=0.8, bagging_freq=1, bagging_seed=3,
                  tpu_tree_impl=impl, device_type="cpu", verbosity=-1)
    out = {}
    for acc in (False, True):
        bst = lt.Booster(params, lt.Dataset(X, p.astype(np.float64),
                                            categorical_feature=[5]),
                         packed_acc=acc)
        for _ in range(3):
            bst.update()
        out[acc] = bst.predict(X)
        clips = bst.gbdt.grower.last_stats["quant_clips"]
        assert clips > 0 if acc else clips == 0
    acc_b = np.mean((out[False] > 0.5) == p)
    acc_p = np.mean((out[True] > 0.5) == p)
    assert acc_b > 0.9, acc_b
    assert acc_p >= acc_b - 0.01, (acc_b, acc_p)
    np.testing.assert_allclose(out[True], out[False], atol=0.12)


def test_the_switch():
    """packed_acc_bits out of [2, 15] raises, 12 trains; fused_route None
    resolves to fused without packed_acc and unfused with it, an explicit
    True is kept; the frontier's default tier is "off" under packed_acc at
    any K."""
    X = np.random.RandomState(0).normal(size=(600, 4))
    y = (X[:, 0] > 0).astype(float)
    cpu = dict(objective="binary", device_type="cpu", verbosity=-1)
    for bits in (1, 16):
        with pytest.raises(ValueError):
            lt.Booster(cpu, lt.Dataset(X, y), packed_acc=True,
                       packed_acc_bits=bits)
    cases = [({}, True), ({"packed_acc": True}, False),
             ({"packed_acc": True, "fused_route": True}, True),
             ({"fused_route": False}, False)]
    for kw, fused in cases:
        g = lt.Booster(cpu, lt.Dataset(X, y), **kw).gbdt
        assert g.grower.fused_route is fused, kw
        assert g.grower.p.packed_acc is bool(kw.get("packed_acc"))
    # a width above 9 bits trains (its values bf16-rounded in the adds)
    # and stays within JAX's gate of the unpacked model
    out = []
    for kw in ({}, {"packed_acc": True, "packed_acc_bits": 12}):
        bst = lt.Booster(cpu, lt.Dataset(X, y), **kw)
        for _ in range(3):
            bst.update()
        out.append(bst.predict(X))
    assert bst.gbdt.grower.p.packed_acc_bits == 12
    np.testing.assert_allclose(out[1], out[0], atol=0.12)
    fr = dict(cpu, tpu_tree_impl="frontier", tpu_frontier_width=1)
    assert lt.Booster(fr, lt.Dataset(X, y)).gbdt.grower.tier == "k1"
    assert lt.Booster(fr, lt.Dataset(X, y),
                      packed_acc=True).gbdt.grower.tier == "off"
    assert lt.Booster(fr, lt.Dataset(X, y), packed_acc=True,
                      frontier_tier="k1").gbdt.grower.tier == "k1"
