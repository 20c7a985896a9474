"""B3's leaf entry (``histogram_chunked_leaf``) and its pieces, on the CPU.

  * the leaf entry's plain version = ``histogram_chunked_plain`` on the
    channels the fused grower used to build, ``chunked_channels(grad,
    hess, (leaf_id == leaf) * member)`` at ``channel_scales`` of them, bit
    for bit, on one- and two-byte bins at 64, 1,024 and 65,536 bins and a
    leaf of every row, every other row, 5% of the rows, one row or none
    (and the root, no leaf id);
  * the same leaf = JAX's XLA ``histogram_chunked`` on those channels
    (counts exact, sums within 1e-6 of the bin's sum of |value|);
  * pass 1's plain version (``chunked_select_plain``): the leaf's rows in
    row order and the scales, = ``channel_scales`` exactly, with an
    all-zero gradient, an empty leaf, |g| near 2^40 and tiny values;
  * ``chunked_rows``: the row-major copy the card reads;
  * a model of the kernel's limb planes (bits 0-15, 16-31 and q >> 32
    added as 32-bit words, renormalised every 65,535 rows) keeps them in
    32 bits and gives the exact 64-bit sums of the largest values a call
    can hold.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import split_parity as sp
from lightgbm_tpu.ops.histogram import histogram_chunked as jax_hist
from lightgbm_tpu_torch.ops import histogram as th


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


def _leaf_case(B, wide, G, n, frac, seed):
    """Bins [G, n] (some past B - 1, which no cell takes), gradients,
    hessians, a member channel with zeros, leaf ids, and the target leaf
    whose rows are ``frac`` of all: "half" is every other row, "one" a
    single row, "none" an empty leaf."""
    rng = np.random.RandomState(seed)
    top = min(B + B // 8 + 1, 65536 if wide else 256)
    bins = rng.randint(0, top, size=(n, G)).astype(
        np.uint16 if wide else np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0, 0.25, size=n).astype(np.float32)
    member = (rng.uniform(size=n) < 0.9).astype(np.float32)
    leaf_id = rng.randint(1, 4, size=n).astype(np.int32)
    if frac == "half":
        leaf_id[::2] = 0
    elif frac == "one":
        leaf_id[n // 3] = 0
        member[n // 3] = 1.0
    elif frac != "none":
        leaf_id[rng.uniform(size=n) < frac] = 0
    host = bins.T.copy()
    binsT = torch.from_numpy(host.view(np.int16) if wide else host)
    return (binsT, bins, torch.from_numpy(grad), torch.from_numpy(hess),
            torch.from_numpy(member), torch.from_numpy(leaf_id))


SHAPES = [(64, False, 6, 3000), (1024, True, 5, 3000), (65536, True, 2, 1024)]
FRACTIONS = [1.0, "half", 0.05, "one", "none"]


@pytest.mark.parametrize("B,wide,G,n", SHAPES)
@pytest.mark.parametrize("frac", FRACTIONS)
def test_leaf_plain_equals_channel_path(B, wide, G, n, frac):
    binsT, bins, grad, hess, member, lid = _leaf_case(B, wide, G, n, frac,
                                                      B)
    got = th.histogram_chunked_leaf(binsT, grad, hess, member, B, lid, 0)
    m = (lid == 0).to(grad.dtype) * member
    w3 = th.chunked_channels(grad, hess, m)
    want = th.histogram_chunked_plain(binsT, w3, B, th.channel_scales(w3))
    assert torch.equal(got, want)
    # every member row counts once in each column where its bin is < B
    in_leaf = (m != 0).numpy()
    assert int(got[..., 2].sum()) == int((bins[in_leaf] < B).sum())
    if frac == 1.0:
        root = th.histogram_chunked_leaf(binsT, grad, hess, member, B)
        w3 = th.chunked_channels(grad, hess, member)
        assert torch.equal(root, th.histogram_chunked(binsT, w3, B))


@pytest.mark.parametrize("B,wide,G,n", SHAPES[:2])
def test_leaf_matches_jax(B, wide, G, n):
    binsT, bins, grad, hess, member, lid = _leaf_case(B, wide, G, n, 0.05,
                                                      B + 1)
    got = th.histogram_chunked_leaf(binsT, grad, hess, member, B, lid,
                                    0).numpy()
    w3 = th.chunked_channels(grad, hess, (lid == 0).float() * member)
    want = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(w3.numpy()),
                               B))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    abs_sums = th.histogram_chunked(binsT, w3.abs(), B).numpy()
    for c in range(2):
        assert np.all(np.abs(got[..., c] - want[..., c])
                      <= 1e-6 * abs_sums[..., c] + 1e-30)


@pytest.mark.parametrize("case", ["random", "zero_grad", "empty_leaf",
                                  "near_2_40", "tiny"])
def test_select_plain_scales_equal_channel_scales(case):
    rng = np.random.RandomState(7)
    n = 2048
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0, 0.25, size=n).astype(np.float32)
    member = (rng.uniform(size=n) < 0.8).astype(np.float32)
    lid = rng.randint(0, 3, size=n).astype(np.int32)
    if case == "zero_grad":
        grad[:] = 0.0
    elif case == "empty_leaf":
        lid[lid == 0] = 1
    elif case == "near_2_40":
        grad *= np.float32(2.0 ** 40)
        hess[5] = np.float32(2.0 ** 40 - 2.0 ** 17)
    elif case == "tiny":
        grad *= np.float32(1e-33)
        hess *= np.float32(1e-38)
    t = [torch.from_numpy(a) for a in (grad, hess, member, lid)]
    rows, g, h, scales = th.chunked_select_plain(*t, 0)
    m = (t[3] == 0).float() * t[2]
    want_rows = torch.nonzero(m != 0).squeeze(1)
    assert torch.equal(rows, want_rows)
    assert torch.equal(g, (t[0] * m)[want_rows])
    assert torch.equal(h, (t[1] * m)[want_rows])
    want = th.channel_scales(th.chunked_channels(t[0], t[1], m))
    assert torch.equal(scales, want)
    # the root: every row with member != 0
    _, _, _, root = th.chunked_select_plain(t[0], t[1], t[2])
    assert torch.equal(root, th.channel_scales(th.chunked_channels(
        t[0], t[1], t[2])))


@pytest.mark.parametrize("dtype,G", [(torch.uint8, 28), (torch.int16, 28),
                                     (torch.int16, 9)])
def test_chunked_rows_layout(dtype, G):
    g = torch.Generator().manual_seed(G)
    binsT = torch.randint(0, 120, (G, 300), generator=g).to(dtype)
    rows = th.chunked_rows(binsT)
    assert rows.dtype == dtype and rows.shape[0] == 300
    assert (rows.shape[1] * rows.element_size()) % 16 == 0
    assert rows.shape[1] - G < 16 // rows.element_size()
    assert torch.equal(rows[:, :G], binsT.t())
    assert not rows[:, G:].any()


# csrc/wide_hist.cu kRenormRows: rows a block adds between
# renormalisations of its 16-bit planes
RENORM_ROWS = 65535


def _limbs_model(qs):
    """The kernel's arithmetic for one cell, in Python integers: each q
    adds its bits 0-15 to a low word, its bits 16-31 to a middle word and
    q >> 32 to a top word (32-bit registers: the test fails if the low or
    middle word leaves its range; the top word wraps); every RENORM_ROWS
    adds each 16-bit word's carry moves up.  Returns the composed sum mod
    2^64."""
    lo = mid = top = 0
    for i, q in enumerate(qs):
        if i and i % RENORM_ROWS == 0:
            m = mid + (lo >> 16)
            lo &= 0xFFFF
            mid = m & 0xFFFF
            top = (top + (m >> 16)) % (1 << 32)
        lo += q & 0xFFFF
        mid += (q >> 16) & 0xFFFF
        top = (top + (q >> 32)) % (1 << 32)
        assert lo < 1 << 32 and mid < 1 << 32
    return (lo + (mid << 16) + (top << 32)) % (1 << 64)


@pytest.mark.parametrize("case", ["largest", "most_negative", "random"])
def test_limbs_keep_sums_exact(case):
    """The limb planes give the exact 64-bit sum of 2.5 intervals' adds of
    the largest values a call can hold (|q| < 2^62) and of random ones;
    pass 2 renormalises as the model does."""
    n = 2 * RENORM_ROWS + RENORM_ROWS // 2
    top = (1 << 62) - 1
    if case == "largest":
        qs = [top] * n
    elif case == "most_negative":
        qs = [-top] * n
    else:
        rng = np.random.RandomState(3)
        qs = [int(x) for x in rng.randint(-top, top, size=n,
                                          dtype=np.int64)]
    want = sum(qs)
    assert _limbs_model(qs) == want % (1 << 64)
