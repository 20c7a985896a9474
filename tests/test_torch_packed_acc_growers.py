"""The growers on the packed-accumulator stream against the JAX package's,
on the CPU.

Both growers are fed the same bins and gradient arrays directly, not
through an objective, so that no ulp of a gradient moves the quantizer's
seed; the JAX growers are built with LIGHTGBM_TPU_PACKED_ACC=force (and
LIGHTGBM_TPU_FUSED_PACKED=1 for fused-K), set by monkeypatch for the
reference only.  The port's trees equal JAX's split for split, leaf ids
too, with leaf values within 1e-6 and the same quant_clips: the segment
grower unfused (JAX's default under the mode) and fused (its histograms
are the unfused ones bit for bit, as JAX's fused opt-in gives), the
frontier grower "off" and "fusedk" at K = 4, and 3-class trees whose
roots keep K5's f32 channels (JAX's histograms given to both) while
their splits quantize.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.models.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.models.grower_frontier import make_grow_tree_frontier
from lightgbm_tpu.models.grower_seg import make_grow_tree_segment
from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.models.grower import GrowerParams
from lightgbm_tpu_torch.models.grower_frontier import FrontierGrower
from lightgbm_tpu_torch.models.grower_seg import SegmentGrower
from lightgbm_tpu_torch.ops import split as ts


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


GF, GB, GRB, GN = 5, 32, 256, 4096
NUM_BIN = np.array([32, 20, 17, 32, 12], dtype=np.int32)
MISSING = np.array([0, 2, 1, 0, 0], dtype=np.int32)
DEFAULT_BIN = np.array([0, 7, 5, 0, 0], dtype=np.int32)
IS_CAT = np.array([False, False, False, False, True])
SP = dict(min_data_in_leaf=5.0, lambda_l2=0.5)


@pytest.fixture(scope="module")
def grower_data():
    """Bins, per-class gradients (3 classes; class 0 the binary case),
    hessians and member, with a bag and pad rows."""
    rng = np.random.RandomState(3)
    bins = np.stack([rng.randint(0, nb, size=GN)
                     for nb in NUM_BIN]).astype(np.uint8)
    member = (rng.uniform(size=GN) > 0.2).astype(np.float32)
    member[-200:] = 0.0
    signal = (bins[0] / 32.0 + 0.6 * (bins[1] > 10)
              + 0.8 * np.isin(bins[4], [1, 4, 7]))
    grads, hesss = [], []
    for c in range(3):
        z = (signal if c != 1 else 2.4 - signal) + 0.4 * rng.normal(size=GN)
        y = (z + rng.normal(size=GN) * 0.3 > 0.9 + 0.2 * c)
        p = 1.0 / (1.0 + np.exp(-rng.normal(size=GN) * 0.2))
        grads.append(((p - y) * member).astype(np.float32))
        hesss.append((p * (1 - p) * member).astype(np.float32))
    return bins, np.stack(grads), np.stack(hesss), member


def _jfm():
    return jsplit.FeatureMeta(
        num_bin=jnp.asarray(NUM_BIN), missing_type=jnp.asarray(MISSING),
        default_bin=jnp.asarray(DEFAULT_BIN), is_cat=jnp.asarray(IS_CAT),
        monotone=jnp.zeros(GF, jnp.int32),
        penalty=jnp.ones(GF, jnp.float32))


def _pfm():
    return ts.FeatureMeta(torch.from_numpy(NUM_BIN),
                          torch.from_numpy(MISSING),
                          torch.from_numpy(DEFAULT_BIN),
                          torch.from_numpy(IS_CAT))


def _jax_params(L):
    return JaxGrowerParams(num_leaves=L, hist_backend="pallas",
                           split=jsplit.SplitParams(**SP, has_cat=True))


def _port_params(L):
    return GrowerParams(num_leaves=L, packed_acc=True,
                        split=ts.SplitParams(**SP, has_cat=True))


# case: (JAX grower kind, its env, the port's grower and its kwargs,
# classes).  "segment_root" is the segment grower given K5's f32 root
# histograms, as a multiclass booster gives them, quantizing for its
# splits; the other kinds grow their roots from the stream.
GROWER_CASES = {
    "segment_unfused": ("segment", {}, "segment", {"fused_route": False}, 1),
    "segment_fused": ("segment", {}, "segment", {"fused_route": True}, 1),
    "frontier_off": ("frontier", {}, "frontier", {"tier": "off"}, 1),
    "frontier_fusedk": ("frontier_fusedk",
                        {"LIGHTGBM_TPU_FUSED_PACKED": "1"}, "frontier",
                        {"tier": "fusedk"}, 1),
    "multiclass": ("segment_root", {}, "segment", {"fused_route": False}, 3),
}
L = 15
K = 4
# the reference is compiled without XLA's costly optimisation passes
# (its trees are the same) to keep the module's four compiles short
QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def jax_growers():
    """{JAX grower kind: the compiled grow}, built lazily with the packed
    accumulator forced (one compile a kind, the env read at build)."""
    return {}


@pytest.fixture(scope="module")
def f32_roots(grower_data):
    """K5's f32 root histogram of each class (JAX's interpret-mode kernel
    on the fixed-point channels)."""
    bins, grads, hesss, member = grower_data
    w8C = jnp.concatenate([jph.pack_channels(
        jnp.asarray(grads[c]), jnp.asarray(hesss[c]), jnp.asarray(member))
        for c in range(3)])
    hists = jph.unpack_hist(jph.histogram_all(jnp.asarray(bins), w8C, GB,
                                              GRB, interpret=True))
    return [hists[c] for c in range(3)]


def _jax_grow(cache, kind, env, monkeypatch, args, root_hist):
    if kind not in cache:
        monkeypatch.setenv("LIGHTGBM_TPU_PACKED_ACC", "force")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if kind.startswith("segment"):
            grow = make_grow_tree_segment(GB, _jax_params(L), GRB)
        else:
            grow = make_grow_tree_frontier(
                GB, _jax_params(L), GRB, batch_k=K,
                fused_k=True if kind == "frontier_fusedk" else None)
        cache[kind] = grow.lower(*args, root_hist=root_hist).compile(
            compiler_options=QUICK_COMPILE)
        assert jph.packed_acc_decisions[kind.split("_")[0]] is True
    return cache[kind]


@pytest.mark.parametrize("case", list(GROWER_CASES))
def test_packed_acc_growers_equal_jax(grower_data, jax_growers, f32_roots,
                                      monkeypatch, case):
    bins, grads, hesss, member = grower_data
    jkind, env, pkind, kw, classes = GROWER_CASES[case]
    roots = f32_roots if jkind == "segment_root" else [None] * classes
    if pkind == "segment":
        g = SegmentGrower(GB, _port_params(L), GRB, **kw)
    else:
        g = FrontierGrower(GB, _port_params(L), GRB, K, **kw)
    compared = 0
    for c in range(classes):
        args = (jnp.asarray(bins), jnp.asarray(grads[c]),
                jnp.asarray(hesss[c]), jnp.asarray(member), _jfm(),
                jnp.ones(GF, jnp.float32), jax.random.PRNGKey(0))
        grow = _jax_grow(jax_growers, jkind, env, monkeypatch, args,
                         roots[c])
        jt, jl, jstats = grow(*args, root_hist=roots[c])
        root = None
        if roots[c] is not None:
            # only the histogram is read under packed_acc
            root = (None, None, torch.from_numpy(np.array(roots[c])))
        pt, pl = g.grow(torch.from_numpy(bins), torch.from_numpy(grads[c]),
                        torch.from_numpy(hesss[c]), torch.from_numpy(member),
                        _pfm(), root=root)
        n = int(jt.num_leaves)
        assert pt.num_leaves == n and n > 8
        for name, m in (("split_feature", n - 1), ("threshold_bin", n - 1),
                        ("default_left", n - 1), ("is_cat", n - 1),
                        ("cat_bitset", n - 1), ("left_child", n - 1),
                        ("right_child", n - 1), ("leaf_parent", n),
                        ("leaf_depth", n)):
            np.testing.assert_array_equal(getattr(pt, name)[:m],
                                          np.asarray(getattr(jt, name))[:m],
                                          f"{case} class {c} {name}")
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        # atol: a leaf whose gradient sum nearly cancels (|value| ~ 0.07)
        # carries the f32 rounding of the scan's prefix sums, which torch
        # and XLA associate differently (a few 1e-6 at these sums)
        np.testing.assert_allclose(pt.leaf_value[:n],
                                   np.asarray(jt.leaf_value)[:n], rtol=1e-6,
                                   atol=1e-5)
        assert g.last_stats["quant_clips"] == int(np.asarray(jstats)[6]) > 0
        compared += n - 1
    assert compared >= 14 * classes
    if case == "multiclass":
        assert pt.is_cat[:n - 1].any()
