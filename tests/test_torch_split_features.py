"""The split features of the port's scan and segment grower against the
JAX package, on the CPU: monotone constraints, feature_contri and CEGB's
split and coupled costs.

  * ``best_split`` against JAX's on histograms made with numpy from a
    seed: finite monotone bounds of both signs, penalties and CEGB costs,
    and a categorical feature; the feature, threshold, default direction
    and bitset exact, sums and outputs within 1e-6 relative, gains within
    1e-6 of the children's gain (float32 sums in another order);
  * the segment grower's trees against JAX's, split for split, one model
    text (tests/split_parity.py), each feature alone, each changing the
    model;
  * predictions monotone in every constrained feature over sweeps (deep
    trees: test_torch_split_frontier.py);
  * one model text for ``steps`` 1 and 4 with the bounds and the used
    features in the grower's device state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as ts

import split_parity as sp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


# ------------------------------------------------------------- the scan
F, B, ROWS = 6, 16, 4000
NUM_BIN = np.array([16, 12, 16, 9, 16, 3], np.int32)
MISSING = np.array([0, 2, 1, 0, 0, 0], np.int32)     # none, NaN, zero
DEFAULT_BIN = np.array([0, 3, 5, 0, 0, 0], np.int32)
IS_CAT = np.array([False, False, False, True, False, True])
MONO = np.array([1, -1, 1, 0, -1, 0], np.int32)


def _hists(seed, leaves=2):
    """[K, F, B, 3] float32 histograms of ``leaves`` leaves of rows drawn
    with numpy, and the leaves' (g, h, c)."""
    rng = np.random.RandomState(seed)
    out, sums = [], []
    for k in range(leaves):
        n = ROWS // (k + 1)
        bins = np.stack([rng.randint(0, nb, size=n) for nb in NUM_BIN])
        g = (0.6 * (bins[0] / 16.0) - 0.5 * (bins[1] > 6)
             + 0.4 * np.isin(bins[3], [1, 4, 6]) + rng.normal(size=n) * 0.5
             - 0.2 * k)
        h = rng.uniform(0.05, 0.25, size=n)
        hist = np.zeros((F, B, 3))
        for f in range(F):
            np.add.at(hist[f, :, 0], bins[f], g)
            np.add.at(hist[f, :, 1], bins[f], h)
            np.add.at(hist[f, :, 2], bins[f], 1.0)
        out.append(hist)
        sums.append((g.sum(), h.sum(), float(n)))
    return (np.asarray(out, np.float32),
            np.asarray(sums, np.float32))


SCAN_CASES = {
    # (monotone, bounds (lo, hi) per leaf, penalty, CEGB adjust, has_cat)
    "monotone": (True, [(-1.6, -1.1), (-np.inf, np.inf)], None, False,
                 False),
    "monotone_tight": (True, [(-1.34, -1.26), (0.15, 0.19)], None, False,
                       False),
    "penalty_adjust": (False, None, [1.0, 0.5, 0.25, 1.0, 0.8, 1.0], True,
                       False),
    "categorical": (True, [(-1.5, -1.0), (0.0, np.inf)],
                    [1.0, 0.9, 1.0, 0.6, 1.0, 1.0], True, True),
}
SP = dict(min_data_in_leaf=20.0, lambda_l2=0.5, min_data_per_group=20,
          cat_smooth=5.0, max_cat_to_onehot=4)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_matches_jax(case):
    mono, bounds, penalty, adjust, has_cat = SCAN_CASES[case]
    hists, sums = _hists(3)
    K = hists.shape[0]
    pen = None if penalty is None else np.asarray(penalty, np.float32)
    cat = IS_CAT if has_cat else np.zeros(F, bool)
    jfm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(NUM_BIN), missing_type=jnp.asarray(MISSING),
        default_bin=jnp.asarray(DEFAULT_BIN), is_cat=jnp.asarray(cat),
        monotone=jnp.asarray(MONO if mono else np.zeros(F, np.int32)),
        penalty=jnp.asarray(np.ones(F, np.float32) if pen is None else pen))
    pfm = ts.FeatureMeta(
        torch.from_numpy(NUM_BIN), torch.from_numpy(MISSING),
        torch.from_numpy(DEFAULT_BIN),
        torch.from_numpy(cat) if has_cat else None,
        monotone=torch.from_numpy(MONO) if mono else None,
        penalty=None if pen is None else torch.from_numpy(pen))
    adj = None
    if adjust:
        adj = np.random.RandomState(9).uniform(0, 2.0, (K, F)).astype(
            np.float32)
    lo = hi = None
    if bounds is not None:
        lo = np.asarray([b[0] for b in bounds], np.float32)
        hi = np.asarray([b[1] for b in bounds], np.float32)
    jp = jsplit.SplitParams(**SP, has_cat=has_cat)
    got = ts.best_split(
        torch.from_numpy(hists), *(torch.from_numpy(sums[:, j])
                                   for j in range(3)),
        pfm, ts.SplitParams(**SP, has_cat=has_cat), None,
        None if lo is None else torch.from_numpy(lo),
        None if hi is None else torch.from_numpy(hi),
        None if adj is None else torch.from_numpy(adj))
    moved = 0
    for k in range(K):
        want = jsplit.best_split(
            jnp.asarray(hists[k]), *(jnp.float32(sums[k, j])
                                     for j in range(3)),
            jfm, jp, jnp.ones(F, jnp.float32),
            mono_lo=None if lo is None else jnp.float32(lo[k]),
            mono_hi=None if hi is None else jnp.float32(hi[k]),
            gain_adjust=None if adj is None else jnp.asarray(adj[k]))
        assert int(got.feature[k]) == int(want.feature) >= 0
        assert int(got.threshold[k]) == int(want.threshold)
        assert bool(got.default_left[k]) == bool(want.default_left)
        if has_cat:
            assert bool(got.is_cat[k]) == bool(want.is_cat)
            np.testing.assert_array_equal(
                got.cat_bitset[k].numpy().astype(np.uint32),
                np.asarray(want.cat_bitset))
        # the gain is the children's gain less the parent's: relative to
        # those (the sums' float32 order moves an ulp of them)
        shift = float(jsplit.leaf_gain(jnp.float32(sums[k, 0]),
                                       jnp.float32(sums[k, 1]), 0.0,
                                       SP["lambda_l2"], 0.0))
        assert abs(float(got.gain[k]) - float(want.gain)) <= 1e-6 * (
            abs(float(want.gain)) + abs(shift))
        for name in ("left_out", "right_out", "left_g", "left_h",
                     "left_c"):
            np.testing.assert_allclose(float(getattr(got, name)[k]),
                                       float(getattr(want, name)),
                                       rtol=1e-6, atol=1e-7)
        if lo is not None:
            assert lo[k] <= float(got.left_out[k]) <= hi[k]
            assert lo[k] <= float(got.right_out[k]) <= hi[k]
        moved += int(got.feature[k]) != 0
    if case == "monotone_tight":
        # the bounds bind: some output sits on one
        outs = torch.stack([got.left_out, got.right_out], 1).numpy()
        assert np.isin(outs, np.concatenate([lo, hi])).any()
    if has_cat:
        assert bool(got.is_cat.any())


def test_violating_candidate_scores_zero_not_minus_inf():
    """A numerical candidate whose clamped outputs break the constraint
    scores 0.0 (it still loses to min_gain_shift), as in JAX."""
    p = ts.SplitParams(min_data_in_leaf=0.0, min_sum_hessian_in_leaf=0.0)
    Gl = torch.tensor([[2.0, -2.0]])
    Hl = torch.ones(1, 2)
    mono = torch.tensor([[1, 1]])
    gain = ts._split_gain(Gl, Hl, -Gl, Hl, p, 0.0, mono)
    want = jsplit._split_gain(jnp.asarray(Gl.numpy()), jnp.ones((1, 2)),
                              jnp.asarray(-Gl.numpy()), jnp.ones((1, 2)),
                              jsplit.SplitParams(), jnp.asarray([[1, 1]]),
                              -jnp.inf, jnp.inf)
    np.testing.assert_array_equal(gain.numpy(), np.asarray(want))
    assert float(gain[0, 0]) > 0.0 and float(gain[0, 1]) == 0.0


# ------------------------------------------------------------ the trees
TREE_CASES = {
    "monotone": dict(monotone_constraints=sp.MONOTONE),
    "feature_contri": dict(feature_contri=[1.0, 0.3, 1.0, 0.5, 1.0, 0.1]),
    "cegb": dict(cegb_penalty_split=0.002, cegb_tradeoff=0.8,
                 cegb_penalty_feature_coupled=[4.0, 0.0, 6.0, 2.0, 5.0,
                                               3.0]),
}


@pytest.fixture(scope="module")
def xy():
    return sp.data()


@pytest.fixture(scope="module")
def plain_splits(xy):
    """The segment grower's splits without the features."""
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.core.dataset import TpuDataset
    X, y = xy
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(**sp.BASE))
    return sp.splits(sp.port_trained(sp.BASE, jds, y))


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_segment_trees_match_jax(xy, plain_splits, case):
    X, y = xy
    params = dict(sp.BASE, tpu_tree_impl="segment", **TREE_CASES[case])
    jds, jgb = sp.jax_trained(params, X, y)
    assert jgb._use_segment
    bst = sp.port_trained(params, jds, y)
    assert type(bst.gbdt.grower).__name__ == "SegmentGrower"
    sp.assert_same_model(jgb, bst)
    # the feature took effect
    assert sp.splits(bst) != plain_splits
    if case == "monotone":
        assert bst.gbdt.grower.p.use_monotone
        assert sp.monotone_violation(bst, X, sp.MONOTONE) <= 0.0


def test_steps_1_and_4_grow_one_model_with_the_features(xy):
    """The bounds and the used features live in the segment grower's
    device state: one model text for steps 1 and 4, and the coupled cost
    remembers the model's features across trees."""
    X, y = xy
    params = dict(sp.BASE, monotone_constraints=sp.MONOTONE,
                  cegb_penalty_split=0.001,
                  cegb_penalty_feature_coupled=[3.0] * sp.NF)
    texts = []
    for steps in (1, 4):
        bst = lt.Booster(params, lt.Dataset(X, y))
        bst.gbdt.grower.steps = steps
        for _ in range(3):
            bst.update()
        texts.append(bst.model_to_string())
        used = bst.gbdt.fmeta.cegb_used0.numpy()
        feats = set()
        for t in bst.gbdt.models:
            feats |= set(t.split_feature_inner[:t.num_leaves - 1].tolist())
        assert sorted(np.nonzero(used)[0].tolist()) == sorted(feats)
    assert texts[0] == texts[1]


@pytest.mark.parametrize("params", [
    {"mc": [1, 0, -1]}, {"monotone_constraint": "1,0,-1"},
    {"fc": [1.0, 0.5, 1.0]}, {"feature_penalty": "1,0.5,1"},
    {"fs": "splits.json"}, {"forced_splits": "splits.json"},
    {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.1},
    {"cegb_penalty_feature_lazy": [1, 2, 3]},
    {"cegb_penalty_feature_coupled": "1,2,3"},
    {"tpu_tree_impl": "fused"}])
def test_split_feature_parameters_are_accepted(params):
    """The eight parameters and their aliases as the JAX Config takes
    them; the model text names each by its canonical name."""
    from lightgbm_tpu.config import Config as JaxConfig
    cfg = lt.Config(device_type="cpu", **params)
    jcfg = JaxConfig(device_type="cpu", **params)
    assert cfg.raw == jcfg.raw
    for name in cfg.raw:
        assert getattr(cfg, name) == getattr(jcfg, name)


def test_feature_list_lengths_are_checked():
    X, y = sp.data(n=200)
    with pytest.raises(lt.LightGBMError, match="monotone_constraints"):
        lt.train(dict(sp.BASE, monotone_constraints=[1, 0]),
                 lt.Dataset(X, y), 1)
    with pytest.raises(lt.LightGBMError, match="feature_contri"):
        lt.train(dict(sp.BASE, feature_contri=[1.0]), lt.Dataset(X, y), 1)
