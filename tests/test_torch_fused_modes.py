"""The port's fused grower (models/grower_fused.py) with every split
feature at once, under the boosting modes, the packed accumulator and
the grower dispatch, against the JAX package on the CPU:

  * ``tpu_tree_impl="fused"`` with a forced plan, monotone constraints,
    feature_contri and CEGB's split, coupled and lazy costs at once;
  * GOSS, DART, RF and 3-class multiclass (C trees an iteration, no
    batched roots) on ``tpu_tree_impl="fused"`` with split features: one
    model text with JAX's (tests/split_parity.py);
  * the packed accumulator, quantized once a leaf, against JAX's
    make_grow_tree fed the same arrays;
  * segment or frontier named with a forced plan warns and takes the
    fused grower, as JAX does; the parameter lines keep the name given.
"""

import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

import split_parity as sp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


FUSED = dict(sp.BASE, tpu_tree_impl="fused")


def test_every_split_feature_on_the_fused_grower_matches_jax(
        tmp_path_factory):
    sp.check_fused_case("all", sp.plan_files(tmp_path_factory.mktemp(
        "plans")))
MODES = {
    "goss": dict(boosting="goss", learning_rate=0.5, top_rate=0.3,
                 other_rate=0.2),
    "dart": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
               feature_fraction=0.8),
    # a class's constraint would fight the others' signs: the costs here
    "multiclass": dict(objective="multiclass", num_class=3,
                       feature_contri=[1.0, 0.6, 1.0, 0.8, 1.0, 0.5],
                       cegb_penalty_feature_coupled=[1.0, 2.0, 0.0, 3.0,
                                                     1.0, 2.0]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_grower_modes_match_jax(mode):
    X, y = sp.data(seed=6)
    if mode == "multiclass":
        y = np.digitize(X[:, 0] - 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
    C = 3 if mode == "multiclass" else 1
    mono = sp.MONOTONE if C == 1 else [0] * sp.NF
    params = dict(FUSED, monotone_constraints=mono, **MODES[mode])
    iters = 4 if mode == "goss" else 3
    jds, jgb = sp.jax_trained(params, X, y, iters=iters)
    bst = sp.port_trained(params, jds, y, iters=iters)
    assert type(bst.gbdt.grower).__name__ == "FusedGrower"
    assert len(bst.gbdt.models) == iters * C
    sp.assert_same_model(jgb, bst, min_splits=10)
    assert sp.monotone_violation(bst, X, mono) <= 0.0


def test_fused_packed_acc_matches_jax(monkeypatch):
    """``packed_acc`` quantizes once a leaf (each leaf's own scales): the
    grower against JAX's make_grow_tree built with
    LIGHTGBM_TPU_PACKED_ACC=force, both fed the same bins and gradient
    arrays (a booster's objective rounds its gradients otherwise, and the
    quantizer's seed is their bits), with a forced plan and monotone
    constraints: the same splits and leaf ids, leaf values within the
    harness's 1e-5 + 1e-4 relative (the forced splits' sums are XLA's and
    torch's cumulative sums, rounded in another order)."""
    import jax
    import jax.numpy as jnp
    import torch
    from lightgbm_tpu.models.grower import GrowerParams as JaxGrowerParams
    from lightgbm_tpu.models.grower import make_grow_tree
    from lightgbm_tpu.ops import split as jsplit
    from lightgbm_tpu_torch.models.grower import GrowerParams
    from lightgbm_tpu_torch.models.grower_fused import FusedGrower
    from lightgbm_tpu_torch.ops import split as ts
    rng = np.random.RandomState(3)
    F, B, N = 5, 32, 4096
    num_bin = np.array([32, 20, 17, 32, 12], np.int32)
    missing = np.array([0, 2, 1, 0, 0], np.int32)
    default = np.array([0, 7, 5, 0, 0], np.int32)
    mono = np.array([1, 0, -1, 0, 0], np.int32)
    bins = np.stack([rng.randint(0, nb, size=N)
                     for nb in num_bin]).astype(np.uint8)
    member = (rng.uniform(size=N) > 0.2).astype(np.float32)
    member[-200:] = 0.0
    z = bins[0] / 32.0 - 0.03 * bins[2] + 0.6 * (bins[1] > 10)
    label = z + 0.4 * rng.normal(size=N) > 0.5
    prob = 1.0 / (1.0 + np.exp(-rng.normal(size=N) * 0.2))
    grad = ((prob - label) * member).astype(np.float32)
    hess = (prob * (1 - prob) * member).astype(np.float32)
    plan = ((0, 3, 16), (0, 4, 5), (1, 1, 9))
    sp_kw = dict(min_data_in_leaf=5.0, lambda_l2=0.5)
    monkeypatch.setenv("LIGHTGBM_TPU_PACKED_ACC", "force")
    grow = make_grow_tree(B, JaxGrowerParams(
        num_leaves=15, hist_backend="pallas", row_chunk=256,
        use_monotone=True, forced_plan=plan,
        split=jsplit.SplitParams(**sp_kw, has_cat=False)))
    jfm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(num_bin), missing_type=jnp.asarray(missing),
        default_bin=jnp.asarray(default), is_cat=jnp.zeros(F, bool),
        monotone=jnp.asarray(mono), penalty=jnp.ones(F, jnp.float32))
    jt, jl = grow(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                  jnp.asarray(member), jfm, jnp.ones(F, jnp.float32),
                  jax.random.PRNGKey(0))
    g = FusedGrower(B, GrowerParams(
        num_leaves=15, packed_acc=True, use_monotone=True, forced_plan=plan,
        split=ts.SplitParams(**sp_kw)), 256)
    pfm = ts.FeatureMeta(torch.from_numpy(num_bin),
                         torch.from_numpy(missing),
                         torch.from_numpy(default),
                         monotone=torch.from_numpy(mono))
    pt, pl = g.grow(torch.from_numpy(bins), torch.from_numpy(grad),
                    torch.from_numpy(hess), torch.from_numpy(member), pfm)
    n = int(jt.num_leaves)
    assert pt.num_leaves == n == 15
    for name, m in (("split_feature", n - 1), ("threshold_bin", n - 1),
                    ("default_left", n - 1), ("left_child", n - 1),
                    ("right_child", n - 1), ("leaf_parent", n),
                    ("leaf_depth", n)):
        np.testing.assert_array_equal(getattr(pt, name)[:m],
                                      np.asarray(getattr(jt, name))[:m],
                                      err_msg=name)
    np.testing.assert_allclose(pt.leaf_value[:n],
                               np.asarray(jt.leaf_value)[:n], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert [(f, t) for _, f, t in plan] == list(zip(
        pt.split_feature[:3].tolist(), pt.threshold_bin[:3].tolist()))


@pytest.mark.parametrize("impl", ["segment", "frontier"])
def test_named_grower_with_a_forced_plan_takes_the_fused_one(tmp_path, impl,
                                                             capsys):
    X, y = sp.data(seed=4, n=600)
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"feature": 0, "threshold": 0.1}))
    params = dict(sp.BASE, tpu_tree_impl=impl, verbosity=1,
                  forcedsplits_filename=str(plan))
    bst = lt.Booster(params, lt.Dataset(X, y))
    assert type(bst.gbdt.grower).__name__ == "FusedGrower"
    assert "using the fused grower" in capsys.readouterr().out
    assert bst.gbdt.tree_impl == "fused"
    # the parameter lines keep the name given
    assert f"[tpu_tree_impl: {impl}]" in bst.model_to_string()
