"""The split features on the port's frontier grower (K = 4) against the
JAX package's, on the CPU: monotone constraints, feature_contri and CEGB's
split and coupled costs each grow JAX's trees split for split with one
model text (tests/split_parity.py), change the model, and keep
predictions monotone in every constrained feature.  A round applies its
four splits, handing bounds on and marking used features, before it scans
the eight children (JAX grower_frontier.py:357-367, :600-615).  And the
segment grower's deep trees (63 leaves, 10 iterations) stay monotone
where an unconstrained model does not."""

import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset

import split_parity as sp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


FRONTIER = dict(sp.BASE, tpu_tree_impl="frontier", tpu_frontier_width=4)
CASES = {
    "monotone": dict(monotone_constraints=sp.MONOTONE),
    "feature_contri": dict(feature_contri=[0.4, 1.0, 1.0, 0.2, 1.0, 1.0]),
    "cegb": dict(cegb_penalty_split=0.003,
                 cegb_penalty_feature_coupled=[0.0, 5.0, 3.0, 8.0, 0.0,
                                               4.0]),
    "all": dict(monotone_constraints=sp.MONOTONE,
                feature_contri=[1.0, 0.7, 1.0, 0.5, 1.0, 0.3],
                cegb_penalty_split=0.001, cegb_tradeoff=1.5,
                cegb_penalty_feature_coupled=[2.0] * sp.NF),
}


@pytest.fixture(scope="module")
def xy():
    return sp.data(seed=8)


@pytest.fixture(scope="module")
def plain_splits(xy):
    X, y = xy
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(**FRONTIER))
    return sp.splits(sp.port_trained(FRONTIER, jds, y))


@pytest.mark.parametrize("case", list(CASES))
def test_frontier_trees_match_jax(xy, plain_splits, case):
    X, y = xy
    params = dict(FRONTIER, **CASES[case])
    jds, jgb = sp.jax_trained(params, X, y)
    bst = sp.port_trained(params, jds, y)
    g = bst.gbdt.grower
    assert type(g).__name__ == "FrontierGrower" and g.K == 4
    sp.assert_same_model(jgb, bst)
    assert sp.splits(bst) != plain_splits
    if "monotone_constraints" in CASES[case]:
        assert sp.monotone_violation(bst, X, sp.MONOTONE) <= 0.0


def test_segment_monotone_deep_trees_hold_globally():
    """63 leaves and 10 iterations re-split the constrained features deep
    in the trees; every sweep stays monotone, and without the constraints
    a sweep does not (the check can fail)."""
    X, y = sp.data(seed=11)
    params = dict(sp.BASE, num_leaves=63, min_data_in_leaf=5,
                  monotone_constraints=sp.MONOTONE)
    bst = lt.train(params, lt.Dataset(X, y), 10)
    assert sp.monotone_violation(bst, X, sp.MONOTONE) <= 0.0
    params.pop("monotone_constraints")
    free = lt.train(params, lt.Dataset(X, y), 10)
    assert sp.monotone_violation(free, X, sp.MONOTONE) > 1e-6
