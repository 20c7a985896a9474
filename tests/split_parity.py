"""The harness the split-feature parity tests share (test_torch_split_*.py,
test_torch_fused_grower.py, test_torch_param_parity.py): the JAX package
and the port train from identical bins on the CPU, JAX's Pallas kernels in
interpret mode, the port's kernels through their plain versions, and the
two models are held to one model text.

``assert_same_model`` is the rule: every tree's structure lines (split
features, thresholds, decision types, children, counts) equal, the
parameter lines equal byte for byte, and leaf values within 1e-5 + 1e-4
relative (float32 sums taken in another order).  The data have a
zero-heavy column and a nonlinear label, and no NaN: a NaN-missing split
of a leaf without NaN rows gets its default direction from float rounding
in both packages (the two directions are one partition), and XLA's
cumulative sums on the CPU round in another order than torch's, so its
model text would differ in a decision type while every split agrees.
"""

import json

import numpy as np
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.models.boosting_factory import \
    create_boosting as jax_boosting
from lightgbm_tpu.models.serialization import save_model_to_string
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import convert

N, NF, ITERS = 3000, 6, 3
BASE = dict(device_type="cpu", objective="binary", num_leaves=15,
            max_bin=63, tpu_row_chunk=256, min_data_in_leaf=10,
            verbosity=-1)
# signs from the label's dependence on each feature (0: free)
MONOTONE = [1, -1, 0, 1, 0, 0]


def data(seed=42, n=N, nf=NF):
    """[n, nf] with a zero-heavy column 3; the label rises in columns 0
    and 3 and falls in column 1, nonlinearly in column 2."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, nf))
    X[:, 3] = np.where(rng.uniform(size=n) < 0.3, 0.0, X[:, 3])
    z = (X[:, 0] - 0.7 * X[:, 1] - 0.4 * X[:, 2] ** 2
         + 0.5 * np.sin(3 * X[:, 3]) + 0.3 * X[:, 4] * X[:, 0])
    y = (z + 0.4 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def one_hot_data(seed=5, n=N):
    """Two dense columns, a 10-way one-hot block (EFB bundles it) and a
    dense column."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 10, size=n)
    X = np.concatenate([rng.normal(size=(n, 2)), np.eye(10)[a],
                        rng.normal(size=(n, 1))], axis=1)
    z = X[:, 0] + 0.8 * (a % 3 == 0) - 0.5 * X[:, 12] ** 2
    y = (z + 0.3 * rng.normal(size=n) > 0.2).astype(np.float64)
    return X, y


def jax_trained(params, X, y, iters=ITERS, categorical=()):
    """(JAX dataset, JAX booster trained ``iters`` iterations) for
    ``params``; the histogram backend is set on the configuration after
    it is built, so its parameter lines are the port's."""
    cfg = JaxConfig(**params)
    cfg.tpu_histogram_backend = "pallas"
    jds = TpuDataset.from_numpy(X, y, config=cfg,
                                categorical_features=list(categorical))
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = jax_boosting(cfg, jds, obj)
    for _ in range(iters):
        jgb.train_one_iter()
    jgb._flush_pending()
    return jds, jgb


def port_dataset(jds, y):
    """The port's Dataset over the JAX dataset's bins, EFB groups and
    per-feature settings."""
    return convert.dataset_from_arrays(
        jds.binned, [m.to_dict() for m in jds.bin_mappers], y,
        bundle_groups=(None if jds.bundle is None
                       else [list(g) for g in jds.bundle.groups]),
        monotone_constraints=jds.monotone_constraints,
        feature_penalty=jds.feature_penalty)


def port_trained(params, jds, y, iters=ITERS, **booster_kw):
    bst = lt.Booster(dict(params), port_dataset(jds, y), **booster_kw)
    for _ in range(iters):
        bst.update()
    return bst


def _structure(text):
    keys = ("Tree=", "num_leaves=", "split_feature=", "threshold=",
            "decision_type=", "left_child=", "right_child=", "leaf_count=",
            "internal_count=", "num_cat=", "cat_threshold=")
    return [line for line in text.split("end of trees")[0].splitlines()
            if line.startswith(keys)]


def assert_same_model(jgb, bst, min_splits=20):
    """The port's model text is JAX's (module docstring); returns it."""
    jtext = save_model_to_string(jgb, jgb.config)
    ptext = bst.model_to_string()
    assert _structure(ptext) == _structure(jtext)
    assert ptext.split("parameters:")[1] == jtext.split("parameters:")[1]
    jt, pt = jgb.models, bst.gbdt.models
    assert len(jt) == len(pt)
    for a, b in zip(jt, pt):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    assert sum(t.num_leaves - 1 for t in pt) >= min_splits
    return ptext


def splits(bst):
    """Every tree's (inner feature, bin threshold) pairs."""
    return [list(zip(t.split_feature_inner[:t.num_leaves - 1].tolist(),
                     t.threshold_in_bin[:t.num_leaves - 1].tolist()))
            for t in bst.gbdt.models]


def monotone_violation(bst, X, monotone, contexts=8, points=60, seed=0):
    """The largest step against its constraint of the raw prediction over
    a sweep of each constrained feature, the other features held at a
    row's values (lightgbm_tpu's tests/test_split_completeness.py:23-34):
    0.0 when every sweep is monotone."""
    rng = np.random.RandomState(seed)
    worst = 0.0
    grid = np.linspace(-3, 3, points)
    for f, sign in enumerate(monotone):
        if sign == 0:
            continue
        rows = X[rng.randint(0, len(X), size=contexts)]
        Xs = np.repeat(rows, points, axis=0)
        Xs[:, f] = np.tile(grid, contexts)
        pred = bst.predict(Xs, raw_score=True).reshape(contexts, points)
        worst = max(worst, float(np.max(-sign * np.diff(pred, axis=1))))
    return worst


def one_torch_thread():
    """A module fixture's body: one torch intra-op thread while the
    module runs (the CPU tests share the cores with other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# three levels: the root, both children, and a child of each
DENSE_PLAN = {"feature": 0, "threshold": 0.1,
              "left": {"feature": 1, "threshold": 0.4,
                       "left": {"feature": 2, "threshold": -0.5}},
              "right": {"feature": 3, "threshold": 0.2,
                        "right": {"feature": 4, "threshold": 0.3}}}
# column 12 dense, 5 a member of the bundled one-hot block
EFB_PLAN = {"feature": 12, "threshold": 0.0,
            "left": {"feature": 5, "threshold": 0.0,
                     "right": {"feature": 0, "threshold": -0.2}},
            "right": {"feature": 0, "threshold": 0.3}}
LAZY = [0.02, 0.05, 0.0, 0.01, 0.03, 0.02]


def plan_files(directory):
    """{"dense": DENSE_PLAN's path, "efb": EFB_PLAN's}, written into
    ``directory`` (a pathlib.Path)."""
    out = {}
    for name, plan in (("dense", DENSE_PLAN), ("efb", EFB_PLAN)):
        path = directory / f"{name}.json"
        path.write_text(json.dumps(plan))
        out[name] = str(path)
    return out


def fused_case(name, plans):
    """(params, X, y, forced splits a tree)."""
    X, y = data(seed=4)
    if name == "forced":
        return (dict(BASE, forcedsplits_filename=plans["dense"],
                     monotone_constraints=MONOTONE), X, y, 5)
    if name == "forced_4bit":
        return (dict(BASE, max_bin=15, forcedsplits_filename=plans["dense"],
                     monotone_constraints=MONOTONE), X, y, 5)
    if name == "forced_efb":
        Xo, yo = one_hot_data()
        return (dict(BASE, forcedsplits_filename=plans["efb"]), Xo, yo, 4)
    if name == "lazy":
        return dict(BASE, cegb_penalty_feature_lazy=LAZY), X, y, 0
    # every split feature on the fused grower
    return (dict(BASE, tpu_tree_impl="fused",
                 forcedsplits_filename=plans["dense"],
                 monotone_constraints=MONOTONE,
                 feature_contri=[1.0, 0.6, 1.0, 0.8, 1.0, 0.5],
                 cegb_penalty_split=0.001,
                 cegb_penalty_feature_coupled=[1.0, 2.0, 0.0, 3.0, 1.0, 2.0],
                 cegb_penalty_feature_lazy=LAZY), X, y, 5)


def check_fused_case(case, plans):
    """The fused grower on ``fused_case(case)`` grows JAX's model text;
    the plan heads every tree, K5 ran once for each root and split, the
    constraints hold and CEGB-lazy changed the model."""
    params, X, y, nforced = fused_case(case, plans)
    jds, jgb = jax_trained(params, X, y)
    assert not jgb._use_segment
    if case == "forced_efb":
        assert jds.bundle is not None
    bst = port_trained(params, jds, y)
    g = bst.gbdt.grower
    assert type(g).__name__ == "FusedGrower"
    assert bst.gbdt.packed4 == (case == "forced_4bit")
    assert len(g.p.forced_plan) == nforced
    assert g.last_stats["forced"] == nforced
    assert g.last_stats["k5_launches"] == g.last_stats["splits"] + 1
    assert_same_model(jgb, bst)
    plan = [(f, t) for _, f, t in g.p.forced_plan]
    for tree in splits(bst):
        assert tree[:nforced] == plan
    if "monotone_constraints" in params:
        assert monotone_violation(bst, X, MONOTONE) <= 0.0
    if "cegb_penalty_feature_lazy" in params:
        plain = dict(params)
        plain.pop("cegb_penalty_feature_lazy")
        jds2 = TpuDataset.from_numpy(X, y, config=JaxConfig(**plain))
        assert splits(port_trained(plain, jds2, y)) != splits(bst)
