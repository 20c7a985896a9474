"""Exclusive feature bundling (EFB) in the PyTorch port against the JAX
package, on the CPU.

The port computes the JAX Dataset's grouping from the same binning sample
(lightgbm_tpu_torch/core/bundle.py).  On the generators of the port's
three configurations (chip_smoke.py: HIGGS-shaped binary data, and
multiclass_cat with its categorical columns) no multi-feature group forms
in either package, so ``enable_bundle=True``, the default of both, trains
on the unbundled bins.  On a sparse one-hot matrix the JAX package
bundles, the port finds the same groups and raises, since storing and
expanding a group is not ported.
"""

import os
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu_torch.core.dataset import TorchDataset

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke  # noqa: E402  (the configurations' data generators)


def _one_hot(n=3000, seed=0):
    """Two dense columns, then a 12-way one-hot block and a 6-way one:
    every one-hot column is 1 on a twelfth (a sixth) of the rows."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 12, size=n)
    b = rng.randint(0, 6, size=n)
    X = np.concatenate([rng.normal(size=(n, 2)), np.eye(12)[a],
                        np.eye(6)[b]], axis=1)
    y = X[:, 0] + (a % 3 == 0) + 0.1 * rng.normal(size=n)
    return X, y


def _groups(X, y, cat=()):
    jds = TpuDataset.from_numpy(X, y, config=JaxConfig(verbosity=-1),
                                categorical_features=cat)
    pds = TorchDataset.from_numpy(
        X, y, config=lt.Config(device_type="cpu", enable_bundle=False),
        categorical_features=cat)
    np.testing.assert_array_equal(pds.used_feature_indices,
                                  jds.used_feature_indices)
    return (None if jds.bundle is None else jds.bundle.groups,
            pds.find_bundle(X, lt.Config(device_type="cpu")))


@pytest.mark.parametrize("config", ["higgs", "multiclass_cat"])
def test_no_group_forms_on_the_configurations_data(config):
    if config == "higgs":
        X, y = chip_smoke.higgs_like(3000, 42)
        cat = ()
    else:
        X, y = chip_smoke.multiclass_cat(3000, 7)
        cat = chip_smoke.MC_CAT
    want, got = _groups(X, y, cat)
    assert want is None and got is None
    # the default enable_bundle=True builds the unbundled matrix
    ds = TorchDataset.from_numpy(X, y, config=lt.Config(device_type="cpu"),
                                 categorical_features=cat)
    plain = TorchDataset.from_numpy(
        X, y, config=lt.Config(device_type="cpu", enable_bundle=False),
        categorical_features=cat)
    np.testing.assert_array_equal(ds.bins_t, plain.bins_t)


def test_one_hot_columns_group_as_in_jax_and_raise():
    X, y = _one_hot()
    want, got = _groups(X, y)
    assert want is not None and any(len(g) > 1 for g in want)
    assert got == want
    with pytest.raises(NotImplementedError, match="expansion"):
        lt.Dataset(X, y).construct()
    with pytest.raises(NotImplementedError, match="expansion"):
        lt.train({"device_type": "cpu", "verbosity": -1},
                 lt.Dataset(X, y), 1)
    # off, the same data trains
    bst = lt.train({"device_type": "cpu", "verbosity": -1,
                    "enable_bundle": False}, lt.Dataset(X, y), 1)
    assert bst.gbdt.models[0].num_leaves > 1
