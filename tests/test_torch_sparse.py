"""Scipy sparse input in the PyTorch port, on the CPU.

``lt.Dataset`` takes a scipy matrix (CSR, CSC) and bins it from each
column's nonzeros, never densifying it (TorchDataset.from_scipy, after
lightgbm_tpu/core/dataset.py from_scipy).  Its bins are the dense input's
byte for byte, so a model trained from a CSR matrix is the model trained
from its dense twin; a valid set takes its reference's packing; predict
on a scipy matrix keeps the dense route (the JAX package's C9 rule).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.core.dataset import TorchDataset

PARAMS = {"objective": "binary", "metric": "binary_logloss",
          "device_type": "cpu", "verbosity": -1, "num_leaves": 15,
          "min_data_in_leaf": 5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests: the CPU tests
    share the cores with other pytest workers, and torch's parallel
    regions on oversubscribed cores ran these tests 20-80 times slower
    than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sparse_binary(n=2000, blocks=50, width=20, seed=0):
    """[n, blocks * width] with one nonzero a block a row (the JAX
    package's tests/test_bundle.py make_sparse_binary): every feature is
    95% zero, the block sums carry the signal."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, blocks * width))
    picks = rng.randint(0, width, size=(n, blocks))
    vals = rng.normal(loc=2.0, scale=1.0, size=(n, blocks))
    for b in range(blocks):
        X[np.arange(n), b * width + picks[:, b]] = vals[:, b]
    logit = (X[:, :width].sum(axis=1) - X[:, width:2 * width].sum(axis=1)
             + 0.5 * X[:, 2 * width:3 * width].sum(axis=1) - 1.0)
    y = (logit + rng.normal(size=n) * 0.3 > 0).astype(np.float64)
    return X, y


def _log_loss(y, p):
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def _trees(bst):
    text = bst.model_to_string()
    return text[:text.index("parameters:")]


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_model_equals_the_dense_model(fmt):
    X, y = _sparse_binary(n=1500, blocks=10)
    Xs = getattr(sp, f"{fmt}_matrix")(X)
    dense = lt.train(PARAMS, lt.Dataset(X, y), 3)
    sparse = lt.train(PARAMS, lt.Dataset(Xs, y), 3)
    assert sparse.gbdt.train_set.bundle is not None
    np.testing.assert_array_equal(sparse.gbdt.train_set.bins_t,
                                  dense.gbdt.train_set.bins_t)
    assert _trees(sparse) == _trees(dense)
    # predict on the scipy matrix = predict on its dense twin
    np.testing.assert_array_equal(sparse.predict(Xs), dense.predict(X))


def test_sparse_without_densify_trains(monkeypatch):
    """The JAX package's test_python_api_accepts_scipy_without_densify:
    a CSR matrix whose toarray raises bins and trains; a valid set from
    another CSR matrix takes the training packing."""
    X, y = _sparse_binary()
    Xs = sp.csr_matrix(X)

    def refuse(*a, **k):
        raise MemoryError("densified sparse input")

    for name in ("toarray", "todense"):
        monkeypatch.setattr(Xs, name, refuse, raising=False)
        monkeypatch.setattr(sp.csc_matrix, name, refuse)
    ds = lt.Dataset(Xs[:1500], y[:1500], params=PARAMS)
    va = ds.create_valid(Xs[1500:], y[1500:])
    evals = {}
    params = dict(PARAMS, learning_rate=0.3)
    bst = lt.train(params, ds, 8, valid_sets=[va], evals_result=evals)
    monkeypatch.undo()
    h = ds._handle
    assert h.bundle is not None and h.bins_t.shape[0] < X.shape[1] // 4
    assert va._handle.bundle is h.bundle
    loss = evals["valid_0"]["binary_logloss"]
    assert loss[-1] < 0.6 and loss[-1] < loss[0]
    # on the raw rows too (the valid bins may differ where two members of
    # a group, exclusive on the training rows, meet on a valid row)
    assert _log_loss(y[1500:], bst.predict(X[1500:])) < 0.6


def test_sparse_valid_set_bins_as_the_dense_one():
    X, y = _sparse_binary(n=1200, blocks=8, seed=1)
    train = TorchDataset.from_scipy(sp.csr_matrix(X[:800]), y[:800],
                                    config=lt.Config(device_type="cpu"))
    a = TorchDataset.from_scipy(sp.csr_matrix(X[800:]), y[800:],
                                reference=train)
    b = TorchDataset.from_numpy(X[800:], y[800:], reference=train)
    assert a.bundle is train.bundle is b.bundle
    np.testing.assert_array_equal(a.bins_t, b.bins_t)
    train.check_align(a)
