"""The port's threefry stream (lightgbm_tpu_torch/utils/random.py) against
``jax.random`` on the CPU, bit for bit: keys from seeds (0, 1, 2^31 - 1,
the package's default seeds, and seeds at and past 2^31 or below 0),
split, fold_in, uniform and bernoulli at several lengths (odd ones
included), batched keys, and the by-node feature masks against
``lightgbm_tpu.models.grower._node_feature_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.models.grower import _node_feature_mask
from lightgbm_tpu_torch.models.grower import GrowerParams, node_feature_mask
from lightgbm_tpu_torch.utils import random

# 0, 1, 2^31 - 1, seed / feature_fraction_seed / bagging_seed /
# drop_seed defaults, and seeds whose 32-bit form wraps
SEEDS = [0, 1, 2**31 - 1, 2, 3, 4, 2**31, 2**32 + 7, -1, -2**31]
LENGTHS = [1, 2, 7, 28, 255, 1001]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the CPU tests
    share the cores with other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_match_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), random.prng_key(seed)
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(random.split(pk, num).numpy(),
                                      _words(jax.random.split(jk, num)))
    # the key stream of a booster: split once a tree
    for _ in range(4):
        jk, jsub = jax.random.split(jk)
        pk, psub = random.split(pk)
        np.testing.assert_array_equal(psub.numpy(), _words(jsub))
    for d in (0, 1, 5, 0x60550000 + 11, 2**32 - 1):
        np.testing.assert_array_equal(random.fold_in(pk, d).numpy(),
                                      _words(jax.random.fold_in(jk, d)))
    steps = torch.arange(9)
    got = random.fold_in(pk, steps).numpy()
    for i in range(9):
        np.testing.assert_array_equal(got[i],
                                      _words(jax.random.fold_in(jk, i)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_bernoulli_match_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), random.prng_key(seed)
    for n in LENGTHS:
        ju = np.asarray(jax.random.uniform(jk, (n,)))
        pu = random.uniform(pk, n).numpy()
        assert pu.dtype == np.float32
        np.testing.assert_array_equal(pu.view(np.uint32), ju.view(np.uint32))
        assert (pu >= 0).all() and (pu < 1).all()
        np.testing.assert_array_equal(
            random.random_bits(pk, n).numpy(),
            _words(jax.random.bits(jk, (n,), dtype=jnp.uint32)))
        for p in (0.1, 0.5, 0.8):
            np.testing.assert_array_equal(
                random.bernoulli(pk, p, n).numpy(),
                np.asarray(jax.random.bernoulli(jk, p, (n,))))


def test_batched_keys_draw_each_keys_stream():
    jk, pk = jax.random.PRNGKey(42), random.prng_key(42)
    keys = random.fold_in(pk, torch.arange(6))
    got = random.uniform(keys, 33).numpy()
    assert got.shape == (6, 33)
    for i in range(6):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(jk, i),
                                              (33,)))
        np.testing.assert_array_equal(got[i].view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("frac", [0.05, 0.3, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("F", [1, 8, 28, 31])
def test_node_feature_mask_matches_jax(F, frac):
    """Every node number a 31-leaf tree uses (0 .. 2L), with a tree mask
    that keeps some features; a draw that keeps none falls back to the
    tree mask (frequent at F = 1 and frac 0.05)."""
    rng = np.random.RandomState(F)
    base = (rng.uniform(size=F) < 0.7).astype(np.float32)
    base[rng.randint(F)] = 1.0
    L = 31
    jp = JaxGrowerParams(num_leaves=L, feature_fraction_bynode=frac)
    pp = GrowerParams(num_leaves=L, feature_fraction_bynode=frac)
    for seed in (0, 5):
        jk = jax.random.split(jax.random.PRNGKey(seed))[1]
        pk = random.split(random.prng_key(seed))[1]
        steps = torch.arange(2 * L + 1)
        got = node_feature_mask(torch.from_numpy(base), pk, steps, pp)
        assert got.shape == (2 * L + 1, F)
        for s in range(2 * L + 1):
            want = np.asarray(_node_feature_mask(jnp.asarray(base), jk,
                                                 jnp.int32(s), jp))
            np.testing.assert_array_equal(got[s].numpy(), want,
                                          err_msg=f"step {s}")
