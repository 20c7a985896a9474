"""Counter-based random numbers: the threefry2x32 stream of ``jax.random``.

The JAX package draws GOSS's row keys and ``feature_fraction_bynode``'s
node masks from ``jax.random`` (PRNGKey(seed), split once a tree, fold_in
a step).  The port draws the same bits from the same keys with its own
threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; 20 rounds of the 2x32 Threefish mix with key injections
every four) in torch, on the tensors' device, in the layout
``jax_threefry_partitionable=True`` gives:

  * ``prng_key(seed)``: the key words (0, seed mod 2^32), as 32-bit JAX
    builds them for any integer seed;
  * ``split(key, n)``: row i is threefry(key, (0, i));
  * ``fold_in(key, d)``: threefry(key, (0, d));
  * ``random_bits(key, n)``: threefry(key, (0, i)) for i < n, the two
    output words xor-ed;
  * ``uniform``: the top 23 bits as a float in [1, 2), minus 1;
  * ``bernoulli(key, p, n)``: uniform < p in float32.

A key is an int64 tensor [..., 2] holding two 32-bit words; every
operation works on int64 masked to 32 bits, which each device implements.
Batched keys ([K, 2]) give batched draws ([K, n]).  Nothing here reads a
value on the host, so the draws can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words (x1, x2) under key words
    (k1, k2); int64 tensors of 32-bit values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device: Union[str, torch.device] = "cpu"
             ) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as built with 32-bit integers: (0, seed
    mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, counts: torch.Tensor):
    """threefry(key, (0, counts)): key [..., 2], counts broadcast against
    the key's leading dimensions with one more axis."""
    return threefry2x32(key[..., :1], key[..., 1:], torch.zeros_like(counts),
                        counts)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: [num, 2] keys."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = _hash(key, idx)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in of one key [2] with each value of ``data`` (an
    int, or an integer tensor [K]): [2], or [K, 2]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y1, y2 = _hash(key, d.reshape(-1))
    out = torch.stack([y1, y2], dim=-1)
    return out.reshape(*d.shape, 2)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) as int64 in [0, 2^32): key [2] -> [n],
    keys [K, 2] -> [K, n]."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = _hash(key, idx)
    return y1 ^ y2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,)): float32 in [0, 1)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, n: int) -> torch.Tensor:
    """jax.random.bernoulli(key, p, (n,)): bool, uniform < p in float32."""
    return uniform(key, n) < float(np.float32(p))
