"""GOSS: gradient-based one-side sampling.

Counterpart of lightgbm_tpu/models/goss.py (reference
src/boosting/goss.hpp:30-220): after a warm-up of int(1 / learning_rate)
iterations on every row, each iteration keeps the ``top_rate`` share of
the rows by sum over classes of |grad x hess| and ``other_rate`` of the
rest, drawn uniformly; the drawn rows' gradients and hessians are
amplified by (n - top_k) / other_k.  The selection runs on the booster's
device over the ``num_data`` real rows (never the pad rows), with the JAX
package's draw: uniform keys from fold_in(key, 0x60550000 + iteration)
of the booster's threefry stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import random
from ..utils.log import check
from .gbdt import GBDT


def goss_select(grad: torch.Tensor, hess: torch.Tensor, key: torch.Tensor,
                top_k: int, other_k: int):
    """The selection over the rows of ``grad``/``hess`` ([C, n] f32, the
    real rows only) with the threefry ``key`` ([2] on their device):
    (grad', hess', mask [n] f32).  The top_k rows by score in a stable
    descending order (the JAX package's ``argsort(-score)``), and of the
    rest the rows whose uniform key is at most the other_k-th smallest
    (so rows tied with it come too, as there); the latter amplified
    (lightgbm_tpu/models/goss.py:24-52)."""
    n = grad.shape[1]
    score = torch.sum(torch.abs(grad * hess), dim=0)
    order = torch.argsort(-score, stable=True)
    top = torch.zeros(n, dtype=torch.bool, device=grad.device)
    top[order[:top_k]] = True
    u = random.uniform(key, n)
    u = torch.where(top, torch.full_like(u, float("inf")), u)
    kth = torch.kthvalue(u, max(other_k, 1)).values
    rest = (u <= kth) & ~top
    multiply = float(np.float32(n - top_k) / np.float32(max(other_k, 1)))
    amp = torch.where(rest, torch.full_like(u, multiply),
                      torch.ones_like(u))
    mask = (top | rest).to(torch.float32)
    return grad * amp[None], hess * amp[None], mask


class GOSS(GBDT):
    """GBDT whose bag is GOSS's selection (the bagging parameters are not
    used)."""

    _draws_keys = True

    def __init__(self, config, train_set, objective, **kwargs):
        super().__init__(config, train_set, objective, **kwargs)
        check(config.top_rate + config.other_rate <= 1.0,
              "top_rate + other_rate cannot be larger than 1.0")
        check(config.top_rate > 0 and config.other_rate > 0,
              "top_rate and other_rate must be positive for GOSS")

    def _bagging(self, iter_idx, grad, hess):
        cfg = self.config
        n = self.num_data
        if iter_idx < int(1.0 / cfg.learning_rate):
            # warm-up: every row
            self.member[:n].fill_(1.0)
            return grad, hess
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        key = random.fold_in(self._key, 0x60550000 + iter_idx)
        g, h, mask = goss_select(grad[:, :n], hess[:, :n],
                                 key.to(self.device), top_k, other_k)
        grad, hess = grad.clone(), hess.clone()
        grad[:, :n] = g
        hess[:, :n] = h
        self._set_bag(mask)
        return grad, hess
