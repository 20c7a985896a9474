"""LambdaRank NDCG objective.

Counterpart of lightgbm_tpu/objective/rank.py; reference
src/objective/rank_objective.hpp:23-230: per-query pairwise lambda
gradients weighted by the pair's delta-NDCG, sigmoid-scaled logistic
pair probabilities, optional lambdamart normalization, the label_gain
table and the inverse max-DCG truncated at ``max_position``.

As in the JAX package, the reference's per-query loop over O(n_q^2)
pairs becomes a masked ``[C, P, P]`` pairwise tensor computation over
chunks of C queries: queries are bucketed by padded length (a power of
two, at least 8), and a bucket is processed in chunks of at most
``PAIR_BUDGET / P^2`` queries, which bounds the transients.  Plain
PyTorch on the training device; the JAX package computes it outside any
Pallas kernel.  Every document is in exactly one query, so each chunk's
lambdas are written to their documents by index, never summed with a
float atomic: the gradients are the same bits on every run.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.dcg import DCGCalculator
from ..utils.log import check
from .base import ObjectiveFunction

# the JAX package's chunk: 2^24 pair entries, ~64 MB a [C, P, P] f32 tensor
PAIR_BUDGET = 1 << 24


def chunk_lambdas(scores: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, inv_max_dcg: torch.Tensor,
                  gains: torch.Tensor, sigmoid: float, norm: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise lambdas of a chunk of queries (lightgbm_tpu/objective/
    rank.py _chunk_lambdas).  scores/labels/mask: [C, P] (f32, int64,
    bool); inv_max_dcg: [C]; gains: the label-gain table.  Returns
    (lambdas [C, P], hessians [C, P])."""
    C, P = scores.shape
    s = torch.where(mask, scores, torch.full_like(scores, -1e30))
    # the stable descending order: at the first iteration every score is
    # 0 and the ranks are the tie order; + 0.0 sorts -0.0 with +0.0
    order = torch.sort(-s + 0.0, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(P, device=s.device).expand(C, P))
    disc = 1.0 / torch.log2(2.0 + rank.float())                 # [C, P]
    g = gains[labels]                                           # [C, P]

    sa = s[:, :, None]
    sb = s[:, None, :]
    pair_ok = (mask[:, :, None] & mask[:, None, :]
               & (labels[:, :, None] > labels[:, None, :]))
    delta = sa - sb
    dn = ((g[:, :, None] - g[:, None, :])
          * torch.abs(disc[:, :, None] - disc[:, None, :])
          * inv_max_dcg[:, None, None])
    if norm:
        inf = torch.full_like(scores, float("inf"))
        best = torch.max(torch.where(mask, scores, -inf), dim=1).values
        worst = torch.min(torch.where(mask, scores, inf), dim=1).values
        diff_bw = (best != worst)[:, None, None]
        dn = torch.where(diff_bw & pair_ok, dn / (0.01 + torch.abs(delta)),
                         dn)
    sig = 1.0 / (1.0 + torch.exp(sigmoid * delta))
    zero = torch.zeros((), dtype=dn.dtype, device=dn.device)
    lam = torch.where(pair_ok, -sigmoid * dn * sig, zero)
    hes = torch.where(pair_ok, sigmoid * sigmoid * dn * sig * (1.0 - sig),
                      zero)

    lambdas = torch.sum(lam, dim=2) - torch.sum(lam, dim=1)
    hessians = torch.sum(hes, dim=2) + torch.sum(hes, dim=1)
    if norm:
        sum_lambdas = -2.0 * torch.sum(lam, dim=(1, 2))         # [C]
        factor = torch.where(sum_lambdas > 0,
                             torch.log2(1.0 + sum_lambdas)
                             / torch.clamp(sum_lambdas, min=1e-20),
                             torch.ones_like(sum_lambdas))
        lambdas = lambdas * factor[:, None]
        hessians = hessians * factor[:, None]
    return lambdas, hessians


class LambdarankNDCG(ObjectiveFunction):
    name = "lambdarank"
    need_group = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        check(metadata.query_boundaries is not None,
              "Lambdarank tasks require query information")
        self.sigmoid = float(self.config.sigmoid)
        self.norm = bool(self.config.lambdamart_norm)
        self.max_position = int(self.config.max_position)
        calc = DCGCalculator(self.config.label_gain)
        calc.check_labels(self.label_np)
        self.calc = calc
        boundaries = np.asarray(metadata.query_boundaries)
        nq = len(boundaries) - 1
        inv = np.zeros(nq)
        for q in range(nq):
            m = calc.cal_maxdcg_at_k(
                self.max_position,
                self.label_np[boundaries[q]: boundaries[q + 1]])
            inv[q] = 1.0 / m if m > 0 else 0.0
        sizes = np.diff(boundaries)
        pads = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(sizes, 1)))
                          .astype(np.int64))
        self.buckets: List[Dict] = []
        for p in np.unique(pads):
            qs = np.nonzero(pads == p)[0]
            P = int(p)
            # query q's documents, then -1 padding: [len(qs), P]
            cols = np.arange(P)[None, :]
            idx = boundaries[qs][:, None] + cols
            idx = np.where(cols < sizes[qs][:, None], idx, -1)
            # the JAX package's chunk: the same chunk count with the
            # fewest phantom queries
            chunk = max(1, PAIR_BUDGET // (P * P))
            n_chunks = -(-len(qs) // min(chunk, len(qs)))
            C = -(-len(qs) // n_chunks)
            mask = idx >= 0
            labels = np.where(mask, self.label_np[np.maximum(idx, 0)], 0)
            dev = lambda a, dt: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a, dtype=dt)).to(device)
            self.buckets.append({
                "P": P, "C": C,
                "idx": dev(np.maximum(idx, 0), np.int64),
                "mask": dev(mask, np.bool_),
                "labels": dev(labels, np.int64),
                "inv_max_dcg": dev(inv[qs], np.float32),
            })
        self.gains = torch.from_numpy(
            calc.label_gain.astype(np.float32)).to(device)

    def get_gradients(self, score):
        grad = torch.zeros_like(score)
        hess = torch.zeros_like(score)
        for b in self.buckets:
            C = b["C"]
            for lo in range(0, b["idx"].shape[0], C):
                idx = b["idx"][lo:lo + C]
                msk = b["mask"][lo:lo + C]
                lam, hes = chunk_lambdas(
                    score[idx], b["labels"][lo:lo + C], msk,
                    b["inv_max_dcg"][lo:lo + C], self.gains,
                    sigmoid=self.sigmoid, norm=self.norm)
                # each document once: written by index, no atomic sum
                rows = idx[msk]
                grad[rows] = lam[msk]
                hess[rows] = hes[msk]
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0
