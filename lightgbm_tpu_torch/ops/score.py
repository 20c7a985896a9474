"""Boosting score update: ``score + table[leaf_id]`` — kernel K4 and its
plain version.

Counterpart of lightgbm_tpu/ops/pallas_score.py (score_gather_add), the
score side of the reference's ScoreUpdater
(src/boosting/score_updater.hpp:84-99).  The CUDA kernel is in
``csrc/score.cu``; it is bit-identical to the plain float32 expression.
Scale factors (shrinkage) belong pre-applied to ``table``; leaf ids
outside [0, len(table)) add zero.  ``out`` may be ``score`` itself: the
boosting loop updates its score rows in place, one pass per tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels


def score_gather_add_plain(score: torch.Tensor, leaf_id: torch.Tensor,
                           table: torch.Tensor,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    L = table.shape[0]
    ok = (leaf_id >= 0) & (leaf_id < L)
    v = torch.where(ok, table[leaf_id.clamp(0, max(L - 1, 0)).long()],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return torch.add(score, v, out=out)


def score_gather_add(score: torch.Tensor, leaf_id: torch.Tensor,
                     table: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: [N] f32 score, [N] i32 leaf ids, [L] f32 table -> [N] f32,
    written to ``out`` when given (which may be ``score``)."""
    if score.device.type == "cpu":
        return score_gather_add_plain(score, leaf_id, table, out)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    n = score.shape[0]
    if out is None:
        out = torch.empty_like(score)
    for name, t, dtype in (("score", score, torch.float32),
                           ("leaf_id", leaf_id, torch.int32),
                           ("table", table, torch.float32),
                           ("out", out, torch.float32)):
        if t.device != score.device or t.dtype != dtype \
                or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor on {score.device}")
    if leaf_id.shape[0] != n or out.shape[0] != n:
        raise ValueError("score, leaf_id and out lengths differ")
    rc = kernels.library().lgbt_score_gather_add(
        score.data_ptr(), leaf_id.data_ptr(), table.data_ptr(),
        out.data_ptr(), n, table.shape[0], kernels.stream_ptr(score.device))
    kernels.check_launch("score_gather_add", rc)
    return out
