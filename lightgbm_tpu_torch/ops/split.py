"""Best-split search over histograms, vectorized across (leaf, feature,
threshold).

Re-expresses the reference's sequential two-direction scans
(FeatureHistogram::FindBestThresholdSequence,
src/treelearner/feature_histogram.hpp:508-650) as cumulative sums over the
bin axis with validity masks, so every (feature, threshold, direction)
candidate is evaluated at once and the winner picked by one argmax.  Gain
math matches GetSplitGains / CalculateSplittedLeafOutput /
GetLeafSplitGainGivenOutput (feature_histogram.hpp:451-506): L1 soft
thresholding, L2, max_delta_step clamp.

Missing-value semantics (feature_histogram.hpp:91-116):
  * MissingType::None  — single right-to-left scan.
  * MissingType::Zero  — the zero bin is excluded from both running sums
    and from the candidate thresholds; its mass follows the default
    direction.
  * MissingType::NaN   — the trailing NaN bin is excluded from the
    running sums; two scans try NaN-left and NaN-right.

The port's slice is numerical only (no categorical candidates) and
unbundled, so a group histogram is already the per-feature histogram.
Every function takes a batch of K leaves: hist ``[K, F, B, 3]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

K_EPSILON = 1e-15
NEG_INF = float("-inf")


class FeatureMeta(NamedTuple):
    """Per-used-feature metadata as int32 tensors [F] on the device."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    default_bin: torch.Tensor


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0


class SplitInfo(NamedTuple):
    """Best split of each of K leaves (reference SplitInfo,
    src/treelearner/split_info.hpp:22); every field is [K]."""
    gain: torch.Tensor
    feature: torch.Tensor        # -1 = no split
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor
    right_g: torch.Tensor
    right_h: torch.Tensor
    right_c: torch.Tensor
    left_out: torch.Tensor
    right_out: torch.Tensor


def threshold_l1(s, l1: float):
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(G, H, l1: float, l2: float, max_delta_step: float):
    """-ThresholdL1(G)/(H+l2), clamped to max_delta_step
    (CalculateSplittedLeafOutput, feature_histogram.hpp:453-460)."""
    out = -threshold_l1(G, l1) / (H + l2 + K_EPSILON)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def leaf_gain_given_output(G, H, l1: float, l2: float, out):
    sg = threshold_l1(G, l1)
    return -(2.0 * sg * out + (H + l2) * out * out)


def leaf_gain(G, H, l1: float, l2: float, max_delta_step: float):
    return leaf_gain_given_output(G, H, l1, l2,
                                  leaf_output(G, H, l1, l2, max_delta_step))


def _split_gain(Gl, Hl, Gr, Hr, p: SplitParams):
    out_l = leaf_output(Gl, Hl, p.lambda_l1, p.lambda_l2, p.max_delta_step)
    out_r = leaf_output(Gr, Hr, p.lambda_l1, p.lambda_l2, p.max_delta_step)
    return (leaf_gain_given_output(Gl, Hl, p.lambda_l1, p.lambda_l2, out_l)
            + leaf_gain_given_output(Gr, Hr, p.lambda_l1, p.lambda_l2, out_r))


def _numerical_candidates(hist, parent, fmeta: FeatureMeta,
                          p: SplitParams):
    """Gains for every (leaf, feature, threshold, direction) candidate.

    Returns (gain [K, F, T, 2], left [K, F, T, 2, 3]) with T = B-1
    thresholds; direction 0 = missing/default LEFT (the reference's
    dir=-1 scan), direction 1 = missing RIGHT (dir=+1)."""
    K, F, B, _ = hist.shape
    dev = hist.device
    b_idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    nb = fmeta.num_bin[:, None]
    mt = fmeta.missing_type[:, None]
    # the reference only applies missing-direction handling when
    # num_bin > 2 (feature_histogram.hpp:96-110)
    use_missing = (mt != MISSING_NONE) & (nb > 2)
    nan_bin = torch.where(mt == MISSING_NAN, nb - 1, -1)
    zero_skip = torch.where(mt == MISSING_ZERO, fmeta.default_bin[:, None],
                            -1)
    in_range = b_idx < nb
    excluded = ((b_idx == nan_bin) | (b_idx == zero_skip)) & use_missing
    eff = hist * (in_range & ~excluded)[None, :, :, None].to(hist.dtype)
    cum = torch.cumsum(eff, dim=2)                            # [K, F, B, 3]
    total_eff = cum[:, :, -1:, :]
    cum_t = cum[:, :, :-1, :]                                 # [K, F, T, 3]
    par = parent[:, None, None, :]
    # dir 0 (missing left): right side accumulated from the top
    right0 = total_eff - cum_t
    left0 = par - right0
    # dir 1 (missing right): left side accumulated from the bottom
    left1 = cum_t
    right1 = par - left1
    left = torch.stack([left0, left1], dim=3)                 # [K, F, T, 2, 3]
    right = torch.stack([right0, right1], dim=3)

    Gl, Hl, Cl = left[..., 0], left[..., 1] + K_EPSILON, left[..., 2]
    Gr, Hr, Cr = right[..., 0], right[..., 1] + K_EPSILON, right[..., 2]
    gain = _split_gain(Gl, Hl, Gr, Hr, p)

    t_idx = torch.arange(B - 1, dtype=torch.int32, device=dev)[None, :, None]
    nb3, mt3 = nb[:, :, None], mt[:, :, None]
    um3 = use_missing[:, :, None]
    dir_idx = torch.arange(2, dtype=torch.int32, device=dev)[None, None, :]
    valid = (t_idx < nb3 - 1) & (dir_idx >= 0)                # [F, T, 2]
    # NaN bin cannot be a left-inclusive threshold when NaN defaults left
    valid &= ~(um3 & (mt3 == MISSING_NAN) & (dir_idx == 0)
               & (t_idx >= nb3 - 2))
    # zero-type: the skipped zero bin is not a candidate threshold
    valid &= ~(um3 & (mt3 == MISSING_ZERO)
               & (t_idx == zero_skip[:, :, None]))
    # second direction only for missing-capable features with > 2 bins
    valid &= ~((dir_idx == 1) & ~um3)
    valid = (valid[None]
             & (Cl >= p.min_data_in_leaf) & (Cr >= p.min_data_in_leaf)
             & (Hl >= p.min_sum_hessian_in_leaf)
             & (Hr >= p.min_sum_hessian_in_leaf))
    gain = torch.where(valid, gain, torch.full_like(gain, NEG_INF))
    return gain, left


def best_split(hist: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_c: torch.Tensor,
               fmeta: FeatureMeta, p: SplitParams) -> SplitInfo:
    """Best split of each of K leaves from their [K, F, B, 3] histograms
    and [K] parent sums (SerialTreeLearner::FindBestSplitsFromHistograms,
    serial_tree_learner.cpp:549-640): per-feature best threshold, then
    the per-leaf argmax over features."""
    K, F, B, _ = hist.shape
    parent = torch.stack([parent_g, parent_h, parent_c], dim=1).to(
        hist.dtype)                                           # [K, 3]
    gain_shift = leaf_gain(parent_g, parent_h + 2 * K_EPSILON,
                           p.lambda_l1, p.lambda_l2, p.max_delta_step)
    min_gain_shift = (gain_shift + p.min_gain_to_split)[:, None]

    num_gain, num_left = _numerical_candidates(hist, parent, fmeta, p)
    flat = num_gain.reshape(K, F, -1)
    ni = torch.argmax(flat, dim=2)                            # [K, F]
    ng = torch.gather(flat, 2, ni[..., None])[..., 0]
    fgain = torch.where(ng > min_gain_shift, ng - min_gain_shift,
                        torch.full_like(ng, NEG_INF))

    best_f = torch.argmax(fgain, dim=1)                       # [K]
    kk = torch.arange(K, device=hist.device)
    best_gain = fgain[kk, best_f]
    has_split = best_gain > NEG_INF
    n_flat = ni[kk, best_f]
    n_t = n_flat // 2
    n_dir = n_flat % 2
    left_stats = num_left[kk, best_f, n_t, n_dir]             # [K, 3]
    # default_left: dir 0 = missing left; the 2-bin NaN edge goes right
    nb_f = fmeta.num_bin[best_f]
    mt_f = fmeta.missing_type[best_f]
    dl = (n_dir == 0) & ~((nb_f <= 2) & (mt_f == MISSING_NAN))

    Gl, Hl, Cl = left_stats[:, 0], left_stats[:, 1], left_stats[:, 2]
    Gr, Hr, Cr = parent[:, 0] - Gl, parent[:, 1] - Hl, parent[:, 2] - Cl
    out_l = leaf_output(Gl, Hl, p.lambda_l1, p.lambda_l2, p.max_delta_step)
    out_r = leaf_output(Gr, Hr, p.lambda_l1, p.lambda_l2, p.max_delta_step)
    return SplitInfo(
        gain=torch.where(has_split, best_gain,
                         torch.full_like(best_gain, NEG_INF)),
        feature=torch.where(has_split, best_f, -1).to(torch.int32),
        threshold=n_t.to(torch.int32),
        default_left=dl,
        left_g=Gl, left_h=Hl, left_c=Cl,
        right_g=Gr, right_h=Hr, right_c=Cr,
        left_out=out_l, right_out=out_r,
    )
