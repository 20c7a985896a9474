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

Categorical features (feature_histogram.hpp:118-300) get two candidate
families: one-hot (one category alone goes left) for features of at most
``max_cat_to_onehot`` bins, and otherwise the sorted-subset scan (bins
ordered by gradient/(hessian + cat_smooth), a prefix or a suffix of the
order goes left, with ``cat_l2``).  The winner's left-going bins leave as
a 256-bit bitset of 8 words.  The categorical scans run only when the
dataset has a categorical feature (``SplitParams.has_cat``), so a numeric
dataset's split search has no extra device ops.

Under EFB (core/bundle.py) the kernels histogram bin columns, [K, G, Bg,
3]; ``expand_group_hist`` turns that into the per-feature [K, F, Bf, 3]
the scan reads.  Every function takes a batch of K leaves: hist
``[K, F, B, 3]``.

The split features (lightgbm_tpu/ops/split.py:158-166, :359, :382,
:398-420): each leaf's monotone bounds ``[mono_lo, mono_hi]`` clamp every
candidate's two outputs, and a numerical candidate whose outputs break
its feature's constraint gets the gain 0.0 (not -inf: it still loses to
``min_gain_shift``); categorical candidates are clamped but keep no
direction.  A feature's ``penalty`` (feature_contri) multiplies its gain
over ``min_gain_shift``, and ``gain_adjust`` ([K, F], CEGB's costs) is
subtracted from it before the argmax.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

K_EPSILON = 1e-15
NEG_INF = float("-inf")


class FeatureMeta(NamedTuple):
    """Per-used-feature metadata as tensors [F] on the device: int32, and
    bool ``is_cat`` (None on a dataset without categorical features).
    Under EFB, each feature's bin column ``feat_group`` and bin offset
    ``feat_offset`` [F] int32, and ``gather_idx`` [F, Bf] int64, the slot
    of the flattened [G * Bg] group histogram that holds each of the
    feature's bins (-1: past its bins); all three None on an unbundled
    dataset, where column = feature (lightgbm_tpu/ops/split.py:50-56)."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    default_bin: torch.Tensor
    is_cat: torch.Tensor = None
    feat_group: torch.Tensor = None
    feat_offset: torch.Tensor = None
    gather_idx: torch.Tensor = None
    # the split features (lightgbm_tpu/ops/split.py:41-49), each None when
    # unused: ``monotone`` int32 (-1, 0, +1), ``penalty`` float32
    # (feature_contri); CEGB's per-feature costs ``cegb_coupled`` and
    # ``cegb_lazy`` float32, and ``cegb_used0`` float32 0/1, the features
    # the model's earlier trees split on (the coupled cost is waived)
    monotone: torch.Tensor = None
    penalty: torch.Tensor = None
    cegb_coupled: torch.Tensor = None
    cegb_lazy: torch.Tensor = None
    cegb_used0: torch.Tensor = None


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # the dataset has a categorical feature: run the categorical scans
    has_cat: bool = False


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
    # categorical winners: is_cat [K] bool and the left-going bins as
    # cat_bitset [K, 8] int64 words of 32 bits; None unless has_cat
    is_cat: torch.Tensor = None
    cat_bitset: torch.Tensor = None


def expand_group_hist(hist: torch.Tensor, fmeta: FeatureMeta, parent_g,
                      parent_h, parent_c) -> torch.Tensor:
    """[K, G, Bg, 3] group histograms -> [K, F, Bf, 3] per-feature ones
    (lightgbm_tpu/ops/split.py:expand_group_hist :97-121); the identity on
    an unbundled dataset.  Each feature's slots are gathered out of its
    column, and its default-bin slot, which bundling never stores, becomes
    the leaf's total minus the stored slots (the reference's FixHistogram,
    src/io/dataset.cpp:948-967).  As in the JAX package the fix applies to
    every feature of a bundled dataset, a single-feature column's too,
    where it replaces the summed slot by that difference.  ``parent_*``
    are the K leaves' sums."""
    if fmeta.gather_idx is None:
        return hist
    gi = fmeta.gather_idx                                     # [F, Bf]
    K = hist.shape[0]
    flat = hist.reshape(K, -1, hist.shape[-1])                # [K, G*Bg, 3]
    fh = flat[:, gi.clamp(min=0)] * (gi >= 0)[None, ..., None].to(
        hist.dtype)                                           # [K, F, Bf, 3]
    total = torch.stack([parent_g, parent_h, parent_c], dim=1).to(
        hist.dtype)                                           # [K, 3]
    Bf = fh.shape[2]
    db = (torch.arange(Bf, dtype=torch.int32, device=hist.device)[None, :]
          == fmeta.default_bin[:, None])                      # [F, Bf]
    stored = torch.sum(fh * (~db)[None, ..., None].to(hist.dtype), dim=2)
    fix = total[:, None, :] - stored                          # [K, F, 3]
    return torch.where(db[None, ..., None], fix[:, :, None, :], fh)


def reconstruct_feature_column(gcol: torch.Tensor, f: int,
                               fmeta: FeatureMeta) -> torch.Tensor:
    """Per-row bin of feature ``f`` from its column ``gcol`` (the inverse
    of core/bundle.quantize_bundled for one feature,
    lightgbm_tpu/ops/split.py:124-133): a value in the feature's range
    ``[offset, offset + num_bin)`` is ``offset + bin``, any other is the
    feature at its default bin.  A feature of offset 0 owns its column,
    whose values are its bins."""
    g = gcol.to(torch.int32)
    if fmeta.feat_offset is None or int(fmeta.feat_offset[f]) == 0:
        return g
    off, nb = int(fmeta.feat_offset[f]), int(fmeta.num_bin[f])
    return torch.where((g >= off) & (g < off + nb), g - off,
                       torch.full_like(g, int(fmeta.default_bin[f])))


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


def clip_output(out, lo, hi):
    """``out`` clamped to the leaves' monotone bounds ``[lo, hi]``
    (jnp.clip's minimum of a maximum); the identity when ``lo`` is None."""
    if lo is None:
        return out
    return torch.minimum(torch.maximum(out, lo), hi)


def _bounds(lo, hi, ndim: int):
    """[K] bounds shaped to broadcast over a [K, ...] candidate tensor of
    ``ndim`` dimensions (None stays None)."""
    if lo is None:
        return None, None
    shape = (-1,) + (1,) * (ndim - 1)
    return lo.reshape(shape), hi.reshape(shape)


def _split_gain(Gl, Hl, Gr, Hr, p: SplitParams, extra_l2: float = 0.0,
                mono=None, lo=None, hi=None):
    """Both children's gain; with bounds each output is clamped first,
    and with ``mono`` a candidate whose outputs break the constraint has
    gain 0.0 (lightgbm_tpu/ops/split.py:_split_gain :158-166)."""
    l2 = p.lambda_l2 + extra_l2
    out_l = clip_output(leaf_output(Gl, Hl, p.lambda_l1, l2,
                                    p.max_delta_step), lo, hi)
    out_r = clip_output(leaf_output(Gr, Hr, p.lambda_l1, l2,
                                    p.max_delta_step), lo, hi)
    gain = (leaf_gain_given_output(Gl, Hl, p.lambda_l1, l2, out_l)
            + leaf_gain_given_output(Gr, Hr, p.lambda_l1, l2, out_r))
    if mono is None:
        return gain
    bad = ((mono > 0) & (out_l > out_r)) | ((mono < 0) & (out_l < out_r))
    return torch.where(bad, torch.zeros_like(gain), gain)


def _numerical_candidates(hist, parent, fmeta: FeatureMeta,
                          p: SplitParams, lo=None, hi=None):
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
    mono = (None if fmeta.monotone is None
            else fmeta.monotone[None, :, None, None])
    gain = _split_gain(Gl, Hl, Gr, Hr, p, 0.0, mono, *_bounds(lo, hi, 4))

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
    if p.has_cat:
        valid &= ~fmeta.is_cat[:, None, None]
    valid = (valid[None]
             & (Cl >= p.min_data_in_leaf) & (Cr >= p.min_data_in_leaf)
             & (Hl >= p.min_sum_hessian_in_leaf)
             & (Hr >= p.min_sum_hessian_in_leaf))
    gain = torch.where(valid, gain, torch.full_like(gain, NEG_INF))
    return gain, left


def _cat_used_bin_mask(B: int, fmeta: FeatureMeta):
    """[F, B] bins a categorical scan may use: in range, and not the
    trailing NaN bin (used_bin = num_bin - 1 + is_full_categorical,
    feature_histogram.hpp:130-131), and below 256: the split's bitset has
    8 words (build_cat_bitset), so a categorical of more bins keeps the
    rest on the right, in the sums as in the routing."""
    b_idx = torch.arange(B, dtype=torch.int32,
                         device=fmeta.num_bin.device)[None, :]
    nb = fmeta.num_bin[:, None]
    used = torch.where(fmeta.missing_type[:, None] == MISSING_NAN, nb - 1,
                       nb)
    return (b_idx < used) & (b_idx < 32 * 8)


def _categorical_onehot_candidates(hist, parent, fmeta: FeatureMeta,
                                   p: SplitParams, used_mask, lo=None,
                                   hi=None):
    """One-hot candidates: bin b alone goes left (feature_histogram.hpp:
    139-170, plain lambda_l2).  Returns (gain [K, F, B], left = hist)."""
    left = hist
    right = parent[:, None, None, :] - left
    Gl, Hl, Cl = left[..., 0], left[..., 1] + K_EPSILON, left[..., 2]
    Gr, Hr, Cr = right[..., 0], right[..., 1] + K_EPSILON, right[..., 2]
    gain = _split_gain(Gr, Hr, Gl, Hl, p, 0.0, None, *_bounds(lo, hi, 3))
    valid = ((fmeta.is_cat[:, None] & used_mask)[None]
             & (Cl >= p.min_data_in_leaf) & (Cr >= p.min_data_in_leaf)
             & (Hl >= p.min_sum_hessian_in_leaf)
             & (Hr >= p.min_sum_hessian_in_leaf))
    return torch.where(valid, gain, torch.full_like(gain, NEG_INF)), left


def _categorical_sorted_candidates(hist, parent, fmeta: FeatureMeta,
                                   p: SplitParams, used_mask, lo=None,
                                   hi=None):
    """Sorted-subset scan (feature_histogram.hpp:118-300): bins with at
    least cat_smooth rows ordered by G/(H + cat_smooth); a prefix (d=0)
    or a suffix (d=1) of the order goes left, cat_l2 added to lambda_l2.

    Returns (gain [K, F, B, 2], left [K, F, B, 2, 3], order [K, F, B]):
    candidate (k, f, j, d) sends order positions <= j (d=0) or >= j (d=1)
    left."""
    K, F, B, _ = hist.shape
    dev = hist.device
    cnt = hist[..., 2]
    usable = used_mask[None] & (cnt >= p.cat_smooth)
    ratio = hist[..., 0] / (hist[..., 1] + p.cat_smooth)
    ratio = torch.where(usable, ratio, torch.full_like(ratio, float("inf")))
    order = torch.argsort(ratio, dim=2, stable=True)          # [K, F, B]
    sorted_hist = torch.take_along_dim(hist, order[..., None], dim=2)
    sorted_valid = torch.take_along_dim(usable, order, dim=2)
    sorted_hist = sorted_hist * sorted_valid[..., None].to(hist.dtype)
    pre = torch.cumsum(sorted_hist, dim=2)
    # A suffix going left is built from its right side: the positions
    # before it plus the unusable bins.  Where those bins hold no rows the
    # suffix from j and the prefix up to j - 1 are one partition, mirrored,
    # and this makes their gains equal bit for bit, so the argmax keeps
    # the prefix on every device; a suffix summed on its own would tie
    # only up to rounding, and the device's cumsum order would pick.
    excl = torch.cat([torch.zeros_like(pre[:, :, :1]), pre[:, :, :-1]],
                     dim=2)
    unusable = (hist * (~usable)[..., None].to(hist.dtype)).sum(
        dim=2, keepdim=True)
    parent_b = parent[:, None, None, :]
    right_suf = excl + unusable
    left = torch.stack([pre, parent_b - right_suf], dim=3)    # [K, F, B, 2, 3]
    right = torch.stack([parent_b - pre, right_suf], dim=3)
    Gl, Hl, Cl = left[..., 0], left[..., 1] + K_EPSILON, left[..., 2]
    Gr, Hr, Cr = right[..., 0], right[..., 1] + K_EPSILON, right[..., 2]
    # categorical splits ignore monotone constraints (GetSplitGains with
    # monotone_type 0, feature_histogram.hpp:226), but are clamped
    gain = _split_gain(Gl, Hl, Gr, Hr, p, p.cat_l2, None,
                       *_bounds(lo, hi, 4))

    num_valid = sorted_valid.sum(dim=2)[:, :, None, None]      # [K, F, 1, 1]
    j_idx = torch.arange(B, device=dev)[None, None, :, None]
    d_idx = torch.arange(2, device=dev)[None, None, None, :]
    left_size = torch.where(d_idx == 0, j_idx + 1, num_valid - j_idx)
    # at most min(max_cat_threshold, (used + 1) / 2) categories move
    # (feature_histogram.hpp:192); the unmoved side keeps at least
    # min_data_per_group rows (:216)
    max_num_cat = torch.clamp((num_valid + 1) // 2,
                              max=int(p.max_cat_threshold))
    valid = (fmeta.is_cat[None, :, None, None] & sorted_valid[..., None]
             & (left_size >= 1) & (Cl > 0) & (Cr > 0)
             & (left_size <= max_num_cat)
             & (Cl >= p.min_data_in_leaf) & (Cr >= p.min_data_in_leaf)
             & (Cr >= float(p.min_data_per_group))
             & (Hl >= p.min_sum_hessian_in_leaf)
             & (Hr >= p.min_sum_hessian_in_leaf))
    gain = torch.where(valid, gain, torch.full_like(gain, NEG_INF))
    return gain, left, order


def build_cat_bitset(mask: torch.Tensor) -> torch.Tensor:
    """[K, B] bool -> [K, 8] int64 words of 32 bits each (bins below 256;
    the scans offer no other to the left set)."""
    K, B = mask.shape
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, (-B) % 32))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, dtype=torch.int64, device=mask.device))
    words = (m.reshape(K, -1, 32) * weights).sum(dim=2)
    out = torch.zeros((K, 8), dtype=torch.int64, device=mask.device)
    out[:, :words.shape[1]] = words[:, :8]
    return out


def best_split(hist: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_c: torch.Tensor,
               fmeta: FeatureMeta, p: SplitParams,
               feature_mask: Optional[torch.Tensor] = None,
               mono_lo: Optional[torch.Tensor] = None,
               mono_hi: Optional[torch.Tensor] = None,
               gain_adjust: Optional[torch.Tensor] = None) -> SplitInfo:
    """Best split of each of K leaves from their [K, F, B, 3] histograms
    and [K] parent sums (SerialTreeLearner::FindBestSplitsFromHistograms,
    serial_tree_learner.cpp:549-640): per-feature best candidate of each
    family (numerical; with has_cat also one-hot and sorted-subset), then
    the per-leaf argmax over features.  ``feature_mask`` ([K, F] or [1,
    F], nonzero = usable; feature fraction by tree and by node) gives a
    masked feature the gain -inf before that argmax
    (lightgbm_tpu/ops/split.py:420).  ``mono_lo``/``mono_hi`` ([K], both
    or neither) are the leaves' monotone output bounds, and
    ``gain_adjust`` ([K, F]) a cost subtracted from each usable feature's
    gain (CEGB; :421-423)."""
    K, F, B, _ = hist.shape
    kk = torch.arange(K, device=hist.device)
    parent = torch.stack([parent_g, parent_h, parent_c], dim=1).to(
        hist.dtype)                                           # [K, 3]
    gain_shift = leaf_gain(parent_g, parent_h + 2 * K_EPSILON,
                           p.lambda_l1, p.lambda_l2, p.max_delta_step)
    min_gain_shift = (gain_shift + p.min_gain_to_split)[:, None]

    num_gain, num_left = _numerical_candidates(hist, parent, fmeta, p,
                                               mono_lo, mono_hi)
    flat = num_gain.reshape(K, F, -1)
    ni = torch.argmax(flat, dim=2)                            # [K, F]
    ng = torch.gather(flat, 2, ni[..., None])[..., 0]
    if p.has_cat:
        used_mask = _cat_used_bin_mask(B, fmeta)              # [F, B]
        oh_gain, oh_left = _categorical_onehot_candidates(
            hist, parent, fmeta, p, used_mask, mono_lo, mono_hi)
        so_gain, so_left, so_order = _categorical_sorted_candidates(
            hist, parent, fmeta, p, used_mask, mono_lo, mono_hi)
        use_onehot = (fmeta.num_bin <= int(p.max_cat_to_onehot))[None, :,
                                                                 None]
        oh_gain = torch.where(use_onehot, oh_gain,
                              torch.full_like(oh_gain, NEG_INF))
        so_gain = torch.where(use_onehot[..., None],
                              torch.full_like(so_gain, NEG_INF), so_gain)
        oi = torch.argmax(oh_gain, dim=2)                     # [K, F]
        og = torch.gather(oh_gain, 2, oi[..., None])[..., 0]
        so_flat = so_gain.reshape(K, F, -1)
        si = torch.argmax(so_flat, dim=2)
        sg = torch.gather(so_flat, 2, si[..., None])[..., 0]
        fam_gains = torch.stack([ng, og, sg], dim=2)          # [K, F, 3]
        fam = torch.argmax(fam_gains, dim=2)
        ng = torch.amax(fam_gains, dim=2)
    over = ng - min_gain_shift
    if fmeta.penalty is not None:
        over = over * fmeta.penalty[None, :]
    fgain = torch.where(ng > min_gain_shift, over,
                        torch.full_like(ng, NEG_INF))
    if feature_mask is not None:
        fgain = torch.where(feature_mask > 0, fgain,
                            torch.full_like(fgain, NEG_INF))
    if gain_adjust is not None:
        fgain = torch.where(fgain > NEG_INF, fgain - gain_adjust,
                            torch.full_like(fgain, NEG_INF))

    best_f = torch.argmax(fgain, dim=1)                       # [K]
    best_gain = fgain[kk, best_f]
    has_split = best_gain > NEG_INF
    n_flat = ni[kk, best_f]
    n_t = n_flat // 2
    n_dir = n_flat % 2
    left_stats = num_left[kk, best_f, n_t, n_dir]             # [K, 3]
    threshold = n_t
    # default_left: dir 0 = missing left; the 2-bin NaN edge goes right
    nb_f = fmeta.num_bin[best_f]
    mt_f = fmeta.missing_type[best_f]
    dl = (n_dir == 0) & ~((nb_f <= 2) & (mt_f == MISSING_NAN))
    l2 = p.lambda_l2
    is_cat = cat_bitset = None
    if p.has_cat:
        fam_f = fam[kk, best_f]
        oi_f = oi[kk, best_f]
        s_flat = si[kk, best_f]
        s_k, s_dir = s_flat // 2, s_flat % 2
        left_oh = oh_left[kk, best_f, oi_f]
        left_so = so_left[kk, best_f, s_k, s_dir]
        left_stats = torch.where(
            (fam_f == 0)[:, None], left_stats,
            torch.where((fam_f == 1)[:, None], left_oh, left_so))
        threshold = torch.where(fam_f == 0, n_t,
                                torch.where(fam_f == 1, oi_f, s_k))
        is_cat = fam_f > 0
        dl = dl & ~is_cat
        # left-going bins: the one-hot bin, or the chosen run of the order
        pos = torch.arange(B, device=hist.device)[None, :]
        valid_bins = (used_mask[best_f]
                      & (hist[kk, best_f, :, 2] >= p.cat_smooth))  # [K, B]
        nvalid = valid_bins.sum(dim=1, keepdim=True)
        sel_sorted = torch.where((s_dir == 0)[:, None], pos <= s_k[:, None],
                                 (pos >= s_k[:, None]) & (pos < nvalid))
        sorted_mask = torch.zeros((K, B), dtype=torch.bool,
                                  device=hist.device).scatter(
            1, so_order[kk, best_f], sel_sorted)
        cat_mask = torch.where((fam_f == 1)[:, None], pos == oi_f[:, None],
                               sorted_mask & valid_bins)
        cat_bitset = build_cat_bitset(cat_mask & is_cat[:, None])
        # cat_l2 applies to the sorted-subset family only
        l2 = torch.where(fam_f == 2, p.lambda_l2 + p.cat_l2,
                         p.lambda_l2).to(hist.dtype)

    Gl, Hl, Cl = left_stats[:, 0], left_stats[:, 1], left_stats[:, 2]
    Gr, Hr, Cr = parent[:, 0] - Gl, parent[:, 1] - Hl, parent[:, 2] - Cl
    # the same clamp as the candidates' (max_delta_step inside, then the
    # bounds)
    out_l = clip_output(leaf_output(Gl, Hl, p.lambda_l1, l2,
                                    p.max_delta_step), mono_lo, mono_hi)
    out_r = clip_output(leaf_output(Gr, Hr, p.lambda_l1, l2,
                                    p.max_delta_step), mono_lo, mono_hi)
    return SplitInfo(
        gain=torch.where(has_split, best_gain,
                         torch.full_like(best_gain, NEG_INF)),
        feature=torch.where(has_split, best_f, -1).to(torch.int32),
        threshold=threshold.to(torch.int32),
        default_left=dl,
        left_g=Gl, left_h=Hl, left_c=Cl,
        right_g=Gr, right_h=Hr, right_c=Cr,
        left_out=out_l, right_out=out_r,
        is_cat=is_cat, cat_bitset=cat_bitset,
    )
