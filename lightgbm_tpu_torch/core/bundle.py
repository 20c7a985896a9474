"""Exclusive Feature Bundling (EFB): which features share a bin column,
and how a group's column is written.

Counterpart of lightgbm_tpu/core/bundle.py (BundleSpec :46, find_groups
:83, build_bundle :141, quantize_bundled :184), after the reference's
Dataset::FindGroups + FastFeatureBundling (src/io/dataset.cpp:68-213):
features that are almost never off their default bin together are
greedily grouped, so a wide sparse matrix costs a few bin columns.  The
encoding is the JAX package's:

  * every multi-feature group is ONE column of the bin matrix;
  * column value 0 means every member feature is at its default bin;
  * member ``f`` with bin ``b != default_bin[f]`` stores
    ``feat_offset[f] + b`` (offsets accumulate ``1 + sum(num_bin)``, so
    the members' ranges never overlap and a member's default slot is
    never written);
  * two members off their default on one row (a conflict, bounded by
    ``max_conflict_rate``) keep the LAST member's value;
  * a single-feature group is the plain column (offset 0).

The scan turns a group histogram back into per-feature histograms with
ops/split.expand_group_hist; the routes and walks read a feature out of
its column as ``offset + bin`` when its offset is not 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

# 8-bit popcount table for packed conflict counting
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)],
                      dtype=np.int32)

# a group's bins (its features' bins plus the shared all-default slot)
# stay within one byte
MAX_BINS_PER_GROUP = 256

# groups whose conflicts find_groups counts in one numpy call
_GROUP_CHUNK = 32


class BundleSpec:
    """The feature -> column packing: ``groups`` (lists of used-feature
    indices), each feature's column ``feat_group`` and bin offset
    ``feat_offset`` [F], and each column's bins ``group_num_bin`` [G]."""

    __slots__ = ("groups", "feat_group", "feat_offset", "group_num_bin")

    def __init__(self, groups: List[List[int]], num_bins: np.ndarray):
        self.groups = [[int(f) for f in g] for g in groups]
        F = int(sum(len(g) for g in groups))
        self.feat_group = np.zeros(F, dtype=np.int32)
        self.feat_offset = np.zeros(F, dtype=np.int32)
        self.group_num_bin = np.zeros(len(groups), dtype=np.int32)
        for gi, g in enumerate(self.groups):
            if len(g) == 1:
                self.feat_group[g[0]] = gi
                self.group_num_bin[gi] = int(num_bins[g[0]])
                continue
            off = 1                               # slot 0 = all-default
            for f in g:
                self.feat_group[f] = gi
                self.feat_offset[f] = off
                off += int(num_bins[f])
            self.group_num_bin[gi] = off

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def to_dict(self) -> dict:
        return {"groups": self.groups}

    @classmethod
    def from_dict(cls, d: dict, num_bins: np.ndarray) -> "BundleSpec":
        return cls(d["groups"], num_bins)


def find_groups(packed: np.ndarray, nnz: np.ndarray, num_bins: np.ndarray,
                is_bundleable: np.ndarray, max_conflict_cnt: int
                ) -> List[List[int]]:
    """Greedy conflict-bounded grouping (Dataset::FindGroups,
    src/io/dataset.cpp:68-138).  ``packed`` [F, ceil(S/8)] uint8 holds
    each feature's non-default mask on the sample (np.packbits), ``nnz``
    its non-default count; only ``is_bundleable`` features enter a group,
    the others stay alone.  In order of descending ``nnz``, a feature
    joins the first group whose bins and conflicting sample rows stay
    within bounds, else opens a group.  Returns the groups as lists of
    feature indices: multi-feature groups first, then the singletons in
    feature order (the JAX package's find_groups, result for result; the
    first fitting group is found by counting conflicts against a chunk of
    the fitting groups at once)."""
    F, W = packed.shape
    cand = [f for f in range(F) if is_bundleable[f]]
    # by descending non-zero count (dataset.cpp:168-176)
    cand.sort(key=lambda f: -int(nnz[f]))
    feats: List[List[int]] = []
    # the groups' masks, bins and conflicts, grown by doubling
    masks = np.zeros((64, W), dtype=np.uint8)
    bins = np.zeros(64, dtype=np.int64)
    conflicts = np.zeros(64, dtype=np.int64)
    for f in cand:
        nb = int(num_bins[f])
        fits = np.flatnonzero(bins[:len(feats)] + nb <= MAX_BINS_PER_GROUP)
        # conflicts can only be in the bytes where f has a sample row
        at_f = np.flatnonzero(packed[f])
        pf = packed[f, at_f]
        placed = -1
        for at in range(0, len(fits), _GROUP_CHUNK):
            gs = fits[at:at + _GROUP_CHUNK]
            c = _POPCOUNT8[masks[gs[:, None], at_f] & pf].sum(axis=1)
            ok = np.flatnonzero(conflicts[gs] + c <= max_conflict_cnt)
            if len(ok):
                placed = int(gs[ok[0]])
                conflicts[placed] += int(c[ok[0]])
                break
        if placed < 0:
            placed = len(feats)
            if placed == len(bins):
                masks = np.concatenate([masks, np.zeros_like(masks)])
                bins = np.concatenate([bins, np.zeros_like(bins)])
                conflicts = np.concatenate([conflicts,
                                            np.zeros_like(conflicts)])
            feats.append([])
            bins[placed] = 1                     # the all-default slot
        feats[placed].append(f)
        masks[placed] |= packed[f]
        bins[placed] += nb
    groups = [g for g in feats if len(g) > 1]
    single = sorted(f for g in feats if len(g) == 1 for f in g)
    rest = [f for f in range(F) if not is_bundleable[f]]
    groups.extend([f] for f in sorted(single + rest))
    return groups


def build_bundle(sample_nonzero_fn: Callable[[int], np.ndarray],
                 num_features: int, sample_cnt: int, num_bins: np.ndarray,
                 sparse_rates: np.ndarray, sparse_threshold: float,
                 max_conflict_rate: float) -> Optional[BundleSpec]:
    """The packing of a dataset from its binning sample
    (lightgbm_tpu/core/bundle.py:build_bundle): ``sample_nonzero_fn(f)``
    is used feature f's [S] non-default mask on the sample; a feature
    whose share of default-bin values is at least ``sparse_threshold`` may
    join a group.  Returns None when every group would hold one feature
    (the layout does not change)."""
    F, S = num_features, sample_cnt
    if F <= 1 or S <= 0:
        return None
    is_bundleable = np.asarray(sparse_rates) >= sparse_threshold
    if int(is_bundleable.sum()) <= 1:
        return None
    packed = np.zeros((F, (S + 7) // 8), dtype=np.uint8)
    nnz = np.zeros(F, dtype=np.int64)
    for f in np.flatnonzero(is_bundleable):
        mask = np.asarray(sample_nonzero_fn(int(f)), dtype=bool)
        packed[f] = np.packbits(mask)
        nnz[f] = int(mask.sum())
    groups = find_groups(packed, nnz, num_bins, is_bundleable,
                         int(max_conflict_rate * S))
    if len(groups) == F:
        return None
    return BundleSpec(groups, num_bins)


def bundle_dtype(spec: BundleSpec):
    """uint8 while every column's bins fit a byte (always, under
    MAX_BINS_PER_GROUP), as lightgbm_tpu/core/bundle.py:bundle_dtype."""
    return (np.uint8 if int(spec.group_num_bin.max(initial=1)) <= 256
            else np.uint16)


def quantize_bundled(member_bins: Callable[[int], tuple], spec: BundleSpec,
                     default_bins: np.ndarray, num_rows: int,
                     workers: Optional[Callable] = None) -> np.ndarray:
    """The feature-major bundled [G, N] matrix (the transpose of the JAX
    package's quantize_bundled, byte for byte).  ``member_bins(f)``
    returns ``(rows, bins)`` of used feature ``f``: the rows it gives a
    bin (None = every row, in order) and their bins; the rows it does not
    give are at the feature's default bin.  A multi-feature column starts
    at 0 and each member, in member order, writes ``offset + bin`` at its
    non-default rows only, so a conflict keeps the last member, as the
    JAX loop over full columns does.  ``workers(fn, items)`` maps ``fn``
    over the columns (default: a loop); each column is written by one
    call."""
    dtype = bundle_dtype(spec)
    out = np.empty((spec.num_groups, num_rows), dtype=dtype)

    def column(gi):
        g = spec.groups[gi]
        col = out[gi]
        if len(g) == 1:
            rows, b = member_bins(g[0])
            if rows is None:
                col[:] = b
            else:
                col.fill(int(default_bins[g[0]]))
                col[rows] = b
            return
        col.fill(0)
        for f in g:
            rows, b = member_bins(f)
            nz = b != default_bins[f]
            hit = np.flatnonzero(nz) if rows is None else rows[nz]
            col[hit] = (int(spec.feat_offset[f]) + b[nz]).astype(dtype)

    if workers is None:
        for gi in range(spec.num_groups):
            column(gi)
    else:
        workers(column, range(spec.num_groups))
    return out
