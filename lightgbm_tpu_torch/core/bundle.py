"""Exclusive Feature Bundling (EFB): which features share a bin column.

Counterpart of lightgbm_tpu/core/bundle.py (find_groups :83, build_bundle
:141), after the reference's Dataset::FindGroups + FastFeatureBundling
(src/io/dataset.cpp:68-213): features that are almost never off their
default bin together are greedily grouped, so a wide sparse matrix costs a
few bin columns.  The port computes the same grouping from the same
binning sample.  Storing a group as one column, and expanding its
histogram back into per-feature histograms (the JAX package's
ops/split.expand_group_hist), are not ported: a dataset on which a
multi-feature group forms raises (core/dataset.py).  When none forms, the
bin matrix is the unbundled one, byte for byte.
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


def find_groups(packed: np.ndarray, nnz: np.ndarray, num_bins: np.ndarray,
                is_bundleable: np.ndarray, max_conflict_cnt: int
                ) -> List[List[int]]:
    """Greedy conflict-bounded grouping (Dataset::FindGroups,
    src/io/dataset.cpp:68-138).  ``packed`` [F, ceil(S/8)] uint8 holds
    each feature's non-default mask on the sample (np.packbits), ``nnz``
    its non-default count; only ``is_bundleable`` features enter a group,
    the others stay alone.  A feature joins the first group whose bins
    and conflicting sample rows stay within bounds.  Returns the groups as
    lists of feature indices: multi-feature groups first, then the
    singletons in feature order."""
    F = packed.shape[0]
    cand = [f for f in range(F) if is_bundleable[f]]
    # by descending non-zero count (dataset.cpp:168-176)
    cand.sort(key=lambda f: -int(nnz[f]))
    feats: List[List[int]] = []
    masks: List[np.ndarray] = []
    bins: List[int] = []
    conflicts: List[int] = []
    for f in cand:
        for g in range(len(feats)):
            if bins[g] + int(num_bins[f]) > MAX_BINS_PER_GROUP:
                continue
            c = int(_POPCOUNT8[packed[f] & masks[g]].sum())
            if conflicts[g] + c > max_conflict_cnt:
                continue
            feats[g].append(f)
            masks[g] |= packed[f]
            bins[g] += int(num_bins[f])
            conflicts[g] += c
            break
        else:
            feats.append([f])
            masks.append(packed[f].copy())
            bins.append(1 + int(num_bins[f]))    # +1: the all-default slot
            conflicts.append(0)
    groups = [g for g in feats if len(g) > 1]
    single = sorted(f for g in feats if len(g) == 1 for f in g)
    rest = [f for f in range(F) if not is_bundleable[f]]
    groups.extend([f] for f in sorted(single + rest))
    return groups


def build_bundle(sample_nonzero_fn: Callable[[int], np.ndarray],
                 num_features: int, sample_cnt: int, num_bins: np.ndarray,
                 sparse_rates: np.ndarray, sparse_threshold: float,
                 max_conflict_rate: float) -> Optional[List[List[int]]]:
    """The grouping of a dataset from its binning sample
    (lightgbm_tpu/core/bundle.py:build_bundle): ``sample_nonzero_fn(f)``
    is used feature f's [S] non-default mask on the sample; a feature
    whose share of default-bin values is at least ``sparse_threshold`` may
    join a group.  Returns the groups, or None when every group would hold
    one feature (the layout does not change)."""
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
    return None if len(groups) == F else groups
