"""Feature quantization: value -> integer bin mapping.

Reimplements the reference's BinMapper (include/LightGBM/bin.h:78-246,
src/io/bin.cpp:25-410) in numpy: greedy equal-ish-frequency bin-bound
finding (``GreedyFindBin`` bin.cpp:74), the zero-aware split of the value
range (``FindBinWithZeroAsOneBin`` bin.cpp:152) and missing handling
(None/Zero/NaN) for numerical features; for categorical ones, bins by
descending category count with a 99% mass cutoff (bin.cpp:310-375), where
negative values, NaN and unseen categories share the last bin.  Bin
assignment (``ValueToBin`` bin.h:496-549) is one ``np.searchsorted`` per
column.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..utils.log import check, log_warning

K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


def _next_after_up(a: float) -> float:
    """std::nextafter(a, +inf) (reference Common::GetDoubleUpperBound)."""
    return math.nextafter(a, math.inf)


def _double_equal_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) for ordered a<=b (Common::CheckDoubleEqualOrdered)."""
    return b <= _next_after_up(a)


# greedy_find_bin walks at most this many distinct values in Python
_SEQUENTIAL_DISTINCT = 256


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy equal-frequency-ish bin upper bounds (bin.cpp:74-150)."""
    check(max_bin > 0, "max_bin must be positive")
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                val = _next_after_up(
                    (distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _double_equal_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur_cnt = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    # values with huge counts get their own bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    if num_distinct <= _SEQUENTIAL_DISTINCT:
        # few values: the reference's walk itself, on Python lists, costs
        # less than the numpy calls of the search below (wide sparse data
        # bins one short column a feature)
        vals = distinct_values.tolist()
        cnts = counts.tolist()
        big = is_big.tolist()
        cur_cnt = 0
        for i in range(num_distinct - 1):
            if not big[i]:
                rest_sample_cnt -= cnts[i]
            cur_cnt += cnts[i]
            if (big[i] or cur_cnt >= mean_bin_size
                    or (big[i + 1]
                        and cur_cnt >= max(1.0, mean_bin_size * 0.5))):
                upper_bounds[bin_cnt] = float(vals[i])
                bin_cnt += 1
                lower_bounds[bin_cnt] = float(vals[i + 1])
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt = 0
                if not big[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        return _bounds_of(upper_bounds, lower_bounds, bin_cnt + 1)
    # The reference walks the distinct values one by one, cutting a bin
    # at value i when i is big, when the bin's count reaches
    # mean_bin_size, or when value i + 1 is big and the count reaches half
    # of it.  Between two cuts mean_bin_size is fixed and the count is an
    # integer prefix sum, so each next cut is found by searchsorted on the
    # prefix sums (count >= x <=> count >= ceil(x)) and a next-big table:
    # the same cuts, without a Python step a value.
    csum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    rest_csum = np.concatenate(
        [[0], np.cumsum(np.where(is_big, 0, counts), dtype=np.int64)])
    big_at = np.nonzero(is_big)[0]
    last = num_distinct - 2          # the loop's last value

    def next_big(k):
        """The first big value at index >= k (num_distinct if none)."""
        p = np.searchsorted(big_at, k, side="left")
        return int(big_at[p]) if p < len(big_at) else num_distinct

    start = 0
    while start <= last:
        base = int(csum[start])
        cut_full = int(np.searchsorted(
            csum, base + math.ceil(mean_bin_size), side="left")) - 1
        half = int(np.searchsorted(
            csum, base + math.ceil(max(1.0, mean_bin_size * 0.5)),
            side="left")) - 1
        i = min(next_big(start), max(cut_full, start),
                next_big(max(half, start) + 1) - 1)
        if i > last:
            break
        rest_sample_cnt -= int(rest_csum[i + 1] - rest_csum[start])
        upper_bounds[bin_cnt] = float(distinct_values[i])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[i + 1])
        if bin_cnt >= max_bin - 1:
            break
        if not is_big[i]:
            rest_bin_cnt -= 1
            mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        start = i + 1
    return _bounds_of(upper_bounds, lower_bounds, bin_cnt + 1)


def _bounds_of(upper_bounds, lower_bounds, bin_cnt: int) -> List[float]:
    """The bins' upper bounds from the greedy cuts (bin.cpp:140-150)."""
    bounds: List[float] = []
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bounds or not _double_equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                  counts: np.ndarray, max_bin: int,
                                  total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Split the range at zero so one bin holds exactly zero (bin.cpp:152-208)."""
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[left_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())
    cnt_zero = int(total_sample_cnt) - left_cnt_data - right_cnt_data

    nz = np.nonzero(distinct_values > -K_ZERO_THRESHOLD)[0]
    left_cnt = int(nz[0]) if len(nz) else len(distinct_values)

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -K_ZERO_THRESHOLD

    nz = np.nonzero(distinct_values[left_cnt:] > K_ZERO_THRESHOLD)[0]
    right_start = left_cnt + int(nz[0]) if len(nz) else -1

    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(distinct_values[right_start:],
                                       counts[right_start:], right_max_bin,
                                       right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(math.inf)
    check(len(bounds) <= max_bin, "bin bound count exceeds max_bin")
    return bounds


def _distinct_with_zero(values_sorted: np.ndarray, zero_cnt: int):
    """Distinct values/counts from a sorted sample, zero block spliced in at
    its ordered position (bin.cpp:236-270).  Adjacent float-equal values
    merge, keeping the larger value; a new group starts wherever the next
    value exceeds nextafter(previous)."""
    n = len(values_sorted)
    if n == 0:
        return (np.asarray([0.0]), np.asarray([zero_cnt], dtype=np.int64))
    v = np.asarray(values_sorted, dtype=np.float64)
    boundary = v[1:] > np.nextafter(v[:-1], np.inf)
    idx = np.flatnonzero(boundary) + 1
    starts = np.concatenate([[0], idx]).astype(np.int64)
    ends = np.concatenate([idx, [n]]).astype(np.int64)
    dvals = v[ends - 1]
    dcnts = ends - starts
    firsts = v[starts]
    if v[0] > 0.0 and zero_cnt > 0:
        dvals = np.concatenate([[0.0], dvals])
        dcnts = np.concatenate([[zero_cnt], dcnts])
    elif v[n - 1] < 0.0 and zero_cnt > 0:
        dvals = np.concatenate([dvals, [0.0]])
        dcnts = np.concatenate([dcnts, [zero_cnt]])
    else:
        # a zero block (even with count 0) at the unique
        # negative->positive group boundary
        pos = np.flatnonzero((dvals[:-1] < 0.0) & (firsts[1:] > 0.0))
        if len(pos):
            p = int(pos[0]) + 1
            dvals = np.insert(dvals, p, 0.0)
            dcnts = np.insert(dcnts, p, zero_cnt)
    return dvals, dcnts.astype(np.int64)


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int,
                 filter_cnt: int, bin_type: int) -> bool:
    """True when no split of this feature can satisfy min-data (bin.cpp:40-72)."""
    if bin_type == BIN_TYPE_NUMERICAL:
        left = 0
        for i in range(len(cnt_in_bin) - 1):
            left += int(cnt_in_bin[i])
            if left >= filter_cnt and total_cnt - left >= filter_cnt:
                return False
        return True
    # categorical: one-vs-rest viability
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            left = int(cnt_in_bin[i])
            if left >= filter_cnt and total_cnt - left >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value->bin quantizer (reference BinMapper, bin.h:78-246)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.bin_type: int = BIN_TYPE_NUMERICAL
        self.is_trivial: bool = True
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        # share of the binning sample in the default bin (EFB's sparsity)
        self.sparse_rate: float = 1.0

    @property
    def is_categorical(self) -> bool:
        return self.bin_type == BIN_TYPE_CATEGORICAL

    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 20,
                 bin_type: int = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True,
                 zero_as_missing: bool = False) -> "BinMapper":
        """Fit bin bounds from a (possibly subsampled) value sample;
        ``total_sample_cnt - len(values)`` values are implicitly zero
        (bin.cpp:210-235)."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        values = values[~nan_mask]
        na_cnt = int(nan_mask.sum())

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NONE if na_cnt == 0 else MISSING_NAN
        if not use_missing:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)
        values_sorted = np.sort(values, kind="stable")
        distinct, counts = _distinct_with_zero(values_sorted, zero_cnt)
        if len(distinct) == 0:
            self.is_trivial = True
            return self
        self.min_val = float(distinct[0])
        self.max_val = float(distinct[-1])

        if bin_type == BIN_TYPE_CATEGORICAL:
            cnt_in_bin = self._find_bin_categorical(
                distinct, counts, max_bin, min_data_in_bin, total_sample_cnt,
                na_cnt)
        else:
            cnt_in_bin = self._find_bin_numerical(
                distinct, counts, max_bin, min_data_in_bin, total_sample_cnt,
                na_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(
                cnt_in_bin, int(total_sample_cnt), min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            if bin_type == BIN_TYPE_CATEGORICAL:
                check(self.default_bin > 0,
                      "categorical default_bin must be > 0")
            self.sparse_rate = (cnt_in_bin[self.default_bin]
                                / max(total_sample_cnt, 1))
        return self

    def _find_bin_numerical(self, distinct, counts, max_bin: int,
                            min_data_in_bin: int, total_sample_cnt: int,
                            na_cnt: int) -> List[int]:
        if self.missing_type == MISSING_NAN:
            bounds = find_bin_with_zero_as_one_bin(
                distinct, counts, max_bin - 1, total_sample_cnt - na_cnt,
                min_data_in_bin)
            bounds.append(math.nan)  # trailing NaN bin
        else:
            bounds = find_bin_with_zero_as_one_bin(
                distinct, counts, max_bin, total_sample_cnt, min_data_in_bin)
            if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                self.missing_type = MISSING_NONE
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)
        # count per bin for trivial-feature filtering: each distinct value
        # in the first bin whose upper bound is >= it
        cnt_in_bin = np.bincount(
            np.searchsorted(self.bin_upper_bound, distinct, side="left"),
            weights=counts, minlength=self.num_bin).astype(np.int64).tolist()
        if self.missing_type == MISSING_NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        check(self.num_bin <= max_bin, "num_bin exceeds max_bin")
        return cnt_in_bin

    def _find_bin_categorical(self, distinct, counts, max_bin: int,
                              min_data_in_bin: int, total_sample_cnt: int,
                              na_cnt: int) -> List[int]:
        """Categorical mapping: by descending count, 99% mass cutoff
        (bin.cpp:310-375).  Bin 0 is never category 0, and the last bin
        takes negative values, NaN and every category left out."""
        ints: List[int] = []
        int_counts: List[int] = []
        for v, c in zip(distinct, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                log_warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            elif ints and iv == ints[-1]:
                int_counts[-1] += int(c)
            else:
                ints.append(iv)
                int_counts.append(int(c))
        self.num_bin = 0
        rest_cnt = int(total_sample_cnt) - na_cnt
        cnt_in_bin: List[int] = []
        if rest_cnt <= 0:
            return cnt_in_bin
        if ints and ints[-1] // 100 > len(ints):
            log_warning("Met categorical feature which contains sparse "
                        "values. Consider renumbering to consecutive "
                        "integers started from zero")
        order = sorted(range(len(ints)), key=lambda i: (-int_counts[i],
                                                        ints[i]))
        ints = [ints[i] for i in order]
        int_counts = [int_counts[i] for i in order]
        if ints and ints[0] == 0:
            if len(ints) == 1:
                ints.append(1)
                int_counts.append(0)
            ints[0], ints[1] = ints[1], ints[0]
            int_counts[0], int_counts[1] = int_counts[1], int_counts[0]
        cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
        used_cnt = 0
        eff_max_bin = min(len(ints), max_bin)
        self.bin_2_categorical = []
        self.categorical_2_bin = {}
        cur = 0
        while cur < len(ints) and (used_cnt < cut_cnt
                                   or self.num_bin < eff_max_bin):
            if int_counts[cur] < min_data_in_bin and cur > 1:
                break
            self.bin_2_categorical.append(ints[cur])
            self.categorical_2_bin[ints[cur]] = self.num_bin
            used_cnt += int_counts[cur]
            cnt_in_bin.append(int_counts[cur])
            self.num_bin += 1
            cur += 1
        if cur == len(ints) and na_cnt > 0:
            self.bin_2_categorical.append(-1)
            self.categorical_2_bin[-1] = self.num_bin
            cnt_in_bin.append(0)
            self.num_bin += 1
        self.missing_type = (MISSING_NONE if cur == len(ints) and na_cnt == 0
                             else MISSING_NAN)
        if cnt_in_bin:
            # the last bin absorbs the leftover mass
            cnt_in_bin[-1] += int(total_sample_cnt) - used_cnt
        return cnt_in_bin

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:496-549)."""
        values = np.asarray(values, dtype=np.float64)
        if self.is_categorical:
            return self._categorical_to_bin(values)
        nan_mask = np.isnan(values)
        v = np.where(nan_mask, 0.0, values)
        ub = self.bin_upper_bound
        n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN
                                   else 0)
        # first bin whose upper bound >= value  (value <= ub[bin])
        bins = np.searchsorted(ub[:max(n_search - 1, 0)], v, side="left")
        if self.missing_type == MISSING_NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins.astype(np.int32)

    def _categorical_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Category value -> bin; NaN, negative and unseen categories go to
        the last bin."""
        out = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
        if not self.categorical_2_bin:
            return out
        iv = np.where(np.isfinite(values), values, -1).astype(np.int64)
        cats = np.fromiter(self.categorical_2_bin.keys(), dtype=np.int64)
        bins = np.fromiter(self.categorical_2_bin.values(), dtype=np.int64)
        order = np.argsort(cats)
        cats, bins = cats[order], bins[order]
        pos = np.clip(np.searchsorted(cats, iv), 0, len(cats) - 1)
        hit = (cats[pos] == iv) & (iv >= 0)
        return np.where(hit, bins[pos], out).astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold of a numerical bin (its upper bound), or the
        category of a categorical one (BinMapper::BinToValue)."""
        if self.is_categorical:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    # ---------------------------------------------------------- hand-over
    def to_dict(self) -> dict:
        """The mapper as plain values, in the JAX package's layout."""
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "bin_upper_bound": [float(x) for x in self.bin_upper_bound],
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.bin_type = int(d.get("bin_type", BIN_TYPE_NUMERICAL))
        m.is_trivial = bool(d["is_trivial"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(x) for x in d.get("bin_2_categorical", [])]
        m.categorical_2_bin = {c: i for i, c in
                               enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m
