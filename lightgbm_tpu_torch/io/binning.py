"""Feature quantization: value -> bin mapping (copied from
lightgbm_tpu/io/binning.py, pure-Python path).

Re-creates the behavior of the reference `BinMapper`
(`src/io/bin.cpp:22-419`, `include/LightGBM/bin.h:70-250,461-497`): greedy
equal-ish-count numerical binning with zero isolated into its own bin,
categorical binning by descending count with a rare-category cutoff, and the
three missing-value regimes {None, Zero, NaN}.

This is host-side preprocessing (NumPy); the resulting per-feature bin edges
drive a fully vectorized `values_to_bins` that produces the uint8/int32 binned
matrix living in device memory.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

K_ZERO_THRESHOLD = 1e-35  # reference kZeroThreshold (bin.cpp:166)

MISSING_NONE = "none"
MISSING_ZERO = "zero"
MISSING_NAN = "nan"

BIN_NUMERICAL = "numerical"
BIN_CATEGORICAL = "categorical"


def _next_after(x: float) -> float:
    """Smallest double > x (reference Common::GetDoubleUpperBound,
    common.h:862)."""
    return math.nextafter(x, math.inf)


def _le_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a) (reference Common::CheckDoubleEqualOrdered,
    common.h:857)."""
    return b <= _next_after(a)


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundaries over sorted distinct values
    (reference GreedyFindBin, bin.cpp:74-157). The scan runs over Python
    lists: the same doubles and integers as numpy's scalars, without their
    per-element cost."""
    n = len(distinct_values)
    bounds: List[float] = []
    assert max_bin > 0
    dv = distinct_values.tolist()
    cnt = counts.tolist()
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += cnt[i]
            if cur >= min_data_in_bin:
                val = _next_after((dv[i] + dv[i + 1]) / 2.0)
                if not bounds or not _le_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    big = is_big.tolist()

    uppers = [math.inf] * max_bin
    lowers = [math.inf] * max_bin
    bin_cnt = 0
    lowers[0] = dv[0]
    cur = 0
    for i in range(n - 1):
        if not big[i]:
            rest_sample_cnt -= cnt[i]
        cur += cnt[i]
        # close the bin when: value itself is heavy; bin is full; or the next
        # value is heavy and this bin is at least half full
        if (big[i] or cur >= mean_bin_size or
                (big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            uppers[bin_cnt] = dv[i]
            bin_cnt += 1
            lowers[bin_cnt] = dv[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    bin_cnt += 1
    bounds = []
    for i in range(bin_cnt - 1):
        val = _next_after((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _le_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _distinct_counts(values: np.ndarray, zero_cnt: int):
    """(distinct values, counts) of sorted non-NaN ``values``: a value
    within one ulp above the one before it joins its run, which keeps the
    larger value; 0.0 with ``zero_cnt`` is spliced into sorted order
    (before all-positive values and after all-negative ones only when
    ``zero_cnt`` > 0, between a negative and a positive value always;
    reference FindBin's scan, bin.cpp:245-270)."""
    n = len(values)
    if n == 0:
        return np.asarray([0.0]), np.asarray([zero_cnt], np.int64)
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = values[1:] > np.nextafter(values[:-1], np.inf)
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], n)
    dv = values[ends - 1]
    cv = (ends - starts).astype(np.int64)
    if values[0] > 0.0:
        at = 0 if zero_cnt > 0 else -1
    elif values[-1] < 0.0:
        at = len(dv) if zero_cnt > 0 else -1
    else:
        cross = np.flatnonzero((values[starts[1:] - 1] < 0.0)
                               & (values[starts[1:]] > 0.0))
        at = int(cross[0]) + 1 if len(cross) else -1
    if at >= 0:
        dv = np.insert(dv, at, 0.0)
        cv = np.insert(cv, at, zero_cnt)
    return dv, cv


def _find_bin_zero_as_one(distinct_values: np.ndarray, counts: np.ndarray,
                          max_bin: int, total_sample_cnt: int,
                          min_data_in_bin: int) -> List[float]:
    """Bin boundaries with the zero region isolated into its own bin
    (reference FindBinWithZeroAsOneBin, bin.cpp:159-215)."""
    neg_mask = distinct_values <= -K_ZERO_THRESHOLD
    pos_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[neg_mask].sum())
    right_cnt_data = int(counts[pos_mask].sum())
    cnt_zero = total_sample_cnt - left_cnt_data - right_cnt_data

    nz = np.nonzero(~neg_mask)[0]
    left_cnt = int(nz[0]) if len(nz) else len(distinct_values)

    bounds: List[float] = []
    if left_cnt > 0:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD

    pz = np.nonzero(pos_mask[left_cnt:])[0]
    right_start = left_cnt + int(pz[0]) if len(pz) else -1

    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bounds)
        assert right_max_bin > 0
        right_bounds = _greedy_find_bin(
            distinct_values[right_start:], counts[right_start:],
            right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(math.inf)
    return bounds


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: str) -> bool:
    """True if no split of this feature can satisfy min-data on both sides
    (reference NeedFilter, bin.cpp:50-72)."""
    if bin_type == BIN_NUMERICAL:
        s = 0
        for c in list(cnt_in_bin)[:-1]:
            s += c
            if s >= filter_cnt and total_cnt - s >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for c in list(cnt_in_bin)[:-1]:
            if c >= filter_cnt and total_cnt - c >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value->bin mapping (reference BinMapper, bin.h:100+)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: str = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: str = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 20, bin_type: str = BIN_NUMERICAL,
                 use_missing: bool = True,
                 zero_as_missing: bool = False) -> "BinMapper":
        """Learn the binning from sampled values (reference FindBin,
        bin.cpp:217-419). `values` holds the sampled NON-ZERO entries;
        zeros are implied by `total_sample_cnt - len(values)`."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        if not use_missing:
            self.missing_type = MISSING_NONE
            na_cnt = 0
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NONE if na_cnt == 0 else MISSING_NAN
        if not use_missing:
            pass
        n_values = len(values)
        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - n_values - na_cnt)

        # distinct values with zero spliced into sorted order
        values = np.sort(values, kind="stable")
        dv, cv = _distinct_counts(values, zero_cnt)
        distinct, counts = dv.tolist(), cv.tolist()

        self.min_val = distinct[0]
        self.max_val = distinct[-1]
        cnt_in_bin: List[int] = []

        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                bounds = _find_bin_zero_as_one(dv, cv, max_bin,
                                               total_sample_cnt, min_data_in_bin)
                if len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                bounds = _find_bin_zero_as_one(dv, cv, max_bin,
                                               total_sample_cnt, min_data_in_bin)
            else:  # NaN bin appended last
                bounds = _find_bin_zero_as_one(dv, cv, max_bin - 1,
                                               total_sample_cnt - na_cnt,
                                               min_data_in_bin)
                bounds.append(math.nan)
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            # each distinct value's bin: the first whose upper bound is at
            # least the value (a NaN bound last, never reached)
            cnt_in_bin = np.bincount(
                np.searchsorted(self.bin_upper_bound, dv, side="left"),
                weights=cv, minlength=self.num_bin).astype(np.int64).tolist()
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: merge as ints, negatives count as NaN
            di: List[int] = []
            ci: List[int] = []
            for v, c in zip(distinct, counts):
                iv = int(v)
                if iv < 0:
                    na_cnt += int(c)
                elif di and iv == di[-1]:
                    ci[-1] += int(c)
                else:
                    di.append(iv)
                    ci.append(int(c))
            self.num_bin = 0
            rest_cnt = total_sample_cnt - na_cnt
            self.categorical_2_bin = {}
            self.bin_2_categorical = []
            cnt_in_bin = []
            if rest_cnt > 0:
                order = np.argsort(np.asarray(ci), kind="stable")[::-1]
                di2 = [di[i] for i in order]
                ci2 = [ci[i] for i in order]
                # bin 0 must not hold category 0 (default_bin must be > 0)
                if di2 and di2[0] == 0:
                    if len(ci2) == 1:
                        ci2.append(0)
                        di2.append(di2[0] + 1)
                    di2[0], di2[1] = di2[1], di2[0]
                    ci2[0], ci2[1] = ci2[1], ci2[0]
                cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
                used_cnt = 0
                eff_max_bin = min(len(di2), max_bin)
                cur_cat = 0
                while cur_cat < len(di2) and (used_cnt < cut_cnt
                                              or self.num_bin < eff_max_bin):
                    if ci2[cur_cat] < min_data_in_bin and cur_cat > 1:
                        break
                    self.bin_2_categorical.append(di2[cur_cat])
                    self.categorical_2_bin[di2[cur_cat]] = self.num_bin
                    used_cnt += ci2[cur_cat]
                    cnt_in_bin.append(ci2[cur_cat])
                    self.num_bin += 1
                    cur_cat += 1
                if cur_cat == len(di2) and na_cnt > 0:
                    self.bin_2_categorical.append(-1)
                    self.categorical_2_bin[-1] = self.num_bin
                    cnt_in_bin.append(0)
                    self.num_bin += 1
                if cur_cat == len(di2) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                elif na_cnt == 0:
                    self.missing_type = MISSING_ZERO
                else:
                    self.missing_type = MISSING_NAN
                if cnt_in_bin:
                    cnt_in_bin[-1] += total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            if bin_type == BIN_CATEGORICAL:
                assert self.default_bin > 0
            self.sparse_rate = cnt_in_bin[self.default_bin] / max(
                total_sample_cnt, 1)
        else:
            self.sparse_rate = 1.0
        return self

    def value_to_bin(self, value: float) -> int:
        """Scalar value->bin (reference bin.h:461-497)."""
        return int(self.values_to_bins(np.asarray([value]))[0])

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a whole column."""
        values = np.asarray(values, dtype=np.float64)
        out = np.zeros(len(values), dtype=np.int32)
        nan_mask = np.isnan(values)
        if self.bin_type == BIN_NUMERICAL:
            v = np.where(nan_mask, 0.0, values)
            r = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                r -= 1
            # bin = first index with value <= upper_bound
            bounds = self.bin_upper_bound[:r]  # exclude last (inf / nan)
            out = np.searchsorted(bounds, v, side="left").astype(np.int32)
            # values equal to a bound belong to that bin (value <= bound)
            # searchsorted 'left' gives idx of first bound >= value: correct.
            if self.missing_type == MISSING_NAN:
                out[nan_mask] = self.num_bin - 1
        else:
            iv = np.where(nan_mask, -1, np.nan_to_num(values, nan=-1.0)).astype(
                np.int64)
            out = np.full(len(values), self.num_bin - 1, dtype=np.int32)
            if self.categorical_2_bin:
                cats = np.fromiter(self.categorical_2_bin.keys(), dtype=np.int64)
                bins = np.fromiter(self.categorical_2_bin.values(), dtype=np.int64)
                sorter = np.argsort(cats)
                cats_sorted, bins_sorted = cats[sorter], bins[sorter]
                pos = np.searchsorted(cats_sorted, iv)
                pos = np.clip(pos, 0, len(cats_sorted) - 1)
                hit = (cats_sorted[pos] == iv) & (iv >= 0)
                out[hit] = bins_sorted[pos[hit]].astype(np.int32)
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative real value for a bin (reference BinToValue,
        used for model-text thresholds)."""
        if self.bin_type == BIN_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])
