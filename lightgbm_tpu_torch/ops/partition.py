"""Leaf partition of the training rows (port of
lightgbm_tpu/ops/partition.py).

The reference `DataPartition` (`src/treelearner/data_partition.hpp`) +
`DenseBin::Split` routing (`src/io/dense_bin.hpp:195-255`): a permuted
row-index array where each leaf's rows are contiguous. A split stably
partitions one leaf's slice in place — left rows first, then right rows,
each in their previous order.

Routing semantics:
- numerical, missing None : bin <= threshold -> left
- numerical, missing Zero : bin == default_bin -> default side; else <= thr
- numerical, missing NaN  : bin == num_bin-1 (NaN bin) -> default side;
                            else <= thr
- categorical             : bin in the split's bitset -> left
                            (`SplitCategorical`, dense_bin.hpp:256-283)
"""
from __future__ import annotations

from typing import Optional

import torch

from .bins import take_bins

MISSING_NONE_C, MISSING_ZERO_C, MISSING_NAN_C = 0, 1, 2


def numerical_goes_left(binvals: torch.Tensor, threshold: int,
                        default_left: bool, missing_type: int,
                        default_bin: int, num_bin: int) -> torch.Tensor:
    base = binvals <= threshold
    if missing_type == MISSING_ZERO_C:
        is_default = binvals == default_bin
    elif missing_type == MISSING_NAN_C:
        is_default = binvals == num_bin - 1
    else:
        return base
    return torch.where(is_default, default_left, base)


def categorical_goes_left(binvals: torch.Tensor,
                          bitset: torch.Tensor) -> torch.Tensor:
    """Left iff bit ``bin`` of ``bitset`` is set: words [..., W] with
    values in [0, 2^32), one set for all rows ([W]) or one a row; bins
    past the words go right (reference Common::FindInBitset,
    utils/common.h)."""
    nw = bitset.shape[-1]
    word = (binvals >> 5).long()
    w = torch.gather(bitset.to(torch.int64).expand(*binvals.shape, nw), -1,
                     word.clamp(0, nw - 1)[..., None])[..., 0]
    return (((w >> (binvals & 31).long()) & 1) != 0) & (word < nw)


def bundle_unpack(raw, boff, bpk, default_bin, num_bin):
    """A bundled storage value -> the feature's own bin (`io/bundling.py`
    layout: the feature owns [boff, boff + num_bin - 1) with its default
    bin skipped; a value outside that range means its default); ``bpk``
    0 leaves the value as it is. Scalars or tensors that broadcast."""
    p = raw - boff
    in_range = (p >= 0) & (p < num_bin - 1)
    b = torch.where(p >= default_bin, p + 1, p)
    unpacked = torch.where(in_range, b, default_bin)
    return torch.where(torch.as_tensor(bpk != 0, device=raw.device),
                       unpacked, raw)


def split_partition(indices: torch.Tensor, bins_col: torch.Tensor,
                    begin: int, count: int, threshold: int,
                    default_left: bool, missing_type: int, default_bin: int,
                    num_bin: int,
                    cat_bitset: Optional[torch.Tensor] = None,
                    bundle_off: int = 0, bundle_packed: int = 0) -> int:
    """Stable-partition one leaf's slice ``indices[begin:begin+count]`` in
    place by the split feature's bin column ``bins_col`` [N] (its storage
    column under bundling: ``bundle_packed`` unpacks it from
    ``bundle_off``); returns the left count (one host read). A
    categorical split passes its bitset (``cat_bitset``, words [8]) and
    routes by it alone."""
    idx = indices[begin:begin + count]
    b = take_bins(bins_col, idx.long())
    if bundle_packed:
        b = bundle_unpack(b, bundle_off, 1, default_bin, num_bin)
    if cat_bitset is not None:
        goes_left = categorical_goes_left(b, cat_bitset)
    else:
        goes_left = numerical_goes_left(b, threshold, default_left,
                                        missing_type, default_bin, num_bin)
    left = idx[goes_left]
    right = idx[~goes_left]
    indices[begin:begin + count] = torch.cat([left, right])
    return int(left.numel())


def leaf_value_fill(leaf_begin: torch.Tensor, leaf_count: torch.Tensor,
                    leaf_value: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Per-POSITION leaf values from the final partition: leaves are
    disjoint contiguous [begin, begin+count) segments, so a difference
    array with +(id+1) at each begin and -(id+1) at each end, prefix
    summed, gives the covering leaf at every position. The cover ids are
    integers, so the fill is exact."""
    live = leaf_count > 0
    ids = torch.arange(1, leaf_value.shape[0] + 1, dtype=torch.int64,
                       device=leaf_value.device)
    d = torch.zeros(n_pad + 1, dtype=torch.int64, device=leaf_value.device)
    d.index_add_(0, torch.where(live, leaf_begin, n_pad).long(),
                 torch.where(live, ids, 0))
    d.index_add_(0, torch.where(live, leaf_begin + leaf_count, n_pad).long(),
                 torch.where(live, -ids, 0))
    cover = torch.cumsum(d[:-1], 0)  # 0 outside every leaf, id+1 inside
    vpad = torch.cat([torch.zeros(1, dtype=leaf_value.dtype,
                                  device=leaf_value.device), leaf_value])
    return vpad[cover]


def unpermute_to_rows(indices: torch.Tensor, values: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Map per-POSITION values back to per-ROW order: position p holds row
    ``indices[p]``. The reference sorts by row id (a sort is cheap on the
    TPU, a scatter is not); on the GPU this is one scatter. Requires
    ``indices[:n]`` to be a permutation of [0, n)."""
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    out[indices[:n].long()] = values[:n]
    return out
