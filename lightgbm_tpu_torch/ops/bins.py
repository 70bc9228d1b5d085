"""The binned matrix's element types (the JAX package's rule,
lightgbm_tpu/io/dataset.py:328): uint8 while every used feature has at
most 256 bins, else uint16.

A uint16 matrix stays 2 B a bin on the device (kernel B1 reads it as
``const uint16_t*``), but torch has few uint16 ops (indexing, gathers,
comparisons and fills are missing in many builds). Torch-side code
therefore reads and writes it through its int16 view (`storage_view`),
which every op takes, and widens what it read to int32 (`bin_values`):
a bin of 32,768 or more is negative in the view and positive again
after the widening.
"""
from __future__ import annotations

import torch

# the most bins a feature may have in a uint8 matrix
UINT8_BINS = 256


def bins_dtype(max_num_bin: int) -> torch.dtype:
    """uint8 while the largest used feature has at most 256 bins, else
    uint16."""
    return torch.uint8 if max_num_bin <= UINT8_BINS else torch.uint16


def storage_view(bins: torch.Tensor) -> torch.Tensor:
    """``bins`` as a tensor every torch op takes: a uint16 matrix as its
    int16 view, a uint8 one as it is (the same storage)."""
    return bins.view(torch.int16) if bins.dtype == torch.uint16 else bins


def bin_values(vals: torch.Tensor) -> torch.Tensor:
    """Values read from `storage_view` as int32 bins."""
    out = vals.to(torch.int32)
    return out & 0xFFFF if vals.dtype == torch.int16 else out


def take_bins(bins: torch.Tensor, *index) -> torch.Tensor:
    """``bins[index]`` as int32 bins, for uint8 and uint16 matrices."""
    return bin_values(storage_view(bins)[index])


def to_storage(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer bins as the storage type of a ``dtype`` matrix: uint8, or
    the int16 view's wrapped values of uint16 (write them into
    `storage_view`)."""
    return vals.to(torch.int16 if dtype == torch.uint16 else dtype)
