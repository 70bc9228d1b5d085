"""Histogram construction — the hottest loop (port of
lightgbm_tpu/ops/histogram.py, backed by kernel B1).

``hist[f, b, :] = sum over the leaf's rows r with bins[r, f] == b of
(g_r, h_r, 1)``. On a CUDA tensor `leaf_histogram` launches the
hand-written kernel ``ops/csrc/histogram.cu`` (shared-memory atomics,
the `ocl/histogram256.cl` pattern) and raises if it cannot; on a CPU
tensor it runs `histogram_plain`, the kernel's plain PyTorch twin.
Precision ``"f32"`` is the default path, ``"f64"`` the exact mode of
``tpu_use_f64_hist`` (order-independent sums of f32 payloads).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# payload columns: gradient, hessian, count
NUM_HIST_STATS = 3

# kernel launches per precision (a launch is one call that ran the CUDA
# kernel; the plain CPU path does not count)
LAUNCHES: Dict[str, int] = {"f32": 0, "f64": 0}

_DTYPES = {"f32": torch.float32, "f64": torch.float64}
_THREADS = 512
# rows one block should at least get before another block is worth it:
# the shared-memory atomics compile to compare-and-swap loops on sm_90a,
# so one block is slow and a leaf needs many blocks (chosen by measuring
# 256-16,384 rows per block on an H100; PERF.md, findings of slice 1)
_MIN_ROWS_PER_BLOCK = 1024
# shared-memory budget per block: two blocks fit one SM's 228 KB
_SMEM_BUDGET = 112 * 1024
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _leaf_rows(indices: Optional[torch.Tensor], begin: int, count: int,
               device) -> torch.Tensor:
    if indices is None:
        return torch.arange(begin, begin + count, device=device)
    return indices[begin:begin + count].long()


def histogram_plain(bins: torch.Tensor, gh: torch.Tensor,
                    indices: Optional[torch.Tensor], begin: int, count: int,
                    num_bins: int, precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the leaf's rows gathered, then
    one ``index_add_`` over the flat cell index ``f * num_bins + bin``,
    accumulated in f32 or f64."""
    dtype = _DTYPES[precision]
    f = bins.shape[1]
    rows = _leaf_rows(indices, begin, count, bins.device)
    payload = torch.cat([gh[rows].to(dtype),
                         torch.ones((rows.numel(), 1), dtype=dtype,
                                    device=bins.device)], dim=1)
    cell = bins[rows].long() + torch.arange(
        f, device=bins.device) * num_bins                      # [P, F]
    out = torch.zeros((f * num_bins, NUM_HIST_STATS), dtype=dtype,
                      device=bins.device)
    out.index_add_(0, cell.reshape(-1),
                   payload[:, None, :].expand(-1, f, -1).reshape(-1, 3))
    return out.view(f, num_bins, NUM_HIST_STATS)


def _kernel(precision: str):
    fn = _fns.get(precision)
    if fn is None:
        from ..utils import cuda_build
        lib = cuda_build.load("histogram")
        p = ctypes.c_void_p
        for name in ("lgbt_hist_f32", "lgbt_hist_f64"):
            k = getattr(lib, name)
            k.argtypes = [p, ctypes.c_int, p, p, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, p, p, p]
            k.restype = ctypes.c_int
        lib.lgbt_smem_optin.argtypes = [ctypes.c_int]
        lib.lgbt_smem_optin.restype = ctypes.c_int
        _fns["f32"], _fns["f64"] = lib.lgbt_hist_f32, lib.lgbt_hist_f64
        _fns["smem_optin"] = lib.lgbt_smem_optin
        fn = _fns[precision]
    return fn


def launch_shape(count: int, num_features: int, num_bins: int,
                 precision: str, num_sms: int, smem_optin: int):
    """(features per block, row blocks): features are tiled so one tile's
    sub-histogram fits the shared-memory budget, and at most as many
    blocks run as the card holds at once."""
    per_feature = num_bins * NUM_HIST_STATS * _DTYPES[precision].itemsize
    budget = min(_SMEM_BUDGET, smem_optin)
    fpb = max(1, min(num_features, budget // per_feature))
    if fpb * per_feature > smem_optin:
        raise ValueError(f"{num_bins} bins of {precision} accumulators "
                         f"exceed the {smem_optin} B of shared memory")
    grid_y = -(-num_features // fpb)
    blocks = max(1, min(-(-count // _MIN_ROWS_PER_BLOCK),
                        max(1, 2 * num_sms // grid_y)))
    return fpb, blocks


def _histogram_cuda(bins, gh, indices, begin, count, num_bins, precision):
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 \
            or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous uint8 [N, F] tensor")
    if gh.dtype != torch.float32 or gh.shape != (bins.shape[0], 2) \
            or not gh.is_contiguous() or gh.device != dev:
        raise ValueError("gh must be a contiguous f32 [N, 2] tensor on the "
                         "device of bins")
    if indices is not None:
        if indices.dtype != torch.int32 or not indices.is_contiguous() \
                or indices.device != dev:
            raise ValueError("indices must be a contiguous int32 tensor on "
                             "the device of bins")
        if begin < 0 or begin + count > indices.numel():
            raise ValueError("leaf slice outside the partition")
    elif begin < 0 or begin + count > bins.shape[0]:
        raise ValueError("row range outside bins")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins={num_bins} outside [1, 256]")
    f = bins.shape[1]
    dtype = _DTYPES[precision]
    if count == 0 or f == 0:
        return torch.zeros((f, num_bins, NUM_HIST_STATS), dtype=dtype,
                           device=dev)
    fn = _kernel(precision)
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    fpb, blocks = launch_shape(
        count, f, num_bins, precision,
        torch.cuda.get_device_properties(ordinal).multi_processor_count,
        _fns["smem_optin"](ordinal))
    out = torch.empty((f, num_bins, NUM_HIST_STATS), dtype=dtype, device=dev)
    partial = (torch.empty((blocks, f, num_bins, NUM_HIST_STATS),
                           dtype=dtype, device=dev) if blocks > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bins.data_ptr(), f, gh.data_ptr(),
                 None if indices is None else indices.data_ptr(),
                 int(begin), int(count), int(num_bins), fpb, blocks,
                 _THREADS, None if partial is None else partial.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err} (blocks={blocks}, features/block={fpb}, "
                           f"bins={num_bins}, {precision})")
    LAUNCHES[precision] += 1
    return out


def leaf_histogram(bins: torch.Tensor, gh: torch.Tensor,
                   indices: Optional[torch.Tensor], begin: int, count: int,
                   num_bins: int, precision: str = "f32") -> torch.Tensor:
    """Histogram of one leaf: the rows ``indices[begin:begin + count]`` of
    ``bins`` [N, F] uint8 and ``gh`` [N, 2] f32, or the contiguous rows
    ``[begin, begin + count)`` when ``indices`` is None (the identity root
    partition). Returns [F, num_bins, 3] in f32 (``"f32"``) or f64
    (``"f64"``)."""
    if precision not in _DTYPES:
        raise ValueError(f"precision must be f32 or f64, got {precision!r}")
    if bins.is_cuda:
        return _histogram_cuda(bins, gh, indices, begin, count, num_bins,
                               precision)
    return histogram_plain(bins, gh, indices, begin, count, num_bins,
                           precision)


def histogram_from_gathered_gh(bins_rows: torch.Tensor, gh: torch.Tensor,
                               valid: torch.Tensor, max_bin: int,
                               precision: str = "f32") -> torch.Tensor:
    """hist[F, max_bin, 3] over the valid rows of already-gathered leaf
    rows (the JAX package's signature; the learner calls
    `leaf_histogram` on the partition directly)."""
    idx = torch.nonzero(valid).flatten().to(torch.int32)
    return leaf_histogram(bins_rows.contiguous(), gh.contiguous(), idx, 0,
                          idx.numel(), max_bin, precision)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """larger-child = parent − smaller-child (reference
    `FeatureHistogram::Subtract`, `feature_histogram.hpp:75`)."""
    return parent - child
