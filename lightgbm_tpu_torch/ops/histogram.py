"""Histogram construction — the hottest loop (port of
lightgbm_tpu/ops/histogram.py, backed by kernels B1 and B5).

``hist[f, b, :] = sum over the leaf's rows r with bins[r, f] == b of
(g_r, h_r, 1)``. On a CUDA tensor `leaf_histogram` launches the
hand-written kernel ``ops/csrc/histogram.cu`` (shared-memory atomics,
the `ocl/histogram256.cl` pattern) and raises if it cannot; on a CPU
tensor it runs `histogram_plain`, the kernel's plain PyTorch twin.
Precision ``"f32"`` is the default path, ``"f64"`` the exact mode of
``tpu_use_f64_hist`` (order-independent sums of f32 payloads).

`histogram_from_words` is the level builder's histogram over packed bin
words, many contiguous row segments in one call: kernel B5
(``ops/csrc/histogram_words.cu``) on a CUDA tensor, its twin
`histogram_words_plain` on a CPU tensor. Both sum in f64 and round to
f32 once, whatever the precision.
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
# launches of kernel B5 (`histogram_from_words`)
WORDS_LAUNCHES: Dict[str, int] = {"histogram_words": 0}

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
    for d in (LAUNCHES, WORDS_LAUNCHES):
        for k in d:
            d[k] = 0


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


# ---------------------------------------------------------------------------
# B5: histograms over packed bin words
# ---------------------------------------------------------------------------
def histogram_words_plain(words: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, seg_begin: torch.Tensor,
                          seg_cnt: torch.Tensor, num_features: int,
                          num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5: the segments' rows unpacked
    from the words, then one ``index_add_`` over the flat cell index
    ``(segment * F + f) * num_bins + bin``, summed in f64 (counts exact)
    and rounded to f32 once."""
    dev = words.device
    nseg = seg_begin.numel()
    cnt = seg_cnt.long()
    total = int(cnt.sum()) if nseg else 0
    out = torch.zeros((nseg * num_features * num_bins, NUM_HIST_STATS),
                      dtype=torch.float64, device=dev)
    if total and num_features:
        seg = torch.repeat_interleave(torch.arange(nseg, device=dev), cnt,
                                      output_size=total)
        start = torch.cumsum(cnt, 0) - cnt
        pos = seg_begin.long()[seg] + torch.arange(total, device=dev) \
            - start[seg]
        f = torch.arange(num_features, device=dev)
        bins = (words[f >> 2][:, pos] >> ((f & 3) * 8)[:, None]) & 255
        cell = (seg[None, :] * num_features + f[:, None]) * num_bins \
            + bins.long()                                     # [F, P]
        pay = torch.stack([g[pos].double(), h[pos].double(),
                           torch.ones(total, dtype=torch.float64,
                                      device=dev)], dim=1)     # [P, 3]
        ok = (bins < num_bins).reshape(-1)
        out.index_add_(0, cell.reshape(-1)[ok],
                       pay[None].expand(num_features, -1, -1)
                       .reshape(-1, NUM_HIST_STATS)[ok])
    return out.view(nseg, num_features, num_bins, NUM_HIST_STATS).float()


def _words_kernel():
    fn = _fns.get("words")
    if fn is None:
        from ..utils import cuda_build
        lib = cuda_build.load("histogram_words")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.lgbt_words_hist
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, i, i, i, i,
                       p, p, p, p]
        fn.restype = ctypes.c_int
        lib.lgbt_words_smem_optin.argtypes = [i]
        lib.lgbt_words_smem_optin.restype = i
        _fns["words_smem_optin"] = lib.lgbt_words_smem_optin
        _fns["words"] = fn
    return fn


def _histogram_words_cuda(words, g, h, seg_begin, seg_cnt, num_features,
                          num_bins, rows_hint):
    from .aligned import hist_launch_shape
    dev = words.device
    wcnt, n = words.shape
    if words.dtype != torch.int32 or not words.is_contiguous() \
            or wcnt * 4 < num_features:
        raise ValueError("words must be a contiguous int32 [ceil(F/4), N] "
                         "tensor")
    for name, t, dtype, size in (("g", g, torch.float32, n),
                                 ("h", h, torch.float32, n),
                                 ("seg_begin", seg_begin, torch.int32, None),
                                 ("seg_cnt", seg_cnt, torch.int32, None)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
                or t.device != dev or (size is not None and t.numel() != size):
            raise ValueError(f"{name} must be a contiguous {dtype} vector "
                             "on the device of words")
    if seg_cnt.numel() != seg_begin.numel():
        raise ValueError("seg_begin and seg_cnt differ in length")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins={num_bins} outside [1, 256]")
    nseg = seg_begin.numel()
    cells = (nseg, num_features, num_bins)
    out = torch.zeros(cells + (NUM_HIST_STATS,), dtype=torch.float32,
                      device=dev)
    if nseg == 0 or num_features == 0:
        return out
    fn = _words_kernel()
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    fpb, blocks = hist_launch_shape(
        -(-max(int(rows_hint), 1) // _MIN_ROWS_PER_BLOCK), num_features,
        num_bins,
        torch.cuda.get_device_properties(ordinal).multi_processor_count,
        _fns["words_smem_optin"](ordinal))
    seg_off = torch.zeros(nseg + 1, dtype=torch.int64, device=dev)
    seg_off[1:] = torch.cumsum(seg_cnt.long(), 0)
    gh = torch.zeros(cells + (2,), dtype=torch.float64, device=dev)
    cnt = torch.zeros(cells, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), n, g.data_ptr(), h.data_ptr(),
                 seg_begin.data_ptr(), seg_off.data_ptr(), nseg,
                 num_features, num_bins, fpb, blocks, _THREADS,
                 gh.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"histogram_words kernel launch failed: CUDA "
                           f"error {err} (blocks={blocks}, features/block="
                           f"{fpb}, bins={num_bins}, segments={nseg})")
    WORDS_LAUNCHES["histogram_words"] += 1
    return out


def histogram_from_words(words: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor, seg_begin: torch.Tensor,
                         seg_cnt: torch.Tensor, num_features: int,
                         num_bins: int,
                         rows_hint: Optional[int] = None) -> torch.Tensor:
    """hist[S, F, num_bins, 3] f32 of S contiguous row segments
    ``[seg_begin[s], seg_begin[s] + seg_cnt[s])`` over packed bin words
    (JAX package: `histogram_from_words`, one call per segment). ``words``
    is int32 [ceil(F/4), N], feature ``4w + j`` in bits ``8j..8j+7`` of
    word ``w``; ``g``/``h`` f32 [N]; the segment table int32 [S] on the
    same device. ``rows_hint`` (the total rows, if the caller knows it)
    sizes the kernel's grid without a read from the card; the kernel
    splits the true total itself."""
    if not words.is_cuda:
        return histogram_words_plain(words, g, h, seg_begin, seg_cnt,
                                     num_features, num_bins)
    if rows_hint is None:
        rows_hint = int(seg_cnt.sum())
    return _histogram_words_cuda(words, g, h, seg_begin, seg_cnt,
                                 num_features, num_bins, rows_hint)
