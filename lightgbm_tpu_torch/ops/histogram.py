"""Histogram construction — the hottest loop (port of
lightgbm_tpu/ops/histogram.py, backed by kernels B1 and B5).

``hist[f, b, :] = sum over the leaf's rows r with bins[r, f] == b of
(g_r, h_r, 1)``. On a CUDA tensor `leaf_histogram` launches the
hand-written kernel ``ops/csrc/histogram.cu`` once a call and raises if
it cannot; on a CPU tensor it runs `histogram_plain`, the kernel's plain
PyTorch twin. Precision ``"f32"`` is the default path: fixed-point shared
cells with native integer atomics over tiles of at most `HIST_TILE_ROWS`
rows, then f64 sums rounded to f32 once, within 2e-6 of the leaf's sum of
|g| (|h|) of the twin, not bit-equal to it. ``"f64"`` is the exact mode
of ``tpu_use_f64_hist``: f64 sums of f32 payloads, equal to the twin's.

`histogram_from_words` is the level builder's histogram over packed bin
words, many contiguous row segments in one call: kernel B5
(``ops/csrc/histogram_words.cu``, one launch a call) on a CUDA tensor,
its twin `histogram_words_plain` on a CPU tensor. The twin sums in f64
and rounds to f32 once in both precisions; on the card ``"f32"`` takes
B1's fixed-point cells over row tiles that never cross a segment (within
2e-6 of the segment's sum of |g| (|h|) of the twin), and ``"f64"`` f64
shared sums, equal to the twin's.

A quantized payload (`quantize_gh`: ``gh`` int8 or int16 [N, 2], the
``tpu_quant_hist`` path) takes B1's integer branch, ``"i8"`` / ``"i16"``:
native 32-bit integer shared atomics over the exact integers, int64 sums
in device memory, each rounded to f32 once; the twin sums in int64 and
rounds once too, so the two are equal bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# payload columns: gradient, hessian, count
NUM_HIST_STATS = 3

# kernel launches per precision (a launch is one call that ran the CUDA
# kernel; the plain CPU path does not count): B1 (`leaf_histogram`), its
# integer branch by the quantized payload's width, and B5
# (`histogram_from_words`)
LAUNCHES: Dict[str, int] = {"f32": 0, "f64": 0}
INT_LAUNCHES: Dict[str, int] = {"i8": 0, "i16": 0}
WORDS_LAUNCHES: Dict[str, int] = {"f32": 0, "f64": 0}

_DTYPES = {"f32": torch.float32, "f64": torch.float64}
# B1's integer branch by the dtype of a quantized gh, and its bound
_INT_KINDS = {torch.int8: "i8", torch.int16: "i16"}
QMAX = {8: 127.0, 16: 32767.0}
# the kernels' indices in the libraries' occupancy query
_KIND_INDEX = {"f32": 0, "f64": 1, "i8": 2, "i16": 3}
# B1 (histogram.cu) and B5 (histogram_words.cu): one CTA of 1024 threads
# an SM, over tiles of at most HIST_TILE_ROWS rows (of a leaf, or of a
# segment), each scaled to its own largest |g| and |h| (2^14 rows keep a
# tile's fixed-point error within 1.9e-6 of its largest |v|)
HIST_TILE_ROWS = 16_384
# A leaf of n rows is spread over about sqrt(HIST_SPREAD * n / num_bins)
# CTAs: a CTA's shared adds take ~0.34 ns a row and feature on an H100
# and the flush of its tile ~2 ns a cell (F x num_bins cells) plus its
# share of the global adds, so that many CTAs balance the two (a tile
# sweep on the card, PERF.md, slice 9)
HIST_SPREAD = 7.2
# shared bytes a cell: f32, the hi/lo int32 words of g and of h and a u32
# count; f64, the f64 sums of g and h and a u32 count; the integer
# branch, the int32 sums of q_g and q_h and a u32 count
_CELL_BYTES = {"f32": 20, "f64": 20, "i8": 12, "i16": 12}
# shared bytes a CTA beyond its cells: the tile's largest |g| and |h| bits
_SMEM_EXTRA = 8
# the kernels' libraries ("histogram": B1, "histogram_words": B5) and the
# prefix of their C entry points (<prefix>_f32, _f64, _setup, _occupancy)
_PREFIX = {"histogram": "lgbt_hist", "histogram_words": "lgbt_words"}
_fns: Dict[str, Dict[str, object]] = {}
# (library, device ordinal) -> (SMs, dynamic shared memory a CTA may
# take), once the library's setup ran
_devices: Dict[Tuple[str, int], Tuple[int, int]] = {}
# (library, ordinal, F, num_bins, precision) -> (SMs, dynamic shared bytes
# a CTA may take, CTAs an SM, shared bytes a CTA): what a call needs from
# above
_shapes: Dict[Tuple[str, int, int, int, str],
              Tuple[int, int, int, int]] = {}
# (ordinal, stream) -> the scratch of B1's and B5's calls on that stream:
# f64 sums [cells, 2], and u32 counts [cells] followed by the tickets,
# zero between calls
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for d in (LAUNCHES, INT_LAUNCHES, WORDS_LAUNCHES):
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
    accumulated in f32 or f64; an integer ``gh`` in int64, rounded to f32
    once."""
    if gh.dtype in _INT_KINDS:
        return _histogram_plain_int(bins, gh, indices, begin, count,
                                    num_bins)
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


def _histogram_plain_int(bins, gh, indices, begin, count, num_bins):
    """`histogram_plain` of a quantized int8/int16 ``gh``: exact int64
    sums of the integers and the count, each rounded to f32 once."""
    f = bins.shape[1]
    rows = _leaf_rows(indices, begin, count, bins.device)
    payload = torch.cat([gh[rows].long(),
                         torch.ones((rows.numel(), 1), dtype=torch.int64,
                                    device=bins.device)], dim=1)
    cell = bins[rows].long() + torch.arange(
        f, device=bins.device) * num_bins                      # [P, F]
    out = torch.zeros((f * num_bins, NUM_HIST_STATS), dtype=torch.int64,
                      device=bins.device)
    out.index_add_(0, cell.reshape(-1),
                   payload[:, None, :].expand(-1, f, -1).reshape(-1, 3))
    return out.to(torch.float32).view(f, num_bins, NUM_HIST_STATS)


def quantize_gh(gh: torch.Tensor, bits: int, key
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounded per-column quantization of the [N, 2] f32
    grad/hess payload (JAX package: `ops/histogram.py::quantize_gh`):
    ``scale = max(absmax / qmax, 1e-30)`` a column in f32 (the division
    by the constant taken as XLA takes it, a product with the constant's
    f32 reciprocal), then ``q =
    clip(floor(gh / scale + u), -qmax, qmax)`` with ``u`` the f32 draw of
    ``jax.random.uniform(key, (N, 2))`` (``utils/prng.py``), so that
    ``E[q * scale] == gh``. Returns (q int8/int16 [N, 2], scale f32 [2]);
    the caller multiplies finished histograms and leaf sums by
    ``scale``."""
    from ..utils import prng
    qmax = QMAX[bits]
    absmax = gh.abs().amax(0)
    # XLA divides by the constant as a product with its f32 reciprocal
    qinv = float(np.float32(1.0) / np.float32(qmax))
    scale = torch.clamp(absmax * qinv, min=1e-30)
    u = prng.uniform_key(key, tuple(gh.shape), gh.device)
    q = torch.clamp(torch.floor(gh / scale + u), -qmax, qmax)
    return q.to(torch.int8 if bits == 8 else torch.int16), scale


def _lib(name: str = "histogram") -> Dict[str, object]:
    """The C entry points of library ``name`` (`_PREFIX`), by role:
    "f32", "f64" (the two kernels' launches), "setup", "occupancy"."""
    fns = _fns.get(name)
    if fns is None:
        from ..utils import cuda_build
        lib = cuda_build.load(name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        launch = ([p, i, p, p, ll, ll, i, i, i, i, i, i, p, p, p, p, p]
                  if name == "histogram" else
                  [p, ll, p, p, p, p, i, i, i, i, i, i, p, p, p, p, p])
        roles = [("f32", launch), ("f64", launch)]
        if name == "histogram":
            roles += [("i8", launch), ("i16", launch)]
        fns = {}
        for role, args in (*roles, ("setup", [i]), ("occupancy", [i, i])):
            fn = getattr(lib, f"{_PREFIX[name]}_{role}")
            fn.argtypes = args
            fn.restype = i
            fns[role] = fn
        _fns[name] = fns
    return fns


def hist_smem(feat_per_block: int, num_bins: int, precision: str) -> int:
    """Shared bytes of one CTA of kernel B1 or B5 over a feature tile."""
    return feat_per_block * num_bins * _CELL_BYTES[precision] + _SMEM_EXTRA


def _cells_fit(num_bins: int, precision: str, smem_optin: int) -> int:
    """Features whose cells fit ``smem_optin`` bytes of one CTA."""
    return (smem_optin - _SMEM_EXTRA) // (num_bins * _CELL_BYTES[precision])


def _feature_tile(num_features: int, num_bins: int, precision: str,
                  smem_optin: int, step: int) -> int:
    """Features a tile: the fewest equal tiles of whole ``step``-feature
    units whose cells fit ``smem_optin`` bytes."""
    fit = _cells_fit(num_bins, precision, smem_optin)
    if fit < step:
        raise ValueError(f"{step} features of {num_bins} bins of "
                         f"{precision} cells exceed the {smem_optin} B of "
                         "shared memory")
    units = -(-num_features // step)
    tiles = -(-units // (fit // step))
    return step * -(-units // tiles)


def _spread(rows: int, num_bins: int, num_sms: int, ctas_per_sm: int,
            grid_y: int) -> int:
    """CTAs along ``rows`` rows: about sqrt(`HIST_SPREAD` x rows /
    num_bins), at most one feature tile's share of the CTAs the SMs hold
    (``ctas_per_sm``, from the occupancy calculator on the card)."""
    if ctas_per_sm < 1:
        raise ValueError(f"{num_bins}-bin cells fit no CTA on an SM")
    return max(1, min(ctas_per_sm * num_sms // grid_y,
                      math.ceil(math.sqrt(HIST_SPREAD * max(rows, 1)
                                          / num_bins))))


def launch_shape(count: int, num_features: int, num_bins: int,
                 precision: str, num_sms: int, smem_optin: int,
                 ctas_per_sm: int = 1) -> Tuple[int, int, int]:
    """(features per tile, CTAs along the rows, rows per tile) of kernel
    B1: the features cut into the fewest equal tiles whose cells fit
    ``smem_optin`` bytes (whole 4-feature words where ``num_features`` %
    4 == 0); the leaf's ``count`` rows spread over `_spread`'s CTAs, each
    taking the same number of equal tiles of at most `HIST_TILE_ROWS`
    rows; never more CTAs than tiles."""
    step = 4 if num_features % 4 == 0 \
        and _cells_fit(num_bins, precision, smem_optin) >= 4 else 1
    fpb = _feature_tile(num_features, num_bins, precision, smem_optin, step)
    rows = max(count, 1)
    ctas = _spread(rows, num_bins, num_sms, ctas_per_sm,
                   -(-num_features // fpb))
    rows_per_cta = -(-rows // ctas)
    tiles_per_cta = -(-rows_per_cta // HIST_TILE_ROWS)
    tile_rows = -(-rows // (ctas * tiles_per_cta))
    return fpb, min(ctas, -(-rows // tile_rows)), tile_rows


def words_launch_shape(rows: int, num_features: int, num_bins: int,
                       precision: str, num_sms: int, smem_optin: int,
                       ctas_per_sm: int = 1) -> Tuple[int, int]:
    """(features per tile, CTAs along the rows) of kernel B5: the
    features cut into the fewest equal tiles of whole 4-feature words
    whose cells fit ``smem_optin`` bytes; the call's ``rows`` rows (all
    segments together) spread over `_spread`'s CTAs. The kernel splits
    the segments' true total evenly over them and cuts each CTA's part
    of a segment into tiles of at most `HIST_TILE_ROWS` rows."""
    fpb = _feature_tile(num_features, num_bins, precision, smem_optin, 4)
    return fpb, _spread(rows, num_bins, num_sms, ctas_per_sm,
                        -(-num_features // fpb))


def _device(ordinal: int, name: str = "histogram") -> Tuple[int, int]:
    """(SMs, dynamic shared bytes a CTA of library ``name``'s kernels may
    take: the opt-in less their static shared memory) of device
    ``ordinal``; the first call lets the kernels take them there."""
    st = _devices.get((name, ordinal))
    if st is None:
        with torch.cuda.device(ordinal):
            optin = _lib(name)["setup"](ordinal)
        if optin < 0:
            raise RuntimeError(f"{name} kernel set-up failed on device "
                               f"{ordinal}")
        st = (torch.cuda.get_device_properties(ordinal).multi_processor_count,
              optin)
        _devices[(name, ordinal)] = st
    return st


def hist_ctas_per_sm(ordinal: int, precision: str, smem: int,
                     name: str = "histogram") -> int:
    """CTAs of library ``name``'s ``precision`` kernel with ``smem``
    shared bytes each that the CUDA occupancy calculator fits on an SM of
    device ``ordinal``."""
    _device(ordinal, name)
    with torch.cuda.device(ordinal):
        n = _lib(name)["occupancy"](_KIND_INDEX[precision], smem)
    if n < 0:
        raise RuntimeError(f"{name} kernel: the CUDA occupancy query "
                           "failed")
    return n


def _shape_state(ordinal: int, num_features: int, num_bins: int,
                 precision: str, name: str = "histogram"
                 ) -> Tuple[int, int, int, int]:
    """(SMs, dynamic shared bytes a CTA may take, CTAs an SM, shared bytes
    a CTA) of library ``name``'s ``precision`` kernel at ``num_features``
    x ``num_bins`` on device ``ordinal``, queried once."""
    key = (name, ordinal, num_features, num_bins, precision)
    st = _shapes.get(key)
    if st is None:
        num_sms, optin = _device(ordinal, name)
        shape = launch_shape if name == "histogram" else words_launch_shape
        fpb = shape(1, num_features, num_bins, precision, num_sms, optin)[0]
        smem = hist_smem(fpb, num_bins, precision)
        st = (num_sms, optin,
              hist_ctas_per_sm(ordinal, precision, smem, name), smem)
        _shapes[key] = st
    return st


def _scratch_for(dev: torch.device, ordinal: int, stream: int, cells: int,
                 tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zeroed scratch of B1's and B5's calls on ``stream``, for at
    least ``cells`` cells and ``tiles`` tickets: f64 sums [cells, 2], and
    int32 counts [cells] followed by the tickets."""
    key = (ordinal, stream)
    s = _scratch.get(key)
    have = (0, 0) if s is None else (s[0].numel() // 2,
                                     s[1].numel() - s[0].numel() // 2)
    if have[0] < cells or have[1] < tiles:
        cells, tiles = max(cells, have[0]), max(tiles, have[1])
        s = (torch.zeros(2 * cells, dtype=torch.float64, device=dev),
             torch.zeros(cells + tiles, dtype=torch.int32, device=dev))
        _scratch[key] = s
    return s


def _histogram_cuda(bins, gh, indices, begin, count, num_bins, precision,
                    ctas: Optional[int] = None):
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 \
            or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous uint8 [N, F] tensor")
    if gh.dtype in _INT_KINDS:
        precision = _INT_KINDS[gh.dtype]
    elif gh.dtype != torch.float32:
        raise ValueError("gh must be f32, int8 or int16")
    if gh.shape != (bins.shape[0], 2) or not gh.is_contiguous() \
            or gh.device != dev:
        raise ValueError("gh must be a contiguous [N, 2] tensor on the "
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
    dtype = _DTYPES.get(precision, torch.float32)
    if count == 0 or f == 0:
        return torch.zeros((f, num_bins, NUM_HIST_STATS), dtype=dtype,
                           device=dev)
    fn = _lib()[precision]
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    num_sms, optin, ctas_per_sm, smem = _shape_state(ordinal, f, num_bins,
                                                     precision)
    fpb, grid_x, tile_rows = launch_shape(count, f, num_bins, precision,
                                          num_sms, optin, ctas_per_sm)
    if ctas is not None:
        # a grid of the caller's (tests: one CTA over many tiles)
        grid_x = max(1, min(int(ctas), -(-count // tile_rows)))
    words = int(f % 4 == 0 and fpb % 4 == 0 and bins.data_ptr() % 4 == 0)
    out = torch.empty((f, num_bins, NUM_HIST_STATS), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sums, cnt = _scratch_for(dev, ordinal, stream, f * num_bins,
                                 -(-f // fpb))
        err = fn(bins.data_ptr(), f, gh.data_ptr(),
                 None if indices is None else indices.data_ptr(),
                 int(begin), int(count), int(num_bins), fpb, tile_rows,
                 grid_x, words, smem, sums.data_ptr(), cnt.data_ptr(),
                 cnt.data_ptr() + 4 * (sums.numel() // 2), out.data_ptr(),
                 stream)
    if err != 0:
        _scratch.pop((ordinal, stream), None)
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err} (CTAs={grid_x}, features/tile={fpb}, "
                           f"rows/tile={tile_rows}, bins={num_bins}, "
                           f"{precision})")
    (INT_LAUNCHES if precision in INT_LAUNCHES else LAUNCHES)[precision] += 1
    return out


def leaf_histogram(bins: torch.Tensor, gh: torch.Tensor,
                   indices: Optional[torch.Tensor], begin: int, count: int,
                   num_bins: int, precision: str = "f32") -> torch.Tensor:
    """Histogram of one leaf: the rows ``indices[begin:begin + count]`` of
    ``bins`` [N, F] uint8 and ``gh`` [N, 2] f32, or the contiguous rows
    ``[begin, begin + count)`` when ``indices`` is None (the identity root
    partition). Returns [F, num_bins, 3] in f32 (``"f32"``) or f64
    (``"f64"``). An int8/int16 ``gh`` (`quantize_gh`) takes the integer
    branch whatever ``precision`` says: the exact integer sums, each
    rounded to f32 once."""
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


def _histogram_words_cuda(words, g, h, seg_begin, seg_cnt, num_features,
                          num_bins, rows_hint, precision):
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
    out = torch.empty((nseg, num_features, num_bins, NUM_HIST_STATS),
                      dtype=torch.float32, device=dev)
    if nseg == 0 or num_features == 0:
        return out
    lib = "histogram_words"
    fn = _lib(lib)[precision]
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    num_sms, optin, ctas_per_sm, smem = _shape_state(
        ordinal, num_features, num_bins, precision, lib)
    fpb, grid_x = words_launch_shape(rows_hint, num_features, num_bins,
                                     precision, num_sms, optin, ctas_per_sm)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sums, cnt = _scratch_for(dev, ordinal, stream,
                                 nseg * num_features * num_bins,
                                 nseg * -(-num_features // fpb))
        err = fn(words.data_ptr(), n, g.data_ptr(), h.data_ptr(),
                 seg_begin.data_ptr(), seg_cnt.data_ptr(), nseg,
                 num_features, num_bins, fpb, grid_x, smem, sums.data_ptr(),
                 cnt.data_ptr(), cnt.data_ptr() + 4 * (sums.numel() // 2),
                 out.data_ptr(), stream)
    if err != 0:
        _scratch.pop((ordinal, stream), None)
        raise RuntimeError(f"histogram_words kernel launch failed: CUDA "
                           f"error {err} (CTAs={grid_x}, features/tile="
                           f"{fpb}, bins={num_bins}, segments={nseg}, "
                           f"{precision})")
    WORDS_LAUNCHES[precision] += 1
    return out


def histogram_from_words(words: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor, seg_begin: torch.Tensor,
                         seg_cnt: torch.Tensor, num_features: int,
                         num_bins: int, rows_hint: Optional[int] = None,
                         precision: str = "f32") -> torch.Tensor:
    """hist[S, F, num_bins, 3] f32 of S contiguous row segments
    ``[seg_begin[s], seg_begin[s] + seg_cnt[s])`` over packed bin words
    (JAX package: `histogram_from_words`, one call per segment). ``words``
    is int32 [ceil(F/4), N], feature ``4w + j`` in bits ``8j..8j+7`` of
    word ``w``; ``g``/``h`` f32 [N]; the segment table int32 [S] on the
    same device. ``rows_hint`` (the total rows, if the caller knows it)
    sizes the kernel's grid without a read from the card; the kernel
    splits the true total itself. ``precision`` is the level builder's
    ``hist_precision``: ``"f32"`` (fixed-point cells on the card) or
    ``"f64"`` (f64 sums on the card); the CPU twin is exact in both."""
    if precision not in _DTYPES:
        raise ValueError(f"precision must be f32 or f64, got {precision!r}")
    if not words.is_cuda:
        return histogram_words_plain(words, g, h, seg_begin, seg_cnt,
                                     num_features, num_bins)
    if rows_hint is None:
        rows_hint = int(seg_cnt.sum())
    return _histogram_words_cuda(words, g, h, seg_begin, seg_cnt,
                                 num_features, num_bins, rows_hint,
                                 precision)
