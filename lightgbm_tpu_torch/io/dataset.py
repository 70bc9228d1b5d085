"""Binned dataset container (port of lightgbm_tpu/io/dataset.py: dense
and scipy CSR/CSC input, exclusive feature bundling, row subsets and the
binary dataset file).

Bin finding runs on the host exactly as in the JAX package (the same
sample draw, the same `BinMapper`s), so both packages bin a matrix to the
same bins. A dense matrix's full ingest, value -> bin for every row, runs
on the device as one `torch.searchsorted` per feature; a sparse matrix is
binned from each column's nonzeros on the host, which are scattered over
the column's zero bin on the device (no dense float copy is made).
The binned matrix lives there as ``uint8 [N, F]`` while every used
feature has at most 256 bins, else as ``uint16 [N, F]`` (the JAX
package's rule; `ops/bins.py` says how torch reads it), or, once bundled
(`io/bundling.py`, uint8 only), as ``uint8 [N, G]`` storage columns:
``num_features`` counts the features, ``num_storage_cols`` the columns.
`save_binary` writes the JAX package's binary dataset file byte for
byte, and `load_binary` reads a file of either package. On the CPU the
native binner (`native.py`) bins a dense matrix, as in the JAX package.
The push-rows flow (`create_from_sample`, `push_rows` /
`push_binned_rows`, `finish_load`) builds a dataset a chunk at a time for
two-round and streamed loading (`io/loader.py`, `io/stream.py`).
"""
from __future__ import annotations

import json
import struct
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops.bins import bins_dtype, storage_view, to_storage
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper, sample_indices)
from .bundling import BundleInfo, apply_bundles, plan_bundles

_BINARY_MAGIC = b"tpu_gbdt_dataset_v1\n"
_MISSING_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}
_BINTYPE_CODE = {BIN_NUMERICAL: 0, BIN_CATEGORICAL: 1}

# rows uploaded per chunk during the device ingest (bounds the f64 copy
# of one chunk on the device)
_INGEST_ROWS = 1 << 21
# objectives that renew leaf outputs after a tree grows: the JAX package
# never bundles for them
_RENEW_OBJECTIVES = {"regression_l1", "l1", "mae", "huber", "fair",
                     "quantile", "mape", "poisson", "gamma", "tweedie"}


class Metadata:
    """Labels, weights, query boundaries, init scores
    (reference `src/io/metadata.cpp`, `dataset.h:40-249`)."""

    def __init__(self, num_data: int) -> None:
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        arr = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(
                f"label length {len(arr)} != num_data {self.num_data}")
        self.label = arr

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        arr = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(
                f"weight length {len(arr)} != num_data {self.num_data}")
        self.weight = arr

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """Accepts group sizes (LightGBM convention) or query boundaries."""
        if group is None:
            self.query_boundaries = None
            return
        arr = np.asarray(group, dtype=np.int64).reshape(-1)
        if arr.sum() == self.num_data:
            self.query_boundaries = np.concatenate(
                [[0], np.cumsum(arr)]).astype(np.int64)
        elif len(arr) > 0 and arr[0] == 0 and arr[-1] == self.num_data:
            self.query_boundaries = arr
        else:
            raise ValueError("group sizes do not sum to num_data")

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        arr = np.asarray(init_score, dtype=np.float64).reshape(-1)
        if len(arr) % self.num_data != 0:
            raise ValueError("init_score length must be a multiple of num_data")
        self.init_score = arr


def _cat_set_from(cfg: Config, categorical_feature) -> set:
    """Union of the categorical_feature argument and the config string."""
    cat_set = set(int(c) for c in (categorical_feature or []))
    if cfg.categorical_feature:
        for tok in str(cfg.categorical_feature).split(","):
            tok = tok.strip()
            if tok.startswith("name:"):
                continue
            if tok:
                cat_set.add(int(tok))
    return cat_set


def values_to_bins_torch(mapper: BinMapper, col: torch.Tensor) -> torch.Tensor:
    """`BinMapper.values_to_bins` for a numerical feature, on the tensor's
    device: ``col`` is f64, the result int64 bins (the same first-bound-
    >=-value rule as the host `np.searchsorted(side="left")`)."""
    nan_mask = torch.isnan(col)
    v = torch.where(nan_mask, torch.zeros_like(col), col)
    r = mapper.num_bin - 1
    if mapper.missing_type == MISSING_NAN:
        r -= 1
    bounds = torch.as_tensor(mapper.bin_upper_bound[:r], dtype=torch.float64,
                             device=col.device)
    out = torch.searchsorted(bounds, v, right=False)
    if mapper.missing_type == MISSING_NAN:
        out = torch.where(nan_mask, torch.full_like(out, mapper.num_bin - 1),
                          out)
    return out


class Dataset:
    """Binned dataset (reference `Dataset`, `dataset.h:250+`).

    Attributes
    ----------
    bins : torch.Tensor uint8 or uint16 [num_data, num_storage_cols] on
        ``device``: a column a used feature, or a bundle's storage column
    bundles : BundleInfo or None
        the bundling of the used features (`io/bundling.py`)
    mappers : list[BinMapper]
        One per ORIGINAL feature column (trivial features have
        ``is_trivial=True`` and no column in ``bins``).
    used_feature_map : np.ndarray int32 [num_total_features]
        original feature -> column in bins, or -1 if unused.
    """

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bins: Optional[torch.Tensor] = None
        self.bundles: Optional[BundleInfo] = None
        self.device = torch.device("cpu")
        self.mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.zeros(0, dtype=np.int32)
        self.real_feature_idx: np.ndarray = np.zeros(0, dtype=np.int32)
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.max_bin: int = 255
        self.min_data_in_bin: int = 3
        self.use_missing: bool = True
        self.zero_as_missing: bool = False
        # the init scores are an init model's raw predictions (the CLI's
        # continued training; `engine._seed_from_model`)
        self.init_score_from_model: bool = False
        self.monotone_constraints: np.ndarray = np.zeros(0, dtype=np.int8)
        self.feature_penalty: np.ndarray = np.zeros(0, dtype=np.float64)

    @property
    def num_features(self) -> int:
        """Number of used (non-trivial) features (the JAX package counts
        the storage columns here, which hides every feature of index G or
        more once the bins are bundled)."""
        return 0 if self.bins is None else len(self.real_feature_idx)

    @property
    def num_storage_cols(self) -> int:
        """Columns of ``bins``: the features, or the bundles' storage
        columns."""
        return 0 if self.bins is None else int(self.bins.shape[1])

    def used_mappers(self) -> List[BinMapper]:
        return [self.mappers[i] for i in self.real_feature_idx]

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, data: np.ndarray, label: Optional[Sequence] = None,
                    config: Optional[Config] = None,
                    weight: Optional[Sequence] = None,
                    group: Optional[Sequence[int]] = None,
                    init_score: Optional[Sequence] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Optional[Sequence[int]] = None,
                    reference: Optional["Dataset"] = None,
                    device: Optional[torch.device] = None) -> "Dataset":
        """Bin a dense float matrix (the analogue of
        `LGBM_DatasetCreateFromMat`, `dataset_loader.cpp:535`). With
        `reference`, reuse its bin mappers so validation data aligns with
        the training set."""
        cfg = config or Config()
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        if data.ndim != 2:
            raise ValueError("data must be 2-D")
        self = cls._empty(*data.shape, cfg, feature_names, reference,
                          device)
        if reference is None:
            self._find_bins(data, cfg, _cat_set_from(cfg, categorical_feature))
        self.bins = self._ingest(data)
        return self._finish(cfg, reference, label, weight, group, init_score)

    @classmethod
    def _empty(cls, n: int, f: int, cfg: Config, feature_names, reference,
               device) -> "Dataset":
        """A dataset of n rows of f columns before its bins: metadata,
        names and device, and with ``reference`` that set's bin mappers
        and feature arrays (a valid set aligns with its training set)."""
        self = cls()
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.num_data = n
        self.num_total_features = f
        self.metadata = Metadata(n)
        self.max_bin = cfg.max_bin
        self.min_data_in_bin = cfg.min_data_in_bin
        self.use_missing = cfg.use_missing
        self.zero_as_missing = cfg.zero_as_missing
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])
        if reference is not None:
            for attr in ("mappers", "used_feature_map", "real_feature_idx",
                         "max_bin", "monotone_constraints", "feature_penalty",
                         "feature_names"):
                setattr(self, attr, getattr(reference, attr))
        return self

    def _finish(self, cfg: Config, reference, label, weight, group,
                init_score) -> "Dataset":
        """Bundle the bins (`_maybe_bundle`) and set the metadata."""
        self._maybe_bundle(cfg, reference)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        return self

    def _find_bins(self, data: np.ndarray, cfg: Config, cat_set) -> None:
        """Per-feature BinMappers from a row sample (reference
        bin_construct_sample_cnt, dataset_loader.cpp:162+) — the JAX
        package's draw (`sample_indices`), so both packages, and the
        streamed route, find the same boundaries."""
        n = data.shape[0]
        sample_cnt = min(n, max(cfg.bin_construct_sample_cnt, 1))
        sample = data[sample_indices(n, sample_cnt, cfg.data_random_seed)] \
            if sample_cnt < n else data
        self._mappers_from_sample(sample, cfg, cat_set)

    def _mappers_from_sample(self, sample: np.ndarray, cfg: Config,
                             cat_set) -> None:
        """One BinMapper a column of the sample rows, then the used
        features."""
        f = sample.shape[1]
        self.mappers = []
        for j in range(f):
            col = np.asarray(sample[:, j], dtype=np.float64)
            # keep only non-zero entries; zeros are implied by count
            nonzero = col[~((col >= -1e-35) & (col <= 1e-35))]
            m = BinMapper()
            bt = BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL
            m.find_bin(nonzero, total_sample_cnt=len(col),
                       max_bin=cfg.max_bin,
                       min_data_in_bin=cfg.min_data_in_bin,
                       min_split_data=cfg.min_data_in_leaf,
                       bin_type=bt, use_missing=cfg.use_missing,
                       zero_as_missing=cfg.zero_as_missing)
            self.mappers.append(m)
        self._finalize_used_features(cfg, f)

    def _finalize_used_features(self, cfg: Config, f: int) -> None:
        """The used-feature map and the used features' monotone and
        penalty arrays, from the mappers."""
        self.used_feature_map = np.full(f, -1, dtype=np.int32)
        used = [j for j in range(f) if not self.mappers[j].is_trivial]
        for col_idx, j in enumerate(used):
            self.used_feature_map[j] = col_idx
        self.real_feature_idx = np.asarray(used, dtype=np.int32)
        mono = np.zeros(f, dtype=np.int8)
        for i, v in enumerate(cfg.monotone_constraints[:f]):
            mono[i] = np.int8(v)
        self.monotone_constraints = mono[self.real_feature_idx] \
            if used else np.zeros(0, dtype=np.int8)
        pen = np.ones(f, dtype=np.float64)
        for i, v in enumerate(cfg.feature_contri[:f]):
            pen[i] = float(v)
        self.feature_penalty = pen[self.real_feature_idx] \
            if used else np.zeros(0, dtype=np.float64)

    def _bins_dtype(self) -> torch.dtype:
        """The matrix's type by the JAX package's rule (uint16 past 256
        bins), warning as it does of categorical features whose bins the
        256-bin bitset cannot all reach."""
        used = self.real_feature_idx
        for j in used:
            m = self.mappers[j]
            if m.bin_type == BIN_CATEGORICAL and m.num_bin > 256:
                warnings.warn(
                    f"categorical feature {j} has {m.num_bin} bins; only the "
                    "256 most frequent categories are split candidates "
                    "(device bitset limit)")
        return bins_dtype(max((self.mappers[j].num_bin for j in used),
                              default=2))

    def _ingest(self, data: np.ndarray) -> torch.Tensor:
        """uint8 or uint16 [N, F_used] bins on the device (`_bin_into`)."""
        bins = torch.empty((self.num_data, len(self.real_feature_idx)),
                           dtype=self._bins_dtype(), device=self.device)
        self._bin_into(bins, 0, data)
        return bins

    def _bin_into(self, bins: torch.Tensor, pos: int,
                  data: np.ndarray) -> None:
        """Rows ``pos`` .. ``pos + len(data)`` of ``bins`` from raw rows
        [k, F_total]: on a CPU dataset by the native binner where the
        library builds (`_native_bin_matrix`, the JAX package's route);
        else numerical columns on the device, chunk by chunk, and
        categorical ones on the host (`BinMapper.values_to_bins`)."""
        used = self.real_feature_idx
        ms = [self.mappers[j] for j in used]
        dtype = bins.dtype
        k = data.shape[0]
        store = storage_view(bins)
        if self.device.type == "cpu" and len(used):
            host = self._native_bin_matrix(
                data, used, np.uint16 if dtype == torch.uint16 else np.uint8)
            if host is not None:
                store[pos:pos + k] = torch.from_numpy(
                    host.view(np.int16) if dtype == torch.uint16 else host)
                return
        for lo in range(0, k, _INGEST_ROWS):
            hi = min(k, lo + _INGEST_ROWS)
            chunk = torch.as_tensor(
                np.ascontiguousarray(data[lo:hi][:, used])).to(
                    self.device).to(torch.float64)
            for c, m in enumerate(ms):
                if m.bin_type == BIN_NUMERICAL:
                    vals = values_to_bins_torch(m, chunk[:, c])
                else:
                    vals = torch.as_tensor(m.values_to_bins(
                        np.asarray(data[lo:hi, used[c]], np.float64)),
                        device=self.device)
                store[pos + lo:pos + hi, c] = to_storage(vals, dtype)

    def _native_bin_matrix(self, data: np.ndarray, used: np.ndarray,
                           dtype) -> Optional[np.ndarray]:
        """The bins of the columns ``used`` through the native OpenMP
        binner (src/native/binning.cpp `lgbt_bin_matrix`; JAX package:
        `Dataset._native_bin_matrix`); None -> the torch route."""
        from ..native import bin_matrix, native_available
        if not native_available():
            return None
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        ms = [self.mappers[j] for j in used]
        bounds_list = [m.bin_upper_bound if m.bin_type == BIN_NUMERICAL
                       else np.zeros(0) for m in ms]
        cats_list, cat_bins_list = [], []
        for m in ms:
            if m.bin_type == BIN_CATEGORICAL and m.categorical_2_bin:
                ck = np.fromiter(m.categorical_2_bin.keys(), np.int64)
                cv = np.fromiter(m.categorical_2_bin.values(), np.int64)
                order = np.argsort(ck)
                cats_list.append(ck[order])
                cat_bins_list.append(cv[order].astype(np.int32))
            else:
                cats_list.append(np.zeros(0, np.int64))
                cat_bins_list.append(np.zeros(0, np.int32))

        def offsets(parts):
            return np.concatenate([[0], np.cumsum([len(p) for p in parts])]
                                  ).astype(np.int64)
        return bin_matrix(
            data, np.asarray(used, np.int32),
            np.asarray([_BINTYPE_CODE[m.bin_type] for m in ms], np.int32),
            np.asarray([_MISSING_CODE[m.missing_type] for m in ms],
                       np.int32),
            np.asarray([m.num_bin for m in ms], np.int32),
            np.concatenate(bounds_list), offsets(bounds_list),
            np.concatenate(cats_list), np.concatenate(cat_bins_list),
            offsets(cats_list), dtype)

    # ------------------------------------------------------------------
    # the push-rows flow (reference `LGBM_DatasetCreateFromSampledColumn`
    # + `PushRows` + `FinishLoad`, c_api.h:52-256; JAX package:
    # `Dataset.create_from_sample` ... `finish_load`)
    @classmethod
    def create_from_sample(cls, sample: Optional[np.ndarray], n_total: int,
                           config: Optional[Config] = None,
                           feature_names: Optional[List[str]] = None,
                           categorical_feature: Optional[Sequence[int]]
                           = None,
                           reference: Optional["Dataset"] = None,
                           device: Optional[torch.device] = None
                           ) -> "Dataset":
        """Step 1 of 3: the bin mappers from a row sample (all its rows;
        with ``reference``, that set's mappers and no sample), and the
        binned matrix of ``n_total`` rows on ``device``, which
        `push_rows` / `push_binned_rows` fill in row order."""
        cfg = config or Config()
        f = (reference.num_total_features if reference is not None
             else np.asarray(sample).shape[1])
        self = cls._empty(int(n_total), f, cfg, feature_names, reference,
                          device)
        if reference is None:
            self._mappers_from_sample(np.asarray(sample, np.float64), cfg,
                                      _cat_set_from(cfg, categorical_feature))
        self.bins = torch.zeros((self.num_data, len(self.real_feature_idx)),
                                dtype=self._bins_dtype(), device=self.device)
        self._push_cfg, self._push_ref = cfg, reference
        self._push_pos = 0
        self._push_label = self._push_weight = self._push_init = None
        return self

    def _push_meta(self, k: int, label, weight, init_score) -> int:
        """Advance the push cursor by ``k`` rows, keeping their label,
        weight and init score slices; returns the rows' first position."""
        if getattr(self, "_push_pos", None) is None:
            raise RuntimeError("pushing rows needs a dataset made by "
                               "create_from_sample")
        pos = self._push_pos
        if pos + k > self.num_data:
            raise ValueError(f"push overflow: {pos + k} > "
                             f"n_total={self.num_data}")
        for attr, vals, fill in (("_push_label", label, 0.0),
                                 ("_push_weight", weight, 1.0),
                                 ("_push_init", init_score, 0.0)):
            if vals is not None:
                if getattr(self, attr) is None:
                    setattr(self, attr, np.full(self.num_data, fill))
                getattr(self, attr)[pos:pos + k] = np.asarray(vals,
                                                              np.float64)
        self._push_pos = pos + k
        return pos

    def push_rows(self, data: np.ndarray, label=None, weight=None,
                  init_score=None) -> None:
        """Step 2: bin one chunk of raw rows [k, F_total] into the matrix
        (`_bin_into`: the native binner on a CPU dataset, the device
        otherwise), its metadata slices beside it (reference
        `Dataset::PushOneRow`)."""
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        pos = self._push_meta(data.shape[0], label, weight, init_score)
        self._bin_into(self.bins, pos, data)

    def push_binned_rows(self, binned, label=None, weight=None,
                         init_score=None) -> None:
        """Step 2, rows binned already ([k, F_used], a tensor in the
        matrix's type or its storage view, or a numpy array)."""
        binned = torch.as_tensor(binned)
        k = binned.shape[0]
        if binned.shape[1] != self.bins.shape[1]:
            raise ValueError(f"push_binned_rows width {binned.shape[1]} != "
                             f"{self.bins.shape[1]} used features")
        pos = self._push_meta(k, label, weight, init_score)
        store = storage_view(self.bins)
        store[pos:pos + k] = storage_view(binned).to(store.dtype)

    def finish_load(self, group=None) -> "Dataset":
        """Step 3 (reference `Dataset::FinishLoad`, dataset.cpp:330): check
        the row count, set the metadata and bundle (`_maybe_bundle`,
        which keeps ``num_features`` F apart from ``num_storage_cols``)."""
        if self._push_pos != self.num_data:
            raise ValueError(f"finish_load: {self._push_pos} rows pushed, "
                             f"{self.num_data} declared")
        cfg, ref = self._push_cfg, self._push_ref
        label, weight, init = (self._push_label, self._push_weight,
                               self._push_init)
        self._push_cfg = self._push_ref = self._push_pos = None
        self._push_label = self._push_weight = self._push_init = None
        return self._finish(cfg, ref, label, weight, group, init)

    # ------------------------------------------------------------------
    @classmethod
    def from_sparse(cls, data, label: Optional[Sequence] = None,
                    config: Optional[Config] = None,
                    weight: Optional[Sequence] = None,
                    group: Optional[Sequence[int]] = None,
                    init_score: Optional[Sequence] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Optional[Sequence[int]] = None,
                    reference: Optional["Dataset"] = None,
                    device: Optional[torch.device] = None) -> "Dataset":
        """Bin a scipy CSR/CSC matrix without a dense float copy (the
        reference's `LGBM_DatasetCreateFromCSR/CSC`; JAX package:
        `Dataset.from_sparse`): each column's bins are found from its
        nonzeros in the sample rows (zeros are implied by the count, as in
        the dense path), then each column's nonzero bins, found on the
        host, are scattered over its zero bin in the binned matrix on the
        device (the JAX package scatters on the host; the bytes are the
        same)."""
        cfg = config or Config()
        csc = data.tocsc()
        n, f = csc.shape
        self = cls._empty(n, f, cfg, feature_names, reference, device)
        cat_set = _cat_set_from(cfg, categorical_feature)
        if reference is None:
            rng = np.random.RandomState(cfg.data_random_seed)
            sample_cnt = min(n, max(cfg.bin_construct_sample_cnt, 1))
            in_sample = None
            if sample_cnt < n:
                # the JAX package's sample rows, as a row mask
                in_sample = np.zeros(n, bool)
                in_sample[rng.choice(n, sample_cnt, replace=False)] = True
            self.mappers = []
            for j in range(f):
                lo, hi = csc.indptr[j], csc.indptr[j + 1]
                vals = np.asarray(csc.data[lo:hi], np.float64)
                if in_sample is not None:
                    vals = vals[in_sample[csc.indices[lo:hi]]]
                vals = vals[~((vals >= -1e-35) & (vals <= 1e-35))]
                m = BinMapper()
                bt = BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL
                m.find_bin(vals, total_sample_cnt=sample_cnt,
                           max_bin=cfg.max_bin,
                           min_data_in_bin=cfg.min_data_in_bin,
                           min_split_data=cfg.min_data_in_leaf,
                           bin_type=bt, use_missing=cfg.use_missing,
                           zero_as_missing=cfg.zero_as_missing)
                self.mappers.append(m)
            self._finalize_used_features(cfg, f)
        used = self.real_feature_idx
        dtype = self._bins_dtype()
        # each column's zero bin, then its nonzeros' bins (found on the
        # host) scattered over it on the device, a block of columns at a
        # time as flat positions row * F + column
        nf = len(used)
        bins = torch.zeros((n, nf), dtype=dtype, device=self.device)
        store = storage_view(bins)
        flat = store.view(-1)
        pos, vals, held = [], [], 0

        def scatter():
            if pos:
                flat[torch.as_tensor(np.concatenate(pos)).to(
                    self.device)] = to_storage(torch.as_tensor(
                        np.concatenate(vals)).to(self.device), dtype)
            pos.clear()
            vals.clear()

        for col_idx, j in enumerate(used):
            m = self.mappers[j]
            zero_bin = int(m.values_to_bins(np.zeros(1))[0])
            if zero_bin:
                scatter()
                store[:, col_idx] = to_storage(
                    torch.tensor(zero_bin, device=self.device), dtype)
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            if hi > lo:
                nz_bins = m.values_to_bins(
                    np.asarray(csc.data[lo:hi], np.float64))
                pos.append(csc.indices[lo:hi].astype(np.int64) * nf + col_idx)
                vals.append(nz_bins.astype(np.int32))
                held += hi - lo
                if held >= _INGEST_ROWS * 8:
                    scatter()
                    held = 0
        scatter()
        self.bins = bins
        return self._finish(cfg, reference, label, weight, group, init_score)

    def _maybe_bundle(self, cfg: Config,
                      reference: Optional["Dataset"]) -> None:
        """Exclusive Feature Bundling (reference dataset.cpp:68-213; JAX
        package: `Dataset._maybe_bundle`, with its gates in its order): a
        valid set built with ``reference`` takes the training set's
        bundling; a training set bundles when bundling is on, the bins
        are uint8 and there are at least 3 features, the learner is
        serial, boosting is gbdt or goss, the objective does not renew
        leaf outputs, no lazy CEGB penalty needs the host learner, no
        feature is categorical, and the plan leaves at most 0.75 F
        columns."""
        used = self.real_feature_idx
        db = np.asarray([self.mappers[j].default_bin for j in used],
                        np.int32)
        if reference is not None:
            self.bundles = reference.bundles
            if self.bundles is not None:
                self.bins = apply_bundles(self.bins, self.bundles, db)
            return
        self.bundles = None
        if (not cfg.enable_bundle or self.bins is None
                or self.bins.dtype != torch.uint8 or self.num_features < 3
                or cfg.tree_learner != "serial"
                or str(cfg.boosting) not in ("gbdt", "goss")
                or str(cfg.objective) in _RENEW_OBJECTIVES
                or cfg.forces_host_learner):
            return
        if any(self.mappers[j].bin_type == BIN_CATEGORICAL for j in used):
            return
        nb = np.asarray([self.mappers[j].num_bin for j in used], np.int32)
        info = plan_bundles(self.bins, nb, db, float(cfg.max_conflict_rate),
                            seed=cfg.data_random_seed)
        if info is None or info.num_groups > 0.75 * self.num_features:
            return
        self.bundles = info
        self.bins = apply_bundles(self.bins, info, db)

    # ------------------------------------------------------------------
    def subset(self, row_indices) -> "Dataset":
        """Row subset sharing the bin mappers (reference
        `Dataset::CopySubset`, used by `cv`'s folds; JAX package:
        `Dataset.subset`): one gather of the device bins. Query
        boundaries do not survive an arbitrary subset, as there."""
        idx = np.asarray(row_indices, dtype=np.int64)
        out = Dataset()
        out.device = self.device
        out.num_data = len(idx)
        for attr in ("num_total_features", "bundles", "mappers",
                     "used_feature_map", "real_feature_idx", "feature_names",
                     "max_bin", "min_data_in_bin", "use_missing",
                     "zero_as_missing", "init_score_from_model",
                     "monotone_constraints", "feature_penalty"):
            setattr(out, attr, getattr(self, attr))
        if self.bins is not None:
            rows = torch.as_tensor(idx, device=self.device)
            out.bins = storage_view(self.bins)[rows].view(self.bins.dtype)
        out.metadata = Metadata(len(idx))
        md = self.metadata
        if md.label is not None:
            out.metadata.label = md.label[idx]
        if md.weight is not None:
            out.metadata.weight = md.weight[idx]
        if md.init_score is not None:
            ns = len(md.init_score) // self.num_data
            out.metadata.init_score = md.init_score.reshape(
                ns, self.num_data)[:, idx].reshape(-1)
        return out

    # ------------------------------------------------------------------
    # binary serialization (reference Dataset::SaveBinaryFile /
    # DatasetLoader::LoadFromBinFile): the JAX package's format, the
    # magic, a length-prefixed JSON header with its keys in its order,
    # then the arrays as `np.save` writes them
    def _host_bins(self) -> np.ndarray:
        host = storage_view(self.bins).cpu().numpy()
        return host.view(np.uint16) if self.bins.dtype == torch.uint16 \
            else host

    def save_binary(self, path: str) -> None:
        bins = None if self.bins is None else self._host_bins()
        header = {
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "max_bin": self.max_bin,
            "min_data_in_bin": self.min_data_in_bin,
            "use_missing": self.use_missing,
            "zero_as_missing": self.zero_as_missing,
            "feature_names": self.feature_names,
            "used_feature_map": self.used_feature_map.tolist(),
            "real_feature_idx": self.real_feature_idx.tolist(),
            "monotone": self.monotone_constraints.tolist(),
            "penalty": self.feature_penalty.tolist(),
            "mappers": [m.to_dict() for m in self.mappers],
            "bins_dtype": str(bins.dtype) if bins is not None else "",
            "bundles": (None if self.bundles is None else {
                "num_groups": int(self.bundles.num_groups),
                "col": self.bundles.col.tolist(),
                "off": self.bundles.off.tolist(),
                "packed": self.bundles.packed.tolist(),
                "group_num_bin": self.bundles.group_num_bin.tolist(),
            }),
            "has_label": self.metadata.label is not None,
            "has_weight": self.metadata.weight is not None,
            "has_query": self.metadata.query_boundaries is not None,
            "has_init_score": self.metadata.init_score is not None,
        }
        from .file_io import open_file
        with open_file(path, "wb") as fh:
            fh.write(_BINARY_MAGIC)
            hb = json.dumps(header).encode()
            fh.write(struct.pack("<q", len(hb)))
            fh.write(hb)
            if bins is not None:
                np.save(fh, bins, allow_pickle=False)
            for arr in (self.metadata.label, self.metadata.weight,
                        self.metadata.query_boundaries,
                        self.metadata.init_score):
                if arr is not None:
                    np.save(fh, arr, allow_pickle=False)

    @classmethod
    def load_binary(cls, path: str,
                    device: Optional[torch.device] = None) -> "Dataset":
        """A binary dataset file of either package, its bins on
        ``device`` (the CPU by default)."""
        from .file_io import open_file
        with open_file(path, "rb") as fh:
            if fh.read(len(_BINARY_MAGIC)) != _BINARY_MAGIC:
                raise ValueError(f"{path} is not a tpu_gbdt binary dataset")
            (hlen,) = struct.unpack("<q", fh.read(8))
            header = json.loads(fh.read(hlen).decode())
            self = cls()
            self.device = torch.device(device) if device is not None \
                else torch.device("cpu")
            for key in ("num_data", "num_total_features", "max_bin",
                        "min_data_in_bin", "use_missing", "zero_as_missing",
                        "feature_names"):
                setattr(self, key, header[key])
            self.used_feature_map = np.asarray(header["used_feature_map"],
                                               dtype=np.int32)
            self.real_feature_idx = np.asarray(header["real_feature_idx"],
                                               dtype=np.int32)
            self.monotone_constraints = np.asarray(header["monotone"],
                                                   dtype=np.int8)
            self.feature_penalty = np.asarray(header["penalty"])
            self.mappers = [BinMapper.from_dict(d) for d in header["mappers"]]
            bd = header.get("bundles")
            if bd is not None:
                self.bundles = BundleInfo(
                    num_groups=int(bd["num_groups"]),
                    col=np.asarray(bd["col"], np.int32),
                    off=np.asarray(bd["off"], np.int32),
                    packed=np.asarray(bd["packed"], bool),
                    group_num_bin=np.asarray(bd["group_num_bin"], np.int32))
            self.metadata = Metadata(self.num_data)
            if header["bins_dtype"]:
                host = np.load(fh, allow_pickle=False)
                wide = host.dtype == np.uint16
                self.bins = torch.from_numpy(
                    host.view(np.int16) if wide else host).to(self.device)
                if wide:
                    self.bins = self.bins.view(torch.uint16)
            md = self.metadata
            if header["has_label"]:
                md.label = np.load(fh, allow_pickle=False)
            if header["has_weight"]:
                md.weight = np.load(fh, allow_pickle=False)
            if header["has_query"]:
                md.query_boundaries = np.load(fh, allow_pickle=False)
            if header["has_init_score"]:
                md.init_score = np.load(fh, allow_pickle=False)
        return self

    # ------------------------------------------------------------------
    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Per-used-feature metadata arrays consumed by the split finder
        (`ops/split.py`); the same arrays as the JAX package's."""
        ms = self.used_mappers()
        fcount = len(ms)
        num_bin = np.asarray([m.num_bin for m in ms], dtype=np.int32)
        default_bin = np.asarray([m.default_bin for m in ms], dtype=np.int32)
        missing = np.asarray([_MISSING_CODE[m.missing_type] for m in ms],
                             dtype=np.int32)
        bin_type = np.asarray([_BINTYPE_CODE[m.bin_type] for m in ms],
                              dtype=np.int32)
        mono = (self.monotone_constraints.astype(np.int32)
                if len(self.monotone_constraints) == fcount
                else np.zeros(fcount, dtype=np.int32))
        penalty = (self.feature_penalty.astype(np.float32)
                   if len(self.feature_penalty) == fcount
                   else np.ones(fcount, dtype=np.float32))
        return {
            "num_bin": num_bin,
            "default_bin": default_bin,
            "missing_type": missing,
            "bin_type": bin_type,
            "monotone": mono,
            "penalty": penalty,
        }
