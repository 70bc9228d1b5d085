"""Binned dataset container (port of lightgbm_tpu/io/dataset.py, dense
input only).

Bin finding runs on the host exactly as in the JAX package (the same
sample draw, the same `BinMapper`s), so both packages bin a matrix to the
same bins. The full ingest, value -> bin for every row, runs on the
device as one `torch.searchsorted` per feature, and the binned matrix
lives there as ``uint8 [N, F]``. Sparse input, EFB bundling and streaming
ingest are later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper)

_MISSING_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}
_BINTYPE_CODE = {BIN_NUMERICAL: 0, BIN_CATEGORICAL: 1}

# rows uploaded per chunk during the device ingest (bounds the f64 copy
# of one chunk on the device)
_INGEST_ROWS = 1 << 21


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
    bins : torch.Tensor uint8 [num_data, num_used_features] on ``device``
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
        self.device = torch.device("cpu")
        self.mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.zeros(0, dtype=np.int32)
        self.real_feature_idx: np.ndarray = np.zeros(0, dtype=np.int32)
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.max_bin: int = 255
        self.monotone_constraints: np.ndarray = np.zeros(0, dtype=np.int8)
        self.feature_penalty: np.ndarray = np.zeros(0, dtype=np.float64)

    @property
    def num_features(self) -> int:
        """Number of used (non-trivial) features."""
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
        n, f = data.shape
        self = cls()
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.num_data = n
        self.num_total_features = f
        self.metadata = Metadata(n)
        self.max_bin = cfg.max_bin
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])
        if reference is not None:
            for attr in ("mappers", "used_feature_map", "real_feature_idx",
                         "max_bin", "monotone_constraints", "feature_penalty",
                         "feature_names"):
                setattr(self, attr, getattr(reference, attr))
        else:
            self._find_bins(data, cfg, _cat_set_from(cfg, categorical_feature))
        self.bins = self._ingest(data)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        return self

    def _find_bins(self, data: np.ndarray, cfg: Config, cat_set) -> None:
        """Per-feature BinMappers from a row sample (reference
        bin_construct_sample_cnt, dataset_loader.cpp:162+) — the JAX
        package's draw, so both packages find the same boundaries."""
        n, f = data.shape
        rng = np.random.RandomState(cfg.data_random_seed)
        sample_cnt = min(n, max(cfg.bin_construct_sample_cnt, 1))
        if sample_cnt < n:
            sample = data[np.sort(rng.choice(n, sample_cnt, replace=False))]
        else:
            sample = data
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

    def _ingest(self, data: np.ndarray) -> torch.Tensor:
        """uint8 [N, F_used] bins on the device. Numerical columns bin on
        the device, chunk by chunk; categorical columns bin on the host
        (`BinMapper.values_to_bins`)."""
        used = self.real_feature_idx
        ms = [self.mappers[j] for j in used]
        if any(m.num_bin > 256 for m in ms):
            raise NotImplementedError(
                "more than 256 bins per feature (uint16 bins) is not "
                "ported yet")
        n = self.num_data
        bins = torch.empty((n, len(used)), dtype=torch.uint8,
                           device=self.device)
        for lo in range(0, n, _INGEST_ROWS):
            hi = min(n, lo + _INGEST_ROWS)
            chunk = torch.as_tensor(
                np.ascontiguousarray(data[lo:hi][:, used])).to(
                    self.device).to(torch.float64)
            for c, m in enumerate(ms):
                if m.bin_type == BIN_NUMERICAL:
                    bins[lo:hi, c] = values_to_bins_torch(m, chunk[:, c]).to(
                        torch.uint8)
                else:
                    host = m.values_to_bins(
                        np.asarray(data[lo:hi, used[c]], np.float64))
                    bins[lo:hi, c] = torch.as_tensor(host.astype(np.uint8),
                                                     device=self.device)
        return bins

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
