"""Binned dataset container (port of lightgbm_tpu/io/dataset.py: dense
and scipy CSR/CSC input, exclusive feature bundling).

Bin finding runs on the host exactly as in the JAX package (the same
sample draw, the same `BinMapper`s), so both packages bin a matrix to the
same bins. A dense matrix's full ingest, value -> bin for every row, runs
on the device as one `torch.searchsorted` per feature; a sparse matrix is
binned from each column's nonzeros on the host, which are scattered over
the column's zero bin on the device (no dense float copy is made).
The binned matrix lives there as ``uint8 [N, F]``, or, once bundled
(`io/bundling.py`), as ``uint8 [N, G]`` storage columns: ``num_features``
counts the features, ``num_storage_cols`` the columns. Streaming ingest
and the binary dataset file are later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper)
from .bundling import BundleInfo, apply_bundles, plan_bundles

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
    bins : torch.Tensor uint8 [num_data, num_storage_cols] on ``device``:
        a column a used feature, or a bundle's storage column
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
        host, are scattered over its zero bin in the uint8 matrix on the
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
        if any(self.mappers[j].num_bin > 256 for j in used):
            raise NotImplementedError(
                "more than 256 bins per feature (uint16 bins) is not "
                "ported yet")
        # each column's zero bin, then its nonzeros' bins (found on the
        # host) scattered over it on the device, a block of columns at a
        # time as flat positions row * F + column
        nf = len(used)
        bins = torch.zeros((n, nf), dtype=torch.uint8, device=self.device)
        flat = bins.view(-1)
        pos, vals, held = [], [], 0

        def scatter():
            if pos:
                flat[torch.as_tensor(np.concatenate(pos)).to(
                    self.device)] = torch.as_tensor(
                        np.concatenate(vals)).to(self.device)
            pos.clear()
            vals.clear()

        for col_idx, j in enumerate(used):
            m = self.mappers[j]
            zero_bin = int(m.values_to_bins(np.zeros(1))[0])
            if zero_bin:
                scatter()
                bins[:, col_idx] = zero_bin
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            if hi > lo:
                nz_bins = m.values_to_bins(
                    np.asarray(csc.data[lo:hi], np.float64))
                pos.append(csc.indices[lo:hi].astype(np.int64) * nf + col_idx)
                vals.append(nz_bins.astype(np.uint8))
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
