"""DatasetLoader: text / binary file -> binned `Dataset` (port of
lightgbm_tpu/io/loader.py, its Python path).

Re-creates `src/io/dataset_loader.cpp`: `LoadFromFile` (`:162`) with
header handling + label/weight/group/ignore column extraction
(`SetHeader` `:25-140`), sidecar metadata files ``<data>.weight`` /
``<data>.query`` / ``<data>.init`` (`src/io/metadata.cpp:376,400`),
validation-set alignment against a reference dataset
(`LoadFromFileAlignWithOtherDataset` `:224`), and the binary-file fast
path (`LoadFromBinFile` `:268` -> `Dataset.load_binary`). Text is parsed
on the host (`io/parser.py`) and binned on the device (`io/dataset.py`).
The JAX package's native C++ parser, two-round loading, streamed chunks
and columnar files are not ported: those options raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, resolve_device
from .dataset import Dataset
from .file_io import exists as vf_exists
from .file_io import open_file
from .parser import create_parser, parse_dense

# columnar front-door extensions of the JAX package's pyarrow reader
_COLUMNAR_EXTS = (".parquet", ".arrow", ".feather", ".ipc")


def _parse_column_spec(spec: str, names: Optional[List[str]]) -> List[int]:
    """``"0,1,2"`` or ``"name:a,b"`` -> column indices (feature space)."""
    spec = str(spec).strip()
    if not spec:
        return []
    if spec.startswith("name:"):
        if not names:
            raise ValueError(
                f"column spec '{spec}' needs a file header with column names")
        want = [s.strip() for s in spec[5:].split(",") if s.strip()]
        out = []
        for w in want:
            if w not in names:
                raise ValueError(f"column name '{w}' not found in header")
            out.append(names.index(w))
        return out
    return [int(s) for s in spec.split(",") if s.strip()]


def _split_header_line(header_line: str) -> List[str]:
    for sep in ("\t", ",", " "):
        if sep in header_line:
            return [s.strip() for s in header_line.split(sep)]
    return [header_line.strip()]


def _read_sidecar(path: str) -> Optional[np.ndarray]:
    if not vf_exists(path):
        return None
    with open_file(path) as f:
        vals = [float(x) for x in f.read().split()]
    return np.asarray(vals, dtype=np.float64)


class DatasetLoader:
    """Host-side loader (reference `DatasetLoader`, `dataset_loader.h:24-86`)
    whose datasets bin onto ``device`` (the config's, `resolve_device`,
    when not given)."""

    def __init__(self, config: Optional[Config] = None,
                 predict_fun=None,
                 device: Optional[torch.device] = None) -> None:
        self.config = config or Config()
        # prior-model predictor hook for continued training: raw scores of
        # the loaded rows become init scores (reference
        # `dataset_loader.h:66-67`, `application.cpp:90-93`)
        self.predict_fun = predict_fun
        self.device = device

    def _device(self) -> torch.device:
        if self.device is None:
            self.device = resolve_device(self.config)
        return self.device

    def _check_ported(self, filename: str) -> None:
        cfg = self.config
        if str(filename).endswith(_COLUMNAR_EXTS):
            raise NotImplementedError(
                f"{filename}: columnar files (the JAX package's pyarrow "
                "reader) are not ported yet (ROADMAP A.4, A.7)")
        if int(cfg.tpu_stream_chunk_rows) > 0:
            raise NotImplementedError(
                "tpu_stream_chunk_rows: streamed ingest is not ported yet "
                "(ROADMAP A.4, A.7)")
        if cfg.two_round:
            raise NotImplementedError(
                "two_round: two-round loading is not ported yet "
                "(ROADMAP A.4)")

    # ------------------------------------------------------------------
    def _read_text(self, filename: str) -> Tuple[Optional[str], List[str]]:
        if not vf_exists(filename):
            raise FileNotFoundError(f"data file {filename} not found")
        with open_file(filename, errors="replace") as f:
            lines = f.read().splitlines()
        lines = [ln for ln in lines if ln.strip()]
        header = None
        if self.config.header and lines:
            header = lines[0]
            lines = lines[1:]
        return header, lines

    def _resolve_label_idx(self, names: Optional[List[str]]) -> int:
        spec = str(self.config.label_column).strip()
        if not spec:
            return 0
        if spec.startswith("name:"):
            if not names:
                raise ValueError("label_column=name:... requires header=true")
            w = spec[5:].strip()
            if w not in names:
                raise ValueError(f"label column '{w}' not found in header")
            return names.index(w)
        return int(spec)

    # ------------------------------------------------------------------
    def parse_file(self, filename: str
                   ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Parse a text data file.

        Returns ``(labels [N], features [N, F], extras)`` where extras holds
        feature_names, weights, group sizes, init scores, ignore column
        indices (feature space, label removed — reference `SetHeader`
        semantics `dataset_loader.cpp:62-140`) and the label's column.
        """
        cfg = self.config
        all_names = None
        header_line, lines = self._read_text(filename)
        if header_line is not None:
            all_names = _split_header_line(header_line)
        label_idx = self._resolve_label_idx(all_names)
        parser = create_parser(lines[:32], label_idx)
        labels, feats = parse_dense(lines, parser)

        feat_names = None
        if all_names is not None:
            feat_names = list(all_names)
            if 0 <= label_idx < len(feat_names):
                feat_names.pop(label_idx)

        # weight / group columns (indices don't count the label column)
        weights = None
        groups_raw = None
        ignore: set = set()
        if str(cfg.weight_column).strip():
            (widx,) = _parse_column_spec(cfg.weight_column, feat_names)
            weights = feats[:, widx].copy()
            ignore.add(widx)
        if str(cfg.group_column).strip():
            (gidx,) = _parse_column_spec(cfg.group_column, feat_names)
            groups_raw = feats[:, gidx].copy()
            ignore.add(gidx)
        for c in _parse_column_spec(cfg.ignore_column, feat_names):
            ignore.add(c)

        # sidecar files override in-file columns (reference metadata.cpp)
        side_w = _read_sidecar(filename + ".weight")
        if side_w is not None:
            weights = side_w
        side_q = _read_sidecar(filename + ".query")
        group_sizes = None
        if side_q is not None:
            group_sizes = side_q.astype(np.int64)
        elif groups_raw is not None:
            # in-file query ids -> boundary sizes (reference
            # `Metadata::SetQueryId`): consecutive equal ids form one query
            change = np.flatnonzero(np.diff(groups_raw) != 0)
            bounds = np.concatenate([[0], change + 1, [len(groups_raw)]])
            group_sizes = np.diff(bounds).astype(np.int64)
        init_score = _read_sidecar(filename + ".init")
        if cfg.initscore_filename and vf_exists(cfg.initscore_filename):
            init_score = _read_sidecar(cfg.initscore_filename)

        extras = dict(feature_names=feat_names, weights=weights,
                      group_sizes=group_sizes, init_score=init_score,
                      ignore=sorted(ignore), label_idx=label_idx)
        return labels, feats, extras

    # ------------------------------------------------------------------
    def _categorical_from_config(self, feat_names) -> Optional[List[int]]:
        spec = str(self.config.categorical_feature).strip()
        if not spec:
            return None
        return _parse_column_spec(spec, feat_names)

    def _seed_init_score(self, ds: Dataset, feats: np.ndarray) -> None:
        """The prior model's raw scores of the rows as their init scores
        (continued training from the CLI) where the file gave none; the
        dataset is marked so that `engine.train` keeps the prior model's
        trees without adding them to the scores a second time."""
        if self.predict_fun is not None and ds.metadata.init_score is None:
            raw = np.asarray(self.predict_fun(feats), dtype=np.float64)
            ds.metadata.set_init_score(raw.reshape(-1, order="F"))
            ds.init_score_from_model = True

    def load_from_file(self, filename: str, rank: int = 0,
                       num_machines: int = 1) -> Dataset:
        """reference `DatasetLoader::LoadFromFile` (`dataset_loader.cpp:162`):
        a ``.bin`` file, or ``<data>.bin`` unless ``save_binary`` asks to
        write it anew, loads as a binary dataset; text is parsed, its
        ignored columns zeroed (a constant column never splits), binned,
        seeded with the prior model's scores, and saved to
        ``<data>.bin`` under ``save_binary``."""
        cfg = self.config
        if num_machines > 1:
            raise NotImplementedError(
                "num_machines > 1: distributed loading is not ported yet "
                "(ROADMAP A.7)")
        if cfg.save_binary or filename.endswith(".bin"):
            binpath = filename if filename.endswith(".bin") \
                else filename + ".bin"
            if not cfg.save_binary and vf_exists(binpath):
                return Dataset.load_binary(binpath, device=self._device())
        self._check_ported(filename)
        labels, feats, ex = self.parse_file(filename)
        for c in ex["ignore"]:
            feats[:, c] = 0.0
        ds = Dataset.from_matrix(
            feats, label=labels, config=cfg, weight=ex["weights"],
            group=ex["group_sizes"], init_score=ex["init_score"],
            feature_names=ex["feature_names"],
            categorical_feature=self._categorical_from_config(
                ex["feature_names"]), device=self._device())
        self._seed_init_score(ds, feats)
        if cfg.save_binary:
            ds.save_binary(filename + ".bin")
        return ds

    def load_from_file_align_with_other_dataset(
            self, filename: str, reference: Dataset) -> Dataset:
        """Validation data binned with the training set's mappers
        (reference `dataset_loader.cpp:224`)."""
        self._check_ported(filename)
        labels, feats, ex = self.parse_file(filename)
        for c in ex["ignore"]:
            feats[:, c] = 0.0
        ds = Dataset.from_matrix(
            feats, label=labels, config=self.config, weight=ex["weights"],
            group=ex["group_sizes"], init_score=ex["init_score"],
            feature_names=ex["feature_names"], reference=reference,
            device=self._device())
        self._seed_init_score(ds, feats)
        return ds
