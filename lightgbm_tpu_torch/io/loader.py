"""DatasetLoader: text / binary / columnar file -> binned `Dataset` (port
of lightgbm_tpu/io/loader.py).

Re-creates `src/io/dataset_loader.cpp`: `LoadFromFile` (`:162`) with
header handling + label/weight/group/ignore column extraction
(`SetHeader` `:25-140`), sidecar metadata files ``<data>.weight`` /
``<data>.query`` / ``<data>.init`` (`src/io/metadata.cpp:376,400`),
validation-set alignment against a reference dataset
(`LoadFromFileAlignWithOtherDataset` `:224`), and the binary-file fast
path (`LoadFromBinFile` `:268` -> `Dataset.load_binary`). A local file
without a header is parsed, on a one-shot load, by the native OpenMP
parser (`native.py`), any other by the Python parser (`io/parser.py`):
the native parser reads the tokens "N/A", "None" and "?" as 0.0, the
Python one as NaN, as in the JAX package (ROADMAP C.38), so a file with
those tokens bins otherwise by route. Besides the one-shot
load, three routes bound the host's memory: ``two_round`` (a reservoir
sample, then the rows pushed a chunk at a time), ``tpu_stream_chunk_rows``
> 0 (a count pass, a pass that parses only the sampled lines, then the
chunks binned on the device, `io/stream.py`) and Parquet / Arrow files
(the same flow over pyarrow's record batches). Loading across machines
(``num_machines`` > 1) raises (ROADMAP A.7).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, resolve_device
from .binning import sample_indices
from .dataset import Dataset
from .file_io import exists as vf_exists
from .file_io import open_file
from .parser import LibSVMParser, create_parser, parse_dense

# rows a chunk of the two-round and streamed loads when
# ``tpu_stream_chunk_rows`` does not set it; LGBM_TPU_INGEST_CHUNK
# overrides it
DEFAULT_CHUNK_LINES = 1 << 16

# columnar front-door extensions of the pyarrow reader
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


def _group_sizes(side_q: Optional[np.ndarray],
                 gid_parts: List[np.ndarray]) -> Optional[np.ndarray]:
    """Query sizes: the ``.query`` sidecar's, else runs of equal in-file
    query ids (reference `Metadata::SetQueryId`)."""
    if side_q is not None:
        return side_q.astype(np.int64)
    if not gid_parts:
        return None
    ids = np.concatenate(gid_parts)
    change = np.flatnonzero(np.diff(ids) != 0)
    bounds = np.concatenate([[0], change + 1, [len(ids)]])
    return np.diff(bounds).astype(np.int64)


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

    def _meta_columns(self, feat_names: Optional[List[str]]):
        """(weight column, group column, ignored columns), in feature
        space (the label's column removed)."""
        cfg = self.config
        widx = gidx = None
        ignore: set = set()
        if str(cfg.weight_column).strip():
            (widx,) = _parse_column_spec(cfg.weight_column, feat_names)
            ignore.add(widx)
        if str(cfg.group_column).strip():
            (gidx,) = _parse_column_spec(cfg.group_column, feat_names)
            ignore.add(gidx)
        for c in _parse_column_spec(cfg.ignore_column, feat_names):
            ignore.add(c)
        return widx, gidx, ignore

    def _init_score_file(self, filename: str) -> Optional[np.ndarray]:
        init_score = _read_sidecar(filename + ".init")
        if self.config.initscore_filename \
                and vf_exists(self.config.initscore_filename):
            init_score = _read_sidecar(self.config.initscore_filename)
        return init_score

    # ------------------------------------------------------------------
    def parse_file(self, filename: str
                   ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Parse a text data file.

        Returns ``(labels [N], features [N, F], extras)`` where extras holds
        feature_names, weights, group sizes, init scores, ignore column
        indices (feature space, label removed — reference `SetHeader`
        semantics `dataset_loader.cpp:62-140`) and the label's column. A
        local file without a header takes the native parser where the
        library builds (the JAX package's condition,
        lightgbm_tpu/io/loader.py:120-132).
        """
        all_names = None
        labels = feats = None
        if not self.config.header and "://" not in str(filename):
            from ..native import parse_file as native_parse
            label_idx = self._resolve_label_idx(None)
            if not os.path.isfile(filename):
                raise FileNotFoundError(f"data file {filename} not found")
            native = native_parse(filename, label_idx)
            if native is not None:
                labels, feats, _fmt = native
        if labels is None:
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

        # weight / group columns (indices don't count the label column);
        # sidecar files override them (reference metadata.cpp)
        widx, gidx, ignore = self._meta_columns(feat_names)
        weights = feats[:, widx].copy() if widx is not None else None
        gids = [feats[:, gidx].copy()] if gidx is not None else []
        side_w = _read_sidecar(filename + ".weight")
        if side_w is not None:
            weights = side_w
        extras = dict(feature_names=feat_names, weights=weights,
                      group_sizes=_group_sizes(
                          _read_sidecar(filename + ".query"), gids),
                      init_score=self._init_score_file(filename),
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
        dataset is marked so that `engine.train` and
        `GBDT.add_valid_dataset` do not add the prior model's trees a
        second time."""
        if self.predict_fun is not None and ds.metadata.init_score is None:
            raw = np.asarray(self.predict_fun(feats), dtype=np.float64)
            ds.metadata.set_init_score(raw.reshape(-1, order="F"))
            ds.init_score_from_model = True

    def _route(self, filename: str):
        """The bounded-memory route a file takes, or None for the one-shot
        load: columnar files, then ``tpu_stream_chunk_rows``, then
        ``two_round`` (the JAX package's order)."""
        if str(filename).endswith(_COLUMNAR_EXTS):
            return self._load_columnar
        if int(self.config.tpu_stream_chunk_rows) > 0:
            return self._load_streamed
        if self.config.two_round:
            return self._load_two_round
        return None

    def load_from_file(self, filename: str, rank: int = 0,
                       num_machines: int = 1) -> Dataset:
        """reference `DatasetLoader::LoadFromFile` (`dataset_loader.cpp:162`):
        a ``.bin`` file, or ``<data>.bin`` unless ``save_binary`` asks to
        write it anew, loads as a binary dataset; a columnar file, a
        streamed or a two-round load takes its route (`_route`); else
        text is parsed, its ignored columns zeroed (a constant column never
        splits), binned, seeded with the prior model's scores, and saved
        to ``<data>.bin`` under ``save_binary``."""
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
        route = self._route(filename)
        if route is not None:
            return route(filename)
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
        (reference `dataset_loader.cpp:224`), by the training file's
        route."""
        route = self._route(filename)
        if route is not None:
            return route(filename, reference=reference)
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

    # ------------------------------------------------------------------
    # the bounded-memory routes (JAX package: loader.py:239-907)
    def _iter_line_chunks(self, filename: str, chunk_lines: int):
        """Lists of at most ``chunk_lines`` non-empty lines (the header
        skipped): O(chunk) lines in memory at a time."""
        with open_file(filename, errors="replace") as f:
            if self.config.header:
                f.readline()
            buf: List[str] = []
            for ln in f:
                if not ln.strip():
                    continue
                buf.append(ln)
                if len(buf) >= chunk_lines:
                    yield buf
                    buf = []
            if buf:
                yield buf

    def _header_names(self, filename: str) -> Optional[List[str]]:
        if not self.config.header:
            return None
        with open_file(filename, errors="replace") as f:
            header_line = f.readline().rstrip("\r\n")
        return _split_header_line(header_line)

    def _text_setup(self, filename: str):
        """(feature names, label column, weight column, group column,
        ignored columns) of a text file, from its header line."""
        if not vf_exists(filename):
            raise FileNotFoundError(f"data file {filename} not found")
        all_names = self._header_names(filename)
        label_idx = self._resolve_label_idx(all_names)
        feat_names = None
        if all_names is not None:
            feat_names = list(all_names)
            if 0 <= label_idx < len(feat_names):
                feat_names.pop(label_idx)
        return (feat_names, label_idx, *self._meta_columns(feat_names))

    @staticmethod
    def _prep(feats: np.ndarray, widx, gidx, ignore):
        """(features with the ignored columns zeroed, in-file weights,
        in-file query ids) of a chunk: both passes see the same rows."""
        w = feats[:, widx].copy() if widx is not None \
            and widx < feats.shape[1] else None
        gids = feats[:, gidx].copy() if gidx is not None \
            and gidx < feats.shape[1] else None
        for c in ignore:
            if c < feats.shape[1]:
                feats[:, c] = 0.0
        return feats, w, gids

    def _finish_scores(self, ds: Dataset, init_score, raw_parts) -> None:
        """The init scores: the file's (or ``initscore_filename``'s), else
        the prior model's raw scores of the rows (`_seed_init_score`)."""
        if init_score is not None:
            ds.metadata.set_init_score(init_score)
        elif raw_parts:
            raw = np.concatenate(raw_parts, axis=0)
            ds.metadata.set_init_score(raw.reshape(-1, order="F"))
            ds.init_score_from_model = True

    def _load_two_round(self, filename: str,
                        reference: Optional[Dataset] = None,
                        chunk_lines: Optional[int] = None) -> Dataset:
        """Two passes over the file in O(chunk) host memory (reference
        two_round, `dataset_loader.cpp:162-266`): pass 1 reservoir-samples
        up to ``bin_construct_sample_cnt`` rows for the bins (the JAX
        package's draw from ``RandomState(data_random_seed)``) and keeps
        the in-file query ids; pass 2 parses again and pushes each chunk
        (`Dataset.push_rows`: binned by the native binner on a CPU dataset,
        on the device otherwise). With ``reference`` nothing is sampled."""
        cfg = self.config
        if chunk_lines is None:
            chunk_lines = int(os.environ.get("LGBM_TPU_INGEST_CHUNK",
                                             DEFAULT_CHUNK_LINES))
        feat_names, label_idx, widx, gidx, ignore = \
            self._text_setup(filename)
        rng = np.random.RandomState(cfg.data_random_seed)
        sample_cap = max(int(cfg.bin_construct_sample_cnt), 1)
        parser = None
        sample_rows: List[np.ndarray] = []
        gid_parts: List[np.ndarray] = []
        n_kept = max_f = 0
        for lines in self._iter_line_chunks(filename, chunk_lines):
            if parser is None:
                parser = create_parser(lines[:32], label_idx)
            _, feats = parse_dense(lines, parser)
            feats, _, gids = self._prep(feats, widx, gidx, ignore)
            max_f = max(max_f, feats.shape[1])
            if gids is not None:
                gid_parts.append(gids)
            # vectorized reservoir sample: fill to the cap, then row t
            # replaces slot j ~ U[0, t] iff j < cap
            k = feats.shape[0]
            if reference is None:
                take = min(max(sample_cap - len(sample_rows), 0), k)
                for i in range(take):
                    sample_rows.append(feats[i].copy())
                if take < k:
                    t = n_kept + np.arange(take, k)
                    j = (rng.random_sample(k - take)
                         * (t + 1)).astype(np.int64)
                    for i, slot in zip(np.nonzero(j < sample_cap)[0],
                                       j[j < sample_cap]):
                        sample_rows[slot] = feats[take + i].copy()
            n_kept += k
        if parser is None:
            raise ValueError(f"data file {filename} is empty")
        if reference is not None:
            # the training set may be wider than this file's rows reach
            # (ragged LibSVM): bin at its width
            max_f = max(max_f, reference.num_total_features)
            ds = Dataset.create_from_sample(None, n_kept, config=cfg,
                                            reference=reference,
                                            device=self._device())
        else:
            sample = np.zeros((len(sample_rows), max_f))
            for i, r in enumerate(sample_rows):
                sample[i, :len(r)] = r
            del sample_rows
            ds = Dataset.create_from_sample(
                sample, n_kept, config=cfg, feature_names=feat_names,
                categorical_feature=self._categorical_from_config(
                    feat_names), device=self._device())
            del sample

        # pass 2: parse again, push each chunk into the binned matrix
        side_w = _read_sidecar(filename + ".weight")
        init_score = self._init_score_file(filename)
        num_cols = max_f if isinstance(parser, LibSVMParser) else None
        raw_parts: List[np.ndarray] = []
        pos = 0
        for lines in self._iter_line_chunks(filename, chunk_lines):
            labs, feats = parse_dense(lines, parser, num_cols=num_cols)
            feats, w, _ = self._prep(feats, widx, gidx, ignore)
            if feats.shape[1] < max_f:
                feats = np.pad(feats, ((0, 0), (0, max_f - feats.shape[1])))
            k = feats.shape[0]
            if pos + k > n_kept:
                raise ValueError(
                    f"two_round pass 2 saw more than the {n_kept} rows of "
                    f"pass 1: the data file changed between passes")
            if side_w is not None:
                w = side_w[pos:pos + k]
            ds.push_rows(feats, label=labs, weight=w)
            if init_score is None and self.predict_fun is not None:
                raw_parts.append(np.asarray(self.predict_fun(feats),
                                            np.float64))
            pos += k
        if pos != n_kept:
            raise ValueError(
                f"two_round pass 2 saw {pos} rows but pass 1 sampled "
                f"{n_kept}: the data file changed between passes (is the "
                f"path a non-rewindable stream?)")
        ds.finish_load(group=_group_sizes(
            _read_sidecar(filename + ".query"), gid_parts))
        self._finish_scores(ds, init_score, raw_parts)
        if cfg.save_binary:
            ds.save_binary(filename + ".bin")
        return ds

    def _load_streamed(self, filename: str,
                       reference: Optional[Dataset] = None,
                       chunk_lines: Optional[int] = None) -> Dataset:
        """Three bounded passes over a text file
        (``tpu_stream_chunk_rows`` > 0), the model equal to the one-shot
        load's:

        1. **count**: the rows, parsing chunks only where the format asks
           for it (LibSVM's width, in-file query ids);
        2. **sample**: the one-shot draw (`sample_indices`) over the rows,
           and only those lines parsed, so the bounds equal the one-shot
           route's;
        3. **bin**: each chunk parsed, then binned into the matrix on the
           device (`io/stream.run_pipeline`, `Dataset.push_rows`).
        """
        from .stream import check_stream_options, ingest_stats, run_pipeline
        cfg = self.config
        check_stream_options(cfg)
        t0 = time.perf_counter()
        if chunk_lines is None:
            chunk_lines = int(cfg.tpu_stream_chunk_rows) \
                or int(os.environ.get("LGBM_TPU_INGEST_CHUNK",
                                      DEFAULT_CHUNK_LINES))
        chunk_lines = max(int(chunk_lines), 1)
        feat_names, label_idx, widx, gidx, ignore = \
            self._text_setup(filename)

        # pass 1: count (parse only where the format asks for it)
        parser = None
        gid_parts: List[np.ndarray] = []
        n_kept = max_f = 0
        needs_parse = True
        for lines in self._iter_line_chunks(filename, chunk_lines):
            if parser is None:
                parser = create_parser(lines[:32], label_idx)
                needs_parse = (isinstance(parser, LibSVMParser)
                               or gidx is not None)
                max_f = parser.num_features(lines[0])
            if needs_parse:
                _, feats = parse_dense(lines, parser)
                feats, _, gids = self._prep(feats, widx, gidx, ignore)
                max_f = max(max_f, feats.shape[1])
                if gids is not None:
                    gid_parts.append(gids)
            n_kept += len(lines)
        if parser is None:
            raise ValueError(f"data file {filename} is empty")
        num_cols = max_f if isinstance(parser, LibSVMParser) else None

        # pass 2: the sample, parsing only the sampled lines
        if reference is not None:
            max_f = max(max_f, reference.num_total_features)
            num_cols = max_f if isinstance(parser, LibSVMParser) else None
            ds = Dataset.create_from_sample(None, n_kept, config=cfg,
                                            reference=reference,
                                            device=self._device())
        else:
            want = np.asarray(sample_indices(
                n_kept, min(n_kept, max(cfg.bin_construct_sample_cnt, 1)),
                cfg.data_random_seed), np.int64)
            picked: List[str] = []
            off = 0
            for lines in self._iter_line_chunks(filename, chunk_lines):
                lo = np.searchsorted(want, off)
                hi = np.searchsorted(want, off + len(lines))
                picked.extend(lines[int(g - off)] for g in want[lo:hi])
                off += len(lines)
            _, sample = parse_dense(picked, parser, num_cols=num_cols)
            del picked
            if sample.shape[1] < max_f:
                sample = np.pad(sample,
                                ((0, 0), (0, max_f - sample.shape[1])))
            sample, _, _ = self._prep(sample, None, None, ignore)
            ds = Dataset.create_from_sample(
                sample, n_kept, config=cfg, feature_names=feat_names,
                categorical_feature=self._categorical_from_config(
                    feat_names), device=self._device())
            del sample

        # pass 3: parse on the host, bin on the device
        side_w = _read_sidecar(filename + ".weight")
        init_score = self._init_score_file(filename)
        raw_parts: List[np.ndarray] = []

        def chunks():
            pos = 0
            for lines in self._iter_line_chunks(filename, chunk_lines):
                labs, feats = parse_dense(lines, parser, num_cols=num_cols)
                feats, w, _ = self._prep(feats, widx, gidx, ignore)
                if feats.shape[1] < max_f:
                    feats = np.pad(feats,
                                   ((0, 0), (0, max_f - feats.shape[1])))
                k = feats.shape[0]
                if pos + k > n_kept:
                    raise ValueError(
                        f"streamed load pass 3 saw more than the {n_kept} "
                        f"rows of pass 1: the data file changed between "
                        f"passes")
                if side_w is not None:
                    w = side_w[pos:pos + k]
                if init_score is None and self.predict_fun is not None:
                    raw_parts.append(np.asarray(self.predict_fun(feats),
                                                np.float64))
                pos += k
                yield feats, labs, w

        stages = run_pipeline(ds, chunks())
        ds.finish_load(group=_group_sizes(
            _read_sidecar(filename + ".query"), gid_parts))
        self._finish_scores(ds, init_score, raw_parts)
        ingest_stats(ds, chunk_lines, t0, stages)
        if cfg.save_binary:
            ds.save_binary(filename + ".bin")
        return ds

    def _load_columnar(self, filename: str,
                       reference: Optional[Dataset] = None) -> Dataset:
        """A Parquet / Arrow IPC file: record batches of
        ``tpu_stream_chunk_rows`` rows (the default chunk without it)
        through the flow of `_load_streamed` (a count pass, the sample
        pass, then the chunks binned on the device). Needs pyarrow."""
        from .stream import (check_stream_options, ingest_stats,
                             iter_parquet_batches, run_pipeline)
        cfg = self.config
        check_stream_options(cfg)
        t0 = time.perf_counter()
        chunk_rows = max(int(cfg.tpu_stream_chunk_rows)
                         or DEFAULT_CHUNK_LINES, 1)
        if not os.path.exists(filename):
            raise FileNotFoundError(f"data file {filename} not found")
        names: Optional[List[str]] = None
        n_kept = 0
        for batch_names, block in iter_parquet_batches(filename, chunk_rows):
            names = batch_names
            n_kept += block.shape[0]
        if names is None or n_kept == 0:
            raise ValueError(f"data file {filename} is empty")
        label_idx = self._resolve_label_idx(names)
        feat_names = list(names)
        if 0 <= label_idx < len(feat_names):
            feat_names.pop(label_idx)
        widx, gidx, ignore = self._meta_columns(feat_names)

        def split(block):
            if 0 <= label_idx < block.shape[1]:
                return (block[:, label_idx].copy(),
                        np.delete(block, label_idx, axis=1))
            return np.zeros(block.shape[0]), block

        if reference is not None:
            ds = Dataset.create_from_sample(None, n_kept, config=cfg,
                                            reference=reference,
                                            device=self._device())
        else:
            want = np.asarray(sample_indices(
                n_kept, min(n_kept, max(cfg.bin_construct_sample_cnt, 1)),
                cfg.data_random_seed), np.int64)
            rows: List[np.ndarray] = []
            off = 0
            for _, block in iter_parquet_batches(filename, chunk_rows):
                feats, _, _ = self._prep(split(block)[1], widx, gidx,
                                         ignore)
                lo = np.searchsorted(want, off)
                hi = np.searchsorted(want, off + block.shape[0])
                if hi > lo:
                    rows.append(feats[want[lo:hi] - off])
                off += block.shape[0]
            sample = (np.concatenate(rows, axis=0) if rows
                      else np.zeros((0, len(feat_names))))
            del rows
            ds = Dataset.create_from_sample(
                sample, n_kept, config=cfg, feature_names=feat_names,
                categorical_feature=self._categorical_from_config(
                    feat_names), device=self._device())
            del sample

        side_w = _read_sidecar(filename + ".weight")
        init_score = _read_sidecar(filename + ".init")
        gid_parts: List[np.ndarray] = []

        def chunks():
            pos = 0
            for _, block in iter_parquet_batches(filename, chunk_rows):
                labs, feats = split(block)
                feats, w, gids = self._prep(feats, widx, gidx, ignore)
                k = feats.shape[0]
                if pos + k > n_kept:
                    raise ValueError(
                        f"columnar load saw more than the {n_kept} rows of "
                        f"the count pass: the file changed between passes")
                if side_w is not None:
                    w = side_w[pos:pos + k]
                if gids is not None:
                    gid_parts.append(gids)
                pos += k
                yield feats, labs, w

        stages = run_pipeline(ds, chunks())
        ds.finish_load(group=_group_sizes(
            _read_sidecar(filename + ".query"), gid_parts))
        if init_score is not None:
            ds.metadata.set_init_score(init_score)
        ingest_stats(ds, chunk_rows, t0, stages)
        return ds
