"""Streamed ingest binned on the device (port of the single-device part
of lightgbm_tpu/io/stream.py).

The one-shot routes hold the whole float matrix on the host; at the HIGGS
shape that is 10.5M x 28 f64 (2.35 GB) for a 294 MB binned matrix. Here:

1. one bounded sample pass draws the bin-construction sample with the
   one-shot draw (`io.binning.sample_indices`), so the bin bounds equal
   the one-shot route's by construction;
2. each chunk goes through `Dataset.push_rows`, the binner of the
   one-shot and two-round routes: numerical columns on the dataset's
   device (`values_to_bins_torch`), categorical ones on the host, written
   by slice into the binned matrix that `create_from_sample` allocated on
   the device, so the learner's first upload is free.

Host memory stays O(sample + chunk): an ``np.memmap`` larger than the
host's memory loads. `iter_parquet_batches` reads Parquet and Arrow IPC
files a record batch at a time through pyarrow, where it imports.

The chunks are read and binned on one thread: the JAX package's prefetch
thread (``tpu_stream_pipeline_depth``) is not ported, because on the card
it made streamed loads slower, not faster (``chip_smoke.py --prefetch-ab``,
PERF.md section 5); the option is accepted and checked only. The JAX package's stream-to-shard
route (`ShardedAppender`, `run_sharded_pipeline`, `finish_sharded_ingest`)
waits for distributed training (ROADMAP A.7); ``tpu_stream_shard=on``
raises.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from .binning import BIN_CATEGORICAL, sample_indices
from .dataset import Dataset

__all__ = [
    "check_stream_options",
    "iter_parquet_batches",
    "pyarrow_available",
    "stream_matrix",
]


def check_stream_options(cfg: Config) -> None:
    """``tpu_stream_shard``: "auto" and "off" stream to one device; "on"
    asks for the stream-to-shard route, which is not ported.
    ``tpu_stream_pipeline_depth``: any count >= 0 (the JAX package's
    prefetch depth; one thread here)."""
    mode = str(cfg.tpu_stream_shard).strip().lower()
    if mode == "on":
        raise NotImplementedError(
            "tpu_stream_shard=on: streaming into the shards of a "
            "data-parallel run is not ported yet (ROADMAP A.7)")
    if mode not in ("auto", "off"):
        raise ValueError(f"tpu_stream_shard must be auto, on or off, not "
                         f"{cfg.tpu_stream_shard!r}")
    if int(cfg.tpu_stream_pipeline_depth) < 0:
        raise ValueError(f"tpu_stream_pipeline_depth must be >= 0, not "
                         f"{cfg.tpu_stream_pipeline_depth!r}")


def run_pipeline(ds: Dataset, chunks: Iterable) -> dict:
    """Push the chunks ``(feats, label, weight)`` into ``ds`` in order
    (`Dataset.push_rows`). Returns the stage seconds: ``parse_s`` spent
    making the chunks, ``bin_s`` binning them (the device synchronized
    once, at the end) and ``wall_s``."""
    t_start = t0 = time.perf_counter()
    parse_s = bin_s = 0.0
    for feats, labs, w in chunks:
        t1 = time.perf_counter()
        parse_s += t1 - t0
        ds.push_rows(feats, label=labs, weight=w)
        t0 = time.perf_counter()
        bin_s += t0 - t1
    t1 = time.perf_counter()
    parse_s += t1 - t0
    if ds.device.type == "cuda":
        torch.cuda.synchronize(ds.device)
    bin_s += time.perf_counter() - t1
    return {"parse_s": parse_s, "bin_s": bin_s,
            "wall_s": time.perf_counter() - t_start}


def ingest_stats(ds: Dataset, chunk_rows: int, t0: float,
                 stages: dict) -> None:
    """``ds._ingest_ms`` (the whole load) and ``ds._ingest_stats``."""
    used = [ds.mappers[j] for j in ds.real_feature_idx]
    host = sum(m.bin_type == BIN_CATEGORICAL for m in used)
    ds._ingest_ms = (time.perf_counter() - t0) * 1e3
    ds._ingest_stats = {
        "rows": int(ds.num_data), "chunk_rows": int(chunk_rows),
        "device_cols": len(used) - host, "host_cols": host,
        **{f"{k[:-2]}_ms": v * 1e3 for k, v in stages.items()}}


def stream_matrix(data, label=None, config: Optional[Config] = None,
                  weight=None, group=None, init_score=None,
                  feature_names: Optional[List[str]] = None,
                  categorical_feature: Optional[Sequence[int]] = None,
                  reference: Optional[Dataset] = None,
                  device: Optional[torch.device] = None) -> Dataset:
    """The chunked twin of `Dataset.from_matrix` on ``device``: the same
    sample draw, the same bounds, the same binned matrix, built a chunk of
    ``tpu_stream_chunk_rows`` rows at a time. ``data`` is anything with a
    2-D shape and row slices (an ``np.memmap`` of a matrix larger than
    the host's memory is the intended caller)."""
    cfg = config or Config()
    check_stream_options(cfg)
    chunk_rows = max(int(cfg.tpu_stream_chunk_rows), 1)
    t0 = time.perf_counter()
    n = data.shape[0]
    if reference is not None:
        ds = Dataset.create_from_sample(None, n, config=cfg,
                                        reference=reference, device=device)
    else:
        cnt = min(n, max(cfg.bin_construct_sample_cnt, 1))
        sample = np.asarray(data[sample_indices(n, cnt,
                                                cfg.data_random_seed)],
                            np.float64)
        ds = Dataset.create_from_sample(
            sample, n, config=cfg, feature_names=feature_names,
            categorical_feature=categorical_feature, device=device)
        del sample
    label = None if label is None else np.asarray(label).reshape(-1)
    weight = None if weight is None else np.asarray(weight).reshape(-1)

    def chunks():
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            yield (np.asarray(data[lo:hi]),
                   None if label is None else label[lo:hi],
                   None if weight is None else weight[lo:hi])

    stages = run_pipeline(ds, chunks())
    ds.finish_load(group=group)
    if init_score is not None:
        ds.metadata.set_init_score(init_score)
    ingest_stats(ds, chunk_rows, t0, stages)
    return ds


def pyarrow_available() -> bool:
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
        return True
    except Exception:
        return False


def iter_parquet_batches(path: str, chunk_rows: int
                         ) -> Iterator[Tuple[List[str], np.ndarray]]:
    """``(column names, f64 [<= chunk_rows, C] block)`` of a Parquet or
    Arrow IPC file, a record batch at a time."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except Exception as e:
        raise ImportError(
            "Parquet/Arrow ingest needs pyarrow, which is not installed; "
            "convert the file to CSV/TSV or install pyarrow") from e
    if str(path).endswith((".arrow", ".feather", ".ipc")):
        with pa.memory_map(str(path)) as src:
            table = pa.ipc.open_file(src).read_all()
        batches = table.to_batches(max_chunksize=chunk_rows)
    else:
        batches = pq.ParquetFile(str(path)).iter_batches(
            batch_size=chunk_rows)
    for batch in batches:
        names = list(batch.schema.names)
        cols = [np.asarray(batch.column(i).to_numpy(zero_copy_only=False),
                           np.float64) for i in range(batch.num_columns)]
        yield names, (np.stack(cols, axis=1) if cols
                      else np.zeros((batch.num_rows, 0)))
