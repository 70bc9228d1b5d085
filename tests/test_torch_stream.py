"""The port's bounded-memory ingest against the JAX package on the CPU:
two-round loading (`_load_two_round`: the reservoir sample, the
``.weight`` / ``.query`` / ``.init`` sidecars, LibSVM's ragged width, a
validation file through ``reference``), the streamed load
(`_load_streamed`) and `stream_matrix`, whose bins and f64 trees equal the
JAX package's and the one-shot load's, the streamed route's device
binner against the host's `values_to_bins` (NaN, categorical, uint16),
the prefetch-depth option, a last chunk without
a trailing newline, Parquet files (`_load_columnar`) and the
``tpu_stream_shard`` switch. Every file is written here from seeded numpy
data."""
import contextlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import loader as jloader
from lightgbm_tpu.io import stream as jstream
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.io import loader as tloader
from lightgbm_tpu_torch.io import stream as tstream

BASE = {"num_leaves": 7, "max_bin": 31, "learning_rate": 0.3,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True, "objective": "binary"}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package enters `jax.experimental.enable_x64()`, which JAX
    0.9 removed (ROADMAP C.5); give it a context manager over the x64
    flag, in the test only."""
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", new_val)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)
    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _table(n=1200, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, f)), 3)
    X[rng.rand(n, f) < 0.05] = np.nan
    z = np.nan_to_num(X)
    y = (z[:, 0] - 0.7 * z[:, 1] + 0.3 * rng.standard_normal(n) > 0)
    return X, y.astype(np.float64)


def _fmt(v):
    return "nan" if np.isnan(v) else f"{v:.6g}"


def _write(path, y, X, libsvm=False, trailing_newline=True):
    with open(path, "w") as fh:
        lines = []
        for yi, row in zip(y, X):
            if libsvm:
                lines.append(" ".join([f"{yi:g}"] + [
                    f"{j}:{np.nan_to_num(v):.6g}" for j, v in enumerate(row)
                    if j == 0 or (not np.isnan(v) and v > -0.5)]))
            else:
                lines.append(",".join([_fmt(yi)] + [_fmt(v) for v in row]))
        fh.write("\n".join(lines) + ("\n" if trailing_newline else ""))


def _same(j, t):
    """Mappers, bins, label, weight, query boundaries, init score."""
    assert [m.to_dict() for m in j.mappers] \
        == [m.to_dict() for m in t.mappers]
    assert str(j.bins.dtype) == str(t.bins.dtype).replace("torch.", "")
    np.testing.assert_array_equal(np.asarray(j.bins), t._host_bins())
    for k in ("label", "weight", "query_boundaries", "init_score"):
        a, b = getattr(j.metadata, k), getattr(t.metadata, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert j.feature_names == t.feature_names


def _files(tmp_path, case):
    """(train path, valid path) of a case: sampled CSV, CSV with sidecars,
    ragged LibSVM."""
    X, y = _table()
    rng = np.random.RandomState(1)
    tr, va = str(tmp_path / "train.txt"), str(tmp_path / "valid.txt")
    libsvm = case == "libsvm"
    if libsvm:
        X[:, -1] = np.where(np.arange(len(y)) % 3 == 0, 1.5, np.nan)
    _write(tr, y, X, libsvm)
    Xv, yv = _table(300, seed=4)
    if libsvm:
        Xv = Xv[:, :4]              # narrower than the training set
    _write(va, yv, Xv, libsvm)
    if case == "sidecars":
        np.savetxt(tr + ".weight", np.round(rng.uniform(0.5, 2, len(y)), 3))
        np.savetxt(tr + ".query", np.full(len(y) // 40, 40), fmt="%d")
        np.savetxt(tr + ".init", np.round(rng.standard_normal(len(y)), 3))
    return tr, va


def _loaders(params):
    return (jloader.DatasetLoader(JConfig.from_params(params)),
            tloader.DatasetLoader(TConfig.from_params(
                {**params, "device_type": "cpu"})))


ROUTES = {"two_round": {"two_round": True},
          "streamed": {"tpu_stream_chunk_rows": 256}}


@pytest.mark.parametrize("case", ["sampled", "sidecars", "libsvm"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_load_matches_jax(x64, tmp_path, monkeypatch, route, case):
    """Two-round and streamed loads: mappers, bins and metadata equal to
    the JAX package's load of the same file (a sample of 300 of 1,200
    rows, chunks of 256 lines), and so are those of a validation file
    loaded through ``reference``; the streamed bins equal the one-shot
    load's."""
    compile_cache.clear_programs()
    monkeypatch.setenv("LGBM_TPU_INGEST_CHUNK", "256")
    tr, va = _files(tmp_path, case)
    params = {**ROUTES[route], "max_bin": 31, "verbosity": -1,
              "bin_construct_sample_cnt": 300}
    jl, tl = _loaders(params)
    jd, td = jl.load_from_file(tr), tl.load_from_file(tr)
    _same(jd, td)
    _same(jl.load_from_file_align_with_other_dataset(va, jd),
          tl.load_from_file_align_with_other_dataset(va, td))
    if route == "streamed":
        one = tloader.DatasetLoader(TConfig.from_params(
            {**params, "tpu_stream_chunk_rows": 0, "device_type": "cpu"})
        ).load_from_file(tr)
        assert torch.equal(one.bins, td.bins)


@pytest.mark.parametrize("route", list(ROUTES))
def test_trains_as_jax(x64, tmp_path, route):
    """3 rounds from a two-round and a streamed `Dataset(path)` with a
    validation file: the f64 model text and the valid metric equal the
    JAX package's."""
    tr, va = _files(tmp_path, "sidecars")
    params = {**BASE, **ROUTES[route], "bin_construct_sample_cnt": 500,
              "metric": "binary_logloss"}
    out = {}
    for name, lib, extra in (("jax", jlgb, {}),
                             ("torch", tlgb, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        p = {**params, **extra}
        ds = lib.Dataset(tr, params=p)
        ev = {}
        bst = lib.train(p, ds, num_boost_round=3,
                        valid_sets=[lib.Dataset(va, reference=ds)],
                        evals_result=ev, verbose_eval=False)
        out[name] = (_sections(bst.model_to_string()), ev)
    assert out["torch"] == out["jax"]


def test_stream_matrix_matches_jax(x64):
    """`stream_matrix` (chunks of 300 rows, a sample of 500): bins equal to
    the JAX package's `stream_matrix` and to the port's `from_matrix`
    (a categorical column and NaN); 3 rounds from it give the one-shot
    dataset's f64 model text, which is the JAX package's."""
    compile_cache.clear_programs()
    X, y = _table(1300)
    X[:, 2] = np.random.RandomState(3).randint(0, 9, len(y))
    params = {**BASE, "tpu_stream_chunk_rows": 300,
              "bin_construct_sample_cnt": 500, "categorical_feature": "2"}
    jd = jstream.stream_matrix(X, label=y, config=JConfig.from_params(params))
    tcfg = TConfig.from_params(params)
    td = tstream.stream_matrix(X, label=y, config=tcfg)
    _same(jd, td)
    assert torch.equal(td.bins,
                       tds.Dataset.from_matrix(X, label=y, config=tcfg).bins)
    assert td._ingest_stats["host_cols"] == 1
    texts = {}
    for name, lib, extra in (("jax", jlgb, {}),
                             ("stream", tlgb, {"device_type": "cpu"}),
                             ("one-shot", tlgb, {"device_type": "cpu",
                                                 "tpu_stream_chunk_rows": 0})):
        compile_cache.clear_programs()
        p = {**params, **extra}
        bst = lib.train(p, lib.Dataset(X, label=y, params=p),
                        num_boost_round=3, verbose_eval=False)
        texts[name] = _sections(bst.model_to_string())
    assert texts["stream"] == texts["one-shot"] == texts["jax"]


@pytest.mark.parametrize("wide", [False, True], ids=["uint8", "uint16"])
def test_device_binner_matches_host(wide, monkeypatch):
    """The streamed route's binner (`push_rows` on its torch route, the
    one that runs on the card: `values_to_bins_torch`, categorical
    columns on the host) against each mapper's host `values_to_bins`:
    NaN (NaN bin or bin of 0.0), +-inf, values on the bounds, and a
    categorical column with unseen and negative codes."""
    from lightgbm_tpu_torch import native as tnative
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    rng = np.random.RandomState(6)
    X = rng.standard_normal((3000, 4))
    X[:, 1] = rng.randint(0, 20, len(X))
    X[rng.rand(3000, 4) < 0.1] = np.nan
    params = {"max_bin": 300 if wide else 63, "verbosity": -1,
              "categorical_feature": "1", "min_data_in_bin": 1}
    cfg = TConfig.from_params(params)
    test = X.copy()
    test[::7, 0] = np.inf
    test[::11, 0] = -np.inf
    test[::5, 1] = np.where(np.arange(len(test))[::5] % 2, 57, -3)
    ds = tds.Dataset.create_from_sample(X[:2000], len(X), config=cfg)
    test[::13, 2] = ds.mappers[2].bin_upper_bound[3]
    assert ds.bins.dtype == (torch.uint16 if wide else torch.uint8)
    for lo in range(0, len(test), 1024):
        ds.push_rows(test[lo:lo + 1024])
    for c, j in enumerate(ds.real_feature_idx):
        want = ds.mappers[j].values_to_bins(test[:, j])
        vals = ds.bins[:, c].numpy().astype(np.int64) & 0xFFFF
        np.testing.assert_array_equal(vals, want, err_msg=str(j))


def test_last_chunk_without_newline(tmp_path):
    """A file whose last line has no newline and whose rows fill whole
    chunks: the streamed and two-round loads keep every row, their bins
    equal to the one-shot load's."""
    X, y = _table(768)
    path = str(tmp_path / "t.csv")
    _write(path, y, X, trailing_newline=False)
    base = {"max_bin": 31, "verbosity": -1, "device_type": "cpu"}
    one = tloader.DatasetLoader(TConfig.from_params(base)).load_from_file(
        path)
    for extra in ({"tpu_stream_chunk_rows": 256}, {"two_round": True}):
        ld = tloader.DatasetLoader(TConfig.from_params({**base, **extra}))
        ds = ld._load_streamed(path) if "two_round" not in extra \
            else ld._load_two_round(path, chunk_lines=256)
        assert ds.num_data == 768
        assert torch.equal(ds.bins, one.bins)
        np.testing.assert_array_equal(ds.metadata.label, one.metadata.label)


def test_na_tokens_parse_by_route(x64, tmp_path, monkeypatch):
    """ROADMAP C.38 pinned across the routes of one headerless CSV whose
    cells hold "N/A", "None" and "?": the one-shot load takes the native
    parser, which reads them as 0.0, and the two-round and streamed loads
    the Python parser, which reads NaN, in both packages alike. The three
    NaN routes give equal bins, and so does the one-shot load where the
    native library is missing; the native one-shot load's differ, only
    in the columns with those tokens."""
    compile_cache.clear_programs()
    from lightgbm_tpu_torch import native as tnative
    X, y = _table(900)
    path = str(tmp_path / "na.csv")
    _write(path, y, X)
    with open(path) as fh:
        lines = fh.read().splitlines()
    cols = []
    for i, tok in enumerate(["N/A", "None", "?"]):
        cells = lines[10 + 40 * i].split(",")
        cells[2 + i] = tok
        lines[10 + 40 * i] = ",".join(cells)
        cols.append(1 + i)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    params = {"max_bin": 31, "verbosity": -1}
    got = {}
    for name, extra in (("one-shot", {}), ("two-round", {"two_round": True}),
                        ("streamed", {"tpu_stream_chunk_rows": 256})):
        jl, tl = _loaders({**params, **extra})
        got[name] = tl.load_from_file(path)
        _same(jl.load_from_file(path), got[name])
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    got["python"] = _loaders(params)[1].load_from_file(path)
    for name in ("two-round", "streamed"):
        assert torch.equal(got[name].bins, got["python"].bins), name
    one, nan = got["one-shot"].bins, got["python"].bins
    differ = [j for j in range(X.shape[1])
              if not torch.equal(one[:, j], nan[:, j])]
    assert differ and set(differ) <= set(cols)


def test_columnar_matches_jax_and_streamed(x64, tmp_path):
    """A Parquet file (label first, named columns) through `_load_columnar`
    in record batches of 256 rows: bins and metadata equal to the JAX
    package's, and to the streamed load of the same rows as CSV."""
    compile_cache.clear_programs()
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    X, y = _table()
    names = ["label"] + [f"f{j}" for j in range(X.shape[1])]
    table = pa.table({n: c for n, c in zip(
        names, [y] + [X[:, j] for j in range(X.shape[1])])})
    path = str(tmp_path / "train.parquet")
    pq.write_table(table, path, row_group_size=400)
    params = {"tpu_stream_chunk_rows": 256, "max_bin": 31, "verbosity": -1,
              "bin_construct_sample_cnt": 300}
    jl, tl = _loaders(params)
    td = tl.load_from_file(path)
    jd = jl.load_from_file(path)
    assert td.feature_names == names[1:]
    _same(jd, td)
    csv = str(tmp_path / "train.csv")
    _write(csv, y, X)
    assert torch.equal(tl.load_from_file(csv).bins, td.bins)


def test_stream_shard_switch(tmp_path):
    """``tpu_stream_shard``: "auto" and "off" stream to one device; "on"
    raises, naming ROADMAP A.7."""
    X, y = _table(400)
    for mode in ("auto", "off"):
        cfg = TConfig.from_params({"tpu_stream_chunk_rows": 100,
                                   "tpu_stream_shard": mode})
        assert tstream.stream_matrix(X, label=y, config=cfg).num_data == 400
    cfg = TConfig.from_params({"tpu_stream_chunk_rows": 100,
                               "tpu_stream_shard": "on"})
    with pytest.raises(NotImplementedError, match="A.7"):
        tstream.stream_matrix(X, label=y, config=cfg)


def test_push_rows_flow_matches_jax():
    """The push-rows flow: `create_from_sample` on a sample, `push_rows`
    of raw chunks and `push_binned_rows` of binned ones (labels and
    weights beside them), `finish_load` with query sizes: mappers, bins
    and metadata equal to the JAX package's flow, and the bins to
    `from_matrix`'s."""
    compile_cache.clear_programs()
    from lightgbm_tpu.io import dataset as jds
    X, y = _table(900)
    w = np.linspace(0.5, 2.0, len(y))
    params = {"max_bin": 31, "verbosity": -1}
    out = []
    for mod, cfg in ((jds, JConfig.from_params(params)),
                     (tds, TConfig.from_params(params))):
        ds = mod.Dataset.create_from_sample(X[::3], len(y), config=cfg)
        ds.push_rows(X[:400], label=y[:400], weight=w[:400])
        whole = mod.Dataset.from_matrix(X, config=cfg, reference=ds)
        ds.push_binned_rows(whole.bins[400:], label=y[400:],
                            weight=w[400:])
        out.append((ds.finish_load(group=np.full(9, 100)), whole))
    _same(out[0][0], out[1][0])
    assert torch.equal(out[1][0].bins, out[1][1].bins)


def test_pipeline_depths_bin_alike():
    """``tpu_stream_pipeline_depth``, the JAX package's prefetch depth:
    every count >= 0 is accepted and bins as the default 2 does (the port
    reads and bins on one thread); a negative one raises."""
    X, y = _table(1000)
    bins = [tstream.stream_matrix(X, label=y, config=TConfig.from_params(
        {"tpu_stream_chunk_rows": 128, "tpu_stream_pipeline_depth": d}))
        .bins for d in (0, 1, 2, 3)]
    assert all(torch.equal(bins[0], b) for b in bins[1:])
    with pytest.raises(ValueError, match="pipeline_depth"):
        tstream.stream_matrix(X, label=y, config=TConfig.from_params(
            {"tpu_stream_chunk_rows": 128, "tpu_stream_pipeline_depth": -1}))


def test_streamed_bundles_as_one_shot(x64):
    """EFB after a streamed load (`finish_load` bundles as `from_matrix`
    does): the same bundles and bundled bins as the one-shot dataset and
    the JAX package's `stream_matrix`, ``num_features`` the features F
    and ``num_storage_cols`` the storage columns G < F (C.24's counts
    kept apart), and 2 f64 rounds from it give the one-shot trees."""
    compile_cache.clear_programs()
    rng = np.random.RandomState(6)
    X = np.zeros((900, 12))
    X[np.arange(900), rng.randint(0, 12, 900)] = rng.randint(1, 5, 900)
    y = (X[:, :4].sum(1) > 1).astype(float)
    params = {**BASE, "tpu_stream_chunk_rows": 256}
    tcfg = TConfig.from_params(params)
    st = tstream.stream_matrix(X, label=y, config=tcfg)
    one = tds.Dataset.from_matrix(X, label=y, config=tcfg)
    jd = jstream.stream_matrix(X, label=y, config=JConfig.from_params(params))
    assert st.bundles is not None and jd.bundles is not None
    assert (st.num_features, st.num_storage_cols) == (12, one.num_storage_cols)
    assert st.num_storage_cols < 12
    assert torch.equal(st.bins, one.bins)
    np.testing.assert_array_equal(np.asarray(jd.bins), st._host_bins())
    texts = [_sections(tlgb.train(
        {**params, "device_type": "cpu", **extra},
        tlgb.Dataset(X, label=y), num_boost_round=2,
        verbose_eval=False).model_to_string())
        for extra in ({}, {"tpu_stream_chunk_rows": 0})]
    assert texts[0] == texts[1]
