"""The port's native helpers (`lightgbm_tpu_torch/native.py` over
``src/native/``) against the JAX package's binding of the same sources and
against the port's own Python and torch routes, on the CPU: the parser
(CSV, TSV, LibSVM, the NA tokens), the numerical bin-bound search, the
full-matrix binner (numerical with NaN, categorical, uint16) and the
batch predictor over a flattened forest (binary, 3 classes, leaf
indices, early stopping). Every array is made here from seeded numpy
data."""
import functools
import os
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu import native as jnative
from lightgbm_tpu.io import binning as jbinning
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import binning as tbinning
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.ops import predict as tpredict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """The JAX package's library is this file's oracle. Its `get_lib`
    runs ``make`` in ``src/native`` and loads the file it writes; under
    pytest-xdist every worker runs that make at once while collecting
    tests/test_native.py (its ``skipif``), and a worker whose load meets
    another worker's half-written library takes the library for
    unavailable for good (``_lib_tried``). Load it again once those
    builds are over, in the test only."""
    deadline = time.monotonic() + 180
    while jnative.get_lib() is None and time.monotonic() < deadline:
        time.sleep(2)
        jnative._lib_tried = False
    assert jnative.get_lib() is not None, "the JAX package's library"


@pytest.fixture
def no_native(monkeypatch):
    """The port's Python and torch routes: the library reads as
    unavailable."""
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


def test_library_built_under_build():
    """The library builds from ``src/native/*.cpp`` into
    ``build/torch_native/``, named by the hash of its sources and flags,
    and the build writes nothing under ``src/``."""
    assert tnative.native_available()
    path = tnative.built_path()
    assert path == tnative.library_path()        # OpenMP's flags here
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "torch_native")
    assert os.path.basename(path).startswith("liblgbt_native-")
    assert os.path.isfile(path)
    assert tnative.build() == path
    assert tnative.SRC_DIR == os.path.join(ROOT, "src", "native")
    assert not [f for f in os.listdir(tnative.SRC_DIR)
                if f.startswith("liblgbt_native-") or f.endswith(".tmp")]


def test_build_falls_back_to_the_next_flags(tmp_path, monkeypatch):
    """A host whose compilers all fail the first flag set (an H100 host's
    g++ lacked libgomp's spec file) builds with the next one, OpenMP left
    out, under that set's name; the library loads."""
    import ctypes
    bad = tnative.CXX_FLAGS + ["-fno-such-flag"]
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "FLAG_SETS", (bad, tnative.FLAG_SETS[1]))
    path = tnative.build()
    assert "-fopenmp" not in tnative.FLAG_SETS[1]
    assert path == tnative.library_path(tnative.FLAG_SETS[1])
    assert not os.path.exists(tnative.library_path(bad))
    tnative._declare(ctypes.CDLL(path))


def _text_file(tmp_path, fmt):
    rng = np.random.RandomState(11)
    n, f = 300, 6
    M = np.round(rng.standard_normal((n, f + 1)), 4)
    if fmt == "libsvm":
        lines = [" ".join([f"{r[0]:g}"] + [f"{j}:{v:g}" for j, v in
                                           enumerate(r[1:]) if v > -0.2])
                 for r in M]
    else:
        sep = {"csv": ",", "tsv": "\t", "na": ","}[fmt]
        rows = [[f"{v:g}" for v in r] for r in M]
        if fmt == "na":
            for i, tok in enumerate(["", "NA", "nan", "null", "N/A",
                                     "None", "?", "NaN"]):
                rows[5 + 7 * i][1 + i % f] = tok
        lines = [sep.join(r) for r in rows]
    path = str(tmp_path / f"data.{fmt}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path, lines


@pytest.mark.parametrize("fmt", ["csv", "tsv", "libsvm", "na"])
def test_parse_file_matches_jax_and_python(tmp_path, fmt):
    """`native.parse_file` equals the JAX package's call and the port's
    Python parse of the same lines (NaN in the same places), and the
    loader's `parse_file` takes it for a local file without a header.
    Both packages' native parser reads the tokens "N/A", "None" and "?"
    as 0.0, where their Python parser reads NaN (ROADMAP C.38): the port
    keeps the JAX package's choice of route, so only those cells
    differ."""
    compile_cache.clear_programs()
    path, lines = _text_file(tmp_path, fmt)
    tl, tf, tfmt = tnative.parse_file(path, 0)
    jl, jf, jfmt = jnative.parse_file(path, 0)
    assert tfmt == jfmt == ("libsvm" if fmt == "libsvm" else
                            "tsv" if fmt == "tsv" else "csv")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
    pl, pf = tparser.parse_dense(lines, tparser.create_parser(lines[:32], 0))
    np.testing.assert_array_equal(tl, pl)
    if fmt == "na":
        toks = np.asarray([ln.split(",")[1:] for ln in lines])
        zero = np.isin(toks, ["N/A", "None", "?"])
        assert zero.sum() == 3
        assert np.all(tf[zero] == 0.0) and np.all(np.isnan(pf[zero]))
        pf[zero] = 0.0
    np.testing.assert_array_equal(tf, pf)
    from lightgbm_tpu_torch.io.loader import DatasetLoader
    ll, lf, _ = DatasetLoader(TConfig.from_params(
        {"device_type": "cpu"})).parse_file(path)
    np.testing.assert_array_equal(lf, tf)
    np.testing.assert_array_equal(ll, tl)


def _columns():
    """Sampled columns: normal, heavy duplicates, few distinct values,
    all positive with zeros, all negative, and one value."""
    rng = np.random.RandomState(5)
    return {
        "normal": rng.standard_normal(3000),
        "dups": np.round(rng.standard_normal(3000), 1),
        "few": rng.randint(1, 6, 3000).astype(float),
        "positive": np.abs(rng.standard_normal(2000)) + 0.5,
        "negative": -np.abs(rng.standard_normal(2000)) - 0.1,
        "one": np.full(500, 2.5),
    }


@pytest.mark.parametrize("max_bin", [15, 255])
@pytest.mark.parametrize("col", list(_columns()))
def test_find_bin_numerical_matches_jax(col, max_bin):
    """`find_bin_numerical` equals the JAX package's call bound for bound,
    and a `BinMapper` found through it equals the JAX package's (native)
    mapper and has the bounds of the port's Python search."""
    compile_cache.clear_programs()
    vals = _columns()[col]
    total = len(vals) + 700            # 700 implied zeros
    got = tnative.find_bin_numerical(vals, total, max_bin, 3)
    np.testing.assert_array_equal(
        got, jnative.find_bin_numerical(vals, total, max_bin, 3))
    for missing in (False, True):
        v = vals.copy()
        if missing:
            v[::17] = np.nan
        tm = tbinning.BinMapper().find_bin(v, total, max_bin, 3, 20)
        jm = jbinning.BinMapper().find_bin(v, total, max_bin, 3, 20)
        assert tm.to_dict() == jm.to_dict()


def test_find_bin_python_bounds_equal_native(no_native):
    """With the library unavailable the mapper's bounds, bin count, missing
    type and default bin are those the native search gives."""
    compile_cache.clear_programs()
    for col, vals in _columns().items():
        total = len(vals) + 700
        py = tbinning.BinMapper().find_bin(vals, total, 63, 3, 20)
        nat = jbinning.BinMapper().find_bin(vals, total, 63, 3, 20)
        np.testing.assert_array_equal(py.bin_upper_bound,
                                      nat.bin_upper_bound, err_msg=col)
        assert (py.num_bin, py.missing_type, py.default_bin) \
            == (nat.num_bin, nat.missing_type, nat.default_bin), col


def _bin_table(wide):
    rng = np.random.RandomState(8)
    n = 4000
    X = rng.standard_normal((n, 5))
    X[rng.rand(n, 5) < 0.08] = np.nan
    X[:, 2] = rng.randint(0, 12, n)            # categorical
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[:, 3] = np.round(X[:, 3], 1)
    params = {"max_bin": 400 if wide else 63, "verbosity": -1,
              "categorical_feature": "2", "min_data_in_bin": 1}
    return X, params


@pytest.mark.parametrize("wide", [False, True], ids=["uint8", "uint16"])
def test_bin_matrix_matches_jax_and_torch(wide, monkeypatch):
    """A CPU dataset binned by the native binner equals the JAX package's
    bins (its native route) and the port's torch route (the numerical
    columns by `values_to_bins_torch`, the categorical one on the host),
    NaN and categorical columns, uint8 and uint16."""
    compile_cache.clear_programs()
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io import dataset as jds
    X, params = _bin_table(wide)
    cfg = TConfig.from_params(params)
    td = tds.Dataset.from_matrix(X, config=cfg)
    jd = jds.Dataset.from_matrix(X, config=JConfig.from_params(params))
    assert str(td.bins.dtype) == ("torch.uint16" if wide else "torch.uint8")
    np.testing.assert_array_equal(td._host_bins(), np.asarray(jd.bins))
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    torch_route = tds.Dataset.from_matrix(X, config=cfg)
    np.testing.assert_array_equal(torch_route._host_bins(), td._host_bins())


@functools.lru_cache(maxsize=None)
def _booster(kind, rounds=4):
    rng = np.random.RandomState(2)
    X = rng.standard_normal((800, 6))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[:, 5] = rng.randint(0, 7, len(X))
    if kind == "multiclass":
        y = np.clip(np.floor(np.nan_to_num(X[:, 0]) + 1.5), 0, 2)
        obj = {"objective": "multiclass", "num_class": 3}
    else:
        y = (np.nan_to_num(X[:, 0]) + 0.5 * (X[:, 5] > 3) > 0.3)
        obj = {"objective": "binary"}
    params = {**obj, "num_leaves": 7, "learning_rate": 0.5,
              "verbosity": -1, "device_type": "cpu",
              "categorical_feature": "5"}
    bst = tlgb.train(params, tlgb.Dataset(X, label=y.astype(float)),
                     num_boost_round=rounds, verbose_eval=False)
    return bst, X


@pytest.mark.parametrize("mode", ["binary", "multiclass", "leaf",
                                  "early_stop"])
def test_predict_forest_matches_jax_and_torch(mode):
    """`flatten_forest` equals the JAX package's arrays; `predict_forest`
    equals the JAX package's call and the port's torch traversal with
    atol=0: raw scores of a binary and a 3-class model (categorical
    splits, NaN), leaf indices, and early stopping (freq 2 iterations,
    margin 1.0) of the 3-class model."""
    compile_cache.clear_programs()
    bst, X = _booster("binary" if mode == "binary" else "multiclass")
    k = bst.num_tree_per_iteration
    trees = bst.trees
    flat = tpredict.flatten_forest(trees, k)
    jflat = jpredict.flatten_forest(trees, k)
    assert flat.keys() == jflat.keys()
    for key in flat:
        np.testing.assert_array_equal(flat[key], jflat[key], err_msg=key)
        assert flat[key].dtype == jflat[key].dtype, key
    leaf = mode == "leaf"
    es = (2 * k, 1.0) if mode == "early_stop" else (0, 0.0)
    got = tnative.predict_forest(X, flat, k, leaf, *es)
    np.testing.assert_array_equal(
        got, jnative.predict_forest(X, jflat, k, leaf, *es))
    walk = tpredict.predict_raw_values(
        trees, X, leaf_index=leaf, num_class=k,
        early_stop=es if es[0] else None)
    np.testing.assert_array_equal(got, walk)
    if mode == "early_stop":
        full = tnative.predict_forest(X, flat, k)
        assert np.any(got != full)
