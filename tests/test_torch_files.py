"""The port's data files and CLI against the JAX package on the CPU: the
text parser (CSV, TSV, space, LibSVM, the NA tokens, ragged rows), the
loader (header, label / weight / group / ignore columns by index and by
``name:``, the ``.weight`` / ``.query`` / ``.init`` sidecars, a
validation file binned with the training set's mappers), the binary
dataset file (byte-equal to the JAX package's, each package loading the
other's), training and predicting from files, the CLI's ``task=train``
(with ``valid=``, ``save_binary``, a run from the ``.bin`` and
``input_model``), ``task=predict`` and ``task=convert_model`` (the C++
text equal, compiled and run), ``python -m lightgbm_tpu_torch``, and the
file options the port lacks, which raise. Every file is written here
from seeded numpy data."""
import os
import shutil
import subprocess
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import compile_cache
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import dataset as jds
from lightgbm_tpu.io import loader as jloader
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.io import loader as tloader
from lightgbm_tpu_torch.io import parser as tparser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _table(n=800, f=6, seed=0, nan=0.05):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, f)), 4)
    X[rng.rand(n, f) < nan] = np.nan
    z = np.nan_to_num(X)
    y = (z[:, 0] - 0.7 * z[:, 1] + 0.3 * rng.standard_normal(n) > 0)
    return X, y.astype(np.float64)


def _fmt(v):
    return "nan" if np.isnan(v) else f"{v:.6g}"


def _write_delimited(path, y, X, sep=",", header=None, extra=None):
    """label first, then the features (and ``extra`` columns after);
    NaN as "nan"."""
    cols = [y[:, None], X] + ([] if extra is None else [extra])
    M = np.concatenate(cols, axis=1)
    with open(path, "w") as fh:
        if header is not None:
            fh.write(sep.join(header) + "\n")
        for row in M:
            fh.write(sep.join(_fmt(v) for v in row) + "\n")


def _both_loaders(params):
    return (jloader.DatasetLoader(JConfig.from_params(params)),
            tloader.DatasetLoader(TConfig.from_params(
                {**params, "device_type": "cpu"})))


def _assert_same_dataset(j, t):
    """Mappers, bins, label, weight, query boundaries, init score."""
    assert [m.to_dict() for m in j.mappers] \
        == [m.to_dict() for m in t.mappers]
    np.testing.assert_array_equal(j.used_feature_map, t.used_feature_map)
    assert str(j.bins.dtype) == str(t.bins.dtype).replace("torch.", "")
    np.testing.assert_array_equal(np.asarray(j.bins), t._host_bins())
    for k in ("label", "weight", "query_boundaries", "init_score"):
        a, b = getattr(j.metadata, k), getattr(t.metadata, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert j.feature_names == t.feature_names


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------
def _parser_lines(fmt, case):
    rng = np.random.RandomState(3)
    n, f = 40, 5
    M = np.round(rng.standard_normal((n, f + 1)), 3)
    if fmt == "libsvm":
        lines = []
        for r in M:
            toks = [f"{r[0]:g}"] + [f"{j}:{v:g}" for j, v in
                                    enumerate(r[1:]) if v > -0.3]
            lines.append(" ".join(toks))
        if case == "na":
            lines[3] = lines[3] + " 7:nan 8:NA"
        if case == "ragged":
            lines[35] = "1 0:1.5"
        return lines
    sep = {"csv": ",", "tsv": "\t", "space": " "}[fmt]
    rows = [[f"{v:g}" for v in r] for r in M]
    if case == "na":
        for i, tok in enumerate(["", "NA", "nan", "null", "N/A", "None",
                                 "?", "abc"]):
            rows[2 + i][1 + i % f] = tok
    lines = [sep.join(r) for r in rows]
    if case == "ragged":
        # past the 32 lines the format is sniffed from
        lines[34] = sep.join(rows[34][:3])
        lines[36] = sep.join(rows[36] + ["9"])
    return lines


@pytest.mark.parametrize("case", ["clean", "na", "ragged"])
@pytest.mark.parametrize("fmt", ["csv", "tsv", "space", "libsvm"])
def test_parser_matches_jax(fmt, case):
    """Labels and features equal to the JAX `parse_dense`, NaN in the
    same places, for every format, the NA tokens and ragged rows."""
    lines = _parser_lines(fmt, case)
    assert tparser.detect_format(lines[:32]) \
        == jparser.detect_format(lines[:32]) == fmt
    jl, jf = jparser.parse_dense(lines, jparser.create_parser(lines[:32]))
    tl, tf = tparser.parse_dense(lines, tparser.create_parser(lines[:32]))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == jf.shape
    if case == "na" and fmt != "libsvm":
        assert np.isnan(tf).sum() >= 8


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------
LOADER_CASES = {
    "plain": ({}, False),
    "header_names": ({"header": True, "label_column": "name:y",
                      "weight_column": "name:w", "group_column": "name:q",
                      "ignore_column": "name:f2"}, True),
    "header_index": ({"header": True, "label_column": "0",
                      "weight_column": "6", "group_column": "7",
                      "ignore_column": "1,3"}, True),
    "categorical": ({"categorical_feature": "4"}, False),
    "sidecars": ({}, False),
}


def _loader_file(tmp_path, case):
    X, y = _table()
    rng = np.random.RandomState(1)
    if case == "categorical":
        X[:, 4] = rng.randint(0, 9, len(y))
    path = str(tmp_path / "train.csv")
    params, has_cols = LOADER_CASES[case]
    if has_cols:
        w = np.round(rng.uniform(0.5, 2.0, len(y)), 3)
        q = np.repeat(np.arange(len(y) // 20), 20).astype(float)
        names = ["y"] + [f"f{j}" for j in range(X.shape[1])] + ["w", "q"]
        _write_delimited(path, y, X, header=names,
                         extra=np.stack([w, q], axis=1))
    else:
        _write_delimited(path, y, X)
    if case == "sidecars":
        np.savetxt(path + ".weight", rng.uniform(0.5, 2.0, len(y)))
        np.savetxt(path + ".query", np.full(len(y) // 40, 40), fmt="%d")
        np.savetxt(path + ".init", rng.standard_normal(len(y)) * 0.1)
    return path, params


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax(tmp_path, case):
    """Mappers, bins, label, weight, query boundaries and init score equal
    to the JAX `DatasetLoader`'s for each column option and sidecar, and
    for a validation file binned with the training set's mappers."""
    path, params = _loader_file(tmp_path, case)
    params = {**params, "max_bin": 31, "verbosity": -1}
    jl, tl = _both_loaders(params)
    jd, td = jl.load_from_file(path), tl.load_from_file(path)
    _assert_same_dataset(jd, td)
    if case == "sidecars":
        assert td.metadata.init_score is not None
        assert len(td.metadata.query_boundaries) == len(td.metadata.label) \
            // 40 + 1
    X, y = _table(300, seed=9)
    vpath = str(tmp_path / "valid.csv")
    _write_delimited(vpath, y, X)
    vparams = {k: v for k, v in params.items()
               if k not in ("header", "weight_column", "group_column",
                            "ignore_column", "label_column")}
    jl, tl = _both_loaders(vparams)
    _assert_same_dataset(
        jl.load_from_file_align_with_other_dataset(vpath, jd),
        tl.load_from_file_align_with_other_dataset(vpath, td))


def test_dataset_from_file_trains_as_jax(x64, tmp_path):
    """`Dataset(path)` and a validation `Dataset(path, reference=)`:
    the f64 trees and the validation metric equal the JAX package's; a
    binary file of either package trains to the same trees."""
    path, _ = _loader_file(tmp_path, "sidecars")
    X, y = _table(300, seed=9)
    vpath = str(tmp_path / "valid.csv")
    _write_delimited(vpath, y, X)
    params = {**BASE, "objective": "binary", "metric": "binary_logloss"}
    out = {}
    for name, lib, extra in (("jax", jlgb, {}),
                             ("torch", tlgb, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        p = {**params, **extra}
        ds = lib.Dataset(path, params=p)
        ev = {}
        bst = lib.train(p, ds, num_boost_round=4,
                        valid_sets=[lib.Dataset(vpath, reference=ds)],
                        evals_result=ev, verbose_eval=False)
        out[name] = (bst, ev)
    text = _sections(out["torch"][0].model_to_string())
    assert text == _sections(out["jax"][0].model_to_string())
    assert out["torch"][1] == out["jax"][1]
    jbin, tbin = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jlgb.Dataset(path, params=params).save_binary(jbin)
    p = {**params, "device_type": "cpu"}
    for b in (jbin, tbin):
        if b == tbin:
            tlgb.Dataset(path, params=p).save_binary(tbin)
        bst = tlgb.train(p, tlgb.Dataset(b, params=p), num_boost_round=4,
                         verbose_eval=False)
        assert _sections(bst.model_to_string()) == text


# ---------------------------------------------------------------------------
# the binary dataset file
# ---------------------------------------------------------------------------
def _binary_case(case):
    X, y = _table(600, f=8, seed=4)
    kw = {}
    params = {"max_bin": 63, "verbosity": -1}
    if case == "meta":
        rng = np.random.RandomState(2)
        kw = {"weight": rng.uniform(0.5, 2, len(y)),
              "group": np.full(30, 20),
              "init_score": rng.standard_normal(len(y))}
    elif case == "uint16":
        params["max_bin"] = 400
        X = np.random.RandomState(5).standard_normal((1500, 4))
        y = (X[:, 0] > 0).astype(float)
    elif case == "bundled":
        rng = np.random.RandomState(6)
        dense = np.zeros((600, 12))
        cols = rng.randint(0, 12, 600)
        dense[np.arange(600), cols] = rng.randint(1, 5, 600)
        X = sp.csr_matrix(dense)
        params.update(objective="binary")
    return X, y, kw, params


@pytest.mark.parametrize("case", ["plain", "meta", "uint16", "bundled"])
def test_binary_file_is_jax_bytes(tmp_path, case):
    """The port's binary file equals the JAX package's byte for byte
    (uint8, uint16 and EFB-bundled bins, with weights, query boundaries
    and init scores); each package loads the other's file to equal
    bins and metadata."""
    X, y, kw, params = _binary_case(case)
    maker_j = jds.Dataset.from_sparse if sp.issparse(X) \
        else jds.Dataset.from_matrix
    maker_t = tds.Dataset.from_sparse if sp.issparse(X) \
        else tds.Dataset.from_matrix
    jd = maker_j(X, label=y, config=JConfig.from_params(params), **kw)
    td = maker_t(X, label=y, config=TConfig.from_params(params), **kw)
    if case == "bundled":
        assert td.bundles is not None and jd.bundles is not None
    if case == "uint16":
        assert str(td.bins.dtype) == "torch.uint16"
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jd.save_binary(jp)
    td.save_binary(tp)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    _assert_same_dataset(jds.Dataset.load_binary(tp),
                         tds.Dataset.load_binary(jp))
    back = tds.Dataset.load_binary(tp)
    assert back.bins.dtype == td.bins.dtype
    assert (back.bundles is None) == (td.bundles is None)


def test_subset_shares_mappers():
    """`Dataset.subset`: the rows' bins, label, weight and init score,
    the mappers shared, as the JAX package's."""
    X, y, kw, params = _binary_case("meta")
    jd = jds.Dataset.from_matrix(X, label=y,
                                 config=JConfig.from_params(params), **kw)
    td = tds.Dataset.from_matrix(X, label=y,
                                 config=TConfig.from_params(params), **kw)
    idx = np.random.RandomState(0).choice(len(y), 250, replace=False)
    js, ts = jd.subset(idx), td.subset(idx)
    assert ts.mappers is td.mappers
    assert ts.metadata.query_boundaries is None
    _assert_same_dataset(js, ts)


# ---------------------------------------------------------------------------
# predicting from a file
# ---------------------------------------------------------------------------
def test_predict_from_file_matches_jax(x64, tmp_path):
    """`Booster.predict(path)`: a labelled file, and a label-free one
    (its column count is the model's feature count), predict as the JAX
    package's booster does; `pred_contrib` raises until SHAP is ported."""
    X, y = _table(500)
    params = {**BASE, "objective": "binary"}
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    jb = jlgb.Booster(model_str=tb.model_to_string())
    lab, free = str(tmp_path / "lab.tsv"), str(tmp_path / "free.tsv")
    _write_delimited(lab, y, X, sep="\t")
    with open(free, "w") as fh:
        for row in X:
            fh.write("\t".join(_fmt(v) for v in row) + "\n")
    for path in (lab, free):
        np.testing.assert_array_equal(tb.predict(path), jb.predict(path))
    np.testing.assert_array_equal(tb.predict(free), tb.predict(X))
    with pytest.raises(NotImplementedError, match="A.5"):
        tb.predict(X, pred_contrib=True)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli_files(tmp_path, objective="binary", n=900):
    X, y = _table(n, seed=12)
    if objective == "regression":
        y = np.nan_to_num(X[:, 0]) * 2 + np.nan_to_num(X[:, 2])
    tr, te = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    names = ["label"] + [f"c{j}" for j in range(X.shape[1])]
    _write_delimited(tr, y[:700], X[:700], header=names)
    _write_delimited(te, y[700:], X[700:], header=names)
    return tr, te, X, y


def _model_lines(path):
    """The model file but for the lines C.25 names, which the packages
    write differently ([device_type: ...])."""
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("[device_type:")]


def _run_both(tmp_path, args):
    """The JAX CLI's and the port's `main` on the same arguments, each in
    a directory of its own holding the same input files; returns the two
    directories."""
    dirs = {}
    for name, mod in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        for f in os.listdir(tmp_path):
            src = tmp_path / f
            if src.is_file():
                shutil.copy(src, d / f)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            compile_cache.clear_programs()
            extra = ["device_type=cpu"] if name == "torch" else []
            assert mod.main(list(args) + extra) == 0
        finally:
            os.chdir(cwd)
        dirs[name] = d
    return dirs["jax"], dirs["torch"]


def test_cli_train_predict_convert_match_jax(x64, tmp_path, capsys):
    """`task=train` with a header, `valid=`, `save_binary` and a metric
    each iteration; then `task=predict` and `task=convert_model` on the
    model: the model files are equal but for C.25's lines, the
    prediction files equal, the C++ text equal; the compiled C++ scores
    1,000 rows within 1e-12 of the model's raw scores."""
    _cli_files(tmp_path)
    with open(tmp_path / "train.conf", "w") as fh:
        fh.write("task = train\nobjective = binary\ndata = train.csv\n"
                 "valid = test.csv\nheader = true\nnum_trees = 4\n"
                 "num_leaves = 15\nmax_bin = 63\nmetric = auc\n"
                 "is_save_binary_file = true\ntpu_grow_mode = leafwise\n"
                 "tpu_use_f64_hist = true\nverbosity = -1\n"
                 "output_model = model.txt\n")
    jd, td = _run_both(tmp_path, ["config=train.conf"])
    assert _model_lines(jd / "model.txt") == _model_lines(td / "model.txt")
    assert (td / "train.csv.bin").read_bytes() \
        == (jd / "train.csv.bin").read_bytes()
    out = capsys.readouterr().out
    assert "valid_0" not in out and "test.csv's auc" in out
    for d in (jd, td):
        shutil.copy(td / "model.txt", d / "model_t.txt")
    pred = ["task=predict", "data=test.csv", "header=true",
            "input_model=model_t.txt", "output_result=preds.txt"]
    jd, td = _run_both(tmp_path, pred)
    assert (td / "preds.txt").read_text() == (jd / "preds.txt").read_text()
    jd, td = _run_both(tmp_path, ["task=convert_model",
                                  "input_model=model_t.txt",
                                  "convert_model=pred.cpp"])
    code = (td / "pred.cpp").read_text()
    assert code == (jd / "pred.cpp").read_text()
    _check_compiled(tmp_path, code, td / "model_t.txt")


def _check_compiled(tmp_path, code, model_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    X = np.random.RandomState(8).standard_normal((1000, 6))
    X[::7, 1] = np.nan
    np.savetxt(tmp_path / "rows.txt", X)
    main = code + r'''
#include <cstdio>
int main() {
  double row[6];
  FILE* f = std::fopen("rows.txt", "r");
  while (true) {
    for (int j = 0; j < 6; ++j) {
      char tok[64];
      if (std::fscanf(f, "%63s", tok) != 1) return 0;
      row[j] = std::strtod(tok, nullptr);
    }
    std::printf("%.17g\n", PredictRaw(row, 0));
  }
}
'''
    (tmp_path / "main.cpp").write_text(main.replace(
        "#include <cstdio>", "#include <cstdio>\n#include <cstdlib>"))
    exe = str(tmp_path / "pred")
    subprocess.run([cxx, "-O1", "-o", exe, str(tmp_path / "main.cpp")],
                   check=True)
    got = np.array([float(v) for v in subprocess.run(
        [exe], cwd=tmp_path, check=True, capture_output=True,
        text=True).stdout.split()])
    ref = tlgb.Booster(model_file=str(model_path),
                       params={"device_type": "cpu"}).predict(
                           X, raw_score=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _tree_bodies(text):
    """The tree blocks of a model text without their ``Tree=i`` lines."""
    return [blk.split("\n", 1)[1]
            for blk in _sections(text).split("Tree=")[1:]]


def test_cli_binary_rerun_and_input_model(x64, tmp_path):
    """A second run from the `.bin` gives the first run's model text. A
    run with `input_model=` continues training as the reference's CLI
    does: the init model's raw scores are the rows' init scores and its
    trees stay at the front; the new trees equal those of a JAX run from
    the same init scores. The JAX CLI adds the init model to the scores a
    second time (ROADMAP C.34): its new trees differ and its training
    error rises above the init model's, while the port's falls."""
    tr, _, _, _ = _cli_files(tmp_path, "regression")
    common = ["task=train", "objective=regression", "num_trees=3",
              "num_leaves=7", "max_bin=31", "learning_rate=1",
              "tpu_grow_mode=leafwise", "tpu_use_f64_hist=true",
              "verbosity=-1", "header=true"]
    jd, td = _run_both(tmp_path, common + ["data=train.csv",
                                           "save_binary=true",
                                           "output_model=m1.txt"])
    first = _model_lines(td / "m1.txt")
    assert first == _model_lines(jd / "m1.txt")
    cwd = os.getcwd()
    os.chdir(td)
    try:
        assert tcli.main(common + ["data=train.csv.bin", "device_type=cpu",
                                   "output_model=m2.txt"]) == 0
    finally:
        os.chdir(cwd)
    # equal up to the params trailer, which names its own run's files
    body = "\n".join(first)
    body = body[:body.index("end of trees")]
    assert (td / "m2.txt").read_text().startswith(body)
    shutil.copy(td / "m1.txt", tmp_path / "init.txt")
    jd, td = _run_both(tmp_path, common + ["data=train.csv",
                                           "input_model=init.txt",
                                           "num_trees=2",
                                           "output_model=m3.txt"])
    cont = (td / "m3.txt").read_text()
    init = (td / "init.txt").read_text()
    assert _tree_bodies(cont)[:3] == _tree_bodies(init)
    prior = jlgb.Booster(model_file=str(td / "init.txt"))
    raw = prior.predict(tr, raw_score=True, data_has_header=True)
    params = {k: v for k, v in (a.split("=") for a in common[1:])
              if k != "num_trees"}
    compile_cache.clear_programs()
    jb = jlgb.train(params, jlgb.Dataset(tr, params=params, init_score=raw),
                    num_boost_round=2, verbose_eval=False)
    assert _tree_bodies(cont)[3:] == _tree_bodies(jb.model_to_string())
    jcont = (jd / "m3.txt").read_text()
    assert _tree_bodies(jcont)[:3] == _tree_bodies(init)
    assert _tree_bodies(jcont)[3:] != _tree_bodies(cont)[3:]
    labels, feats, _ = tloader.DatasetLoader(TConfig.from_params(
        {"header": True, "device_type": "cpu"})).parse_file(tr)

    def rmse(path):
        bst = tlgb.Booster(model_file=str(path),
                           params={"device_type": "cpu"})
        return float(np.sqrt(np.mean((bst.predict(feats) - labels) ** 2)))

    assert rmse(td / "m3.txt") < rmse(td / "init.txt") < rmse(jd / "m3.txt")


def test_cli_module_subprocess(tmp_path):
    """`python -m lightgbm_tpu_torch` trains from a config file and
    writes its model, in a process of its own."""
    _cli_files(tmp_path)
    (tmp_path / "t.conf").write_text(
        "task=train\nobjective=binary\ndata=train.csv\nheader=true\n"
        "num_trees=2\nnum_leaves=7\nverbosity=-1\ndevice_type=cpu\n"
        "output_model=m.txt\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                          "config=t.conf"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Finished training" in res.stdout
    assert tlgb.Booster(model_file=str(tmp_path / "m.txt"),
                        params={"device_type": "cpu"}).num_trees() == 2


@pytest.mark.parametrize("option", ["refit", "serve", "trace",
                                    "checkpoint"])
def test_missing_options_raise(tmp_path, option):
    """A file or CLI option the port lacks raises NotImplementedError
    naming its ROADMAP item; none is ignored."""
    tr, te, X, y = _cli_files(tmp_path)
    base = ["objective=binary", f"data={tr}", "header=true", "num_trees=1",
            "verbosity=-1", "device_type=cpu",
            f"output_model={tmp_path / 'm.txt'}"]
    args = {"refit": ["task=refit", f"input_model={tmp_path / 'm.txt'}"],
            "serve": ["task=serve"],
            "trace": ["tpu_trace=true"],
            "checkpoint": [f"tpu_checkpoint_dir={tmp_path / 'ck'}"]}[option]
    item = {"refit": "A.5", "serve": "A.6", "trace": "A.9",
            "checkpoint": "A.8"}[option]
    with pytest.raises(NotImplementedError, match=item):
        tcli.Application(base + args).run()


def test_file_io_registry(tmp_path):
    """A registered scheme serves a data file and its sidecar to the
    loader, as the JAX package's registry does."""
    from lightgbm_tpu_torch.io import file_io
    store = {}

    def opener(path, mode="r", **kw):
        key = path.split("://", 1)[1]
        import io
        if key not in store:
            raise FileNotFoundError(path)
        return io.StringIO(store[key])

    X, y = _table(200)
    path = tmp_path / "a.tsv"
    _write_delimited(str(path), y, X, sep="\t")
    store["a.tsv"] = path.read_text()
    store["a.tsv.weight"] = "\n".join(["1.5"] * 200)
    file_io.register_filesystem("mem", opener)
    try:
        assert file_io.exists("mem://a.tsv")
        assert not file_io.exists("mem://b.tsv")
        ds = tloader.DatasetLoader(TConfig.from_params(
            {"verbosity": -1, "device_type": "cpu"})).load_from_file(
                "mem://a.tsv")
    finally:
        file_io._SCHEMES.pop("mem", None)
    assert ds.num_data == 200
    np.testing.assert_array_equal(ds.metadata.weight, np.full(200, 1.5,
                                                              np.float32))
