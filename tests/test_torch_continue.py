"""Two repairs of the port, held against the JAX package on the CPU.

C.35: continued training with validation sets. `train(init_model=,
valid_sets=)` replays the init model's trees onto each validation set, as
the JAX package does: the evals, the best iteration and the f64 model text
are the JAX package's, for a binary and a 3-class model, from a `Booster`
and from a model file; `Booster.add_valid` after training too; and the
CLI's ``task=train`` with ``input_model=`` and ``valid=`` prints each
round's valid metric, equal to the JAX run from the same init scores (the
reference's CLI semantics, ROADMAP C.34).

C.36: prediction early stopping. `predict(pred_early_stop=True)` gives
the JAX package's predictions for a binary and a 3-class model, dense and
CSR, through the native predictor and the torch traversal alike; a huge
margin gives the full walk; the CLI's ``task=predict`` reaches it through
the booster's params. C.37 pins the JAX package's loaded booster, which
always stops early. Every array is made here from seeded numpy data."""
import os

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import compile_cache
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.callback import _format_eval_result

BASE = {"num_leaves": 7, "max_bin": 31, "learning_rate": 0.5,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True, "min_data_in_leaf": 10}
OBJ = {"binary": {"objective": "binary", "metric": "binary_logloss"},
       "multiclass": {"objective": "multiclass", "num_class": 3,
                      "metric": "multi_logloss"}}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement, in the
    test only."""
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _tree_bodies(text):
    """The model's trees without their ``Tree=i`` lines."""
    return [blk.split("\n", 1)[1]
            for blk in _sections(text).split("Tree=")[1:]]


def _data(kind, n=700, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, 5)), 3)
    X[rng.rand(n, 5) < 0.03] = np.nan
    z = np.nan_to_num(X)
    s = z[:, 0] - 0.6 * z[:, 1] + 0.8 * rng.standard_normal(n)
    if kind == "multiclass":
        y = np.digitize(s, [-0.6, 0.6]).astype(float)
    else:
        y = (s > 0).astype(float)
    return X, y


def _init_model(kind, rounds=3):
    """A port booster of ``rounds`` and its model text."""
    X, y = _data(kind)
    p = {**BASE, **OBJ[kind], "device_type": "cpu"}
    bst = tlgb.train(p, tlgb.Dataset(X[:500], label=y[:500]),
                     num_boost_round=rounds, verbose_eval=False)
    return bst, bst.model_to_string()


@pytest.mark.parametrize("kind", list(OBJ))
def test_init_model_with_valid_sets_matches_jax(x64, tmp_path, kind):
    """`train(init_model=, valid_sets=, early_stopping_rounds=2)` for 6
    more rounds, the init model a `Booster` and a model file:
    `evals_result`, `best_iteration`, `best_score` and the f64 model text
    equal the JAX package's (which raised in the port before: ROADMAP
    C.35)."""
    bst0, text = _init_model(kind)
    path = str(tmp_path / "init.txt")
    with open(path, "w") as fh:
        fh.write(text)
    X, y = _data(kind, seed=1)
    out = {}
    for name, lib, init, extra in (
            ("jax", jlgb, path, {}),
            ("booster", tlgb, bst0, {"device_type": "cpu"}),
            ("file", tlgb, path, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        p = {**BASE, **OBJ[kind], **extra}
        ds = lib.Dataset(X[:500], label=y[:500], params=p)
        ev = {}
        bst = lib.train(p, ds, num_boost_round=6, init_model=init,
                        valid_sets=[ds, lib.Dataset(X[500:], label=y[500:],
                                                    reference=ds)],
                        valid_names=["train", "valid"],
                        early_stopping_rounds=2, evals_result=ev,
                        verbose_eval=False)
        out[name] = (ev, bst.best_iteration,
                     {k: dict(v) for k, v in bst.best_score.items()},
                     _sections(bst.model_to_string()))
    assert out["booster"] == out["jax"]
    assert out["file"] == out["jax"]
    assert len(out["jax"][0]["valid"][OBJ[kind]["metric"]]) >= 3


def test_add_valid_after_training_matches_jax(x64):
    """`Booster.add_valid` on a booster with trees: the replayed
    validation scores evaluate as the JAX package's, and the next rounds'
    evals too."""
    X, y = _data("binary", seed=2)
    res = {}
    for name, lib, extra in (("jax", jlgb, {}),
                             ("torch", tlgb, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        p = {**BASE, **OBJ["binary"], **extra}
        ds = lib.Dataset(X[:500], label=y[:500], params=p)
        bst = lib.Booster(params=p, train_set=ds)
        for _ in range(3):
            bst.update()
        bst.add_valid(lib.Dataset(X[500:], label=y[500:], reference=ds),
                      "late")
        evals = [bst.eval_valid()]
        bst.update()
        evals.append(bst.eval_valid())
        res[name] = [[(n, m, float(v)) for n, m, v, _ in e] for e in evals]
    assert res["torch"] == res["jax"]


def _cli_files(tmp_path, kind):
    X, y = _data(kind, n=900, seed=3)
    names = ["label"] + [f"c{j}" for j in range(X.shape[1])]
    for fname, sl in (("train.csv", slice(0, 700)),
                      ("valid.csv", slice(700, None))):
        M = np.concatenate([y[sl, None], X[sl]], axis=1)
        with open(tmp_path / fname, "w") as fh:
            fh.write(",".join(names) + "\n")
            for row in M:
                fh.write(",".join("nan" if np.isnan(v) else f"{v:.6g}"
                                  for v in row) + "\n")
    return X, y


@pytest.mark.parametrize("kind", list(OBJ))
def test_cli_input_model_with_valid(x64, tmp_path, capsys, kind):
    """``task=train`` with ``input_model=`` and ``valid=``: the run exits
    0 and prints each round's valid metric, equal to the JAX package's
    in-process run from the init model's raw scores as the rows' init
    scores (train and valid, the reference CLI's semantics; C.34), and
    its new trees are that run's."""
    compile_cache.clear_programs()
    _cli_files(tmp_path, kind)
    _, text = _init_model(kind)
    (tmp_path / "init.txt").write_text(text)
    metric = OBJ[kind]["metric"]
    args = ["task=train", "data=train.csv", "valid=valid.csv",
            "header=true", "input_model=init.txt", "num_trees=3",
            "output_model=m.txt", "device_type=cpu", f"metric={metric}"] \
        + [f"{k}={v}" for k, v in {**BASE, **OBJ[kind]}.items()
           if k != "metric"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        capsys.readouterr()
        assert tcli.main(args) == 0
        printed = [ln for ln in capsys.readouterr().out.splitlines()
                   if ln.startswith("[")]
    finally:
        os.chdir(cwd)
    prior = jlgb.Booster(model_str=text)
    p = {**BASE, **OBJ[kind]}
    raw = {f: prior.predict(str(tmp_path / f), raw_score=True,
                            data_has_header=True)
           for f in ("train.csv", "valid.csv")}
    compile_cache.clear_programs()
    jp = {**p, "header": True}
    jtr = jlgb.Dataset(str(tmp_path / "train.csv"), params=jp,
                       init_score=raw["train.csv"].reshape(-1, order="F"))
    jva = jlgb.Dataset(str(tmp_path / "valid.csv"), reference=jtr,
                       init_score=raw["valid.csv"].reshape(-1, order="F"))
    ev = {}
    jb = jlgb.train(jp, jtr, num_boost_round=3, valid_sets=[jva],
                    valid_names=["valid.csv"], evals_result=ev,
                    verbose_eval=False)
    want = [f"[{i + 1}]\t" + _format_eval_result(("valid.csv", metric, v,
                                                  False))
            for i, v in enumerate(ev["valid.csv"][metric])]
    assert printed == want
    k = 1 if kind == "binary" else 3
    assert _tree_bodies((tmp_path / "m.txt").read_text())[3 * k:] \
        == _tree_bodies(jb.model_to_string())


def _es_model(kind):
    X, y = _data(kind, n=900, seed=4)
    p = {**BASE, **OBJ[kind], "device_type": "cpu"}
    bst = tlgb.train(p, tlgb.Dataset(X[:600], label=y[:600]),
                     num_boost_round=12 if kind == "binary" else 6,
                     verbose_eval=False)
    return bst, X[600:]


ES = {"pred_early_stop": True, "pred_early_stop_freq": 2,
      "pred_early_stop_margin": 1.0}


@pytest.mark.parametrize("kind", list(OBJ))
def test_pred_early_stop_matches_jax(kind, monkeypatch):
    """`predict(pred_early_stop=True, freq 2, margin 1.0)`: the JAX
    package's predictions, dense and CSR, from the trained booster and a
    loaded one, through the native predictor and the torch traversal
    (the card's route) alike, with atol=0; they differ from the full
    walk on some rows; a margin of 1e30 gives the full walk, and so do
    ``raw_score`` and ``pred_leaf`` (early stopping off)."""
    compile_cache.clear_programs()
    bst, X = _es_model(kind)
    text = bst.model_to_string()
    jb = jlgb.Booster(model_str=text)
    want = jb.predict(X, **ES)
    full = jb.predict(X, pred_early_stop=False)
    assert np.any(want != full)
    loaded = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    X_csr = sp.csr_matrix(np.nan_to_num(X))
    for b in (bst, loaded):
        np.testing.assert_array_equal(b.predict(X, **ES), want)
        np.testing.assert_array_equal(
            b.predict(X_csr, **ES), jb.predict(X_csr, **ES))
        np.testing.assert_array_equal(b.predict(X), full)
        np.testing.assert_array_equal(
            b.predict(X, **{**ES, "pred_early_stop_margin": 1e30}), full)
        np.testing.assert_array_equal(b.predict(X, raw_score=True, **ES),
                                      jb.predict(X, raw_score=True,
                                                 pred_early_stop=False))
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    np.testing.assert_array_equal(loaded.predict(X, **ES), want)
    np.testing.assert_array_equal(
        loaded.predict(X_csr, **ES), jb.predict(X_csr, **ES))


def test_cli_predict_early_stop_matches_jax(tmp_path):
    """``task=predict`` with ``pred_early_stop=true``, freq 2, margin 1.0:
    the prediction file equals the JAX CLI's, and differs from the full
    predictions."""
    bst, X = _es_model("binary")
    (tmp_path / "m.txt").write_text(bst.model_to_string())
    np.savetxt(tmp_path / "rows.tsv", np.nan_to_num(X), delimiter="\t",
               fmt="%.6g")
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("torch", tcli, ["device_type=cpu"])):
        for es in ("true", "false"):
            out = f"{name}_{es}.txt"
            cwd = os.getcwd()
            os.chdir(tmp_path)
            try:
                compile_cache.clear_programs()
                assert mod.main(["task=predict", "data=rows.tsv",
                                 "input_model=m.txt", f"output_result={out}",
                                 f"pred_early_stop={es}",
                                 "pred_early_stop_freq=2",
                                 "pred_early_stop_margin=1.0"]
                                + extra) == 0
            finally:
                os.chdir(cwd)
            outs[(name, es)] = (tmp_path / out).read_text()
    assert outs[("torch", "true")] == outs[("jax", "true")]
    assert outs[("torch", "true")] != outs[("torch", "false")]
    want = "".join(f"{v:g}\n" for v in bst.predict(np.nan_to_num(X)))
    assert outs[("torch", "false")] == want


def test_c37_jax_loaded_booster_always_stops_early():
    """ROADMAP C.37: the JAX package's loaded booster reads its model
    file's ``[pred_early_stop: False]`` with ``bool()``, which is true, so
    it stops early at freq 10 and margin 10 unless told otherwise; the
    port reads the string as the config does and walks every tree."""
    compile_cache.clear_programs()
    bst, X = _es_model("binary")
    jb = jlgb.Booster(model_str=bst.model_to_string())
    assert jb.params["pred_early_stop"] == "False"
    full = jb.predict(X, pred_early_stop=False)
    stopped = jb.predict(X, pred_early_stop=True, pred_early_stop_freq=10,
                         pred_early_stop_margin=10.0)
    np.testing.assert_array_equal(jb.predict(X), stopped)
    loaded = tlgb.Booster(model_str=bst.model_to_string(),
                          params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X), full)
