"""Continued training (``init_model``) and cross validation (`cv`) of
the port against the JAX package on the CPU: the model text of a
continued run, binary and multiclass, from a `Booster`, from a model
file the port wrote and from one the JAX package wrote, equal to the
JAX package's continued run (f64 leaf-wise trees); the folds of `cv`
(plain, shuffled, stratified, query-grouped, a ``folds`` object) equal,
and its result dict within 1e-12; early stopping in `cv` (which raises
in the JAX package, ROADMAP C.33) cutting the results at the best mean;
``return_cvbooster``. The JAX runs clear `compile_cache.clear_programs()`
first (ROADMAP C.19: the same labels train again and again)."""
import jax
import jax.experimental
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu import engine as jengine
from lightgbm_tpu.models import device_learner as JDL
from lightgbm_tpu_torch import engine as tengine

BASE = {"num_leaves": 7, "max_bin": 63, "learning_rate": 0.2,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture
def jax_mask_fixed(x64, monkeypatch):
    """The JAX learner with its feature mask over every feature of
    bundled data (ROADMAP C.24, as tests/test_torch_efb.py corrects it):
    ``num_real_features`` is the storage column count there."""
    orig = JDL.DeviceTreeLearner.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        if self.bundled:
            self.num_real_features = self.num_features
    monkeypatch.setattr(JDL.DeviceTreeLearner, "__init__", init)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _data(n=1500, seed=0, classes=2, groups=False):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 6))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    m = z[:, 0] - 0.7 * z[:, 1] * z[:, 2] + 0.4 * np.sin(2 * z[:, 3])
    if classes == 0:
        y = m + 0.2 * rng.standard_normal(n)
    elif classes == 2:
        y = (rng.rand(n) < 1 / (1 + np.exp(-2 * m))).astype(np.float64)
    else:
        y = np.digitize(m + 0.3 * rng.standard_normal(n),
                        np.linspace(-0.6, 0.6, classes - 1)).astype(
                            np.float64)
    if groups:
        y = np.clip(np.round(m + 1.5), 0, 3)
    return X, y


def _params(classes):
    if classes == 2:
        return {**BASE, "objective": "binary"}
    return {**BASE, "objective": "multiclass", "num_class": classes}


@pytest.mark.parametrize("source", ["booster", "port_file", "jax_file"])
@pytest.mark.parametrize("classes", [2, 3])
def test_init_model_matches_jax(x64, tmp_path, classes, source):
    """`train(init_model=)` from a `Booster`, a port model file and a
    JAX model file: the whole continued model (the old trees first) has
    the JAX package's tree sections, and its raw predictions are the
    JAX package's."""
    X, y = _data(classes=classes)
    params = _params(classes)
    tparams = {**params, "device_type": "cpu"}
    compile_cache.clear_programs()
    jfirst = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=3,
                        verbose_eval=False)
    tfirst = tlgb.train(tparams, tlgb.Dataset(X, label=y),
                        num_boost_round=3, verbose_eval=False)
    assert _sections(tfirst.model_to_string()) \
        == _sections(jfirst.model_to_string())
    if source == "booster":
        jinit, tinit = jfirst, tfirst
    else:
        path = str(tmp_path / "init.txt")
        (jfirst if source == "jax_file" else tfirst).save_model(path)
        jinit = tinit = path
    X2, y2 = _data(classes=classes, seed=1)
    compile_cache.clear_programs()
    jb = jlgb.train(params, jlgb.Dataset(X2, label=y2), num_boost_round=3,
                    init_model=jinit, verbose_eval=False)
    tb = tlgb.train(tparams, tlgb.Dataset(X2, label=y2), num_boost_round=3,
                    init_model=tinit, verbose_eval=False)
    text = _sections(tb.model_to_string())
    assert text == _sections(jb.model_to_string())
    assert text.startswith(_sections(tfirst.model_to_string()))
    assert tb.num_trees() == 6 * (1 if classes == 2 else classes)
    np.testing.assert_array_equal(tb.predict(X2[:300], raw_score=True),
                                  jb.predict(X2[:300], raw_score=True))


def test_init_model_replays_uint16_and_bundled_bins(jax_mask_fixed):
    """The replay reads the training matrix whatever its storage: uint16
    bins (``max_bin`` 511) and EFB-bundled bins give the JAX package's
    continued model (its C.24 mask corrected)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(6)
    dense = np.zeros((1500, 12))
    cols = rng.randint(0, 12, 1500)
    dense[np.arange(1500), cols] = rng.randint(1, 5, 1500)
    cases = [(sp.csr_matrix(dense), (cols % 3 == 0).astype(float),
              {"max_bin": 63}),
             (*_data(), {"max_bin": 511, "min_data_in_bin": 1})]
    for X, y, extra in cases:
        params = {**_params(2), **extra}
        tparams = {**params, "device_type": "cpu"}
        compile_cache.clear_programs()
        jfirst = jlgb.train(params, jlgb.Dataset(X, label=y),
                            num_boost_round=2, verbose_eval=False)
        jb = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=2,
                        init_model=jfirst, verbose_eval=False)
        tb = tlgb.train(tparams, tlgb.Dataset(X, label=y),
                        num_boost_round=2,
                        init_model=tlgb.Booster(
                            model_str=jfirst.model_to_string(),
                            params={"device_type": "cpu"}),
                        verbose_eval=False)
        td = tb._gbdt.train_data
        assert td.bundles is not None or str(td.bins.dtype) == \
            "torch.uint16"
        assert _sections(tb.model_to_string()) \
            == _sections(jb.model_to_string())


class _TwoSplit:
    """A folds object with ``split``, as scikit-learn's splitters have."""

    def split(self, X, y=None, groups=None):
        n = len(X)
        first = np.arange(n) % 3 == 0
        yield np.nonzero(~first)[0], np.nonzero(first)[0]
        yield np.nonzero(first | (np.arange(n) % 3 == 1))[0], \
            np.nonzero(np.arange(n) % 3 == 2)[0]


FOLD_CASES = {
    "stratified_shuffled": dict(classes=2, stratified=True, shuffle=True),
    "stratified_in_order": dict(classes=3, stratified=True, shuffle=False),
    "plain_shuffled": dict(classes=0, stratified=False, shuffle=True),
    "grouped": dict(classes=0, stratified=False, shuffle=True,
                    groups=True),
    "folds_object": dict(classes=2, folds=True),
}


def _fold_inputs(case):
    kw = FOLD_CASES[case]
    classes = kw["classes"]
    X, y = _data(900, classes=classes, groups=kw.get("groups", False))
    if kw.get("groups"):
        # whole queries a fold; the folds drop the query boundaries, as
        # the JAX package's subsets do, so the objective is pointwise
        params = {**BASE, "objective": "regression", "metric": "l2"}
        group = np.full(45, 20)
    elif classes == 0:
        params, group = {**BASE, "objective": "regression",
                         "metric": ["l2", "l1"]}, None
    else:
        params, group = _params(classes), None
    return X, y, group, params, kw


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_cv_folds_and_results_match_jax(x64, case):
    """The folds' row indices are the JAX package's (the same numpy
    draws in the same order), and the result dict equals its within
    1e-12 at f64."""
    X, y, group, params, kw = _fold_inputs(case)
    folds = _TwoSplit() if kw.get("folds") else None
    opts = dict(nfold=3, seed=7, folds=folds,
                stratified=kw.get("stratified", True),
                shuffle=kw.get("shuffle", True))
    jf = jengine._make_n_folds(jlgb.Dataset(X, label=y, group=group),
                               opts["folds"], 3, params, 7,
                               opts["stratified"], opts["shuffle"])
    tf = tengine._make_n_folds(
        tlgb.Dataset(X, label=y, group=group,
                     params={"device_type": "cpu"}),
        _TwoSplit() if folds else None, 3, params, 7, opts["stratified"],
        opts["shuffle"])
    assert len(jf) == len(tf)
    for (jtr, jte), (ttr, tte) in zip(jf, tf):
        np.testing.assert_array_equal(ttr.used_indices, jtr.used_indices)
        np.testing.assert_array_equal(tte.used_indices, jte.used_indices)
    compile_cache.clear_programs()
    jres = jlgb.cv(params, jlgb.Dataset(X, label=y, group=group),
                   num_boost_round=3, **opts)
    tres = tlgb.cv({**params, "device_type": "cpu"},
                   tlgb.Dataset(X, label=y, group=group),
                   num_boost_round=3, **{**opts, "folds": (
                       _TwoSplit() if folds else None)})
    assert list(tres) == list(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-12, atol=1e-12)


def test_cv_early_stopping_callbacks_and_cvbooster(x64):
    """Early stopping in `cv` (the JAX package's raises on cv's 5-field
    results, ROADMAP C.33): the results are the full run's cut at the
    best mean metric, plus `eval_train_metric`, `feval`, a before-
    iteration callback and `return_cvbooster`."""
    X, y = _data(900, classes=2)
    params = {**_params(2), "metric": "binary_logloss",
              "learning_rate": 0.8, "num_leaves": 31,
              "min_data_in_leaf": 2}
    compile_cache.clear_programs()
    full = jlgb.cv(params, jlgb.Dataset(X, label=y), num_boost_round=12,
                   nfold=3, seed=3, eval_train_metric=True)
    key = "valid binary_logloss-mean"
    best = int(np.argmin(full[key])) + 1
    assert best < 10, "the run must overfit for the test to stop early"
    seen = []

    def before(env):
        seen.append(env.iteration)
    before.before_iteration = True

    def feval(preds, data):
        return "mean_pred", float(np.mean(preds)), False

    res = tlgb.cv({**params, "device_type": "cpu"},
                  tlgb.Dataset(X, label=y), num_boost_round=12, nfold=3,
                  seed=3, early_stopping_rounds=2, eval_train_metric=True,
                  feval=feval, callbacks=[before], return_cvbooster=True)
    cvb = res.pop("cvbooster")
    assert cvb.best_iteration == best
    assert len(cvb.boosters) == 3
    assert seen == list(range(best + 2))
    for k in full:
        np.testing.assert_allclose(res[k], full[k][:best], rtol=1e-12,
                                   atol=1e-12)
    assert len(res["valid mean_pred-mean"]) == best
