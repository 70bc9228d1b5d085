"""The port's host `SerialTreeLearner` against the JAX package's on the
CPU: the objectives that renew leaf outputs (regression_l1, quantile,
mape) train on it, and the f64 tree sections are byte-equal to the JAX
package's, plain and weighted, with a categorical column, bagging,
``feature_fraction``, ``max_depth``, a monotone constraint, forced
splits, L1/L2 regularization, the lazy CEGB penalty (alone and with the
split and coupled ones), and under DART, RF and GOSS. The lazy penalty
takes the host learner for any objective. On the CPU its histograms are
kernel B1's twin (one call a leaf it histograms), and bundled bins never
reach it. The JAX runs clear `compile_cache.clear_programs()` first
(ROADMAP C.19: quantile's ``alpha`` is read from the config)."""
import json

import jax
import jax.experimental
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu_torch.models import serial_learner as SL
from lightgbm_tpu_torch.models.serial_learner import SerialTreeLearner

ROUNDS = 5
BASE = {"tpu_grow_mode": "leafwise", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "verbosity": -1, "tpu_use_f64_hist": True}
LAZY = [0.002, 0.01, 0.03, 0.0, 0.001, 0.02, 0.007, 0.003]
FORCED = {"feature": 0, "threshold": 0.3,
          "left": {"feature": 2, "threshold": -0.5},
          "right": {"feature": 1, "threshold": 0.7,
                    "right": {"feature": 3, "threshold": -1.0}}}
VARIANTS = {
    "plain": {},
    "weighted": {},
    "categorical": {},
    "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1},
    "feature_fraction": {"feature_fraction": 0.6},
    "max_depth": {"max_depth": 3},
    "monotone": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0]},
    "forced": {},
    "l1_l2": {"lambda_l1": 0.5, "lambda_l2": 1.0},
    "lazy": {"cegb_penalty_feature_lazy": LAZY},
    "lazy_split_coupled": {
        "cegb_penalty_feature_lazy": LAZY, "cegb_penalty_split": 0.001,
        "cegb_tradeoff": 0.7,
        "cegb_penalty_feature_coupled": [0.5, 0.1, 3.0, 0.2, 0.1, 2.0,
                                         0.7, 0.3]},
    "dart": {"boosting": "dart", "drop_rate": 0.5},
    "rf": {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(n=3000, seed=0, categorical=False, binary=False):
    """n x 8 with 5% missing values; with ``categorical`` columns 4 and 6
    hold 12 and 40 categories the label depends on."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 8))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    m = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    if binary:
        return X, (rng.rand(n) < 1 / (1 + np.exp(-m))).astype(np.float64)
    y = 3 * m + rng.standard_normal(n)
    if categorical:
        rc = np.random.RandomState(seed + 1)
        X[:, 4] = rc.randint(0, 12, n)
        X[:, 6] = rc.randint(0, 40, n)
        y = y + 0.8 * (X[:, 4] % 3) - 0.5 * (X[:, 6] % 5 == 0)
    return X, y


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _pair(params, X, y, w=None, cat=None, rounds=ROUNDS):
    kw = {} if cat is None else {"categorical_feature": cat}
    compile_cache.clear_programs()
    jb = jlgb.train(params, jlgb.Dataset(X, label=y, weight=w, **kw),
                    num_boost_round=rounds, verbose_eval=False)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y, weight=w, **kw),
                    num_boost_round=rounds, verbose_eval=False)
    return jb, tb


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("obj", ["regression_l1", "quantile", "mape"])
def test_host_trees_match_jax(x64, tmp_path, obj, variant):
    params = {**BASE, "objective": obj, **VARIANTS[variant]}
    if obj == "quantile":
        params["alpha"] = 0.3
    if variant == "forced":
        path = tmp_path / "forced.json"
        path.write_text(json.dumps(FORCED))
        params["forcedsplits_filename"] = str(path)
    X, y = _data(categorical=variant == "categorical")
    w = np.random.RandomState(5).uniform(0.3, 2.0, len(y)) \
        if variant == "weighted" else None
    cat = [4, 6] if variant == "categorical" else None
    jb, tb = _pair(params, X, y, w, cat)
    g = tb._gbdt
    assert g.train_path == "host"
    assert isinstance(g.learner, SerialTreeLearner)
    text = _sections(tb.model_to_string())
    assert text == _sections(jb.model_to_string())
    assert tb.trees[0].num_leaves > 2
    if variant == "categorical":
        assert sum(t.num_cat for t in tb.trees) > 0
    np.testing.assert_array_equal(tb.predict(X[:500]), jb.predict(X[:500]))


@pytest.mark.parametrize("objective", ["binary", "regression", "huber"])
def test_lazy_penalty_takes_the_host_learner(x64, objective):
    """The lazy CEGB penalty sends any objective to the host learner, as
    `Config.forces_host_learner` does in the JAX package: byte-equal f64
    trees, and the penalty changes them."""
    X, y = _data(binary=objective == "binary")
    params = {**BASE, "objective": objective,
              "cegb_penalty_feature_lazy": LAZY}
    jb, tb = _pair(params, X, y)
    assert isinstance(tb._gbdt.learner, SerialTreeLearner)
    assert tb._gbdt.train_path == "host"
    text = _sections(tb.model_to_string())
    assert text == _sections(jb.model_to_string())
    plain = tlgb.train({**BASE, "objective": objective,
                        "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                       num_boost_round=ROUNDS, verbose_eval=False)
    assert _sections(plain.model_to_string()) != text


def test_host_histograms_are_b1_twin(monkeypatch):
    """On the CPU each leaf the learner histograms is one call of B1's
    wrapper (`leaf_histogram`), which takes its twin there: the root and
    the smaller child of every split but the last of a tree."""
    calls = []
    real = SL.leaf_histogram

    def counting(bins, gh, *args):
        calls.append(bins.device.type)
        return real(bins, gh, *args)

    monkeypatch.setattr(SL, "leaf_histogram", counting)
    X, y = _data()
    bst = tlgb.train({**BASE, "objective": "regression_l1",
                      "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                     num_boost_round=3, verbose_eval=False)
    splits = sum(t.num_leaves - 1 for t in bst.trees)
    assert len(calls) == splits and set(calls) == {"cpu"}
    assert all(t.num_leaves == 15 for t in bst.trees)


def test_bundling_never_reaches_the_host_learner():
    """One-hot sparse columns bundle under binary but not under the
    renewing objectives or the lazy penalty (the JAX package's EFB gate),
    so the host learner sees the unbundled bins."""
    rng = np.random.RandomState(0)
    n = 3000
    codes = rng.randint(0, 12, n)
    X = sp.csr_matrix((np.ones(n), (np.arange(n), codes)), shape=(n, 12))
    y = codes % 3 + rng.standard_normal(n)
    bundled = tlgb.Dataset(X, label=(y > 1).astype(float),
                           params={"objective": "binary",
                                   "device_type": "cpu"}).construct()
    assert bundled._handle.bundles is not None
    for params in ({"objective": "regression_l1"},
                   {"objective": "binary",
                    "cegb_penalty_feature_lazy": [0.01] * 12}):
        label = y if params["objective"] != "binary" else (y > 1) * 1.0
        bst = tlgb.train({**BASE, **params, "device_type": "cpu"},
                         tlgb.Dataset(X, label=label),
                         num_boost_round=2, verbose_eval=False)
        assert bst._gbdt.train_data.bundles is None
        assert not bst._gbdt.learner.bundled
