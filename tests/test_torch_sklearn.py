"""The port's scikit-learn estimators (`lightgbm_tpu_torch/sklearn.py`)
against the JAX package's on the CPU, at f64 histograms: the
predictions of `LGBMClassifier` (with ``class_weight``, and with
``eval_set`` and early stopping on 3 classes), `LGBMRegressor` (and a
custom ``objective`` callable) and `LGBMRanker` are equal, with their
feature importances and best iterations; `clone`, the type predicates
and `NotFittedError` as in the JAX package's conformance tests; and a
pickled classifier predicts as before. `check_estimator`'s battery runs
in tests/test_torch_sklearn_checks.py. Every JAX run clears the compiled
programs first (ROADMAP C.19). Every array is made here from seeded numpy
data."""
import pickle

import numpy as np
import pytest

import lightgbm_tpu as jlgb
from lightgbm_tpu import compile_cache
import lightgbm_tpu_torch as tlgb

sklearn = pytest.importorskip("sklearn")
from sklearn.base import clone, is_classifier, is_regressor  # noqa: E402
from sklearn.exceptions import NotFittedError  # noqa: E402

KW = {"num_leaves": 7, "n_estimators": 4, "learning_rate": 0.5,
      "min_child_samples": 10, "verbosity": -1, "max_bin": 31,
      "tpu_grow_mode": "leafwise", "tpu_use_f64_hist": True}


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    """ROADMAP C.5: the JAX package's f64 mode under JAX 0.9, in the test
    only."""
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(n=600, seed=0, f=5):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, f)), 3)
    s = X[:, 0] - 0.6 * X[:, 1] + 0.4 * X[:, 2] + 0.6 * rng.standard_normal(n)
    return X, s


def _pair(name, **kw):
    """(JAX estimator, port estimator) of one class, the same keywords."""
    compile_cache.clear_programs()
    return (getattr(jlgb, name)(**{**KW, **kw}),
            getattr(tlgb, name)(**{**KW, **kw, "device_type": "cpu"}))


def test_classifier_class_weight_matches_jax():
    X, s = _data()
    y = np.where(s > 0.8, "pos", "neg")
    je, te = _pair("LGBMClassifier", class_weight="balanced")
    je.fit(X, y)
    te.fit(X, y)
    assert list(te.classes_) == list(je.classes_) == ["neg", "pos"]
    assert te.n_classes_ == 2
    np.testing.assert_array_equal(te.predict_proba(X), je.predict_proba(X))
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    np.testing.assert_array_equal(te.feature_importances_,
                                  je.feature_importances_)
    np.testing.assert_array_equal(te.predict(X, raw_score=True),
                                  je.predict(X, raw_score=True))
    np.testing.assert_array_equal(te.predict(X[:20], pred_contrib=True),
                                  je.predict(X[:20], pred_contrib=True))


def test_classifier_eval_set_early_stopping_matches_jax():
    X, s = _data(800)
    y = np.digitize(s, [-0.6, 0.6])
    kw = {"n_estimators": 40, "learning_rate": 0.3}
    je, te = _pair("LGBMClassifier", **kw)
    fit = {"eval_set": [(X[600:], y[600:])], "early_stopping_rounds": 2,
           "eval_metric": "multi_logloss"}
    je.fit(X[:600], y[:600], **fit)
    te.fit(X[:600], y[:600], **fit)
    assert 0 < te.best_iteration_ == je.best_iteration_ < 40
    assert te.evals_result_ == je.evals_result_
    assert dict(te.best_score_) == dict(je.best_score_)
    np.testing.assert_array_equal(te.predict_proba(X), je.predict_proba(X))
    assert te.predict_proba(X).shape == (800, 3)


def test_regressor_matches_jax():
    X, s = _data()
    je, te = _pair("LGBMRegressor", reg_lambda=1.0, colsample_bytree=0.8,
                   random_state=3)
    je.fit(X, s)
    te.fit(X, s)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert te.n_features_ == je.n_features_ == 5
    assert te.objective_ == je.objective_ == "regression"


def test_custom_objective_matches_jax():
    X, s = _data()

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_true)

    je, te = _pair("LGBMRegressor", objective=l2)
    je.fit(X, s)
    te.fit(X, s)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert not np.allclose(te.predict(X), 0.0)


def test_ranker_matches_jax():
    X, s = _data(600)
    y = np.digitize(s, [-1.0, 0.0, 1.0])
    group = [30] * 20
    je, te = _pair("LGBMRanker")
    je.fit(X, y, group=group)
    te.fit(X, y, group=group)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    with pytest.raises(ValueError, match="group"):
        tlgb.LGBMRanker(device_type="cpu").fit(X, y)


def test_clone_and_type_predicates():
    c = tlgb.LGBMClassifier(num_leaves=9, verbosity=-1)
    r = tlgb.LGBMRegressor(num_leaves=9, verbosity=-1)
    assert is_classifier(c) and not is_regressor(c)
    assert is_regressor(r) and not is_classifier(r)
    c2 = clone(c)
    assert c2.get_params()["num_leaves"] == 9
    assert c2 is not c
    assert set(c.get_params()) == set(
        jlgb.LGBMClassifier(num_leaves=9, verbosity=-1).get_params())


def test_unfitted_predict_raises_notfitted():
    with pytest.raises(NotFittedError):
        tlgb.LGBMClassifier().predict(np.zeros((3, 2)))


def test_pickled_classifier_predicts_as_before():
    X, s = _data()
    y = (s > 0).astype(int)
    clf = tlgb.LGBMClassifier(**{**KW, "device_type": "cpu"}).fit(X, y)
    back = pickle.loads(pickle.dumps(clf))
    np.testing.assert_array_equal(back.predict_proba(X),
                                  clf.predict_proba(X))
    assert back.booster_.device.type == "cpu"
