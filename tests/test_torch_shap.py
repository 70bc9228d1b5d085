"""SHAP values of the port (`predict(pred_contrib=True)`, `ops/shap.py`)
against the JAX package's `predict_contrib` on the CPU.

The port's TreeSHAP keeps one path buffer a tree where the JAX package
allocates a path at every node; the arithmetic and its order are the
same, so the values are expected bit-equal (the bound stated is 1e-12
relative). Cases: binary, l2, softmax with 3 classes, categorical splits,
NaN rows, a sparse CSR input, a 63-leaf tree, an iteration slice, and a
model of one-leaf trees, which adds to the expected-value column only.
Each row's values sum to its raw score. The JAX package predicts from
the port's model text, and in the binary case from its own training run
too. Every array is made here from seeded numpy data."""
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.ops import shap as jshap
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import shap as tshap

BASE = {"num_leaves": 7, "max_bin": 31, "learning_rate": 0.5,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True, "min_data_in_leaf": 10}
CASES = {
    "binary": ({"objective": "binary"}, {}),
    "l2": ({"objective": "regression"}, {}),
    "softmax": ({"objective": "multiclass", "num_class": 3}, {}),
    "categorical": ({"objective": "binary"}, {"cat": True}),
    "nan": ({"objective": "regression", "use_missing": True},
            {"nan": 0.25}),
    "sparse": ({"objective": "binary"}, {"sparse": True}),
    "deep": ({"objective": "regression", "num_leaves": 63,
              "min_data_in_leaf": 2, "max_bin": 63}, {"n": 3000}),
    "one_leaf": ({"objective": "regression", "min_data_in_leaf": 10000},
                 {}),
}


@pytest.fixture
def x64(monkeypatch):
    """ROADMAP C.5: the JAX package's f64 mode under JAX 0.9, in the test
    only."""
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(kind, n=600, seed=0, nan=0.03, cat=False, sparse=False):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, 5)), 3)
    if cat:
        X[:, 2] = rng.randint(0, 6, n)
    if sparse:
        X[rng.rand(n, 5) < 0.6] = 0.0
    else:
        X[rng.rand(n, 5) < nan] = np.nan
    z = np.nan_to_num(X)
    s = z[:, 0] - 0.6 * z[:, 1] + 0.5 * (z[:, 2] % 3) \
        + 0.5 * rng.standard_normal(n)
    if kind == "softmax":
        return X, np.digitize(s, [-0.6, 0.6]).astype(float)
    if kind in ("l2", "nan", "deep", "one_leaf"):
        return X, s
    return X, (s > 0).astype(float)


def _port_model(kind, rounds=3):
    params, opts = CASES[kind]
    X, y = _data(kind, **{k: v for k, v in opts.items()})
    p = {**BASE, **params, "device_type": "cpu"}
    ds = tlgb.Dataset(sp.csr_matrix(X) if opts.get("sparse") else X,
                      label=y,
                      categorical_feature=[2] if opts.get("cat") else "auto")
    return tlgb.train(p, ds, num_boost_round=rounds, verbose_eval=False), X


def _check_equal(port, ref):
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(port - ref).max() <= 1e-12 * scale
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_pred_contrib_matches_jax(kind):
    bst, X = _port_model(kind)
    k = bst.num_tree_per_iteration
    rows = X[:80]
    data = sp.csr_matrix(rows) if CASES[kind][1].get("sparse") else rows
    contrib = bst.predict(data, pred_contrib=True)
    jb = jlgb.Booster(model_str=bst.model_to_string())
    _check_equal(contrib, jb.predict(data, pred_contrib=True))
    f = X.shape[1]
    assert contrib.shape == (len(rows), k * (f + 1))
    # each class block sums to the class's raw score
    raw = bst.predict(rows, raw_score=True).reshape(len(rows), k)
    sums = contrib.reshape(len(rows), k, f + 1).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(raw).max()))
    if kind == "one_leaf":
        assert all(t.num_leaves == 1 for t in bst.trees)
        assert not contrib[:, :f].any()
        np.testing.assert_array_equal(contrib[:, f],
                                      bst.trees[0].leaf_value[0])


def test_pred_contrib_iteration_slice_matches_jax():
    """``start_iteration`` and ``num_iteration`` pick the trees SHAP
    walks, in both packages (3 classes, 4 iterations)."""
    bst, X = _port_model("softmax", rounds=4)
    jb = jlgb.Booster(model_str=bst.model_to_string())
    for start, num in ((0, 2), (1, 2), (2, None)):
        got = bst.predict(X[:40], pred_contrib=True, start_iteration=start,
                          num_iteration=num)
        _check_equal(got, jb.predict(X[:40], pred_contrib=True,
                                     start_iteration=start,
                                     num_iteration=num))


def test_buffer_recursion_matches_jax_recursion_on_jax_trees():
    """The two recursions on the very trees the JAX package loads: the
    port's function takes any object with a tree's arrays."""
    bst, X = _port_model("deep")
    jb = jlgb.Booster(model_str=bst.model_to_string())
    trees = jb.trees
    _check_equal(tshap.predict_contrib(trees, X[:30]),
                 jshap.predict_contrib(trees, X[:30]))


def test_binary_matches_jax_training_run(x64):
    """Both packages train the f64 binary model; the SHAP values of the
    two boosters are equal."""
    params, _ = CASES["binary"]
    X, y = _data("binary")
    p = {**BASE, **params}
    compile_cache.clear_programs()
    jb = jlgb.Booster(params=p, train_set=jlgb.Dataset(X, label=y, params=p))
    tb = tlgb.Booster(params={**p, "device_type": "cpu"},
                      train_set=tlgb.Dataset(X, label=y))
    for _ in range(3):
        jb.update()
        tb.update()
    _check_equal(tb.predict(X[:60], pred_contrib=True),
                 jb.predict(X[:60], pred_contrib=True))
