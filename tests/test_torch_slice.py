"""The port's whole slice against the JAX package on the CPU: Dataset ->
train (binary, leaf-wise) -> predict / model text, and `from_reference`
carrying a JAX model into the port."""
import jax
import jax.experimental
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import from_reference, tree_arrays

N_TRAIN, N_TEST, F = 4000, 2000, 10
PARAMS = {"objective": "binary", "tpu_grow_mode": "leafwise",
          "num_leaves": 31, "max_bin": 63, "feature_fraction": 1.0,
          "learning_rate": 0.1, "verbosity": -1}
ROUNDS = 5


def _data():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((N_TRAIN + N_TEST, F))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    y = (rng.rand(len(X)) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]


def _auc(y, score):
    """Mann-Whitney AUC, tied scores sharing their mean rank."""
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y > 0
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) \
        / (pos.sum() * (~pos).sum())


@pytest.fixture(scope="module")
def runs():
    """Both packages trained once per histogram precision."""
    Xtr, ytr, Xte, yte = _data()
    out = {"data": (Xtr, ytr, Xte, yte)}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's f64 mode enters `jax.experimental.enable_x64()`,
        # which JAX 0.9 removed; give it the replacement
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        for f64 in (True, False):
            p = {**PARAMS, "tpu_use_f64_hist": f64, "metric": "auc"}
            jds = jlgb.Dataset(Xtr, label=ytr)
            jev, tev = {}, {}
            jb = jlgb.train(p, jds, num_boost_round=ROUNDS,
                            valid_sets=[jds.create_valid(Xte, label=yte)],
                            evals_result=jev, verbose_eval=False)
            tds = tlgb.Dataset(Xtr, label=ytr)
            tb = tlgb.train({**p, "device_type": "cpu"}, tds,
                            num_boost_round=ROUNDS,
                            valid_sets=[tds.create_valid(Xte, label=yte)],
                            evals_result=tev, verbose_eval=False)
            out[f64] = (jds, jb, tds, tb)
            out[("evals", f64)] = (jev, tev)
    return out


def test_bin_boundaries_equal(runs):
    jds, _, tds, _ = runs[True]
    jm, tm = jds._handle.mappers, tds._handle.mappers
    assert len(jm) == len(tm) == F
    for a, b in zip(jm, tm):
        assert (a.num_bin, a.missing_type, a.default_bin) == \
            (b.num_bin, b.missing_type, b.default_bin)
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
    np.testing.assert_array_equal(np.asarray(jds._handle.bins),
                                  tds._handle.bins.numpy())


def _tree_sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


def test_f64_trees_and_predictions_match(runs):
    """tpu_use_f64_hist: the tree sections of the model text are the JAX
    package's byte for byte (split gains included); identical tree
    structure, leaf values at rtol=1e-6, raw predictions at rtol=1e-5 /
    atol=1e-7."""
    _, jb, _, tb = runs[True]
    Xte = runs["data"][2]
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)
    for jt, tt in zip(jb.trees, tb.trees):
        assert tt.num_leaves == jt.num_leaves
        m = tt.num_leaves - 1
        for key in ("split_feature", "threshold_in_bin", "left_child",
                    "right_child"):
            np.testing.assert_array_equal(getattr(tt, key)[:m],
                                          getattr(jt, key)[:m], err_msg=key)
        np.testing.assert_array_equal(tt.leaf_count[:m + 1],
                                      jt.leaf_count[:m + 1])
        np.testing.assert_allclose(tt.leaf_value[:m + 1],
                                   jt.leaf_value[:m + 1], rtol=1e-6)
    np.testing.assert_allclose(tb.predict(Xte, raw_score=True),
                               jb.predict(Xte, raw_score=True),
                               rtol=1e-5, atol=1e-7)


def test_default_precision_auc_matches(runs):
    """f32 histograms: sums round in another order, so trees may differ
    in the last bits; the holdout AUC agrees within 2e-3."""
    _, jb, _, tb = runs[False]
    _, _, Xte, yte = runs["data"]
    a_j = _auc(yte, jb.predict(Xte))
    a_t = _auc(yte, tb.predict(Xte))
    assert a_t > 0.7
    assert abs(a_t - a_j) < 2e-3


@pytest.mark.parametrize("how", ["model_str", "arrays"])
def test_from_reference_predicts_as_jax(runs, how):
    """A JAX-trained model carried into the port scores as the JAX
    Booster does."""
    _, jb, _, _ = runs[False]
    Xte = runs["data"][2]
    if how == "model_str":
        pb = from_reference(model_str=jb.model_to_string(),
                            params={"device_type": "cpu"})
    else:
        pb = from_reference(arrays={
            "trees": [tree_arrays(t) for t in jb.trees],
            "objective": "binary sigmoid:1", "num_tree_per_iteration": 1},
            params={"device_type": "cpu"})
    assert pb.num_trees() == jb.num_trees()
    np.testing.assert_allclose(pb.predict(Xte, raw_score=True),
                               jb.predict(Xte, raw_score=True),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pb.predict(Xte), jb.predict(Xte),
                               rtol=1e-5, atol=1e-7)


def test_port_model_text_loads_in_jax(runs):
    """The model text format is shared: the port's model loads in the JAX
    package and predicts the same."""
    _, _, _, tb = runs[False]
    Xte = runs["data"][2]
    jb = jlgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(jb.predict(Xte, raw_score=True),
                               tb.predict(Xte, raw_score=True),
                               rtol=1e-5, atol=1e-7)


def test_valid_set_metric_per_round(runs):
    """The validation set's scores, kept on the device by traversing each
    new tree over its bins, give the JAX package's AUC every round."""
    jev, tev = runs[("evals", True)]
    _, _, Xte, yte = runs["data"]
    tb = runs[True][3]
    assert list(tev) == list(jev) == ["valid_0"]
    assert len(tev["valid_0"]["auc"]) == ROUNDS
    # the JAX package computes AUC in f32 with jnp, the port in f64 numpy
    np.testing.assert_allclose(tev["valid_0"]["auc"], jev["valid_0"]["auc"],
                               rtol=1e-6)
    assert abs(tev["valid_0"]["auc"][-1] - _auc(yte, tb.predict(Xte))) \
        < 1e-6
