"""The port's plotting functions (`lightgbm_tpu_torch/plotting.py`) on
matplotlib's Agg backend: the four cases of the JAX package's
tests/test_plotting.py (slow-marked there), on one small booster, and
the tree digraph's source equal to the JAX package's for the same model.
Every array is made here from seeded numpy data."""
import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import lightgbm_tpu as jlgb  # noqa: E402
import lightgbm_tpu_torch as tlgb  # noqa: E402


@pytest.fixture(scope="module")
def booster():
    rng = np.random.RandomState(0)
    X = rng.randn(500, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "metric": ["binary_logloss", "auc"], "device_type": "cpu"}
    ds = tlgb.Dataset(X, label=y, params=params, free_raw_data=False)
    evals = {}
    bst = tlgb.train(params, ds, num_boost_round=10,
                     valid_sets=[ds], valid_names=["train"],
                     callbacks=[tlgb.record_evaluation(evals)],
                     verbose_eval=False)
    bst._evals = evals
    return bst


def test_plot_importance(booster):
    ax = tlgb.plot_importance(booster)
    assert ax is not None
    assert len(ax.patches) > 0
    ax2 = tlgb.plot_importance(booster, importance_type="gain",
                               max_num_features=3)
    assert len(ax2.patches) <= 3


def test_plot_metric(booster):
    ax = tlgb.plot_metric(booster._evals, metric="auc")
    assert ax is not None
    with pytest.raises(ValueError):
        tlgb.plot_metric(booster._evals)  # two metrics -> must pick one


def test_plot_split_value_histogram(booster):
    imp = booster.feature_importance()
    feat = int(np.argmax(imp))
    ax = tlgb.plot_split_value_histogram(booster, feat)
    assert ax is not None
    hist, edges = booster.get_split_value_histogram(feat)
    assert hist.sum() == imp[feat]


def test_create_tree_digraph(booster):
    pytest.importorskip("graphviz")
    g = tlgb.create_tree_digraph(booster, tree_index=0,
                                 show_info=["split_gain", "leaf_count"])
    src = g.source
    assert "split0" in src and "leaf" in src
    with pytest.raises(IndexError):
        tlgb.create_tree_digraph(booster, tree_index=10**6)
    jb = jlgb.Booster(model_str=booster.model_to_string())
    assert src == jlgb.create_tree_digraph(
        jb, tree_index=0, show_info=["split_gain", "leaf_count"]).source
