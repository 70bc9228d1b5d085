"""The port's aligned engine on the CPU (its kernels' plain twins) against
the JAX package's aligned engine (Pallas kernels in interpret mode, as
tests/test_aligned.py runs it) and against the port's leaf-wise builder:
the same splits, leaf values within float noise, and per tree the same
number of speculative rounds and executed splits."""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
from lightgbm_tpu_torch.ops.objectives import create_objective
from lightgbm_tpu_torch.utils import log

ITERS = 4


def _make(n=2500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2]
          + 0.3 * rng.standard_normal(n)) > 0).astype(np.float32)
    return X, y


def _params(mode, objective="binary", **extra):
    return {"objective": objective, "num_leaves": 8, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
            "metric": "none", "tpu_grow_mode": mode,
            "tpu_aligned_interpret": mode == "aligned", "tpu_chunk": 256,
            **extra}


def _port(X, y, mode, iters=ITERS, **extra):
    return tlgb.train({**_params(mode, **extra), "device_type": "cpu"},
                      tlgb.Dataset(X, label=y), num_boost_round=iters,
                      verbose_eval=False)


def _jax(X, y, **extra):
    """The JAX package's aligned run; returns (booster, [(rounds, n_exec)]
    of its trees, read from the specs before they are materialized)."""
    params = _params("aligned", **extra)
    ds = jlgb.Dataset(X, label=y, params=params).construct()
    bst = jlgb.Booster(params=params, train_set=ds)
    for _ in range(ITERS):
        bst.update()
    g = bst._gbdt
    stats = [(int(m.record.rounds), int(m.record.n_exec)) for m in g.models]
    g.materialized_models()
    return bst, stats


def _same_trees(ta, tb):
    assert len(ta) == len(tb)
    for a, b in zip(ta, tb):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.threshold_in_bin[:k]) == list(b.threshold_in_bin[:k])
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def runs():
    """The JAX aligned runs (about 10 s each in interpret mode) and the
    port's aligned and leaf-wise runs on the same data."""
    X, y = _make()
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1]) + y
    out = {"data": (X, y, yr)}
    for mb in (63, 255):
        out[("jax", mb)] = _jax(X, y, max_bin=mb)
        out[("aligned", mb)] = _port(X, y, "aligned", max_bin=mb)
        out[("leafwise", mb)] = _port(X, y, "leafwise", max_bin=mb)
    out[("jax", "l2")] = _jax(X, yr, objective="regression")
    out[("aligned", "l2")] = _port(X, yr, "aligned", objective="regression")
    return out


@pytest.mark.parametrize("max_bin", [63, 255])
def test_aligned_matches_jax_aligned(runs, max_bin):
    jb, jstats = runs[("jax", max_bin)]
    tb = runs[("aligned", max_bin)]
    stats = tb._gbdt.aligned_stats
    assert tb._gbdt.train_path == "aligned"
    assert all(exact for _, _, exact in stats)
    assert [(r, e) for r, e, _ in stats] == jstats
    _same_trees(jb._gbdt.models, tb.trees)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_aligned_matches_port_leafwise(runs, max_bin):
    _same_trees(runs[("leafwise", max_bin)].trees,
                runs[("aligned", max_bin)].trees)
    assert runs[("leafwise", max_bin)]._gbdt.train_path == "leafwise"


def test_force_big_n_matches_default_layout(runs):
    """STANDARD records and the count pass grow the default layout's
    trees, and the recorded leaf counts are the rows' exact counts."""
    X, y, _ = runs["data"]
    big = _port(X, y, "aligned", tpu_force_big_n=True)
    eng = big._gbdt._aligned_eng
    assert eng.big_n and not eng.compact
    _same_trees(runs[("aligned", 63)].trees, big.trees)
    leaves = big.predict(X, pred_leaf=True).astype(np.int64)
    for t, tree in enumerate(big.trees):
        counts = np.bincount(leaves[:, t], minlength=tree.num_leaves)
        np.testing.assert_array_equal(tree.leaf_count[:tree.num_leaves],
                                      counts)


def test_regression_l2_matches_jax(runs):
    X, _, yr = runs["data"]
    jb, jstats = runs[("jax", "l2")]
    tb = runs[("aligned", "l2")]
    assert not tb._gbdt._aligned_eng.compact      # real-valued labels
    assert [(r, e) for r, e, _ in tb._gbdt.aligned_stats] == jstats
    np.testing.assert_allclose(tb.predict(X[:500]), jb.predict(X[:500]),
                               rtol=1e-3)


def test_train_score_synced_from_records(runs):
    """The engine's permuted score lane, read back in row order, is the
    sum of the trees' predictions."""
    X, y, _ = runs["data"]
    tb = runs[("aligned", 63)]
    g = tb._gbdt
    g._sync_train_score()
    np.testing.assert_allclose(g.train_score.score[0].numpy(),
                               tb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_inexact_replay_falls_back_to_leafwise(runs):
    """A speculation budget of 1.2 x num_leaves leaves some trees
    inexact: those iterations grow leaf-wise, and every tree is still
    the leaf-wise run's."""
    X, y, _ = runs["data"]
    tight = _port(X, y, "aligned", tpu_level_spec=1.2)
    exact = [e for _, _, e in tight._gbdt.aligned_stats]
    assert not all(exact) and any(exact)
    assert tight._gbdt._aligned_eng.fallbacks == exact.count(False)
    _same_trees(runs[("leafwise", 63)].trees, tight.trees)


def test_gate_names_what_the_slice_leaves_out(runs):
    """Under auto a params set the engine leaves out trains leaf-wise and
    the log names the gate; under tpu_grow_mode=aligned it raises. A
    non-pointwise objective (lambdarank) passes from 1M rows under auto,
    at any size when forced; a bagged config passes."""
    X, y, _ = runs["data"]
    lines = []
    log.register_callback(lines.append)
    try:
        bst = tlgb.train({**_params("auto", verbosity=1),
                          "device_type": "cpu"},
                         tlgb.Dataset(X, label=y), num_boost_round=1,
                         verbose_eval=False)
    finally:
        log.register_callback(None)
    assert bst._gbdt.train_path == "leafwise"
    assert any("aligned engine rejected: CUDA kernels unavailable" in ln
               for ln in lines)
    ds = tlgb.Dataset(X, label=y,
                      params={"device_type": "cpu"}).construct()._handle
    for extra, why in (({"tpu_grow_mode": "leafwise"},
                        "tpu_grow_mode=leafwise"),
                       ({"tree_learner": "data"}, "tree_learner=data"),
                       ({"num_leaves": 1}, "num_leaves < 2"),
                       ({"bagging_freq": 1, "bagging_fraction": 0.5}, None)):
        cfg = Config.from_params({**_params("aligned"), **extra})
        obj = create_objective(cfg)
        obj.init(ds.metadata, ds.num_data)
        learner = DeviceTreeLearner(cfg, ds, ds.bins.device)
        gate = learner.aligned_mode_gate(obj)
        assert gate == why if why is None else gate.startswith(why)
    ds.metadata.set_group([ds.num_data // 2, ds.num_data - ds.num_data // 2])
    for mode, why in (("auto", "non-pointwise objective below the row "
                               f"floor ({ds.num_data} < 1000000 rows)"),
                      ("aligned", None)):
        cfg = Config.from_params({**_params(mode), "objective": "lambdarank",
                                  "tpu_aligned_interpret": True})
        obj = create_objective(cfg)
        obj.init(ds.metadata, ds.num_data)
        learner = DeviceTreeLearner(cfg, ds, ds.bins.device)
        assert learner.aligned_mode_gate(obj) == why
    with pytest.raises(NotImplementedError, match="aligned engine cannot"):
        _port(X, y, "aligned", tpu_aligned_interpret=False)
