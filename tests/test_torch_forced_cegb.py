"""Forced splits and the CEGB split and coupled penalties on the port's
leaf-wise learner, against the JAX package's fused leaf-wise learner on
the CPU: the f64 tree sections of the model text are byte-equal.

- Forced splits: a one-node JSON, a three-level one, one with a node on
  an unused (constant) feature, whose subtree drops, and one whose
  threshold empties a child, which is skipped with its subtree.
- CEGB: the split penalty at two tradeoffs, coupled penalties, and both;
  the penalized gain is the model text's ``split_gain``.
- Each plain, with bagging and ``feature_fraction``, and with softmax
  K = 3 (a coupled feature is paid once per model, across every class's
  tree).
- ``auto`` and ``level`` grow these trees leaf-wise, with the JAX
  package's gate reason; the lazy penalty trains on the host learner;
  `convert.from_reference` carries such a JAX model across.

The JAX runs clear `compile_cache.clear_programs()` first (ROADMAP C.19);
the data is dense, so the JAX package bundles nothing (C.24)."""
import json

import jax
import jax.experimental
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu_torch.convert import from_reference

ROUNDS = 4
BASE = {"objective": "binary", "tpu_grow_mode": "leafwise",
        "num_leaves": 31, "max_bin": 63, "learning_rate": 0.1,
        "verbosity": -1, "tpu_use_f64_hist": True}
COUPLED = [0.5, 1.0, 3.0, 0.2, 0.1, 2.0, 0.7, 0.3, 1.5, 0.9, 0.4]
VARIANTS = {
    "plain": {},
    "bag_ff": {"bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.7},
    "mc3": {"objective": "multiclass", "num_class": 3},
}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(n=3000, seed=0, classes=2):
    """n x 11 rows with 5% missing values but in column 9; column 10 is
    constant, so the dataset drops it (an unused feature)."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 11))
    full = X[:, 9].copy()
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[:, 9] = full
    X[:, 10] = 1.0
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    if classes > 2:
        y = np.digitize(margin + 0.5 * rng.standard_normal(n),
                        [-0.5, 0.5]).astype(np.float64)
    else:
        y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X, y


FORCED = {
    "one_node": {"feature": 2, "threshold": 0.25},
    "three_levels": {
        "feature": 0, "threshold": 0.3,
        "left": {"feature": 2, "threshold": -0.5,
                 "left": {"feature": 5, "threshold": 0.1}},
        "right": {"feature": 1, "threshold": 0.7,
                  "right": {"feature": 3, "threshold": -1.0}}},
    "unused_feature": {
        "feature": 0, "threshold": 0.3,
        "left": {"feature": 10, "threshold": 0.5,
                 "left": {"feature": 4, "threshold": 0.0}},
        "right": {"feature": 6, "threshold": -0.2}},
    "empty_child": {
        "feature": 0, "threshold": -0.1,
        "left": {"feature": 9, "threshold": 1e9,
                 "left": {"feature": 4, "threshold": 0.0}},
        "right": {"feature": 7, "threshold": 0.4}},
}
CEGB = {
    "split": {"cegb_penalty_split": 0.3},
    "split_tradeoff": {"cegb_penalty_split": 0.05, "cegb_tradeoff": 2.5},
    "coupled": {"cegb_penalty_feature_coupled": COUPLED},
    "both": {"cegb_penalty_split": 0.1, "cegb_tradeoff": 0.7,
             "cegb_penalty_feature_coupled": COUPLED},
}


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _pair(params, classes=2, rounds=ROUNDS):
    X, y = _data(classes=classes)
    compile_cache.clear_programs()
    jb = jlgb.train(params, jlgb.Dataset(X, label=y),
                    num_boost_round=rounds, verbose_eval=False)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=rounds,
                    verbose_eval=False)
    return jb, tb, X


def _forced_file(tmp_path, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(FORCED[name]))
    return str(path)


def _split_nodes(tree):
    """(inner feature, threshold bin) of each split node, in split order."""
    k = tree.num_leaves - 1
    return list(zip(tree.split_feature_inner[:k].tolist(),
                    tree.threshold_in_bin[:k].tolist()))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("forced", list(FORCED))
def test_forced_splits_match_jax(x64, tmp_path, forced, variant):
    """Every tree starts with the surviving forced nodes, in BFS order,
    and the f64 tree sections are the JAX package's byte for byte (the
    forced gains are the plain leaf formula on the parent's histogram,
    its bins summed in XLA's windowed order; with forced splits XLA
    subtracts the tested copy of the gain shift from the reported gain,
    `make_split_finder(tested_report=)`)."""
    params = {**BASE, **VARIANTS[variant],
              "forcedsplits_filename": _forced_file(tmp_path, forced)}
    jb, tb, _ = _pair(params, 3 if variant == "mc3" else 2)
    assert tb._gbdt.train_path == "leafwise"
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    lr = tb._gbdt.learner
    nodes = lr.forced
    expect = {"one_node": 1, "three_levels": 5, "unused_feature": 2,
              "empty_child": 4}[forced]
    assert len(nodes) == expect
    # the forced nodes that split, in BFS order from the root; the empty
    # child's node and its subtree are skipped
    skipped = {1} if forced == "empty_child" else set()   # threshold 1e9
    first, queue = [], [0]
    while queue:
        node = queue.pop(0)
        f, t, left, right = nodes[node]
        if node in skipped:
            continue
        first.append((f, t))
        queue += [c for c in (left, right) if c >= 0]
    for tree in tb.trees:
        assert _split_nodes(tree)[:len(first)] == first


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cegb", list(CEGB))
def test_cegb_matches_jax(x64, cegb, variant):
    """The penalty (split penalty x tradeoff x the leaf's rows, rounded,
    plus each unused feature's coupled penalty x tradeoff) is taken off
    each feature's gain before the masks; the f64 tree sections, whose
    split_gain is the penalized gain, are the JAX package's byte for
    byte. A coupled feature is paid only until a tree of the model first
    splits on it."""
    params = {**BASE, **VARIANTS[variant], **CEGB[cegb]}
    jb, tb, _ = _pair(params, 3 if variant == "mc3" else 2)
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    lr = tb._gbdt.learner
    used = set()
    for tree in tb.trees:
        used |= set(tree.split_feature_inner[:tree.num_leaves - 1].tolist())
    if "cegb_penalty_feature_coupled" in CEGB[cegb]:
        assert set(np.nonzero(lr._cegb_used)[0].tolist()) == used
        eff = lr._cegb_coupled_eff()
        assert not eff[sorted(used)].any()
        unused = [f for f in range(lr.num_features) if f not in used]
        assert eff[unused].all()


def test_wide_coupled_penalties_match_jax(x64):
    """40 features, coupled penalties of 0.5-30 and a split penalty whose
    f32 product rounds: many splits pay a coupled penalty, so the
    penalty's form (the product rounded, then the add) shows; f64 tree
    sections byte-equal over 8 rounds."""
    rng = np.random.RandomState(2)
    X = rng.standard_normal((6000, 40))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, :20] @ rng.standard_normal(20) * 0.5 \
        + 0.5 * np.sin(2 * z[:, 3])
    y = (rng.rand(6000) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    cp = [float(v) for v in np.random.RandomState(5).uniform(0.5, 30, 40)]
    params = {**BASE, "cegb_penalty_split": 0.05, "cegb_tradeoff": 1.3,
              "cegb_penalty_feature_coupled": cp}
    compile_cache.clear_programs()
    jb = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=8,
                    verbose_eval=False)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=8,
                    verbose_eval=False)
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_forced_and_cegb_together_match_jax(x64, tmp_path):
    """Forced splits beside both CEGB penalties: the forced gains are not
    penalized, a forced split marks its feature used."""
    params = {**BASE, **CEGB["both"],
              "forcedsplits_filename": _forced_file(tmp_path,
                                                    "three_levels")}
    jb, tb, _ = _pair(params)
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


@pytest.mark.parametrize("mode", ["auto", "level"])
def test_sequential_options_grow_leafwise(x64, tmp_path, mode):
    """Under auto (with the aligned engine's twins on) and level, forced
    splits and CEGB grow the trees leaf-wise, as in the JAX package: the
    aligned gate names the JAX package's reason, the level builder
    refuses them; the f64 tree sections are the JAX package's."""
    params = {**BASE, **CEGB["split"], "tpu_grow_mode": mode,
              "tpu_aligned_interpret": True,
              "forcedsplits_filename": _forced_file(tmp_path, "one_node")}
    jb, tb, _ = _pair(params)
    gbdt = tb._gbdt
    assert gbdt.train_path == "leafwise"
    assert not gbdt.learner.level_mode_ok()
    X, y = _data()
    jbst = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))
    jl = jbst._gbdt.learner
    assert not jl.level_mode_ok()
    if mode == "auto":
        why = gbdt.learner.aligned_mode_gate(gbdt.objective)
        assert why == jl.aligned_mode_gate(jbst._gbdt.objective)
        assert why == "sequential-only features (forced splits/CEGB)"
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_lazy_penalty_raises(x64):
    """The lazy CEGB penalty no longer raises: it trains on the port's
    host `SerialTreeLearner`, as in the JAX package, with byte-equal
    f64 tree sections."""
    params = {**BASE, "cegb_penalty_feature_lazy": [0.01] * 11}
    jb, tb, _ = _pair(params)
    assert type(tb._gbdt.learner).__name__ == "SerialTreeLearner"
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_convert_carries_forced_cegb_model(x64, tmp_path):
    """A JAX model trained with forced splits and both CEGB penalties,
    carried across by `convert.from_reference`, predicts as the JAX
    package does and writes the same tree sections."""
    params = {**BASE, **CEGB["both"],
              "forcedsplits_filename": _forced_file(tmp_path,
                                                    "three_levels")}
    jb, _, X = _pair(params)
    tb = from_reference(jb.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_array_equal(tb.predict(X[:500], raw_score=True),
                                  jb.predict(X[:500], raw_score=True))
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
