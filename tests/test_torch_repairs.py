"""The port against the JAX package on the CPU where the port used to
diverge without a word (ROADMAP C.17, C.18, C.20-C.23, C.25):

- ``feature_fraction < 1`` draws the JAX package's feature subsets, so
  the f64 leaf-wise model text is byte-equal and the aligned engine
  splits on the same features;
- early stopping, under each alias of its param, and ``tpu_quant_hist=
  on`` train as the JAX package does (they raised until they were
  ported); their off values train as before;
- under a binding ``max_delta_step`` clamp (with L1/L2, ``max_depth`` or
  a monotone constraint) the f64 tree sections, leaf-wise and level,
  are the JAX package's byte for byte: the parent's gain shift is
  contracted as XLA contracts each of its two copies;
- at bin counts of at most 16 the root's side gains are contracted as
  the JAX leaf-wise program's root search contracts them;
- the whole model text is the JAX package's but for the device line."""
import jax
import jax.experimental
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

ROUNDS = 5
SLICE = {"objective": "binary", "tpu_grow_mode": "leafwise",
         "num_leaves": 31, "max_bin": 63, "learning_rate": 0.1,
         "verbosity": -1, "tpu_use_f64_hist": True}


def _slice_data():
    """tests/test_torch_slice.py's data: 4,000 x 10 training rows with 5%
    missing values and 2,000 test rows."""
    rng = np.random.RandomState(0)
    X = rng.standard_normal((6000, 10))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    y = (rng.rand(len(X)) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X[:4000], y[:4000], X[4000:]


def _aligned_data():
    """tests/test_torch_aligned.py's data: 2,500 x 6."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2500, 6)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2]
          + 0.3 * rng.standard_normal(2500)) > 0).astype(np.float32)
    return X, y


def _tree_sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _leafwise_pair(params):
    X, y, Xte = _slice_data()
    jb = jlgb.train(params, jlgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS, verbose_eval=False)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                    verbose_eval=False)
    return jb, tb, Xte


@pytest.mark.parametrize("path", ["leafwise", "aligned"])
@pytest.mark.parametrize("frac", [0.5, 0.9])
def test_feature_fraction_matches_jax(x64, frac, path):
    """C.17: one subset drawn per tree with the JAX package's
    `RandomState(feature_fraction_seed).choice`, in its order. Leaf-wise
    in f64 the tree sections of the model text are the JAX package's byte
    for byte; the aligned engine (its kernels' twins against the JAX
    package's interpret mode) splits on the same features at the same
    thresholds, leaf values at test_torch_aligned.py's tolerance."""
    if path == "leafwise":
        jb, tb, _ = _leafwise_pair({**SLICE, "feature_fraction": frac})
        assert tb.num_trees() == jb.num_trees() == ROUNDS
        assert _tree_sections(tb) == _tree_sections(jb)
        return
    X, y = _aligned_data()
    params = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "metric": "none", "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": 256,
              "feature_fraction": frac}
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(
        X, label=y, params=params).construct())
    for _ in range(ROUNDS):
        jb.update()
    jtrees = jb._gbdt.materialized_models()
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                    verbose_eval=False)
    assert tb._gbdt.train_path == "aligned"
    assert len(tb.trees) == len(jtrees) == ROUNDS
    used = set()
    for a, b in zip(jtrees, tb.trees):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.threshold_in_bin[:k]) == list(b.threshold_in_bin[:k])
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)
        used |= set(b.split_feature[:k].tolist())
    if frac == 0.5:
        # three of six features per tree: the subsets changed from tree
        # to tree, or every tree would split on the same three
        assert len(used) > 3


@pytest.mark.parametrize("alias", ["early_stopping_round",
                                   "early_stopping_rounds",
                                   "early_stopping"])
def test_early_stopping_alias_matches_jax(x64, alias):
    """C.20: a positive early-stopping round under each alias in params
    stops training as the JAX package does (the port used to train every
    round, then raised until early stopping was ported): the same best
    iteration, best score and trees, at learning rate 0.5 and 40 rounds,
    where the validation logloss turns."""
    X, y, _ = _slice_data()
    params = {**SLICE, "learning_rate": 0.5, alias: 2,
              "metric": "binary_logloss"}
    out = {}
    for name, pkg in (("jax", jlgb), ("port", tlgb)):
        p = params if pkg is jlgb else {**params, "device_type": "cpu"}
        tr = pkg.Dataset(X[:3000], label=y[:3000])
        out[name] = pkg.train(p, tr, num_boost_round=40,
                              valid_sets=[tr.create_valid(
                                  X[3000:], label=y[3000:])],
                              verbose_eval=False)
    jb, tb = out["jax"], out["port"]
    assert 0 < tb.best_iteration == jb.best_iteration < 40
    assert tb.num_trees() == jb.num_trees() < 40
    assert dict(tb.best_score["valid_0"]) == dict(jb.best_score["valid_0"])
    assert _tree_sections(tb) == _tree_sections(jb)


@pytest.mark.parametrize("value", [0, None])
def test_early_stopping_off_trains(value):
    X, y, _ = _slice_data()
    bst = tlgb.train({**SLICE, "device_type": "cpu",
                      "early_stopping_round": value},
                     tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                     verbose_eval=False)
    assert bst.num_trees() == ROUNDS


def test_quant_hist_on_matches_jax():
    """C.21: tpu_quant_hist=on quantizes as the JAX package does (the
    port used to train unquantized, then raised until the quantized
    histograms were ported): at 8 bits, without SLICE's f64 histograms
    (which never quantize), the tree sections are the JAX package's byte
    for byte; the integer sums of 4,000 rows stay below 2^24, where the
    JAX package's f32 sums are exact."""
    X, y, _ = _slice_data()
    params = {**SLICE, "tpu_use_f64_hist": False, "tpu_quant_hist": "on",
              "tpu_quant_hist_bits": 8}
    jb, tb, _ = _leafwise_pair(params)
    assert tb._gbdt.learner.quant_bits == 8
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_quant_hist_auto_and_off_train_as_jax(x64, mode):
    """Under auto and off the port trains on: its f64 leaf-wise tree
    sections are the JAX package's under the same mode, byte for byte
    (which quantizes under neither here: off never, auto only on a
    TPU)."""
    jb, tb, _ = _leafwise_pair({**SLICE, "tpu_quant_hist": mode})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)


# five settings whose clamp changes the model text's bits on this data,
# and two that matched without the fused parent shift
@pytest.mark.parametrize("extra", [
    {"max_delta_step": 0.3},
    {"max_delta_step": 0.3, "lambda_l1": 1.0},
    {"max_delta_step": 0.3, "lambda_l2": 1.0},
    {"max_delta_step": 0.7, "lambda_l1": 0.5, "lambda_l2": 2.0},
    {"max_delta_step": 0.3,
     "monotone_constraints": [0, -1, 0, 0, 0, 0, 0, 0, 0, 0]},
    {"max_delta_step": 0.0, "lambda_l1": 1.0},
    {"max_delta_step": 0.05, "lambda_l2": 1.0},
], ids=["0.0", "1.0", "l2", "0.7_l1_l2", "mono_neg", "mds0_l1",
        "0.05_l2"])
def test_max_delta_step_predictions_equal_jax(x64, extra):
    """C.18: under max_delta_step the f64 leaf-wise tree sections of the
    model text are the JAX package's byte for byte, and so are the raw
    predictions. XLA fuses the product `(sh + l2) * out * out` into the
    add of the parent's gain shift it subtracts from the reported gain
    (`ops/split.py::_leaf_gain`); left uncontracted, a split gain
    changes in its last digits and two splits of tree 0 swap. (The first
    two ids are lambda_l1 0 and 1.)"""
    jb, tb, Xte = _leafwise_pair({**SLICE, **extra})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)
    np.testing.assert_array_equal(tb.predict(Xte, raw_score=True),
                                  jb.predict(Xte, raw_score=True))


@pytest.mark.parametrize("mode", ["leafwise", "level"])
def test_max_depth_clamped_matches_jax(x64, mode):
    """C.18b: at max_delta_step 0.3 and max_depth 5, tree 3 of the JAX
    package stops at 25 leaves where a 26th split has a gain of 2^-21,
    both children clamped to -0.03, in both builders. XLA tests a
    threshold's gain against a copy of the parent's shift contracted as
    the side gains are (`_leaf_gain_tested`), which refuses that noise
    split; testing against the reported shift takes it."""
    jb, tb, Xte = _leafwise_pair({**SLICE, "max_delta_step": 0.3,
                                  "max_depth": 5, "tpu_grow_mode": mode})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    if mode == "level":
        assert tb._gbdt.train_path == "level"
    assert _tree_sections(tb) == _tree_sections(jb)
    np.testing.assert_array_equal(tb.predict(Xte, raw_score=True),
                                  jb.predict(Xte, raw_score=True))


@pytest.mark.parametrize("mds", [0.3, 0.0])
def test_monotone_clamped_matches_jax(x64, mds):
    """C.22: with monotone [1, 0, ...] under a binding clamp the JAX
    package's first tree takes 25 splits and refuses 5 more whose gains
    are noise, as C.18b's tested shift does (tested against the reported
    shift, the trees diverge, raw predictions up to 0.031 apart); and at
    max_delta_step 0."""
    jb, tb, Xte = _leafwise_pair({**SLICE, "max_delta_step": mds,
                                  "monotone_constraints": [1] + [0] * 9})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)
    np.testing.assert_array_equal(tb.predict(Xte, raw_score=True),
                                  jb.predict(Xte, raw_score=True))


@pytest.mark.parametrize("max_bin", [10, 12, 13, 16])
def test_small_bin_root_gain_matches_jax(x64, max_bin):
    """C.23: at 16 bins or fewer the JAX leaf-wise program's root search
    contracts `(sh + l2) * out * out` into the side gains' add, where
    every other search contracts `2 * reg * out`; the root's reported
    gain used to differ by 1-2 f32 ulps (at 16 bins tree 0's first gain
    216.04180908203125 against 216.0417938232422). The f64 tree sections
    are the JAX package's byte for byte, beside test_torch_slice.py's 63
    bins."""
    jb, tb, Xte = _leafwise_pair({**SLICE, "max_bin": max_bin})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)
    np.testing.assert_array_equal(tb.predict(Xte, raw_score=True),
                                  jb.predict(Xte, raw_score=True))


@pytest.mark.parametrize("extra", [
    {"lambda_l2": 1.0},
    {"lambda_l2": 1.0, "monotone_constraints": [1] + [0] * 9},
    {"max_delta_step": 0.3, "lambda_l2": 1.0},
], ids=["l2", "l2_mono", "mds_l2"])
def test_small_bin_root_gain_regularized_matches_jax(x64, extra):
    """C.23's rule under regularization at 13 bins: with L2 alone XLA
    contracts the Hessian product on each direction's own prefix side
    only, with a monotone constraint on both sides, and under a binding
    clamp on neither; each form alone would differ in the last bits of
    some root gain."""
    jb, tb, _ = _leafwise_pair({**SLICE, "max_bin": 13, **extra})
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)


def test_whole_model_text_matches_jax(x64):
    """C.25: the whole f64 leaf-wise model text, header, trees, feature
    importances and parameters block, is the JAX package's line for line
    but for `[device_type: tpu]`, which the port leaves out so that a
    CUDA run and a CPU run write the same text. The port keeps the JAX
    package's nine TPU knobs at their defaults (config.py) to write them
    as it does."""
    jb, tb, _ = _leafwise_pair(SLICE)
    jlines = jb.model_to_string().splitlines()
    tlines = tb.model_to_string().splitlines()
    assert "[device_type: tpu]" in jlines
    assert [ln for ln in jlines if ln != "[device_type: tpu]"] == tlines
