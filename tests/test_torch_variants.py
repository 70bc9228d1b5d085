"""GOSS, DART and RF in the port against the JAX package on the CPU: the
port's Threefry against `jax.random.uniform`, the GOSS selection bit for
bit, each variant's f64 trees byte for byte, the checks that raise, and
RF's averaged output."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import boosting_variants as JBV
from lightgbm_tpu_torch.models import boosting_variants as TBV
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.utils import prng

N, N_TEST, F, ROUNDS = 3000, 1000, 8, 6
PARAMS = {"objective": "binary", "tpu_grow_mode": "leafwise",
          "num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_use_f64_hist": True}
# learning_rate 0.5: GOSS samples from iteration int(1 / 0.5) = 2 on
VARIANTS = {
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "dart": {"boosting": "dart"},
    "dart_uniform": {"boosting": "dart", "uniform_drop": True,
                     "skip_drop": 0.0},
    "dart_xgboost": {"boosting": "dart", "xgboost_dart_mode": True,
                     "skip_drop": 0.0},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1},
}


def _data():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((N + N_TEST, F))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    y = (rng.rand(len(X)) < 1 / (1 + np.exp(
        -(z[:, 0] - 0.8 * z[:, 1] * z[:, 2])))).astype(np.float64)
    return X[:N], y[:N], X[N:], y[N:]


@pytest.fixture(scope="module")
def runs():
    """Each variant trained by both packages (f64 histograms)."""
    Xtr, ytr, Xte, yte = _data()
    out = {"data": (Xtr, ytr, Xte, yte)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        for name, extra in VARIANTS.items():
            p = {**PARAMS, **extra}
            jb = jlgb.train(p, jlgb.Dataset(Xtr, label=ytr),
                            num_boost_round=ROUNDS, verbose_eval=False)
            tb = tlgb.train({**p, "device_type": "cpu"},
                            tlgb.Dataset(Xtr, label=ytr),
                            num_boost_round=ROUNDS, verbose_eval=False)
            out[name] = (jb, tb)
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 2])
@pytest.mark.parametrize("n", [1, 5, 1001, 65539])
def test_threefry_uniform_bit_equal(seed, n):
    """`prng.uniform` is `jax.random.uniform(PRNGKey(seed), (n,))` bit
    for bit (the partitionable counters; odd lengths, one above 2^16)."""
    assert jax.config.jax_threefry_partitionable
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(
        np.uint32(seed)), (n,)))
    got = prng.uniform(seed, n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", [3, 2**31 - 2])
def test_goss_select_bit_equal(seed):
    """`goss_select_body`: the keep-mask and the multiplier of the JAX
    function's (jitted, as GOSS runs it), with ties in |g * h|."""
    rng = np.random.RandomState(seed % 1000)
    n = 5001
    g = np.round(rng.standard_normal((1, n)), 1).astype(np.float32)
    h = rng.uniform(0.05, 0.25, (1, n)).astype(np.float32)
    top_k, other_k = max(1, int(n * 0.2)), max(1, int(n * 0.1))
    fn = jax.jit(lambda g, h, s: JBV.goss_select_body(g, h, s[0], n, top_k,
                                                      other_k))
    jm, jmult = fn(jnp.asarray(g), jnp.asarray(h),
                   jnp.asarray([seed], jnp.uint32))
    tm, tmult = TBV.goss_select_body(torch.tensor(g), torch.tensor(h), seed,
                                     n, top_k, other_k)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmult.numpy().view(np.uint32),
                                  np.asarray(jmult).view(np.uint32))
    assert int(tm.sum()) >= top_k + other_k


def _tree_sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_f64_trees_byte_equal(runs, name):
    """The tree sections of each variant's model text are the JAX
    package's byte for byte; each trains leaf-wise and says why the
    aligned engine did not take it."""
    jb, tb = runs[name]
    g = tb._gbdt
    assert type(g).__name__ == {"goss": "GOSS", "rf": "RF"}.get(
        name, "DART")
    assert g.train_path == "leafwise"
    assert g.aligned_gate().startswith(f"boosting={g.cfg.boosting}")
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    assert _tree_sections(tb) == _tree_sections(jb)
    Xte = runs["data"][2]
    np.testing.assert_allclose(tb.predict(Xte, raw_score=True),
                               jb.predict(Xte, raw_score=True),
                               rtol=1e-5, atol=1e-7)


def test_goss_samples_after_its_warmup(runs):
    """GOSS with learning_rate 0.5 keeps every row in iterations 0-1 and
    the top rows plus a sample of the rest from iteration 2 on."""
    _, tb = runs["goss"]
    g = tb._gbdt
    # ties at the threshold join the top rows
    assert int(N * 0.2) + int(N * 0.1) <= g.bag_data_cnt < N
    assert g._goss_multiplier is not None
    root = tb.trees[0]
    assert root.leaf_count[:root.num_leaves].sum() == N


def test_dart_dropped_trees_stay_positive(runs):
    """DART's renormalized trees keep their sign: the stored leaf values
    equal the JAX package's after the drops (-1, then 1/(k+1), then
    -k)."""
    jb, tb = runs["dart_uniform"]
    assert tb._gbdt.drop_index
    for jt, tt in zip(jb.trees, tb.trees):
        np.testing.assert_array_equal(tt.leaf_value[:tt.num_leaves],
                                      jt.leaf_value[:jt.num_leaves])


def test_variant_checks_raise_as_jax():
    """top_rate + other_rate > 1, and RF without a bag fraction below 1,
    raise the JAX package's errors."""
    Xtr, ytr, _, _ = _data()
    cases = (({"boosting": "goss", "top_rate": 0.7, "other_rate": 0.5},
              "top_rate \\+ other_rate must be <= 1.0"),
             ({"boosting": "rf", "bagging_fraction": 1.0,
               "pos_bagging_fraction": 0.5, "bagging_freq": 1},
              "RF needs bagging"))
    for extra, msg in cases:
        p = {**PARAMS, **extra}
        with pytest.raises(ValueError, match=msg):
            jlgb.Booster(params=p, train_set=jlgb.Dataset(Xtr, label=ytr))
        with pytest.raises(ValueError, match=msg):
            tlgb.Booster(params={**p, "device_type": "cpu"},
                         train_set=tlgb.Dataset(Xtr, label=ytr))


def test_rf_average_output(runs):
    """RF's model text carries average_output; its predictions equal the
    JAX package's and the reloaded model's, and are the mean of its
    trees."""
    jb, tb = runs["rf"]
    Xte = runs["data"][2]
    text = tb.model_to_string()
    assert "\naverage_output\n" in text
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    p = tb.predict(Xte)
    np.testing.assert_allclose(p, jb.predict(Xte), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(loaded.predict(Xte), p, rtol=1e-12)
    raw = tb.predict(Xte, raw_score=True)
    per_tree = [tlgb.Booster(params={"device_type": "cpu"},
                             model_str=text).predict(
        Xte, raw_score=True, start_iteration=i, num_iteration=1)
        for i in range(ROUNDS)]
    np.testing.assert_allclose(raw, np.mean(per_tree, axis=0), rtol=1e-9)
    # the training scores hold the running average too
    g = tb._gbdt
    np.testing.assert_allclose(g.train_score.score[0].numpy(),
                               tb.predict(runs["data"][0], raw_score=True),
                               rtol=1e-5, atol=1e-6)


def test_create_boosting_names_each_variant():
    Xtr, ytr, _, _ = _data()
    for name, cls in (("gbdt", GBDT), ("goss", TBV.GOSS),
                      ("dart", TBV.DART), ("rf", TBV.RF)):
        p = {**PARAMS, **VARIANTS.get(name, {}), "device_type": "cpu"}
        b = tlgb.Booster(params=p, train_set=tlgb.Dataset(Xtr, label=ytr))
        assert type(b._gbdt) is cls
