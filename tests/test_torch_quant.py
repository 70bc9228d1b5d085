"""Quantized histograms (``tpu_quant_hist=on``) on the port's leaf-wise
learner against the JAX package on the CPU.

- `utils/prng.py`: ``fold_in`` and draws under any key bit-equal to
  ``jax.random.fold_in`` and ``jax.random.uniform(key, (N, 2))``.
- `quantize_gh` bit-equal to the JAX package's (q and the scale), an
  all-zero hessian column included.
- B1's twin on integer payloads bit-equal to `histogram_from_gathered_gh`
  (the JAX leaf-wise program's precision: one bf16 pass at 8 bits, the
  bf16 hi/lo split at 16) and to `pallas_histogram(interpret=True)`.
- Tree sections byte-equal at int8 / 2,000 rows and int16 / 500 rows
  (their integer sums stay below 2^24, where the JAX package's f32 sums
  are exact), with bagging, GOSS and softmax K = 3 (a fresh rounding key
  each class tree); at int16 / 20,000 rows the JAX package's f32 sums
  round and the port's do not: the same splits for the first trees, leaf
  values within 1e-4 relative (the stated tolerance).
- f64 histograms, ``gpu_use_dp``, ``tpu_grow_mode=level`` and ``auto``
  do not quantize, with the JAX package's reasons; under ``on`` the
  aligned gate fails with its reason.

The JAX runs clear `compile_cache.clear_programs()` first (ROADMAP
C.19); the data is dense (C.24)."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.pallas_hist import pallas_histogram
from lightgbm_tpu_torch.convert import from_reference
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.utils import prng

BASE = {"objective": "binary", "tpu_grow_mode": "leafwise",
        "num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "min_data_in_leaf": 5, "verbosity": -1, "tpu_quant_hist": "on"}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(n, f=10, seed=0, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    if classes > 2:
        y = np.digitize(margin + 0.5 * rng.standard_normal(n),
                        [-0.5, 0.5]).astype(np.float64)
    else:
        y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X, y


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _pair(params, n, rounds=5, classes=2):
    X, y = _data(n, classes=classes)
    compile_cache.clear_programs()
    jb = jlgb.Booster(params=params,
                      train_set=jlgb.Dataset(X, label=y, params=params))
    for _ in range(rounds):
        jb.update()
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=rounds,
                    verbose_eval=False)
    return jb, tb, X


@pytest.mark.parametrize("seed", [1, 7, 123456])
@pytest.mark.parametrize("qseq", [1, 2, 31])
def test_fold_in_and_uniform_bit_equal(seed, qseq):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(qseq))
    k = prng.fold_in(prng.key(seed), qseq)
    assert tuple(int(w) for w in np.asarray(jax.random.key_data(key))) == k
    u = np.asarray(jax.random.uniform(key, (1001, 2), jnp.float32))
    got = prng.uniform_key(k, (1001, 2)).numpy()
    np.testing.assert_array_equal(u.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("zero_hess", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_gh_bit_equal(bits, zero_hess):
    """q and the scale equal the JAX package's (the scale taken as XLA
    takes it: absmax times the f32 reciprocal of qmax); an all-zero
    hessian column keeps its floor scale 1e-30 and all-zero q."""
    rng = np.random.RandomState(bits)
    gh = np.stack([rng.standard_normal(3000) * 0.3,
                   rng.uniform(0.0, 0.25, 3000)], 1).astype(np.float32)
    if zero_hess:
        gh[:, 1] = 0.0
    key = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(5))
    jq, js = JH.quantize_gh(jnp.asarray(gh), bits, key)
    tq, ts = H.quantize_gh(torch.tensor(gh), bits,
                           prng.fold_in(prng.key(3), 5))
    assert tq.dtype == (torch.int8 if bits == 8 else torch.int16)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.uint32),
                                  ts.numpy().view(np.uint32))
    if zero_hess:
        assert float(ts[1]) == np.float32(1e-30)
        assert not tq[:, 1].any()


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("max_bin", [63, 255])
def test_twin_matches_jax_on_integer_payload(bits, max_bin):
    """The twin's exact int64 sums rounded to f32 once equal the JAX
    package's f32 sums of the integers (exact below 2^24: 4,000 rows
    here) through `histogram_from_gathered_gh` and through the Pallas
    kernel in interpret mode."""
    rng = np.random.RandomState(max_bin + bits)
    n, f = 4000 if bits == 8 else 500, 6
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint8)
    gh = np.stack([rng.standard_normal(n), rng.uniform(0.01, 0.25, n)],
                  1).astype(np.float32)
    q, _ = H.quantize_gh(torch.tensor(gh), bits, prng.key(9))
    valid = rng.rand(n) < 0.7
    idx = torch.tensor(np.nonzero(valid)[0], dtype=torch.int32)
    got = H.histogram_plain(torch.tensor(bins), q, idx, 0, idx.numel(),
                            max_bin)
    assert got.dtype == torch.float32
    prec = "bf16" if bits == 8 else "bf16x2"
    ref = JH.histogram_from_gathered_gh(jnp.asarray(bins),
                                        jnp.asarray(q.numpy()),
                                        jnp.asarray(valid), max_bin,
                                        precision=prec)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    pal = pallas_histogram(jnp.asarray(bins), jnp.asarray(q.numpy()),
                           jnp.asarray(valid), max_bin, interpret=True)
    np.testing.assert_array_equal(np.asarray(pal), got.numpy())
    via = H.histogram_from_gathered_gh(torch.tensor(bins), q,
                                       torch.tensor(valid), max_bin)
    assert torch.equal(via, got)


@pytest.mark.parametrize("n,bits", [(2000, 8), (500, 16)])
@pytest.mark.parametrize("variant", ["plain", "bagging", "goss"])
def test_tree_sections_match_jax(n, bits, variant):
    """Byte-equal tree sections: the integer sums are exact in both
    packages, the scale is XLA's, and the port follows the JAX program's
    two contractions of the scale products (the root's right g sum;
    under one padded bucket, the larger child's stored histogram)."""
    extra = {"plain": {},
             "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1,
                         "feature_fraction": 0.7},
             "goss": {"boosting": "goss", "learning_rate": 0.3}}[variant]
    rounds = 8 if variant == "goss" else 5
    jb, tb, _ = _pair({**BASE, **extra, "tpu_quant_hist_bits": bits}, n,
                      rounds)
    lr = tb._gbdt.learner
    assert lr.quant_bits == bits == jb._gbdt.learner.quant_bits
    assert lr._qseq == rounds
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_multiclass_int8_matches_jax():
    """Softmax K = 3 at 8 bits: each class tree draws its own rounding
    key (qseq one a tree), and the tree sections are byte-equal."""
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "tpu_quant_hist_bits": 8}
    jb, tb, _ = _pair(params, 2000, rounds=3, classes=3)
    assert tb._gbdt.learner._qseq == 9
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_int16_large_leaves_within_tolerance():
    """At int16 / 20,000 rows the integer sums pass 2^24: the JAX
    package's f32 sums round, the port's are exact. The first two trees
    split on the same features at the same thresholds; every leaf value
    of them agrees within 1e-4 relative, 1e-6 absolute (the stated
    tolerance)."""
    jb, tb, _ = _pair({**BASE, "tpu_quant_hist_bits": 16}, 20000, rounds=2)
    jt = jb._gbdt.materialized_models()
    for a, b in zip(jt, tb.trees):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.threshold_in_bin[:k]) == list(b.threshold_in_bin[:k])
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["f64", "gpu_use_dp", "level", "auto",
                                  "off"])
def test_modes_that_do_not_quantize(x64, case):
    """f64 histograms, gpu_use_dp, the level builder, auto and off keep
    f32 payloads, with the JAX package's reasons, and no histogram of
    the run takes the integer branch; f64's tree sections are the JAX
    package's byte for byte."""
    extra = {"f64": {"tpu_use_f64_hist": True},
             "gpu_use_dp": {"gpu_use_dp": True},
             "level": {"tpu_grow_mode": "level"},
             "auto": {"tpu_quant_hist": "auto"},
             "off": {"tpu_quant_hist": "off"}}[case]
    params = {**BASE, **extra}
    X, y = _data(1500)
    compile_cache.clear_programs()
    jb = jlgb.Booster(params=params,
                      train_set=jlgb.Dataset(X, label=y, params=params))
    jl = jb._gbdt.learner
    calls = []
    orig = H._histogram_plain_int
    try:
        H._histogram_plain_int = lambda *a: calls.append(1) or orig(*a)
        tb = tlgb.train({**params, "device_type": "cpu"},
                        tlgb.Dataset(X, label=y), num_boost_round=2,
                        verbose_eval=False)
    finally:
        H._histogram_plain_int = orig
    lr = tb._gbdt.learner
    assert lr.quant_bits == jl.quant_bits == 0
    assert lr.quant_why == jl._quant_why
    assert not calls
    if case == "f64":
        for _ in range(2):
            jb.update()
        assert _sections(tb.model_to_string()) \
            == _sections(jb.model_to_string())


def test_quant_on_fails_the_aligned_gate():
    """Under on, auto (with the aligned engine's twins on) grows
    leaf-wise: the aligned gate names the JAX package's reason."""
    params = {**BASE, "tpu_grow_mode": "auto", "tpu_aligned_interpret": True,
              "tpu_quant_hist_bits": 8}
    X, y = _data(1500)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=2,
                    verbose_eval=False)
    jb = jlgb.Booster(params=params,
                      train_set=jlgb.Dataset(X, label=y, params=params))
    gbdt = tb._gbdt
    assert gbdt.train_path == "leafwise"
    why = gbdt.learner.aligned_mode_gate(gbdt.objective)
    assert why == jb._gbdt.learner.aligned_mode_gate(jb._gbdt.objective)
    assert why == "tpu_quant_hist=on (quantized hist rides the fused path)"


def test_convert_carries_quantized_model():
    """A JAX model trained with int8 histograms, carried across by
    `convert.from_reference`, predicts as the JAX package does."""
    jb, _, X = _pair({**BASE, "tpu_quant_hist_bits": 8}, 2000, rounds=3)
    tb = from_reference(jb.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_array_equal(tb.predict(X[:500], raw_score=True),
                                  jb.predict(X[:500], raw_score=True))
