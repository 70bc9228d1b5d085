"""The port's level builder (`tpu_grow_mode=level`) on the CPU, through
kernel B5's plain twin, against the JAX package's level builder (run as
its own tests run it on the CPU) and against the port's leaf-wise
builder: packed words bit for bit, B5's twin against the Pallas kernel in
interpret mode, one speculative build table for table, and whole runs
whose model text is byte-equal in f64 mode."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.models.level_builder as JLB
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.pallas_hist import pallas_histogram_words
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import level_builder as TLB
from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.utils import log

N, F, ROUNDS = 4000, 10, 5
PARAMS = {"objective": "binary", "tpu_grow_mode": "level", "num_leaves": 15,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "none"}


def _data(n=N, f=F, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X, y


def _sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


def _auc(y, score):
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y > 0
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) \
        / (pos.sum() * (~pos).sum())


def _port(X, y, rounds=ROUNDS, **extra):
    return tlgb.train({**PARAMS, "device_type": "cpu", **extra},
                      tlgb.Dataset(X, label=y), num_boost_round=rounds,
                      verbose_eval=False)


def _jax(X, y, mp, rounds=ROUNDS, **extra):
    """The JAX package's level run; returns (booster, [(n_exec, exact)]
    of its level builds, fallbacks)."""
    builds = []
    real = JLB.replay_leafwise

    def recording(spec, num_leaves):
        rec, exact = real(spec, num_leaves)
        builds.append((int(spec.n_exec), bool(exact)))
        return rec, exact

    params = {**PARAMS, **extra}
    mp.setattr(JLB, "replay_leafwise", recording)
    bst = jlgb.Booster(params=params, train_set=jlgb.Dataset(
        X, label=y, params=params))
    for _ in range(rounds):
        bst.update()
    mp.setattr(JLB, "replay_leafwise", real)
    return bst, builds, getattr(bst._gbdt.learner, "_level_fallbacks", 0)


@pytest.fixture(scope="module")
def runs():
    """The JAX level runs (a few seconds each, compile included) and the
    port's level and leaf-wise runs on the same data."""
    X, y = _data()
    yr = np.nan_to_num(X[:, 0]) * 2.0 + np.sin(np.nan_to_num(X[:, 1])) + y
    out = {"data": (X, y, yr)}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's f64 mode enters `jax.experimental.enable_x64()`,
        # which JAX 0.9 removed; give it the replacement
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        for mb in (63, 255):
            p = {"max_bin": mb, "tpu_use_f64_hist": True}
            out[("jax", mb)] = _jax(X, y, mp, **p)
            out[("level", mb)] = _port(X, y, **p)
            out[("leafwise", mb)] = _port(X, y, tpu_grow_mode="leafwise",
                                          **p)
        out[("jax", "f32")] = _jax(X, y, mp, max_bin=63)
        out[("level", "f32")] = _port(X, y, max_bin=63)
        p = {"max_bin": 63, "tpu_use_f64_hist": True,
             "objective": "regression"}
        out[("jax", "l2")] = _jax(X, yr, mp, **p)
        out[("level", "l2")] = _port(X, yr, **p)
        p = {"max_bin": 63, "tpu_use_f64_hist": True, "tpu_level_spec": 3.0}
        out[("jax", "tight")] = _jax(X, y, mp, **p)
        out[("level", "tight")] = _port(X, y, **p)
    return out


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f", [4, 7, 28])
def test_pack_bin_words_bit_equal(f):
    """Packed words equal the JAX package's bit for bit, padded features
    included."""
    rng = np.random.RandomState(f)
    bins = rng.randint(0, 256, (1000, f)).astype(np.uint8)
    got = TLB.pack_bin_words(torch.as_tensor(bins)).numpy()
    ref = JLB.pack_bin_words(bins)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    w = torch.as_tensor(got)
    feat = torch.as_tensor(rng.randint(0, f, 1000))
    np.testing.assert_array_equal(
        TLB.extract_bin(w, feat >> 2, (feat & 3) * 8).numpy(),
        bins[np.arange(1000), feat.numpy()])


def _words_case(n, f, max_bin, seed, int_payload):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint8)
    if int_payload:
        g = rng.randint(-8, 9, n).astype(np.float32)
        h = rng.randint(0, 5, n).astype(np.float32)
    else:
        g = rng.standard_normal(n).astype(np.float32)
        h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return bins, g, h


@pytest.mark.parametrize("int_payload", [True, False])
@pytest.mark.parametrize("max_bin", [63, 255])
def test_words_twin_vs_pallas(max_bin, int_payload):
    """B5's twin over a row segment against `pallas_histogram_words` in
    interpret mode over the same rows masked (63 bins: B5a; 255: the
    sub-bin branch B5b): counts equal; integer payloads bit-equal (the
    bf16 hi/lo split is exact on them); float payloads within rtol=2e-4
    (the split keeps ~16 bits; ROADMAP C.4, C.7)."""
    n, f, begin, count = 1536, 7, 301, 777
    bins, g, h = _words_case(n, f, max_bin, 1, int_payload)
    words = JLB.pack_bin_words(bins)
    valid = (np.arange(n) >= begin) & (np.arange(n) < begin + count)
    ref = np.asarray(pallas_histogram_words(
        [jnp.asarray(w) for w in words], jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(valid), num_features=f, max_bin=max_bin, chunk=512,
        interpret=True))
    got = H.histogram_from_words(
        torch.as_tensor(words), torch.as_tensor(g), torch.as_tensor(h),
        torch.tensor([begin], dtype=torch.int32),
        torch.tensor([count], dtype=torch.int32), f, max_bin)[0].numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    if int_payload:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)


def test_words_twin_segments_batch():
    """One call over a segment table (empty segments included) equals one
    call per segment, and f64 sums rounded once are what the twin
    returns."""
    n, f, B = 3000, 9, 63
    bins, g, h = _words_case(n, f, B, 2, False)
    words = torch.as_tensor(JLB.pack_bin_words(bins))
    gt, ht = torch.as_tensor(g), torch.as_tensor(h)
    segs = [(0, 0), (5, 1200), (1205, 0), (2000, 999), (1300, 1)]
    beg = torch.tensor([s[0] for s in segs], dtype=torch.int32)
    cnt = torch.tensor([s[1] for s in segs], dtype=torch.int32)
    got = H.histogram_from_words(words, gt, ht, beg, cnt, f, B)
    assert got.shape == (len(segs), f, B, 3)
    for i, (b, c) in enumerate(segs):
        one = H.histogram_from_words(words, gt, ht, beg[i:i + 1],
                                     cnt[i:i + 1], f, B)[0]
        assert torch.equal(got[i], one)
        rows = np.arange(b, b + c)
        exp = np.zeros((f, B, 3))
        for j in range(f):
            np.add.at(exp[j], bins[rows, j],
                      np.stack([g[rows], h[rows], np.ones(c)], 1)
                      .astype(np.float64))
        np.testing.assert_array_equal(one.numpy(), exp.astype(np.float32))


@pytest.mark.parametrize("precision", ["bf16x2", "pallas", "f16"])
def test_words_rejects_unknown_precision(precision):
    """`histogram_from_words` takes the level builder's precisions, "f32"
    and "f64", and raises on any other (the JAX package's "bf16x2" and
    "pallas" included), on the CPU as on the card."""
    words = torch.zeros((1, 8), dtype=torch.int32)
    g = torch.ones(8)
    seg = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="precision"):
        H.histogram_from_words(words, g, g, seg, seg + 8, 4, 15,
                               precision=precision)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_words_twin_same_in_both_precisions(max_bin):
    """On the CPU both precisions take the twin: f64 sums rounded to f32
    once, the same tensor for "f32" and "f64"."""
    n, f = 2500, 11
    bins, g, h = _words_case(n, f, max_bin, 5, False)
    args = (torch.as_tensor(JLB.pack_bin_words(bins)), torch.as_tensor(g),
            torch.as_tensor(h),
            torch.tensor([3, 900, 2000], dtype=torch.int32),
            torch.tensor([800, 0, 499], dtype=torch.int32), f, max_bin)
    ref = H.histogram_words_plain(*args)
    for precision in ("f32", "f64"):
        got = H.histogram_from_words(*args, precision=precision)
        assert got.dtype == torch.float32
        assert torch.equal(got, ref)


@pytest.mark.parametrize("f64", [False, True])
def test_level_builder_passes_precision(monkeypatch, f64):
    """The level builder hands its ``hist_precision`` to every B5 call,
    the root's and each round's (the JAX level builder passes its own to
    `histogram_from_words`): "f64" under tpu_use_f64_hist, else "f32"."""
    seen = []
    real = TLB.histogram_from_words

    def record(*args, **kw):
        seen.append((args[3].numel(), kw.get("precision")))
        return real(*args, **kw)

    monkeypatch.setattr(TLB, "histogram_from_words", record)
    X, y = _data(1500, 6, seed=3)
    _port(X, y, rounds=2, max_bin=63, tpu_use_f64_hist=f64)
    want = "f64" if f64 else "f32"
    assert len(seen) > 2 and any(k > 1 for k, _ in seen)
    assert {p for _, p in seen} == {want}


# ---------------------------------------------------------------------------
def test_one_level_build_matches_jax():
    """One speculative build on the same gradients in f64 mode: executed
    splits, the final row permutation, the physical blocks and the
    replay's covering values equal the JAX package's (`_level_fn`)."""
    X, y = _data()
    p = {**PARAMS, "max_bin": 63, "tpu_use_f64_hist": True,
         "num_leaves": 31}
    rng = np.random.RandomState(4)
    prob = (1 / (1 + np.exp(-rng.standard_normal(N)))).astype(np.float32)
    g = (prob - y).astype(np.float32)
    h = (prob * (1 - prob)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        jl = jlgb.Booster(params=p, train_set=jlgb.Dataset(
            X, label=y, params=p))._gbdt.learner
        js = jax.device_get(jl._level_fn()(
            jl.words_dev, jnp.asarray(g), jnp.asarray(h),
            jl._fmask_arr(None)))
    jrec, jexact = JLB.replay_leafwise(js._replace(rid=None), 31)
    ds = tlgb.Dataset(X, label=y, params={**p, "device_type": "cpu"}) \
        .construct()._handle
    tl = DeviceTreeLearner(Config.from_params(p), ds, torch.device("cpu"))
    np.testing.assert_array_equal(tl.words_dev.numpy(),
                                  np.asarray(jl.words_dev))
    ts = TLB.make_level_build_fn(tl)(tl.words_dev, torch.as_tensor(g),
                                     torch.as_tensor(h),
                                     tl.fmask_tensor(None))
    trec, texact = TLB.replay_leafwise(ts, 31)
    ne = int(js.n_exec)
    assert ts.n_exec == ne > 30 and ts.rounds > 1
    np.testing.assert_array_equal(ts.execI[:ne], np.asarray(js.execI)[:ne])
    np.testing.assert_array_equal(ts.execF[:ne], np.asarray(js.execF)[:ne])
    np.testing.assert_array_equal(ts.rid.numpy(), np.asarray(js.rid))
    np.testing.assert_array_equal(ts.block_begin, np.asarray(js.block_begin))
    np.testing.assert_array_equal(ts.block_cnt, np.asarray(js.block_cnt))
    assert texact == jexact
    np.testing.assert_array_equal(trec.block_value, jrec.block_value)
    assert trec.num_splits == int(jrec.num_splits)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_f64_level_matches_jax_level(runs, max_bin):
    """tpu_use_f64_hist: the tree sections of the model text equal the
    JAX level run's byte for byte, with the same executed splits per
    tree and the same fallbacks."""
    jb, jbuilds, jfall = runs[("jax", max_bin)]
    tb = runs[("level", max_bin)]
    g = tb._gbdt
    assert g.train_path == "level"
    assert [(e, x) for _, e, x in g.level_stats] == jbuilds
    assert g.learner.level_fallbacks == jfall
    assert _sections(tb) == _sections(jb)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_f64_level_matches_port_leafwise(runs, max_bin):
    assert _sections(runs[("level", max_bin)]) == \
        _sections(runs[("leafwise", max_bin)])


def test_default_precision_matches_jax(runs):
    """f32 mode: the JAX package's CPU histograms split the payload into
    bf16 halves and B5's twin sums in f64, so leaf values may differ by
    ~1e-4 of themselves (ROADMAP C.4): raw predictions, sums of five
    leaf values near 0.1, within rtol=1e-4 + atol=1e-4 (observed 1.4e-5
    at most); holdout AUC within 2e-3."""
    X, y, _ = runs["data"]
    Xte, yte = _data(2000, seed=1)
    jb, _, _ = runs[("jax", "f32")]
    tb = runs[("level", "f32")]
    np.testing.assert_allclose(tb.predict(Xte, raw_score=True),
                               jb.predict(Xte, raw_score=True), rtol=1e-4,
                               atol=1e-4)
    a_t, a_j = _auc(yte, tb.predict(Xte)), _auc(yte, jb.predict(Xte))
    assert a_t > 0.7 and abs(a_t - a_j) < 2e-3


def test_l2_level_matches_jax(runs):
    jb, jbuilds, _ = runs[("jax", "l2")]
    tb = runs[("level", "l2")]
    assert [(e, x) for _, e, x in tb._gbdt.level_stats] == jbuilds
    assert _sections(tb) == _sections(jb)


def test_inexact_fallback_matches_jax(runs):
    """tpu_level_spec=3.0 (S = 45 slots for 15 leaves) leaves some trees
    inexact: as many fall back as in the JAX run, the trees stay its
    trees, and the training score is a fresh predict of the model."""
    X, y, _ = runs["data"]
    jb, jbuilds, jfall = runs[("jax", "tight")]
    tb = runs[("level", "tight")]
    g = tb._gbdt
    assert 0 < g.learner.level_fallbacks == jfall < ROUNDS
    assert [(e, x) for _, e, x in g.level_stats] == jbuilds
    assert _sections(tb) == _sections(jb)
    np.testing.assert_allclose(g.train_score.score[0].numpy(),
                               tb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_budget_exhausted_falls_back_as_jax():
    """Deep leaf-wise trees (20,000 x 28 HIGGS-like rows, 63 leaves, f64):
    the breadth-first speculation spends its S - 1 = 283 splits before it
    reaches their deepest splits, the replay is inexact and the tree grows
    leaf-wise, in the JAX package as in the port (the HIGGS shape on the
    card does the same at 255 leaves; PERF.md)."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((20000, 28), dtype=np.float32)
    for j in range(7):
        X[:, 27 - j] = np.abs(X[:, 2 * j] * X[:, 2 * j + 1]) \
            + 0.1 * X[:, 27 - j]
    w = rng.standard_normal(28).astype(np.float32) / np.sqrt(28)
    margin = X @ w + 0.5 * np.sin(X[:, 0] * 2.0) * X[:, 1]
    y = (rng.random(20000) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    p = {"num_leaves": 63, "max_bin": 63, "tpu_use_f64_hist": True}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        jb, jbuilds, jfall = _jax(X, y, mp, rounds=1, **p)
    tb = _port(X, y, rounds=1, **p)
    assert jbuilds == [(283, False)] and jfall == 1
    assert [(e, x) for _, e, x in tb._gbdt.level_stats] == jbuilds
    assert tb._gbdt.learner.level_fallbacks == 1
    assert _sections(tb) == _sections(jb)


def _real_splits(tree, floor=1e-3):
    """(feature, threshold bin, gain) of the splits whose gain is above
    ``floor``, in a fixed order."""
    k = tree.num_leaves - 1
    gain = np.asarray(tree.split_gain[:k])
    keep = gain > floor
    return sorted(zip(np.asarray(tree.split_feature[:k])[keep].tolist(),
                      np.asarray(tree.threshold_in_bin[:k])[keep].tolist(),
                      gain[keep].tolist()))


# the JAX package's tests/test_level.py::test_level_matches_leafwise cases,
# on that test's data at 10,000 rows
@pytest.mark.parametrize("extra", [
    {},                                             # budget-bound
    {"num_leaves": 255, "min_data_in_leaf": 50},    # unconstrained
    {"num_leaves": 7, "min_data_in_leaf": 5},       # tiny budget
    {"categorical_feature": "3"},                   # categorical splits
    {"monotone_constraints": "1,0,0,0,0,0,0,0,0,0"},
    {"max_depth": 4},
], ids=["budget", "255_leaves", "tiny", "categorical", "monotone",
        "max_depth"])
def test_level_matches_leafwise(extra):
    """f64 mode, 31 leaves unless the case says otherwise: the level
    run's model text equals the leaf-wise run's, and its training score
    is the model's raw prediction. At 255 leaves the first tree reaches
    leaves whose rows all carry one gradient: their splits have zero gain
    up to rounding, many tie exactly, and the replay breaks a tie by slot
    where leaf-wise growth breaks it by leaf index (ROADMAP C.14, the JAX
    package's design). There the splits above that noise are the same,
    and so is the first tree's prediction (a zero-gain split leaves its
    children one value, up to rounding: atol=1e-6)."""
    rng = np.random.RandomState(0)
    X = rng.randn(10000, 10).astype(np.float32)
    X[:, 3] = rng.randint(0, 8, 10000)
    y = (X[:, 0] + X[:, 1] * (X[:, 3] > 3)
         + 0.3 * rng.randn(10000) > 0).astype(np.float32)
    p = {"num_leaves": 31, "max_bin": 63, "tpu_use_f64_hist": True, **extra}
    lv = _port(X, y, **p)
    lw = _port(X, y, tpu_grow_mode="leafwise", **p)
    assert lv._gbdt.train_path == "level"
    if p["num_leaves"] == 255:
        assert _real_splits(lv.trees[0]) == _real_splits(lw.trees[0])
        np.testing.assert_allclose(
            lv.predict(X, raw_score=True, num_iteration=1),
            lw.predict(X, raw_score=True, num_iteration=1), rtol=0,
            atol=1e-6)
    else:
        assert _sections(lv) == _sections(lw)
    np.testing.assert_allclose(lv._gbdt.train_score.score[0].numpy(),
                               lv.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_pure_leaf_split_gain_is_rounding_noise():
    """ROADMAP C.13: a leaf whose rows all carry one (g, h) has zero
    split gain in exact arithmetic; both finders return rounding noise
    there, below 1e-6 x the leaf's sum_g^2 / sum_h. Its bits and sign
    follow the f32 op order, and which thresholds pass `gain >
    min_gain_shift` follows the contraction of the shift XLA tests
    against (`ops/split.py::_leaf_gain_tested`): with that copy the
    port's noise is the JAX package's bit for bit, so both split such a
    leaf or both stop."""
    from lightgbm_tpu.ops import split as jsplit
    from lightgbm_tpu_torch.ops import split as tsplit
    f, B = 6, 63
    cfg = Config.from_params({"device_type": "cpu", "min_data_in_leaf": 5})
    meta = dict(num_bin=np.full(f, B, np.int32),
                default_bin=np.zeros(f, np.int32),
                missing_type=np.zeros(f, np.int32),
                bin_type=np.zeros(f, np.int32),
                monotone=np.zeros(f, np.int32),
                penalty=np.ones(f, np.float32))
    jf = jsplit.make_split_finder(jsplit.SplitHyper.from_config(cfg), meta,
                                  B)
    tf = tsplit.make_split_finder(tsplit.SplitHyper.from_config(cfg), meta,
                                  B)
    noise = 0
    for seed in range(8):
        cnt = np.random.RandomState(seed).poisson(4, (f, B)) \
            .astype(np.float32)
        hist = np.stack([cnt * np.float32(0.5002123),
                         cnt * np.float32(0.2499999), cnt], -1)
        sg = hist[0, :, 0].sum(dtype=np.float32)
        sh = hist[0, :, 1].sum(dtype=np.float32)
        n = int(cnt[0].sum())
        jg = np.asarray(jf(jnp.asarray(hist), jnp.float32(sg),
                           jnp.float32(sh), jnp.int32(n),
                           jnp.float32(-np.inf),
                           jnp.float32(np.inf))["gain"])
        tg = tf(torch.tensor(hist)[None], torch.tensor([sg]),
                torch.tensor([sh]), torch.tensor([n]),
                torch.tensor([-np.inf]), torch.tensor([np.inf]))["gain"][0] \
            .numpy()
        for gain in (jg, tg):
            fin = gain[np.isfinite(gain)]
            assert np.all(np.abs(fin) <= 1e-6 * sg * sg / sh)
        np.testing.assert_array_equal(tg, jg)
        noise += int(np.isfinite(jg).sum())
    assert noise > 0       # some thresholds pass the test on noise alone


def test_lambdarank_level_matches_leafwise():
    """lambdarank's row-order gradients (kernel B6's twin) pass through the
    level builder unchanged: f64 model text equal to the leaf-wise run's."""
    rng = np.random.RandomState(3)
    sizes = rng.randint(5, 40, 120)
    n = int(sizes.sum())
    X = rng.randn(n, 8)
    y = np.clip((X[:, 0] + 0.5 * rng.randn(n)) * 1.5 + 2, 0, 4).round()
    texts = []
    for mode in ("level", "leafwise"):
        bst = tlgb.train({**PARAMS, "objective": "lambdarank",
                          "tpu_use_f64_hist": True, "max_bin": 63,
                          "tpu_grow_mode": mode, "device_type": "cpu"},
                         tlgb.Dataset(X, label=y, group=sizes),
                         num_boost_round=3, verbose_eval=False)
        assert bst._gbdt.train_path == mode
        texts.append(_sections(bst))
    assert texts[0] == texts[1]


def test_gate_and_log():
    """The log names the level path; a categorical feature (which used to
    raise) trains on the level builder too, with categorical nodes, and
    the run's training score is its model's prediction."""
    X, y = _data(1000)
    lines = []
    log.register_callback(lines.append)
    try:
        _port(X, y, rounds=1, verbosity=1)
    finally:
        log.register_callback(None)
    assert any("training path: level" in ln for ln in lines)
    Xc = np.nan_to_num(X)
    Xc[:, 3] = np.arange(len(Xc)) % 6
    y = (np.isin(Xc[:, 3], [1, 4]) ^ (Xc[:, 0] > 0.5)).astype(np.float64)
    bst = _port(Xc, y, rounds=2, categorical_feature="3",
                max_cat_to_onehot=1, cat_smooth=1.0, min_data_per_group=5)
    g = bst._gbdt
    assert g.train_path == "level" and len(g.level_stats) == 2
    assert any(t.num_cat > 0 for t in bst.trees)
    np.testing.assert_allclose(g.train_score.score[0].numpy(),
                               bst.predict(Xc, raw_score=True), rtol=1e-5,
                               atol=1e-6)
