"""The port's objectives and metrics against the JAX package on the CPU.

- Gradients: each objective's `get_gradients` is bit-equal to the JAX
  package's jitted program on seeded scores, weighted and not (weighted
  xentlambda within ROADMAP C.31's bound: its ``log1p`` is the
  library's).
- Kernel twins: `_payload`'s pointwise kinds (COMPACT records) in
  `slot_hist_pass_plain` and `move_pass_plain` against the Pallas
  kernels in interpret mode with the JAX objective's own gradient
  inlined: counts equal, g/h within C.7's rtol 2e-4.
- Training: the f64 tree sections of every objective are byte-equal to
  the JAX package's (l1, quantile and mape on the host learner, the rest
  leaf-wise), with equal predictions and equal ``evals_result`` of the
  default metric on a validation set; the aligned engine (xentropy on
  COMPACT records, huber on STANDARD records) holds to the JAX aligned
  run with 0 fallbacks; a custom objective (``fobj``) gives the JAX
  package's trees.
- Metrics: every metric of the JAX registry equals the JAX value (f64,
  1e-12 relative); the registries hold the same names.

Every JAX run clears `compile_cache.clear_programs()` first (ROADMAP
C.19: huber's and quantile's ``alpha``, ``fair_c``,
``poisson_max_delta_step`` and ``tweedie_variance_power`` are read from
the config, not keyed in its gradient program)."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu.ops import metrics as JM
from lightgbm_tpu.ops import objectives as JO
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA
from lightgbm_tpu_torch.ops import metrics as TM
from lightgbm_tpu_torch.ops import objectives as TO

OBJECTIVES = {
    "regression_l1": {}, "huber": {"alpha": 0.7}, "fair": {"fair_c": 1.3},
    "poisson": {"poisson_max_delta_step": 0.6}, "quantile": {"alpha": 0.3},
    "mape": {}, "gamma": {}, "tweedie": {"tweedie_variance_power": 1.3},
    "xentropy": {}, "xentlambda": {},
}
HOST = ("regression_l1", "quantile", "mape")
# the pointwise kinds the aligned engine's kernels compute (l1 and
# quantile train on the host learner, but are kinds all the same)
KINDS = ("huber", "fair", "poisson", "gamma", "tweedie", "xentropy",
         "regression_l1", "quantile")
BASE = {"tpu_grow_mode": "leafwise", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "verbosity": -1, "tpu_use_f64_hist": True}
ROUNDS = 4


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _labels(obj, margin, rng):
    """Labels an objective accepts, from a margin: positive counts or
    amounts for the log-link family, probabilities for cross-entropy."""
    n = len(margin)
    if obj in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.4 * margin)).astype(np.float64)
    elif obj == "gamma":
        y = np.exp(0.5 * margin) * rng.gamma(2.0, 1.0, n) + 1e-3
    elif obj in ("xentropy", "xentlambda"):
        y = 1.0 / (1.0 + np.exp(-margin))
    else:
        y = 3.0 * margin + rng.standard_normal(n)
    return y


def _data(obj, n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 8))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    return X, _labels(obj, margin, rng)


def _objectives(obj, y, w):
    """(JAX objective, port objective) initialised on labels y, weights w."""
    p = {"objective": obj, **OBJECTIVES.get(obj, {})}
    jm, tm = JMeta(len(y)), Metadata(len(y))
    for md in (jm, tm):
        md.set_label(np.asarray(y, np.float32))
        md.weight = None if w is None else np.asarray(w, np.float32)
    jo = JO.create_objective(JConfig.from_params(p))
    jo.init(jm, len(y))
    to = TO.create_objective(Config.from_params(p))
    to.init(tm, len(y))
    return jo, to


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("obj", sorted(OBJECTIVES))
def test_gradients_bit_equal_to_jax(obj, weighted):
    """Seeded scores (a few exactly at the label: sign(0) is 0), 50,000
    rows; weighted xentlambda (C.31): g and h within 1e-5 x their
    largest |value|, NaN at the same rows."""
    rng = np.random.default_rng(3)
    n = 50_000
    _, y = _data(obj, n=n, seed=1)
    w = rng.uniform(0.2, 3.0, n) if weighted else None
    sc = (rng.standard_normal(n) * 2).astype(np.float32)
    sc[:40] = np.float32(y[:40])
    compile_cache.clear_programs()
    jo, to = _objectives(obj, y, w)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(sc[None])))
    tg, th = (a.numpy() for a in to.get_gradients(torch.tensor(sc[None])))
    if obj == "xentlambda" and weighted:
        for a, b in ((tg, jg), (th, jh)):
            assert np.array_equal(np.isnan(a), np.isnan(b))
            fin = np.isfinite(b)
            err = np.abs(a[fin] - b[fin]).max()
            assert err <= 1e-5 * np.abs(b[fin]).max()
        return
    np.testing.assert_array_equal(tg.view(np.int32), jg.view(np.int32))
    np.testing.assert_array_equal(th.view(np.int32), jh.view(np.int32))


def test_registries_match_jax():
    """The port's objective and metric registries hold the JAX package's
    names, and its default metric for each objective; every objective
    builds and initialises, none raises NotImplementedError."""
    assert set(TO._OBJECTIVES) == set(JO._OBJECTIVES)
    assert set(TM._METRICS) == set(JM._METRICS)
    assert TM._DEFAULT_METRIC_FOR_OBJECTIVE == \
        JM._DEFAULT_METRIC_FOR_OBJECTIVE
    y = np.abs(_data("regression", n=200)[1]) % 1.0
    for name in TO._OBJECTIVES:
        p = {"objective": name, "num_class": 3}
        md = Metadata(200)
        md.set_label(np.floor(y * 3) if name.startswith("multiclass")
                     else y)
        if name == "lambdarank":
            md.set_label(np.floor(y * 3))
            md.set_group([100, 100])
        TO.create_objective(Config.from_params(p)).init(md, 200)
    for name in TM._METRICS:
        assert TM.create_metrics(Config.from_params({"metric": name}))


# ---------------------------------------------------------------------------
# the pointwise kinds of the kernel twins against Pallas (interpret mode)
# ---------------------------------------------------------------------------
N, F, CHUNK = 2500, 6, 256


@pytest.fixture(scope="module")
def compact_calls():
    """The B2 and B4 calls of a two-tree binary aligned run on COMPACT
    records, through the twins on the CPU."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, F)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2]
          + 0.3 * rng.standard_normal(N)) > 0).astype(np.float32)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    params = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
              "verbosity": -1, "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": CHUNK,
              "device_type": "cpu"}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("move_pass", "slot_hist_pass"):
            mp.setattr(AB, name, recorder(name, getattr(AB, name)))
        bst = tlgb.train(params, tlgb.Dataset(X, label=y),
                         num_boost_round=2, verbose_eval=False)
    assert bst._gbdt._aligned_eng.compact
    return calls, y


def _random_scores(rec, wcnt, seed):
    """The records with seeded scores in the score lane, so that every
    kind's gradients vary from row to row."""
    rec = rec.clone()
    rng = np.random.RandomState(seed)
    sc = (rng.standard_normal(rec[:, wcnt].shape) * 1.5).astype(np.float32)
    rec[:, wcnt] = torch.tensor(sc).view(torch.int32)
    return rec


@pytest.mark.parametrize("kind", KINDS)
def test_point_kinds_twin_equal_pallas(compact_calls, kind):
    """B4's root pass and B2's second move with the kind's `PointGrad`
    (its constants from the objective) against the Pallas kernels with
    the JAX objective's `point_grad_fn` inlined, on the same records with
    seeded scores: counts equal, g/h within rtol 2e-4 (C.7)."""
    calls, y = compact_calls
    jo, to = _objectives(kind, y, None)
    pg, jfn = to.point_grad_fn(), jo.point_grad_fn()
    assert pg.kind == {"regression_l1": "l1"}.get(kind, kind)
    _, sargs, _ = next(c for c in calls if c[0] == "slot_hist_pass")
    rec, slots, meta, k, F_, B, wcnt, bits, _ = sargs
    rec = _random_scores(rec, wcnt, 1)
    got = TA.slot_hist_pass_plain(rec, slots, meta, k, F_, B, wcnt, bits,
                                  pg).numpy()
    ref = np.asarray(JA.slot_hist_pass(
        jnp.asarray(rec.numpy()), jnp.asarray(slots.numpy()),
        jnp.asarray(meta.numpy()), k, F_, B, CHUNK, 8, wcnt, bits=bits,
        grad_fn=jfn, interpret=True))
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)

    moves = [c for c in calls if c[0] == "move_pass"]
    (mrec, r1, r2, bl, br, mmeta, wsel, hs, mk, F_, B, wcnt, bits,
     w_used, _) = moves[1][1]
    mrec = _random_scores(mrec, wcnt, 2)
    _, got = TA.move_pass_plain(mrec, r1, r2, bl, br, mmeta, wsel, hs, mk,
                                F_, B, wcnt, bits, w_used, pg)
    _, ref = JA.move_pass(
        jnp.asarray(mrec.numpy()),
        *(jnp.asarray(a.numpy() if torch.is_tensor(a) else a)
          for a in (r1, r2, bl, br, mmeta, wsel, hs)),
        jnp.zeros((mk + 1) * 8, jnp.int32), CHUNK, mrec.shape[1], wcnt, mk,
        F_, B, 8, bits=bits, grad_fn=jfn, w_used=w_used, interpret=True)
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


def test_point_kinds_reach_the_kernels():
    """Every kind has a kernel code, and `_grad_args` hands the kernel
    the PointGrad's three constants."""
    for kind in TA.POINT_KINDS:
        assert TA._GRAD_KIND[kind] >= 1
    pg = TO.PointGrad("tweedie", 0.25, 0.75)
    assert TA._grad_args(pg, 3) == (TA._GRAD_KIND["tweedie"], 0.25, 0.75,
                                    1.0, 0, 3, 4)


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------
def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _lines(text, key):
    """The values of every tree's ``key=`` line of a model text."""
    return [ln[len(key) + 1:] for ln in _sections(text).splitlines()
            if ln.startswith(key + "=")]


def _train_pair(params, X, y, w=None, rounds=ROUNDS, valid=None,
                fobj=None):
    """(JAX booster, port booster, JAX evals_result, port evals_result)."""
    out = []
    for lgb, extra in ((jlgb, {}), (tlgb, {"device_type": "cpu"})):
        if lgb is jlgb:
            compile_cache.clear_programs()
        ds = lgb.Dataset(X, label=y, weight=w)
        ev = {}
        vs = [] if valid is None else [lgb.Dataset(
            valid[0], label=valid[1], reference=ds)]
        bst = lgb.train({**params, **extra}, ds, num_boost_round=rounds,
                        valid_sets=vs, evals_result=ev, verbose_eval=False,
                        fobj=fobj)
        out.append((bst, ev))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("obj", sorted(OBJECTIVES))
def test_f64_trees_match_jax(x64, obj, weighted):
    """Four rounds at 15 leaves, 63 bins: the tree sections byte-equal,
    the predictions equal and the default metric's evals_result on a
    validation set equal; l1, quantile and mape train on the host
    learner. Weighted xentlambda (C.31): the first tree's splits equal
    and its leaf values within 1e-5 relative (its gradients are not the
    JAX package's bits, and its hessians hold NaN, so later trees may
    route missing values the other way)."""
    X, y = _data(obj)
    Xv, yv = _data(obj, n=800, seed=5)
    w = np.random.RandomState(5).uniform(0.3, 2.0, len(y)) \
        if weighted else None
    params = {**BASE, "objective": obj, **OBJECTIVES[obj]}
    jb, tb, jev, tev = _train_pair(params, X, y, w, valid=(Xv, yv))
    assert tb._gbdt.train_path == ("host" if obj in HOST else "leafwise")
    assert type(tb._gbdt.learner).__name__ == (
        "SerialTreeLearner" if obj in HOST else "DeviceTreeLearner")
    assert list(tev["valid_0"]) == list(jev["valid_0"]) == \
        [JM._DEFAULT_METRIC_FOR_OBJECTIVE[obj]]
    if obj == "xentlambda" and weighted:
        jt, tt = jb.model_to_string(), tb.model_to_string()
        for key in ("split_feature", "threshold", "decision_type"):
            assert _lines(tt, key)[0] == _lines(jt, key)[0]
        np.testing.assert_allclose(
            np.array(_lines(tt, "leaf_value")[0].split(), float),
            np.array(_lines(jt, "leaf_value")[0].split(), float), rtol=1e-5)
        return
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))
    assert tev == jev


def test_custom_objective_matches_jax(x64):
    """``fobj`` (a pseudo-Huber gradient of the raw scores) through
    `train` gives the JAX package's trees, and `Booster.update(fobj=)`
    continues both alike."""
    X, y = _data("regression")

    def fobj(preds, ds):
        d = preds - np.asarray(ds.get_label())
        s = np.sqrt(1.0 + (d / 2.0) ** 2)
        return d / s, 1.0 / s ** 3

    params = {**BASE, "objective": "none"}
    jb, tb, _, _ = _train_pair(params, X, y, fobj=fobj)
    assert tb._gbdt.objective is None
    text = _sections(jb.model_to_string())
    assert _sections(tb.model_to_string()) == text
    np.testing.assert_array_equal(tb.predict(X[:300]), jb.predict(X[:300]))
    boosters = []
    for lgb, extra in ((jlgb, {}), (tlgb, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        full = {**params, **extra}
        bst = lgb.Booster(full, lgb.Dataset(X, label=y, params=full))
        for _ in range(ROUNDS):
            bst.update(fobj=fobj)
        boosters.append(_sections(bst.model_to_string()))
    assert boosters == [text, text]


def _jax_aligned(params, X, y, rounds):
    ds = jlgb.Dataset(X, label=y, params=params).construct()
    compile_cache.clear_programs()
    bst = jlgb.Booster(params=params, train_set=ds)
    for _ in range(rounds):
        bst.update()
    g = bst._gbdt
    stats = [(int(m.record.rounds), int(m.record.n_exec)) for m in g.models]
    g.materialized_models()
    return bst, stats


@pytest.mark.parametrize("obj,layout", [("xentropy", "compact"),
                                        ("huber", "standard")])
def test_aligned_engine_matches_jax_aligned(obj, layout):
    """The port's aligned engine (its twins) against the JAX aligned run
    (Pallas in interpret mode): xentropy on {0, 1} labels takes COMPACT
    records and its kind in the kernels, huber on real labels STANDARD
    records and `_grad_lanes`; the same rounds and executed splits a
    tree, no fallback, splits equal and leaf values within C.7's rtol
    1e-4."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2500, 6)).astype(np.float32)
    m = X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(2500)
    y = (m > 0).astype(np.float32) if layout == "compact" else 2.0 * m
    params = {"objective": obj, **OBJECTIVES[obj], "num_leaves": 8,
              "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "metric": "none", "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": 256}
    jb, jstats = _jax_aligned(params, X, y, ROUNDS)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                    verbose_eval=False)
    g = tb._gbdt
    assert g.train_path == "aligned"
    assert g._aligned_eng.compact == (layout == "compact")
    assert g._aligned_eng.fallbacks == 0
    assert [(r, e) for r, e, _ in g.aligned_stats] == jstats
    for a, b in zip(jb._gbdt.models, tb.trees):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.threshold_in_bin[:k]) == list(b.threshold_in_bin[:k])
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
# the objective whose output transform each metric evaluates
_METRIC_OBJECTIVE = {
    "l1": "regression_l1", "l2": "regression", "rmse": "regression",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape", "gamma": "gamma",
    "gamma_deviance": "gamma", "tweedie": "tweedie",
    "binary_logloss": "binary", "binary_error": "binary", "auc": "binary",
    "multi_logloss": "multiclass", "multi_error": "multiclass",
    "ndcg": "lambdarank", "map": "lambdarank", "xentropy": "xentropy",
    "xentlambda": "xentlambda", "kldiv": "xentropy",
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", sorted(JM._METRICS))
def test_metric_equals_jax(metric, weighted):
    """Each metric on seeded scores, through its objective's output
    transform (f64 host forms in both packages): within 1e-12
    relative."""
    rng = np.random.default_rng(11)
    n = 4000
    obj = _METRIC_OBJECTIVE[metric]
    K = 3 if obj == "multiclass" else 1
    _, y = _data(obj if obj in OBJECTIVES else "regression", n=n, seed=2)
    if obj in ("binary", "lambdarank"):
        y = (y > 0).astype(np.float64) * (1 + (obj == "lambdarank")
                                          * (np.abs(y) > 2))
    elif obj == "multiclass":
        y = np.digitize(y, [-1.0, 1.0]).astype(np.float64)
    w = rng.uniform(0.3, 2.0, n) if weighted else None
    scores = (rng.standard_normal((K, n)) * 0.8).astype(np.float64)
    p = {"objective": obj, "metric": metric, "num_class": K,
         "alpha": 0.8, "fair_c": 0.9, "tweedie_variance_power": 1.4,
         "eval_at": [1, 3, 5]}
    vals = []
    for CfgCls, Meta, mod, omod in ((JConfig, JMeta, JM, JO),
                                    (Config, Metadata, TM, TO)):
        cfg = CfgCls.from_params(p)
        md = Meta(n)
        md.set_label(y.astype(np.float32))
        md.weight = None if w is None else w.astype(np.float32)
        if obj == "lambdarank":
            md.set_group([40] * (n // 40))
        objective = omod.create_objective(cfg)
        objective.init(md, n)
        (m,) = mod.create_metrics(cfg)
        m.init(md, n)
        vals.append(m.eval(scores, objective))
    (jv, tv) = vals
    assert [name for name, _ in tv] == [name for name, _ in jv]
    np.testing.assert_allclose([v for _, v in tv], [v for _, v in jv],
                               rtol=1e-12, atol=0)
