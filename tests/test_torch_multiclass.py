"""Multiclass (softmax and one-vs-all) in the port against the JAX package
on the CPU: the objectives' gradients, the multiclass metrics, the K-lane
COMPACT records, the class-lane twins of B4 and B2's children against the
Pallas kernels in interpret mode, f64 trees byte for byte on the
leaf-wise and level builders, the aligned engine through its twins, its
leaf-wise fallback, its gates, predictions and model text, the boosting
variants, and the eval surface's repairs (the train set's name, C.27;
the f32 device AUC, C.28)."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.models import aligned_builder as JAB
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu.ops import metrics as JM
from lightgbm_tpu.ops import objectives as JO
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA
from lightgbm_tpu_torch.ops import metrics as TM
from lightgbm_tpu_torch.ops import objectives as TO
from lightgbm_tpu_torch.ops.predict import predict_raw_values

N, F, CHUNK, ROUNDS = 2000, 6, 256, 4
CAT = [5]
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1, "bagging_seed": 5}


def _params(obj, K, **extra):
    return {"objective": obj, "num_class": K, "num_leaves": 8,
            "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
            "verbosity": -1, "tpu_chunk": CHUNK, **extra}


def _data(K, n=N, seed=0):
    """Five normal columns and one categorical column of 8 codes; the
    label drawn from a softmax of linear margins (the categorical column
    moves class 0)."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, F))
    X[:, 5] = rng.randint(0, 8, n)
    margins = [X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 3]] \
        + [0.3 * X[:, j % 5] for j in range(K - 3)]
    logits = np.stack(margins, 1)
    logits[:, 0] += X[:, 5] % 3 == 0
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = (rng.rand(n, 1) > np.cumsum(p, 1)).sum(1).astype(np.float64)
    return X, np.minimum(y, K - 1)


@pytest.fixture(autouse=True)
def _jax_f64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed; give it the replacement (C.5)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _jax_train(p, X, y, rounds=ROUNDS, cat=CAT, **kw):
    """A JAX run on a Dataset that bins with the run's params, its
    program cache cleared first: a gradient program keyed without
    ``sigmoid`` would otherwise carry an earlier run's (C.19; one-vs-all's
    class 0 and a binary run on ``label == 0`` share a key)."""
    compile_cache.clear_programs()
    ds = jlgb.Dataset(X, label=y, categorical_feature=cat, params=p)
    return jlgb.train(p, ds, num_boost_round=rounds, verbose_eval=False,
                      **kw)


def _port_train(p, X, y, rounds=ROUNDS, cat=CAT, **kw):
    return tlgb.train({**p, "device_type": "cpu"},
                      tlgb.Dataset(X, label=y, categorical_feature=cat),
                      num_boost_round=rounds, verbose_eval=False, **kw)


def _tree_sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


# ---------------------------------------------------------------------------
# objectives and metrics
# ---------------------------------------------------------------------------
def _objectives(obj, K, y, weight=None, **extra):
    p = {"objective": obj, "num_class": K, **extra}
    n = len(y)
    jo = JO.create_objective(JConfig.from_params(p))
    jm = JMeta(n)
    jm.set_label(y)
    jm.weight = weight
    jo.init(jm, n)
    to = TO.create_objective(TConfig.from_params(p))
    tm = TMeta(n)
    tm.set_label(y)
    tm.set_weight(weight)
    to.init(tm, n)
    return jo, to


@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("K", [3, 7])
def test_gradients_bit_equal(obj, K):
    """The [K, N] gradients and hessians of seeded f32 scores are the JAX
    package's `get_gradients` bit for bit (softmax: `jax.nn.softmax`'s
    order and XLA's exp; OVA: a `BinaryLogloss` a class), with weights
    too; the per-class init scores equal."""
    rng = np.random.RandomState(K)
    y = rng.randint(0, K, 5000).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 5000).astype(np.float32)
    sc = (3 * rng.standard_normal((K, 5000))).astype(np.float32)
    for weight in (None, w):
        if obj == "multiclassova":
            compile_cache.clear_programs()
        jo, to = _objectives(obj, K, y, weight, sigmoid=1.3)
        jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(sc)))
        tg, th = (a.numpy() for a in to.get_gradients(torch.tensor(sc)))
        np.testing.assert_array_equal(tg.view(np.int32), jg.view(np.int32))
        np.testing.assert_array_equal(th.view(np.int32), jh.view(np.int32))
        assert [to.boost_from_score(k) for k in range(K)] \
            == [jo.boost_from_score(k) for k in range(K)]
        assert to.mc_lane_mode() == jo.mc_lane_mode()


def test_label_check():
    """A label outside [0, K) raises, as in the JAX package."""
    with pytest.raises(ValueError, match="Label must be in"):
        _objectives("multiclass", 3, np.array([0, 1, 3], np.float32))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
def test_metrics_match_jax(obj, top_k):
    """multi_logloss and multi_error (multi_error_top_k 1 and 2), with and
    without weights, equal the JAX package's to 1e-12 relative."""
    K, n = 5, 3000
    rng = np.random.RandomState(top_k)
    y = rng.randint(0, K, n).astype(np.float32)
    raw = rng.standard_normal((K, n))
    for weight in (None, rng.uniform(0.5, 2, n).astype(np.float32)):
        jo, to = _objectives(obj, K, y, weight)
        cfg = {"objective": obj, "num_class": K,
               "multi_error_top_k": top_k}
        for name in ("multi_logloss", "multi_error"):
            jm = JM.create_metrics(JConfig.from_params(cfg), [name])[0]
            tm = TM.create_metrics(TConfig.from_params(cfg), [name])[0]
            for m, o, meta in ((jm, jo, JMeta(n)), (tm, to, TMeta(n))):
                meta.set_label(y)
                meta.weight = weight
                m.init(meta, n)
            (jn, jv), = jm.eval(raw, jo)
            (tn, tv), = tm.eval(raw, to)
            assert jn == tn
            np.testing.assert_allclose(tv, jv, rtol=1e-12)
    assert TM.metric_names(TConfig.from_params(
        {"objective": obj, "num_class": K})) == ["multi_logloss"]


# ---------------------------------------------------------------------------
# records and the class-lane twins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_prob", [False, True])
@pytest.mark.parametrize("K", [3, 31])
def test_pack_records_match_jax(K, with_prob):
    """K score lanes (and K probability lanes), the integer class in meta
    bits 24-30 and the bag bit: the lanes and the records equal the JAX
    package's `lane_layout` / `pack_records` bit for bit."""
    rng = np.random.RandomState(K)
    bins = rng.randint(0, 60, (1000, 12)).astype(np.uint8)
    y = rng.randint(0, K, 1000).astype(np.float32)
    got = TA.pack_records(torch.tensor(bins), y, None, CHUNK, compact=True,
                          max_bin=63, num_class=K, with_prob=with_prob)
    ref = JA.pack_records(bins, y, None, CHUNK, compact=True, max_bin=63,
                          num_class=K, with_prob=with_prob)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    assert got[1:] == (ref[1], ref[2], got[3], ref[4])
    np.testing.assert_array_equal(got[3], ref[3])
    assert TA.lane_layout(got[1], compact=True, num_class=K,
                          with_prob=with_prob) \
        == JA.lane_layout(ref[1], compact=True, num_class=K,
                          with_prob=with_prob)


def _record(names):
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped
    return calls, recorder


@pytest.fixture(scope="module", params=["prob", "score"])
def mc_rounds(request):
    """The kernel calls of the first two iterations of the port's aligned
    engine (through the twins), K = 3, unbagged and bagged, softmax
    ("prob") or one-vs-all ("score")."""
    obj = "multiclass" if request.param == "prob" else "multiclassova"
    X, y = _data(3)
    out = {}
    for bagged in (False, True):
        calls, recorder = _record(("move_pass", "slot_hist_pass"))
        with pytest.MonkeyPatch.context() as mp:
            for name in ("move_pass", "slot_hist_pass", "count_pass"):
                mp.setattr(AB, name, recorder(name, getattr(AB, name)))
            extra = BAG if bagged else {}
            bst = _port_train(_params(obj, 3, tpu_grow_mode="aligned",
                                      tpu_aligned_interpret=True, **extra),
                              X, y, rounds=2)
        out[bagged] = (bst, calls)
    return request.param, out


def _jax_class_grad(eng, grad):
    """The grad_fn the JAX engine's `_mc_payload_fn` builds for this
    class, over a stand-in for the engine (its lanes, lane mode, bag and
    objective)."""
    p = {"objective": "multiclass" if grad.kind == "prob"
         else "multiclassova", "num_class": eng.num_class}
    jo, _ = _objectives(p["objective"], eng.num_class,
                        eng.objective._label_np)
    stand_in = type("Eng", (), {})()
    stand_in.lanes = dict(eng.lanes)
    stand_in.mc_mode = grad.kind
    stand_in.bagged = eng.bagged
    stand_in.objective = jo
    return JAB.AlignedEngine._mc_payload_fn(stand_in, grad.cls)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("bagged", [False, True])
def test_slot_hist_class_lanes_match_pallas(mc_rounds, bagged):
    """B4's class-lane twin on each class's root pass against the Pallas
    kernel in interpret mode with the grad_fn of `_mc_payload_fn`: counts
    equal, sums within rtol=2e-4 (C.7); bagged, the counts are the
    bag's."""
    mode, runs = mc_rounds
    bst, calls = runs[bagged]
    eng = bst._gbdt._aligned_eng
    roots = [(a, kw) for name, a, kw in calls
             if name == "slot_hist_pass"][:3]
    assert [a[8].cls for a, _ in roots] == [0, 1, 2]
    for args, kw in roots:
        rec, slots, meta, k, F_, B, wcnt, bits, grad = args
        assert isinstance(grad, TA.ClassGrad) and grad.kind == mode
        got = TA.slot_hist_pass_plain(*args, **kw).numpy()
        ref = np.asarray(JA.slot_hist_pass(
            jnp.asarray(rec.numpy()), jnp.asarray(slots.numpy()),
            jnp.asarray(meta.numpy()), k, F_, B, CHUNK, 8, wcnt,
            bag_lane=kw["bag_lane"], bits=bits,
            grad_fn=_jax_class_grad(eng, grad), num_class=eng.num_class,
            interpret=True))
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)
        assert got[0, 0, :, 2].sum() == (int(0.8 * N) if bagged else N)


@pytest.mark.parametrize("bagged", [False, True])
def test_move_pass_class_lanes_match_pallas(mc_rounds, bagged):
    """B2 on a round of class 1 (the wider records move whole: every used
    lane, the score, probability and meta lanes with their rows) and its
    smaller children's class-lane histograms against the Pallas kernel in
    interpret mode."""
    mode, runs = mc_rounds
    bst, calls = runs[bagged]
    eng = bst._gbdt._aligned_eng
    moves = [(a, kw) for name, a, kw in calls if name == "move_pass"
             and a[14].cls == 1]
    assert moves
    args, kw = moves[1]
    (rec, r1, r2, bl, br, meta, wsel, hs, k, F_, B, wcnt, bits, w_used,
     grad) = args
    kw = {"cbits": kw["cbits"], "gh_off": kw["gh_off"],
          "bag_lane": kw["bag_lane"]}
    got_rec, got_hist = TA.move_pass_plain(*args, **kw)
    cb = kw["cbits"] if kw["cbits"] is not None \
        else torch.zeros((k + 1) * 8, dtype=torch.int32)
    ref_rec, ref_hist = JA.move_pass(
        jnp.asarray(rec.numpy()),
        *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
        jnp.asarray(cb.numpy()), CHUNK, rec.shape[1], wcnt, k, F_, B, 8,
        bag_lane=kw["bag_lane"], bits=bits,
        grad_fn=_jax_class_grad(eng, grad), num_class=eng.num_class,
        w_used=w_used, interpret=True)
    outs = [TA.move_pass_plain(*args, out=torch.full_like(rec, fill),
                               **kw)[0][:, 0] for fill in (-1, -2)]
    cov = (outs[0] == outs[1]).numpy()
    got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
    assert w_used == eng.lanes["meta"] + 1
    for u in range(w_used):
        np.testing.assert_array_equal(got_np[:, u][cov], ref_np[:, u][cov])
    ref_hist = np.asarray(ref_hist)
    np.testing.assert_array_equal(got_hist.numpy()[..., 2],
                                  ref_hist[..., 2])
    np.testing.assert_allclose(got_hist.numpy(), ref_hist, rtol=2e-4,
                               atol=1e-3)


def test_move_pass_wide_records_twin():
    """B2's twin on K = 31 softmax records (W = 72 lanes): a random split
    of every chunk moves all 66 used lanes with their rows, and the
    smaller child's class-lane histogram equals a histogram of the moved
    rows."""
    K = 31
    rng = np.random.RandomState(4)
    n, C = 3000, CHUNK
    bins = rng.randint(0, 60, (n, 12)).astype(np.uint8)
    y = rng.randint(0, K, n).astype(np.float32)
    rec, wcnt, W, cnts, bits = TA.pack_records(
        torch.tensor(bins), y, None, C, compact=True, max_bin=63,
        num_class=K, with_prob=True)
    lanes, _ = TA.lane_layout(wcnt, compact=True, num_class=K,
                              with_prob=True)
    p = torch.softmax(torch.tensor(rng.standard_normal((rec.shape[0], K, C)),
                                   dtype=torch.float32), dim=1)
    rec[:, lanes["prob"]:lanes["prob"] + K] = p.view(torch.int32)
    nc = rec.shape[0]
    tot = 2 * nc + 2
    full = torch.cat([rec, torch.zeros((tot - nc, W, C), dtype=torch.int32)])
    w_used = lanes["meta"] + 1
    assert w_used == 66 and W == 72
    meta = torch.zeros(tot, dtype=torch.int32)
    meta[:nc] = torch.tensor(cnts, dtype=torch.int32)
    meta[0] |= 1 << TA.META_FIRST
    meta[nc - 1] |= 1 << TA.META_LAST
    r1 = torch.full((tot,), 30, dtype=torch.int32)
    r2 = torch.full((tot,), TA.pack_route2(0, 64), dtype=torch.int32)
    wsel = torch.zeros(tot, dtype=torch.int32)
    left = int((bins[:, 0] <= 30).sum())
    nl = -(-left // C)
    bl = torch.full((tot,), nc, dtype=torch.int32)
    br = torch.full((tot,), nc + nl, dtype=torch.int32)
    hs = torch.zeros(tot, dtype=torch.int32)
    hs[nc:] = 1
    grad = TA.ClassGrad("prob", 7, lanes["prob"] + 7, lanes["meta"])
    out, hist = TA.move_pass_plain(full, r1, r2, bl, br, meta, wsel, hs, 1,
                                   12, 64, wcnt, bits, w_used, grad)
    moved = out[nc:nc + nl].transpose(1, 2).reshape(-1, W)[:left]
    src = full[:nc].transpose(1, 2).reshape(-1, W)[:n]
    np.testing.assert_array_equal(moved[:, :w_used].numpy(),
                                  src[bins[:, 0] <= 30][:, :w_used].numpy())
    slots = torch.full((tot,), 1, dtype=torch.int32)
    slots[nc:nc + nl] = 0
    cm = torch.zeros(tot, dtype=torch.int32)
    cm[nc:nc + nl] = C
    cm[nc + nl - 1] = left - (nl - 1) * C
    ref = TA.slot_hist_pass_plain(out, slots, cm, 1, 12, 64, wcnt, bits,
                                  grad)
    torch.testing.assert_close(hist, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the aligned engine against the JAX package
# ---------------------------------------------------------------------------
def _leaf_map(ref, got, X):
    """The row partitions of two trees are equal: each leaf of ``got``
    holds the rows of one leaf of ``ref``. Returns (ref leaf per row,
    got leaf per row)."""
    a = predict_raw_values([ref], X, leaf_index=True)[:, 0]
    b = predict_raw_values([got], X, leaf_index=True)[:, 0]
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len({u for u, _ in pairs}) \
        == len({v for _, v in pairs})
    return a, b


@pytest.mark.parametrize("obj,bagged,K", [
    ("multiclass", False, 3), ("multiclass", True, 3),
    ("multiclassova", False, 3), ("multiclassova", True, 3),
    ("multiclass", True, 7)])
def test_aligned_matches_jax_leafwise(obj, bagged, K):
    """The aligned engine through its twins (K = 3, and 7 bagged): every
    iteration on the engine with no fallback, in mode "prob" (softmax)
    or "score" (OVA); its trees are the JAX package's leaf-wise f64 trees up to C.7:
    the same split features, the same partition of the training rows
    into leaves with the same counts, and leaf values within rtol=1e-4.
    Leaves are matched by their rows, not by their ids: a categorical
    split's two sides can be swapped when its forward and reverse scans
    tie up to rounding (seen on a 3,000-row draw of 7 classes)."""
    X, y = _data(K)
    extra = BAG if bagged else {}
    jb = _jax_train(_params(obj, K, tpu_grow_mode="leafwise",
                            tpu_use_f64_hist=True, **extra), X, y)
    tb = _port_train(_params(obj, K, tpu_grow_mode="aligned",
                             tpu_aligned_interpret=True, **extra), X, y)
    g = tb._gbdt
    eng = g._aligned_eng
    assert g.train_path == "aligned" and eng.fallbacks == 0
    assert eng.mc_mode == ("prob" if obj == "multiclass" else "score")
    assert eng.bagged == bagged and eng.num_class == K
    assert len(g.aligned_stats) == ROUNDS * K
    assert all(exact for _, _, exact in g.aligned_stats)
    Xb = X.copy()
    for a, b in zip(jb.trees, tb.trees):
        k = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        la, lb = _leaf_map(a, b, Xb)
        np.testing.assert_allclose(b.leaf_value[lb], a.leaf_value[la],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(b.leaf_count[lb], a.leaf_count[la])
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), atol=1e-5)


def test_aligned_fallback_matches_leafwise(monkeypatch):
    """An inexact class 1 in the first iteration: the engine's copy
    restores the pre-iteration scores, and the iteration's K trees and
    the scores after it equal a leaf-wise iteration's; the next
    iteration goes on on the engine."""
    K = 3
    X, y = _data(K)
    orig = AB.AlignedEngine.train_iter
    seen = []

    def train_iter(self, scale, fmask=None, grads=None, class_k=0):
        spec, exact = orig(self, scale, fmask, grads, class_k)
        seen.append(class_k)
        return spec, exact and len(seen) != 2
    monkeypatch.setattr(AB.AlignedEngine, "train_iter", train_iter)
    p = _params("multiclass", K, tpu_grow_mode="aligned",
                tpu_aligned_interpret=True)
    tb = tlgb.Booster({**p, "device_type": "cpu"},
                      tlgb.Dataset(X, label=y, categorical_feature=CAT))
    tb.update()
    g = tb._gbdt
    assert g._aligned_eng.fallbacks == 1 and seen == [0, 1]
    ref = tlgb.Booster({**p, "device_type": "cpu",
                        "tpu_grow_mode": "leafwise"},
                       tlgb.Dataset(X, label=y, categorical_feature=CAT))
    ref.update()
    assert _tree_sections(tb) == _tree_sections(ref)
    torch.testing.assert_close(g._aligned_eng.row_scores_all(),
                               ref._gbdt.train_score.score, rtol=0, atol=0)
    tb.update()
    assert g._aligned_eng.fallbacks == 1 and len(tb.trees) == 2 * K
    assert g.aligned_stats[-1][2]


def test_gates_give_the_jax_reasons():
    """Weighted data, K > 127 and n > 2^24 (on the gate function) keep
    the aligned engine out with the JAX package's reasons."""
    X, y = _data(3, n=600)
    w = np.linspace(0.5, 1.5, 600)
    y128 = (np.arange(600) % 128).astype(np.float64)
    for label, weight, K in ((y, w, 3), (y128, None, 128), (y, None, 3)):
        p = _params("multiclass", K, tpu_grow_mode="aligned",
                    tpu_aligned_interpret=True, metric="none")
        jd = jlgb.Dataset(X, label=label, weight=weight, params=p)
        jg = jlgb.Booster(params=p, train_set=jd)._gbdt
        tg = tlgb.Booster({**p, "tpu_grow_mode": "auto",
                           "device_type": "cpu"},
                          tlgb.Dataset(X, label=label, weight=weight))._gbdt
        if weight is None and K == 3:
            jg.learner.n = tg.learner.n = (1 << 24) + 1
        want = jg.learner.aligned_mode_gate(jg.objective)
        assert want is not None
        assert tg.learner.aligned_mode_gate(tg.objective) == want


# ---------------------------------------------------------------------------
# predict, model text, convert, variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
def test_predict_and_model_text_match_jax(obj):
    """Raw and converted [N, K] predictions, ``pred_leaf``,
    ``num_iteration`` and ``start_iteration`` equal the JAX package's;
    the model text is its own line for line but `[device_type: tpu]`
    (C.25),
    its objective line ``multiclass num_class:3`` or ``multiclassova
    num_class:3 sigmoid:1.5``; a port Booster loaded from it predicts
    alike."""
    K = 3
    X, y = _data(K)
    p = _params(obj, K, tpu_grow_mode="leafwise", tpu_use_f64_hist=True,
                sigmoid=1.5)
    jb = _jax_train(p, X, y)
    tb = _port_train(p, X, y)
    Xt = _data(K, n=300, seed=1)[0]
    for kw in ({}, {"raw_score": True}, {"num_iteration": 2},
               {"start_iteration": 1, "raw_score": True},
               {"start_iteration": 1, "num_iteration": 2}):
        np.testing.assert_allclose(tb.predict(Xt, **kw),
                                   jb.predict(Xt, **kw), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(tb.predict(Xt, pred_leaf=True),
                                  jb.predict(Xt, pred_leaf=True))
    jt, tt = jb.model_to_string(), tb.model_to_string()
    jlines = jt.splitlines()
    assert "[device_type: tpu]" in jlines
    assert [ln for ln in jlines if ln != "[device_type: tpu]"] \
        == tt.splitlines()
    line = [s for s in tt.splitlines() if s.startswith("objective=")][0]
    assert line == ("objective=multiclass num_class:3" if obj == "multiclass"
                    else "objective=multiclassova num_class:3 sigmoid:1.5")
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=tt)
    np.testing.assert_allclose(loaded.predict(Xt), jb.predict(Xt),
                               rtol=1e-12, atol=1e-12)


def test_convert_from_reference_three_classes():
    """`convert.from_reference` of a JAX 3-class model, from its text and
    from its tree arrays, predicts as the JAX package does."""
    X, y = _data(3)
    jb = _jax_train(_params("multiclass", 3, tpu_grow_mode="leafwise"),
                    X, y)
    Xt = _data(3, n=300, seed=2)[0]
    want = jb.predict(Xt)
    a = convert.from_reference(model_str=jb.model_to_string(),
                               params={"device_type": "cpu"})
    b = convert.from_reference(arrays={
        "trees": [convert.tree_arrays(t) for t in jb.trees],
        "objective": "multiclass num_class:3", "num_tree_per_iteration": 3,
        "feature_names": [f"Column_{i}" for i in range(F)]},
        params={"device_type": "cpu"})
    for bst in (a, b):
        assert bst.num_tree_per_iteration == 3
        np.testing.assert_allclose(bst.predict(Xt), want, rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the eval surface: C.27 and C.28
# ---------------------------------------------------------------------------
def _evals(train, p, X, y, Xv, yv, names):
    mod = jlgb if train is _jax_train else tlgb
    pp = p if train is _jax_train else {**p, "device_type": "cpu"}
    if train is _jax_train:
        compile_cache.clear_programs()
    dtr = mod.Dataset(X, label=y, params=pp)
    dv = mod.Dataset(Xv, label=yv, reference=dtr, params=pp)
    res = {}
    bst = mod.train(pp, dtr, num_boost_round=ROUNDS,
                    valid_sets=[dtr, dv], valid_names=names,
                    evals_result=res, verbose_eval=False)
    return bst, res


@pytest.mark.parametrize("names", [["train", "valid"], None])
def test_evals_result_names_and_values_match_jax(names):
    """C.27: with ``valid_names`` the train set's results carry its name
    (``booster.name_train_set`` too), without it "training"; the keys and
    the multi_logloss and multi_error values equal the JAX package's."""
    X, y = _data(3)
    Xv, yv = _data(3, n=700, seed=3)
    p = _params("multiclass", 3, tpu_grow_mode="leafwise",
                tpu_use_f64_hist=True,
                metric=["multi_logloss", "multi_error"])
    jb, jres = _evals(_jax_train, p, X, y, Xv, yv, names)
    tb, tres = _evals(_port_train, p, X, y, Xv, yv, names)
    assert list(tres) == list(jres)
    assert list(tres) == (names or ["training", "valid_1"])
    assert tb.name_train_set == (names[0] if names else "training")
    for d in jres:
        assert list(tres[d]) == list(jres[d])
        for m in jres[d]:
            np.testing.assert_allclose(tres[d][m], jres[d][m], rtol=1e-12)
    assert {d: list(v) for d, v in tb.best_score.items()} \
        == {d: list(v) for d, v in jb.best_score.items()}


def test_auc_is_the_jax_device_auc():
    """C.28: the eval path's AUC is the JAX package's f32 device AUC
    (integer counts a tie group, f32 products and an f32 sum; weighted,
    f32 sums). On the train and valid sets of a binary run (2,000 and
    700 rows) it equals the JAX package's values bit for bit; weighted,
    within 1e-6 relative (the JAX package's stated ~1e-6 form); the host
    f64 form stays for `eval` callers, 3e-8 away at most here."""
    X, y = _data(3)
    yb = (y == 0).astype(np.float64)
    Xv, yv = _data(3, n=700, seed=3)
    yvb = (yv == 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
         "verbosity": -1, "metric": "auc", "tpu_grow_mode": "leafwise",
         "tpu_use_f64_hist": True}
    _, jres = _evals(_jax_train, p, X, yb, Xv, yvb, ["train", "valid"])
    tb, tres = _evals(_port_train, p, X, yb, Xv, yvb, ["train", "valid"])
    for d in ("train", "valid"):
        assert tres[d]["auc"] == jres[d]["auc"]
    g = tb._gbdt
    host = g.valid_metrics[0][0].eval(g.valid_scores[0].numpy(), None)[0][1]
    assert abs(host - tres["valid"]["auc"][-1]) < 3e-8
    # weighted: f32 sums
    rng = np.random.RandomState(8)
    w = rng.uniform(0.2, 3.0, len(yvb)).astype(np.float32)
    score = rng.standard_normal((1, len(yvb))).astype(np.float32)
    jm = JM.AUCMetric(JConfig())
    tm = TM.AUCMetric(TConfig())
    for m, meta in ((jm, JMeta(len(yvb))), (tm, TMeta(len(yvb)))):
        meta.set_label(yvb)
        meta.weight = w
        m.init(meta, len(yvb))
    (_, jv), = jm.eval_dev(jnp.asarray(score), None)
    (_, tv), = tm.eval_dev(torch.tensor(score), None)
    np.testing.assert_allclose(tv, float(jv), rtol=1e-6)
