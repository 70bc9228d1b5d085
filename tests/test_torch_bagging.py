"""Bagging in the port against the JAX package on the CPU: plain and
pos/neg balanced bags drawn alike, the leaf-wise trees byte for byte in
f64, the level builder's bagged iterations grown leaf-wise, the aligned
engine's bag (COMPACT's meta bit, STANDARD's and EXT's f32 lane) through
its kernels' twins, the twins' bag branch against the Pallas kernels in
interpret mode, `set_bag`, and a bagged aligned fallback."""
import types

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import aligned_builder as JAB
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA

N, N_TEST, F, CHUNK, ROUNDS = 4000, 2000, 6, 256, 6
PARAMS = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "none", "tpu_chunk": CHUNK, "bagging_seed": 11}
BAGS = {"plain1": {"bagging_fraction": 0.7, "bagging_freq": 1},
        "plain2": {"bagging_fraction": 0.7, "bagging_freq": 2},
        "balanced": {"pos_bagging_fraction": 0.6,
                     "neg_bagging_fraction": 0.8, "bagging_freq": 1}}


def _data():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((N + N_TEST, F))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    margin = z[:, 0] - 0.8 * z[:, 1] * z[:, 2] + 0.5 * np.sin(2 * z[:, 3])
    y = (rng.rand(len(X)) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X[:N], y[:N], X[N:], y[N:]


def _rank_data():
    rng = np.random.default_rng(2)
    counts = rng.integers(10, 80, 60)
    n = int(counts.sum())
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = np.minimum((X[:, 0] + rng.standard_normal(n) > 0.5) * 2
                   + (X[:, 1] > 1.0), 4).astype(np.float32)
    return X, y, counts


def _auc(y, score):
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y > 0
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) \
        / (pos.sum() * (~pos).sum())


def _port(X, y, mode, rounds=ROUNDS, group=None, **extra):
    p = {**PARAMS, "tpu_grow_mode": mode, "device_type": "cpu",
         "tpu_aligned_interpret": mode == "aligned", **extra}
    return tlgb.train(p, tlgb.Dataset(X, label=y, group=group),
                      num_boost_round=rounds, verbose_eval=False)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's bagged leaf-wise runs (f64 histograms, and one at
    default precision), and a bagged lambdarank run."""
    Xtr, ytr, Xte, yte = _data()
    Xr, yr, gr = _rank_data()
    out = {"data": (Xtr, ytr, Xte, yte), "rank": (Xr, yr, gr)}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's f64 mode enters `jax.experimental.enable_x64()`,
        # which JAX 0.9 removed; give it the replacement
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        for name, bag in BAGS.items():
            p = {**PARAMS, **bag, "tpu_grow_mode": "leafwise",
                 "tpu_use_f64_hist": True}
            out[name] = jlgb.train(p, jlgb.Dataset(Xtr, label=ytr),
                                   num_boost_round=ROUNDS, verbose_eval=False)
        out["f32"] = jlgb.train(
            {**PARAMS, **BAGS["plain1"], "tpu_grow_mode": "leafwise"},
            jlgb.Dataset(Xtr, label=ytr), num_boost_round=ROUNDS,
            verbose_eval=False)
        p = {**PARAMS, **BAGS["plain1"], "objective": "lambdarank",
             "min_data_in_leaf": 10, "tpu_grow_mode": "leafwise",
             "tpu_use_f64_hist": True}
        out["rank_jax"] = jlgb.train(p, jlgb.Dataset(Xr, label=yr, group=gr),
                                     num_boost_round=4, verbose_eval=False)
    return out


def _tree_sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


def _same_trees(ref, got, rtol=1e-4, atol=1e-6):
    """Equal features and thresholds, leaf values within rtol / atol and
    leaf counts equal (the JAX package's relation between its aligned
    and leaf-wise bagged trees)."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        k = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.threshold_in_bin[:k]) == list(b.threshold_in_bin[:k])
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        np.testing.assert_allclose(b.leaf_value[:k + 1],
                                   a.leaf_value[:k + 1], rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("bag", list(BAGS))
def test_leafwise_f64_trees_byte_equal(runs, bag):
    """tpu_use_f64_hist: the port draws the JAX package's bags, so the
    tree sections of the model text are its own byte for byte."""
    Xtr, ytr, Xte, _ = runs["data"]
    tb = _port(Xtr, ytr, "leafwise", tpu_use_f64_hist=True, **BAGS[bag])
    assert tb._gbdt.train_path == "leafwise"
    assert tb._gbdt.bag_data_indices is not None
    assert _tree_sections(tb) == _tree_sections(runs[bag])
    np.testing.assert_allclose(tb.predict(Xte, raw_score=True),
                               runs[bag].predict(Xte, raw_score=True),
                               rtol=1e-5, atol=1e-7)


def test_bag_draw_is_the_jax_packages(runs):
    """The bag of each iteration: the in-bag counts of the root equal the
    JAX package's, and the balanced bag keeps each class's fraction."""
    Xtr, ytr, _, _ = runs["data"]
    for bag in BAGS:
        tb = _port(Xtr, ytr, "leafwise", rounds=1, tpu_use_f64_hist=True,
                   **BAGS[bag])
        g = tb._gbdt
        idx = g.bag_data_indices.numpy()
        assert g.bag_data_cnt == len(idx)
        assert np.all(np.diff(idx) > 0)
        mine, root = tb.trees[0], runs[bag].trees[0]
        assert mine.leaf_count[:mine.num_leaves].sum() == g.bag_data_cnt \
            == root.leaf_count[:root.num_leaves].sum()
    pos = ytr[idx] > 0
    assert abs(pos.sum() / (ytr > 0).sum() - 0.6) < 0.05
    assert abs((~pos).sum() / (ytr <= 0).sum() - 0.8) < 0.05


def test_default_precision_auc_matches(runs):
    """f32 histograms: predictions within 2e-3 and holdout AUC within
    2e-3 of the JAX package's."""
    Xtr, ytr, Xte, yte = runs["data"]
    tb = _port(Xtr, ytr, "leafwise", metric="auc", **BAGS["plain1"])
    jb = runs["f32"]
    np.testing.assert_allclose(tb.predict(Xte), jb.predict(Xte), atol=2e-3)
    a_t, a_j = _auc(yte, tb.predict(Xte)), _auc(yte, jb.predict(Xte))
    assert a_t > 0.65
    assert abs(a_t - a_j) < 2e-3


@pytest.mark.parametrize("bag", ["plain1", "balanced"])
def test_level_mode_bagged_iterations_grow_leafwise(runs, bag):
    """tpu_grow_mode=level: every bagged iteration grows leaf-wise, the
    JAX package's trees (level_builder.py:40)."""
    Xtr, ytr, _, _ = runs["data"]
    tb = _port(Xtr, ytr, "level", tpu_use_f64_hist=True, **BAGS[bag])
    assert tb._gbdt.train_path == "leafwise"
    assert tb._gbdt.level_stats == []
    assert _tree_sections(tb) == _tree_sections(runs[bag])


@pytest.mark.parametrize("layout,bag", [("compact", "plain2"),
                                        ("compact", "balanced"),
                                        ("standard", "plain1")])
def test_aligned_bagged_matches_jax_leafwise(runs, layout, bag):
    """The aligned engine through its twins, bag lane and the count pass
    driving the layout: the JAX package's bagged leaf-wise trees (f64
    histograms, the exact sums) with equal features, thresholds and leaf
    counts, leaf values within rtol 1e-4."""
    Xtr, ytr, _, _ = runs["data"]
    tb = _port(Xtr, ytr, "aligned", tpu_force_big_n=layout == "standard",
               **BAGS[bag])
    g = tb._gbdt
    eng = g._aligned_eng
    assert g.train_path == "aligned" and eng.bagged
    assert eng.compact == (layout == "compact")
    assert eng.bag_lane == (-2 if layout == "compact" else eng.lanes["bag"])
    assert all(exact for _, _, exact in g.aligned_stats)
    _same_trees(runs[bag].trees, tb.trees)
    # every row scored, in the bag or not
    g._sync_train_score()
    np.testing.assert_allclose(g.train_score.score[0].numpy(),
                               tb.predict(Xtr, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_aligned_bagged_lambdarank_ext(runs):
    """A bagged lambdarank run on EXT records (the f32 bag lane times the
    gathered gradients): the JAX package's bagged leaf-wise trees."""
    Xr, yr, gr = runs["rank"]
    tb = _port(Xr, yr, "aligned", rounds=4, group=gr,
               objective="lambdarank", min_data_in_leaf=10,
               **BAGS["plain1"])
    eng = tb._gbdt._aligned_eng
    assert eng.ext and eng.bag_lane == eng.lanes["bag"]
    _same_trees(runs["rank_jax"].trees, tb.trees)


def test_bagged_aligned_fallback_uses_its_rounds_bag():
    """A speculation budget of 1.2 x num_leaves leaves some trees inexact:
    each grows leaf-wise on the bag its own round drew, so every tree is
    the bagged leaf-wise run's."""
    Xtr, ytr, _, _ = _data()
    tight = _port(Xtr, ytr, "aligned", tpu_level_spec=1.2,
                  **BAGS["plain1"])
    exact = [e for _, _, e in tight._gbdt.aligned_stats]
    assert not all(exact) and any(exact)
    assert tight._gbdt._aligned_eng.fallbacks == exact.count(False)
    _same_trees(_port(Xtr, ytr, "leafwise", **BAGS["plain1"]).trees,
                tight.trees, atol=1e-5)


# ---------------------------------------------------------------------------
# the twins' bag branch and set_bag against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["compact", "standard"])
def bag_rounds(request):
    """The kernel calls of two bagged trees of the port's aligned engine
    (through the twins), with their inputs."""
    Xtr, ytr, _, _ = _data()
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for name in ("move_pass", "count_pass", "slot_hist_pass"):
            mp.setattr(AB, name, recorder(name, getattr(AB, name)))
        bst = _port(Xtr, ytr, "aligned", rounds=2,
                    tpu_force_big_n=request.param == "standard",
                    **BAGS["plain1"])
    return request.param, bst._gbdt._aligned_eng, calls


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _jax_binary_grad(score, label, weight):
    sl = jnp.where(label > 0, 1.0, -1.0)
    response = -sl * 1.0 / (1.0 + jnp.exp(sl * 1.0 * score))
    absr = jnp.abs(response)
    return response * 1.0, absr * (1.0 - absr) * 1.0


def _integer_gh(rec, eng, seed):
    """STANDARD records with integer grad/hess lanes (the bf16 hi/lo split
    of the Pallas kernels is exact there), the out-of-bag rows' too."""
    rec = rec.clone()
    rng = np.random.RandomState(seed)
    shape = rec[:, 0].shape
    rec[:, eng.lanes["grad"]] = torch.tensor(
        rng.randint(-8, 9, shape).astype(np.float32)).view(torch.int32)
    rec[:, eng.lanes["hess"]] = torch.tensor(
        rng.randint(0, 5, shape).astype(np.float32)).view(torch.int32)
    return rec


def _check_hist(layout, got, ref):
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    if layout == "standard":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


def test_bag_kernels_take_the_bag(bag_rounds):
    """Every histogram call of a bagged engine takes its bag lane (-2 for
    COMPACT, the f32 lane for STANDARD), and the count pass drives the
    layout on COMPACT records too."""
    layout, eng, calls = bag_rounds
    want = -2 if layout == "compact" else eng.lanes["bag"]
    hist_calls = [kw for name, _, kw in calls if name != "count_pass"]
    assert hist_calls and all(kw["bag_lane"] == want for kw in hist_calls)
    assert any(name == "count_pass" for name, _, _ in calls)


def test_slot_hist_plain_bag_equals_pallas(bag_rounds):
    """The root pass of the first bagged tree: the twin against the
    Pallas kernel in interpret mode with the same bag_lane; the records'
    out-of-bag rows add nothing (the counts are the bag's)."""
    layout, eng, calls = bag_rounds
    _, args, kw = next(c for c in calls if c[0] == "slot_hist_pass")
    rec, slots, meta, k, F_, B, wcnt, bits, grad = args
    if layout == "standard":
        rec = _integer_gh(rec, eng, seed=3)
    got = TA.slot_hist_pass_plain(rec, slots, meta, k, F_, B, wcnt, bits,
                                  grad, bag_lane=kw["bag_lane"]).numpy()
    ref = np.asarray(JA.slot_hist_pass(
        jnp.asarray(rec.numpy()), jnp.asarray(slots.numpy()),
        jnp.asarray(meta.numpy()), k, F_, B, CHUNK, 8, wcnt,
        bag_lane=kw["bag_lane"], bits=bits,
        grad_fn=_jax_binary_grad if grad is not None else None,
        interpret=True))
    _check_hist(layout, got, ref)
    assert got[0, 0, :, 2].sum() == int(0.7 * N)


def test_move_pass_plain_bag_equals_pallas(bag_rounds):
    """A bagged round's move: records equal on the rows the new layout
    covers (the bag bit and lane moving with their rows); the smaller
    children's histograms of the in-bag rows as the Pallas kernel's."""
    layout, eng, calls = bag_rounds
    _, args, kw = [c for c in calls if c[0] == "move_pass"][1]
    (rec, r1, r2, bl, br, meta, wsel, hs, k, F_, B, wcnt, bits, w_used,
     grad) = args
    if layout == "standard":
        rec = _integer_gh(rec, eng, seed=1)
    args = (rec,) + args[1:]
    bag_lane = kw["bag_lane"]
    got_rec, got_hist = TA.move_pass_plain(*args, bag_lane=bag_lane)
    ref_rec, ref_hist = JA.move_pass(
        jnp.asarray(rec.numpy()),
        *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
        jnp.zeros((k + 1) * 8, jnp.int32), CHUNK, rec.shape[1], wcnt, k,
        F_, B, 8, bag_lane=bag_lane, bits=bits,
        grad_fn=_jax_binary_grad if grad is not None else None,
        w_used=w_used, interpret=True)
    outs = [TA.move_pass_plain(*args, out=torch.full_like(rec, fill),
                               bag_lane=bag_lane)[0][:, 0]
            for fill in (-1, -2)]
    cov = (outs[0] == outs[1]).numpy()
    got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
    for u in range(w_used):
        np.testing.assert_array_equal(got_np[:, u][cov], ref_np[:, u][cov])
    _check_hist(layout, got_hist.numpy(), np.asarray(ref_hist))
    # the bag travels: as many in-bag rows after the move as before
    assert (wcnt + 1 if layout == "compact" else bag_lane) < w_used
    before = TA._in_bag(rec, wcnt, bag_lane) & TA._valid_rows(meta, CHUNK)
    moved = TA._in_bag(got_rec, wcnt, bag_lane)[torch.tensor(cov)]
    assert int(before.sum()) == int(moved.sum()) == int(0.7 * N)


def test_count_pass_plain_counts_physical_rows(bag_rounds):
    """Under bagging the count pass counts every row, in the bag or not:
    the twin equals the Pallas kernel, on COMPACT records too."""
    layout, eng, calls = bag_rounds
    counts = [c for c in calls if c[0] == "count_pass"]
    for _, (rec, r1, r2, meta, wsel, ks, k, bits), kw in counts[:2]:
        got = TA.count_pass_plain(rec, r1, r2, meta, wsel, ks, k, bits)
        ref = JA.count_pass(jnp.asarray(rec.numpy()), *(
            jnp.asarray(_np(a)) for a in (r1, r2, meta, wsel, ks)),
            jnp.zeros((k + 1) * 8, jnp.int32), k, CHUNK, bits=bits,
            interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_set_bag_equals_jax(bag_rounds):
    """`set_bag` on the engine's permuted records (after two trees)
    against the JAX package's `AlignedEngine.set_bag` program."""
    layout, eng, _ = bag_rounds
    rng = np.random.RandomState(5)
    mask = (rng.rand(eng.n) < 0.5).astype(np.float32)
    before = eng.rec.clone()
    fn = JAB.AlignedEngine._set_bag_program(types.SimpleNamespace(
        lanes=eng.lanes, n=eng.n, compact=eng.compact))
    ref = np.asarray(fn(jnp.asarray(before.numpy()), jnp.asarray(mask)))
    eng.set_bag(mask)
    np.testing.assert_array_equal(eng.rec.numpy(), ref)
    lane = eng.lanes["meta" if eng.compact else "bag"]
    changed = (eng.rec != before).any(dim=(0, 2)).nonzero()[:, 0].tolist()
    assert changed in ([], [lane])
