"""Categorical splits in the port against the JAX package on the CPU: the
split finder's one-hot and CTR-sorted scans bit for bit, f64 model text
byte for byte on the leaf-wise and level builders, the aligned engine
(its B2/B3 twins against the Pallas kernels in interpret mode) within
float noise with the same rounds, executed splits and bitset words, and
model text that round-trips."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA
from lightgbm_tpu_torch.ops import split as tsplit

FINDER_KEYS = ("gain", "threshold", "default_left", "left_c", "right_c",
               "left_g", "left_h", "right_g", "right_h", "left_output",
               "right_output", "is_cat", "cat_bitset", "cat_dir", "n_elig",
               "use_onehot", "sort_order")


# ---------------------------------------------------------------------------
# the split finder
# ---------------------------------------------------------------------------
def _finder_case(case):
    """(meta, B, [K, F, B, 3] histograms, params) of one finder case:
    categorical features of 3 to B bins beside numerical ones."""
    rng = np.random.RandomState(len(case) * 7 + sum(map(ord, case)))
    B, K = 63, 3
    nbs = [B, B, 3, 4, 12, B, 40, 7]
    cats = [0, 1, 1, 1, 1, 1, 0, 1]
    mts = [0, 2, 0, 2, 0, 0, 1, 2]          # a NaN bin where mt is 2
    params = {}
    if case == "onehot":
        params = {"max_cat_to_onehot": 64, "min_data_in_leaf": 3}
    elif case == "smooth_ties":
        params = {"cat_smooth": 1.0, "min_data_per_group": 5}
    elif case == "group_binds":
        params = {"min_data_per_group": 50, "cat_smooth": 2.0}
    elif case == "threshold_1":
        params = {"max_cat_threshold": 1, "cat_smooth": 1.0}
    elif case == "regularized":
        params = {"lambda_l1": 0.5, "lambda_l2": 1.0, "cat_l2": 3.0,
                  "max_delta_step": 0.8, "min_gain_to_split": 0.2}
    elif case == "wide":                    # past the 256-bin bitset
        B, K = 300, 1
        nbs = [B, 300, 3, 4, 12, 260, 40, 7]
    elif case == "one_leaf":
        K = 1
    cnt = rng.poisson(6, (K, 8, B)).astype(np.float32)
    cnt[rng.rand(K, 8, B) < 0.15] = 0
    cnt[..., np.arange(B)[None, :] >= np.array(nbs)[:, None]] = 0
    g = (rng.standard_normal((K, 8, B)) * cnt * 0.3).astype(np.float32)
    h = (cnt * rng.uniform(0.1, 0.25, (K, 8, B))).astype(np.float32)
    if case == "smooth_ties":
        # equal ratios g / (h + cat_smooth) across bins: the stable sort
        # keeps them in bin order
        h = np.where(cnt > 0, np.float32(1.0), 0).astype(np.float32)
        g = (np.round(rng.standard_normal((K, 8, B))) * 2).astype(
            np.float32) * (cnt > 0)
    meta = dict(num_bin=np.array(nbs, np.int32),
                default_bin=np.zeros(8, np.int32),
                missing_type=np.array(mts, np.int32),
                bin_type=np.array(cats, np.int32),
                monotone=np.zeros(8, np.int32),
                penalty=np.ones(8, np.float32))
    return meta, B, np.stack([g, h, cnt], -1), params


FINDER_CASES = ["default", "onehot", "smooth_ties", "group_binds",
                "threshold_1", "regularized", "wide", "one_leaf"]


@pytest.fixture(scope="module")
def finder_runs():
    """Every finder case through both finders: (port outputs, [JAX outputs
    per leaf])."""
    out = {}
    for case in FINDER_CASES:
        meta, B, hists, params = _finder_case(case)
        cfg = Config.from_params({**params, "device_type": "cpu"})
        jf = jsplit.make_split_finder(jsplit.SplitHyper.from_config(cfg),
                                      meta, B)
        tf = tsplit.make_split_finder(tsplit.SplitHyper.from_config(cfg),
                                      meta, B)
        k = hists.shape[0]
        sg = hists[:, 0, :, 0].sum(1)
        sh = hists[:, 0, :, 1].sum(1)
        n = hists[:, 0, :, 2].sum(1).astype(np.int32)
        to = tf(torch.tensor(hists), torch.tensor(sg), torch.tensor(sh),
                torch.tensor(n), torch.full((k,), -np.inf),
                torch.full((k,), np.inf))
        jo = [jax.device_get(jf(jnp.asarray(hists[i]), jnp.float32(sg[i]),
                                jnp.float32(sh[i]), jnp.int32(n[i]),
                                jnp.float32(-np.inf), jnp.float32(np.inf)))
              for i in range(k)]
        out[case] = (to, jo)
    return out


@pytest.mark.parametrize("case", FINDER_CASES)
def test_finder_matches_jax(finder_runs, case):
    """Every output of every leaf equals the JAX finder's bit for bit."""
    to, jo = finder_runs[case]
    for i, ref in enumerate(jo):
        for key in FINDER_KEYS:
            want = np.asarray(ref[key])
            if key == "cat_bitset":
                want = want.astype(np.int64)
            np.testing.assert_array_equal(to[key][i].numpy(), want,
                                          err_msg=f"{case} leaf {i} {key}")


def test_finder_cases_reach_every_path(finder_runs):
    """The cases take the one-hot path, the sorted path's forward and
    backward winners, a bitset with bits past the first word, and at
    more than 256 bins no bin from 256 on."""
    dirs, onehot, high_word = set(), False, False
    for case, (to, _) in finder_runs.items():
        cat = to["is_cat"][0]
        fin = torch.isfinite(to["gain"]) & cat
        dirs |= set(to["cat_dir"][fin & ~to["use_onehot"]].tolist())
        onehot |= bool((fin & to["use_onehot"]).any())
        high_word |= bool((to["cat_bitset"][..., 1:][fin] != 0).any())
        if case == "wide":
            assert to["n_elig"][0, 1] > 0
            assert bool((to["cat_bitset"][fin][:, 8:] == 0).all())
    assert dirs == {-1, 1} and onehot and high_word


def test_group_and_threshold_bind(finder_runs):
    """`min_data_per_group` and `max_cat_threshold` change the winners
    the default parameters choose on the same histograms."""
    meta, B, hists, _ = _finder_case("group_binds")
    k = hists.shape[0]
    args = (torch.tensor(hists), torch.tensor(hists[:, 0, :, 0].sum(1)),
            torch.tensor(hists[:, 0, :, 1].sum(1)),
            torch.tensor(hists[:, 0, :, 2].sum(1).astype(np.int32)),
            torch.full((k,), -np.inf), torch.full((k,), np.inf))
    outs = {}
    for name, p in (("loose", {"cat_smooth": 2.0, "min_data_per_group": 1}),
                    ("group", {"cat_smooth": 2.0, "min_data_per_group": 50}),
                    ("thr1", {"cat_smooth": 2.0, "min_data_per_group": 1,
                              "max_cat_threshold": 1})):
        cfg = Config.from_params({**p, "device_type": "cpu"})
        outs[name] = tsplit.make_split_finder(
            tsplit.SplitHyper.from_config(cfg), meta, B)(*args)
    for name in ("group", "thr1"):
        assert not torch.equal(outs[name]["cat_bitset"],
                               outs["loose"]["cat_bitset"])
    bits = outs["thr1"]["cat_bitset"]
    ones = sum(((bits >> s) & 1).sum(-1) for s in range(32))
    srt = outs["thr1"]["is_cat"] & ~outs["thr1"]["use_onehot"] \
        & torch.isfinite(outs["thr1"]["gain"])
    assert bool((ones[srt] == 1).all())


# ---------------------------------------------------------------------------
# whole runs: leaf-wise and level f64, byte-equal
# ---------------------------------------------------------------------------
def _cat_data(n=4000, seed=0, ncat=12, nbig=40):
    """Three categorical columns (12 codes, 40 Zipf-skewed codes with NaN,
    3 codes) beside two numerical ones; random effects per code."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 5))
    X[:, 0] = rng.randint(0, ncat, n)
    X[:, 1] = rng.zipf(1.5, n) % nbig
    X[:, 2] = rng.randint(0, 3, n)
    X[rng.rand(n) < 0.03, 1] = np.nan
    e0, e1 = rng.standard_normal(ncat), rng.standard_normal(nbig)
    m = (e0[X[:, 0].astype(int)] + e1[np.nan_to_num(X[:, 1]).astype(int)]
         + X[:, 3] + 0.5 * (X[:, 2] == 1))
    y = (rng.rand(n) < 1 / (1 + np.exp(-m))).astype(np.float64)
    return X, y


def _sections(booster):
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
        "verbosity": -1, "metric": "none", "tpu_use_f64_hist": True,
        "categorical_feature": "0,1,2"}
F64_CASES = {
    "leafwise_63": {"tpu_grow_mode": "leafwise", "max_bin": 63},
    "leafwise_15": {"tpu_grow_mode": "leafwise", "max_bin": 15},
    "leafwise_255_weights_l1l2": {
        "tpu_grow_mode": "leafwise", "max_bin": 255, "lambda_l1": 0.3,
        "lambda_l2": 2.0, "cat_l2": 1.0, "cat_smooth": 1.0,
        "min_data_per_group": 10, "max_cat_to_onehot": 8},
    "level_15": {"tpu_grow_mode": "level", "max_bin": 15,
                 "max_cat_to_onehot": 13},
}


@pytest.fixture(scope="module")
def f64_runs():
    X, y = _cat_data(3000)
    w = np.random.RandomState(5).uniform(0.5, 2.0, len(y))
    out = {"data": (X, y)}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's f64 mode enters `jax.experimental.enable_x64()`,
        # which JAX 0.9 removed (ROADMAP C.5); give it the replacement
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        for name, extra in F64_CASES.items():
            p = {**BASE, **extra}
            wt = w if "weights" in name else None
            jb = jlgb.train(p, jlgb.Dataset(X, label=y, weight=wt, params=p),
                            num_boost_round=4)
            tb = tlgb.train({**p, "device_type": "cpu"},
                            tlgb.Dataset(X, label=y, weight=wt),
                            num_boost_round=4, verbose_eval=False)
            out[name] = (jb, tb)
    return out


@pytest.mark.parametrize("name", list(F64_CASES))
def test_f64_tree_sections_match_jax(f64_runs, name):
    """tpu_use_f64_hist: the tree sections of the model text are the JAX
    package's byte for byte, with categorical nodes (decision type 1) in
    them, at 15 bins and above (the root search's contraction, ROADMAP
    C.26), with weights and L1/L2, on the level builder too (its
    categorical case at 63 bins is
    tests/test_torch_level.py::test_level_matches_leafwise)."""
    jb, tb = f64_runs[name]
    assert tb._gbdt.train_path == F64_CASES[name]["tpu_grow_mode"]
    assert _sections(tb) == _sections(jb)
    assert sum(t.num_cat for t in tb.trees) > 0


def test_model_text_round_trips(f64_runs):
    """The whole model text equals the JAX package's but for the device
    line; it loads both ways and predicts the same, raw values of the
    categorical columns (NaN among them) included."""
    X, _ = f64_runs["data"]
    jb, tb = f64_runs["leafwise_63"]
    text = tb.model_to_string()
    assert text.replace("[device_type: cpu]\n", "") == \
        jb.model_to_string().replace("[device_type: tpu]\n", "")
    back = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X), tb.predict(X))
    np.testing.assert_array_equal(
        jlgb.Booster(model_str=text).predict(X, raw_score=True),
        tb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


def test_valid_set_scores_by_bitset():
    """A validation set's scores come from traversing each new tree over
    its bins, a categorical node by its bitset: the final validation
    score is the model's raw prediction."""
    X, y = _cat_data(3000, seed=3)
    Xv, yv = _cat_data(1000, seed=4)
    p = {**BASE, "tpu_grow_mode": "leafwise", "max_bin": 63,
         "device_type": "cpu"}
    ds = tlgb.Dataset(X, label=y)
    bst = tlgb.train(p, ds, num_boost_round=4, verbose_eval=False,
                     valid_sets=[tlgb.Dataset(Xv, label=yv, reference=ds)])
    assert sum(t.num_cat for t in bst.trees) > 0
    np.testing.assert_allclose(bst._gbdt.valid_scores[0].score[0].numpy(),
                               bst.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the aligned engine: the port's twins against the JAX interpret run
# ---------------------------------------------------------------------------
def _aligned_params(mode, **extra):
    return {"objective": "binary", "num_leaves": 8, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
            "metric": "none", "tpu_grow_mode": mode,
            "tpu_aligned_interpret": mode == "aligned", "tpu_chunk": 256,
            "categorical_feature": "0", "max_cat_to_onehot": 1,
            "cat_smooth": 1.0, "min_data_per_group": 5, **extra}


def _aligned_data():
    """tests/test_aligned.py::test_aligned_categorical_matches_leafwise's
    data: a 12-code categorical column beside 4 numerical ones."""
    rng = np.random.default_rng(9)
    n = 3000
    Xc = rng.integers(0, 12, n).astype(np.float32)
    Xn = rng.standard_normal((n, 4)).astype(np.float32)
    X = np.column_stack([Xc, Xn])
    y = ((np.isin(Xc, [1, 3, 7]) * 1.0 + Xn[:, 0]
          + 0.3 * rng.standard_normal(n)) > 0.5).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def aligned_runs():
    """The JAX aligned run in interpret mode and the port's aligned runs
    (COMPACT, and STANDARD with the count pass), the port's kernel calls
    recorded."""
    X, y = _aligned_data()
    p = _aligned_params("aligned")
    ds = jlgb.Dataset(X, label=y, params=p).construct()
    jb = jlgb.Booster(params=p, train_set=ds)
    for _ in range(4):
        jb.update()
    g = jb._gbdt
    stats = [(int(m.record.rounds), int(m.record.n_exec)) for m in g.models]
    g.materialized_models()
    out = {"jax": (jb, stats)}
    for layout in ("compact", "standard"):
        calls = []

        def recorder(name, fn):
            def wrapped(*args, **kw):
                calls.append((name, args, kw))
                return fn(*args, **kw)
            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            for name in ("move_pass", "count_pass"):
                mp.setattr(AB, name, recorder(name, getattr(AB, name)))
            tb = tlgb.train({**_aligned_params(
                "aligned", tpu_force_big_n=layout == "standard"),
                "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                num_boost_round=4, verbose_eval=False)
        out[layout] = (tb, calls)
    return out


@pytest.mark.parametrize("layout", ["compact", "standard"])
def test_aligned_matches_jax_aligned(aligned_runs, layout):
    """The same rounds and executed splits per tree, the same features,
    decision types and bitset words (outer and inner), leaf values
    within rtol=1e-4."""
    jb, jstats = aligned_runs["jax"]
    tb, _ = aligned_runs[layout]
    g = tb._gbdt
    assert g.train_path == "aligned"
    assert all(exact for _, _, exact in g.aligned_stats)
    assert [(r, e) for r, e, _ in g.aligned_stats] == jstats
    assert len(jb._gbdt.models) == len(tb.trees)
    for a, b in zip(jb._gbdt.models, tb.trees):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        assert list(a.decision_type[:k]) == list(b.decision_type[:k])
        assert a.cat_threshold == b.cat_threshold
        assert a.cat_threshold_inner == b.cat_threshold_inner
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)
    assert sum(t.num_cat for t in tb.trees) > 0


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _covered(args, kw):
    """[NC, C] rows a move writes: the twin run into two fills."""
    outs = [TA.move_pass_plain(*args, out=torch.full_like(args[0], fill),
                               **kw)[0][:, 0] for fill in (-1, -2)]
    return (outs[0] == outs[1]).numpy()


def test_count_pass_plain_equals_pallas(aligned_runs):
    """The count pass twin with the round's bitset table against the
    Pallas kernel in interpret mode: equal counts on every categorical
    round."""
    _, calls = aligned_runs["standard"]
    counts = [(a, kw) for name, a, kw in calls if name == "count_pass"
              and bool(((a[1] >> TA.R_CAT) & 1).any())]
    assert counts
    for (rec, r1, r2, meta, wsel, ks, k, bits), kw in counts[:3]:
        cbits = kw["cbits"]
        got = TA.count_pass_plain(rec, r1, r2, meta, wsel, ks, k, bits,
                                  cbits)
        ref = JA.count_pass(jnp.asarray(rec.numpy()), *(
            jnp.asarray(_np(a)) for a in (r1, r2, meta, wsel, ks)),
            jnp.asarray(cbits.numpy()), k, 256, bits=bits, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["compact", "standard"])
def test_move_pass_plain_equals_pallas(aligned_runs, layout):
    """The move twin with the bitset table against the Pallas kernel in
    interpret mode on the categorical rounds: records equal on the rows
    the new layout covers, the children's counts equal (their g/h as in
    tests/test_torch_aligned_ops.py: within rtol=2e-4)."""
    _, calls = aligned_runs[layout]
    moves = [(a, kw) for name, a, kw in calls if name == "move_pass"
             and bool(((a[1] >> TA.R_CAT) & 1).any())]
    assert moves
    for args, kw in moves[-1:]:
        (rec, r1, r2, bl, br, meta, wsel, hs, k, F_, B, wcnt, bits,
         w_used, grad) = args
        kw = {"cbits": kw["cbits"], "gh_off": kw["gh_off"]}
        got_rec, got_hist = TA.move_pass_plain(*args, **kw)
        jgrad = None
        if grad is not None:
            def jgrad(score, label, weight):
                sl = jnp.where(label > 0, 1.0, -1.0)
                resp = -sl / (1.0 + jnp.exp(sl * score))
                absr = jnp.abs(resp)
                return resp, absr * (1.0 - absr)
        ref_rec, ref_hist = JA.move_pass(
            jnp.asarray(rec.numpy()),
            *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
            jnp.asarray(kw["cbits"].numpy()), 256, rec.shape[1], wcnt, k,
            F_, B, 8, bits=bits, grad_fn=jgrad, w_used=w_used,
            interpret=True)
        cov = _covered(args, kw)
        got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
        for u in range(w_used):
            np.testing.assert_array_equal(got_np[:, u][cov], ref_np[:, u][cov])
        ref_hist = np.asarray(ref_hist)
        np.testing.assert_array_equal(got_hist.numpy()[..., 2],
                                      ref_hist[..., 2])
        np.testing.assert_allclose(got_hist.numpy(), ref_hist, rtol=2e-4,
                                   atol=1e-3)


def test_bitset_helpers_match_jax():
    """`construct_bitset` and `find_in_bitset` of the port's tree are the
    JAX package's: the same words, the same membership, negative and
    out-of-range values absent."""
    from lightgbm_tpu.models import tree as jtree
    from lightgbm_tpu_torch.models import tree as ttree
    rng = np.random.default_rng(1)
    for values in ([], [0], [31, 32], list(rng.choice(300, 40, False))):
        words = ttree.construct_bitset(values)
        np.testing.assert_array_equal(words, jtree.construct_bitset(values))
        for v in (-1, 0, 1, 31, 32, 63, 64, 299, 300, 1000):
            assert ttree.find_in_bitset(words, v) == \
                jtree.find_in_bitset(words, v) == (v in values)


def test_goes_left_routes_by_bitset_only():
    """A categorical chunk goes left iff its bin's bit is set, whatever
    its missing type and default side; a copy chunk sends every row
    left; a numerical chunk ignores the word; `cat_word` reads word
    binv >> 5 of the chunk's row of the table."""
    binv = torch.arange(256, dtype=torch.int32)[None, :].expand(4, -1)
    rng = np.random.default_rng(3)
    cbits = torch.tensor(rng.integers(-2**31, 2**31 - 1, 16,
                                      dtype=np.int64).astype(np.int32))
    ks = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    r1 = torch.tensor([(1 << TA.R_CAT) | (1 << TA.R_DL) | (2 << TA.R_MT),
                       1 << TA.R_CAT, 100,
                       (1 << TA.R_CAT) | (1 << TA.R_COPY)],
                      dtype=torch.int32)[:, None]
    r2 = torch.full((4, 1), TA.pack_route2(0, 256), dtype=torch.int32)
    catw = TA.cat_word(cbits, ks[:, None], binv)
    left = TA.goes_left(binv, r1, r2, torch.ones_like(binv, dtype=torch.bool),
                        catw)
    words = cbits.numpy().astype(np.int64) & 0xFFFFFFFF
    for c in (0, 1):
        want = [(int(words[8 * c + b // 32]) >> (b % 32)) & 1
                for b in range(256)]
        assert left[c].int().tolist() == want
    assert left[2].tolist() == [b <= 100 for b in range(256)]
    assert bool(left[3].all())
