"""The port's ranking path on the CPU against the JAX package: the
lambdarank gradient's plain twin (`ops/rank.py`) against the JAX
package's bucketed path and its fused Pallas kernel in interpret mode,
the NDCG metric, leaf-wise and aligned (EXT records) lambdarank training,
the row-floor gate, and a JAX-trained ranking model in the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.ops.metrics import NDCGMetric as JNDCG
from lightgbm_tpu.ops.objectives import LambdarankNDCG as JLambdarank
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import from_reference
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.ops import rank as TR
from lightgbm_tpu_torch.ops.metrics import NDCGMetric
from lightgbm_tpu_torch.ops.objectives import LambdarankNDCG
from lightgbm_tpu_torch.utils import log

GAINS = [float((1 << i) - 1) for i in range(31)]
# the query lengths of tests/test_rank_fused.py::test_fused_parity
LENGTHS = [(0, [1, 7, 40, 130, 200, 300, 520, 3, 64, 128, 129]),
           (1, [17] * 23),
           (2, [1, 1, 2, 257, 511, 512, 5])]


def _boundaries(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


class _Meta:
    """The metadata an objective reads, for both packages."""

    def __init__(self, qb, labels, weight=None):
        self.query_boundaries = qb
        self.label = np.asarray(labels, np.float64)
        self.weight = weight


def _jax_grads(qb, labels, score, weight=None, **cfg_keys):
    cfg = JConfig()
    cfg.objective = "lambdarank"
    cfg.label_gain = list(GAINS)
    for k, v in cfg_keys.items():
        setattr(cfg, k, v)
    obj = JLambdarank(cfg)
    obj.init(_Meta(qb, labels, weight), int(qb[-1]))
    g, h = obj.get_gradients(jnp.asarray(score, jnp.float32)[None, :])
    return np.asarray(g[0]), np.asarray(h[0])


def _port_grads(qb, labels, score, weight=None, **params):
    obj = LambdarankNDCG(Config.from_params({"objective": "lambdarank",
                                             "device_type": "cpu",
                                             **params}))
    obj.init(_Meta(qb, labels, weight), int(qb[-1]))
    g, h = obj.get_gradients(torch.tensor(score)[None, :])
    return g[0].numpy(), h[0].numpy()


def _inputs(counts, seed, ties=False):
    rng = np.random.default_rng(seed)
    qb = _boundaries(counts)
    n = int(qb[-1])
    labels = rng.integers(0, 5, n)
    score = rng.normal(size=n).astype(np.float32)
    if ties:      # runs of equal scores: ranks by position
        score[1::2] = score[::2][:len(score[1::2])]
    return qb, labels, score


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,counts", LENGTHS)
def test_plain_matches_jax_bucketed(seed, counts, weighted):
    """The twin rounds to bf16 where the JAX package's bucketed path does:
    within 1e-6 x max|g| (f32 summation order is the only difference)."""
    qb, labels, score = _inputs(counts, seed, ties=seed == 0)
    w = (np.random.default_rng(seed + 9).uniform(0.5, 2.0, len(score))
         .astype(np.float32) if weighted else None)
    g0, h0 = _jax_grads(qb, labels, score, w, tpu_rank_fused="off")
    g1, h1 = _port_grads(qb, labels, score, w)
    np.testing.assert_allclose(g1, g0, rtol=0, atol=1e-6 * np.abs(g0).max())
    np.testing.assert_allclose(h1, h0, rtol=0, atol=1e-6 * np.abs(h0).max())


@pytest.mark.parametrize("seed,counts", LENGTHS)
def test_plain_matches_jax_fused_interpret(seed, counts):
    """Against the fused Pallas kernel in interpret mode (tile 128; longer
    queries take the JAX package's bucketed fallback), at the JAX
    package's own fused-vs-bucketed tolerance."""
    qb, labels, score = _inputs(counts, seed)
    g0, h0 = _jax_grads(qb, labels, score, tpu_rank_fused="on",
                        tpu_rank_tile=128)
    g1, h1 = _port_grads(qb, labels, score, tpu_rank_fused="on",
                         tpu_rank_tile=128)
    np.testing.assert_allclose(g1, g0, rtol=1e-5,
                               atol=1e-4 * max(1.0, np.abs(g0).max()))
    np.testing.assert_allclose(h1, h0, rtol=1e-5,
                               atol=1e-4 * max(1.0, np.abs(h0).max()))


@pytest.mark.parametrize("lut_bins", [64, 1024])
def test_sigmoid_table_matches_jax_fused(lut_bins):
    """tpu_rank_sigmoid_bins: the reference's quantized sigmoid, which the
    JAX package applies in its fused kernel (queries within one tile
    here), at the fused kernel's tolerance; it changes the gradients."""
    qb, labels, score = _inputs([3, 50, 128, 90, 17, 1, 64], 4)
    score = score * 4.0           # spread the inputs over many cells
    g0, h0 = _jax_grads(qb, labels, score, tpu_rank_fused="on",
                        tpu_rank_tile=128, tpu_rank_sigmoid_bins=lut_bins)
    g1, h1 = _port_grads(qb, labels, score, tpu_rank_fused="on",
                         tpu_rank_tile=128, tpu_rank_sigmoid_bins=lut_bins)
    np.testing.assert_allclose(g1, g0, rtol=1e-5,
                               atol=1e-4 * max(1.0, np.abs(g0).max()))
    np.testing.assert_allclose(h1, h0, rtol=1e-5,
                               atol=1e-4 * max(1.0, np.abs(h0).max()))
    exact = _port_grads(qb, labels, score)[0]
    assert np.abs(exact - g1).max() > 1e-3 * np.abs(exact).max()


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
def test_sigmoid_table_only_where_jax_applies_it(mode):
    """tpu_rank_sigmoid_bins 1024 with a 300-document query among short
    ones. Under off, and under auto on the CPU, the JAX package computes
    the exact sigmoid (its bucketed path): the port matches it within
    1e-6 x max|g| and equals its own run without the table. Under on
    with tile 128 the JAX fused kernel tables the queries of at most 128
    documents and its bucketed path takes the 300: the port matches at
    the fused tolerance, and its gradients on the 300 documents are the
    table-free run's bit for bit."""
    counts = [3, 50, 128, 90, 17, 1, 64, 300]
    qb, labels, score = _inputs(counts, 4)
    score = score * 4.0
    keys = {"tpu_rank_fused": mode, "tpu_rank_sigmoid_bins": 1024}
    if mode == "on":
        keys["tpu_rank_tile"] = 128
    g0, h0 = _jax_grads(qb, labels, score, **keys)
    g1, h1 = _port_grads(qb, labels, score, **keys)
    ge, he = _port_grads(qb, labels, score, tpu_rank_fused=mode)
    if mode == "on":
        np.testing.assert_allclose(g1, g0, rtol=1e-5,
                                   atol=1e-4 * max(1.0, np.abs(g0).max()))
        np.testing.assert_allclose(h1, h0, rtol=1e-5,
                                   atol=1e-4 * max(1.0, np.abs(h0).max()))
        long_q = slice(int(qb[-2]), int(qb[-1]))
        assert np.array_equal(g1[long_q], ge[long_q])
        assert np.array_equal(h1[long_q], he[long_q])
        assert np.abs(g1 - ge).max() > 1e-3 * np.abs(ge).max()
    else:
        np.testing.assert_allclose(g1, g0, rtol=0,
                                   atol=1e-6 * np.abs(g0).max())
        np.testing.assert_allclose(h1, h0, rtol=0,
                                   atol=1e-6 * np.abs(h0).max())
        assert np.array_equal(g1, ge) and np.array_equal(h1, he)


@pytest.mark.parametrize("keys,device,want", [
    ({"tpu_rank_fused": "on", "tpu_rank_tile": 128}, "cpu", 128),
    ({"tpu_rank_fused": "on", "tpu_rank_tile": 100}, "cpu", 128),
    ({"tpu_rank_fused": "on", "tpu_rank_tile": 513}, "cpu", 640),
    ({"tpu_rank_fused": "auto"}, "cpu", 0),
    ({"tpu_rank_fused": "auto"}, "cuda", 512),
    ({"tpu_rank_fused": "off"}, "cuda", 0),
    ({"tpu_rank_fused": "on", "tpu_rank_sigmoid_bins": 0}, "cuda", 0),
])
def test_tabled_length_resolves_as_jax_fused_mode(keys, device, want):
    """The longest tabled query: the JAX package's fused-mode resolution
    (on; auto iff the accelerator, here the card, is attached; off), its
    tile rounded up to a multiple of 128, 0 without the table."""
    params = {"objective": "lambdarank", "device_type": "cpu",
              "tpu_rank_sigmoid_bins": 1024, **keys}
    obj = LambdarankNDCG(Config.from_params(params))
    assert obj._tabled_length(torch.device(device)) == want


def test_degenerate_queries_have_zero_gradients():
    """Single-document queries, queries with one label throughout, and a
    query whose scores all tie (no normalisation, ranks by position)."""
    counts = [1, 6, 1, 9]
    qb = _boundaries(counts)
    labels = np.array([3] + [2] * 6 + [0] + [0, 1, 2, 3, 4, 0, 1, 2, 3])
    score = np.linspace(-1, 1, qb[-1]).astype(np.float32)
    score[8:] = 0.25
    g1, h1 = _port_grads(qb, labels, score)
    assert not g1[:8].any() and not h1[:8].any()
    g0, h0 = _jax_grads(qb, labels, score, tpu_rank_fused="off")
    np.testing.assert_allclose(g1, g0, rtol=0, atol=1e-6 * np.abs(g0).max())
    np.testing.assert_allclose(h1, h0, rtol=0, atol=1e-6 * np.abs(h0).max())


def test_wrapper_takes_the_twin_on_cpu():
    qb, labels, score = _inputs([5, 70, 200], 3)
    args = (torch.tensor(score), torch.tensor(qb, dtype=torch.int32),
            torch.tensor(labels, dtype=torch.int32),
            torch.tensor(np.asarray(GAINS, np.float32)[labels]),
            torch.rand(3), torch.rand(200), 1.0)
    TR.reset_launches()
    g, h = TR.lambdarank_grad(*args)
    gp, hp = TR.lambdarank_grad_plain(*args)
    assert torch.equal(g, gp) and torch.equal(h, hp)
    assert TR.LAUNCHES == {"lambdarank_grad": 0}
    blocks = TR.query_blocks(qb)
    assert blocks.tolist() == [[0, 0], [1, 0], [1, 64], [2, 0], [2, 64],
                               [2, 128], [2, 192]]


def test_ndcg_metric_matches_jax():
    qb, labels, score = _inputs([1, 7, 40, 130, 3, 64], 5)
    labels[:1] = 0                    # a query with max DCG 0 counts 1
    vals = {}
    for pkg, (cfg, meta, metric) in {
            "jax": (JConfig(), JMetadata(int(qb[-1])), JNDCG),
            "port": (Config(), Metadata(int(qb[-1])), NDCGMetric)}.items():
        cfg.eval_at = [1, 3, 10]
        cfg.label_gain = list(GAINS)
        meta.set_label(labels.astype(np.float64))
        meta.set_group(np.diff(qb))
        m = metric(cfg)
        m.init(meta, int(qb[-1]))
        vals[pkg] = m.eval(score[None, :].astype(np.float64), None)
    assert [k for k, _ in vals["port"]] == ["ndcg@1", "ndcg@3", "ndcg@10"]
    assert vals["port"] == vals["jax"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
ITERS = 4


def _rank_data(nq=60, f=8, seed=0):
    """MSLR-like: queries of 5-60 documents, labels 0-4 by within-query
    quantile of a noisy signal."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(5, 60, nq)
    n = int(counts.sum())
    X = rng.standard_normal((n, f)).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.standard_normal(n)
    y = np.zeros(n)
    pos = 0
    for c in counts:
        r = s[pos:pos + c].argsort().argsort() / max(c - 1, 1)
        y[pos:pos + c] = np.digitize(r, [0.55, 0.75, 0.9, 0.97])
        pos += c
    return X, y, counts


def _params(mode, **extra):
    return {"objective": "lambdarank", "num_leaves": 8, "max_bin": 63,
            "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
            "tpu_chunk": 128, "tpu_grow_mode": mode,
            "tpu_aligned_interpret": mode == "aligned", **extra}


def _port(X, y, g, mode, **extra):
    return tlgb.train({**_params(mode, **extra), "device_type": "cpu"},
                      tlgb.Dataset(X, label=y, group=g),
                      num_boost_round=ITERS, verbose_eval=False)


def _jax(X, y, g, mode):
    """The JAX package's run (aligned: Pallas in interpret mode, about 10
    s); returns (booster, [(rounds, n_exec)] of its aligned trees)."""
    params = _params(mode)
    ds = jlgb.Dataset(X, label=y, group=g, params=params).construct()
    bst = jlgb.Booster(params=params, train_set=ds)
    for _ in range(ITERS):
        bst.update()
    gb = bst._gbdt
    stats = [(int(m.record.rounds), int(m.record.n_exec))
             for m in gb.models] if mode == "aligned" else []
    gb.materialized_models()
    return bst, stats


@pytest.fixture(scope="module")
def runs():
    X, y, g = _rank_data()
    out = {"data": (X, y, g)}
    for mode in ("leafwise", "aligned"):
        out[("jax", mode)] = _jax(X, y, g, mode)
        out[("port", mode)] = _port(X, y, g, mode)
    return out


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


def test_leafwise_matches_jax_leafwise(runs):
    """Equal structure and leaf values within rtol 1e-4: the gradients
    differ from the JAX package's only in f32 summation order."""
    jb, _ = runs[("jax", "leafwise")]
    tb = runs[("port", "leafwise")]
    assert tb._gbdt.train_path == "leafwise"
    _same_trees(jb._gbdt.models, tb.trees)
    X = runs["data"][0]
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)


def test_aligned_ext_matches_jax_aligned(runs):
    """EXT records on the aligned engine (the twins of B2 and B4, the
    gradients gathered by rid): per tree the JAX aligned run's rounds and
    executed splits, and its trees."""
    jb, jstats = runs[("jax", "aligned")]
    tb = runs[("port", "aligned")]
    g = tb._gbdt
    assert g.train_path == "aligned" and g._aligned_eng.ext
    assert g._aligned_eng.lanes == {"score": g._aligned_eng.wcnt,
                                    "grad": g._aligned_eng.wcnt + 1,
                                    "hess": g._aligned_eng.wcnt + 2,
                                    "rid": g._aligned_eng.wcnt + 3}
    assert all(exact for _, _, exact in g.aligned_stats)
    assert [(r, e) for r, e, _ in g.aligned_stats] == jstats
    _same_trees(jb._gbdt.models, tb.trees)


def test_aligned_ext_matches_port_leafwise(runs):
    _same_trees(runs[("port", "leafwise")].trees,
                runs[("port", "aligned")].trees)
    g = runs[("port", "aligned")]._gbdt
    g._sync_train_score()
    X = runs["data"][0]
    np.testing.assert_allclose(
        g.train_score.score[0].numpy(),
        runs[("port", "aligned")].predict(X, raw_score=True), rtol=1e-5,
        atol=1e-6)


def test_valid_set_ndcg_per_round(runs):
    """metric=ndcg with eval_at on a validation set made by create_valid
    with its own groups: the port's per-round values equal the JAX
    package's over the same trees."""
    X, y, g = runs["data"]
    half = int(np.cumsum(g)[len(g) // 2 - 1])
    params = {**_params("leafwise"), "metric": "ndcg", "eval_at": [1, 5]}
    res = {}
    for pkg, lib in (("port", tlgb), ("jax", jlgb)):
        p = {**params, "device_type": "cpu"} if pkg == "port" else params
        tr = lib.Dataset(X[:half], label=y[:half], group=g[:len(g) // 2],
                         params=p)
        va = tr.create_valid(X[half:], label=y[half:],
                             group=g[len(g) // 2:])
        ev = {}
        lib.train(p, tr, num_boost_round=3, valid_sets=[va],
                  valid_names=["va"], evals_result=ev, verbose_eval=False)
        res[pkg] = ev["va"]
    assert list(res["port"]) == ["ndcg@1", "ndcg@5"]
    for k in res["port"]:
        np.testing.assert_allclose(res["port"][k], res["jax"][k], rtol=1e-9)
    assert res["port"]["ndcg@5"][-1] > res["port"]["ndcg@5"][0]


def test_auto_below_row_floor_trains_leafwise(runs):
    """Under auto, lambdarank below 1M rows goes leaf-wise, and the log
    names the row floor (the aligned engine's twins are allowed here, so
    that gate is the first to fail)."""
    X, y, g = runs["data"]
    lines = []
    log.register_callback(lines.append)
    try:
        bst = _port(X, y, g, "auto", tpu_aligned_interpret=True,
                    verbosity=1)
    finally:
        log.register_callback(None)
    assert bst._gbdt.train_path == "leafwise"
    assert any("non-pointwise objective below the row floor" in ln
               and "1000000" in ln for ln in lines)


def test_jax_model_text_predicts_the_same_in_the_port(runs):
    """A lambdarank model trained by the JAX package carries into the port
    as model text and scores the same raw values."""
    jb, _ = runs[("jax", "leafwise")]
    X = runs["data"][0]
    text = jb.model_to_string()
    assert "objective=lambdarank" in text
    port = from_reference(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port.predict(X), port.predict(
        X, raw_score=True))
