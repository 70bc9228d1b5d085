"""Sparse input and exclusive feature bundling (EFB) in the port, against
the JAX package on the CPU.

- The plan (`BundleInfo`) and the bundled bins equal the JAX package's,
  field for field and byte for byte, on three laws: one-hot blocks beside
  dense drivers (tests/test_efb.py), a ROADMAP C.24 table (4 normal and
  6 exclusive columns) and a small Allstate-law CSR (one-hot blocks of
  20-60 columns); `from_sparse` bins equal the JAX package's for CSR and
  CSC.
- The unpack (`ops/partition.bundle_unpack`, the twins' `unpack_bundle`)
  equals both of the JAX package's forms over the whole domain, and the
  bundled twins of B2 and B3 equal the Pallas kernels (interpret mode)
  on bundled records of real rounds.
- Oracle (i): the f64 leaf-wise tree sections are byte-equal to the JAX
  package's bundled run with its feature mask corrected in the test only
  (`jax_mask_fixed`: ``num_real_features`` set to the feature count, as
  C.5's patch replaces a missing function). Oracle (ii): the same run
  splits on the features and thresholds of the JAX package's
  ``enable_bundle=false`` run, gains and leaf values within 1e-4. Oracle
  (iii) pins C.24: unpatched, the JAX package never splits on a feature
  of index G or more; the port does.
- GOSS, bagging, softmax, lambdarank, forced splits, CEGB and quantized
  histograms on bundled data against the patched JAX package; the
  aligned engine bundled against the JAX aligned run without bundling
  (C.7's bound); valid sets share the training set's bundling; the
  gates; `predict` of a CSR matrix.

Every JAX run clears `compile_cache.clear_programs()` first (C.19)."""
import json

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache
from lightgbm_tpu.io.bundling import apply_bundles as j_apply
from lightgbm_tpu.models import device_learner as JDL
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu_torch.io import bundling as TB
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA
from lightgbm_tpu_torch.ops import partition as TP

LEAF = {"tpu_grow_mode": "leafwise", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "verbosity": -1, "tpu_use_f64_hist": True}
ROUNDS = 5


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture
def jax_mask_fixed(x64, monkeypatch):
    """The JAX learner with its feature mask over every feature of
    bundled data (ROADMAP C.24): ``num_real_features`` is the storage
    column count there, which masks every feature of index G or more."""
    orig = JDL.DeviceTreeLearner.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        if self.bundled:
            self.num_real_features = self.num_features
    monkeypatch.setattr(JDL.DeviceTreeLearner, "__init__", init)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _onehot_data(n=4000, f=60, dense=4, seed=3):
    """One-hot blocks of 8 (a row holds at most one of a block) beside
    dense drivers: tests/test_efb.py's law."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, f), np.float32)
    X[:, :dense] = rng.standard_normal((n, dense))
    j = dense
    while j < f:
        width = min(8, f - j)
        pick = rng.integers(0, width + 1, n)
        rows = np.arange(n)
        active = pick < width
        X[rows[active], j + pick[active]] = \
            rng.standard_normal(active.sum()) + 1.0
        j += width
    y = ((X[:, 0] + X[:, dense] * 0.5 + X[:, dense + 1]
          + 0.2 * rng.standard_normal(n)) > 0.3).astype(np.float32)
    return X, y


def _c24_data(n=3000, seed=0, regression=False):
    """ROADMAP C.24's table: 4 normal columns and 6 mutually exclusive
    ones (a row holds at most one), the label driven by two exclusive
    columns of index 6 and 8, which the unbundled run splits on."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 10))
    X[:, :4] = rng.standard_normal((n, 4))
    pick = rng.randint(0, 7, n)
    for j in range(6):
        m = pick == j
        X[m, 4 + j] = rng.standard_normal(m.sum()) + 2.0
    margin = X[:, 0] + 1.5 * (X[:, 8] > 0) - 1.2 * (X[:, 6] > 0) \
        + 0.3 * X[:, 9]
    if regression:
        return X, margin + 0.3 * rng.standard_normal(n)
    y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X, y


def _allstate_csr(n=6000, blocks=12, seed=0):
    """The Allstate law of tests/test_efb.py at a small size: one-hot
    blocks of 20-60 columns, one column of each set in every row."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 60, blocks)
    cols, off = [], 0
    for s in sizes:
        cols.append(off + rng.integers(0, s, n))
        off += s
    rows = np.tile(np.arange(n), blocks)
    Xs = sp.csr_matrix((np.ones(n * blocks, np.float32),
                        (rows, np.concatenate(cols))), shape=(n, off))
    y = (np.asarray(Xs[:, :25].sum(axis=1)).ravel() > 0).astype(np.float32)
    return Xs, y


LAWS = {"onehot": _onehot_data, "c24": _c24_data, "allstate": _allstate_csr}


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _jax_train(params, X, y, rounds=ROUNDS, **ds_kw):
    """The JAX package's booster after ``rounds`` updates (its live trees
    keep their inner features and bin thresholds)."""
    compile_cache.clear_programs()
    bst = jlgb.Booster(params=params, train_set=jlgb.Dataset(
        X, label=y, params=params, **ds_kw))
    for _ in range(rounds):
        bst.update()
    return bst


def _port_train(params, X, y, rounds=ROUNDS, **ds_kw):
    return tlgb.train({**params, "device_type": "cpu"},
                      tlgb.Dataset(X, label=y, **ds_kw),
                      num_boost_round=rounds, verbose_eval=False)


def _split_nodes(tree):
    k = tree.num_leaves - 1
    return (list(tree.split_feature_inner[:k]),
            list(tree.threshold_in_bin[:k]))


# ---------------------------------------------------------------------------
# the plan, the bins, sparse ingest
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("law", list(LAWS))
def test_bundle_plan_and_bins_match_jax(law):
    """The port bundles exactly when and as the JAX package does: its
    `BundleInfo` equals the JAX package's field for field, its bundled
    bins byte for byte, and `apply_bundles` on the device equals the
    numpy form on the unbundled bins."""
    X, y = LAWS[law]()
    params = {"objective": "binary", "max_bin": 63, "verbosity": -1}
    jd = jlgb.Dataset(X, label=y, params=params).construct()._handle
    td = tlgb.Dataset(X, label=y,
                      params={**params, "device_type": "cpu"}).construct() \
        ._handle
    ji, ti = jd.bundles, td.bundles
    assert ji is not None and ti is not None
    assert ti.num_groups == ji.num_groups
    for field in ("col", "off", "packed", "group_num_bin"):
        np.testing.assert_array_equal(getattr(ti, field), getattr(ji, field))
    np.testing.assert_array_equal(td.bins.numpy(), jd.bins)
    assert td.num_features == len(td.real_feature_idx) > ti.num_groups
    assert td.num_storage_cols == ti.num_groups
    # the device form against the numpy form, with conflicts: random bins
    rng = np.random.RandomState(1)
    nb = ti.group_num_bin
    used = td.real_feature_idx
    fnb = np.asarray([td.mappers[j].num_bin for j in used])
    db = np.asarray([td.mappers[j].default_bin for j in used], np.int32)
    raw = (rng.rand(500, len(used)) * fnb).astype(np.uint8)
    raw = np.where(rng.rand(*raw.shape) < 0.7, db[None, :], raw) \
        .astype(np.uint8)
    np.testing.assert_array_equal(
        TB.apply_bundles(torch.tensor(raw), ti, db).numpy(),
        j_apply(raw, ji, db))
    assert nb.max() <= 256


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("bundle", [True, False])
def test_from_sparse_bins_match_jax(fmt, bundle):
    """`from_sparse` bins, found from each column's nonzeros and scattered
    over its zero bin, equal the JAX package's byte for byte; a dense
    column with negative values (zero bin not 0) and explicit zeros in
    the matrix included."""
    Xs, y = _allstate_csr(n=3000, blocks=6, seed=2)
    rng = np.random.RandomState(3)
    dense = sp.csr_matrix(rng.standard_normal((3000, 2)) - 1.0)
    Xs = sp.hstack([dense, Xs]).tocsr()
    Xs.data[::97] = 0.0                       # stored zeros
    Xs = Xs.asformat(fmt)
    params = {"objective": "binary", "max_bin": 63, "verbosity": -1,
              "enable_bundle": bundle}
    jd = jlgb.Dataset(Xs, label=y, params=params).construct()._handle
    td = tlgb.Dataset(Xs, label=y,
                      params={**params, "device_type": "cpu"}).construct() \
        ._handle
    assert (td.bundles is None) == (jd.bundles is None) == (not bundle)
    np.testing.assert_array_equal(td.bins.numpy(), jd.bins)
    np.testing.assert_array_equal(td.real_feature_idx, jd.real_feature_idx)
    for a, b in zip(td.used_mappers(), jd.used_mappers()):
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)


def test_unpack_matches_jax_over_the_domain():
    """`bundle_unpack` and the twins' `unpack_bundle` equal the JAX
    package's `bundle_unpack` and the Pallas kernels' `_unpack_bundle`
    over every storage value and a grid of offsets, packings, default
    bins and bin counts (as tests/test_efb.py pins the JAX pair)."""
    import itertools
    raw = np.arange(256, dtype=np.int32)
    for boff, bpk, db, nb in itertools.product(
            (0, 1, 5, 40, 200, 255), (0, 1), (0, 2, 7, 62),
            (2, 5, 20, 63, 256)):
        r2 = TA.pack_route2(db, nb, boff, bpk)
        assert r2 == int(JA.pack_route2(db, nb, boff, bpk))
        ref = np.asarray(JP.bundle_unpack(jnp.asarray(raw), boff, bpk, db,
                                          nb))
        ref2 = np.asarray(JA._unpack_bundle(jnp.asarray(raw), jnp.int32(r2)))
        np.testing.assert_array_equal(ref, ref2)
        t = torch.tensor(raw)
        np.testing.assert_array_equal(
            TP.bundle_unpack(t, boff, bpk, db, nb).numpy(), ref)
        np.testing.assert_array_equal(
            TA.unpack_bundle(t, torch.tensor(r2, dtype=torch.int32)).numpy(),
            ref)


# ---------------------------------------------------------------------------
# B2 and B3 bundled: twins against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bundled_rounds():
    """The kernel calls of two trees of the port's aligned engine on
    bundled data (the twins on the CPU), STANDARD records (so the count
    pass runs), with their inputs."""
    X, y = _onehot_data(n=2500)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    params = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
              "verbosity": -1, "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": 256,
              "device_type": "cpu", "tpu_force_big_n": True}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("move_pass", "count_pass"):
            mp.setattr(AB, name, recorder(name, getattr(AB, name)))
        bst = tlgb.train(params, tlgb.Dataset(X, label=y),
                         num_boost_round=2, verbose_eval=False)
    eng = bst._gbdt._aligned_eng
    assert bst._gbdt.learner.bundled and eng.bits == 8
    return eng, calls


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def test_bundled_count_pass_plain_equals_pallas(bundled_rounds):
    """B3's bundled twin equals `count_pass(bundled=True)` in interpret
    mode, and differs from the unbundled route on the same records (the
    unpack changes what goes left)."""
    eng, calls = bundled_rounds
    counts = [c for c in calls if c[0] == "count_pass"]
    assert counts and all(kw.get("bundled") for _, _, kw in counts)
    differs = False
    for _, (rec, r1, r2, meta, wsel, ks, k, bits), kw in counts[:3]:
        got = TA.count_pass_plain(rec, r1, r2, meta, wsel, ks, k, bits,
                                  bundled=True)
        ref = JA.count_pass(jnp.asarray(rec.numpy()), *(
            jnp.asarray(_np(a)) for a in (r1, r2, meta, wsel, ks)),
            jnp.zeros((k + 1) * 8, jnp.int32), k, 256, bits=bits,
            bundled=True, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        plain = TA.count_pass_plain(rec, r1, r2, meta, wsel, ks, k, bits)
        differs |= not torch.equal(plain, got)
    assert differs


def _integer_gh(records, eng, seed):
    rec = records.clone()
    rng = np.random.RandomState(seed)
    shape = rec[:, 0].shape
    rec[:, eng.lanes["grad"]] = torch.tensor(
        rng.randint(-8, 9, shape).astype(np.float32)).view(torch.int32)
    rec[:, eng.lanes["hess"]] = torch.tensor(
        rng.randint(0, 5, shape).astype(np.float32)).view(torch.int32)
    return rec


def test_bundled_move_pass_plain_equals_pallas(bundled_rounds):
    """B2's bundled twin equals `move_pass(bundled=True)` in interpret
    mode: the records on every row the new layout covers, and the smaller
    children's histograms over the storage columns bit for bit (integer
    payloads)."""
    eng, calls = bundled_rounds
    moves = [c for c in calls if c[0] == "move_pass"]
    assert len(moves) >= 3 and all(kw.get("bundled") for _, _, kw in moves)
    for i, (_, args, kw) in enumerate((moves[0], moves[2])):
        (rec, r1, r2, bl, br, meta, wsel, hs, k, G, BH, wcnt, bits,
         w_used, grad) = args
        rec = _integer_gh(rec, eng, seed=i)
        args = (rec,) + args[1:]
        got_rec, got_hist = TA.move_pass_plain(*args, bundled=True)
        ref_rec, ref_hist = JA.move_pass(
            jnp.asarray(rec.numpy()),
            *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
            jnp.zeros((k + 1) * 8, jnp.int32), 256, rec.shape[1], wcnt, k,
            G, BH, 4, bits=bits, w_used=w_used, bundled=True,
            interpret=True, subbin=BH > 128)
        outs = [TA.move_pass_plain(*args, out=torch.full_like(rec, fill),
                                   bundled=True)[0][:, 0]
                for fill in (-1, -2)]
        cov = (outs[0] == outs[1]).numpy()
        got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
        for u in range(w_used):
            np.testing.assert_array_equal(got_np[:, u][cov],
                                          ref_np[:, u][cov])
        np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))


# ---------------------------------------------------------------------------
# the oracle: C.24
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("law", ["c24", "onehot"])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_leafwise_f64_matches_jax_mask_fixed(jax_mask_fixed, law,
                                             objective):
    """Oracle (i): the f64 leaf-wise tree sections are byte-equal to the
    JAX package's bundled run with its feature mask corrected (the
    FixHistogram step summed in XLA's order, its count rounded)."""
    if law == "c24":
        X, y = _c24_data(regression=objective == "regression")
    else:
        X, y = _onehot_data()
        if objective == "regression":
            y = X[:, 0] + 2.0 * X[:, 5] - X[:, 9]
    params = {**LEAF, "objective": objective}
    jb = _jax_train(params, X, y)
    tb = _port_train(params, X, y)
    assert tb._gbdt.learner.bundled and jb._gbdt.learner.bundled
    assert tb._gbdt.train_path == "leafwise"
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


@pytest.mark.parametrize("law", ["c24", "onehot"])
def test_bundling_loses_nothing(x64, law):
    """Oracle (ii): the port's bundled f64 run splits on the features
    and thresholds of the JAX package's enable_bundle=false run, its
    gains and leaf values within 1e-4 relative (the rebuilt default bins
    are the leaf's f32 totals less the other bins)."""
    X, y = _c24_data() if law == "c24" else _onehot_data()
    params = {**LEAF, "objective": "binary"}
    jb = _jax_train({**params, "enable_bundle": False}, X, y)
    tb = _port_train(params, X, y)
    assert tb._gbdt.learner.bundled
    assert not jb._gbdt.learner.bundled
    assert len(jb.trees) == len(tb.trees)
    for a, b in zip(jb.trees, tb.trees):
        assert _split_nodes(a) == _split_nodes(b)
        k = b.num_leaves - 1
        np.testing.assert_allclose(b.split_gain[:k], a.split_gain[:k],
                                   rtol=1e-4)
        np.testing.assert_allclose(b.leaf_value[:k + 1],
                                   a.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-7)


def test_c24_jax_masks_features_past_g(x64):
    """Oracle (iii), ROADMAP C.24: unpatched, the JAX package's bundled
    trees split only on features of index below G (its mask counts the
    storage columns); the port's tree 0 splits on a feature of index G or
    more, one the unbundled run also chooses."""
    X, y = _c24_data()
    params = {**LEAF, "objective": "binary"}
    jb = _jax_train(params, X, y)
    ju = _jax_train({**params, "enable_bundle": False}, X, y)
    tb = _port_train(params, X, y)
    G = tb._gbdt.learner.num_storage_cols
    assert G == 6 and tb._gbdt.learner.num_features == 10
    j_feats = set().union(*(_split_nodes(t)[0] for t in jb.trees))
    assert max(j_feats) < G
    t_feats = set(_split_nodes(tb.trees[0])[0])
    u_feats = set(_split_nodes(ju.trees[0])[0])
    high = {f for f in t_feats if f >= G}
    assert high and high <= u_feats


# ---------------------------------------------------------------------------
# the options that take bundled data
# ---------------------------------------------------------------------------
VARIANTS = {
    "goss": {"boosting": "goss", "learning_rate": 0.3},
    "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1,
                "feature_fraction": 0.7},
    "softmax": {"objective": "multiclass", "num_class": 3},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_jax_mask_fixed(jax_mask_fixed, variant):
    """GOSS, bagging with feature_fraction (drawn over every feature) and
    softmax K = 3 on bundled data: f64 tree sections byte-equal to the
    patched JAX package."""
    X, y = _onehot_data()
    if variant == "softmax":
        y = np.digitize(X[:, 0] + X[:, 4] - X[:, 12], [-0.5, 0.5]) \
            .astype(np.float64)
    params = {"objective": "binary", **LEAF, **VARIANTS[variant]}
    jb = _jax_train(params, X, y)
    tb = _port_train(params, X, y)
    assert tb._gbdt.learner.bundled
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def _forced_file(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({
        "feature": 6, "threshold": 0.5,
        "left": {"feature": 0, "threshold": 0.1},
        "right": {"feature": 8, "threshold": 1.0}}))
    return str(path)


@pytest.mark.parametrize("option", ["forced", "cegb", "quant8", "quant16"])
def test_sequential_options_match_jax_mask_fixed(jax_mask_fixed, tmp_path,
                                                 option):
    """Forced splits (on bundled features), the CEGB split and coupled
    penalties (f64), and quantized histograms (int8, int16; the integer
    sums expanded after the scale) on bundled data against the patched
    JAX package, as their earlier tests hold them: tree sections
    byte-equal, but at int16, whose integer sums pass 2^24 at 3,000 rows
    (the JAX package's f32 sums round there, the port's are exact): the
    same splits, leaf values within rtol 1e-4, atol 1e-6
    (tests/test_torch_quant.py::test_int16_large_leaves_within_tolerance)."""
    X, y = _c24_data()
    extra = {
        "forced": {"forcedsplits_filename": _forced_file(tmp_path)},
        "cegb": {"cegb_penalty_split": 0.1, "cegb_tradeoff": 0.7,
                 "cegb_penalty_feature_coupled":
                     [0.5, 1.0, 3.0, 0.2, 0.1, 2.0, 0.7, 0.3, 1.5, 0.9]},
        "quant8": {"tpu_quant_hist": "on", "tpu_quant_hist_bits": 8,
                   "tpu_use_f64_hist": False, "min_data_in_leaf": 5},
        "quant16": {"tpu_quant_hist": "on", "tpu_quant_hist_bits": 16,
                    "tpu_use_f64_hist": False, "min_data_in_leaf": 5},
    }[option]
    params = {**LEAF, "objective": "binary", **extra}
    jb = _jax_train(params, X, y)
    tb = _port_train(params, X, y)
    lr = tb._gbdt.learner
    assert lr.bundled and tb._gbdt.train_path == "leafwise"
    if option.startswith("quant"):
        assert lr.quant_bits == jb._gbdt.learner.quant_bits > 0
    if option == "quant16":
        assert len(jb.trees) == len(tb.trees)
        for a, b in zip(jb.trees, tb.trees):
            assert _split_nodes(a) == _split_nodes(b)
            k = b.num_leaves - 1
            np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                       b.leaf_value[:k + 1], rtol=1e-4,
                                       atol=1e-6)
        return
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_lambdarank_matches_jax_mask_fixed(jax_mask_fixed):
    """Lambdarank on bundled data, leaf-wise: the JAX package's trees, leaf
    values within rtol 1e-4 (its gradients differ from the port's only in
    f32 summation order, as in tests/test_torch_rank.py)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(5, 60, 60)
    n = int(counts.sum())
    X, _ = _onehot_data(n=n, f=36, seed=5)
    s = X[:, 0] + X[:, 4] - X[:, 13] + 0.5 * rng.standard_normal(n)
    y = np.zeros(n)
    pos = 0
    for c in counts:
        r = s[pos:pos + c].argsort().argsort() / max(c - 1, 1)
        y[pos:pos + c] = np.digitize(r, [0.55, 0.75, 0.9, 0.97])
        pos += c
    params = {**LEAF, "objective": "lambdarank", "num_leaves": 8,
              "min_data_in_leaf": 5, "tpu_use_f64_hist": False,
              "metric": "none"}
    jb = _jax_train(params, X, y, rounds=4, group=counts)
    tb = _port_train(params, X, y, rounds=4, group=counts)
    assert tb._gbdt.learner.bundled
    assert len(jb.trees) == len(tb.trees)
    for a, b in zip(jb.trees, tb.trees):
        assert _split_nodes(a) == _split_nodes(b)
        k = b.num_leaves - 1
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)


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


@pytest.mark.parametrize("force_big_n", [False, True])
def test_aligned_bundled_matches_jax_aligned_unbundled(force_big_n):
    """The aligned engine on bundled records (B2's and B3's bundled twins,
    B4 over the storage columns) against the JAX aligned run without
    bundling (Pallas in interpret mode): its trees within C.7's bound,
    no fallback, every kernel call bundled."""
    X, y = _onehot_data(n=2500)
    params = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "metric": "none", "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": 256,
              "tpu_force_big_n": force_big_n}
    jt = _jax_train({**params, "enable_bundle": False}, X, y,
                    rounds=4).trees
    seen = []
    orig = AB.move_pass

    def spy(*args, **kw):
        seen.append(kw.get("bundled"))
        return orig(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AB, "move_pass", spy)
        tb = _port_train(params, X, y, rounds=4)
    g = tb._gbdt
    assert g.train_path == "aligned" and g.learner.bundled
    assert g._aligned_eng.fallbacks == 0 and g._aligned_eng.big_n == \
        force_big_n
    assert seen and all(seen)
    _same_trees(jt, tb.trees)


def test_valid_set_shares_bundling_and_evals(x64, jax_mask_fixed):
    """A valid set built with ``reference=`` takes the training set's
    bundling, and its recorded metrics equal the JAX package's."""
    X, y = _c24_data(n=4000)
    params = {**LEAF, "objective": "binary",
              "metric": ["auc", "binary_logloss"]}
    res = {}
    for pkg in (jlgb, tlgb):
        p = params if pkg is jlgb else {**params, "device_type": "cpu"}
        tr = pkg.Dataset(X[:3000], label=y[:3000])
        va = tr.create_valid(X[3000:], label=y[3000:])
        if pkg is jlgb:
            compile_cache.clear_programs()
        evals = {}
        bst = pkg.train(p, tr, num_boost_round=ROUNDS, valid_sets=[va],
                        evals_result=evals, verbose_eval=False)
        res[pkg] = (bst, evals, va)
    tva = res[tlgb][2]._handle
    assert tva.bundles is res[tlgb][0]._gbdt.train_data.bundles
    assert tva.num_storage_cols == 6
    assert {k: dict(v) for k, v in res[tlgb][1].items()} == \
        {k: dict(v) for k, v in res[jlgb][1].items()}


@pytest.mark.parametrize("case", ["dart", "rf", "categorical", "l1",
                                  "off", "level"])
def test_gates(x64, case):
    """No bundling for DART, RF, a categorical column, an objective that
    renews leaf outputs or enable_bundle=false, as in the JAX package;
    ``tpu_grow_mode=level`` grows bundled trees leaf-wise."""
    X, y = _c24_data()
    params = {"objective": "binary", "max_bin": 63, "verbosity": -1}
    extra = {"dart": {"boosting": "dart"},
             "rf": {"boosting": "rf", "bagging_fraction": 0.8,
                    "bagging_freq": 1},
             "categorical": {"categorical_feature": "1"},
             "l1": {"objective": "regression_l1"},
             "off": {"enable_bundle": False},
             "level": {"tpu_grow_mode": "level"}}[case]
    p = {**params, **extra}
    Xc = X.copy()
    if case == "categorical":
        Xc[:, 1] = np.abs(np.round(Xc[:, 1] * 2))
    jd = jlgb.Dataset(Xc, label=y, params=p).construct()._handle
    td = tlgb.Dataset(Xc, label=y, params={**p, "device_type": "cpu"}) \
        .construct()._handle
    assert (td.bundles is None) == (jd.bundles is None)
    if case != "level":
        assert td.bundles is None
        return
    assert td.bundles is not None
    tb = _port_train({**LEAF, **p}, Xc, y, rounds=2)
    assert tb._gbdt.train_path == "leafwise" and not tb._gbdt.level_stats
    assert not tb._gbdt.learner.level_mode_ok()


def test_predict_csr_equals_dense():
    """`Booster.predict` of a CSR matrix (densified by row blocks) equals
    `predict` of the dense matrix, raw and transformed, and the model
    trained from the CSR matrix predicts as the one from its dense
    form."""
    Xs, y = _allstate_csr(n=4000, blocks=8, seed=4)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "device_type": "cpu"}
    tb = tlgb.train(params, tlgb.Dataset(Xs, label=y), num_boost_round=4,
                    verbose_eval=False)
    td = tlgb.train(params, tlgb.Dataset(Xs.toarray(), label=y),
                    num_boost_round=4, verbose_eval=False)
    assert tb._gbdt.learner.bundled
    assert tb.model_to_string() == td.model_to_string()
    dense = Xs.toarray()
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(Xs, raw_score=raw),
                                      tb.predict(dense, raw_score=raw))
    np.testing.assert_array_equal(tb.predict(Xs.tocsc()[:7]),
                                  tb.predict(dense[:7]))
