"""uint16 bins (a feature of more than 256 bins) through the port on the
CPU, against the JAX package: the binned matrix (dense and sparse) and
its dtype, B1's uint16 twin against the JAX CPU histogram (f64 equal,
f32 within C.4's rtol, integer payloads equal), C.32 (the Pallas kernel
casts its bins to uint8, so bins of 256 or more wrap there), the
partition and the binned traversal over bins past the int16 range, the
uint16 route's launch arithmetic, and the f64 tree sections byte-equal
on the leaf-wise and host learners at ``max_bin`` 511, with a
categorical column of ~300 codes and with int8 quantized histograms.
`auto` leaves the aligned engine with the JAX package's reason, "bins
not uint8"."""
import warnings

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
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import dataset as jds
from lightgbm_tpu.ops.histogram import \
    histogram_from_gathered_gh as jax_hist
from lightgbm_tpu.ops.pallas_hist import pallas_histogram
from lightgbm_tpu.ops.predict import TreePredictor
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.ops import bins as B
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops.partition import split_partition
from lightgbm_tpu_torch.ops.predict import predict_binned_leaves

BASE = {"num_leaves": 15, "max_bin": 511, "learning_rate": 0.1,
        "min_data_in_bin": 1, "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _data(n=3000, seed=0, cat=False):
    """n x 6, 5% missing; with ``cat`` column 5 holds ~300 codes."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 6))
    X[rng.rand(*X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X)
    y = z[:, 0] - 0.5 * z[:, 1] * z[:, 2] + 0.2 * rng.standard_normal(n)
    if cat:
        X[:, 5] = rng.randint(0, 300, n)
        y = y + 1.5 * (X[:, 5] % 7 == 0) - 1.0 * (X[:, 5] % 11 == 0)
    return X, y


def _hist_inputs(n, f, max_bin, seed, payload="f32"):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint16)
    if payload == "f32":
        gh = np.stack([rng.standard_normal(n),
                       rng.uniform(0.01, 0.25, n)], 1).astype(np.float32)
    else:
        top = 127 if payload == "i8" else 32767
        gh = rng.randint(-top, top + 1, (n, 2)).astype(
            np.int8 if payload == "i8" else np.int16)
    valid = rng.rand(n) < 0.7
    return bins, gh, valid


def _twin(bins, gh, valid, max_bin, precision):
    return H.histogram_from_gathered_gh(
        torch.from_numpy(bins.view(np.int16)).view(torch.uint16),
        torch.tensor(gh), torch.tensor(valid), max_bin, precision).numpy()


@pytest.mark.parametrize("payload", ["f64", "f32", "i8", "i16"])
@pytest.mark.parametrize("max_bin", [511, 1023])
def test_uint16_twin_matches_jax_histogram(x64, max_bin, payload):
    """B1's twin on uint16 bins against the JAX CPU
    `histogram_from_gathered_gh`: f64 equal; f32 counts equal, sums
    within C.4's rtol; integer payloads (exact sums rounded once) equal
    to the f64 path's rounding."""
    kind = "f32" if payload in ("f64", "f32") else payload
    bins, gh, valid = _hist_inputs(4000, 5, max_bin, 1, kind)
    prec = "f64" if payload == "f64" else "f32"
    got = _twin(bins, gh, valid, max_bin, prec)
    ref = np.asarray(jax_hist(jnp.asarray(bins.astype(np.int32)),
                              jnp.asarray(gh.astype(np.float32)),
                              jnp.asarray(valid), max_bin,
                              precision="f64"))
    assert got.shape == (5, max_bin, 3)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    if payload == "f64":
        np.testing.assert_array_equal(got, ref)
    elif payload == "f32":
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_c32_pallas_wraps_wide_bins():
    """C.32: the Pallas kernel casts its bins to uint8, so a row of bin
    256 or more lands 256 bins lower there; the JAX CPU histogram and the
    port's twin keep every bin."""
    bins, gh, valid = _hist_inputs(600, 3, 511, 2)
    bins[:, 0] = np.where(np.arange(600) % 2, 300, 44)
    pal = np.asarray(pallas_histogram(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(valid),
        max_bin=511, chunk=512, interpret=True))
    cpu = np.asarray(jax_hist(jnp.asarray(bins.astype(np.int32)),
                              jnp.asarray(gh), jnp.asarray(valid), 511,
                              precision="f32"))
    twin = _twin(bins, gh, valid, 511, "f32")
    np.testing.assert_array_equal(twin[..., 2], cpu[..., 2])
    assert cpu[0, 300, 2] > 0 and cpu[0, 44, 2] > 0
    # the Pallas kernel's bin 44 holds the rows of bin 300 too
    assert pal[0, 44, 2] == cpu[0, 44, 2] + cpu[0, 300, 2]
    assert pal[0, :, 2].sum() == valid.sum()


@pytest.mark.parametrize("sparse", [False, True])
def test_uint16_dataset_matches_jax(sparse):
    """`from_matrix` and `from_sparse` bin to uint16 past 256 bins,
    bytes equal to the JAX package's; a categorical column of ~300 codes
    warns, as there, that only 256 codes can be split on."""
    X, y = _data(2000, cat=True)
    if sparse:
        X = np.where(np.abs(np.nan_to_num(X)) < 0.5, 0.0, X)
        X = sp.csr_matrix(np.nan_to_num(X))
    params = {"max_bin": 400, "verbosity": -1, "categorical_feature": "5"}
    jm = jds.Dataset.from_sparse if sparse else jds.Dataset.from_matrix
    tm = tds.Dataset.from_sparse if sparse else tds.Dataset.from_matrix
    jd = jm(X, label=y, config=JConfig.from_params(params))
    with pytest.warns(UserWarning, match="256 most frequent"):
        td = tm(X, label=y, config=TConfig.from_params(params))
    assert td.bins.dtype == torch.uint16 and jd.bins.dtype == np.uint16
    assert max(m.num_bin for m in td.mappers) > 256
    np.testing.assert_array_equal(td._host_bins(), jd.bins)


def test_partition_and_traversal_past_int16():
    """Bins of 32,768 and more (negative in the int16 view the port reads
    uint16 through) partition and traverse as their values say."""
    rng = np.random.RandomState(3)
    col = rng.randint(0, 65536, 5000).astype(np.uint16)
    t = torch.from_numpy(col.view(np.int16)).view(torch.uint16)
    np.testing.assert_array_equal(B.take_bins(t, slice(None)).numpy(),
                                  col.astype(np.int32))
    idx = torch.arange(5000, dtype=torch.int32)
    left = split_partition(idx, t, 0, 5000, 40000, False, 0, 0, 65536)
    expect = np.nonzero(col <= 40000)[0]
    assert left == len(expect)
    np.testing.assert_array_equal(idx[:left].numpy(), expect)


@pytest.mark.parametrize("case", ["uint16", "uint16_cat", "bundled"])
def test_predict_binned_leaves_matches_jax(case):
    """`predict_binned_leaves` over uint16 bins (numerical and
    categorical) and EFB-bundled bins: the JAX `TreePredictor`'s leaves."""
    if case == "bundled":
        rng = np.random.RandomState(6)
        dense = np.zeros((1500, 12))
        cols = rng.randint(0, 12, 1500)
        dense[np.arange(1500), cols] = rng.randint(1, 5, 1500)
        X, y = sp.csr_matrix(dense), (cols % 3 == 0).astype(float)
        params = {"objective": "binary", "max_bin": 63}
    else:
        X, y = _data(1500, cat=case == "uint16_cat")
        params = {"objective": "regression", "max_bin": 511,
                  "min_data_in_bin": 1}
        if case == "uint16_cat":
            params["categorical_feature"] = "5"
    params.update(num_leaves=15, verbosity=-1, device_type="cpu",
                  tpu_grow_mode="leafwise")
    bst = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=3,
                     verbose_eval=False)
    td = bst._gbdt.train_data
    assert (td.bundles is not None) == (case == "bundled")
    if case != "bundled":
        assert td.bins.dtype == torch.uint16
    got = predict_binned_leaves(bst.trees, td.bins, td.bundles).numpy()
    bundle = None if td.bundles is None else tuple(
        jnp.asarray(a.astype(np.int32)) for a in
        (td.bundles.col, td.bundles.off, td.bundles.packed))
    ref = np.asarray(TreePredictor(bst.trees).predict_binned_leaves(
        jnp.asarray(td._host_bins()), bundle))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("features,bins,precision", [
    (28, 511, "f32"), (28, 1023, "f64"), (27, 511, "i8"), (3, 20000, "f32"),
    (4, 40000, "i16")])
def test_launch_shape16_fits_shared_memory(features, bins, precision):
    """The uint16 route's tiles fit an H100's opt-in (232,448 B): whole
    2-feature words where F is even; one feature a tile and bin tiles
    that cover its bins where one feature's cells do not fit."""
    optin = 232_448
    fpb, bt, ctas, tile_rows = H.launch_shape16(
        10_485_760, features, bins, precision, 132, optin)
    assert H.hist_smem(fpb, bt, precision) <= optin
    if bins * H._CELL_BYTES[precision] + H._SMEM_EXTRA <= optin:
        assert bt == bins
        assert fpb % 2 == 0 or features % 2 == 1 or fpb == features
    else:
        assert fpb == 1 and bt < bins and -(-bins // bt) * bt >= bins
    assert tile_rows <= H.HIST_TILE_ROWS
    grid = -(-features // fpb) * -(-bins // bt)
    assert 1 <= ctas <= max(1, 132 // grid)


@pytest.mark.parametrize("learner", ["leafwise", "host"])
@pytest.mark.parametrize("case", ["numerical", "categorical"])
def test_uint16_trees_match_jax(x64, learner, case):
    """f64 tree sections byte-equal to the JAX package's at ``max_bin``
    511 (and with a categorical column of ~300 codes), on the leaf-wise
    learner (l2) and the host learner (l1); the matrix is uint16."""
    X, y = _data(cat=case == "categorical")
    params = {**BASE, "objective": "regression" if learner == "leafwise"
              else "regression_l1"}
    kw = {}
    if case == "categorical":
        kw = {"categorical_feature": [5]}
        params.update(min_data_per_group=5, cat_smooth=1.0)
    compile_cache.clear_programs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # > 256 codes
        jb = jlgb.train(params, jlgb.Dataset(X, label=y, **kw),
                        num_boost_round=4, verbose_eval=False)
        tb = tlgb.train({**params, "device_type": "cpu"},
                        tlgb.Dataset(X, label=y, **kw), num_boost_round=4,
                        verbose_eval=False)
    g = tb._gbdt
    assert g.train_data.bins.dtype == torch.uint16
    assert g.train_path == learner
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    if case == "categorical":
        assert sum(t.num_cat for t in tb.trees) > 0


def test_uint16_quantized_int8_matches_jax():
    """int8 quantized histograms over uint16 bins: the tree sections are
    the JAX package's (its f32 sums of the integers are exact at this
    size, C.30)."""
    X, y = _data(2000)
    y = (y > 0).astype(np.float64)
    params = {**BASE, "objective": "binary", "tpu_quant_hist": "on",
              "tpu_quant_hist_bits": 8, "min_data_in_leaf": 5}
    params.pop("tpu_use_f64_hist")
    compile_cache.clear_programs()
    jb = jlgb.Booster(params=params,
                      train_set=jlgb.Dataset(X, label=y, params=params))
    for _ in range(4):
        jb.update()
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=4,
                    verbose_eval=False)
    assert tb._gbdt.learner.quant_bits == 8
    assert tb._gbdt.train_data.bins.dtype == torch.uint16
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_auto_leaves_aligned_for_uint16(caplog):
    """`auto` takes the leaf-wise learner on uint16 bins, with the JAX
    package's first failing gate, "bins not uint8", as its reason (on
    the CPU with the aligned engine's twins allowed, as the card has its
    kernels)."""
    X, y = _data(2000)
    params = {"objective": "regression", "max_bin": 511,
              "min_data_in_bin": 1, "num_leaves": 7, "verbosity": 1,
              "device_type": "cpu", "tpu_aligned_interpret": True}
    bst = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1,
                     verbose_eval=False)
    assert bst._gbdt.train_path == "leafwise"
    assert bst._gbdt.aligned_gate() == "bins not uint8"
    jp = {k: v for k, v in params.items() if k != "device_type"}
    jb = jlgb.Booster(params=jp, train_set=jlgb.Dataset(X, label=y,
                                                        params=jp))
    assert jb._gbdt.learner.aligned_mode_gate(jb._gbdt.objective) \
        == "bins not uint8"
