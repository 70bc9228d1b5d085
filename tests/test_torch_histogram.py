"""Kernel B1's plain twin (lightgbm_tpu_torch/ops/histogram.py) against
the JAX package's histogram: the Pallas kernel in interpret mode (as
tests/test_subbin_spill.py runs it) and the f64 einsum path."""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import \
    histogram_from_gathered_gh as jax_hist
from lightgbm_tpu.ops.pallas_hist import pallas_histogram
from lightgbm_tpu_torch.ops import histogram as H


@pytest.fixture
def jax_x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed; give it the replacement for this test."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _mk(n, f, max_bin, seed=0, int_payload=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint8)
    if int_payload:
        g = rng.randint(-8, 9, n).astype(np.float32)
        h = rng.randint(0, 5, n).astype(np.float32)
    else:
        g = rng.standard_normal(n).astype(np.float32)
        h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    valid = rng.rand(n) < 0.7
    return bins, np.stack([g, h], axis=1), valid


def _port(bins, gh, valid, max_bin, precision="f32"):
    return H.histogram_from_gathered_gh(
        torch.tensor(bins), torch.tensor(gh), torch.tensor(valid), max_bin,
        precision).numpy()


def _pallas(bins, gh, valid, max_bin):
    return np.asarray(pallas_histogram(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(valid),
        max_bin=max_bin, chunk=512, interpret=True))


@pytest.mark.parametrize("max_bin", [63, 255])
def test_integer_payload_bitwise_vs_pallas(max_bin):
    """Integer payloads: the bf16 hi/lo split is exact, so the port's
    histogram equals the Pallas kernel's bit for bit (255 bins takes the
    sub-bin branch)."""
    bins, gh, valid = _mk(1500, 5, max_bin, seed=1, int_payload=True)
    np.testing.assert_array_equal(_port(bins, gh, valid, max_bin),
                                  _pallas(bins, gh, valid, max_bin))


@pytest.mark.parametrize("max_bin", [63, 255])
def test_float_payload_vs_pallas(max_bin):
    """Float payloads: counts exact; grad/hess within the tolerance of
    test_subbin_spill.py (the hi/lo split is only about f32)."""
    bins, gh, valid = _mk(2000, 4, max_bin, seed=2)
    got = _port(bins, gh, valid, max_bin)
    ref = _pallas(bins, gh, valid, max_bin)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_f64_equals_reference_f64(max_bin, jax_x64):
    """tpu_use_f64_hist: exactly the JAX package's f64 histogram."""
    bins, gh, valid = _mk(1800, 6, max_bin, seed=3)
    got = _port(bins, gh, valid, max_bin, "f64")
    ref = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(gh),
                              jnp.asarray(valid), max_bin=max_bin,
                              precision="f64"))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def test_leaf_slice_and_root_match_gathered():
    """The fused gather: a leaf's index slice and the contiguous root give
    the histogram of the rows they name, without launching a kernel on
    CPU tensors."""
    bins, gh, _ = _mk(900, 7, 63, seed=4)
    tb, tgh = torch.tensor(bins), torch.tensor(gh)
    perm = torch.tensor(np.random.RandomState(5).permutation(900),
                        dtype=torch.int32)
    H.reset_launches()
    got = H.leaf_histogram(tb, tgh, perm, 100, 333, 63, "f64")
    rows = perm[100:433].long()
    ref = H.histogram_plain(tb[rows], tgh[rows], None, 0, 333, 63, "f64")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    root = H.leaf_histogram(tb, tgh, None, 0, 900, 63)
    assert root.dtype == torch.float32
    np.testing.assert_array_equal(root[..., 2].sum(1).numpy(), 900)
    assert H.LAUNCHES == {"f32": 0, "f64": 0}
    torch.testing.assert_close(
        H.subtract_histogram(root, got.float()),
        root - got.float(), rtol=0, atol=0)


@pytest.mark.parametrize("features,bins,precision,tiles", [
    (28, 63, "f32", 1), (28, 255, "f32", 1), (28, 63, "f64", 1),
    (28, 255, "f64", 1), (137, 255, "f32", 4)])
def test_launch_shape_fits_shared_memory(features, bins, precision, tiles):
    """Kernel B1's feature tiles: the fewest equal tiles whose 20-byte
    cells fit a CTA's shared memory (227 KB opt-in on an H100), whole
    4-feature words where the features divide by 4 (HIGGS's 28 in one
    tile, MSLR's 137 at 255 bins in four); one CTA an SM over the root's
    row tiles of at most 16,384 rows."""
    optin = 232448
    fpb, ctas, tile_rows = H.launch_shape(10_500_000, features, bins,
                                          precision, num_sms=132,
                                          smem_optin=optin)
    assert -(-features // fpb) == tiles
    assert H.hist_smem(fpb, bins, precision) <= optin
    assert features % 4 or fpb % 4 == 0
    assert tile_rows <= H.HIST_TILE_ROWS
    assert ctas * tiles <= 132 and ctas == 132 // tiles


@pytest.mark.parametrize("count,ctas_63,ctas_255", [
    (1, 1, 1), (16_384, 44, 22), (16_385, 44, 22), (20_000, 48, 24),
    (10_500_000, 132, 132)])
def test_launch_shape_small_leaves(count, ctas_63, ctas_255):
    """A leaf's rows are spread over about sqrt(7.2 x rows / bins) CTAs
    (at most one an SM), each taking the same number of equal tiles (one
    more at most) of at most 16,384 rows, never more CTAs than tiles: 1
    row one CTA, 20,000 rows 48 at 63 bins and 24 at 255, the 10.5M root
    all 132 SMs with five tiles each."""
    for bins, want in ((63, ctas_63), (255, ctas_255)):
        fpb, ctas, tile_rows = H.launch_shape(count, 28, bins, "f32", 132,
                                              232448)
        tiles = -(-count // tile_rows)
        per_cta = -(-tiles // ctas)
        assert fpb == 28
        assert ctas == want
        assert tile_rows <= H.HIST_TILE_ROWS
        assert ctas <= tiles and ctas * (per_cta - 1) < tiles
    assert H.launch_shape(10_500_000, 28, 63, "f32", 132, 232448)[2] \
        == 15_910


def test_launch_shape_rejects_what_does_not_fit():
    """A feature's cells beyond the opt-in, or no CTA an SM, raise."""
    with pytest.raises(ValueError):
        H.launch_shape(100, 28, 255, "f32", 132, 255 * 20)
    with pytest.raises(ValueError):
        H.launch_shape(100, 28, 255, "f32", 132, 232448, ctas_per_sm=0)


# kernel B5's dynamic shared memory on an H100: the 227 KB opt-in less
# about 12.6 KB of the kernels' static segment tables
WORDS_OPTIN = 232448 - 12_800


@pytest.mark.parametrize("features,bins,precision,tiles", [
    (28, 63, "f32", 1), (28, 255, "f32", 1), (137, 255, "f32", 4),
    (28, 63, "f64", 1), (28, 255, "f64", 1)])
def test_words_launch_shape_fits_shared_memory(features, bins, precision,
                                               tiles):
    """Kernel B5's feature tiles: the fewest equal tiles of whole 4-feature
    words whose 20-byte cells fit a CTA's dynamic shared memory (HIGGS's
    28 features one tile at 63 and at 255 bins, MSLR's 137 at 255 four);
    the 10.5M-row root on all 132 SMs."""
    fpb, ctas = H.words_launch_shape(10_500_000, features, bins, precision,
                                     num_sms=132, smem_optin=WORDS_OPTIN)
    assert -(-features // fpb) == tiles
    assert fpb % 4 == 0
    assert H.hist_smem(fpb, bins, precision) <= WORDS_OPTIN
    assert ctas * tiles <= 132 and ctas == 132 // tiles


@pytest.mark.parametrize("rows,ctas_63,ctas_255", [
    (1, 1, 1), (16_384, 44, 22), (16_385, 44, 22), (20_000, 48, 24),
    (10_500_000, 132, 132)])
def test_words_launch_shape_ctas(rows, ctas_63, ctas_255):
    """A call's rows (all its segments together) are spread over about
    sqrt(7.2 x rows / bins) CTAs, at most one an SM: 1 row one CTA,
    20,000 rows 48 at 63 bins and 24 at 255, the 10.5M root all 132."""
    for bins, want in ((63, ctas_63), (255, ctas_255)):
        fpb, ctas = H.words_launch_shape(rows, 28, bins, "f32", 132,
                                         WORDS_OPTIN)
        assert fpb == 28 and ctas == want
    assert H.words_launch_shape(20_000, 28, 63, "f32", 132, WORDS_OPTIN,
                                ctas_per_sm=2)[1] == 48


def test_words_launch_shape_rejects_what_does_not_fit():
    """A word's four features of cells beyond the shared memory, or no
    CTA an SM, raise (B1 would still take one feature a tile)."""
    with pytest.raises(ValueError):
        H.words_launch_shape(100, 28, 255, "f32", 132, 3 * 255 * 20 + 8)
    assert H.launch_shape(100, 28, 255, "f32", 132, 3 * 255 * 20 + 8)[0] \
        == 3
    with pytest.raises(ValueError):
        H.words_launch_shape(100, 28, 63, "f32", 132, WORDS_OPTIN,
                             ctas_per_sm=0)
