"""Tests of the port that need the card: the CUDA histogram kernels (B1
and the level builder's B5), the aligned engine's kernels and the
lambdarank kernel against their plain twins, B1's integer branch
(quantized payloads) bit-equal to its twin and quantized training on the
card against the CPU, B1's uint16 route (bins past 256, its bin-axis
tiles) against its twin and its training against the CPU, f64 training on the card
against the CPU (leaf-wise and level), the aligned engine on the card
(binary, and lambdarank on EXT records), the categorical route of B2 and
B3 and categorical f64 training against the CPU, the bundled branch of
B2 and B3 (exclusive feature bundling) and bundled f64 training against
the CPU, the pointwise objective kinds of B2 and B4 (COMPACT records),
the host learner's f64 training against the CPU, and the prototype
kernels P1-P3 against their twins. They import
neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as A
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import proto as P
from lightgbm_tpu_torch.ops import rank as R
from lightgbm_tpu_torch.ops.ranking import discount_table
from lightgbm_tpu_torch.utils import prng
from lightgbm_tpu_torch.utils.launches import graph_launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _mk(n, f, max_bin, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint8)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return bins, np.stack([g, h], axis=1)


def _leaf_abs_sums(tgh, idx, begin, count):
    """[2] sum of |g| and |h| over a leaf's rows (the scale of the f32
    histogram tolerance); NaN and Inf add nothing."""
    rows = idx[begin:begin + count].long() if idx is not None \
        else slice(begin, begin + count)
    v = tgh[rows]
    return torch.where(torch.isfinite(v), v.abs(), 0.0).sum(0)


def _check_leaf(tb, tgh, idx, begin, count, max_bin):
    """B1 against its twin on one leaf: f64 equal; f32 counts equal and
    grad/hess within 1e-5 of the rows' sum of |g| (|h|)."""
    got = H.leaf_histogram(tb, tgh, idx, begin, count, max_bin, "f64")
    ref = H.histogram_plain(tb, tgh, idx, begin, count, max_bin, "f64")
    assert torch.equal(got, ref)
    got = H.leaf_histogram(tb, tgh, idx, begin, count, max_bin)
    ref = H.histogram_plain(tb, tgh, idx, begin, count, max_bin)
    assert torch.equal(got[..., 2], ref[..., 2])
    scale = _leaf_abs_sums(tgh, idx, begin, count)
    assert bool(((got[..., :2] - ref[..., :2]).abs()
                 <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [63, 255])
def test_kernel_matches_plain_on_gpu(cuda, max_bin):
    """f64 equal to the twin; f32 counts equal and grad/hess within
    1e-5 of the rows' sum of |g| (|h|), over gathered leaves of 0, 1,
    16,383, 16,384, 16,385 and 20,000 rows and the root, the 20,000-row
    leaf once more on bins stored one byte off a 4-byte boundary (read
    through the words that hold each row's bytes); at 255 bins also 137
    features (four feature tiles)."""
    bins, gh = _mk(50000, 28, max_bin, seed=6)
    tb = torch.tensor(bins, device=cuda)
    tgh = torch.tensor(gh, device=cuda)
    perm = torch.randperm(50000, device=cuda).to(torch.int32)
    cases = [(tb, tgh, perm, 1000, count)
             for count in (0, 1, 16_383, 16_384, 16_385, 20_000)]
    cases.append((tb, tgh, None, 0, 50000))
    odd = torch.empty(tb.numel() + 1, dtype=torch.uint8,
                      device=cuda)[1:].view(tb.shape)
    odd.copy_(tb)
    assert odd.is_contiguous() and odd.data_ptr() % 4 == 1
    cases.append((odd, tgh, perm, 1000, 20_000))
    if max_bin == 255:
        wide, wgh = _mk(30000, 137, max_bin, seed=8)
        tw = torch.tensor(wide, device=cuda)
        twgh = torch.tensor(wgh, device=cuda)
        wperm = torch.randperm(30000, device=cuda).to(torch.int32)
        cases += [(tw, twgh, wperm, 500, 20_000), (tw, twgh, None, 0, 30000)]
    H.reset_launches()
    for b, g, idx, begin, count in cases:
        _check_leaf(b, g, idx, begin, count, max_bin)
    launched = sum(1 for c in cases if c[4] > 0)
    assert H.LAUNCHES == {"f32": launched, "f64": launched}


@pytest.mark.cuda
def test_hist_nonfinite_on_gpu(cuda):
    """NaN, +Inf and -Inf written into g and h: B1 (f32 and f64) against
    its twin cell by cell, NaN, Inf (of its sign) or finite where the
    twin's is, finite cells within 1e-5 x the leaf's finite sum of |g|
    (|h|); over a gathered leaf and the root, whose last row tiles hold
    finite payloads only."""
    bins, gh = _mk(40000, 28, 63, seed=9)
    rng = np.random.RandomState(10)
    vals = [float("nan"), float("inf"), float("-inf")]
    for i, r in enumerate(rng.choice(12000, 60, replace=False)):
        gh[r, i % 2] = vals[i % 3]
    tb = torch.tensor(bins, device=cuda)
    tgh = torch.tensor(gh, device=cuda)
    perm = torch.randperm(40000, device=cuda).to(torch.int32)
    for idx, begin, count in ((perm, 3000, 20000), (None, 0, 40000)):
        scale = _leaf_abs_sums(tgh, idx, begin, count)
        for prec in ("f32", "f64"):
            got = H.leaf_histogram(tb, tgh, idx, begin, count, 63, prec)
            ref = H.histogram_plain(tb, tgh, idx, begin, count, 63, prec)
            assert bool(ref[..., :2].isnan().any())
            assert bool(ref[..., :2].isinf().any())
            _assert_hist_nonfinite(got[None], ref[None],
                                   scale[None].to(got.dtype))


@pytest.mark.cuda
def test_hist_ctas_per_sm_on_gpu(cuda):
    """The occupancy calculator fits one 1,024-thread CTA of B1's f32 and
    f64 kernels on an SM at the HIGGS (28 features, 63 and 255 bins) and
    MSLR (137 x 255) shapes."""
    ordinal = cuda.index or 0
    num_sms, optin = H._device(ordinal)
    for F, B in ((28, 63), (28, 255), (137, 255)):
        for prec in ("f32", "f64"):
            fpb = H.launch_shape(10_500_000, F, B, prec, num_sms, optin)[0]
            smem = H.hist_smem(fpb, B, prec)
            assert smem <= optin
            assert H.hist_ctas_per_sm(ordinal, prec, smem) == 1


@pytest.mark.cuda
def test_hist_back_to_back_calls_on_gpu(cuda):
    """Calls in a row on different leaves, sizes and bin counts, enqueued
    without a synchronize between them, each give the twin's result: the
    last CTA of a call zeroes the scratch and the ticket for the next."""
    bins, gh = _mk(30000, 28, 63, seed=12)
    tb = torch.tensor(bins, device=cuda)
    tgh = torch.tensor(gh, device=cuda)
    perm = torch.randperm(30000, device=cuda).to(torch.int32)
    leaves = [(perm, 0, 20000, 255), (perm, 20000, 10000, 63),
              (None, 0, 30000, 255), (perm, 5, 1, 63),
              (perm, 100, 16385, 255), (perm, 7, 20000, 63)]
    for prec in ("f32", "f64"):
        H.reset_launches()
        outs = [H.leaf_histogram(tb, tgh, idx, b, c, nb, prec)
                for idx, b, c, nb in leaves]
        assert H.LAUNCHES[prec] == len(leaves)
        for out, (idx, b, c, nb) in zip(outs, leaves):
            ref = H.histogram_plain(tb, tgh, idx, b, c, nb, prec)
            if prec == "f64":
                assert torch.equal(out, ref)
                continue
            assert torch.equal(out[..., 2], ref[..., 2])
            scale = _leaf_abs_sums(tgh, idx, b, c)
            assert bool(((out[..., :2] - ref[..., :2]).abs()
                         <= 1e-5 * scale).all())


def _mk_q(n, f, max_bin, bits, seed, extreme=False):
    """uint8 bins [n, f] and the quantized payload of random g/h
    (`quantize_gh`, int8 or int16 [n, 2]); ``extreme``: every value at
    +-qmax, the largest sums a cell can take."""
    bins, gh = _mk(n, f, max_bin, seed)
    if extreme:
        sign = np.where(np.random.RandomState(seed).rand(n) < 0.5, -1, 1)
        gh = np.stack([sign, np.ones(n)], 1).astype(np.float32)
    q, _ = H.quantize_gh(torch.tensor(gh), bits,
                         prng.fold_in(prng.key(seed), 1))
    return bins, q


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("max_bin", [63, 255])
def test_int_kernel_matches_plain_on_gpu(cuda, max_bin, bits):
    """B1's integer branch (int8 / int16 quantized g and h) bit-equal to
    its twin: over gathered leaves of 0, 1, 16,383, 16,384, 16,385 and
    20,000 rows, the root, the 20,000-row leaf on bins one byte off a
    4-byte boundary, and at 255 bins 137 features (four feature tiles);
    one launch a call, counted by width."""
    bins, q = _mk_q(50000, 28, max_bin, bits, seed=21)
    tb = torch.tensor(bins, device=cuda)
    tq = q.to(cuda)
    perm = torch.randperm(50000, device=cuda).to(torch.int32)
    cases = [(tb, tq, perm, 1000, count)
             for count in (0, 1, 16_383, 16_384, 16_385, 20_000)]
    cases.append((tb, tq, None, 0, 50000))
    odd = torch.empty(tb.numel() + 1, dtype=torch.uint8,
                      device=cuda)[1:].view(tb.shape)
    odd.copy_(tb)
    cases.append((odd, tq, perm, 1000, 20_000))
    if max_bin == 255:
        wide, wq = _mk_q(30000, 137, max_bin, bits, seed=22)
        tw, twq = torch.tensor(wide, device=cuda), wq.to(cuda)
        wperm = torch.randperm(30000, device=cuda).to(torch.int32)
        cases += [(tw, twq, wperm, 500, 20_000), (tw, twq, None, 0, 30000)]
    H.reset_launches()
    for b, g, idx, begin, count in cases:
        got = H.leaf_histogram(b, g, idx, begin, count, max_bin)
        ref = H.histogram_plain(b, g, idx, begin, count, max_bin)
        assert got.dtype == torch.float32
        assert torch.equal(got, ref)
    launched = sum(1 for c in cases if c[4] > 0)
    assert H.INT_LAUNCHES == {"i8": launched if bits == 8 else 0,
                              "i16": launched if bits == 16 else 0}
    assert H.LAUNCHES == {"f32": 0, "f64": 0}


def _u16(arr, device):
    """A uint16 numpy array as a torch.uint16 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(
        device).view(torch.uint16)


def _u16_payloads(gh, device):
    """The f32 payload and its int8 / int16 quantized forms."""
    from lightgbm_tpu_torch.utils import prng
    t = torch.tensor(gh, device=device)
    return {"f32": t, "f64": t,
            "i8": H.quantize_gh(t, 8, prng.key(8))[0],
            "i16": H.quantize_gh(t, 16, prng.key(16))[0]}


def _u16_check(b, pay, kind, idx, begin, count, nbins):
    prec = "f64" if kind == "f64" else "f32"
    got = H.leaf_histogram(b, pay, idx, begin, count, nbins, prec)
    ref = H.histogram_plain(b, pay, idx, begin, count, nbins, prec)
    if kind == "f32":
        assert torch.equal(got[..., 2], ref[..., 2])
        scale = _leaf_abs_sums(pay, idx, begin, count)
        assert bool(((got[..., :2] - ref[..., :2]).abs()
                     <= 1e-5 * scale).all())
    else:
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "f64", "i8", "i16"])
@pytest.mark.parametrize("nbins,features", [(511, 28), (1023, 27)])
def test_u16_kernel_matches_plain_on_gpu(cuda, nbins, features, kind):
    """B1's uint16 route against its twin: f32 within 1e-5 of the leaf's
    sum of |g| (|h|), f64 and the integer payloads equal; over gathered
    leaves of 0, 1, 16,385 and 20,000 rows and the root, and the
    20,000-row leaf on bins 2 bytes off a 4-byte boundary (read through
    the words that hold each bin); F even (whole 2-feature words) and
    odd; one launch a call, counted in `WIDE_LAUNCHES`."""
    rng = np.random.RandomState(31)
    bins = rng.randint(0, nbins, (50000, features)).astype(np.uint16)
    bins[::7, 0] = nbins - 1
    _, gh = _mk(50000, 2, 2, seed=32)
    tb = _u16(bins, cuda)
    pay = _u16_payloads(gh, cuda)[kind]
    perm = torch.randperm(50000, device=cuda).to(torch.int32)
    cases = [(tb, perm, 1000, count) for count in (0, 1, 16_385, 20_000)]
    cases.append((tb, None, 0, 50000))
    odd = torch.empty(tb.numel() + 1, dtype=torch.int16,
                      device=cuda)[1:].view(tb.shape)
    odd.copy_(tb.view(torch.int16))
    odd = odd.view(torch.uint16)
    assert odd.is_contiguous() and odd.data_ptr() % 4 == 2
    cases.append((odd, perm, 1000, 20_000))
    H.reset_launches()
    for b, idx, begin, count in cases:
        _u16_check(b, pay, kind, idx, begin, count, nbins)
    launched = sum(1 for c in cases if c[3] > 0)
    assert H.WIDE_LAUNCHES[kind] == launched
    assert sum(H.WIDE_LAUNCHES.values()) == launched
    assert H.LAUNCHES == {"f32": 0, "f64": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "f64", "i8"])
def test_u16_bin_tiles_on_gpu(cuda, kind):
    """Bins whose one feature's cells exceed a CTA's shared memory (20,000
    and 40,000 bins): the bin axis in tiles, each with its ticket, equal
    to the twin (f32 within the bound), root and gathered leaf; a
    feature's bins all land."""
    for nbins, features in ((20_000, 3), (40_000, 2)):
        rng = np.random.RandomState(nbins)
        bins = rng.randint(0, nbins, (120_000, features)).astype(np.uint16)
        _, gh = _mk(120_000, 2, 2, seed=33)
        tb = _u16(bins, cuda)
        pay = _u16_payloads(gh, cuda)[kind]
        sms, optin = H._device(cuda.index or 0)
        _, bin_tile, _, _ = H.launch_shape16(120_000, features, nbins,
                                             kind, sms, optin)
        assert bin_tile < nbins
        perm = torch.randperm(120_000, device=cuda).to(torch.int32)
        for idx, begin, count in ((None, 0, 120_000), (perm, 7, 40_000)):
            _u16_check(tb, pay, kind, idx, begin, count, nbins)


@pytest.mark.cuda
def test_u16_training_on_gpu_equals_cpu(cuda):
    """max_bin 511 (uint16 bins), f64 histograms, leaf-wise and on the
    host learner (l1): the card's tree sections equal the CPU's, every B1
    launch on the uint16 route."""
    rng = np.random.RandomState(34)
    X = rng.standard_normal((20000, 8))
    y = X[:, 0] - 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.standard_normal(20000)
    for obj in ("regression", "regression_l1"):
        params = {"objective": obj, "num_leaves": 15, "max_bin": 511,
                  "tpu_grow_mode": "leafwise", "tpu_use_f64_hist": True,
                  "verbosity": -1}
        texts = []
        for dev in ("cuda", "cpu"):
            H.reset_launches()
            bst = tlgb.train({**params, "device_type": dev},
                             tlgb.Dataset(X, label=y), num_boost_round=3,
                             verbose_eval=False)
            assert bst._gbdt.train_data.bins.dtype == torch.uint16
            t = bst.model_to_string()
            texts.append(t[t.index("Tree=0"):t.index("end of trees")])
            if dev == "cuda":
                assert H.WIDE_LAUNCHES["f64"] > 0
                assert H.LAUNCHES == {"f32": 0, "f64": 0}
        assert texts[0] == texts[1]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_int_kernel_flushes_on_gpu(cuda, bits):
    """One CTA over 300,000 rows of +-qmax payloads in two bins (int16: a
    flush of its 32-bit cells every four 16,384-row tiles) and over a
    gathered leaf of them: bit-equal to the twin, whose int64 sums pass
    2^31."""
    bins, q = _mk_q(300_000, 8, 2, bits, seed=23, extreme=True)
    tb, tq = torch.tensor(bins, device=cuda), q.to(cuda)
    perm = torch.randperm(300_000, device=cuda).to(torch.int32)
    for idx, begin, count in ((None, 0, 300_000), (perm, 1, 299_990)):
        ref = H.histogram_plain(tb, tq, idx, begin, count, 2)
        for ctas in (1, 3, None):
            got = H._histogram_cuda(tb, tq, idx, begin, count, 2, "f32",
                                    ctas=ctas)
            assert torch.equal(got, ref)
    if bits == 16:
        assert float(ref[..., 1].abs().max()) > 2 ** 31


@pytest.mark.cuda
def test_int_back_to_back_with_f32_on_gpu(cuda):
    """f32, int8 and int16 calls in a row on the same stream, without a
    synchronize: the integer branch reads the shared scratch's f64 words
    as int64 sums, and each call leaves it zero for the next."""
    bins, gh = _mk(30000, 28, 63, seed=24)
    tb, tgh = torch.tensor(bins, device=cuda), torch.tensor(gh, device=cuda)
    q8, _ = H.quantize_gh(torch.tensor(gh), 8, prng.key(3))
    q16, _ = H.quantize_gh(torch.tensor(gh), 16, prng.key(4))
    perm = torch.randperm(30000, device=cuda).to(torch.int32)
    calls = [(tgh, perm, 0, 20000, 255), (q8.to(cuda), perm, 20000, 10000,
                                          63),
             (q16.to(cuda), None, 0, 30000, 255), (tgh, None, 0, 30000, 63),
             (q8.to(cuda), perm, 5, 1, 63), (q16.to(cuda), perm, 7, 20000,
                                             63)]
    outs = [H.leaf_histogram(tb, g, idx, b, c, nb) for g, idx, b, c, nb
            in calls]
    for out, (g, idx, b, c, nb) in zip(outs, calls):
        ref = H.histogram_plain(tb, g, idx, b, c, nb)
        if g.dtype == torch.float32:
            assert torch.equal(out[..., 2], ref[..., 2])
            scale = _leaf_abs_sums(g, idx, b, c)
            assert bool(((out[..., :2] - ref[..., :2]).abs()
                         <= 1e-5 * scale).all())
        else:
            assert torch.equal(out, ref)


@pytest.mark.cuda
def test_int_ctas_per_sm_on_gpu(cuda):
    """The occupancy calculator fits at least one 1,024-thread CTA of the
    integer branch (12-byte cells) on an SM at the HIGGS and MSLR
    shapes."""
    ordinal = cuda.index or 0
    num_sms, optin = H._device(ordinal)
    for F, B in ((28, 63), (28, 255), (137, 255)):
        for kind in ("i8", "i16"):
            fpb = H.launch_shape(10_500_000, F, B, kind, num_sms, optin)[0]
            smem = H.hist_smem(fpb, B, kind)
            assert smem <= optin
            assert H.hist_ctas_per_sm(ordinal, kind, smem) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_training_on_gpu_equals_cpu(cuda, bits):
    """tpu_quant_hist=on: the integer branch equals its twin, so the
    trees grown on the card are the CPU's, byte for byte."""
    rng = np.random.RandomState(2)
    X = rng.standard_normal((3000, 8))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(3000) > 0)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "tpu_quant_hist": "on", "tpu_quant_hist_bits": bits,
              "tpu_grow_mode": "leafwise", "verbosity": -1}
    texts = {}
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y.astype(np.float64)),
                         num_boost_round=3, verbose_eval=False)
        assert (H.INT_LAUNCHES[f"i{bits}"] > 0) == (dev == "cuda")
        assert H.LAUNCHES["f32"] == 0
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    assert texts["cuda"] == texts["cpu"]


def _words_abs_sums(g, h, beg, cnt):
    """[S, 2] sum of |g| and |h| over each segment's rows (the scale of
    B5's f32 tolerance); NaN and Inf add nothing."""
    out = torch.zeros((beg.numel(), 2), dtype=torch.float32,
                      device=g.device)
    for i, (b, c) in enumerate(zip(beg.tolist(), cnt.tolist())):
        v = torch.stack([g[b:b + c], h[b:b + c]], 1)
        out[i] = torch.where(torch.isfinite(v), v.abs(), 0.0).sum(0)
    return out


def _check_words(got, ref, g, h, beg, cnt, precision):
    """B5 against its twin: "f64" bit for bit; "f32" counts equal and
    grad/hess within 1e-5 x the segment's sum of |g| (|h|)."""
    if precision == "f64":
        assert torch.equal(got, ref)
        return
    assert torch.equal(got[..., 2], ref[..., 2])
    scale = _words_abs_sums(g, h, beg, cnt)[:, None, None, :]
    assert bool(((got[..., :2] - ref[..., :2]).abs() <= 1e-5 * scale).all())


def _words_segments(n, rng):
    """Segment tables of one call each: the whole rows; segments of 0, 1,
    16,383, 16,384, 16,385 and 20,000 rows; ~200 small segments."""
    tables = [[(0, n)],
              [(7, 20000), (20007, 0), (30000, 1), (40000, 16383),
               (1, 5), (60000, 16384), (80000, 16385)]]
    small, p = [], 0
    for _ in range(200):
        c = int(rng.randint(0, 400))
        small.append((p, c))
        p += c
    tables.append(small)
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("max_bin", [63, 255])
def test_words_kernel_matches_plain_on_gpu(cuda, max_bin, precision):
    """Kernel B5 (63 bins: B5a's branch; 255: B5b's) against its twin, one
    launch a call: "f64" bit for bit (f64 shared sums rounded once, as
    the twin), "f32" (fixed-point cells) counts equal and grad/hess
    within 1e-5 x the segment's sum of |g|, over the whole rows, segments
    of 0, 1, 16,383, 16,384, 16,385 and 20,000 rows, and ~200 small
    segments; and the level run on the card launches it and, in f64,
    grows the CPU's trees."""
    from lightgbm_tpu_torch.models.level_builder import pack_bin_words
    n = 100_000
    bins, gh = _mk(n, 28, max_bin, seed=8)
    words = pack_bin_words(torch.tensor(bins, device=cuda))
    g = torch.tensor(gh[:, 0], device=cuda)
    h = torch.tensor(gh[:, 1], device=cuda)
    tables = _words_segments(n, np.random.RandomState(max_bin))
    H.reset_launches()
    for segs in tables:
        beg = torch.tensor([s[0] for s in segs], dtype=torch.int32,
                           device=cuda)
        cnt = torch.tensor([s[1] for s in segs], dtype=torch.int32,
                           device=cuda)
        got = H.histogram_from_words(words, g, h, beg, cnt, 28, max_bin,
                                     precision=precision)
        ref = H.histogram_words_plain(words, g, h, beg, cnt, 28, max_bin)
        _check_words(got, ref, g, h, beg, cnt, precision)
    assert H.WORDS_LAUNCHES == {"f32": 0, "f64": 0, precision: len(tables)}
    rng = np.random.RandomState(2)
    X = rng.standard_normal((4000, 8))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(4000) > 0)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": max_bin,
              "tpu_use_f64_hist": precision == "f64",
              "tpu_grow_mode": "level", "verbosity": -1}
    texts = {}
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y.astype(np.float64)),
                         num_boost_round=3, verbose_eval=False)
        assert bst._gbdt.train_path == "level"
        assert (H.WORDS_LAUNCHES[precision] > 0) == (dev == "cuda")
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    if precision == "f64":
        assert texts["cuda"] == texts["cpu"]


@pytest.mark.cuda
def test_words_nonfinite_on_gpu(cuda):
    """NaN, +Inf and -Inf written into g and h: B5 (f32 and f64) against
    its twin cell by cell, NaN, Inf (of its sign) or finite where the
    twin's is, finite cells within 1e-5 x the segment's finite sum of |g|
    (|h|); over the whole rows and a table of segments, some of them
    holding no non-finite value."""
    from lightgbm_tpu_torch.models.level_builder import pack_bin_words
    bins, gh = _mk(40000, 28, 63, seed=9)
    rng = np.random.RandomState(10)
    vals = [float("nan"), float("inf"), float("-inf")]
    for i, r in enumerate(rng.choice(12000, 60, replace=False)):
        gh[r, i % 2] = vals[i % 3]
    words = pack_bin_words(torch.tensor(bins, device=cuda))
    g = torch.tensor(gh[:, 0], device=cuda)
    h = torch.tensor(gh[:, 1], device=cuda)
    for segs in ([(0, 40000)], [(0, 5000), (5000, 20000), (25000, 15000),
                                (11000, 1)]):
        beg = torch.tensor([s[0] for s in segs], dtype=torch.int32,
                           device=cuda)
        cnt = torch.tensor([s[1] for s in segs], dtype=torch.int32,
                           device=cuda)
        ref = H.histogram_words_plain(words, g, h, beg, cnt, 28, 63)
        assert bool(ref[..., :2].isnan().any())
        assert bool(ref[..., :2].isinf().any())
        scale = _words_abs_sums(g, h, beg, cnt)
        for prec in ("f32", "f64"):
            got = H.histogram_from_words(words, g, h, beg, cnt, 28, 63,
                                         precision=prec)
            _assert_hist_nonfinite(got, ref, scale)


@pytest.mark.cuda
def test_words_back_to_back_calls_on_gpu(cuda):
    """Calls in a row on different segment tables, sizes and bin counts,
    enqueued without a synchronize between them, each give the twin's
    result: each segment's last CTA zeroes its part of the scratch and its
    ticket for the next call."""
    from lightgbm_tpu_torch.models.level_builder import pack_bin_words
    bins, gh = _mk(60000, 28, 255, seed=12)
    words = pack_bin_words(torch.tensor(bins, device=cuda))
    g = torch.tensor(gh[:, 0], device=cuda)
    h = torch.tensor(gh[:, 1], device=cuda)
    tables = [([(0, 60000)], 255), ([(0, 30000), (30000, 30000)], 63),
              ([(5, 1), (100, 20000), (40000, 0)], 255),
              ([(i * 250, 250) for i in range(240)], 63),
              ([(0, 60000)], 63), ([(17, 16385), (20000, 16383)], 255)]
    for prec in ("f32", "f64"):
        H.reset_launches()
        calls = []
        for segs, nb in tables:
            beg = torch.tensor([s[0] for s in segs], dtype=torch.int32,
                               device=cuda)
            cnt = torch.tensor([s[1] for s in segs], dtype=torch.int32,
                               device=cuda)
            calls.append((beg, cnt, nb, H.histogram_from_words(
                words, g, h, beg, cnt, 28, nb, precision=prec)))
        assert H.WORDS_LAUNCHES[prec] == len(tables)
        for beg, cnt, nb, out in calls:
            ref = H.histogram_words_plain(words, g, h, beg, cnt, 28, nb)
            _check_words(out, ref, g, h, beg, cnt, prec)


@pytest.mark.cuda
def test_words_ctas_per_sm_on_gpu(cuda):
    """The occupancy calculator fits one 1,024-thread CTA of B5's f32 and
    f64 kernels on an SM at the HIGGS shape (28 features, 63 and 255 bins,
    one feature tile each) and at 137 x 255."""
    ordinal = cuda.index or 0
    num_sms, optin = H._device(ordinal, "histogram_words")
    for F, B, tiles in ((28, 63, 1), (28, 255, 1), (137, 255, 4)):
        for prec in ("f32", "f64"):
            fpb = H.words_launch_shape(10_500_000, F, B, prec, num_sms,
                                       optin)[0]
            assert -(-F // fpb) == tiles
            smem = H.hist_smem(fpb, B, prec)
            assert smem <= optin
            assert H.hist_ctas_per_sm(ordinal, prec, smem,
                                      "histogram_words") == 1


@pytest.mark.cuda
def test_f64_training_on_gpu_equals_cpu(cuda):
    """tpu_use_f64_hist: the trees grown on the card are the CPU's."""
    rng = np.random.RandomState(1)
    X = rng.standard_normal((3000, 8))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(3000) > 0)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "tpu_use_f64_hist": True, "tpu_grow_mode": "leafwise",
              "verbosity": -1}
    texts = {}
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y.astype(np.float64)),
                         num_boost_round=3, verbose_eval=False)
        assert (H.LAUNCHES["f64"] > 0) == (dev == "cuda")
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    assert texts["cuda"] == texts["cpu"]


def _slot_abs_sums(rec, slot_of_chunk, meta, k, wcnt, grad, gh_off=2):
    """[k, 2] sum of |g| and |h| over the valid rows of each slot's
    chunks (the scale of the histogram tolerance); NaN and Inf add
    nothing."""
    g, h = A._payload(rec, wcnt, grad, gh_off)
    valid = A._valid_rows(meta, rec.shape[2])

    def fin(x):
        return torch.where(valid & torch.isfinite(x), x.abs(), 0.0)

    per_chunk = torch.stack([fin(g).sum(1), fin(h).sum(1)], dim=1)
    ok = (slot_of_chunk >= 0) & (slot_of_chunk < k)
    out = torch.zeros((k, 2), dtype=torch.float32, device=rec.device)
    out.index_add_(0, slot_of_chunk[ok].long(), per_chunk[ok])
    return out


def _assert_hist_close(got, ref, scale):
    assert torch.equal(got[..., 2], ref[..., 2])
    err = (got[..., :2] - ref[..., :2]).abs()
    assert bool((err <= 1e-5 * scale[:, None, None, :]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin,force_big_n", [(63, False), (255, False),
                                                 (63, True)])
def test_aligned_kernels_match_twins_on_gpu(cuda, monkeypatch, max_bin,
                                            force_big_n):
    """B2/B3/B4 against their twins on the inputs of a real aligned run on
    the card (COMPACT, and STANDARD under tpu_force_big_n): counts equal,
    moved records equal on the rows they cover, histograms' counts equal
    and g/h within 1e-5 x the slot's sum of |g| (|h|)."""
    rng = np.random.RandomState(4)
    X = rng.standard_normal((60000, 28))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args)))
            return fn(*args, **kw)
        return wrapped

    for name in ("move_pass", "count_pass", "slot_hist_pass"):
        monkeypatch.setattr(AB, name, recorder(name, getattr(AB, name)))
    A.reset_launches()
    bst = tlgb.train({"objective": "binary", "num_leaves": 31,
                      "max_bin": max_bin, "verbosity": -1,
                      "tpu_force_big_n": force_big_n},
                     tlgb.Dataset(X, label=y.astype(np.float64)),
                     num_boost_round=2, verbose_eval=False)
    assert bst._gbdt.train_path == "aligned"
    assert A.LAUNCHES["move_pass"] > 0 and A.LAUNCHES["slot_hist_pass"] > 0
    assert (A.LAUNCHES["count_pass"] > 0) == force_big_n
    for name, args in calls:
        if name == "count_pass":
            assert torch.equal(A.count_pass(*args),
                               A.count_pass_plain(*args))
        elif name == "slot_hist_pass":
            rec, slots, meta, k, _, _, wcnt, _, grad = args
            _assert_hist_close(A.slot_hist_pass(*args),
                               A.slot_hist_pass_plain(*args),
                               _slot_abs_sums(rec, slots, meta, k, wcnt,
                                              grad))
        else:
            rec, meta, hs, k = args[0], args[5], args[7], args[8]
            wcnt, w_used, grad = args[11], args[13], args[14]
            out, hist = A.move_pass(*args)
            ref_a, ref_hist = A.move_pass_plain(
                *args, out=torch.full_like(rec, -1))
            ref_b, _ = A.move_pass_plain(*args, out=torch.full_like(rec, -2))
            cov = ref_a[:, 0] == ref_b[:, 0]
            for u in range(w_used):
                assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
            _assert_hist_close(hist, ref_hist, _slot_abs_sums(
                rec, hs & 0xFFFFFF, meta, k, wcnt, grad))


def _record_aligned(monkeypatch, params, X, y, group=None, rounds=1):
    """Clones of the (args, kwargs) of every B2 and B4 call of an aligned
    run on the card."""
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args),
                          {"gh_off": kw.get("gh_off", 2)}))
            return fn(*args, **kw)
        return wrapped

    for name in ("move_pass", "slot_hist_pass"):
        monkeypatch.setattr(AB, name, recorder(name, getattr(AB, name)))
    A.reset_launches()
    bst = tlgb.train({**params, "tpu_grow_mode": "aligned", "verbosity": -1},
                     tlgb.Dataset(X, label=y, group=group),
                     num_boost_round=rounds, verbose_eval=False)
    assert bst._gbdt.train_path == "aligned"
    assert A.LAUNCHES["move_pass"] > 0 and A.LAUNCHES["slot_hist_pass"] > 0
    return calls


def _poison(rec, wcnt, gh_off, meta, rng, every=997):
    """NaN, +Inf and -Inf into the g and h lanes of about one valid row
    in ``every``, as a user's overflowing objective would leave them."""
    valid = A._valid_rows(meta, rec.shape[2]).nonzero().cpu().numpy()
    pick = valid[rng.choice(len(valid), max(3, len(valid) // every),
                            replace=False)]
    pay = rec[:, wcnt + gh_off:wcnt + gh_off + 2].view(torch.float32)
    vals = [float("nan"), float("inf"), float("-inf")]
    for i, (c, r) in enumerate(pick):
        pay[int(c), i % 2, int(r)] = vals[i % 3]


def _assert_hist_nonfinite(got, ref, scale):
    """Counts equal; each g/h cell NaN, Inf (of its sign) or finite where
    the twin's is; finite cells within 1e-5 x the slot's finite sum of
    |g| (|h|)."""
    assert torch.equal(got[..., 2], ref[..., 2])
    a, b = got[..., :2], ref[..., :2]
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(a.isinf(), b.isinf())
    assert torch.equal(a[b.isinf()], b[b.isinf()])
    fin = torch.isfinite(b)
    lim = 1e-5 * scale[:, None, None, :].expand_as(a)
    assert bool(((a - b).abs()[fin] <= lim[fin]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["standard", "ext"])
def test_aligned_hist_nonfinite_on_gpu(cuda, monkeypatch, layout):
    """B4 (the root) and B2's smaller-child histograms against their twins
    on the STANDARD (binary, tpu_force_big_n) and EXT (lambdarank)
    records of a real aligned run on the card, with NaN, +Inf and -Inf
    written into the g/h lanes: cell by cell, NaN and Inf where the twin's
    f64 sums have them, counts equal, finite cells within 1e-5 x the
    slot's finite sum of |g| (|h|)."""
    rng = np.random.default_rng(7)
    if layout == "standard":
        X = rng.standard_normal((60000, 28))
        y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0)
        calls = _record_aligned(monkeypatch, {
            "objective": "binary", "num_leaves": 31, "max_bin": 63,
            "tpu_force_big_n": True}, X, y.astype(np.float64))
        gh_off = 2
    else:
        counts = rng.integers(20, 120, 600)
        n = int(counts.sum())
        X = rng.standard_normal((n, 20))
        y = np.clip(np.round(X[:, 0] + rng.standard_normal(n)), 0, 4)
        calls = _record_aligned(monkeypatch, {
            "objective": "lambdarank", "num_leaves": 31, "max_bin": 255},
            X, y, group=counts)
        gh_off = 1
    nonfinite = 0
    for name, args, kw in calls:
        assert kw["gh_off"] == gh_off
        if name == "slot_hist_pass":
            rec, slots, meta, k, _, _, wcnt, _, grad = args
            _poison(rec, wcnt, gh_off, meta, rng)
            ref = A.slot_hist_pass_plain(*args, **kw)
            _assert_hist_nonfinite(A.slot_hist_pass(*args, **kw), ref,
                                   _slot_abs_sums(rec, slots, meta, k, wcnt,
                                                  grad, gh_off))
        else:
            rec, meta, hs, k = args[0], args[5], args[7], args[8]
            wcnt, grad = args[11], args[14]
            _poison(rec, wcnt, gh_off, meta, rng)
            _, ref = A.move_pass_plain(*args, **kw)
            _, got = A.move_pass(*args, **kw)
            _assert_hist_nonfinite(got, ref, _slot_abs_sums(
                rec, hs & 0xFFFFFF, meta, k, wcnt, grad, gh_off))
        nonfinite += int((~torch.isfinite(ref[..., :2])).sum())
    assert nonfinite > 0


@pytest.mark.cuda
def test_aligned_l2_compact_on_gpu(cuda, monkeypatch):
    """l2 regression on 0/1 labels, so on COMPACT records, whose g =
    score - label the kernel recomputes and no objective bounds: B4 and
    B2's smaller-child histograms against their twins, counts equal and
    g/h within 1e-5 x the slot's sum of |g| (|h|)."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((60000, 28))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0) \
        .astype(np.float64)
    calls = _record_aligned(monkeypatch, {
        "objective": "regression", "num_leaves": 31, "max_bin": 255}, X, y,
        rounds=2)
    for name, args, kw in calls:
        if name == "slot_hist_pass":
            rec, slots, meta, k, _, _, wcnt, _, grad = args
            assert grad.kind == "l2"
            _assert_hist_close(A.slot_hist_pass(*args),
                               A.slot_hist_pass_plain(*args),
                               _slot_abs_sums(rec, slots, meta, k, wcnt,
                                              grad))
        else:
            rec, meta, hs, k = args[0], args[5], args[7], args[8]
            wcnt, grad = args[11], args[14]
            _assert_hist_close(A.move_pass(*args)[1],
                               A.move_pass_plain(*args)[1],
                               _slot_abs_sums(rec, hs & 0xFFFFFF, meta, k,
                                              wcnt, grad))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", [
    "binary", "regression", "huber", "fair", "poisson", "gamma", "tweedie",
    "xentropy", "regression_l1", "quantile"])
def test_aligned_point_kinds_on_gpu(cuda, monkeypatch, objective):
    """Each pointwise objective on 0/1 labels trains on COMPACT records
    with its kind computed in the kernel; l1 and quantile, which train on
    the host learner, take the records of a binary run with their kind
    swapped in. B4 and B2's smaller-child histograms against their twins:
    counts equal, NaN and Inf where the twin has them, finite g/h within
    1e-5 x the slot's sum of |g| (|h|)."""
    from lightgbm_tpu_torch.ops.objectives import PointGrad
    rng = np.random.default_rng(9)
    X = rng.standard_normal((60000, 28))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0) \
        .astype(np.float64)
    host = objective in ("regression_l1", "quantile")
    calls = _record_aligned(monkeypatch, {
        "objective": "binary" if host else objective, "num_leaves": 31,
        "max_bin": 63}, X, y, rounds=2)
    kind = {"regression": "l2", "regression_l1": "l1"}.get(objective,
                                                            objective)
    if not host and kind not in ("binary", "l2"):
        assert A.POINT_LAUNCHES["slot_hist_pass", kind] > 0
        assert A.POINT_LAUNCHES["move_pass", kind] > 0
    swap = {"l1": PointGrad("l1"), "quantile": PointGrad("quantile", 0.1,
                                                         -0.9)}.get(kind)
    for name, args, kw in calls:
        grad = args[8] if name == "slot_hist_pass" else args[14]
        if swap is not None:
            args = args[:8] + (swap,) if name == "slot_hist_pass" \
                else args[:14] + (swap,) + args[15:]
            grad = swap
        assert grad.kind == kind
        if name == "slot_hist_pass":
            rec, slots, meta, k, _, _, wcnt = args[:7]
            _assert_hist_nonfinite(A.slot_hist_pass(*args),
                                   A.slot_hist_pass_plain(*args),
                                   _slot_abs_sums(rec, slots, meta, k, wcnt,
                                                  grad))
        else:
            rec, meta, hs, k, wcnt = (args[0], args[5], args[7], args[8],
                                      args[11])
            _assert_hist_nonfinite(A.move_pass(*args)[1],
                                   A.move_pass_plain(*args)[1],
                                   _slot_abs_sums(rec, hs & 0xFFFFFF, meta,
                                                  k, wcnt, grad))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_host_learner_f64_on_gpu_equals_cpu(cuda, objective):
    """The host learner's f64 trees (B1's f64 kernel, bit-equal to its
    twin) on the card equal the CPU's, as do the predictions."""
    rng = np.random.default_rng(10)
    X = rng.standard_normal((20000, 12))
    y = X[:, 0] * 3 + X[:, 1] * X[:, 2] + rng.standard_normal(20000)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, "tpu_use_f64_hist": True,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    texts, preds = [], []
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y), num_boost_round=3,
                         verbose_eval=False)
        assert bst._gbdt.train_path == "host"
        assert (H.LAUNCHES["f64"] > 0) == (dev == "cuda")
        t = bst.model_to_string()
        texts.append(t[t.index("Tree=0"):t.index("end of trees")])
        preds.append(bst.predict(X[:2000]))
    assert texts[0] == texts[1]
    np.testing.assert_array_equal(preds[0], preds[1])


@pytest.mark.cuda
def test_slot_hist_ctas_per_sm_on_gpu(cuda):
    """The occupancy calculator fits one CTA of the B2/B4 histogram kernel
    on an SM at the HIGGS (28 features, 63 and 255 bins) and MSLR (137 x
    255) shapes; shared memory beyond the card's fits none."""
    ordinal = cuda.index or 0
    optin = A._lib()["lgbt_aligned_smem_optin"](ordinal)
    for F, B, C in ((28, 63, 1024), (28, 255, 1024), (137, 255, 512)):
        smem = A.slot_hist_smem(C, F, B, optin)[2]
        assert A.slot_hist_ctas_per_sm(ordinal, smem) >= 1
    assert A.slot_hist_ctas_per_sm(ordinal, optin + 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lut_bins", [0, 1024])
def test_rank_kernel_matches_plain_on_gpu(cuda, lut_bins):
    """B6 against its twin over queries of 1 to 5,000 documents (several
    blocks of one CTA each): g and h within 1e-5 x max|g| (max|h|), f32
    summation order being the only difference; with the sigmoid table
    on the queries of at most 512 documents (the longer ones exact)."""
    rng = np.random.default_rng(8)
    counts = np.concatenate([[1, 2, 63, 64, 65, 129, 600, 2000, 5000],
                             rng.integers(80, 160, 300)])
    qb = np.concatenate([[0], np.cumsum(counts)])
    n = int(qb[-1])
    lab = rng.integers(0, 5, n)
    gains = np.asarray([float((1 << i) - 1) for i in range(31)], np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=cuda)

    args = (t(rng.normal(size=n), np.float32), t(qb, np.int32),
            t(lab, np.int32), t(gains[lab], np.float32),
            t(rng.uniform(0.01, 0.2, len(counts)), np.float32),
            t(discount_table(int(counts.max())), np.float32), 1.0, lut_bins,
            512 if lut_bins else 0)
    R.reset_launches()
    g, h = R.lambdarank_grad(*args)
    gp, hp = R.lambdarank_grad_plain(*args)
    assert R.LAUNCHES["lambdarank_grad"] == 1
    assert float((g - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float((h - hp).abs().max()) <= 1e-5 * float(hp.abs().max())


@pytest.mark.cuda
def test_lambdarank_aligned_on_gpu(cuda):
    """lambdarank forced onto the aligned engine (EXT records) on the card:
    B6 once per iteration, B2/B4 launched, and the NDCG of the leaf-wise
    run on the card within 5e-3."""
    rng = np.random.default_rng(3)
    counts = rng.integers(20, 120, 500)
    n = int(counts.sum())
    X = rng.standard_normal((n, 20))
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + rng.standard_normal(n)),
                0, 4)
    params = {"objective": "lambdarank", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, "metric": "ndcg", "eval_at": [10]}
    ndcg = {}
    for mode in ("aligned", "leafwise"):
        R.reset_launches()
        A.reset_launches()
        ds = tlgb.Dataset(X, label=y, group=counts)
        ev = {}
        bst = tlgb.train({**params, "tpu_grow_mode": mode}, ds,
                         num_boost_round=3, valid_sets=[ds],
                         evals_result=ev, verbose_eval=False)
        assert bst._gbdt.train_path == mode
        assert R.LAUNCHES["lambdarank_grad"] >= 3
        if mode == "aligned":
            assert bst._gbdt._aligned_eng.ext
            assert A.LAUNCHES["move_pass"] > 0
            assert A.LAUNCHES["slot_hist_pass"] > 0
        ndcg[mode] = ev["training"]["ndcg@10"][-1]
    assert abs(ndcg["aligned"] - ndcg["leafwise"]) <= 5e-3


def _count_inputs(nc, chunk, num_slots, seed, cuda, W=8, bits=8):
    """Hand-built count pass inputs: random words, routing of every kind
    (missing none / zero / NaN, default left or right, a few copy
    chunks), valid rows from 0 to above the chunk, slots in no order
    (a slot's chunks apart) and out of range on either side."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(-2**31, 2**31 - 1, size=(nc, W, chunk),
                       dtype=np.int64).astype(np.int32)
    bpw = 32 // bits
    shift = bits * rng.integers(0, bpw, nc)
    r1 = (rng.integers(0, 1 << bits, nc) | (shift << A.R_SHIFT)
          | (rng.integers(0, 2, nc) << A.R_DL)
          | (rng.integers(0, 3, nc) << A.R_MT)
          | ((rng.random(nc) < 0.05).astype(np.int64) << A.R_COPY))
    r2 = A.pack_route2(rng.integers(0, 1 << bits, nc),
                       rng.integers(2, (1 << bits) + 1, nc))
    cnt = rng.integers(0, chunk + 1, nc)
    cnt[rng.random(nc) < 0.1] = 0
    cnt[rng.random(nc) < 0.05] = chunk + 9       # clamped to the chunk
    meta = cnt | (rng.integers(0, 2, nc) << A.META_FIRST)
    kslots = rng.integers(-3, num_slots + 3, nc)
    wsel = rng.integers(0, W, nc)
    t = [torch.tensor(a.astype(np.int32), device=cuda)
         for a in (r1, r2, meta, wsel, kslots)]
    return (torch.tensor(rec, device=cuda), *t, num_slots, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("num_slots", [1, 200])
@pytest.mark.parametrize("chunk", [256, 1024, 250])
def test_count_pass_matches_twin_on_gpu(cuda, chunk, num_slots):
    """B3's one launch (persistent grid, warps over whole chunks, shared
    counters, the last CTA writes) against its twin on hand-built inputs:
    chunks skipped by kslots out of range, empty chunks, slots whose
    chunks are not neighbours, chunks of 256 and 1,024 rows (16-byte
    loads) and 250 (word loads); equal after a first call on other shapes
    left its scratch, and two calls in a row bit-equal."""
    A.count_pass(*_count_inputs(57, 512, 300, 5, cuda))      # other shapes
    args = _count_inputs(900, chunk, num_slots, chunk + num_slots, cuda)
    A.reset_launches()
    got = A.count_pass(*args)
    again = A.count_pass(*args)
    ref = A.count_pass_plain(*args)
    assert A.LAUNCHES["count_pass"] == 2
    assert got.shape == (num_slots,) and int(ref.sum()) > 0
    assert torch.equal(got, ref) and torch.equal(again, ref)


@pytest.mark.cuda
def test_count_pass_edges_on_gpu(cuda):
    """No chunk: zero counts; no slot: an empty result and no launch;
    a scratch left by a call with more slots serves one with fewer."""
    args = _count_inputs(40, 256, 7, 3, cuda)
    A.reset_launches()
    empty = (args[0][:0], *(a[:0] for a in args[1:6]), 7, 8)
    assert torch.equal(A.count_pass(*empty),
                       torch.zeros(7, dtype=torch.int32, device=cuda))
    assert A.count_pass(*args[:6], 0, 8).shape == (0,)
    assert A.LAUNCHES["count_pass"] == 1
    for k in (300, 7, 1):
        a = (*args[:6], k, 8)
        assert torch.equal(A.count_pass(*a), A.count_pass_plain(*a))


@pytest.mark.cuda
def test_count_pass_one_launch_on_gpu(cuda):
    """A count pass call puts one kernel on its stream and nothing else
    (no zeroing): the nodes of a captured CUDA graph of the wrapper."""
    args = _count_inputs(300, 1024, 64, 9, cuda)
    assert graph_launches(lambda: A.count_pass(*args)) == {
        "kernels": 1, "memsets": 0, "other": 0}


def _partition_calls(monkeypatch, layout):
    """The B2 calls of a real aligned tree on the card: COMPACT records
    (binary, 63 bins) or EXT (lambdarank, 255 bins)."""
    rng = np.random.default_rng(11)
    if layout == "compact":
        X = rng.standard_normal((60000, 28))
        y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0) \
            .astype(np.float64)
        params, group = {"objective": "binary", "num_leaves": 31,
                         "max_bin": 63}, None
    else:
        group = rng.integers(80, 160, 300)
        X = rng.standard_normal((int(group.sum()), 40))
        y = np.clip(np.round(X[:, 0] + rng.standard_normal(len(X))), 0, 4)
        params = {"objective": "lambdarank", "num_leaves": 31,
                  "max_bin": 255}
    calls = _record_aligned(monkeypatch, params, X, y, group, rounds=2)
    return [(args, kw) for name, args, kw in calls if name == "move_pass"]


def _check_partition(args, cbits=None):
    """The partition alone against the twin: records bit-equal in the used
    lanes of every row the new layout covers, every other word as the
    buffer held it; each slot's children's map holds the rows the twin's
    smaller-child histogram counts. ``cbits``: the round's bitset table."""
    rec, r1, r2, bl, br, meta, wsel, hs, k = args[:9]
    bits, w_used = args[12], args[13]
    out = torch.full_like(rec, -1)
    nslot, ncnt = A._move_partition_cuda(
        rec, r1, r2, bl, br, meta, wsel, hs, k, bits, w_used, out,
        0 if cbits is None else cbits.data_ptr())
    ref_a, ref_hist = A.move_pass_plain(*args, out=torch.full_like(rec, -1),
                                        cbits=cbits)
    ref_b, _ = A.move_pass_plain(*args, out=torch.full_like(rec, -2),
                                 cbits=cbits)
    torch.cuda.synchronize()
    cov = ref_a[:, 0] == ref_b[:, 0]
    for u in range(w_used):
        assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
    assert bool((out[:, 0][~cov] == -1).all())
    assert bool((out[:, w_used:] == -1).all())
    rows = ref_hist[:, 0, :, 2].sum(1).long()
    mapped = ncnt > 0
    got = torch.zeros(k, dtype=torch.long, device=rec.device)
    got.index_add_(0, nslot[mapped].long(), ncnt[mapped].long())
    assert torch.equal(got, rows)
    return out, nslot, ncnt


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["compact", "ext"])
def test_partition_matches_twin_on_gpu(cuda, monkeypatch, layout):
    """B2's one-launch partition (ticket, staged lanes, look-back) against
    the twin on every move of two aligned trees, COMPACT and EXT; a second
    call on the same inputs gives the same bits (the ticket and flags
    start from zero each call)."""
    calls = _partition_calls(monkeypatch, layout)
    assert len(calls) >= 4
    for args, kw in calls:
        first = _check_partition(args)
        again = _check_partition(args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_partition_lane_groups_on_gpu(cuda, monkeypatch):
    """With room for only 3 lanes a stage the partition stages and stores
    the used lanes in turn, and ranks from global memory when the split
    word is not in the first group: the same records and map."""
    calls = _partition_calls(monkeypatch, "compact")
    real = A.move_smem

    def three(C, w_used, optin):
        lanes, smem = real(C, w_used, optin)
        return 3, smem - 4 * (lanes - 3) * C

    for args, kw in calls[:4]:
        want = _check_partition(args)
        monkeypatch.setattr(A, "move_smem", three)
        got = _check_partition(args)
        monkeypatch.setattr(A, "move_smem", real)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def _cat_data(n, seed):
    """Three categorical columns (200, 7 and 40 codes, effects random in
    the code) beside seven numerical ones: at 255 bins the bitsets reach
    every word."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 10))
    codes = [200, 7, 40]
    for j, nc in enumerate(codes):
        X[:, j] = rng.integers(0, nc, n)
    m = sum(rng.standard_normal(nc)[X[:, j].astype(int)]
            for j, nc in enumerate(codes)) + X[:, 3]
    y = (m + rng.standard_normal(n) > 0).astype(np.float64)
    return X, y


def _cat_count_inputs(nc, chunk, num_slots, seed, cuda, bits):
    """`_count_inputs` with about two in five chunks categorical (the
    R_CAT bit of the route word; copy chunks among them) and a random
    bitset table of num_slots + 1 rows, every word of it set at random."""
    args = _count_inputs(nc, chunk, num_slots, seed, cuda, bits=bits)
    rng = np.random.default_rng(seed + 1)
    cat = torch.tensor((rng.random(nc) < 0.4).astype(np.int32) << A.R_CAT,
                       device=cuda)
    cbits = torch.tensor(rng.integers(-2**31, 2**31 - 1, (num_slots + 1) * 8,
                                      dtype=np.int64).astype(np.int32),
                         device=cuda)
    return (args[0], args[1] | cat, *args[2:]), cbits


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("chunk", [256, 1024, 250])
def test_count_pass_cat_matches_twin_on_gpu(cuda, chunk, bits):
    """B3 routes categorical chunks by their row of the bitset table (the
    chunk's 8 words shuffled from lanes 0-7), numerical and copy chunks
    as before, bit-equal to its twin, at 4-, 6- and 8-bit bins and with
    16-byte and word loads; one kernel a call, nothing else."""
    args, cbits = _cat_count_inputs(900, chunk, 200, chunk + bits, cuda,
                                    bits)
    A.reset_launches()
    got = A.count_pass(*args, cbits=cbits)
    ref = A.count_pass_plain(*args, cbits=cbits)
    assert A.LAUNCHES["count_pass"] == A.LAUNCHES["count_pass_cat"] == 1
    assert torch.equal(got, ref)
    assert not torch.equal(ref, A.count_pass_plain(*args))
    assert torch.equal(A.count_pass(*args), A.count_pass_plain(*args))
    assert graph_launches(lambda: A.count_pass(*args, cbits=cbits)) == {
        "kernels": 1, "memsets": 0, "other": 0}


def _cat_partition_calls(monkeypatch, layout):
    """The B2 calls (args, round's bitset table) of two aligned trees on
    the card, on categorical data at 255 bins: COMPACT records, or
    STANDARD under tpu_force_big_n."""
    X, y = _cat_data(60000, 12)
    calls = []

    def recorder(fn):
        def wrapped(*args, **kw):
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args), kw["cbits"].clone()))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(AB, "move_pass", recorder(AB.move_pass))
    bst = tlgb.train({"objective": "binary", "num_leaves": 31,
                      "max_bin": 255, "verbosity": -1,
                      "categorical_feature": "0,1,2",
                      "tpu_force_big_n": layout == "standard"},
                     tlgb.Dataset(X, label=y), num_boost_round=2,
                     verbose_eval=False)
    assert bst._gbdt.train_path == "aligned"
    assert bst._gbdt._aligned_eng.compact == (layout == "compact")
    assert sum(t.num_cat for t in bst.trees) > 0
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["compact", "standard"])
def test_partition_cat_matches_twin_on_gpu(cuda, monkeypatch, layout):
    """B2's partition routes categorical chunks by their split's row of the
    bitset table (8 words in shared memory): bit-equal to the twin on
    every move of two categorical trees, COMPACT and STANDARD; one memset
    and one kernel a call."""
    calls = _cat_partition_calls(monkeypatch, layout)
    assert any(bool(((args[1] >> A.R_CAT) & 1).any()) for args, _ in calls)
    for args, cbits in calls:
        _check_partition(args, cbits)
    args, cbits = calls[-1]
    rec, r1, r2, bl, br, meta, wsel, hs, k = args[:9]
    out = torch.empty_like(rec)
    assert graph_launches(lambda: A._move_partition_cuda(
        rec, r1, r2, bl, br, meta, wsel, hs, k, args[12], args[13], out,
        cbits.data_ptr())) == {"kernels": 1, "memsets": 1, "other": 0}


def _cat_move_inputs(seed, chunk, cuda, nblocks=60):
    """Hand-built move inputs over random 8-bit bin words: blocks of 1 to
    4 chunks (the last one partial), each categorical (the R_CAT bit; its
    row of a random bitset table whose 8 words all hold bits),
    numerical (every missing type, either default side) or unsplit
    (copy), the smaller side random; the new layout from the twin's own
    left counts of each block, so that every destination is the one the
    engine would give."""
    rng = np.random.default_rng(seed)
    W, wcnt, bits = 8, 4, 8
    sizes = rng.integers(1, 5, nblocks)
    n_in = int(sizes.sum())
    nc = n_in + 2 * nblocks + 2
    rec = rng.integers(-2**31, 2**31 - 1, (nc, W, chunk),
                       dtype=np.int64).astype(np.int32)
    r1 = np.full(nc, 1 << A.R_COPY, np.int64)
    r2 = np.zeros(nc, np.int64)
    meta = np.zeros(nc, np.int64)
    wsel = np.zeros(nc, np.int64)
    hs = np.full(nc, nblocks, np.int64)
    kind = rng.integers(0, 3, nblocks)      # numerical, categorical, copy
    blocks, c = [], 0
    for b, (size, kd) in enumerate(zip(sizes, kind)):
        cnt = np.full(size, chunk)
        cnt[-1] = rng.integers(1, chunk + 1)
        word = (int(rng.integers(0, 256)) | (8 * int(rng.integers(0, 4))
                                             << A.R_SHIFT)
                | int(rng.integers(0, 2)) << A.R_DL
                | int(rng.integers(0, 3)) << A.R_MT)
        word |= {1: 1 << A.R_CAT, 2: 1 << A.R_COPY}.get(int(kd), 0)
        for i in range(size):
            r1[c + i] = word
            meta[c + i] = (cnt[i] | (i == 0) << A.META_FIRST
                           | (i == size - 1) << A.META_LAST)
        r2[c:c + size] = A.pack_route2(int(rng.integers(0, 256)),
                                       int(rng.integers(2, 257)))
        wsel[c:c + size] = rng.integers(0, wcnt)
        if kd != 2:
            hs[c:c + size] = b | int(rng.integers(0, 2)) << 24
        blocks.append((c, size, kd))
        c += size
    cbits = torch.tensor(rng.integers(-2**31, 2**31 - 1, (nblocks + 1) * 8,
                                      dtype=np.int64).astype(np.int32))
    t = {k: torch.tensor(v.astype(np.int32)) for k, v in dict(
        r1=r1, r2=r2, meta=meta, wsel=wsel, hs=hs).items()}
    rec_t = torch.tensor(rec)
    binv = A._split_bins(rec_t, t["r1"], t["wsel"], bits)
    valid = A._valid_rows(t["meta"], chunk)
    left = A.goes_left(binv, t["r1"][:, None], t["r2"][:, None], valid,
                       A._cat_words(cbits, t["hs"] & 0xFFFFFF, binv))
    lcnt = left.sum(1).numpy()
    basel = np.zeros(nc, np.int64)
    baser = np.zeros(nc, np.int64)
    nxt = 0
    for c, size, kd in blocks:
        if kd == 2:
            basel[c:c + size] = nxt + np.arange(size)
            nxt += size
            continue
        nl = int(lcnt[c:c + size].sum())
        nv = int((meta[c:c + size] & A.META_CNT_MASK).sum())
        basel[c:c + size] = nxt
        nxt += -(-nl // chunk)
        baser[c:c + size] = nxt
        nxt += -(-(nv - nl) // chunk)
    assert nxt <= nc
    dev = [torch.tensor(a.astype(np.int32), device=cuda)
           for a in (r1, r2, basel, baser, meta, wsel, hs)]
    args = (torch.tensor(rec, device=cuda), *dev, nblocks, 4 * wcnt,
            1 << bits, wcnt, bits, W, None)
    return args, cbits.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 1024])
def test_partition_cat_random_on_gpu(cuda, chunk):
    """B2's partition on hand-built blocks of random words with random
    bitsets that use all 8 words, categorical, numerical and copy chunks
    mixed: bit-equal to the twin, the children's map as the twin's."""
    for seed in range(3):
        args, cbits = _cat_move_inputs(seed, chunk, cuda)
        assert bool(((args[1] >> A.R_CAT) & 1).any())
        _check_partition(args, cbits)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["leafwise", "level"])
def test_f64_categorical_training_on_gpu_equals_cpu(cuda, mode):
    """tpu_use_f64_hist with categorical features: the trees grown on the
    card (the categorical scan in torch ops on the card, the bitset
    routing of the leaf-wise partition and of the level builder) are the
    CPU's."""
    X, y = _cat_data(4000, 2)
    texts = {}
    for dev in ("cuda", "cpu"):
        bst = tlgb.train({"objective": "binary", "num_leaves": 15,
                          "max_bin": 255, "tpu_use_f64_hist": True,
                          "tpu_grow_mode": mode, "verbosity": -1,
                          "categorical_feature": "0,1,2",
                          "cat_smooth": 1.0, "min_data_per_group": 10,
                          "device_type": dev},
                         tlgb.Dataset(X, label=y), num_boost_round=3,
                         verbose_eval=False)
        assert bst._gbdt.train_path == mode
        assert sum(t.num_cat for t in bst.trees) > 0
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    assert texts["cuda"] == texts["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("lut_bins", [0, 1024])
def test_rank_kernel_once_and_deterministic_on_gpu(cuda, lut_bins):
    """B6 on MSLR-shaped queries (80-159 documents, packed into short
    items), long ones (600, 5,000), a short query with a label of 40 (the
    long walk) and offsets that leave documents out: within 1e-5 x
    max|g| (max|h|) of the twin, documents outside every query 0, and
    two calls bit-equal."""
    rng = np.random.default_rng(9)
    counts = np.concatenate([rng.integers(80, 160, 200), [600, 50, 5000],
                             rng.integers(1, 40, 20)])
    qb = np.concatenate([[7], 7 + np.cumsum(counts)])
    n = int(qb[-1]) + 5
    lab = rng.integers(0, 5, n)
    lab[qb[201] + 3] = 40
    gains = np.asarray([float((1 << min(i, 30)) - 1) for i in range(41)],
                       np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=cuda)

    args = (t(rng.normal(size=n), np.float32), t(qb, np.int32),
            t(lab, np.int32), t(gains[lab], np.float32),
            t(rng.uniform(0.01, 0.2, len(counts)), np.float32),
            t(discount_table(int(counts.max())), np.float32), 1.0, lut_bins,
            512 if lut_bins else 0)
    work = R.rank_work(qb, lab).to(cuda)
    assert not work.covers
    R.reset_launches()
    g, h = R.lambdarank_grad(*args, work=work)
    g2, h2 = R.lambdarank_grad(*args, work=work)
    gp, hp = R.lambdarank_grad_plain(*args)
    assert R.LAUNCHES["lambdarank_grad"] == 2
    assert torch.equal(g, g2) and torch.equal(h, h2)
    assert float((g - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float((h - hp).abs().max()) <= 1e-5 * float(hp.abs().max())
    assert not g[:7].any() and not g[-5:].any() and not h[-5:].any()


def _proto_records(nc, chunk, seed, cuda):
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 2**31 - 1, size=(nc, P.W, chunk), dtype=np.int32)
    rec[:, P.LG] = rng.standard_normal((nc, chunk)).astype(np.float32) \
        .view(np.int32)
    rec[:, P.LH] = np.abs(rng.standard_normal((nc, chunk))) \
        .astype(np.float32).view(np.int32)
    return torch.tensor(rec, device=cuda), rng


@pytest.mark.cuda
@pytest.mark.parametrize("b_pad", [256, 64, 16])
@pytest.mark.parametrize("chunk", [256, 512, 250])
def test_proto_slot_hist_matches_plain_on_gpu(cuda, chunk, b_pad):
    """P1 against its twin over partial chunks (odd counts, and counts
    below 0 or above the chunk) whose slots revisit earlier slots (the
    last run wins), skip a slot and leave the range, with kept runs that
    cross the kernel's tiles; chunks of 256, 512 and 250 rows: counts
    equal, g/h within 1e-5 x the largest |sum|."""
    nc = 160
    rec, rng = _proto_records(nc, chunk, 11 + chunk, cuda)
    # runs of 20 chunks: slot 1's only run spans chunks 60-79 across the
    # tiles of 64 (chunks of 256), 32 (512) and 65 (250) chunks
    slots = np.repeat(np.array([0, 3, 0, 1, 3, -1, 2, 9], np.int32), 20)
    cnts = rng.integers(-5, chunk + 40, nc).astype(np.int32)
    cnts[rng.random(nc) < 0.5] |= 1
    args = (rec, torch.tensor(slots, device=cuda),
            torch.tensor(cnts, device=cuda), 5, 28, b_pad, 4)
    P.reset_launches()
    got = P.slot_hist(*args)
    ref = P.slot_hist_plain(*args)
    assert P.LAUNCHES["slot_hist"] == 1
    assert torch.equal(got[..., 2], ref[..., 2])
    assert not bool(got[4].any())
    scale = max(float(ref[..., :2].abs().max()), 1.0)
    assert float((got[..., :2] - ref[..., :2]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_proto_slot_hist_nonfinite_on_gpu(cuda):
    """P1 with NaN, +Inf and -Inf among g and h, in the kept runs of some
    slots and in a dropped run of another: each cell is NaN, Inf (of its
    sign) or finite where its twin's is; counts equal; the finite cells
    within 1e-5 x the largest finite |sum|."""
    nc, chunk = 96, 256
    rec, rng = _proto_records(nc, chunk, 21, cuda)
    pay = rec[:, P.LG:P.LH + 1].view(torch.float32)
    # runs of 8 chunks; the last run of each slot is kept. Chunk 3 (slot
    # 0's dropped run): NaN g; 18 (slot 0's kept run): NaN g; 33 and 36
    # (slot 3): +Inf and -Inf h in rows with the same bins, so their
    # cells are NaN; 50 (slot 1's kept run): +Inf g; the rest finite
    pay[3, 0, 9] = float("nan")
    pay[18, 0, 5] = float("nan")
    pay[33, 1, 7] = float("inf")
    pay[36, 1, 100] = float("-inf")
    rec[36, :P.NWORDS, 100] = rec[33, :P.NWORDS, 7]
    pay[50, 0, 0] = float("inf")
    slots = np.repeat(np.array([0, 1, 0, 2, 3, 2, 1, 4, 5, 6, 7, 5],
                               np.int32), 8)
    cnts = np.full(nc, chunk, np.int32)
    args = (rec, torch.tensor(slots, device=cuda),
            torch.tensor(cnts, device=cuda), 8, 28, 256, 4)
    got = P.slot_hist(*args)
    ref = P.slot_hist_plain(*args)
    a, b = got[..., :2], ref[..., :2]
    assert bool(b.isnan().any()) and bool(b.isinf().any())
    assert torch.equal(got[..., 2], ref[..., 2])
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(a.isinf(), b.isinf())
    assert torch.equal(a[b.isinf()], b[b.isinf()])
    fin = torch.isfinite(b)
    scale = max(float(b[fin].abs().max()), 1.0)
    assert float((a[fin] - b[fin]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_proto_slot_hist_ctas_per_sm_on_gpu(cuda):
    """The CUDA occupancy calculator fits at least one of P1's CTAs on an
    SM at every b_pad, and never fewer as b_pad falls; shared memory
    beyond the card's fits none, and the launch shape raises there."""
    ordinal = cuda.index or 0
    ctas = [P.slot_hist_ctas_per_sm(ordinal, P.slot_hist_smem(256, 28, b)[1])
            for b in (256, 64, 16)]
    assert ctas[0] >= 1 and ctas == sorted(ctas)
    assert P.slot_hist_ctas_per_sm(ordinal, 1 << 20) == 0
    with pytest.raises(ValueError, match="shared memory"):
        P.slot_hist_launch_shape(100, 256, 28, 256, 0, 132)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 512])
def test_proto_move_matches_plain_on_gpu(cuda, chunk):
    """P2 against its twin over blocks of 1 to 40 chunks (one ends without
    its last bit, one reads word lane 7), both written into an output
    filled with -1: equal everywhere."""
    rec, rng = _proto_records(100, chunk, 12, cuda)
    params = np.zeros((100, 8), np.int32)
    params[:, P.P_CNT] = rng.integers(0, chunk + 1, 100)
    params[:, P.P_SHIFT] = rng.integers(0, 32, 100)
    params[:, P.P_THR] = rng.integers(0, 256, 100)
    edges = [0, 1, 41, 60, 61, 80, 100]
    dest = 0
    for blk, (c0, c1) in enumerate(zip(edges[:-1], edges[1:])):
        params[c0:c1, P.P_WSEL] = 7 if blk == 2 else blk % P.NWORDS
        params[c0:c1, P.P_SHIFT] = params[c0, P.P_SHIFT]
        params[c0:c1, P.P_THR] = params[c0, P.P_THR]
        span = -(-int(params[c0:c1, P.P_CNT].sum()) // chunk)
        params[c0:c1, P.P_BASEL] = dest
        params[c0:c1, P.P_BASER] = dest + span
        dest += 2 * span + 1
        params[c0, P.P_FIRST] = 1
        params[c1 - 1, P.P_LAST] = blk != 3
    pt = torch.tensor(params, device=cuda)
    P.reset_launches()
    got = P.move(rec, pt, dest, out=torch.full((dest, P.W, chunk), -1,
                                               dtype=torch.int32,
                                               device=cuda))
    ref = P.move_plain(rec, pt, dest, out=torch.full_like(got, -1))
    assert P.LAUNCHES["move"] == 1
    assert torch.equal(got, ref)


def _move_dropped_case(chunk, cuda):
    """(records, params, nc_out) of 60 chunks in three blocks split by a
    last bit alone, counts above the chunk (clamped) among them: a block
    whose right rows start at chunk -2 (its first two right chunks
    dropped), one whose right rows pass nc_out and one whose left rows
    lie past it. A block of n chunks fills at most n chunks a side, so
    the ranges are apart: right from -2, left from 18; 38 and 63; right
    from 88 (past nc_out from 89 on), left from 103."""
    nc = 60
    rec, rng = _proto_records(nc, chunk, 13 + chunk, cuda)
    params = np.zeros((nc, 8), np.int32)
    params[:, P.P_CNT] = rng.integers(0, chunk + 1, nc)
    params[::7, P.P_CNT] = chunk + 3
    params[:, P.P_WSEL] = rng.integers(0, P.NWORDS, nc)
    params[:, P.P_SHIFT] = rng.integers(0, 32, nc)
    params[:, P.P_THR] = rng.integers(0, 256, nc)
    for c0, c1, bl, br in ((0, 20, 18, -2), (20, 45, 38, 63),
                           (45, 60, 103, 88)):
        params[c0:c1, P.P_BASEL] = bl
        params[c0:c1, P.P_BASER] = br
        params[c1 - 1, P.P_LAST] = 1
    return rec, torch.tensor(params, device=cuda), 89


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 512, 250])
def test_proto_move_dropped_destinations_on_gpu(cuda, chunk):
    """P2 where destinations leave [0, nc_out) (`_move_dropped_case`),
    with 16-byte stores of four rows (chunks of 256 and 512) and with a
    word a row and lane (250): bit-equal to the twin in an output filled
    with -1."""
    rec, pt, nc_out = _move_dropped_case(chunk, cuda)
    P.reset_launches()
    got = P.move(rec, pt, nc_out, out=torch.full(
        (nc_out, P.W, chunk), -1, dtype=torch.int32, device=cuda))
    ref = P.move_plain(rec, pt, nc_out, out=torch.full_like(got, -1))
    assert P.LAUNCHES["move"] == 1
    assert torch.equal(got, ref)
    assert bool((ref == -1).any()) and bool((ref != -1).any())


@pytest.mark.cuda
def test_proto_move_one_stage_on_gpu(cuda, monkeypatch):
    """With room for one stage only, P2 copies each chunk in after the
    last one's stores: the same bits as the twin, and as two stages."""
    rec, pt, nc_out = _move_dropped_case(512, cuda)
    want = P.move(rec, pt, nc_out, out=torch.full(
        (nc_out, P.W, 512), -1, dtype=torch.int32, device=cuda))
    real = P.move_smem

    def one(C, optin):
        tile, stages, smem = real(C, optin)
        return tile, 1, smem - (stages - 1) * 4 * P.W * C

    monkeypatch.setattr(P, "move_smem", one)
    got = P.move(rec, pt, nc_out, out=torch.full_like(want, -1))
    assert torch.equal(got, want)
    assert torch.equal(got, P.move_plain(rec, pt, nc_out,
                                         out=torch.full_like(want, -1)))


@pytest.mark.cuda
def test_proto_move_one_memset_one_launch_on_gpu(cuda):
    """P2's launch alone puts one memset of its scratch and one kernel on
    its stream: the nodes of a captured CUDA graph; the twin's output."""
    rec, rng = _proto_records(64, 256, 17, cuda)
    params = np.zeros((64, 8), np.int32)
    params[:, P.P_CNT] = 256
    params[:, P.P_WSEL] = 1
    params[:, P.P_SHIFT] = 8
    params[:, P.P_THR] = 127
    params[:, P.P_BASER] = 64
    pt = torch.tensor(params, device=cuda)
    out = torch.full((129, P.W, 256), -1, dtype=torch.int32, device=cuda)
    sc = P.move_scratch(rec)
    assert graph_launches(lambda: P._move_cuda(rec, pt, 129, out, sc)) \
        == {"kernels": 1, "memsets": 1, "other": 0}
    assert torch.equal(out, P.move_plain(rec, pt, 129,
                                         out=torch.full_like(out, -1)))


def _ring_records(n, chunk, left_share, seed, cuda):
    """P3's records: random words (one row in eight goes left), or lane
    0's low byte set so that a row goes left with probability
    ``left_share``, or each chunk has no left row (``"no left"``), all
    but one (``"C-1 left"``: route4c skips positions below C lap after
    lap) or a left row in 8 chunks on average (``"sparse left"``: the
    last 2C left rows span thousands of chunks)."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 2**31 - 1, size=(n, P.W, chunk), dtype=np.int32)
    if left_share is not None:
        if left_share == "no left":
            left = np.zeros((n, chunk), bool)
        elif left_share == "C-1 left":
            left = np.ones((n, chunk), bool)
            left[np.arange(n), rng.integers(0, chunk, n)] = False
        elif left_share == "sparse left":
            left = rng.random((n, chunk)) < 1 / (8 * chunk)
        else:
            left = rng.random((n, chunk)) < left_share
        key = rec[:, 0] & 255
        rec[:, 0] = (rec[:, 0] & ~255) | np.where(left, key & 31,
                                                   32 + key % 224)
    return torch.tensor(rec, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("left_share", [None, 0.9, "no left", "C-1 left",
                                        "sparse left"])
@pytest.mark.parametrize("n", [1, 2, 24, 777, 20000])
@pytest.mark.parametrize("wrap", [False, True])
def test_proto_ring_stage_matches_plain_on_gpu(cuda, wrap, n, left_share):
    """P3's one launch against its twin, both variants, over chunks of 512
    rows: random (one row in eight goes left), nine in ten left, and the
    chunks that stress the walk back from the last chunk (none left, all
    but one, a left row in 8 chunks): the whole staging equal."""
    rec = _ring_records(n, 512, left_share, n, cuda)
    P.reset_launches()
    got = P.ring_stage(rec, wrap)
    assert P.LAUNCHES["compact_roll" if wrap else "route4c"] == 1
    assert torch.equal(got, P.ring_stage_plain(rec, wrap))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [512, 250, 8, 1])
def test_proto_ring_stage_odd_chunks_on_gpu(cuda, chunk):
    """Chunks of 250 and 1 row (word loads), 8 (a warp's segment past the
    chunk's end) and 512; no chunk at all (a zero staging); both
    variants equal to the twin."""
    for n in (0, 3, 5000):
        rec = _ring_records(n, chunk, 0.5 if chunk < 32 else None, chunk,
                            cuda)
        for wrap in (False, True):
            assert torch.equal(P.ring_stage(rec, wrap),
                               P.ring_stage_plain(rec, wrap))


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True])
def test_proto_ring_stage_one_launch_on_gpu(cuda, wrap):
    """A `ring_stage` call puts one kernel on its stream and nothing else
    (no memset): the nodes of a captured CUDA graph of the wrapper."""
    rec = _ring_records(3000, 512, None, 3, cuda)
    assert graph_launches(lambda: P.ring_stage(rec, wrap)) == {
        "kernels": 1, "memsets": 0, "other": 0}


@pytest.mark.cuda
def test_proto_ring_stage_back_to_back_on_gpu(cuda):
    """Calls of other sizes and both variants one after another on one
    stream, read only at the end: each equal to its twin (the scratch
    kept for the stream serves every size, growing with it)."""
    cases = [(n, kind, wrap) for n, kind in ((20000, None), (5, 0.9),
                                             (777, "C-1 left"),
                                             (3000, "sparse left"),
                                             (1, None), (20000, "no left"))
             for wrap in (False, True)]
    recs = {(n, kind): _ring_records(n, 512, kind, n, cuda)
            for n, kind, _ in cases}
    got = [P.ring_stage(recs[(n, kind)], wrap) for n, kind, wrap in cases]
    for (n, kind, wrap), g in zip(cases, got):
        assert torch.equal(g, P.ring_stage_plain(recs[(n, kind)], wrap)), \
            (n, kind, wrap)


def _bag_calls(monkeypatch, layout, max_bin=63):
    """Clones of the (args, kwargs) of every B2, B3 and B4 call of two
    bagged aligned trees on the card (bagging_fraction 0.7): COMPACT
    (binary), STANDARD (binary, tpu_force_big_n) or EXT (lambdarank)."""
    rng = np.random.default_rng(13)
    group = None
    params = {"objective": "binary", "num_leaves": 31, "max_bin": max_bin,
              "bagging_fraction": 0.7, "bagging_freq": 1,
              "tpu_force_big_n": layout == "standard"}
    if layout == "ext":
        group = rng.integers(80, 160, 300)
        X = rng.standard_normal((int(group.sum()), 40))
        y = np.clip(np.round(X[:, 0] + rng.standard_normal(len(X))), 0, 4)
        params.update(objective="lambdarank", max_bin=255)
    else:
        X = rng.standard_normal((60000, 28))
        y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(60000) > 0) \
            .astype(np.float64)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for name in ("move_pass", "count_pass", "slot_hist_pass"):
        monkeypatch.setattr(AB, name, recorder(name, getattr(AB, name)))
    A.reset_launches()
    bst = tlgb.train({**params, "tpu_grow_mode": "aligned", "verbosity": -1},
                     tlgb.Dataset(X, label=y, group=group),
                     num_boost_round=2, verbose_eval=False)
    eng = bst._gbdt._aligned_eng
    assert bst._gbdt.train_path == "aligned" and eng.bagged
    assert eng.bag_lane == (-2 if layout == "compact" else eng.lanes["bag"])
    assert A.LAUNCHES["slot_hist_pass_bag"] == A.LAUNCHES["slot_hist_pass"]
    assert A.LAUNCHES["move_pass_bag"] == A.LAUNCHES["move_pass"] > 0
    assert A.LAUNCHES["count_pass"] == A.LAUNCHES["move_pass"]
    for _, _, kw in calls:
        kw.pop("out", None)
    return eng, calls


def _bag_abs_sums(rec, slot_of_chunk, meta, k, wcnt, grad, gh_off,
                  bag_lane):
    """`_slot_abs_sums` over the in-bag rows."""
    g, h = A._payload(rec, wcnt, grad, gh_off)
    take = A._valid_rows(meta, rec.shape[2]) & A._in_bag(rec, wcnt,
                                                         bag_lane)

    def fin(x):
        return torch.where(take & torch.isfinite(x), x.abs(), 0.0)

    per_chunk = torch.stack([fin(g).sum(1), fin(h).sum(1)], dim=1)
    ok = (slot_of_chunk >= 0) & (slot_of_chunk < k)
    out = torch.zeros((k, 2), dtype=torch.float32, device=rec.device)
    out.index_add_(0, slot_of_chunk[ok].long(), per_chunk[ok])
    return out


def _empty_a_slot(rec, slot_of_chunk, wcnt, bag_lane, k):
    """Take every row of the chunks of slot k - 1 out of the bag."""
    chunks = (slot_of_chunk == k - 1).nonzero()[:, 0]
    if bag_lane == -2:
        rec[chunks, wcnt + 1] &= 0x7FFFFFFF
    else:
        rec[chunks, bag_lane] = 0


def _poison_out_of_bag(rec, wcnt, gh_off, meta, bag_lane, rng):
    """NaN, +Inf and -Inf into the g/h lanes of out-of-bag rows, which
    neither the kernel nor the twin reads."""
    oob = (A._valid_rows(meta, rec.shape[2])
           & ~A._in_bag(rec, wcnt, bag_lane)).nonzero().cpu().numpy()
    pay = rec[:, wcnt + gh_off:wcnt + gh_off + 2].view(torch.float32)
    vals = [float("nan"), float("inf"), float("-inf")]
    for i, (c, r) in enumerate(oob[rng.choice(len(oob), 200,
                                              replace=False)]):
        pay[int(c), i % 2, int(r)] = vals[i % 3]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["compact", "standard", "ext"])
def test_aligned_bag_kernels_match_twins_on_gpu(cuda, monkeypatch, layout):
    """The bag branch of B4 (the root) and of B2's smaller-child
    histograms against their twins on every call of two bagged trees on
    the card, COMPACT (meta bit 31), STANDARD and EXT (the f32 lane):
    counts equal (the bag's), g/h within 1e-5 x the slot's in-bag sum of
    |g| (|h|); then with the last slot's rows all out of the bag (a slot
    of zeros) and, with lane-resident payloads, NaN and Inf in
    out-of-bag rows (skipped by both); moved records equal on the rows
    they cover, the bag with its rows; B3 counts every physical row."""
    eng, calls = _bag_calls(monkeypatch, layout)
    gh_off = eng.gh_off
    rng = np.random.default_rng(3)
    for name, args, kw in calls:
        if name == "count_pass":
            assert torch.equal(A.count_pass(*args, **kw),
                               A.count_pass_plain(*args, **kw))
            continue
        bl = kw["bag_lane"]
        if name == "move_pass":
            rec, meta, hs, k = args[0], args[5], args[7], args[8]
            wcnt, w_used, grad = args[11], args[13], args[14]
            out, got = A.move_pass(*args, **kw)
            ref_a, ref = A.move_pass_plain(
                *args, out=torch.full_like(rec, -1), **kw)
            ref_b, _ = A.move_pass_plain(
                *args, out=torch.full_like(rec, -2), **kw)
            cov = ref_a[:, 0] == ref_b[:, 0]
            for u in range(w_used):
                assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
            _assert_hist_close(got, ref, _bag_abs_sums(
                rec, hs & 0xFFFFFF, meta, k, wcnt, grad, gh_off, bl))
            continue
        rec, slots, meta, k, _, _, wcnt, _, grad = args
        for variant in ("as run", "empty slot"):
            if variant == "empty slot":
                _empty_a_slot(rec, slots, wcnt, bl, k)
                if grad is None:
                    _poison_out_of_bag(rec, wcnt, gh_off, meta, bl, rng)
            got = A.slot_hist_pass(*args, **kw)
            _assert_hist_close(got, A.slot_hist_pass_plain(*args, **kw),
                               _bag_abs_sums(rec, slots, meta, k, wcnt,
                                             grad, gh_off, bl))
        assert float(got[k - 1, ..., 2].sum()) == 0.0
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [63, 255])
def test_count_pass_compact_on_gpu(cuda, monkeypatch, max_bin):
    """B3 on COMPACT records (6-bit and 8-bit bin words), as bagging runs
    it: the physical left counts of every round equal the twin's, and
    the bag bits travel with the rows through each move."""
    eng, calls = _bag_calls(monkeypatch, "compact", max_bin)
    assert eng.bits == (6 if max_bin == 63 else 8)
    counts = [(a, kw) for name, a, kw in calls if name == "count_pass"]
    assert counts
    for args, kw in counts:
        assert torch.equal(A.count_pass(*args, **kw),
                           A.count_pass_plain(*args, **kw))
    in_bag = [int((A._in_bag(a[0], eng.wcnt, -2)
                   & A._valid_rows(a[5], a[0].shape[2])).sum())
              for name, a, _ in calls if name == "move_pass"]
    assert len(set(in_bag)) == 1 and in_bag[0] == int(0.7 * eng.n)


def _mc_data(n, K, seed):
    """n rows of 12 columns (two categorical: 4 and 40 codes) and a label
    of K classes that the columns move."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 12))
    X[:, 10] = rng.integers(0, 4, n)
    X[:, 11] = rng.integers(0, 40, n)
    y = (np.floor((X[:, 0] + 2.5) * K / 5) + X[:, 11] % 2).clip(0, K - 1)
    return X, y


def _mc_calls(monkeypatch, objective, K, bagged, rounds=1, n=60000):
    """Clones of the (args, kwargs) of every B2, B3 and B4 call of a
    K-class aligned run on the card (``auto``, 63 bins, the two
    categorical columns)."""
    X, y = _mc_data(n, K, seed=K)
    params = {"objective": objective, "num_class": K, "num_leaves": 31,
              "max_bin": 63, "verbosity": -1,
              "categorical_feature": "10,11"}
    if bagged:
        params.update(bagging_fraction=0.7, bagging_freq=1)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for name in ("move_pass", "count_pass", "slot_hist_pass"):
        monkeypatch.setattr(AB, name, recorder(name, getattr(AB, name)))
    A.reset_launches()
    bst = tlgb.train(params, tlgb.Dataset(X, label=y),
                     num_boost_round=rounds, verbose_eval=False)
    eng = bst._gbdt._aligned_eng
    assert bst._gbdt.train_path == "aligned" and eng.num_class == K
    assert A.CLASS_LAUNCHES["slot_hist_pass"] \
        == A.LAUNCHES["slot_hist_pass"] == rounds * K
    assert A.CLASS_LAUNCHES["move_pass"] == A.LAUNCHES["move_pass"] > 0
    for _, _, kw in calls:
        kw.pop("out", None)
    return bst, eng, calls


def _mc_abs_sums(rec, slot_of_chunk, meta, k, wcnt, grad, bag_lane):
    """`_slot_abs_sums` of a class's payload over the valid (in-bag)
    rows."""
    g, h = A._payload(rec, wcnt, grad)
    take = A._valid_rows(meta, rec.shape[2])
    if bag_lane != -1:
        take = take & A._in_bag(rec, wcnt, bag_lane, grad.meta_lane)
    per_chunk = torch.stack([torch.where(take, g.abs(), 0.0).sum(1),
                             torch.where(take, h.abs(), 0.0).sum(1)], dim=1)
    ok = (slot_of_chunk >= 0) & (slot_of_chunk < k)
    out = torch.zeros((k, 2), dtype=torch.float32, device=rec.device)
    out.index_add_(0, slot_of_chunk[ok].long(), per_chunk[ok])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("bagged", [False, True])
def test_class_lane_kernels_match_twins_on_gpu(cuda, monkeypatch, objective,
                                               bagged):
    """The class-lane kinds of B4 and of B2's smaller-child histograms
    (softmax reads the probability lanes, one-vs-all the score lanes;
    with the meta bag bit or not) against their twins on every call of a
    7-class iteration on the card: counts equal, g/h within 1e-5 x the
    slot's sum of |g| (|h|); B2's moved records (W = 24 or 16) equal on
    the rows they cover; B3 on the bagged K-class records equal. Two
    iterations: the second's payloads take many values."""
    _, eng, calls = _mc_calls(monkeypatch, objective, 7, bagged, rounds=2)
    kind = "prob" if objective == "multiclass" else "score"
    assert eng.mc_mode == kind and eng.W == (24 if kind == "prob" else 16)
    classes = set()
    for name, args, kw in calls:
        if name == "count_pass":
            assert bagged
            assert torch.equal(A.count_pass(*args, **kw),
                               A.count_pass_plain(*args, **kw))
            continue
        bl = kw["bag_lane"]
        assert bl == (-2 if bagged else -1)
        if name == "move_pass":
            rec, meta, hs, k = args[0], args[5], args[7], args[8]
            wcnt, w_used, grad = args[11], args[13], args[14]
            out, got = A.move_pass(*args, **kw)
            ref_a, ref = A.move_pass_plain(
                *args, out=torch.full_like(rec, -1), **kw)
            ref_b, _ = A.move_pass_plain(
                *args, out=torch.full_like(rec, -2), **kw)
            cov = ref_a[:, 0] == ref_b[:, 0]
            for u in range(w_used):
                assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
            _assert_hist_close(got, ref, _mc_abs_sums(
                rec, hs & 0xFFFFFF, meta, k, wcnt, grad, bl))
            continue
        rec, slots, meta, k, _, _, wcnt, _, grad = args
        assert grad.kind == kind
        classes.add(grad.cls)
        _assert_hist_close(A.slot_hist_pass(*args, **kw),
                           A.slot_hist_pass_plain(*args, **kw),
                           _mc_abs_sums(rec, slots, meta, k, wcnt, grad, bl))
    assert classes == set(range(7))


@pytest.mark.cuda
def test_class_lane_kernel_rejects_bag_lane_on_gpu(cuda):
    """A class kind with an f32 bag lane (no route takes it) is refused
    by the launch, not run."""
    bins = torch.randint(0, 60, (4096, 12), dtype=torch.uint8)
    rec, wcnt, W, cnts, bits = A.pack_records(
        bins.to(cuda), np.zeros(4096), None, 512, compact=True, max_bin=63,
        num_class=3, with_prob=True)
    grad = A.ClassGrad("prob", 0, wcnt + 3, wcnt + 6)
    meta = torch.tensor(cnts, dtype=torch.int32, device=cuda)
    slots = torch.zeros_like(meta)
    with pytest.raises(RuntimeError, match="CUDA error"):
        A.slot_hist_pass(rec, slots, meta, 1, 12, 64, wcnt, bits, grad,
                         bag_lane=wcnt + 3)


@pytest.mark.cuda
def test_partition_of_31_classes_on_gpu(cuda, monkeypatch):
    """31-class softmax records (W = 72, 66 lanes used: more than a stage
    of the partition holds at a chunk of 1,024 rows, so the lanes go in
    turns): every move of an iteration equal to the twin's on the rows it
    covers, the class-lane histograms within the bound."""
    _, eng, calls = _mc_calls(monkeypatch, "multiclass", 31, False,
                              n=40000)
    assert eng.W == 72 and eng.w_used == 66
    lanes, _ = A.move_smem(eng.C, eng.w_used,
                           A._lib()["lgbt_aligned_smem_optin"](0))
    assert lanes < eng.w_used
    moves = [(a, kw) for name, a, kw in calls if name == "move_pass"]
    for args, kw in moves[:40]:
        rec, meta, hs, k = args[0], args[5], args[7], args[8]
        wcnt, w_used, grad = args[11], args[13], args[14]
        out, got = A.move_pass(*args, **kw)
        ref_a, ref = A.move_pass_plain(*args, out=torch.full_like(rec, -1),
                                       **kw)
        ref_b, _ = A.move_pass_plain(*args, out=torch.full_like(rec, -2),
                                     **kw)
        cov = ref_a[:, 0] == ref_b[:, 0]
        for u in range(w_used):
            assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
        _assert_hist_close(got, ref, _mc_abs_sums(
            rec, hs & 0xFFFFFF, meta, k, wcnt, grad, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("mode", ["leafwise", "level"])
def test_multiclass_f64_matches_cpu_on_gpu(cuda, objective, mode):
    """f64 histograms: 3-class trees on the card (leaf-wise, and the
    level builder at max_depth 4) are the CPU's, with both categorical
    columns, bagged on the leaf-wise builder."""
    X, y = _mc_data(20000, 3, seed=5)
    params = {"objective": objective, "num_class": 3, "num_leaves": 15,
              "max_bin": 63, "tpu_use_f64_hist": True, "verbosity": -1,
              "tpu_grow_mode": mode, "categorical_feature": "10,11"}
    if mode == "level":
        params["max_depth"] = 4
    else:
        params.update(bagging_fraction=0.8, bagging_freq=1)
    texts = []
    for dev in ("cuda", "cpu"):
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y), num_boost_round=3,
                         verbose_eval=False)
        t = bst.model_to_string()
        texts.append(t[t.index("Tree=0"):t.index("end of trees")])
    assert texts[0] == texts[1]


@pytest.mark.cuda
def test_multiclass_aligned_on_gpu(cuda):
    """7-class softmax under ``auto`` on the card: the aligned engine, 7
    builds an iteration, no fallback; [N, 7] predictions whose rows sum
    to 1, the card's equal to a CPU predict of the model text; the
    training scores the engine holds are the model's raw predictions."""
    X, y = _mc_data(60000, 7, seed=9)
    bst = tlgb.train({"objective": "multiclass", "num_class": 7,
                      "num_leaves": 31, "max_bin": 63, "verbosity": -1,
                      "categorical_feature": "10,11"},
                     tlgb.Dataset(X, label=y), num_boost_round=4,
                     verbose_eval=False)
    g = bst._gbdt
    assert g.train_path == "aligned" and g._aligned_eng.fallbacks == 0
    assert len(g.aligned_stats) == 28
    p = bst.predict(X[:5000])
    assert p.shape == (5000, 7) and np.allclose(p.sum(1), 1.0, atol=1e-6)
    cpu = tlgb.Booster(model_str=bst.model_to_string(),
                       params={"device_type": "cpu"})
    np.testing.assert_allclose(bst.predict(X[:5000], raw_score=True),
                               cpu.predict(X[:5000], raw_score=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        g._aligned_eng.row_scores_all()[:, :5000].t().cpu().numpy(),
        bst.predict(X[:5000], raw_score=True), rtol=1e-5, atol=1e-5)


def _efb_data(n, seed=0):
    """n rows: 4 dense columns and 7 one-hot blocks of 8 (at most one
    column of a block is 1 in a row), which bundle into a few storage
    columns; the label reads two one-hot columns."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 60))
    X[:, :4] = rng.standard_normal((n, 4))
    for b in range(7):
        pick = rng.randint(0, 9, n)
        on = pick < 8
        X[np.nonzero(on)[0], 4 + 8 * b + pick[on]] = 1.0
    margin = X[:, 0] + 1.5 * (X[:, 9] > 0) - (X[:, 30] > 0)
    y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return X, y


def _efb_calls(monkeypatch, force_big_n, bundle=True):
    """Clones of the (args, kwargs) of every B2 and B3 call of an aligned
    run on the card at 255 bins on `_efb_data`, bundled or (``bundle``
    False: ``enable_bundle=false``) not."""
    X, y = _efb_data(60000)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for name in ("move_pass", "count_pass"):
        monkeypatch.setattr(AB, name, recorder(name, getattr(AB, name)))
    A.reset_launches()
    bst = tlgb.train({"objective": "binary", "num_leaves": 31,
                      "max_bin": 255, "verbosity": -1,
                      "tpu_force_big_n": force_big_n,
                      "enable_bundle": bundle},
                     tlgb.Dataset(X, label=y), num_boost_round=2,
                     verbose_eval=False)
    g = bst._gbdt
    assert g.train_path == "aligned" and g.learner.bundled == bundle
    assert g._aligned_eng.fallbacks == 0
    moves, counts = A.LAUNCHES["move_pass"], A.LAUNCHES["count_pass"]
    assert moves > 0 and (counts > 0) == force_big_n
    assert A.BUNDLED_LAUNCHES == {"move_pass": moves if bundle else 0,
                                  "count_pass": counts if bundle else 0}
    return calls


def _check_efb_calls(calls):
    """Each recorded B2 and B3 call through the kernel and its twin, with
    the call's own ``bundled``: counts and moved records bit-equal, the
    children's histograms within C.7's bound."""
    for name, args, kw in calls:
        kw = {k: v for k, v in kw.items() if k != "out"}
        if name == "count_pass":
            assert torch.equal(A.count_pass(*args, **kw),
                               A.count_pass_plain(*args, **kw))
            continue
        rec, meta, hs, k = args[0], args[5], args[7], args[8]
        wcnt, w_used, grad = args[11], args[13], args[14]
        out, hist = A.move_pass(*args, **kw)
        ref_a, ref_hist = A.move_pass_plain(
            *args, **kw, out=torch.full_like(rec, -1))
        ref_b, _ = A.move_pass_plain(*args, **kw,
                                     out=torch.full_like(rec, -2))
        cov = ref_a[:, 0] == ref_b[:, 0]
        for u in range(w_used):
            assert torch.equal(out[:, u][cov], ref_a[:, u][cov])
        _assert_hist_close(hist, ref_hist, _slot_abs_sums(
            rec, hs & 0xFFFFFF, meta, k, wcnt, grad,
            kw.get("gh_off", 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("force_big_n", [False, True])
def test_bundled_kernels_match_twins_on_gpu(cuda, monkeypatch, force_big_n):
    """The bundled branch of B2's partition and of B3 against their twins
    on every call of a bundled aligned run (COMPACT, and STANDARD under
    tpu_force_big_n): counts and moved records bit-equal, the children's
    histograms within C.7's bound."""
    calls = _efb_calls(monkeypatch, force_big_n)
    assert all(kw.get("bundled") for _, _, kw in calls)
    _check_efb_calls(calls)


@pytest.mark.cuda
def test_unbundled_route_unchanged_on_gpu(cuda, monkeypatch):
    """The same table with ``enable_bundle=false``: every B2 and B3 call
    takes the unbundled instantiation (no bundled launch counted) and
    equals its twin."""
    calls = _efb_calls(monkeypatch, True, bundle=False)
    assert not any(kw.get("bundled") for _, _, kw in calls)
    _check_efb_calls(calls)


@pytest.mark.cuda
def test_f64_bundled_training_on_gpu_equals_cpu(cuda):
    """Bundled data from a CSR matrix, leaf-wise at tpu_use_f64_hist: the
    card's tree sections equal the CPU's, and so do the CSR predictions
    of the two boosters."""
    import scipy.sparse as sp
    X, y = _efb_data(20000, seed=2)
    Xs = sp.csr_matrix(X)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, "tpu_use_f64_hist": True,
              "tpu_grow_mode": "leafwise"}
    out = []
    for dev in ("cuda", "cpu"):
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(Xs, label=y), num_boost_round=3,
                         verbose_eval=False)
        assert bst._gbdt.learner.bundled
        t = bst.model_to_string()
        out.append((t[t.index("Tree=0"):t.index("end of trees")],
                    bst.predict(Xs[:3000], raw_score=True)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
