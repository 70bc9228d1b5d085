"""Tests of the port that need the card: the CUDA histogram kernels (B1
and the level builder's B5), the aligned engine's kernels and the
lambdarank kernel against their plain twins, f64 training on the card
against the CPU (leaf-wise and level), the aligned engine on the card
(binary, and lambdarank on EXT records), and the prototype kernels P1-P3
against their twins. They import
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


def _check_partition(args):
    """The partition alone against the twin: records bit-equal in the used
    lanes of every row the new layout covers, every other word as the
    buffer held it; each slot's children's map holds the rows the twin's
    smaller-child histogram counts."""
    rec, r1, r2, bl, br, meta, wsel, hs, k = args[:9]
    bits, w_used = args[12], args[13]
    out = torch.full_like(rec, -1)
    nslot, ncnt = A._move_partition_cuda(rec, r1, r2, bl, br, meta, wsel,
                                         hs, k, bits, w_used, out)
    ref_a, ref_hist = A.move_pass_plain(*args, out=torch.full_like(rec, -1))
    ref_b, _ = A.move_pass_plain(*args, out=torch.full_like(rec, -2))
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
