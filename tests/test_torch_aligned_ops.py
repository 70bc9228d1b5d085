"""The aligned engine's records and kernel twins (lightgbm_tpu_torch/ops/
aligned.py) against the JAX package: `pack_records` bit for bit, and the
plain twins of B2 `move_pass`, B3 `count_pass` and B4 `slot_hist_pass`
against the Pallas kernels in interpret mode, on the inputs of real
rounds of the port's aligned engine (COMPACT and STANDARD layouts)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import aligned as JA
from lightgbm_tpu_torch.models import aligned_builder as AB
from lightgbm_tpu_torch.ops import aligned as TA

N, F, CHUNK = 2500, 6, 256


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2]
          + 0.3 * rng.standard_normal(N)) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("max_bin,bits", [(15, 4), (63, 6), (255, 8)])
@pytest.mark.parametrize("compact", [True, False])
def test_pack_records_bit_equal(max_bin, bits, compact):
    rng = np.random.RandomState(max_bin)
    bins = rng.randint(0, max_bin, (N, F)).astype(np.uint8)
    label = (rng.rand(N) < 0.4).astype(np.float32)
    weight = None if compact else rng.uniform(0.5, 2.0, N)
    ref = JA.pack_records(bins, label, weight, CHUNK, compact=compact,
                          max_bin=max_bin, rid_base=7)
    got = TA.pack_records(torch.tensor(bins), label, weight, CHUNK,
                          compact=compact, max_bin=max_bin, rid_base=7)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    assert got[1:3] == ref[1:3] and got[4] == ref[4] == bits
    np.testing.assert_array_equal(got[3], ref[3])
    assert TA.lane_layout(got[1], compact)[0] == \
        JA.lane_layout(got[1], compact=compact)[0]


def _jax_binary_grad(score, label, weight):
    """BinaryLogloss.point_grad_fn of the JAX package at sigmoid 1 and
    unit label weights (the kernel inlines it for COMPACT records)."""
    sl = jnp.where(label > 0, 1.0, -1.0)
    response = -sl * 1.0 / (1.0 + jnp.exp(sl * 1.0 * score))
    absr = jnp.abs(response)
    return response * 1.0, absr * (1.0 - absr) * 1.0


@pytest.fixture(scope="module", params=["compact", "standard"])
def rounds(request):
    """The kernel calls of two trees of the port's aligned engine (on the
    CPU, through the twins), with their inputs."""
    X, y = _data()
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    params = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
              "verbosity": -1, "tpu_grow_mode": "aligned",
              "tpu_aligned_interpret": True, "tpu_chunk": CHUNK,
              "device_type": "cpu",
              "tpu_force_big_n": request.param == "standard"}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("move_pass", "count_pass", "slot_hist_pass"):
            mp.setattr(AB, name, recorder(name, getattr(AB, name)))
        bst = tlgb.train(params, tlgb.Dataset(X, label=y),
                         num_boost_round=2, verbose_eval=False)
    eng = bst._gbdt._aligned_eng
    assert eng.compact == (request.param == "compact")
    return request.param, eng, calls


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _integer_gh(records, eng, seed):
    """STANDARD records with integer grad/hess lanes: the bf16 hi/lo split
    of the Pallas kernels is exact there."""
    rec = records.clone()
    rng = np.random.RandomState(seed)
    shape = rec[:, 0].shape
    g = torch.tensor(rng.randint(-8, 9, shape).astype(np.float32))
    h = torch.tensor(rng.randint(0, 5, shape).astype(np.float32))
    rec[:, eng.lanes["grad"]] = g.view(torch.int32)
    rec[:, eng.lanes["hess"]] = h.view(torch.int32)
    return rec


def _group(b):
    return 8 if b <= 64 else 4


def test_count_pass_plain_equals_pallas(rounds):
    layout, eng, calls = rounds
    counts = [c for c in calls if c[0] == "count_pass"]
    if layout == "compact":
        assert not counts          # the finder's left counts drive COMPACT
        return
    assert counts
    for _, (rec, r1, r2, meta, wsel, ks, k, bits), _ in counts[:3]:
        got = TA.count_pass_plain(rec, r1, r2, meta, wsel, ks, k, bits)
        ref = JA.count_pass(jnp.asarray(rec.numpy()), *(
            jnp.asarray(_np(a)) for a in (r1, r2, meta, wsel, ks)),
            jnp.zeros((k + 1) * 8, jnp.int32), k, CHUNK, bits=bits,
            interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _covered(args):
    """[NC, C] rows a move writes (the new layout's rows, and the pad rows
    of chunks copied whole): the twin run into two different fills, equal
    where it wrote."""
    outs = []
    for fill in (-1, -2):
        out = torch.full_like(args[0], fill)
        outs.append(TA.move_pass_plain(*args, out=out)[0][:, 0])
    return (outs[0] == outs[1]).numpy()


def test_move_pass_plain_equals_pallas(rounds):
    """Records equal on the rows the new layout covers (used lanes); the
    smaller children's histograms: counts equal, bit-equal with integer
    STANDARD payloads, rtol 2e-4 with COMPACT's recomputed gradients."""
    layout, eng, calls = rounds
    moves = [c for c in calls if c[0] == "move_pass"]
    assert len(moves) >= 3
    for i, (_, args, kw) in enumerate((moves[0], moves[2])):
        (rec, r1, r2, bl, br, meta, wsel, hs, k, F_, B, wcnt, bits,
         w_used, grad) = args
        if layout == "standard":
            rec = _integer_gh(rec, eng, seed=i)
        args = (rec,) + args[1:]
        got_rec, got_hist = TA.move_pass_plain(*args)
        jgrad = _jax_binary_grad if grad is not None else None
        ref_rec, ref_hist = JA.move_pass(
            jnp.asarray(rec.numpy()),
            *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
            jnp.zeros((k + 1) * 8, jnp.int32), CHUNK, rec.shape[1], wcnt, k,
            F_, B, _group(B), bits=bits, grad_fn=jgrad, w_used=w_used,
            interpret=True, subbin=B > 128)
        cov = _covered(args)
        assert cov.sum() >= int((_np(meta) & TA.META_CNT_MASK).sum())
        got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
        for u in range(w_used):
            np.testing.assert_array_equal(got_np[:, u][cov], ref_np[:, u][cov])
        ref_hist = np.asarray(ref_hist)
        got_hist = got_hist.numpy()
        np.testing.assert_array_equal(got_hist[..., 2], ref_hist[..., 2])
        if layout == "standard":
            np.testing.assert_array_equal(got_hist, ref_hist)
        else:
            np.testing.assert_allclose(got_hist, ref_hist, rtol=2e-4,
                                       atol=1e-3)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_slot_hist_pass_plain_equals_pallas(rounds, max_bin):
    """The root pass of the engine's first tree, and the same records
    mapped to three slots with a skipped (dummy) run of chunks."""
    layout, eng, calls = rounds
    _, args, _ = next(c for c in calls if c[0] == "slot_hist_pass")
    rec, slots, meta, _, F_, B, wcnt, bits, grad = args
    if layout == "standard":
        rec = _integer_gh(rec, eng, seed=3)
    if max_bin == 255:
        # the same rows, declared 255 bins wide (bins stay < 64)
        B = 255
    nc = rec.shape[0]
    three = torch.tensor(np.arange(nc) * 4 // nc, dtype=torch.int32)
    for sl, k in ((slots, 1), (three, 3)):
        got = TA.slot_hist_pass_plain(rec, sl, meta, k, F_, B, wcnt, bits,
                                      grad).numpy()
        ref = np.asarray(JA.slot_hist_pass(
            jnp.asarray(rec.numpy()), jnp.asarray(sl.numpy()),
            jnp.asarray(meta.numpy()), k, F_, B, CHUNK, _group(B), wcnt,
            bits=bits,
            grad_fn=_jax_binary_grad if grad is not None else None,
            interpret=True, subbin=B > 128))
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        if layout == "standard":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


def test_wrappers_take_the_twins_on_cpu(rounds):
    """On CPU tensors the wrappers run the twins and count no launch."""
    _, eng, calls = rounds
    TA.reset_launches()
    _, args, kw = next(c for c in calls if c[0] == "move_pass")
    out, hist = TA.move_pass(*args, **kw)
    ref_out, ref_hist = TA.move_pass_plain(*args)
    assert torch.equal(out, ref_out) and torch.equal(hist, ref_hist)
    assert TA.LAUNCHES == {"move_pass": 0, "count_pass": 0,
                           "slot_hist_pass": 0, "move_pass_cat": 0,
                           "count_pass_cat": 0, "move_pass_bag": 0,
                           "slot_hist_pass_bag": 0}


@pytest.mark.parametrize("max_bin,bits", [(15, 4), (63, 6), (255, 8)])
def test_pack_records_ext_bit_equal(max_bin, bits):
    """EXT records (ranking): bin words, then score, grad, hess and rid
    lanes, bit for bit the JAX package's."""
    rng = np.random.RandomState(max_bin + 1)
    bins = rng.randint(0, max_bin, (N, F)).astype(np.uint8)
    label = rng.randint(0, 5, N).astype(np.float32)
    ref = JA.pack_records(bins, label, None, CHUNK, max_bin=max_bin,
                          ext=True, rid_base=7)
    got = TA.pack_records(torch.tensor(bins), label, None, CHUNK,
                          max_bin=max_bin, rid_base=7, ext=True)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    assert got[1:3] == ref[1:3] and got[4] == bits
    np.testing.assert_array_equal(got[3], ref[3])
    wcnt = got[1]
    assert TA.lane_layout(wcnt, ext=True) == JA.lane_layout(wcnt, ext=True)
    assert TA.lane_layout(wcnt, ext=True)[0] == {
        "score": wcnt, "grad": wcnt + 1, "hess": wcnt + 2, "rid": wcnt + 3}


@pytest.fixture(scope="module")
def ext_rounds():
    """The kernel calls of two lambdarank trees of the port's aligned
    engine on EXT records (on the CPU, through the twins)."""
    rng = np.random.default_rng(2)
    counts = rng.integers(10, 80, 60)
    n = int(counts.sum())
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = np.minimum((X[:, 0] + rng.standard_normal(n) > 0.5) * 2
                   + (X[:, 1] > 1.0), 4).astype(np.float32)
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    params = {"objective": "lambdarank", "num_leaves": 8, "max_bin": 63,
              "min_data_in_leaf": 10, "verbosity": -1, "metric": "none",
              "tpu_grow_mode": "aligned", "tpu_aligned_interpret": True,
              "tpu_chunk": CHUNK, "device_type": "cpu"}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("move_pass", "slot_hist_pass"):
            mp.setattr(AB, name, recorder(name, getattr(AB, name)))
        bst = tlgb.train(params, tlgb.Dataset(X, label=y, group=counts),
                         num_boost_round=2, verbose_eval=False)
    eng = bst._gbdt._aligned_eng
    assert eng.ext and eng.gh_off == 1
    assert all(kw["gh_off"] == 1 for _, _, kw in calls)
    return eng, calls


def test_ext_move_pass_plain_equals_pallas(ext_rounds):
    """The move pass on EXT records (gh_off=1) with integer grad/hess
    lanes: records equal on the rows the new layout covers, histograms
    bit-equal."""
    eng, calls = ext_rounds
    moves = [c for c in calls if c[0] == "move_pass"]
    assert len(moves) >= 3
    for i, (_, args, kw) in enumerate((moves[0], moves[2])):
        (rec, r1, r2, bl, br, meta, wsel, hs, k, F_, B, wcnt, bits,
         w_used, grad) = args
        rec = _integer_gh(rec, eng, seed=10 + i)
        args = (rec,) + args[1:]
        got_rec, got_hist = TA.move_pass_plain(*args, gh_off=1)
        ref_rec, ref_hist = JA.move_pass(
            jnp.asarray(rec.numpy()),
            *(jnp.asarray(_np(a)) for a in (r1, r2, bl, br, meta, wsel, hs)),
            jnp.zeros((k + 1) * 8, jnp.int32), CHUNK, rec.shape[1], wcnt, k,
            F_, B, _group(B), bits=bits, grad_fn=None, w_used=w_used,
            gh_off=1, interpret=True, subbin=B > 128)
        outs = [TA.move_pass_plain(*args, out=torch.full_like(rec, fill),
                                   gh_off=1)[0][:, 0] for fill in (-1, -2)]
        cov = (outs[0] == outs[1]).numpy()
        got_np, ref_np = got_rec.numpy(), np.asarray(ref_rec)
        for u in range(w_used):
            np.testing.assert_array_equal(got_np[:, u][cov], ref_np[:, u][cov])
        np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))


@pytest.mark.parametrize("max_bin", [63, 255])
def test_ext_slot_hist_pass_plain_equals_pallas(ext_rounds, max_bin):
    """The root pass of the first EXT tree (gh_off=1), with integer
    grad/hess lanes, and declared 255 bins wide: bit-equal."""
    eng, calls = ext_rounds
    _, args, _ = next(c for c in calls if c[0] == "slot_hist_pass")
    rec, slots, meta, k, F_, B, wcnt, bits, grad = args
    rec = _integer_gh(rec, eng, seed=5)
    B = max_bin if max_bin == 255 else B
    got = TA.slot_hist_pass_plain(rec, slots, meta, k, F_, B, wcnt, bits,
                                  grad, gh_off=1).numpy()
    ref = np.asarray(JA.slot_hist_pass(
        jnp.asarray(rec.numpy()), jnp.asarray(slots.numpy()),
        jnp.asarray(meta.numpy()), k, F_, B, CHUNK, _group(B), wcnt,
        bits=bits, grad_fn=None, gh_off=1, interpret=True, subbin=B > 128))
    np.testing.assert_array_equal(got, ref)
    # the payload really came from the EXT lanes: wcnt + 1 and + 2
    g = rec[:, wcnt + 1].view(torch.float32)
    valid = TA._valid_rows(meta, rec.shape[2])
    assert got[0, 0, :, 0].sum() == float(g[valid].sum())
