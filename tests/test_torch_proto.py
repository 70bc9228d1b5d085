"""The port's prototype kernels P1-P3 (`lightgbm_tpu_torch/ops/proto.py`)
on the CPU against the Pallas functions of tools/proto_aligned.py and
tools/proto_roll.py run in interpret mode (the tools' module-level `pl`
swapped, in the test only, for one whose `pallas_call` interprets), and
the port's harnesses driven on the CPU at a small size."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.proto_aligned as TA
import tools.proto_roll as TR
from lightgbm_tpu_torch.ops import proto as P
from lightgbm_tpu_torch.tools import proto_aligned as HA
from lightgbm_tpu_torch.tools import proto_roll as HR

F = 28


@pytest.fixture
def interpret(monkeypatch):
    """tools/proto_aligned.py with its Pallas calls in interpret mode."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(TA, "pl", ns)
    return TA


def _records(nc, chunk, seed):
    """The correctness check's records: random words, normal g and
    |normal| h."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 2**31 - 1, size=(nc, P.W, chunk), dtype=np.int32)
    rec[:, P.LG] = rng.standard_normal((nc, chunk)).astype(np.float32) \
        .view(np.int32)
    rec[:, P.LH] = np.abs(rng.standard_normal((nc, chunk))) \
        .astype(np.float32).view(np.int32)
    return rec, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas_hist(tool, rec, slots, cnts, S, b_pad, group):
    return np.asarray(tool.slot_hist(jnp.asarray(rec), jnp.asarray(slots),
                                     jnp.asarray(cnts), S, F, b_pad,
                                     rec.shape[2], group))


def _assert_hist(got, want):
    """Counts exact; g/h within 1e-5 x max|want| (the harness's own
    tolerance; the Pallas kernel sums bf16 hi/lo halves in f32, the twin
    f32 values in f64)."""
    assert np.array_equal(got[..., 2], want[..., 2])
    scale = max(np.abs(want[..., :2]).max(), 1.0)
    assert np.abs(got[..., :2] - want[..., :2]).max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# P1 slot_hist
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b_pad,group", [(256, 4), (64, 4), (64, 14),
                                         (16, 14)])
def test_slot_hist_matches_pallas(interpret, b_pad, group):
    """The harness's four configurations over partial chunks of 256 rows:
    bins at or above b_pad (most of the random bytes at 64 and 16) add
    nothing in either."""
    rec, rng = _records(12, 256, 1)
    slots = np.repeat(np.arange(4, dtype=np.int32), 3)
    cnts = rng.integers(128, 257, 12).astype(np.int32)
    want = _pallas_hist(interpret, rec, slots, cnts, 4, b_pad, group)
    got = P.slot_hist(_t(rec), _t(slots), _t(cnts), 4, F, b_pad, group)
    _assert_hist(got.numpy(), want)
    if b_pad == 256:
        _assert_hist(got.numpy(), P.slot_hist_ref(rec, slots, cnts, 4, F,
                                                  256))


def test_slot_hist_revisited_slot_keeps_last_run(interpret):
    """Slots [0, 0, 2, 2, 0, 0]: the Pallas kernel zeroes slot 0's block
    when its second run starts, so slot 0 holds chunks 4 and 5 only; slot
    1 is never visited (undefined there, zero in the port)."""
    rec, rng = _records(6, 256, 2)
    slots = np.array([0, 0, 2, 2, 0, 0], np.int32)
    cnts = rng.integers(100, 257, 6).astype(np.int32)
    want = _pallas_hist(interpret, rec, slots, cnts, 3, 256, 4)
    got = P.slot_hist(_t(rec), _t(slots), _t(cnts), 3, F, 256).numpy()
    for s in (0, 2):
        _assert_hist(got[s], want[s])
    assert not got[1].any()
    last_run = P.slot_hist_ref(rec[4:], slots[4:], cnts[4:], 3, F, 256)
    _assert_hist(got[0], last_run[0])
    assert got[0, ..., 2].sum() == F * cnts[4:].sum()


def test_slot_hist_drops_chunks_outside_the_slots():
    """A chunk whose slot lies outside [0, num_slots) adds nothing, and a
    negative or oversized count clips to [0, C]."""
    rec, _ = _records(4, 64, 3)
    slots = np.array([0, 5, -1, 1], np.int32)
    cnts = np.array([-3, 64, 64, 1000], np.int32)
    got = P.slot_hist(_t(rec), _t(slots), _t(cnts), 2, F, 256).numpy()
    assert not got[0].any()
    _assert_hist(got[1], P.slot_hist_ref(rec[3:], np.zeros(1, np.int32),
                                         np.array([64]), 1, F, 256)[0])


# ---------------------------------------------------------------------------
# P2 move
# ---------------------------------------------------------------------------
def _two_blocks(rec, cnts, wsel=None):
    """check_correctness's params: two blocks of six chunks split on byte
    1 of word blk + 1 at 120 (``wsel`` overrides the word lane)."""
    nc, _, chunk = rec.shape
    params = np.zeros((nc, 8), np.int32)
    half = nc // 2
    dest = 0
    blocks = []
    for blk, (c0, c1) in enumerate(((0, half), (half, nc))):
        ws = blk + 1 if wsel is None else wsel
        rows = np.concatenate([rec[i, :, :cnts[i]] for i in range(c0, c1)],
                              axis=1)
        word = rows[ws] if ws < P.NWORDS else np.zeros_like(rows[0])
        n_l = int((((word >> 8) & 255) <= 120).sum())
        n_r = rows.shape[1] - n_l
        baseL = dest
        baseR = dest + (n_l + chunk - 1) // chunk
        dest = baseR + (n_r + chunk - 1) // chunk
        blocks.append((baseL, n_l, baseR, n_r))
        params[c0:c1] = (ws, 8, 120, baseL, baseR, 0, 0, 0)
        params[c0, 5] = 1
        params[c1 - 1, 6] = 1
    params[:, 7] = cnts
    return params, dest + 1, blocks


def _covered(out, blocks, chunk):
    """The rows the Pallas kernel flushes: each side's first n rows."""
    parts = []
    for bl, n_l, br, n_r in blocks:
        for base, n in ((bl, n_l), (br, n_r)):
            k = -(-n // chunk)
            if k:
                parts.append(np.concatenate([out[base + j].T
                                             for j in range(k)])[:n])
    return np.concatenate(parts)


@pytest.mark.parametrize("chunk,wsel", [(256, None), (512, None),
                                        (256, 7)])
def test_move_matches_pallas(interpret, chunk, wsel):
    """Bit-equal on the covered rows at the correctness check's two blocks,
    and equal to the numpy oracle there; at wsel 7 the Pallas kernel reads
    word 0 (every valid row goes left), which the oracle does not follow
    (it reads lane 7)."""
    rec, rng = _records(12, chunk, 4)
    cnts = rng.integers(chunk // 2, chunk + 1, 12).astype(np.int32)
    params, nc_out, blocks = _two_blocks(rec, cnts, wsel)
    want = np.asarray(interpret.move(jnp.asarray(rec), jnp.asarray(params),
                                     chunk, nc_out))
    got = P.move(_t(rec), _t(params), nc_out).numpy()
    assert np.array_equal(_covered(got, blocks, chunk),
                          _covered(want, blocks, chunk))
    if wsel is None:
        ref = P.move_ref(rec, params, chunk, nc_out)
        assert np.array_equal(_covered(ref, blocks, chunk),
                              _covered(want, blocks, chunk))
    else:
        assert all(n_r == 0 for _, _, _, n_r in blocks)


@pytest.mark.parametrize("col,value", [(P.P_SHIFT, 32), (P.P_SHIFT, -1),
                                       (P.P_CNT, 1 << 20), (P.P_FIRST, 2),
                                       (P.P_THR, 256), (P.P_WSEL, -1)])
def test_move_rejects_fields_the_packing_cannot_hold(col, value):
    rec, _ = _records(2, 64, 5)
    params = np.zeros((2, 8), np.int32)
    params[:, P.P_CNT] = 64
    params[1, col] = value
    with pytest.raises(ValueError, match="outside"):
        P.move(_t(rec), _t(params))


def test_move_blocks_restart_after_last_and_drop_out_of_range():
    """A block starts after a chunk with the last bit even without a first
    bit; destinations outside [0, nc_out) are dropped."""
    rec, _ = _records(3, 8, 6)
    params = np.zeros((3, 8), np.int32)
    params[:] = (7, 0, 255, 0, 0, 0, 0, 8)         # every row left
    params[0, P.P_LAST] = 1
    params[1, P.P_BASEL] = 1
    params[2, P.P_BASEL] = 5                       # outside nc_out = 3
    out = P.move(_t(rec), _t(params), 3,
                 out=torch.full((3, P.W, 8), -7, dtype=torch.int32))
    assert torch.equal(out[0], _t(rec[0]))
    assert torch.equal(out[1], _t(rec[1]))
    assert bool((out[2] == -7).all())


# ---------------------------------------------------------------------------
# P3 ring_stage
# ---------------------------------------------------------------------------
def _pallas_ring(kernel, rec):
    """tools/proto_roll.py's pallas_call of ``bench``, over rec's chunks,
    in interpret mode: the left ring's first C columns."""
    f = pl.pallas_call(
        kernel, grid=(rec.shape[0],),
        in_specs=[pl.BlockSpec((1, TR.W, TR.C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, TR.W, TR.C), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, TR.W, TR.C), jnp.int32),
        scratch_shapes=[pltpu.VMEM((TR.W, 4 * TR.C), jnp.int32),
                        pltpu.SMEM((8,), jnp.int32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(rec)))[0]


@pytest.fixture(scope="module")
def ring_records():
    rng = np.random.RandomState(0)
    return {n: rng.randint(0, 2**31 - 1, (n, TR.W, TR.C)).astype(np.int32)
            for n in (2, 24)}


@pytest.mark.parametrize("n", [2, 24])
@pytest.mark.parametrize("wrap", [False, True], ids=["route4c",
                                                     "compact_roll"])
def test_ring_stage_matches_pallas(ring_records, n, wrap):
    """Bit-equal on the written positions (those where the twin's result
    does not depend on the staging's initial fill); at 2 chunks most of
    the first C columns are unwritten, at 24 none."""
    rec = ring_records[n]
    kernel = TR.kernel_compact_roll if wrap else TR.kernel_route4c
    want = _pallas_ring(kernel, rec)
    got = P.ring_stage(_t(rec), wrap).numpy()
    written = got == P.ring_stage_plain(_t(rec), wrap, fill=1).numpy()
    cols = written[:, :TR.C].all(0)
    assert np.array_equal(written[:, :TR.C], np.broadcast_to(
        cols, written[:, :TR.C].shape))
    assert np.array_equal(got[:, :TR.C][:, cols], want[:, cols])
    assert not got[~written].any()
    assert (0 < (~cols).sum() < TR.C) if n == 2 else cols.all()


def _ring_kind(rec, kind, seed):
    """rec with lane 0's low byte set so that each chunk has no left row,
    all but one (route4c then skips positions below C lap after lap), or
    a left row in 64 on average."""
    rng = np.random.default_rng(seed)
    n, _, C = rec.shape
    if kind == "no left":
        left = np.zeros((n, C), bool)
    elif kind == "C-1 left":
        left = np.ones((n, C), bool)
        left[np.arange(n), rng.integers(0, C, n)] = False
    else:
        left = rng.random((n, C)) < 1 / 64
    key = rec[:, 0] & 255
    out = rec.copy()
    out[:, 0] = (rec[:, 0] & ~255) | np.where(left, key & 31,
                                               32 + key % 224)
    return out


@pytest.mark.parametrize("kind", ["no left", "C-1 left", "sparse left"])
@pytest.mark.parametrize("wrap", [False, True], ids=["route4c",
                                                     "compact_roll"])
def test_ring_stage_matches_pallas_on_skewed_chunks(ring_records, kind,
                                                    wrap):
    """24 chunks whose left rows stress a walk back from the last chunk:
    none (the left ring stays empty: zero), C - 1 a chunk (route4c drops
    each lap's first positions and keeps an earlier lap's there), and
    sparse (every row in lap 0). The twin is bit-equal to the Pallas
    kernel on every position it writes, and 0 elsewhere."""
    rec = _ring_kind(ring_records[24], kind, len(kind))
    kernel = TR.kernel_compact_roll if wrap else TR.kernel_route4c
    want = _pallas_ring(kernel, rec)
    got = P.ring_stage(_t(rec), wrap).numpy()
    written = got == P.ring_stage_plain(_t(rec), wrap, fill=1).numpy()
    cols = written[:, :TR.C].all(0)
    assert np.array_equal(got[:, :TR.C][:, cols], want[:, cols])
    assert not got[~written].any()
    n_left = int(((rec[:, 0] & 255) <= P.ROLL_THRESHOLD).sum())
    n_right = rec.shape[0] * TR.C - n_left
    assert cols.sum() == min(n_left, TR.C)
    # lap 0 reaches every position up to the side's rows
    assert written[:, :2 * TR.C].all(0).sum() == min(n_left, 2 * TR.C)
    assert written[:, 2 * TR.C:].all(0).sum() == min(n_right, 2 * TR.C)


def test_ring_variants_differ_at_24_chunks(ring_records):
    """route4c drops the rows whose position passes the ring's end, and
    compact_roll wraps them: the Pallas outputs differ, and so do the
    port's."""
    rec = ring_records[24]
    a = _pallas_ring(TR.kernel_route4c, rec)
    b = _pallas_ring(TR.kernel_compact_roll, rec)
    assert (a != b).any()
    pa = P.ring_stage(_t(rec), False).numpy()[:, :TR.C]
    pb = P.ring_stage(_t(rec), True).numpy()[:, :TR.C]
    assert np.array_equal((pa != pb).any(0), (a != b).any(0))


def test_ring_stage_counts_rows_in_order():
    """Hand-made chunks of 4 rows (C = 4, rings of 8): the left rows of
    each chunk land at the left cursor in row order; route4c drops the one
    row that passes position 8, compact_roll puts it at position 0."""
    C = 4
    keys = np.array([[0, 0, 0, 255],      # 3 left, 1 right
                     [0, 0, 0, 0],        # 4 left
                     [0, 255, 255, 0]])   # 2 left (the 2nd at 7 + 1 = 8)
    rec = np.zeros((3, P.W, C), np.int32)
    rec[:, 0] = keys
    rec[:, 1] = np.arange(12).reshape(3, C)  # row ids
    for wrap in (False, True):
        stag = P.ring_stage(_t(rec), wrap).numpy()
        left = stag[1, :8].tolist()
        assert left == [11 if wrap else 0, 1, 2, 4, 5, 6, 7, 8]
        assert stag[1, 8:].tolist() == [3, 9, 10, 0, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# wrappers and harnesses
# ---------------------------------------------------------------------------
def test_wrappers_take_the_twins_on_cpu():
    rec, rng = _records(4, 64, 7)
    slots = np.array([0, 0, 1, 1], np.int32)
    cnts = np.full(4, 64, np.int32)
    params = np.zeros((4, 8), np.int32)
    params[:] = (1, 8, 127, 0, 3, 0, 0, 64)
    params[0, P.P_FIRST] = params[3, P.P_LAST] = 1
    P.reset_launches()
    assert torch.equal(
        P.slot_hist(_t(rec), _t(slots), _t(cnts), 2, F, 64),
        P.slot_hist_plain(_t(rec), _t(slots), _t(cnts), 2, F, 64))
    assert torch.equal(P.move(_t(rec), _t(params), 8),
                       P.move_plain(_t(rec), _t(params), 8))
    for wrap in (False, True):
        assert torch.equal(P.ring_stage(_t(rec), wrap),
                           P.ring_stage_plain(_t(rec), wrap))
    assert P.LAUNCHES == {"slot_hist": 0, "move": 0, "route4c": 0,
                          "compact_roll": 0}
    with pytest.raises(ValueError, match="b_pad"):
        P.slot_hist(_t(rec), _t(slots), _t(cnts), 2, F, 257)
    with pytest.raises(ValueError, match="num_features"):
        P.slot_hist(_t(rec), _t(slots), _t(cnts), 2, 29, 64)


def test_proto_aligned_harness_on_cpu(capsys):
    """The harness's main at 4,096 rows on the CPU: both correctness
    checks hold and every configuration is timed."""
    res = HA.main(4096, device="cpu")
    out = capsys.readouterr().out
    assert res["ok"]
    assert "slot-hist: counts EXACT" in out and "move correctness: OK" in out
    assert len(res["slot_hist"]) == 8 and len(res["move"]) == 2
    assert HA.cli(["2048", "--device", "cpu"]) == 0


def test_proto_roll_harness_on_cpu(capsys):
    res = HR.main(24, device="cpu")
    out = capsys.readouterr().out
    assert set(res) == {"device", "route4c", "compact_roll"}
    assert "route4c:" in out and "compact_roll:" in out
    assert HR.cli(["3", "--device", "cpu"]) == 0
