"""The prototype kernels P1-P3 of the chunk-aligned pipeline (port of the
measurement harnesses tools/proto_aligned.py and tools/proto_roll.py,
from which the aligned engine's kernels B2 and B4 were derived).

Records are ``[nc, W, C]`` int32 with W = 16 lanes: seven packed bin
words (four 8-bit bins a word, features 0..27), then g and h (f32 bit
patterns) in lanes `LG` and `LH`. Three functions work on them:

- P1 `slot_hist`: the slot-mapped streaming histogram (prototype of B4);
- P2 `move`: the stable two-way partition of every block of chunks into
  chunk-aligned destinations (prototype of B2);
- P3 `ring_stage`: the in-chunk left/right split into two rings of 2C
  positions, as the roll prototype's two variants compute it
  (``wrap=False``: ``kernel_route4c``, ``wrap=True``:
  ``kernel_compact_roll``).

Each keeps the prototype's own semantics (ROADMAP C.16): a slot visited
in two separate runs of chunks keeps the last run, ``route4c`` drops the
rows whose ring position passes 2C while ``compact_roll`` wraps them, and
positions no row reaches are unspecified in the Pallas kernels (here:
zero in P1's histogram and P3's staging, untouched in P2's output).

On a CUDA tensor each wrapper launches its kernel of
``ops/csrc/proto.cu`` or raises; on a CPU tensor it runs the plain
PyTorch twin beside it (``*_plain``), which is also what the kernels are
held against on the card. `slot_hist_ref` and `move_ref` are the
harness's numpy oracles.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

W = 16                      # record lanes (i32)
NWORDS = 7                  # packed bin words for 28 features
LG, LH = NWORDS, NWORDS + 1  # g/h record lanes
MAX_FEATURES = 4 * NWORDS
NUM_STATS = 3
# move params columns (per chunk)
P_WSEL, P_SHIFT, P_THR, P_BASEL, P_BASER, P_FIRST, P_LAST, P_CNT = range(8)
# the Pallas kernel packs cnt into 20 bits, first/last into bits 20 and 21
CNT_LIMIT = 1 << 20
# the roll prototype's routing: a row goes left when its lane-0 low byte
# is at most 31
ROLL_THRESHOLD = 31

# P1's CTA (proto.cu kHistThreads) and its tiles: a CTA sums at most a
# tile's rows in fixed point before it adds them to the f64 sums (the
# rows bound the rounding, proto.cu)
SLOT_HIST_THREADS = 1024
SLOT_HIST_TILE_ROWS = 16384
SLOT_HIST_MAX_TILE_CHUNKS = 256
_SLOT_HIST_CELL_BYTES = 20         # hi/lo int32 of g and of h, u32 count

# kernel launches by wrapper (a CPU call of a twin does not count)
LAUNCHES: Dict[str, int] = {"slot_hist": 0, "move": 0, "route4c": 0,
                            "compact_roll": 0}

# P2's CTA (proto.cu) takes a tile of chunks, about MOVE_TILE_ROWS rows
# (at most 32 chunks); shared memory: two mbarriers (16 B), one or two
# stages of a whole chunk (4 B a row and lane), a u16 row permutation a
# tile row and two words a 32-row ballot; the kernel's static shared
# memory (the tile's per-chunk fields) stays under the slack
MOVE_TILE_ROWS = 2048
MOVE_MAX_TILE = 32
_MOVE_STATIC_SLACK = 1024

_fns: Dict[str, object] = {}
_ctas: Dict[Tuple[int, int], int] = {}
_optin: Dict[int, int] = {}            # ordinal -> shared-memory opt-in


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# checks (shared by the kernels and their twins)
# ---------------------------------------------------------------------------
def _check_records(records: torch.Tensor) -> None:
    if records.dtype != torch.int32 or records.dim() != 3 \
            or records.shape[1] != W or not records.is_contiguous():
        raise ValueError(f"records must be a contiguous int32 [nc, {W}, C] "
                         "tensor")


def _check_chunk_array(a: torch.Tensor, records: torch.Tensor,
                       what: str) -> None:
    if a.dtype != torch.int32 or tuple(a.shape) != (records.shape[0],) \
            or not a.is_contiguous() or a.device != records.device:
        raise ValueError(f"{what} must be a contiguous int32 [nc] tensor on "
                         "the device of records")


def _check_slot_hist_args(records, slots, cnts, num_slots, num_features,
                          b_pad, group) -> None:
    _check_records(records)
    _check_chunk_array(slots, records, "slots")
    _check_chunk_array(cnts, records, "cnts")
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(f"num_features={num_features} outside "
                         f"[1, {MAX_FEATURES}]")
    if not 1 <= b_pad <= 256:
        raise ValueError(f"b_pad={b_pad} outside [1, 256]")
    if num_slots < 1 or group < 1:
        raise ValueError("num_slots and group must be positive")


def _check_move_params(records: torch.Tensor, params: torch.Tensor) -> None:
    """The field ranges the Pallas kernel's packing keeps intact: wsel and
    thr in 8 bits, shift in [0, 32) (an arithmetic shift of an int32),
    first/last single bits, cnt in 20 bits (one host read of the
    per-column extremes)."""
    _check_records(records)
    if params.dtype != torch.int32 or tuple(params.shape) != (
            records.shape[0], 8) or not params.is_contiguous() \
            or params.device != records.device:
        raise ValueError("params must be a contiguous int32 [nc, 8] tensor "
                         "on the device of records")
    if params.shape[0] == 0:
        return
    lo, hi = torch.stack([params.amin(0), params.amax(0)]).cpu().tolist()
    limits = {P_WSEL: (0, 255, "wsel"), P_SHIFT: (0, 31, "shift"),
              P_THR: (0, 255, "thr"), P_FIRST: (0, 1, "first"),
              P_LAST: (0, 1, "last"), P_CNT: (0, CNT_LIMIT - 1, "cnt")}
    for col, (a, b, name) in limits.items():
        if lo[col] < a or hi[col] > b:
            raise ValueError(f"move params: {name} outside [{a}, {b}] "
                             f"(found {lo[col]}..{hi[col]})")


def _check_out(out: torch.Tensor, records: torch.Tensor,
               nc_out: int) -> None:
    if out.dtype != torch.int32 or tuple(out.shape) != (
            nc_out, W, records.shape[2]) or not out.is_contiguous() \
            or out.device != records.device \
            or out.data_ptr() == records.data_ptr():
        raise ValueError(f"out must be another contiguous int32 [{nc_out}, "
                         f"{W}, C] tensor on the device of records")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def _last_run_chunks(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """[nc] bool: the chunks whose slot is in [0, num_slots) and that lie
    in the last run of equal consecutive slots with that slot (the Pallas
    kernel zeroes a slot's block at the first chunk of each run, so only
    the last run survives)."""
    nc = slots.shape[0]
    dev = slots.device
    iota = torch.arange(nc, device=dev)
    start = torch.ones(nc, dtype=torch.bool, device=dev)
    start[1:] = slots[1:] != slots[:-1]
    run0 = torch.cummax(torch.where(start, iota, 0), dim=0).values
    ok = (slots >= 0) & (slots < num_slots)
    key = torch.where(ok, slots, num_slots).long()
    last = torch.full((num_slots + 1,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, key, run0, reduce="amax")
    return ok & (run0 == last[key])


def slot_hist_plain(records, slots, cnts, num_slots, num_features, b_pad,
                    group=4):
    """Plain twin of `slot_hist`: the kept chunks' valid rows, one f64
    ``index_add_`` per feature, rounded to f32 once."""
    _check_slot_hist_args(records, slots, cnts, num_slots, num_features,
                          b_pad, group)
    nc, _, C = records.shape
    dev = records.device
    out = torch.zeros((num_slots, num_features, b_pad, NUM_STATS),
                      dtype=torch.float32, device=dev)
    take = (torch.arange(C, device=dev)[None, :] < cnts[:, None]) \
        & _last_run_chunks(slots, num_slots)[:, None]
    chunk, row = take.nonzero(as_tuple=True)
    if chunk.numel() == 0:
        return out
    pay = torch.stack([records[chunk, LG, row].view(torch.float32),
                       records[chunk, LH, row].view(torch.float32),
                       torch.ones(chunk.numel(), dtype=torch.float32,
                                  device=dev)], dim=1).double()
    base = slots.long()[chunk] * b_pad
    for f in range(num_features):
        b = (records[chunk, f >> 2, row] >> ((f & 3) * 8)) & 255
        ok = b < b_pad
        acc = torch.zeros((num_slots * b_pad, NUM_STATS),
                          dtype=torch.float64, device=dev)
        acc.index_add_(0, (base + b.long())[ok], pay[ok])
        out[:, f] = acc.view(num_slots, b_pad, NUM_STATS).float()
    return out


def _move_blocks(params: torch.Tensor) -> torch.Tensor:
    """[nc] first chunk of each chunk's block: a block starts at chunk 0,
    at a chunk with the first bit and after a chunk with the last bit (the
    Pallas kernel resets its fills at both)."""
    nc = params.shape[0]
    iota = torch.arange(nc, device=params.device)
    start = params[:, P_FIRST] != 0
    start[0] = True
    start[1:] |= params[:-1, P_LAST] != 0
    return torch.cummax(torch.where(start, iota, 0), dim=0).values


def move_plain(records, params, nc_out=None, out=None):
    """Plain twin of `move`: block-segmented exclusive ranks of the left
    and right rows in (chunk, row) order and one scatter of every lane."""
    _check_move_params(records, params)
    nc, _, C = records.shape
    dev = records.device
    nc_out = nc if nc_out is None else nc_out
    if out is None:
        out = torch.zeros((nc_out, W, C), dtype=torch.int32, device=dev)
    _check_out(out, records, nc_out)
    p = params.long()
    valid = torch.arange(C, device=dev)[None, :] < p[:, P_CNT, None]
    iota = torch.arange(nc, device=dev)
    wsel = p[:, P_WSEL]
    word = records[iota, wsel.clamp(max=NWORDS - 1)]
    word = torch.where((wsel < NWORDS)[:, None], word, 0)
    binv = (word >> params[:, P_SHIFT, None]) & 255
    left = (binv <= params[:, P_THR, None]) & valid
    block0 = _move_blocks(params)
    for mask, base in ((left, p[:, P_BASEL]), (valid & ~left,
                                                p[:, P_BASER])):
        m = mask.reshape(-1).long()
        excl = (torch.cumsum(m, 0) - m).view(nc, C)
        rank = excl - excl[block0, 0][:, None]
        c, r = mask.nonzero(as_tuple=True)
        d = rank[c, r]
        dc = base[c] + d // C
        ok = (dc >= 0) & (dc < nc_out)
        c, r, d, dc = c[ok], r[ok], d[ok], dc[ok]
        lanes = torch.arange(W, device=dev)
        out[dc[:, None], lanes[None, :], (d % C)[:, None]] = \
            records[c[:, None], lanes[None, :], r[:, None]]
    return out


def ring_stage_plain(records, wrap: bool, fill: int = 0):
    """Plain twin of `ring_stage`: each side's rows in (chunk, row) order
    get ring positions; a position keeps the row of the latest chunk that
    wrote it. ``fill`` is the value of the positions no row reaches."""
    _check_records(records)
    n, _, C = records.shape
    dev = records.device
    C2 = 2 * C
    stag = torch.full((W, 2 * C2), fill, dtype=torch.int32, device=dev)
    left = (records[:, 0] & 255) <= ROLL_THRESHOLD
    chunk_of = torch.arange(n, device=dev)[:, None].expand(n, C)
    for side, mask in enumerate((left, ~left)):
        k = mask.sum(1)
        lo = (torch.cumsum(k, 0) - k) % C2            # ring cursor
        m = mask.long()
        pos = lo[:, None] + torch.cumsum(m, 1) - m
        if wrap:
            pos = pos % C2
            writes = mask
        else:
            writes = mask & (pos < C2)
        p = pos[writes]
        c = chunk_of[writes]
        last = torch.full((C2,), -1, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, p, c, reduce="amax")
        fin = writes & (chunk_of == last[pos.clamp(max=C2 - 1)])
        cc, rr = fin.nonzero(as_tuple=True)
        stag[:, side * C2 + pos[fin]] = records[cc, :, rr].t()
    return stag


# ---------------------------------------------------------------------------
# numpy oracles of the harness (tools/proto_aligned.py)
# ---------------------------------------------------------------------------
def slot_hist_ref(rec, slots, cnts, num_slots, num_features, b_pad):
    """NumPy oracle over [nc, W, C] records (every chunk's rows, whatever
    its run; bins must be below ``b_pad``)."""
    out = np.zeros((num_slots, num_features, b_pad, 3), np.float64)
    nc, _, chunk = rec.shape
    for c in range(nc):
        s = slots[c]
        for r in range(cnts[c]):
            g = np.int32(rec[c, LG, r]).view(np.float32)
            h = np.int32(rec[c, LH, r]).view(np.float32)
            for f in range(num_features):
                b = (rec[c, f >> 2, r] >> ((f & 3) * 8)) & 255
                out[s, f, b, 0] += g
                out[s, f, b, 1] += h
                out[s, f, b, 2] += 1
    return out


def move_ref(rec, params, chunk, nc_out=None):
    """NumPy oracle: stable partition per block, aligned destinations
    (reads word lane ``wsel`` for any wsel; the Pallas kernel reads 0 from
    wsel 7 on)."""
    nc = rec.shape[0]
    out = np.zeros((nc_out or nc, rec.shape[1], chunk), rec.dtype)
    lefts, rights = [], []
    for i in range(nc):
        wsel, shift, thr, baseL, baseR, first, last, cnt = params[i]
        if first:
            lefts, rights = [], []
        rows = rec[i, :, :cnt]                       # [W, cnt]
        binv = (rows[wsel] >> shift) & 255
        m = binv <= thr
        lefts.append(rows[:, m])
        rights.append(rows[:, ~m])
        if last:
            for base, rs in ((baseL, lefts), (baseR, rights)):
                allr = np.concatenate(rs, axis=1)
                for j in range(allr.shape[1]):
                    out[base + j // chunk, :, j % chunk] = allr[:, j]
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _lib():
    if not _fns:
        from ..utils import cuda_build
        lib = cuda_build.load("proto")
        p, i = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "lgbt_proto_slot_hist": [p, i, i, p, p, i, i, i, i, i, i,
                                     p, p, p, p, p],
            "lgbt_proto_move": [p, i, i, i, i, i, p, i, p, p, p],
            "lgbt_proto_ring_stage": [p, i, i, i, p, p, p, p, p, p],
            "lgbt_proto_slot_hist_occupancy": [i],
            "lgbt_proto_smem_optin": [i],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def slot_hist_smem(C: int, num_features: int, b_pad: int) -> Tuple[int, int]:
    """(tile_chunks, shared bytes per CTA) of P1's kernel: a CTA holds
    every feature's cells and one tile's chunk metadata, a tile is
    `SLOT_HIST_TILE_ROWS` rows of whole chunks."""
    if C > SLOT_HIST_TILE_ROWS:
        raise ValueError(f"slot_hist takes chunks of at most "
                         f"{SLOT_HIST_TILE_ROWS} rows, got {C}")
    tile_chunks = min(SLOT_HIST_MAX_TILE_CHUNKS, SLOT_HIST_TILE_ROWS // C)
    smem = _SLOT_HIST_CELL_BYTES * num_features * b_pad + 8 * tile_chunks \
        + 8
    return tile_chunks, smem


def slot_hist_launch_shape(nc: int, C: int, num_features: int, b_pad: int,
                           ctas_per_sm: int, num_sms: int):
    """(tile_chunks, shared bytes per CTA, grid) of P1's kernel, given the
    CTAs of `SLOT_HIST_THREADS` threads an SM holds at that shared memory
    (`slot_hist_ctas_per_sm` on the card): that many CTAs per SM, or one
    per tile if fewer, each taking tiles of ``tile_chunks`` chunks in
    turn."""
    tile_chunks, smem = slot_hist_smem(C, num_features, b_pad)
    if ctas_per_sm < 1:
        raise ValueError(f"{num_features} features x {b_pad} bins "
                         f"({smem} B) exceed an SM's shared memory")
    tiles = -(-nc // tile_chunks)
    return tile_chunks, smem, max(1, min(tiles, ctas_per_sm * num_sms))


def slot_hist_ctas_per_sm(ordinal: int, smem: int) -> int:
    """CTAs of P1's kernel with ``smem`` bytes of shared memory each that
    the CUDA occupancy calculator fits on an SM of device ``ordinal`` (0
    where one does not fit)."""
    key = (ordinal, smem)
    if key not in _ctas:
        with torch.cuda.device(ordinal):
            n = _lib()["lgbt_proto_slot_hist_occupancy"](smem)
        if n < 0:
            raise RuntimeError("slot_hist: the CUDA occupancy query failed")
        _ctas[key] = n
    return _ctas[key]


def slot_hist(records, slots, cnts, num_slots, num_features, b_pad,
              group=4):
    """hist[num_slots, num_features, b_pad, 3] f32 = (sum g, sum h,
    count) over the rows r < cnts[c] of each chunk c, into slot slots[c]:
    bin of feature f = byte f & 3 of word lane f >> 2, g/h the f32 bits
    of lanes `LG`/`LH`. Bins at or above ``b_pad`` add nothing. A slot
    whose chunks form several separate runs keeps its last run; a slot no
    chunk reaches is zero; chunks whose slot lies outside [0, num_slots)
    add nothing. ``group`` (the TPU kernel's MXU tiling) changes no
    output and is only checked. On the card chunks hold at most
    `SLOT_HIST_TILE_ROWS` rows: the kernel sums each slot's rows of a
    tile in fixed point scaled to their largest |g| (|h|), off by at most
    1.9e-6 of it, then in f64, rounded to f32 once; a tile's run of one
    slot that holds a non-finite g (h) sums that stat in f64 throughout,
    so NaN and Inf come out as the twin's."""
    if not records.is_cuda:
        return slot_hist_plain(records, slots, cnts, num_slots,
                               num_features, b_pad, group)
    _check_slot_hist_args(records, slots, cnts, num_slots, num_features,
                          b_pad, group)
    nc, _, C = records.shape
    dev = records.device
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    _, smem = slot_hist_smem(C, num_features, b_pad)
    tile_chunks, smem, grid = slot_hist_launch_shape(
        nc, C, num_features, b_pad, slot_hist_ctas_per_sm(ordinal, smem),
        torch.cuda.get_device_properties(ordinal).multi_processor_count)
    cells = (num_slots, num_features, b_pad)
    out = torch.empty(cells + (NUM_STATS,), dtype=torch.float32, device=dev)
    gh = torch.empty(cells + (2,), dtype=torch.float64, device=dev)
    cnt = torch.empty(cells, dtype=torch.int32, device=dev)
    last = torch.empty(num_slots, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib()["lgbt_proto_slot_hist"](
            records.data_ptr(), nc, C, slots.data_ptr(), cnts.data_ptr(),
            num_slots, num_features, b_pad, tile_chunks, grid, smem,
            last.data_ptr(), gh.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            _stream(dev))
    _raise_on(err, "slot_hist")
    LAUNCHES["slot_hist"] += 1
    return out


def move(records, params, nc_out=None, out: Optional[torch.Tensor] = None):
    """Stable two-way partition of every block of chunks, one pass.

    params [nc, 8] int32 per chunk: (wsel, shift, thr, baseL, baseR,
    first, last, cnt). The rows r < cnt of chunk c go left when ((word
    >> shift) & 255) <= thr, with word = lane wsel for wsel < 7 and 0
    from 7 on (so every row goes left), the shift arithmetic; a block's
    left rows fill chunks baseL, baseL + 1, ... and its right rows chunks
    baseR, ..., in (chunk, row) order. A block starts at chunk 0, at a
    chunk with the first bit and after one with the last bit; bases are
    read from each row's own chunk (constant over a block, as the Pallas
    kernel needs them), and rows whose destination chunk lies outside
    [0, nc_out) are dropped.

    Returns out [nc_out, W, C] (a new tensor when ``out`` is None): the
    rows the Pallas kernel flushes are exact; every other position is
    unspecified (here: what ``out`` held, except that the rows of a
    block's last partial chunk are written even without its last bit).
    On the card the params are checked on the host (one read), then the
    move is one memset of its scratch and one launch: CTAs take tiles of
    chunks by ticket, rank them from their split words, find their
    block's earlier rows by a look-back over the tiles (as B2's partition,
    `ops.aligned.move_pass`, does over chunks) while the chunks' bulk
    copies land, and store the chunks in turn."""
    if not records.is_cuda:
        return move_plain(records, params, nc_out, out)
    _check_move_params(records, params)
    nc, _, C = records.shape
    nc_out = nc if nc_out is None else nc_out
    if out is None:
        out = torch.empty((nc_out, W, C), dtype=torch.int32,
                          device=records.device)
    _check_out(out, records, nc_out)
    _move_cuda(records, params, nc_out, out, move_scratch(records))
    LAUNCHES["move"] += 1
    return out


def move_smem(C: int, smem_optin: int) -> Tuple[int, int, int]:
    """(chunks a tile, stages, dynamic shared bytes per CTA) of P2's
    kernel: a tile of `MOVE_TILE_ROWS` // C chunks (1 to
    `MOVE_MAX_TILE`: 8 at chunks of 256, 4 at 512); two stages of a
    whole chunk (`W` lanes of ``C`` rows, 64 C bytes, always a multiple
    of 16 for the bulk copy) where they fit ``smem_optin`` beside the
    mbarriers, the tile's permutations and its ballots (16 and 32 KB a
    stage at 256 and 512), else one. Chunks that do not fit one stage,
    or of more than 65,535 rows (u16 permutation), are refused."""
    if not 1 <= C <= 65535:
        raise ValueError(f"move takes chunks of 1 to 65,535 rows, got {C}")
    tile = max(1, min(MOVE_MAX_TILE, MOVE_TILE_ROWS // C))
    fixed = 16 + -(-2 * tile * C // 16) * 16 + 8 * tile * -(-C // 32)
    room = smem_optin - _MOVE_STATIC_SLACK - fixed
    stages = min(2, room // (4 * W * C))
    if stages < 1:
        raise ValueError(f"a chunk of {C} rows does not fit the "
                         f"{smem_optin} B of shared memory")
    return tile, stages, fixed + stages * 4 * W * C


def move_scratch(records: torch.Tensor) -> torch.Tensor:
    """The scratch of one `move` call on the card over ``records``: a flag
    word (u64) a tile and the ticket, as int32 [2 nc + 2] (enough for
    tiles of one chunk)."""
    return torch.empty(2 * records.shape[0] + 2, dtype=torch.int32,
                       device=records.device)


def _move_cuda(records, params, nc_out: int, out, scratch) -> None:
    """`move`'s launch alone, on arguments `move` has checked and a
    `move_scratch`: one memset of the scratch, one launch."""
    nc, _, C = records.shape
    dev = records.device
    if records.data_ptr() % 16:
        raise ValueError("move's bulk copies need 16-byte aligned records")
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if ordinal not in _optin:
        optin = _lib()["lgbt_proto_smem_optin"](ordinal)
        if optin < 0:
            raise RuntimeError("move: the shared-memory opt-in query failed")
        _optin[ordinal] = optin
    tile, stages, smem = move_smem(C, _optin[ordinal])
    with torch.cuda.device(dev):
        err = _lib()["lgbt_proto_move"](
            records.data_ptr(), nc, C, tile, stages, smem,
            params.data_ptr(), nc_out, scratch.data_ptr(), out.data_ptr(),
            _stream(dev))
    _raise_on(err, "move")


def ring_stage(records, wrap: bool):
    """[W, 4C] int32 staging after every chunk of records [n, W, C]: each
    chunk's rows split left ((lane 0 & 255) <= 31) and right, in row
    order, into the left ring (columns [0, 2C)) and the right ring
    ([2C, 4C)) at the ring's cursor, which then advances by the rows put
    there, mod 2C. ``wrap=False`` is ``kernel_route4c``: a row whose
    position passes the ring's end is dropped; ``wrap=True`` is
    ``kernel_compact_roll``: it wraps to the ring's start. Positions no
    row reaches are 0. The Pallas kernels' output is ``[:, :C]``."""
    if not records.is_cuda:
        return ring_stage_plain(records, wrap)
    _check_records(records)
    n, _, C = records.shape
    if n * C >= 1 << 31:
        raise ValueError("ring_stage takes fewer than 2^31 rows")
    dev = records.device
    stag = torch.empty((W, 4 * C), dtype=torch.int32, device=dev)
    kl = torch.empty(n, dtype=torch.int32, device=dev)
    prefix = torch.empty(n + 1, dtype=torch.int32, device=dev)
    laps = torch.empty((2, n + 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib()["lgbt_proto_ring_stage"](
            records.data_ptr(), n, C, int(bool(wrap)), kl.data_ptr(),
            prefix.data_ptr(), laps[0].data_ptr(), laps[1].data_ptr(),
            stag.data_ptr(), _stream(dev))
    _raise_on(err, "ring_stage")
    LAUNCHES["compact_roll" if wrap else "route4c"] += 1
    return stag
