"""Chunk-aligned records and the aligned engine's kernels (port of
lightgbm_tpu/ops/aligned.py, serial path).

One persistent ``[NC, W, C]`` int32 record matrix holds the training rows,
chunk-blocked and transposed: within a chunk each lane is a contiguous run
of C words. The first ``wcnt`` lanes are packed bin words (8, 5 or 4 bins a
word at 4-, 6- and 8-bit widths), the rest the layout's value lanes
(`lane_layout`): STANDARD score/label/grad/hess/rid/weight; COMPACT
score/meta, where meta packs rid | label << 24 | bag << 31 and gradients
are recomputed inside the kernels from the score and the label bit; or
EXT score/grad/hess/rid for objectives whose gradients are not pointwise
(ranking), which arrive in row order and are gathered into the grad/hess
lanes by rid. Under bagging STANDARD and EXT records carry an f32 0/1
``bag`` lane; a histogram takes a row only where it is in the bag (the
kernels' ``bag_lane``: -1 none, -2 COMPACT's meta bit 31, >= 0 the f32
lane), while the partition and the count pass move and count every
physical row. A K-class objective takes COMPACT records with K score
lanes (softmax: K probability lanes after them) and the integer class in
meta bits 24-30; the histogram of class k reads its class's lane
(`ClassGrad`), so the meta lane is not always the one after the score.

Tree blocks own disjoint chunk-aligned ranges, so every chunk belongs to
one block and the routing arrives as per-chunk int32 arrays (bit layouts
below); a categorical split routes by its bitset, 8 words a split in the
round's compact table ``cbits`` (int32 [(K + 1) * 8], row K the pad row;
None: no categorical chunk). Three kernels, in ``ops/csrc/aligned.cu``,
work on the matrix:

- B2 `move_pass`: a stable two-way partition of every split block into its
  new chunk-aligned left and right ranges, copies of the used lanes of
  unsplit blocks' chunks (one launch, a decoupled look-back over chunk
  tickets), and the smaller child's histogram per compact slot;
- B3 `count_pass`: exact i32 left counts per compact slot (one
  launch: a persistent grid, warps over whole chunks, one last CTA);
- B4 `slot_hist_pass`: histograms of chunks mapped to slots.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch twin beside it (``*_plain``), which is
also what the card's kernels are held against.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from .objectives import PointGrad
from .partition import bundle_unpack

NUM_STATS = 3
MISSING_NONE_C, MISSING_ZERO_C, MISSING_NAN_C = 0, 1, 2

# route word 1 (per chunk): threshold bin | shift within the split word
# << 8 | default_left << 13 | missing type << 14 | copy-through << 16 |
# categorical << 25 (the JAX package's bit; its wsel bits 17-24 travel in
# their own array here)
R_THR = 0
R_SHIFT = 8
R_DL = 13
R_MT = 14
R_COPY = 16
R_CAT = 25
# route word 2: default_bin | (num_bin - 1) << 8 | bundle offset << 16 |
# packed << 24 (`pack_route2`)
# chunk meta word: valid rows | first chunk of block << 20 | last << 21
META_CNT_MASK = (1 << 20) - 1
META_FIRST = 20
META_LAST = 21
# COMPACT meta lane: rid | label << 24 | bag << 31
META_RID_MASK = (1 << 24) - 1
META_LABEL = 24
META_LABEL_MASK = 127
META_BAG = 31

# kernel launches by wrapper (a CPU call of a twin does not count)
LAUNCHES: Dict[str, int] = {"move_pass": 0, "count_pass": 0,
                            "slot_hist_pass": 0, "move_pass_cat": 0,
                            "count_pass_cat": 0, "move_pass_bag": 0,
                            "slot_hist_pass_bag": 0}
# of those, the launches of a `ClassGrad`'s kinds (a K-class objective)
CLASS_LAUNCHES: Dict[str, int] = {"move_pass": 0, "slot_hist_pass": 0}
# and the launches of the bundled branch (bundled storage columns)
BUNDLED_LAUNCHES: Dict[str, int] = {"move_pass": 0, "count_pass": 0}

_GRAD_KIND = {None: 0, "binary": 1, "l2": 2, "prob": 3, "score": 4, "l1": 5,
              "huber": 6, "fair": 7, "poisson": 8, "quantile": 9,
              "gamma": 10, "tweedie": 11, "xentropy": 12}
# of those, the launches of each `PointGrad` kind (COMPACT records):
# (wrapper, kind) -> launches
POINT_KINDS = tuple(k for k in _GRAD_KIND if k not in (None, "prob",
                                                       "score"))
POINT_LAUNCHES: Dict[Tuple[str, str], int] = {
    (w, k): 0 for w in ("move_pass", "slot_hist_pass") for k in POINT_KINDS}
# the slot histogram (B4, B2's smaller children; CTAs of 1024 threads):
# tiles of at most 16,384 rows (the bound of the fixed-point rounding,
# ops/csrc/aligned.cu), hi/lo int32 of g and of h and a u32 count a cell
SLOT_HIST_TILE_ROWS = 16384
SLOT_HIST_MAX_TILE_CHUNKS = 256
_SLOT_HIST_CELL_BYTES = 20
# the partition (B2): a 16-byte mbarrier, the staged lanes (4 B a row and
# lane), a u16 row permutation, two words a 32-row ballot and a
# categorical split's 8 bitset words; the kernel's static shared memory
# stays under the slack
_MOVE_STATIC_SLACK = 256
# the count pass (B3): a persistent grid of CTAs of 256 threads, 8 warps
# each taking whole chunks; a u32 counter a slot in shared memory
COUNT_THREADS = 256
_COUNT_WARPS = COUNT_THREADS // 32
_fns: Dict[str, object] = {}
_ctas: Dict[Tuple[int, int], int] = {}
# (ordinal, num_slots, bundled) -> (CTAs an SM, SMs, shared-memory
# opt-in) of the count pass; (ordinal, stream) -> its scratch: u32 [slots]
# then the ticket, zero between calls
_count_shapes: Dict[Tuple[int, int, bool], Tuple[int, int, int]] = {}
_count_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for d in (LAUNCHES, CLASS_LAUNCHES, BUNDLED_LAUNCHES, POINT_LAUNCHES):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# chunk size and layout (host)
# ---------------------------------------------------------------------------
def effective_chunk(cfg, num_features: int = 0) -> int:
    """Rows per chunk: ``tpu_chunk`` when set, else 1024 up to 40 features
    and 512 above (the JAX package's choice, kept so both packages pick
    the same C and NC)."""
    C = int(getattr(cfg, "tpu_chunk", 0) or 0)
    if C > 0:
        return C
    return 1024 if num_features <= 40 else 512


def chunk_for(cfg, num_features: int, n: int) -> int:
    """`effective_chunk`, doubled until the data takes at most 40,000
    chunks (the JAX package's scalar-prefetch bound, kept as a gate so
    both packages choose the same layout); a pinned ``tpu_chunk`` that
    has to grow says so."""
    C0 = C = effective_chunk(cfg, num_features)
    while n // C > 40_000:
        C *= 2
    if C != C0 and int(getattr(cfg, "tpu_chunk", 0) or 0):
        log.warning(f"tpu_chunk={C0} cannot hold {n} rows within 40000 "
                    f"chunks; using tpu_chunk={C} instead")
    return C


def aligned_num_chunks(n: int, cfg, spec_slots: int,
                       num_features: int = 0) -> int:
    """NC of the engine's record matrix: data chunks + one fresh chunk per
    speculative slot + 2."""
    C = chunk_for(cfg, num_features, n)
    return (n + C - 1) // C + spec_slots + 2


def _bpw_for_bits(bits: int) -> int:
    """Bins per 32-bit word at a bin bit width."""
    return {4: 8, 6: 5, 8: 4}[bits]


def lane_layout(wcnt: int, compact: bool = False, ext: bool = False,
                with_bag: bool = False, num_class: int = 1,
                with_prob: bool = False):
    """(lane indices, W padded to a multiple of 8) of a record with
    ``wcnt`` bin words: EXT score, grad, hess and rid; COMPACT
    ``num_class`` score lanes (``score`` the first, class k at score +
    k), with ``with_prob`` as many probability lanes (``prob``), then
    meta (its bag is meta bit 31); or STANDARD score, label, grad, hess,
    rid and weight. ``with_bag`` adds EXT's and STANDARD's f32 bag lane
    last."""
    ls = wcnt
    if ext:
        lanes = dict(score=ls, grad=ls + 1, hess=ls + 2, rid=ls + 3)
        w = wcnt + 4
    elif compact:
        lanes = dict(score=ls)
        w = wcnt + num_class
        if with_prob:
            lanes["prob"] = w
            w += num_class
        lanes["meta"] = w
        w += 1
    else:
        lanes = dict(score=ls, label=ls + 1, grad=ls + 2, hess=ls + 3,
                     rid=ls + 4, weight=ls + 5)
        w = wcnt + 6
    if with_bag and not compact:
        lanes["bag"] = w
        w += 1
    return lanes, ((w + 7) // 8) * 8


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_records(bins: torch.Tensor, label, weight, chunk: int,
                 compact: bool = False, max_bin: int = 0,
                 rid_base: int = 0, ext: bool = False,
                 with_bag: bool = False, num_class: int = 1,
                 with_prob: bool = False):
    """[N, F] uint8 bins -> ([NC, W, C] int32 records on the device of
    ``bins``, wcnt, W, cnts, bits); cnts[i] (numpy) is the number of valid
    rows of chunk i. Bits equal the JAX package's ``pack_records``: bin
    words at the narrowest width the bin range allows (4 bits under 16
    bins, 6 under 64, else 8), pad rows zero, rids from ``rid_base``;
    every row in the bag at first (``with_bag``: the bag lane 1.0; COMPACT
    sets its meta bag bit always). COMPACT's meta label is the label bit,
    or with ``num_class`` > 1 the integer class (& 127); its score and
    probability lanes start at zero."""
    n, f = bins.shape
    dev = bins.device
    bmax = max(int(bins.max()) if n * f else 0, max_bin - 1)
    bits = 4 if bmax < 16 else (6 if bmax < 64 else 8)
    bpw = _bpw_for_bits(bits)
    wcnt = (f + bpw - 1) // bpw
    lanes, w_pad = lane_layout(wcnt, compact, ext, with_bag, num_class,
                               with_prob)
    nc = (n + chunk - 1) // chunk
    n_pad = nc * chunk
    rec = torch.zeros((nc, w_pad, chunk), dtype=torch.int32, device=dev)
    # a block of whole chunks at a time, read row by row (a wide table's
    # columns one by one would be strided reads of the whole matrix): its
    # words are the sums of each word's bins shifted into their fields
    shifts = torch.arange(bpw, device=dev, dtype=torch.int64) * bits
    step = max(1, (1 << 24) // max(wcnt * bpw * chunk, 1)) * chunk
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        blk = torch.zeros((hi - lo, wcnt * bpw), dtype=torch.int64,
                          device=dev)
        blk[:, :f] = bins[lo:hi]
        words = (blk.view(hi - lo, wcnt, bpw) << shifts).sum(2)
        c0, c1 = lo // chunk, (hi + chunk - 1) // chunk
        full = torch.zeros(((c1 - c0) * chunk, wcnt), dtype=torch.int64,
                           device=dev)
        full[:hi - lo] = words
        rec[c0:c1, :wcnt, :] = _as_int32(full).view(
            c1 - c0, chunk, wcnt).transpose(1, 2)
    rid = rid_base + torch.arange(n_pad, dtype=torch.int64, device=dev)

    def lane(vals: torch.Tensor) -> torch.Tensor:
        return vals.view(nc, chunk)

    if ext:
        rec[:, lanes["rid"], :] = lane(rid.to(torch.int32))
    elif compact:
        lab = torch.as_tensor(np.asarray(label), device=dev)
        lab = (lab.to(torch.int64) & META_LABEL_MASK) if num_class > 1 \
            else (lab > 0).to(torch.int64)
        meta = rid & META_RID_MASK
        meta[:n] |= (lab << META_LABEL) | (1 << META_BAG)
        rec[:, lanes["meta"], :] = lane(_as_int32(meta))
    else:
        f32 = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        f32[:n] = torch.as_tensor(np.asarray(label, np.float32), device=dev)
        rec[:, lanes["label"], :] = lane(f32.view(torch.int32))
        rec[:, lanes["rid"], :] = lane(rid.to(torch.int32))
        wv = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        wv[:n] = 1.0 if weight is None else torch.as_tensor(
            np.asarray(weight, np.float32), device=dev)
        rec[:, lanes["weight"], :] = lane(wv.view(torch.int32))
    if "bag" in lanes:
        bag = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        bag[:n] = 1.0
        rec[:, lanes["bag"], :] = lane(bag.view(torch.int32))
    cnts = np.full(nc, chunk, np.int32)
    if nc:
        cnts[-1] = n - (nc - 1) * chunk
    return rec, wcnt, w_pad, cnts, bits


def pack_route2(db, nb, boff=0, bpk=0):
    """Route word 2: default_bin | (num_bin - 1) << 8 | boff << 16 | bpk
    << 24 (8-bit fields, so num_bin <= 256 and, under bundling, a
    bundle's offset below 256, which its 256-bin cap keeps), the JAX
    package's layout. Works on ints and numpy arrays."""
    return ((db & 255) | (((nb - 1) & 255) << 8) | ((boff & 255) << 16)
            | ((bpk & 1) << 24))


def unpack_bundle(binv: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """A bundled storage value -> the split feature's bin, from route
    word 2's fields (JAX package: `_unpack_bundle`): the map of
    `ops/partition.py::bundle_unpack`. Runs before the routing, which
    takes feature bins. ``r2`` broadcasts against ``binv``."""
    return bundle_unpack(binv, (r2 >> 16) & 255, (r2 >> 24) & 1, r2 & 255,
                         ((r2 >> 8) & 255) + 1)


def goes_left(binv: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
              valid: torch.Tensor,
              catw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference DenseBin::Split routing (dense_bin.hpp:195-283):
    numerical with missing None/Zero/NaN; with ``catw`` (each row's word
    ``binv >> 5`` of its split's bitset, `cat_word`) a categorical split
    (r1's R_CAT bit) sends a row left iff its bin's bit is set, the
    missing logic bypassed; copy-through routes every valid row left.
    ``r1``/``r2`` broadcast against ``binv``."""
    thr = r1 & 255
    dl = ((r1 >> R_DL) & 1) != 0
    mt = (r1 >> R_MT) & 3
    copy = ((r1 >> R_COPY) & 1) != 0
    db = r2 & 255
    nb = ((r2 >> 8) & 255) + 1
    is_def = (((mt == MISSING_ZERO_C) & (binv == db))
              | ((mt == MISSING_NAN_C) & (binv == nb - 1)))
    left = torch.where(is_def, dl, binv <= thr)
    if catw is not None:
        left = torch.where(((r1 >> R_CAT) & 1) != 0,
                           ((catw >> (binv & 31)) & 1) != 0, left)
    return (copy | left) & valid


def cat_word(cbits: torch.Tensor, ks: torch.Tensor,
             binv: torch.Tensor) -> torch.Tensor:
    """Each row's bitset word: ``cbits`` is the round's flat compact table
    (int32 [(K + 1) * 8], 8 words a split, row K the pad row), ``ks`` the
    split id of each row's chunk (broadcast against ``binv``); word
    ``binv >> 5``, 0 from word 8 on (JAX package: `_cat_word`)."""
    bw = binv >> 5
    w = cbits[(ks.long() * 8 + bw.clamp(max=7)).clamp(max=cbits.numel() - 1)]
    return torch.where(bw < 8, w, 0)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def _split_bins(records: torch.Tensor, r1: torch.Tensor,
                wsel: torch.Tensor, bits: int) -> torch.Tensor:
    """[NC, C] bin of each chunk's split feature (word lane wsel, shift
    from r1)."""
    nc, _, C = records.shape
    word = records[torch.arange(nc, device=records.device), wsel.long()]
    shift = ((r1 >> R_SHIFT) & 31)[:, None]
    return (word >> shift) & ((1 << bits) - 1)


def _valid_rows(meta: torch.Tensor, C: int) -> torch.Tensor:
    pos = torch.arange(C, device=meta.device)
    return pos[None, :] < (meta & META_CNT_MASK)[:, None]


class ClassGrad(NamedTuple):
    """Class ``cls``'s gradient of a K-class COMPACT record (JAX package:
    the engine's `_mc_payload_fn`): ``kind`` "prob" reads the f32
    probability ``lane`` and gives g = p - [label == cls], h = (2 p)(1 -
    p) (softmax); "score" reads the class's score ``lane`` and gives the
    logistic loss of label ``label == cls`` with ``sigmoid``, ``w_pos``
    and ``w_neg`` (one-vs-all). The label is meta bits 24-30 of lane
    ``meta_lane``, whose bit 31 is the bag bit."""
    kind: str
    cls: int
    lane: int
    meta_lane: int
    sigmoid: float = 1.0
    w_pos: float = 1.0
    w_neg: float = 1.0


def _meta_lane(grad, wcnt: int) -> int:
    """The COMPACT meta lane: a class gradient's own, else the lane after
    the score."""
    return grad.meta_lane if isinstance(grad, ClassGrad) else wcnt + 1


def _payload(records: torch.Tensor, wcnt: int, grad, gh_off: int = 2):
    """[NC, C] (g, h): the grad/hess lanes at ``wcnt + gh_off`` (grad
    None; STANDARD: 2, EXT: 1), or recomputed by ``grad`` from a COMPACT
    record: a `PointGrad` from the score lane and the meta label bits, a
    `ClassGrad` from its class's lane and whether the meta label is its
    class."""
    if grad is None:
        return (records[:, wcnt + gh_off].view(torch.float32),
                records[:, wcnt + gh_off + 1].view(torch.float32))
    label = (records[:, _meta_lane(grad, wcnt)] >> META_LABEL) \
        & META_LABEL_MASK
    if isinstance(grad, ClassGrad):
        v = records[:, grad.lane].view(torch.float32)
        is_lab = (label == grad.cls).to(torch.float32)
        if grad.kind == "prob":
            return v - is_lab, 2.0 * v * (1.0 - v)
        return PointGrad("binary", grad.sigmoid, grad.w_pos,
                         grad.w_neg)(v, is_lab)
    score = records[:, wcnt].view(torch.float32)
    return grad(score, label.to(torch.float32))


def _in_bag(records: torch.Tensor, wcnt: int, bag_lane: int,
            meta_lane: Optional[int] = None):
    """[NC, C] rows in the bag (JAX package: `_payload_gh`'s rule), or
    None for ``bag_lane`` -1: -2 reads COMPACT's meta bit 31 (of lane
    ``meta_lane``, by default ``wcnt + 1``), >= 0 the f32 lane
    ``bag_lane`` (> 0.5)."""
    if bag_lane == -2:
        return records[:, wcnt + 1 if meta_lane is None else meta_lane] < 0
    if bag_lane >= 0:
        return records[:, bag_lane].view(torch.float32) > 0.5
    return None


def _slot_histograms(records, take, slot_of_chunk, num_slots, num_features,
                     num_bins, wcnt, bits, grad, gh_off,
                     bag_lane=-1) -> torch.Tensor:
    """hist[num_slots, F, B, 3]: (g, h, 1) of the rows where ``take``
    [NC, C] is set, into the slot of their chunk; one ``index_add_`` per
    feature. The sums run in f64 and round to f32 once: a plain f32
    accumulator drifts when a cell sums millions of equal gradients (the
    first tree's, from a constant score), by far more than the kernel's
    blocked f32 sums do. Rows out of the bag (`_in_bag`) add nothing."""
    nc, _, C = records.shape
    dev = records.device
    bag = _in_bag(records, wcnt, bag_lane, _meta_lane(grad, wcnt))
    if bag is not None:
        take = take & bag
    out = torch.zeros((num_slots, num_features, num_bins, NUM_STATS),
                      dtype=torch.float32, device=dev)
    sel = take.reshape(-1).nonzero()[:, 0]
    if sel.numel() == 0:
        return out
    g, h = _payload(records, wcnt, grad, gh_off)
    pay = torch.stack([g.reshape(-1)[sel], h.reshape(-1)[sel],
                       torch.ones(sel.numel(), dtype=torch.float32,
                                  device=dev)], dim=1).double()
    chunk = sel // C
    row = sel % C
    slot = slot_of_chunk.long()[chunk]
    bpw = _bpw_for_bits(bits)
    for f in range(num_features):
        b = (records[chunk, f // bpw, row] >> ((f % bpw) * bits)) \
            & ((1 << bits) - 1)
        ok = b < num_bins
        cell = slot * num_bins + b.long()
        acc = torch.zeros((num_slots * num_bins, NUM_STATS),
                          dtype=torch.float64, device=dev)
        acc.index_add_(0, cell[ok], pay[ok])
        out[:, f] = acc.view(num_slots, num_bins, NUM_STATS).float()
    return out


def slot_hist_pass_plain(records, slots, meta, num_slots, num_features,
                         num_bins, wcnt, bits, grad=None, gh_off=2,
                         bag_lane=-1):
    """Plain twin of `slot_hist_pass`."""
    nc, _, C = records.shape
    in_slot = (slots >= 0) & (slots < num_slots)
    take = _valid_rows(meta, C) & in_slot[:, None]
    return _slot_histograms(records, take, slots, num_slots, num_features,
                            num_bins, wcnt, bits, grad, gh_off, bag_lane)


def _cat_words(cbits, ks, binv):
    """`cat_word` of every row, from an all-zero table when ``cbits`` is
    None (as the kernels read a missing table)."""
    if cbits is None:
        return torch.zeros_like(binv)
    return cat_word(cbits, ks[:, None], binv)


def count_pass_plain(records, r1, r2, meta, wsel, kslots, num_slots, bits,
                     cbits=None, bundled=False):
    """Plain twin of `count_pass`."""
    nc, _, C = records.shape
    binv = _split_bins(records, r1, wsel, bits)
    if bundled:
        binv = unpack_bundle(binv, r2[:, None])
    left = goes_left(binv, r1[:, None], r2[:, None], _valid_rows(meta, C),
                     _cat_words(cbits, kslots, binv))
    per_chunk = left.sum(dim=1).to(torch.int32)
    ok = (kslots >= 0) & (kslots < num_slots)
    out = torch.zeros(num_slots, dtype=torch.int32, device=records.device)
    out.index_add_(0, kslots[ok].long(), per_chunk[ok])
    return out


def move_pass_plain(records, r1, r2, basel, baser, meta, wsel, hslots,
                    num_slots, num_features, num_bins, wcnt, bits, w_used,
                    grad=None, out=None, gh_off=2, cbits=None, bag_lane=-1,
                    bundled=False):
    """Plain twin of `move_pass`: block-segmented exclusive ranks of the
    left and right rows in (chunk, row) order, one scatter of the used
    lanes, copy chunks' used lanes moved whole, and the smaller children's
    histograms from the in-bag rows that go to the smaller side."""
    nc, W, C = records.shape
    dev = records.device
    out = records.clone() if out is None else out
    valid = _valid_rows(meta, C)
    cnt = meta & META_CNT_MASK
    copy = ((r1 >> R_COPY) & 1) != 0
    hslot = hslots & 0xFFFFFF
    binv = _split_bins(records, r1, wsel, bits)
    if bundled:
        binv = unpack_bundle(binv, r2[:, None])
    left = goes_left(binv, r1[:, None], r2[:, None], valid,
                     _cat_words(cbits, hslot, binv))
    split = valid & ~copy[:, None]
    go_l = split & left
    go_r = split & ~left
    iota = torch.arange(nc, device=dev)
    first = ((meta >> META_FIRST) & 1) != 0
    block0 = torch.cummax(torch.where(first, iota, 0), dim=0).values

    def ranks(mask):
        m = mask.reshape(-1).to(torch.int64)
        excl = (torch.cumsum(m, 0) - m).view(nc, C)
        return excl - excl[block0, 0][:, None]

    lanes = torch.arange(w_used, device=dev)
    for mask, base in ((go_l, basel), (go_r, baser)):
        rank = ranks(mask)
        c, r = mask.nonzero(as_tuple=True)
        d = rank[c, r]
        dc = base.long()[c] + d // C
        out[dc[:, None], lanes[None, :], (d % C)[:, None]] = \
            records[c[:, None], lanes[None, :], r[:, None]]
    cc = (copy & (cnt > 0)).nonzero()[:, 0]
    out[basel.long()[cc], :w_used] = records[cc, :w_used]
    side_r = ((hslots >> 24) & 1) != 0
    take = torch.where(side_r[:, None], go_r, go_l) \
        & (hslot < num_slots)[:, None]
    hist = _slot_histograms(records, take, hslot, num_slots, num_features,
                            num_bins, wcnt, bits, grad, gh_off, bag_lane)
    return out, hist


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _lib():
    if not _fns:
        from ..utils import cuda_build
        lib = cuda_build.load("aligned")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {
            "lgbt_count_pass": [p, ctypes.c_longlong, i, i, p, p, p, p, p,
                                p, i, i, i, i, i, p, p, p, p],
            "lgbt_count_occupancy": [i, i],
            "lgbt_move_partition": [p, i, i, i, i, i, i, i, p, p, p, p, p,
                                    p, p, p, i, i, p, p, p],
            "lgbt_slot_hist": [p, i, i, i, i, i, i, i, i, i, i, i, i, p, p,
                               i, i, f, f, f, i, i, i, i, p, p, p, p],
            "lgbt_slot_hist_occupancy": [i],
            "lgbt_aligned_smem_optin": [i],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns


def _check_cuda(records: torch.Tensor, *arrays: torch.Tensor) -> None:
    if records.dtype != torch.int32 or records.dim() != 3 \
            or not records.is_contiguous():
        raise ValueError("records must be a contiguous int32 [NC, W, C] "
                         "tensor")
    nc = records.shape[0]
    for a in arrays:
        if a.dtype != torch.int32 or a.shape != (nc,) \
                or not a.is_contiguous() or a.device != records.device:
            raise ValueError("per-chunk arrays must be contiguous int32 [NC] "
                             "tensors on the device of records")


def _cbits_ptr(cbits: Optional[torch.Tensor], records: torch.Tensor,
               num_slots: int) -> int:
    """The device address of the round's bitset table (0 for None),
    checked: contiguous int32 on the device of records, at least
    (num_slots + 1) * 8 words."""
    if cbits is None:
        return 0
    if cbits.dtype != torch.int32 or cbits.dim() != 1 \
            or not cbits.is_contiguous() or cbits.device != records.device \
            or cbits.numel() < (num_slots + 1) * 8:
        raise ValueError("cbits must be a contiguous int32 tensor of at "
                         "least (num_slots + 1) * 8 words on the device of "
                         "records")
    return cbits.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _grad_args(grad, wcnt: int):
    """(kind, c0, c1, c2, class, value lane, meta lane) of the kernels'
    payload: a `PointGrad`'s constants, or a `ClassGrad`'s sigmoid and
    label weights."""
    if grad is None:
        return 0, 0.0, 0.0, 0.0, 0, 0, wcnt + 1
    if isinstance(grad, ClassGrad):
        return (_GRAD_KIND[grad.kind], float(grad.sigmoid),
                float(grad.w_pos), float(grad.w_neg), grad.cls, grad.lane,
                grad.meta_lane)
    return (_GRAD_KIND[grad.kind], float(grad.c0), float(grad.c1),
            float(grad.c2), 0, wcnt, _meta_lane(grad, wcnt))


def slot_hist_smem(C: int, num_features: int, num_bins: int,
                   smem_optin: int) -> Tuple[int, int, int]:
    """(tile_chunks, features per tile, shared bytes per CTA) of the slot
    histogram kernel: a tile is `SLOT_HIST_TILE_ROWS` rows of whole chunks
    (at most `SLOT_HIST_MAX_TILE_CHUNKS`), and the features are cut into
    the fewest tiles of equal size whose cells and one tile's chunk
    metadata fit ``smem_optin`` bytes."""
    if C > SLOT_HIST_TILE_ROWS:
        raise ValueError(f"slot_hist_pass takes chunks of at most "
                         f"{SLOT_HIST_TILE_ROWS} rows, got {C}")
    tile_chunks = min(SLOT_HIST_MAX_TILE_CHUNKS, SLOT_HIST_TILE_ROWS // C)
    meta = 8 * tile_chunks + 8
    per_feature = _SLOT_HIST_CELL_BYTES * num_bins
    fit = (smem_optin - meta) // per_feature
    if fit < 1:
        raise ValueError(f"{num_bins} bins ({per_feature} B a feature) "
                         f"exceed the {smem_optin} B of shared memory")
    fpb = -(-num_features // -(-num_features // fit))
    return tile_chunks, fpb, per_feature * fpb + meta


def move_smem(C: int, w_used: int, smem_optin: int) -> Tuple[int, int]:
    """(lanes a stage, dynamic shared bytes per CTA) of the partition
    kernel: as many of the ``w_used`` lanes of a chunk of ``C`` rows as fit
    ``smem_optin`` beside the mbarrier, the permutation, the ballots and
    the 8 bitset words (all of them at HIGGS 63 / 255 and MSLR EXT: 32,
    36 and 78 KB of stage); fewer lanes are staged and stored in turn.
    Chunks of more than 65,535 rows, or of rows not a multiple of 4
    (16-byte bulk copies), are refused."""
    if C > 65535 or C % 4:
        raise ValueError(f"move_pass takes chunks of at most 65,535 rows, "
                         f"a multiple of 4, got {C}")
    fixed = 16 + -(-2 * C // 16) * 16 + 8 * -(-C // 32) + 32
    fit = (smem_optin - _MOVE_STATIC_SLACK - fixed) // (4 * C)
    if fit < 1:
        raise ValueError(f"a chunk of {C} rows does not fit the "
                         f"{smem_optin} B of shared memory")
    lanes = min(w_used, fit)
    return lanes, fixed + 4 * lanes * C


def slot_hist_launch_shape(nc: int, C: int, num_features: int,
                           num_bins: int, ctas_per_sm: int, num_sms: int,
                           smem_optin: int):
    """(tile_chunks, features per tile, shared bytes per CTA, grid_x,
    grid_y) of the slot histogram kernel, given the CTAs of 1024
    threads an SM holds at that shared memory
    (`slot_hist_ctas_per_sm` on the card): grid_y feature tiles, and for
    each that share of the CTAs the SMs hold (or one per row tile if
    fewer), each taking row tiles in turn."""
    tile_chunks, fpb, smem = slot_hist_smem(C, num_features, num_bins,
                                            smem_optin)
    if ctas_per_sm < 1:
        raise ValueError(f"{fpb} features x {num_bins} bins ({smem} B) "
                         "fit no CTA on an SM")
    grid_y = -(-num_features // fpb)
    tiles = -(-nc // tile_chunks)
    grid_x = max(1, min(tiles, ctas_per_sm * num_sms // grid_y))
    return tile_chunks, fpb, smem, grid_x, grid_y


def slot_hist_ctas_per_sm(ordinal: int, smem: int) -> int:
    """CTAs of the slot histogram kernel with ``smem`` bytes of shared
    memory each that the CUDA occupancy calculator fits on an SM of
    device ``ordinal`` (0 where one does not fit)."""
    key = (ordinal, smem)
    if key not in _ctas:
        with torch.cuda.device(ordinal):
            n = _lib()["lgbt_slot_hist_occupancy"](smem)
        if n < 0:
            raise RuntimeError("slot_hist_pass: the CUDA occupancy query "
                               "failed")
        _ctas[key] = n
    return _ctas[key]


def _check_bag_lane(bag_lane: int, W: int, wcnt: int, grad) -> None:
    """-1; -2 with a COMPACT ``grad``; or a lane past the bin words; and
    a `ClassGrad`'s lanes among the value lanes."""
    if isinstance(grad, ClassGrad) and not (
            wcnt <= grad.lane < W and wcnt <= grad.meta_lane < W):
        raise ValueError(f"class lanes {grad.lane}, {grad.meta_lane} "
                         f"outside the value lanes [{wcnt}, {W})")
    if bag_lane == -1 or (bag_lane == -2 and grad is not None) \
            or wcnt <= bag_lane < W:
        return
    raise ValueError(f"bag_lane={bag_lane} is none of -1, -2 (COMPACT "
                     f"records) or a value lane in [{wcnt}, {W})")


def _slot_hist_cuda(records, slots, meta, num_slots, num_features,
                    num_bins, wcnt, bits, grad, gh_off, bag_lane=-1):
    dev = records.device
    nc, W, C = records.shape
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins={num_bins} outside [1, 256]")
    _check_bag_lane(bag_lane, W, wcnt, grad)
    fns = _lib()
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    optin = fns["lgbt_aligned_smem_optin"](ordinal)
    _, _, smem = slot_hist_smem(C, num_features, num_bins, optin)
    tile_chunks, fpb, smem, grid_x, _ = slot_hist_launch_shape(
        nc, C, num_features, num_bins, slot_hist_ctas_per_sm(ordinal, smem),
        torch.cuda.get_device_properties(ordinal).multi_processor_count,
        optin)
    cells = (num_slots, num_features, num_bins)
    out = torch.empty(cells + (NUM_STATS,), dtype=torch.float32, device=dev)
    gh = torch.zeros(cells + (2,), dtype=torch.float64, device=dev)
    cnt = torch.zeros(cells, dtype=torch.int32, device=dev)
    kind, sig, wp, wn, cls, vlane, mlane = _grad_args(grad, wcnt)
    with torch.cuda.device(dev):
        err = fns["lgbt_slot_hist"](
            records.data_ptr(), nc, W, C, wcnt, gh_off, bits, num_features,
            num_bins, fpb, tile_chunks, grid_x, smem, slots.data_ptr(),
            meta.data_ptr(), num_slots, kind, sig, wp, wn, cls, vlane,
            mlane, bag_lane, gh.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            _stream(dev))
    _raise_on(err, "slot_hist_pass")
    return out


def slot_hist_pass(records, slots, meta, num_slots, num_features, num_bins,
                   wcnt, bits, grad=None, gh_off=2, bag_lane=-1):
    """hist[num_slots, F, num_bins, 3] over the valid rows (``meta &
    META_CNT_MASK``) of every chunk whose ``slots`` entry is in
    [0, num_slots); chunks mapped to ``num_slots`` (the dummy) are
    skipped. ``grad`` None reads the grad/hess lanes at ``wcnt + gh_off``
    (STANDARD: 2, EXT: 1); a `PointGrad` recomputes them from a COMPACT
    record. On the card each slot's rows of a tile (at most
    `SLOT_HIST_TILE_ROWS`) sum in fixed point scaled to their largest
    |g| (|h|), off by at most 1.9e-6 of it, then in f64, rounded to f32
    once: within 2e-6 x the slot's sum of |g| (|h|) of the twin's f64
    sums, not bit-equal to them; counts are exact. A tile's run of one
    slot that holds a non-finite g (h) sums that stat in f64
    throughout, so NaN and Inf come out as the twin's. ``bag_lane`` -1
    takes every valid row; -2 (COMPACT) only rows whose meta bit 31 is
    set, >= 0 (STANDARD, EXT) only rows whose f32 lane ``bag_lane`` is
    above 0.5: the kernel's bag branch, chosen by the launch, skips the
    others in the scale pass and the sums alike."""
    if not records.is_cuda:
        return slot_hist_pass_plain(records, slots, meta, num_slots,
                                    num_features, num_bins, wcnt, bits, grad,
                                    gh_off, bag_lane)
    _check_cuda(records, slots, meta)
    out = _slot_hist_cuda(records, slots, meta, num_slots, num_features,
                          num_bins, wcnt, bits, grad, gh_off, bag_lane)
    LAUNCHES["slot_hist_pass"] += 1
    if bag_lane != -1:
        LAUNCHES["slot_hist_pass_bag"] += 1
    if isinstance(grad, ClassGrad):
        CLASS_LAUNCHES["slot_hist_pass"] += 1
    elif grad is not None:
        POINT_LAUNCHES["slot_hist_pass", grad.kind] += 1
    return out


def count_launch_shape(nc: int, num_slots: int, ctas_per_sm: int,
                       num_sms: int, smem_optin: int) -> Tuple[int, int]:
    """(dynamic shared bytes per CTA, CTAs) of the count pass: a u32
    counter a slot, within ``smem_optin``; the CTAs the SMs hold
    (``ctas_per_sm`` from the occupancy calculator on the card), or
    fewer when the chunks give fewer than one a warp, at least one (with
    no chunk it still writes the zero counts)."""
    smem = 4 * num_slots
    if smem > smem_optin - _MOVE_STATIC_SLACK:
        raise ValueError(f"{num_slots} slots ({smem} B of counters) exceed "
                         f"the {smem_optin} B of shared memory")
    if ctas_per_sm < 1:
        raise ValueError(f"{num_slots} slots' counters fit no CTA on an SM")
    return smem, max(1, min(ctas_per_sm * num_sms,
                            -(-nc // _COUNT_WARPS)))


def _count_shape(ordinal: int, num_slots: int,
                 bundled: bool = False) -> Tuple[int, int, int]:
    """(CTAs an SM, SMs, shared-memory opt-in) of the count pass (its
    ``bundled`` instantiation) at ``num_slots`` on device ``ordinal``,
    queried once."""
    key = (ordinal, num_slots, bool(bundled))
    st = _count_shapes.get(key)
    if st is None:
        fns = _lib()
        optin = fns["lgbt_aligned_smem_optin"](ordinal)
        smem, _ = count_launch_shape(1, num_slots, 1, 1, optin)
        with torch.cuda.device(ordinal):
            n = fns["lgbt_count_occupancy"](smem, int(bundled))
        if n < 0:
            raise RuntimeError("count_pass: the CUDA occupancy query failed")
        st = (n, torch.cuda.get_device_properties(
            ordinal).multi_processor_count, optin)
        _count_shapes[key] = st
    return st


def _count_scratch_for(dev: torch.device, ordinal: int, stream: int,
                       num_slots: int) -> torch.Tensor:
    """The zeroed scratch of the count passes on ``stream``: int32 [cap +
    1], cap >= ``num_slots`` counters, then the ticket."""
    key = (ordinal, stream)
    s = _count_scratch.get(key)
    if s is None or s.numel() - 1 < num_slots:
        cap = max(num_slots, 0 if s is None else s.numel() - 1)
        s = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        _count_scratch[key] = s
    return s


def count_pass(records, r1, r2, meta, wsel, kslots, num_slots, bits,
               cbits=None, bundled=False):
    """[num_slots] int32 left rows per compact slot: kslots[i] is the slot
    of chunk i's split (``num_slots`` skips); r1/r2/meta/wsel/cbits/
    bundled as for `move_pass` (copy bit clear on counted chunks; a
    chunk's bitset is row kslots[i] of cbits); a chunk's rows r <
    min(meta count, C). On the card one launch a call (no zeroing): the
    output comes from ``torch.empty``."""
    if not records.is_cuda:
        return count_pass_plain(records, r1, r2, meta, wsel, kslots,
                                num_slots, bits, cbits, bundled)
    _check_cuda(records, r1, r2, meta, wsel, kslots)
    cptr = _cbits_ptr(cbits, records, num_slots)
    out = torch.empty(num_slots, dtype=torch.int32, device=records.device)
    if num_slots == 0:
        return out
    _count_cuda(records, r1, r2, meta, wsel, kslots, num_slots, bits, out,
                cptr, bundled)
    LAUNCHES["count_pass"] += 1
    if cbits is not None:
        LAUNCHES["count_pass_cat"] += 1
    if bundled:
        BUNDLED_LAUNCHES["count_pass"] += 1
    return out


def _count_cuda(records, r1, r2, meta, wsel, kslots, num_slots, bits,
                out, cptr: int = 0, bundled: bool = False) -> None:
    """`count_pass`'s launch alone, on checked arguments, into ``out``
    [num_slots] (num_slots >= 1); ``cptr`` the bitset table's address,
    ``bundled`` the kernel's instantiation that unpacks bundles."""
    nc, W, C = records.shape
    dev = records.device
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    _, grid = count_launch_shape(nc, num_slots,
                                 *_count_shape(ordinal, num_slots, bundled))
    vec = int(C % 4 == 0 and records.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sc = _count_scratch_for(dev, ordinal, stream, num_slots)
        err = _lib()["lgbt_count_pass"](
            records.data_ptr(), nc, W, C, r1.data_ptr(), r2.data_ptr(),
            meta.data_ptr(), wsel.data_ptr(), kslots.data_ptr(), cptr,
            num_slots, bits, int(bool(bundled)), vec, grid, sc.data_ptr(),
            sc.data_ptr() + 4 * (sc.numel() - 1), out.data_ptr(), stream)
    if err != 0:
        _count_scratch.pop((ordinal, stream), None)
        raise RuntimeError(f"count_pass kernel launch failed: CUDA error "
                           f"{err} (CTAs={grid}, slots={num_slots})")


def move_pass(records, r1, r2, basel, baser, meta, wsel, hslots, num_slots,
              num_features, num_bins, wcnt, bits, w_used, grad=None,
              out: Optional[torch.Tensor] = None, gh_off: int = 2,
              cbits: Optional[torch.Tensor] = None, bag_lane: int = -1,
              bundled: bool = False):
    """Stable two-way partition of every block in one pass, plus the
    smaller children's histograms.

    Per chunk i: r1/r2 route words, meta = count | first << 20 | last <<
    21, wsel the split word lane. A split chunk (copy bit clear) sends its
    valid rows to the left child's chunks from basel[i] or the right's
    from baser[i], after the rows of the block's earlier chunks, in row
    order; a copy chunk moves whole to basel[i]. hslots[i] = slot | side
    << 24 names the compact slot of the block's smaller child (side 0:
    the left rows), ``num_slots`` skips. A categorical split (r1's R_CAT
    bit) routes by row ``slot`` of ``cbits`` (int32 [(num_slots + 1) *
    8]; None reads as all zero). ``bundled``: the split word holds
    bundled storage columns, and each chunk's split value is unpacked to
    its feature's bin from r2's offset and packing (`unpack_bundle`)
    before it is routed; the histograms stay over the storage columns.
    ``grad``, ``gh_off`` and ``bag_lane`` as for `slot_hist_pass`: every
    row moves, in the bag or not (its meta word or bag lane with it), and
    the histograms take the in-bag rows.

    Returns (records_out, hist[num_slots, F, num_bins, 3]). Lanes >=
    ``w_used`` of moved rows and of copy chunks, and rows outside the new
    layout, keep whatever ``out`` held (a fresh copy of ``records`` on the
    CPU). On the card the partition is one memset and one launch, then
    the histogram's two."""
    if not records.is_cuda:
        return move_pass_plain(records, r1, r2, basel, baser, meta, wsel,
                               hslots, num_slots, num_features, num_bins,
                               wcnt, bits, w_used, grad, out, gh_off, cbits,
                               bag_lane, bundled)
    _check_cuda(records, r1, r2, basel, baser, meta, wsel, hslots)
    cptr = _cbits_ptr(cbits, records, num_slots)
    dev = records.device
    if out is None:
        out = torch.empty_like(records)
    elif out.shape != records.shape or out.dtype != torch.int32 \
            or not out.is_contiguous() or out.device != dev \
            or out.data_ptr() == records.data_ptr():
        raise ValueError("out must be another contiguous int32 tensor of "
                         "the shape of records")
    nslot, ncnt = _move_partition_cuda(records, r1, r2, basel, baser, meta,
                                       wsel, hslots, num_slots, bits,
                                       w_used, out, cptr, bundled)
    hist = _slot_hist_cuda(out, nslot, ncnt, num_slots, num_features,
                           num_bins, wcnt, bits, grad, gh_off, bag_lane)
    LAUNCHES["move_pass"] += 1
    if cbits is not None:
        LAUNCHES["move_pass_cat"] += 1
    if bag_lane != -1:
        LAUNCHES["move_pass_bag"] += 1
    if bundled:
        BUNDLED_LAUNCHES["move_pass"] += 1
    if isinstance(grad, ClassGrad):
        CLASS_LAUNCHES["move_pass"] += 1
    elif grad is not None:
        POINT_LAUNCHES["move_pass", grad.kind] += 1
    return out, hist


def _move_partition_cuda(records, r1, r2, basel, baser, meta, wsel, hslots,
                         num_slots, bits, w_used, out, cptr: int = 0,
                         bundled: bool = False):
    """`move_pass`'s partition into ``out`` (one memset of its scratch,
    one launch of the partition kernel, its instantiation that unpacks
    bundles where ``bundled``); ``cptr`` the bitset table's address (0:
    none). Returns the smaller children's chunk map (nslot,
    ncnt), the slots and row counts its histogram takes (ncnt 0 on every
    other chunk)."""
    nc, W, C = records.shape
    dev = records.device
    if not 1 <= w_used <= W:
        raise ValueError(f"w_used={w_used} outside [1, {W}]")
    fns = _lib()
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    lanes, smem = move_smem(C, w_used, fns["lgbt_aligned_smem_optin"](
        ordinal))
    # flag words (u64), the ticket and a pad word, nslot, ncnt
    scratch = torch.empty(4 * nc + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fns["lgbt_move_partition"](
            records.data_ptr(), nc, W, C, w_used, lanes, smem, bits,
            r1.data_ptr(), r2.data_ptr(), meta.data_ptr(), wsel.data_ptr(),
            basel.data_ptr(), baser.data_ptr(), hslots.data_ptr(), cptr,
            num_slots, int(bool(bundled)), scratch.data_ptr(), out.data_ptr(),
            _stream(dev))
    _raise_on(err, "move_pass")
    return scratch[2 * nc + 2:3 * nc + 2], scratch[3 * nc + 2:]
