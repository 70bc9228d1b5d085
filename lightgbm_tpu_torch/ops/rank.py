"""The lambdarank gradient, kernel B6 (port of lightgbm_tpu/ops/
pallas_rank.py, whose Pallas kernel computes the bucketed formula of
`LambdarankNDCG._make_grad_fn` in lightgbm_tpu/ops/objectives.py).

`lambdarank_grad` takes the training scores in row order and the query
layout as CSR offsets, and returns every document's (g, h): the sum over
the document's pairs with a different label of the NDCG-weighted
logistic pair loss's first and second derivative. On a CUDA tensor it
launches the kernel of ``ops/csrc/rank.cu`` or raises; on a CPU tensor
it runs `lambdarank_grad_plain`, the kernel's plain PyTorch twin, which
is also what the kernel is held against on the card.

The pair factors are bf16 with f32 score differences and f32 sums, as in
the JAX package. XLA's CPU backend rounds to bf16 after every bf16
operation, so kernel and twin compute each operation in f32 and round
there: both equal the JAX package's bucketed path up to f32 summation
order. Unlike the JAX package, every query length runs through the same
code (the TPU kernel leaves queries longer than ``tpu_rank_tile`` to the
bucketed path). The quantized sigmoid table (``lut_bins``) is what tells
the two JAX paths apart: only the TPU kernel applies it, so here it
applies to the queries of at most ``lut_len`` documents (the caller's
tile when the JAX package would run its kernel, else 0) and every other
query takes the exact sigmoid.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.xla_math import exp_f32

# kernel launches by wrapper (a CPU call of the twin does not count)
LAUNCHES: Dict[str, int] = {"lambdarank_grad": 0}

# the kernel's work list (ops/csrc/rank.cu): queries of at most SHORT_DOCS
# documents with labels below MAX_LABELS are held whole in shared memory,
# consecutive ones packed into an item of up to PACK_DOCS documents; every
# other query is a long one, walked by at most LONG_CTAS CTAs that own row
# blocks of BLOCK_DOCS documents
SHORT_DOCS = 512
MAX_LABELS = 32
PACK_DOCS = 256
LONG_CTAS = 128
BLOCK_DOCS = 64
KIND_SHORT, KIND_LONG = 0, 1
# pair elements of one batch of the twin (bounds its temporaries)
_PAIR_BATCH = 1 << 22
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def query_blocks(qoff) -> np.ndarray:
    """int32 [num_blocks, 2]: (q, i0) for the row blocks i0 = 0,
    BLOCK_DOCS, ... below the length of each query q (host numpy from the
    host offsets)."""
    counts = np.diff(np.asarray(qoff, np.int64))
    per = -(-np.maximum(counts, 0) // BLOCK_DOCS)
    q = np.repeat(np.arange(len(counts)), per)
    first = np.repeat(np.cumsum(per) - per, per)
    i0 = (np.arange(len(q)) - first) * BLOCK_DOCS
    return np.stack([q, i0], axis=1).astype(np.int32)


class RankWork(NamedTuple):
    """The kernel's work list: ``items`` int32 [n, 4], (KIND_SHORT, q0,
    q1, 0) for the queries q0 .. q1 - 1 held one after the other, or
    (KIND_LONG | slot << 1, q, k, m) for CTA k of the m that walk long
    query q (its counters at ``slot``); ``sync`` int32 [1 + 2 x long
    queries], the ticket and each long query's arrival and departure
    counters, zero and left zero by every launch; ``covers``: the queries
    cover every document, so g and h need no zero fill."""
    items: np.ndarray
    sync: np.ndarray
    covers: bool

    def to(self, device) -> "RankWork":
        return RankWork(torch.as_tensor(self.items, device=device),
                        torch.as_tensor(self.sync, device=device),
                        self.covers)


def rank_work(qoff, label) -> RankWork:
    """The kernel's work list for the host offsets ``qoff`` and labels
    (host numpy): first the long items, min(row blocks, LONG_CTAS) for
    each query longer than SHORT_DOCS documents or with a label of
    MAX_LABELS or more, taken from its `query_blocks` (the CTAs of one
    query consecutive); then the short items, the other non-empty queries
    packed in order up to PACK_DOCS documents an item (a longer one
    alone; a long query between two ends the item). Empty queries take no
    item."""
    qb = np.asarray(qoff, np.int64)
    lab = np.asarray(label, np.int64)
    counts = np.diff(qb)
    some = counts > 0
    top = np.zeros(len(counts), np.int64)
    if some.any():
        if lab.min() < 0:
            raise ValueError("lambdarank labels must be non-negative")
        top[some] = np.maximum.reduceat(lab, qb[:-1][some])
    short = some & (counts <= SHORT_DOCS) & (top < MAX_LABELS)
    is_long = some & ~short
    slot = np.cumsum(is_long) - 1
    ctas = np.minimum(-(-counts // BLOCK_DOCS), LONG_CTAS)
    blocks = query_blocks(qb)
    q, k = blocks[:, 0], blocks[:, 1] // BLOCK_DOCS
    take = is_long[q] & (k < ctas[q])
    q, k = q[take], k[take]
    items = [np.stack([KIND_LONG | slot[q] << 1, q, k, ctas[q]], axis=1)]
    longs_before = np.concatenate([[0], np.cumsum(is_long)])
    run, docs = [], 0
    for qi in np.nonzero(short)[0]:
        c = int(counts[qi])
        if run and docs + c <= PACK_DOCS \
                and longs_before[qi] == longs_before[run[-1][2]]:
            run[-1][2] = qi + 1
            docs += c
        else:
            run.append([KIND_SHORT, qi, qi + 1, 0])
            docs = c
    items.append(np.asarray(run, np.int64).reshape(-1, 4))
    return RankWork(np.concatenate(items).astype(np.int32),
                    np.zeros(1 + 2 * int(is_long.sum()), np.int32),
                    bool(len(qb) and qb[0] == 0
                         and qb[-1] == lab.shape[0]))


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _padded(c: int) -> int:
    """The twin's batch width for a query of ``c`` documents: ``c``
    rounded up to a quarter of its power of two (at least 8)."""
    step = max(8, 1 << max(0, c.bit_length() - 3))
    return -(-max(c, 1) // step) * step


def _pair_block(s, lab, gb, valid, inv_b, disc, two_sig: float,
                lut_bins: int, tabled: Optional[torch.Tensor]):
    """(g, h) [B, S] of a batch of queries padded to S documents: the JAX
    package's bucketed formula, rows the higher-labelled member; the
    queries where ``tabled`` [B] is set (None: none) take the sigmoid
    table of ``lut_bins`` cells."""
    B, S = s.shape
    pos = torch.arange(S, device=s.device)
    sj, si = s[:, None, :], s[:, :, None]
    earlier = pos[None, :] < pos[:, None]                 # [i, j]: j < i
    before = valid[:, None, :] & ((sj > si) | ((sj == si) & earlier))
    # (a pad row's count may reach the query length: clamped, unused)
    d = disc[before.sum(-1).clamp(max=disc.shape[0] - 1)]
    big = torch.finfo(torch.float32).max
    norm_on = (torch.where(valid, s, -big).amax(1)
               != torch.where(valid, s, big).amin(1))[:, None, None]
    ds = _bf(si - sj)
    dgap = _bf(gb[:, :, None] - gb[:, None, :])
    pd = _bf((d[:, :, None] - d[:, None, :]).abs())
    delta = _bf(_bf(dgap * pd) * inv_b[:, None, None])
    eps = float(torch.tensor(0.01).to(torch.bfloat16))
    delta = torch.where(norm_on, _bf(delta / _bf(eps + ds.abs())), delta)
    x = ds
    if tabled is not None:
        factor = float(np.float32(lut_bins / 100.0))
        idx = torch.floor((x.clamp(-50.0, 50.0) + 50.0) * factor) \
            .clamp(0.0, float(lut_bins - 1))
        x = torch.where(tabled[:, None, None],
                        idx / torch.full_like(idx, factor) - 50.0, x)
    # divisions by tensors: `2.0 / t` is `t.reciprocal() * 2.0`, and on
    # CUDA `t / 2.0` multiplies by the reciprocal too; neither is the
    # correctly rounded f32 quotient
    den = 1.0 + exp_f32(two_sig * x)
    p = _bf(torch.full_like(den, 2.0) / den)
    p_hess = _bf(p * _bf(2.0 - p))
    pair = (lab[:, :, None] > lab[:, None, :]) & valid[:, :, None] \
        & valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    lam = torch.where(pair, _bf(-p * delta), zero)
    hes = torch.where(pair, _bf((p_hess * 2.0) * delta), zero)
    return lam.sum(2) - lam.sum(1), hes.sum(2) + hes.sum(1)


def lambdarank_grad_plain(score: torch.Tensor, qoff: torch.Tensor,
                          label: torch.Tensor, gain: torch.Tensor,
                          inv: torch.Tensor, disc: torch.Tensor,
                          sigmoid: float, lut_bins: int = 0,
                          lut_len: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of `lambdarank_grad`: the queries padded to a few
    widths (`_padded`) and their pair matrices built in batches."""
    dev = score.device
    n = score.shape[0]
    g = torch.zeros(n, dtype=torch.float32, device=dev)
    h = torch.zeros(n, dtype=torch.float32, device=dev)
    qb = qoff.cpu().numpy().astype(np.int64)
    counts = np.diff(qb)
    two_sig = float(np.float32(2.0 * sigmoid))
    widths: Dict[int, list] = {}
    for q in np.nonzero(counts > 0)[0]:
        widths.setdefault(_padded(int(counts[q])), []).append(int(q))
    for S, qs in sorted(widths.items()):
        per = max(1, _PAIR_BATCH // (S * S))
        for b0 in range(0, len(qs), per):
            qt = torch.as_tensor(qs[b0:b0 + per], device=dev)
            lo = qoff[qt].long()
            cnt = qoff[qt + 1].long() - lo
            pos = torch.arange(S, device=dev)
            valid = pos[None, :] < cnt[:, None]
            idx = torch.where(valid, lo[:, None] + pos[None, :], lo[:, None])
            s = torch.where(valid, score[idx], 0.0)
            lab = torch.where(valid, label[idx], -1)
            gb = _bf(gain[idx])
            tabled = cnt <= lut_len if lut_bins > 0 and lut_len > 0 \
                else None
            gq, hq = _pair_block(s, lab, gb, valid, _bf(inv[qt]), disc,
                                 two_sig, lut_bins, tabled)
            g[idx[valid]] = gq[valid]
            h[idx[valid]] = hq[valid]
    return g, h


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------
def _lib():
    if not _fns:
        from ..utils import cuda_build
        lib = cuda_build.load("rank")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.lgbt_rank_grad
        fn.argtypes = [p, p, p, p, p, i, p, p, f, i, f, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fns["lgbt_rank_grad"] = fn
    return _fns


def _check_cuda(score, qoff, label, gain, inv, disc, work) -> None:
    n = score.shape[0]
    want = ((score, torch.float32, (n,)), (label, torch.int32, (n,)),
            (gain, torch.float32, (n,)), (qoff, torch.int32, None),
            (inv, torch.float32, (qoff.shape[0] - 1,)),
            (disc, torch.float32, None),
            (work.items, torch.int32, (work.items.shape[0], 4)),
            (work.sync, torch.int32, None))
    for t, dtype, shape in want:
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != score.device \
                or t.dim() != (1 if shape is None else len(shape)) \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError("lambdarank_grad takes contiguous tensors on "
                             "one device: score/gain f32 [N], label int32 "
                             "[N], qoff int32 [Q+1], inv f32 [Q], disc f32, "
                             "the work list's items int32 [n, 4] and sync "
                             "int32")


def lambdarank_grad(score: torch.Tensor, qoff: torch.Tensor,
                    label: torch.Tensor, gain: torch.Tensor,
                    inv: torch.Tensor, disc: torch.Tensor, sigmoid: float,
                    lut_bins: int = 0, lut_len: int = 0,
                    work: Optional[RankWork] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g [N], h [N]) f32 of the documents of queries ``qoff[q] ..
    qoff[q + 1]``: ``score`` f32 [N] in row order, ``label`` int32 [N],
    ``gain`` f32 [N] (label_gain of each label), ``inv`` f32 [Q] (1 / the
    query's max DCG at max_position, 0 where that is 0), ``disc`` f32 the
    rank-position discounts (`ranking.discount_table`, at least as long
    as the longest query), ``sigmoid`` the pair loss's slope, and
    ``lut_bins`` > 0 the cells of the reference's quantized sigmoid
    table, which the queries of at most ``lut_len`` documents take (0:
    none). Documents outside every query get 0. ``work`` is the kernel's
    work list (`rank_work` of ``qoff`` and the labels, on the device),
    made from host copies when not given; one launch a call (and a zero
    fill of g and h only where the queries leave documents out)."""
    if not score.is_cuda:
        return lambdarank_grad_plain(score, qoff, label, gain, inv, disc,
                                     sigmoid, lut_bins, lut_len)
    dev = score.device
    if work is None:
        work = rank_work(qoff.cpu().numpy(), label.cpu().numpy()).to(dev)
    _check_cuda(score, qoff, label, gain, inv, disc, work)
    n = score.shape[0]
    alloc = torch.empty if work.covers else torch.zeros
    g = alloc(n, dtype=torch.float32, device=dev)
    h = alloc(n, dtype=torch.float32, device=dev)
    scratch = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib()["lgbt_rank_grad"](
            score.data_ptr(), label.data_ptr(), gain.data_ptr(),
            qoff.data_ptr(), work.items.data_ptr(), work.items.shape[0],
            inv.data_ptr(),
            disc.data_ptr(), float(np.float32(2.0 * sigmoid)),
            int(lut_bins), float(np.float32(lut_bins / 100.0)),
            int(lut_len) if lut_bins > 0 else 0, scratch.data_ptr(),
            work.sync.data_ptr(), g.data_ptr(), h.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lambdarank_grad kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["lambdarank_grad"] += 1
    return g, h
