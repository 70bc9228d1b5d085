"""Aligned tree builder: speculative level growth over the chunk-aligned
record matrix (`ops/aligned.py`), with exact leaf-wise replay (port of
lightgbm_tpu/models/aligned_builder.py, serial path).

A tree grows in a handful of speculative rounds. Each round splits up to
K = min(S - 1, 256) leaves at once in one pass over the rows:

1. need-driven selection: the leaves the leaf-wise replay flagged as its
   frontier, best gain first;
2. left counts (the split finder's exact left count, or kernel B3 under
   bagging and for the STANDARD layout of ``tpu_force_big_n`` and n >
   2^24) give the new chunk-aligned layout: the left child at the
   parent's slot, the right child at a fresh slot, every block's begin
   rounded up to a chunk;
3. kernel B2 partitions every split block into the new layout, copies
   unsplit blocks whole, and histograms each split's smaller child; the
   larger child is parent minus sibling (`FeatureHistogram::Subtract`).
   A categorical split routes by its bitset: the round's selected splits'
   bitsets form one compact table (8 words a selection rank, the JAX
   package's ``cbits``) that B3 and B2 read;
4. the split finder evaluates the 2k children, and the reference's
   priority queue (`serial_tree_learner.cpp:173-237`) is replayed over the
   executed splits to flag the next frontier.

Under bagging the records keep every row: a bag (COMPACT's meta bit 31,
else an f32 lane, re-written by `AlignedEngine.set_bag` on bagging_freq
boundaries) keeps the out-of-bag rows out of the histograms, so the
finder's counts (LI_COUNTG, the tree's leaf counts) are in-bag counts,
while the layout's counts (LI_COUNT) are physical and come from B3; the
score update reaches every row, in the bag or not.

Bundled bins (`io/bundling.py`): the records pack the G storage columns
at ``hist_bins`` bins, B4's and B2's histograms run over G x hist_bins,
each chunk's route words carry its split feature's storage column (word
and shift) and the bundle offset and packing in r2, which B2 and B3
unpack before they route, and the per-feature view is expanded only for
the split search (`DeviceTreeLearner.expand_hist`).

A K-class objective (softmax or one-vs-all) takes COMPACT records with K
score lanes, under softmax K probability lanes too, and the integer class
in the meta lane; each class's tree is a `train_iter` whose kernels read
that class's lane (`ClassGrad`), and whose leaf values go to that class's
score lane. `begin_iter_mc` writes the probability lanes from the
pre-iteration scores and keeps a copy of the score lanes for a fallback.

The records stay permuted across iterations. Pointwise gradients are
computed in the records' permuted order, so nothing is unpermuted on the
hot path; row-order scores are materialized lazily through the rid lane.
An objective whose gradients are not pointwise (lambdarank) takes the
EXT records: each iteration reads the row-order scores on the device,
the objective computes (g, h) in row order (kernel B6), and the engine
gathers them by rid into the grad/hess lanes. The JAX package runs the
rounds inside one `lax.while_loop`; here they are a host loop whose
per-leaf tables (a few thousand numbers) live in numpy, with one small
read from the card per round (the children's best splits) and a second
one when the count pass runs. The replay decides exactly what the JAX package's
`device_replay` decides: same lowest-slot tie-break, same budget cap, the
same all-needed shortcut and the same authoritative final replay
(`replay_frontier`), so the rounds and the number of executed splits are
the JAX package's.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.aligned import (META_FIRST, META_LAST, META_RID_MASK, R_CAT,
                           R_COPY, R_DL, R_MT, R_SHIFT, ClassGrad,
                           _bpw_for_bits, chunk_for, count_pass, lane_layout,
                           move_pass, pack_records, pack_route2,
                           slot_hist_pass)
from ..ops.objectives import softmax_rows
from ..utils.xla_math import fma_f32
from .device_learner import (BF_GAIN, BF_LG, BF_LH, BF_LOUT, BF_RG, BF_RH,
                             BF_ROUT, BF_W, BI_CAT0, BI_DEFLEFT, BI_FEAT,
                             BI_ISCAT, BI_LC, BI_RC, BI_THR, BI_W, LF_MAXC,
                             LF_MINC, LF_SG, LF_SH, LF_VALUE, LF_W, LI_BEGIN,
                             LI_COUNT, LI_COUNTG, LI_DEPTH, LI_W)
from .level_builder import (SF_GAIN, SF_IVAL, SF_LOUT, SF_ROUT, SF_W,
                            SI_DEFLEFT, SI_FEAT, SI_ISCAT, SI_LC, SI_RC,
                            SI_SLOT, SI_THR, SI_W, cover_values,
                            replay_leafwise, spec_slots)

K_CAP = 256      # splits per round at most (the JAX package's K)


class AlignedSpec(NamedTuple):
    """One aligned speculative build's tables (host numpy): what the
    leaf-wise replay reads, and the build's round count."""
    rounds: int
    n_exec: int
    execF: np.ndarray      # f32[Sm1, SF_W]
    execI: np.ndarray      # i64[Sm1, SI_W]
    execB: np.ndarray      # i64[Sm1, 8] categorical splits' bitsets
    bestF: np.ndarray      # f32[S, BF_W]
    leafI: np.ndarray      # i64[S, LI_W] (LI_BEGIN in chunk units)


def slot_in_any_map(begin, count, nc: int, chunk: int):
    """(slot_of [nc], in_range [nc]) from monotonic block begins: a
    chunk's slot is the last slot whose begin is <= the chunk."""
    nslot = begin.shape[0]
    iota = np.arange(nc)
    marks = np.zeros(nc + 1, np.int64)
    np.add.at(marks, np.clip(begin, 0, nc), 1)
    slot_of = np.clip(np.cumsum(marks[:nc]) - 1, 0, nslot - 1)
    nch = (count + chunk - 1) // chunk
    in_range = ((iota >= begin[slot_of])
                & (iota < begin[slot_of] + nch[slot_of])
                & (count[slot_of] > 0))
    return slot_of, in_range


def chunk_maps(begin, count, exists, nc: int, chunk: int, cnts_pc=None,
               root_span: bool = False):
    """(slot_of, cnt_of, first, last, in_any) per chunk from the block
    tables. A freshly moved layout is table-exact (full chunks, a partial
    last one); the layout a tree inherits at its root round has gaps, so
    there the root block spans all chunks and counts come from the carried
    per-chunk ``cnts_pc``."""
    nch = (count + chunk - 1) // chunk
    if root_span:
        nch = nch.copy()
        nch[0] = nc
    slot_of, _ = slot_in_any_map(begin, count, nc, chunk)
    iota = np.arange(nc)
    b = begin[slot_of]
    in_any = ((iota >= b) & (iota < b + nch[slot_of]) & exists[slot_of]
              & (count[slot_of] > 0))
    if cnts_pc is None:
        cnt_of = np.clip(count[slot_of] - (iota - b) * chunk, 0, chunk)
    else:
        cnt_of = cnts_pc
    cnt_of = np.where(in_any, cnt_of, 0)
    first = in_any & (iota == b)
    last = in_any & (iota == b + np.maximum(nch[slot_of], 1) - 1)
    return slot_of, cnt_of, first, last, in_any


def route_words(feat, thr, default_left, split, lr, bits: int, is_cat):
    """Per-slot route words (r1, r2, wsel) of the slots' best splits on
    learner ``lr``'s data; r1's copy bit is set where ``split`` is False,
    its categorical bit where ``is_cat`` is 1. A split routes by its
    feature's storage column (word and shift), and r2 carries the bundle
    offset and packing (0 unbundled; JAX package:
    aligned_builder.py:805-832)."""
    bpw = _bpw_for_bits(bits)
    meta = lr.meta
    scol = lr.bcol[feat]
    r1 = (np.clip(thr, 0, 255)
          | (((scol % bpw) * bits) << R_SHIFT)
          | (default_left << R_DL)
          | (meta["missing_type"][feat].astype(np.int64) << R_MT)
          | ((1 - split.astype(np.int64)) << R_COPY)
          | (np.asarray(is_cat, np.int64) << R_CAT))
    r2 = pack_route2(np.clip(meta["default_bin"][feat], 0, 255)
                     .astype(np.int64),
                     np.clip(meta["num_bin"][feat], 1, 256).astype(np.int64),
                     lr.boff[feat], lr.bpk[feat])
    return r1, r2, scol // bpw


def new_layout(sel, exists, right_slot, left_local, count, chunk: int):
    """(new_begin [S+1] in chunks, right_local) of the layout after a
    round: every existing block keeps its left part at its slot, each
    selected split's right part goes to its fresh right slot, and blocks
    take consecutive chunk-aligned ranges in slot order."""
    S = sel.shape[0] - 1
    right_local = count - left_local
    allcnt = np.where(exists, left_local, 0)
    allcnt[right_slot[sel]] += right_local[sel]
    nch = (allcnt + chunk - 1) // chunk
    new_begin = np.concatenate([[0], np.cumsum(nch)[:S]])
    return new_begin, right_local


def replay_frontier(execF, execI, best_gain, n_exec: int, S: int,
                    Lm1: int):
    """The reference's leaf-wise priority queue replayed over the
    speculated splits (JAX package: `device_replay`, a `lax.while_loop`
    on the TPU; here a heap on the host). Returns (commit [S] bool over
    execs, need [S+1] bool, ncommit): ``commit`` marks the executed splits
    the true leaf-wise order takes, ``need`` the slots whose next split it
    wants but speculation has not executed (the frontier, marked only
    while commits plus marks stay under the L-1 budget). An empty ``need``
    certifies the replay exact. Ties pop the lowest slot, as `argmax`."""
    Sm1 = S - 1
    E_INF = Sm1 + 1
    first_e = np.full(S + 1, E_INF, np.int64)
    nxt = np.full(Sm1 + 1, E_INF, np.int64)
    for e in range(n_exec - 1, -1, -1):
        sl = int(execI[e, SI_SLOT])
        nxt[e] = first_e[sl]
        first_e[sl] = e
    ptr = np.full(S + 1, E_INF, np.int64)
    ptr[0] = first_e[0]

    def key(s):
        e = ptr[s]
        return float(execF[e, SF_GAIN]) if e < E_INF else float(best_gain[s])

    heap = [(-key(0), 0)]
    commit = np.zeros(Sm1 + 1, bool)
    need = np.zeros(S + 1, bool)
    ncommit = nneed = 0
    while heap and ncommit < Lm1:
        neg, sl = heapq.heappop(heap)
        if not -neg > 0.0:
            break
        e = ptr[sl]
        if e < E_INF:
            commit[e] = True
            ncommit += 1
            ptr[sl] = nxt[e]
            heapq.heappush(heap, (-key(sl), sl))
            r = min(e + 1, S)
            ptr[r] = first_e[r]
            heapq.heappush(heap, (-key(r), r))
        elif ncommit + nneed < Lm1:
            need[sl] = True
            nneed += 1
    return commit, need, ncommit


def replay_spec(spec: AlignedSpec, num_leaves: int):
    """The TreeRecord of a build: the leaf-wise replay of its executed
    splits, the tree `replay_frontier` committed. (Its exactness flag
    agrees with the build's, which the caller already holds.)"""
    return replay_leafwise(spec, num_leaves)[0]


class AlignedEngine:
    """Persistent aligned-record training state for one Dataset: the
    [NC, W, C] record matrix (two buffers the move pass ping-pongs), the
    per-chunk valid counts and the per-slot histogram store."""

    def __init__(self, learner, objective, init_row_scores=None,
                 bagged: bool = False, num_class: int = 1) -> None:
        self.learner = learner
        self.objective = objective
        self.cfg = cfg = learner.cfg
        self.device = dev = learner.device
        self.n = n = learner.n
        F = learner.num_features
        self.C = C = chunk_for(cfg, F, n)
        self.S = S = spec_slots(cfg.num_leaves, float(cfg.tpu_level_spec))
        pg = objective.point_grad_fn()
        label = objective._label_np
        weight = objective._weight_np
        lab01 = bool(np.all((label == 0) | (label == 1)))
        self.num_class = num_class
        # K classes: COMPACT always (K score lanes, the class in the meta
        # lane), gradients from a class's probability or score lane
        self.mc_mode = objective.mc_lane_mode() if num_class > 1 else None
        if num_class > 1 and not (self.mc_mode in ("prob", "score")
                                  and weight is None and n <= (1 << 24)
                                  and num_class <= 127):
            raise ValueError("a K-class engine needs an unweighted "
                             "softmax or one-vs-all objective, K <= 127 "
                             "and n <= 2^24")
        # COMPACT: gradients recomputed in the kernels from score + label
        # bit; EXT: gradients from the objective in row order (ranking);
        # STANDARD otherwise, and for the big-n layout
        self.compact = num_class > 1 or (
            pg is not None and weight is None and lab01
            and n <= (1 << 24) and not cfg.tpu_force_big_n)
        self.ext = pg is None and num_class == 1
        self.gh_off = 1 if self.ext else 2
        self.big_n = n > (1 << 24) or bool(cfg.tpu_force_big_n)
        self.bagged = bagged
        self.pgrad = pg
        self.grad = pg if self.compact else None
        with_prob = self.mc_mode == "prob"
        # the storage columns at their bins (bundles hold up to 256)
        rec, self.wcnt, self.W, cnts, self.bits = pack_records(
            learner.bins, label, weight, C, compact=self.compact,
            max_bin=learner.hist_bins, ext=self.ext, with_bag=bagged,
            num_class=num_class, with_prob=with_prob)
        nc_data = rec.shape[0]
        self.NC = NC = nc_data + S + 2
        self.lanes, _ = lane_layout(self.wcnt, self.compact, self.ext,
                                    bagged, num_class, with_prob)
        # the kernels' bag mode: -1 none, -2 COMPACT's meta bit, else the
        # f32 lane
        self.bag_lane = -1 if not bagged else (
            -2 if self.compact else self.lanes["bag"])
        self.w_used = max(self.lanes.values()) + 1
        self.rec = torch.zeros((NC, self.W, C), dtype=torch.int32,
                               device=dev)
        self.rec[:nc_data] = rec
        del rec
        self._spare = torch.empty_like(self.rec)
        self.cnts = np.zeros(NC, np.int64)
        self.cnts[:nc_data] = cnts
        if init_row_scores is not None:
            isc = torch.as_tensor(init_row_scores, dtype=torch.float32,
                                  device=dev).reshape(-1, n)
            for k in range(num_class):
                sc = torch.zeros(nc_data * C, dtype=torch.float32,
                                 device=dev)
                sc[:n] = isc[k]
                self.rec[:nc_data, self.lanes["score"] + k] = \
                    sc.view(nc_data, C).view(torch.int32)
        self._hist_store = None
        self._saved = None
        self.fallbacks = 0

    # ------------------------------------------------------------------
    def _lane_f32(self, name: str) -> torch.Tensor:
        return self.rec[:, self.lanes[name]].view(torch.float32)

    def _rid(self) -> torch.Tensor:
        if self.compact:
            return self.rec[:, self.lanes["meta"]] & META_RID_MASK
        return self.rec[:, self.lanes["rid"]]

    def _grad_lanes(self) -> None:
        """STANDARD records: the grad/hess lanes from the score, label
        (and weight) lanes, in the records' permuted row order."""
        w = self._lane_f32("weight") if self.objective.weight is not None \
            else None
        g, h = self.pgrad(self._lane_f32("score"), self._lane_f32("label"),
                          w)
        self._set_grad_lanes(g, h)

    def _gather_grad_lanes(self, g_rows: torch.Tensor,
                           h_rows: torch.Tensor) -> None:
        """EXT records: the grad/hess lanes from row-order (g, h), by the
        rid lane (pad rows read the last row's, and no pass reads them)."""
        rid = self._rid().long().clamp(0, self.n - 1)
        self._set_grad_lanes(g_rows[rid], h_rows[rid])

    def _set_grad_lanes(self, g: torch.Tensor, h: torch.Tensor) -> None:
        """Write [NC, C] (g, h) into the grad/hess lanes; under bagging
        multiplied by the bag lane, so out-of-bag rows carry zeros (JAX
        package: aligned_builder.py:353-357, :682-685)."""
        if self.bagged:
            bag = self._lane_f32("bag")
            g, h = g * bag, h * bag
        self.rec[:, self.lanes["grad"]] = g.view(torch.int32)
        self.rec[:, self.lanes["hess"]] = h.view(torch.int32)

    def set_bag(self, mask_rows) -> None:
        """Re-ingest a row-order 0/1 bag mask ([N], host or device) by rid
        (JAX package: `AlignedEngine.set_bag`): COMPACT's meta bit 31
        cleared and set (int32-safe), else the f32 bag lane written; pad
        rows (rid n) leave the bag."""
        mask = torch.as_tensor(mask_rows, device=self.device).float()
        vals = torch.cat([mask, mask.new_zeros(1)])
        if self.compact:
            meta = self.rec[:, self.lanes["meta"]]
            rid = (meta & META_RID_MASK).long().clamp(0, self.n)
            self.rec[:, self.lanes["meta"]] = (meta & 0x7FFFFFFF) | \
                torch.where(vals[rid] > 0.5, -(1 << 31), 0).to(torch.int32)
        else:
            rid = self.rec[:, self.lanes["rid"]].long().clamp(0, self.n)
            self.rec[:, self.lanes["bag"]] = vals[rid].view(torch.int32)

    def _to_rows(self, lanes: torch.Tensor, rid: torch.Tensor,
                  cnts: np.ndarray) -> torch.Tensor:
        """[K, N] row-order values of f32 lanes [NC, K, C] whose rows the
        rid lane [NC, C] names, the chunks' valid counts ``cnts``."""
        C, n = self.C, self.n
        pos = torch.arange(C, device=self.device)
        cnt = torch.as_tensor(cnts, device=self.device)
        valid = (pos[None, :] < cnt[:, None]).reshape(-1)
        r = rid.reshape(-1).long()
        r = torch.where(valid & (r < n), r, n)
        K = lanes.shape[1]
        out = torch.zeros((K, n + 1), dtype=torch.float32,
                          device=self.device)
        out[:, r] = lanes.transpose(0, 1).reshape(K, -1)
        return out[:, :n]

    def _score_lanes(self) -> torch.Tensor:
        """The K score lanes, f32 [NC, K, C]."""
        sl = self.lanes["score"]
        return self.rec[:, sl:sl + self.num_class].view(torch.float32)

    def row_scores(self) -> torch.Tensor:
        """Training scores of class 0 in row order ([N] f32 on the
        device; nothing is read back to the host)."""
        return self.row_scores_all()[0]

    def row_scores_all(self) -> torch.Tensor:
        """Training scores of every class in row order ([K, N] f32 on the
        device)."""
        return self._to_rows(self._score_lanes(), self._rid(), self.cnts)

    def set_row_scores(self, row_scores: torch.Tensor) -> None:
        """Re-ingest row-order scores ([N] or [K, N]) into the score lanes
        (after a leaf-wise fallback updated them in row order)."""
        rid = self._rid().long().clamp(0, self.n - 1)
        sc = row_scores.to(torch.float32).reshape(-1, self.n)
        for k in range(sc.shape[0]):
            self.rec[:, self.lanes["score"] + k] = sc[k][rid] \
                .view(torch.int32)

    def begin_iter_mc(self) -> None:
        """Start a K-class iteration: under softmax, the probability lanes
        from the score lanes (the JAX program's order: the max by
        successive maximums, XLA's ``exp``, the sum class by class, each
        quotient; lightgbm_tpu/models/aligned_builder.py:655-677), and a
        copy of the score lanes with the rows they belong to, which
        `saved_row_scores` turns back into row order."""
        sc = self._score_lanes()
        if self.mc_mode == "prob":
            pl = self.lanes["prob"]
            p = softmax_rows(sc.transpose(0, 1))
            self.rec[:, pl:pl + self.num_class] = \
                p.transpose(0, 1).contiguous().view(torch.int32)
        self._saved = (sc.clone(), self._rid().clone(), self.cnts.copy())

    def saved_row_scores(self) -> torch.Tensor:
        """[K, N] row-order scores of the copy `begin_iter_mc` kept."""
        return self._to_rows(*self._saved)

    # ------------------------------------------------------------------
    def _upload(self, *arrays) -> torch.Tensor:
        """Per-chunk host arrays -> one int32 [len, NC] device tensor."""
        host = np.stack([np.asarray(a, np.int64) for a in arrays])
        return torch.as_tensor(host.astype(np.int32), device=self.device)

    def _class_grad(self, k: int) -> ClassGrad:
        """Class k's gradient of these records (JAX package:
        `_mc_payload_fn`)."""
        ln = self.lanes
        if self.mc_mode == "prob":
            return ClassGrad("prob", k, ln["prob"] + k, ln["meta"])
        pg = self.objective.score_point_grad(k)
        return ClassGrad("score", k, ln["score"] + k, ln["meta"],
                         pg.c0, pg.c1, pg.c2)

    def train_iter(self, scale: float, fmask: Optional[np.ndarray] = None,
                   grads=None, class_k: int = 0):
        """One tree: gradients, speculative build, and (when the replay is
        exact) the score-lane update. EXT records take ``grads``, the
        objective's row-order (g [N], h [N]) on the device; K-class
        records build class ``class_k``'s tree (after `begin_iter_mc`).
        Returns (AlignedSpec, exact)."""
        lr = self.learner
        cfg = self.cfg
        dev = self.device
        C, NC, S = self.C, self.NC, self.S
        Sm1 = S - 1
        K = min(Sm1, K_CAP)
        Lm1 = max(cfg.num_leaves - 1, 1)
        # histograms over the storage columns (the features, unbundled)
        F, B = lr.num_storage_cols, lr.hist_bins
        bundled = lr.bundled
        bits, wcnt, grad, gh_off = self.bits, self.wcnt, self.grad, \
            self.gh_off
        if self.num_class > 1:
            grad = self._class_grad(class_k)
        meta = lr.meta
        mono = meta["monotone"].astype(np.int64)
        fmask_t = lr.fmask_tensor(fmask)
        s_ids = np.arange(S + 1)
        chunk_iota = np.arange(NC)
        if self.ext:
            self._gather_grad_lanes(*grads)
        elif not self.compact:
            self._grad_lanes()
        if self._hist_store is None:
            self._hist_store = torch.empty((S + 1, F, B, 3),
                                           dtype=torch.float32, device=dev)
        store = self._hist_store

        # ---------- root: every chunk maps to slot 0
        cnts_pc = self.cnts
        cm = self._upload(np.zeros(NC), cnts_pc)
        root = slot_hist_pass(self.rec, cm[0], cm[1], 1, F, B, wcnt, bits,
                              grad, gh_off=gh_off,
                              bag_lane=self.bag_lane)[0]
        store[0] = root
        tot = root[0].sum(0).cpu().numpy()           # column 0's bins
        root_g, root_h = np.float32(tot[0]), np.float32(tot[1])
        root_cnt_g = int(tot[2])

        leafF = np.zeros((S + 1, LF_W), np.float32)
        leafF[:, LF_MINC] = -np.inf
        leafF[:, LF_MAXC] = np.inf
        leafF[0, LF_SG], leafF[0, LF_SH] = root_g, root_h
        leafI = np.zeros((S + 1, LI_W), np.int64)
        leafI[:, LI_BEGIN] = NC
        leafI[0, LI_BEGIN] = 0
        leafI[0, LI_COUNT] = int(cnts_pc.sum())
        leafI[0, LI_COUNTG] = root_cnt_g
        execF = np.zeros((Sm1 + 1, SF_W), np.float32)
        execI = np.zeros((Sm1 + 1, SI_W), np.int64)
        execB = np.zeros((Sm1 + 1, 8), np.int64)
        bestF = np.full((S + 1, BF_W), -np.inf, np.float32)
        bestI = np.zeros((S + 1, BI_W), np.int64)
        vf, vi = lr._eval_leaves(root[None], [root_g], [root_h],
                                 [root_cnt_g], [-np.inf], [np.inf], [0],
                                 fmask_t)
        bestF[0], bestI[0] = vf[0], vi[0]
        need = np.zeros(S + 1, bool)
        need[0] = bestF[0, BF_GAIN] > 0.0
        done = rounds = 0

        while done < Sm1 and need.any():
            gains = bestF[:, BF_GAIN]
            budget = min(Sm1 - done, K)
            sel = need & (gains > 0.0)
            order = np.argsort(-gains, kind="stable")
            selrank = np.empty(S + 1, np.int64)
            selrank[order] = np.cumsum(sel[order]) - 1
            sel &= selrank < budget
            k = int(sel.sum())
            if k == 0:
                break
            seq = done + selrank
            right_slot = seq + 1
            sl_sel = np.nonzero(sel)[0]
            # slot of each selection rank
            slot_l = np.empty(k, np.int64)
            slot_l[selrank[sl_sel]] = sl_sel
            slot_r = done + np.arange(k) + 1

            # ---- record the executed splits
            e_sel = seq[sl_sel]
            execF[e_sel, SF_GAIN] = bestF[sl_sel, BF_GAIN]
            execF[e_sel, SF_LOUT] = bestF[sl_sel, BF_LOUT]
            execF[e_sel, SF_ROUT] = bestF[sl_sel, BF_ROUT]
            execF[e_sel, SF_IVAL] = leafF[sl_sel, LF_VALUE]
            execI[e_sel] = 0
            execI[e_sel, SI_SLOT] = sl_sel
            execI[e_sel, SI_FEAT] = bestI[sl_sel, BI_FEAT]
            execI[e_sel, SI_THR] = bestI[sl_sel, BI_THR]
            execI[e_sel, SI_DEFLEFT] = bestI[sl_sel, BI_DEFLEFT]
            execI[e_sel, SI_LC] = bestI[sl_sel, BI_LC]
            execI[e_sel, SI_RC] = bestI[sl_sel, BI_RC]
            execI[e_sel, SI_ISCAT] = bestI[sl_sel, BI_ISCAT]
            execB[e_sel] = bestI[sl_sel, BI_CAT0:BI_CAT0 + 8]

            exists = s_ids <= done
            slot_of, cnt_of, first, last, in_any = chunk_maps(
                leafI[:, LI_BEGIN], leafI[:, LI_COUNT], exists, NC, C,
                cnts_pc=cnts_pc, root_span=done == 0)
            r1_s, r2_s, wsel_s = route_words(
                bestI[:, BI_FEAT], bestI[:, BI_THR], bestI[:, BI_DEFLEFT],
                sel, lr, bits, bestI[:, BI_ISCAT])
            # the round's compact bitset table, a row a selection rank
            # (row K the pad row; JAX package: aligned_builder.py:821-826)
            cbits = None
            if lr.has_cat:
                tab = np.zeros((K + 1, 8), np.int64)
                tab[selrank[sl_sel]] = bestI[sl_sel, BI_CAT0:BI_CAT0 + 8]
                cbits = torch.as_tensor(
                    tab.astype(np.uint32).view(np.int32).reshape(-1),
                    device=dev)
            meta_pc = (cnt_of | (first.astype(np.int64) << META_FIRST)
                       | (last.astype(np.int64) << META_LAST))

            # ---- left counts: the finder's exact count, or the i32 count
            # pass of the physical rows when the count channel is in-bag
            # only (bagging) or cannot be trusted (f32 counts, n > 2^24)
            if self.big_n or self.bagged:
                ks_s = np.where(sel, np.clip(selrank, 0, K - 1), K)
                ks_pc = np.where(in_any & sel[slot_of], ks_s[slot_of], K)
                up = self._upload(r1_s[slot_of], r2_s[slot_of], meta_pc,
                                  wsel_s[slot_of], ks_pc)
                phys = count_pass(self.rec, up[0], up[1], up[2], up[3],
                                  up[4], K, bits, cbits=cbits,
                                  bundled=bundled).cpu().numpy()
                left_local = np.where(sel, phys[np.clip(selrank, 0, K - 1)],
                                      leafI[:, LI_COUNT])
            else:
                left_local = np.where(sel, bestI[:, BI_LC],
                                      leafI[:, LI_COUNT])
            new_begin, right_local = new_layout(
                sel, exists, right_slot, left_local, leafI[:, LI_COUNT], C)

            # ---- per-chunk destinations in the new layout
            copy_pc = ~sel[slot_of] & in_any
            direct_pc = new_begin[slot_of] + chunk_iota \
                - leafI[:, LI_BEGIN][slot_of]
            br_s = np.where(sel, new_begin[np.where(sel, right_slot, S)],
                            new_begin)
            bl_pc = np.where(copy_pc, direct_pc, new_begin[slot_of])
            smaller_is_left = bestI[:, BI_LC] <= bestI[:, BI_RC]
            hslot_s = np.where(sel, np.clip(selrank, 0, K - 1)
                               | ((~smaller_is_left).astype(np.int64) << 24),
                               K)
            up = self._upload(r1_s[slot_of], r2_s[slot_of], bl_pc,
                              br_s[slot_of], meta_pc, wsel_s[slot_of],
                              np.where(in_any, hslot_s[slot_of], K))
            out, hout = move_pass(self.rec, up[0], up[1], up[2], up[3],
                                  up[4], up[5], up[6], K, F, B, wcnt, bits,
                                  self.w_used, grad,
                                  out=self._spare if self.rec.is_cuda
                                  else None, gh_off=gh_off, cbits=cbits,
                                  bag_lane=self.bag_lane, bundled=bundled)
            self._spare, self.rec = self.rec, out

            # ---- tables: children of the selected slots
            depth_new = leafI[:, LI_DEPTH] + 1
            lmin = rmin = leafF[:, LF_MINC].copy()
            lmax = rmax = leafF[:, LF_MAXC].copy()
            if mono.any():
                m = mono[bestI[:, BI_FEAT]]
                mid = (bestF[:, BF_LOUT] + bestF[:, BF_ROUT]) \
                    / np.float32(2.0)
                lmax = np.where(m > 0, np.minimum(lmax, mid), lmax)
                rmin = np.where(m > 0, np.maximum(rmin, mid), rmin)
                lmin = np.where(m < 0, np.maximum(lmin, mid), lmin)
                rmax = np.where(m < 0, np.minimum(rmax, mid), rmax)
            rs = right_slot[sl_sel]
            leafF[rs] = 0.0
            leafF[rs, LF_SG] = bestF[sl_sel, BF_RG]
            leafF[rs, LF_SH] = bestF[sl_sel, BF_RH]
            leafF[rs, LF_MINC] = rmin[sl_sel]
            leafF[rs, LF_MAXC] = rmax[sl_sel]
            leafF[rs, LF_VALUE] = bestF[sl_sel, BF_ROUT]
            leafI[rs] = 0
            leafI[rs, LI_COUNT] = right_local[sl_sel]
            leafI[rs, LI_COUNTG] = bestI[sl_sel, BI_RC]
            leafI[rs, LI_DEPTH] = depth_new[sl_sel]
            leafF[sl_sel, LF_SG] = bestF[sl_sel, BF_LG]
            leafF[sl_sel, LF_SH] = bestF[sl_sel, BF_LH]
            leafF[sl_sel, LF_MINC] = lmin[sl_sel]
            leafF[sl_sel, LF_MAXC] = lmax[sl_sel]
            leafF[sl_sel, LF_VALUE] = bestF[sl_sel, BF_LOUT]
            leafI[sl_sel, LI_COUNT] = left_local[sl_sel]
            leafI[sl_sel, LI_COUNTG] = bestI[sl_sel, BI_LC]
            leafI[sl_sel, LI_DEPTH] = depth_new[sl_sel]
            exists2 = s_ids <= done + k
            leafI[:, LI_BEGIN] = np.where(exists2, new_begin, NC)
            cnts_pc = chunk_maps(leafI[:, LI_BEGIN], leafI[:, LI_COUNT],
                                 exists2, NC, C)[1]

            # ---- children histograms (smaller from the move pass, larger
            # by subtraction) and their best splits
            il = torch.as_tensor(slot_l, device=dev)
            ir = torch.as_tensor(slot_r, device=dev)
            sm = hout[:k]
            parent = store[il]
            lg = parent - sm
            sil = torch.as_tensor(smaller_is_left[slot_l],
                                  device=dev)[:, None, None, None]
            left_h = torch.where(sil, sm, lg)
            right_h = torch.where(sil, lg, sm)
            store[il] = left_h
            store[ir] = right_h
            vf, vi = lr._eval_leaves(
                torch.cat([left_h, right_h]),
                np.concatenate([bestF[slot_l, BF_LG], bestF[slot_l, BF_RG]]),
                np.concatenate([bestF[slot_l, BF_LH], bestF[slot_l, BF_RH]]),
                np.concatenate([bestI[slot_l, BI_LC], bestI[slot_l, BI_RC]]),
                np.concatenate([lmin[slot_l], rmin[slot_l]]),
                np.concatenate([lmax[slot_l], rmax[slot_l]]),
                np.concatenate([depth_new[slot_l]] * 2), fmask_t)
            bestF[slot_l], bestI[slot_l] = vf[:k], vi[:k]
            bestF[slot_r], bestI[slot_r] = vf[k:], vi[k:]

            # ---- next frontier: while 2e + 1 < L - 1 (e = execs so far)
            # the budget cap cannot bind and every positive slot is needed
            if 2 * (done + k) + 1 < Lm1:
                need = (bestF[:, BF_GAIN] > 0.0) & exists2
            else:
                need = replay_frontier(execF, execI, bestF[:, BF_GAIN],
                                       done + k, S, Lm1)[1]
            done += k
            rounds += 1

        # authoritative final replay: the last round may have taken the
        # shortcut, and a tree that stops early must commit its splits
        n_exec = done
        commit, need_fin, _ = replay_frontier(
            execF, execI, bestF[:, BF_GAIN], n_exec, S, Lm1)
        exact = not need_fin.any()
        cover = cover_values(execF, execI, commit, n_exec, S + 1)
        self.cnts = cnts_pc
        if exact:
            slot_f, _, _, _, in_any_f = chunk_maps(
                leafI[:, LI_BEGIN], leafI[:, LI_COUNT], s_ids <= n_exec, NC,
                C)
            valmap = torch.as_tensor(
                np.where(in_any_f, cover[slot_f], 0.0).astype(np.float32),
                device=dev)
            lane = self.lanes["score"] + class_k
            sc = self.rec[:, lane].view(torch.float32)
            self.rec[:, lane] = fma_f32(
                valmap[:, None], float(np.float32(scale)), sc) \
                .view(torch.int32)
        spec = AlignedSpec(rounds=rounds, n_exec=n_exec, execF=execF[:Sm1],
                           execI=execI[:Sm1], execB=execB[:Sm1],
                           bestF=bestF[:S], leafI=leafI[:S])
        return spec, exact
