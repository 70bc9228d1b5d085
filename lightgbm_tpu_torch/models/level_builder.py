"""Speculative level builder with exact leaf-wise replay (port of
lightgbm_tpu/models/level_builder.py, serial path), selected by
``tpu_grow_mode=level``.

The rows stay in one word-major record ``[wcnt + 3, N]`` int32 per tree:
``ceil(F/4)`` packed bin words (`pack_bin_words`), then the gradient, the
hessian (f32 bits) and the row id. A tree grows in speculative rounds;
each round

1. selects the positive-gain slots best first (`argsort(-gain)`, stable,
   so equal gains go in slot order), up to the budget of S - 1 executed
   splits (S = `spec_slots`);
2. routes every row by its block's split (unselected blocks copy their
   rows through; a categorical split by its bitset, whose 8 words ride
   in the slot table) and partitions every selected block stably, left rows
   first, with one scatter of the whole record: the destination of a row
   is its block's begin plus its rank among the block's left (or right)
   rows, from one exact prefix count. The JAX package does the same with
   one stable `lax.sort` over ``(block_begin << 1) | side``; the
   permutation is the same;
3. histograms every split's smaller child (by the global counts) in ONE
   launch of kernel B5 over a segment table built on the card, takes the
   larger child as parent minus smaller, and searches the 2k children;
4. reads the children's best splits and their local left counts back in
   one copy.

The JAX package runs the rounds in one `lax.while_loop` on the device
and re-evaluates all S + 1 slots each round; here the rounds are a host
loop over numpy tables (a few thousand numbers), and only the 2k slots a
round changed are evaluated (the others' inputs are unchanged). Then
`replay_leafwise` re-runs the reference's priority queue
(`serial_tree_learner.cpp:173-237`) over the executed splits; a tree
whose replay needs a split beyond the speculation frontier is inexact and
the caller grows it leaf-wise. The physical partition is finer than the
committed tree, so the score update runs over the physical blocks with
each block's covering committed value.
"""
from __future__ import annotations

import heapq
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops.aligned import (R_CAT, R_COPY, R_DL, R_MT, R_SHIFT, cat_word,
                           goes_left, pack_route2)
from ..ops.histogram import histogram_from_words
from .device_learner import (BF_GAIN, BF_LG, BF_LH, BF_LOUT, BF_RG, BF_RH,
                             BF_ROUT, BF_W, BI_CAT0, BI_DEFLEFT, BI_FEAT,
                             BI_ISCAT, BI_LC, BI_RC, BI_THR, BI_W, LF_MAXC,
                             LF_MINC, LF_SG, LF_SH, LF_VALUE, LF_W, LI_BEGIN,
                             LI_COUNT, LI_COUNTG, LI_DEPTH, LI_W, TreeRecord)

# speculated-split record lanes (execution order e; right child slot e+1)
SF_GAIN, SF_LOUT, SF_ROUT, SF_IVAL = range(4)
SF_W = 4
SI_SLOT, SI_FEAT, SI_THR, SI_DEFLEFT, SI_ISCAT, SI_LC, SI_RC = range(7)
SI_W = 8


class SpecResult(NamedTuple):
    """One speculative level build: the final row-id permutation on the
    device, the rest host tables (JAX package: `SpecResult`)."""
    rid: torch.Tensor          # i32[N] row id at each position
    rounds: int
    n_exec: int                # executed speculative splits
    execF: np.ndarray          # f32[S-1, SF_W]
    execI: np.ndarray          # i64[S-1, SI_W]
    execB: np.ndarray          # i64[S-1, 8] categorical splits' bitsets
    bestF: np.ndarray          # f32[S, BF_W] frontier candidates
    leafF: np.ndarray          # f32[S, LF_W]
    leafI: np.ndarray          # i64[S, LI_W]
    block_begin: np.ndarray    # i64[S] physical partition block starts
    block_cnt: np.ndarray      # i64[S]


def pack_bin_words(bins: torch.Tensor) -> torch.Tensor:
    """uint8 bins [N, F] -> packed int32 words [ceil(F/4), N] on the
    device of ``bins``: word w holds features 4w..4w+3, feature 4w+j in
    bits 8j..8j+7 (the padded features are 0)."""
    if sys.byteorder != "little":
        raise NotImplementedError("packing bins into words by a view "
                                  "assumes a little-endian host")
    n, f = bins.shape
    wcnt = (f + 3) // 4
    padded = torch.zeros((n, wcnt * 4), dtype=torch.uint8,
                         device=bins.device)
    padded[:, :f] = bins
    return padded.view(torch.int32).t().contiguous()


def extract_bin(words: torch.Tensor, word_idx: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """Per-row bin of a per-row feature: select the word, shift, mask."""
    return (words.gather(0, word_idx.long()[None])[0] >> shift) & 255


def spec_slots(num_leaves: int, factor: float) -> int:
    """Speculation slot count S: ~factor x num_leaves, min num_leaves+1."""
    return max(int(np.ceil(factor * num_leaves)), num_leaves + 1)


def make_level_build_fn(learner):
    """The speculative level build of a DeviceTreeLearner: returns
    fn(words [wcnt, N] int32, grad [N], hess [N], fmask [F] f32) ->
    SpecResult. `replay_leafwise` turns the result into the tree."""
    cfg = learner.cfg
    L = cfg.num_leaves
    S = spec_slots(L, float(cfg.tpu_level_spec))
    Sm1 = S - 1
    F = learner.num_features
    B = learner.max_bin_global
    n = learner.n
    dev = learner.device
    meta = learner.meta
    mono = meta["monotone"].astype(np.int64)
    mono_any = bool(mono.any())
    mt = meta["missing_type"].astype(np.int64)
    db = np.clip(meta["default_bin"], 0, 255).astype(np.int64)
    nb = np.clip(meta["num_bin"], 1, 256).astype(np.int64)
    wcnt = (F + 3) // 4
    G, H, RID = wcnt, wcnt + 1, wcnt + 2
    f64 = learner.hist_precision == "f64"
    i32 = torch.int32

    def gh(rec):
        return rec[G].view(torch.float32), rec[H].view(torch.float32)

    def build(words, grad, hess, fmask) -> SpecResult:
        cur = torch.empty((wcnt + 3, n), dtype=i32, device=dev)
        cur[:wcnt] = words
        cur[G] = grad.to(torch.float32).view(i32)
        cur[H] = hess.to(torch.float32).view(i32)
        cur[RID] = torch.arange(n, dtype=i32, device=dev)
        spare = torch.empty_like(cur)
        store = torch.empty((S + 1, F, B, 3), dtype=torch.float32,
                            device=dev)
        pos = torch.arange(n, dtype=i32, device=dev)

        # ---------- root (JAX :203-243): one segment; f64 sums in f64 mode
        g0, h0 = gh(cur)
        store[0] = histogram_from_words(
            cur[:wcnt], g0, h0, torch.zeros(1, dtype=i32, device=dev),
            torch.full((1,), n, dtype=i32, device=dev), F, B,
            rows_hint=n, precision=learner.hist_precision)[0]
        sums = torch.stack([g0.double().sum(), h0.double().sum()]) if f64 \
            else torch.stack([g0.sum(), h0.sum()])
        root_g, root_h = sums.to(torch.float32).cpu().numpy()
        leafF = np.zeros((S + 1, LF_W), np.float32)
        leafF[:, LF_MINC] = -np.inf
        leafF[:, LF_MAXC] = np.inf
        leafF[0, LF_SG], leafF[0, LF_SH] = root_g, root_h
        leafI = np.zeros((S + 1, LI_W), np.int64)
        leafI[:, LI_BEGIN] = n
        leafI[0, LI_BEGIN] = 0
        leafI[0, LI_COUNT] = leafI[0, LI_COUNTG] = n
        execF = np.zeros((Sm1 + 1, SF_W), np.float32)
        execI = np.zeros((Sm1 + 1, SI_W), np.int64)
        execB = np.zeros((Sm1 + 1, 8), np.int64)
        bestF = np.full((S + 1, BF_W), -np.inf, np.float32)
        bestI = np.zeros((S + 1, BI_W), np.int64)
        bestF[:1], bestI[:1] = learner._eval_leaves(
            store[:1], [root_g], [root_h], [n], [-np.inf], [np.inf], [0],
            fmask)
        done = rounds = 0

        while done < Sm1 and bestF[:, BF_GAIN].max() > 0.0:
            # ---- selection (JAX :256-287): best gain first, ties by slot
            gains = bestF[:, BF_GAIN]
            order = np.argsort(-gains, kind="stable")
            k = min(int((gains > 0.0).sum()), Sm1 - done)
            slot_l = order[:k]                     # parent = left child
            slot_r = done + 1 + np.arange(k)       # right child slots
            bf, bi = bestF[slot_l], bestI[slot_l]
            e = done + np.arange(k)
            execF[e] = np.stack([bf[:, BF_GAIN], bf[:, BF_LOUT],
                                 bf[:, BF_ROUT], leafF[slot_l, LF_VALUE]],
                                axis=1)
            execI[e] = 0
            execI[e, SI_SLOT] = slot_l
            execI[e, SI_FEAT] = bi[:, BI_FEAT]
            execI[e, SI_THR] = bi[:, BI_THR]
            execI[e, SI_DEFLEFT] = bi[:, BI_DEFLEFT]
            execI[e, SI_LC] = bi[:, BI_LC]
            execI[e, SI_RC] = bi[:, BI_RC]
            execI[e, SI_ISCAT] = bi[:, BI_ISCAT]
            execB[e] = bi[:, BI_CAT0:BI_CAT0 + 8]

            # ---- routing (JAX :289-352): per existing slot a route word
            # (r1: threshold, shift, default-left, missing type, copy for
            # unselected blocks, categorical) and r2 | word index << 16,
            # and with a categorical split selected the slots' bitset
            # words (JAX `with_cat`); blocks in position order for the
            # per-row slot map
            ex = np.arange(done + 1)
            feat = bestI[ex, BI_FEAT]
            sel = np.zeros(done + 1, bool)
            sel[slot_l] = True
            r1 = (np.clip(bestI[ex, BI_THR], 0, 255)
                  | (((feat & 3) * 8) << R_SHIFT)
                  | (bestI[ex, BI_DEFLEFT] << R_DL) | (mt[feat] << R_MT)
                  | ((~sel).astype(np.int64) << R_COPY)
                  | (bestI[ex, BI_ISCAT] << R_CAT))
            r2 = pack_route2(db[feat], nb[feat]) | ((feat >> 2) << 16)
            beg = leafI[ex, LI_BEGIN]
            cnt = leafI[ex, LI_COUNT]
            ob = np.argsort(beg, kind="stable")
            rows = [ob, cnt[ob], r1, r2, beg, cnt]
            with_cat = bool((bestI[slot_l, BI_ISCAT] != 0).any())
            if with_cat:
                rows.extend(bestI[ex, BI_CAT0:BI_CAT0 + 8].T)
            tab = torch.as_tensor(np.stack(rows).astype(np.uint32)
                                  .view(np.int32), device=dev)
            slot_row = torch.repeat_interleave(tab[0].long(), tab[1].long(),
                                               output_size=n)
            r1p, r2p = tab[2][slot_row], tab[3][slot_row]
            binv = extract_bin(cur[:wcnt], r2p >> 16, (r1p >> R_SHIFT) & 31)
            catw = cat_word(tab[6:].t().reshape(-1), slot_row, binv) \
                if with_cat else None
            gl = goes_left(binv, r1p, r2p, True, catw)

            # ---- stable partition of every selected block: left rows from
            # the block's begin, right rows after its left count
            clp = torch.zeros(n + 1, dtype=i32, device=dev)
            clp[1:] = torch.cumsum(gl, 0, dtype=i32)
            bx = tab[4].long()
            left = clp[bx + tab[5].long()] - clp[bx]     # per existing slot
            bp = tab[4][slot_row]
            lrank = clp[:-1] - clp[bp.long()]
            dest = torch.where(gl, bp + lrank,
                               bp + left[slot_row] + (pos - bp - lrank))
            spare.index_copy_(1, dest.long(), cur)
            cur, spare = spare, cur

            # ---- children (JAX :418-450): the smaller child (global
            # counts, <=) of every split in one B5 launch; larger = parent
            # - smaller
            il = torch.as_tensor(slot_l, device=dev)
            ir = torch.as_tensor(slot_r, device=dev)
            sil = bi[:, BI_LC] <= bi[:, BI_RC]
            sil_t = torch.as_tensor(sil, device=dev)
            lk, bk, ck = left[il], tab[4][il], tab[5][il]
            g2, h2 = gh(cur)
            sm = histogram_from_words(
                cur[:wcnt], g2, h2, torch.where(sil_t, bk, bk + lk),
                torch.where(sil_t, lk, ck - lk), F, B,
                rows_hint=int(np.minimum(bi[:, BI_LC], bi[:, BI_RC]).sum()),
                precision=learner.hist_precision)
            lg = store[il] - sm
            s4 = sil_t[:, None, None, None]
            left_h = torch.where(s4, sm, lg)
            right_h = torch.where(s4, lg, sm)
            store[il] = left_h
            store[ir] = right_h

            # ---- constraints (JAX :370-384) and the children's search
            depth_new = leafI[slot_l, LI_DEPTH] + 1
            lmin = rmin = leafF[slot_l, LF_MINC]
            lmax = rmax = leafF[slot_l, LF_MAXC]
            if mono_any:
                m = mono[bi[:, BI_FEAT]]
                mid = (bf[:, BF_LOUT] + bf[:, BF_ROUT]) / np.float32(2.0)
                lmax = np.where(m > 0, np.minimum(lmax, mid), lmax)
                rmin = np.where(m > 0, np.maximum(rmin, mid), rmin)
                lmin = np.where(m < 0, np.maximum(lmin, mid), lmin)
                rmax = np.where(m < 0, np.minimum(rmax, mid), rmax)
            both = learner._eval_leaves_dev(
                torch.cat([left_h, right_h]),
                np.concatenate([bf[:, BF_LG], bf[:, BF_RG]]),
                np.concatenate([bf[:, BF_LH], bf[:, BF_RH]]),
                np.concatenate([bi[:, BI_LC], bi[:, BI_RC]]),
                np.concatenate([lmin, rmin]), np.concatenate([lmax, rmax]),
                np.concatenate([depth_new, depth_new]), fmask)
            host = torch.cat([both.reshape(-1), lk.view(torch.float32)]) \
                .cpu()                                  # the round's read
            vf, vi = learner._unpack_eval(
                host[:both.numel()].view(both.shape))
            lc = host[both.numel():].view(i32).numpy().astype(np.int64)

            # ---- leaf bookkeeping (JAX :386-416)
            beg_l = leafI[slot_l, LI_BEGIN]
            cnt_l = leafI[slot_l, LI_COUNT]
            leafF[slot_r] = 0.0
            leafF[slot_r, LF_SG] = bf[:, BF_RG]
            leafF[slot_r, LF_SH] = bf[:, BF_RH]
            leafF[slot_r, LF_MINC] = rmin
            leafF[slot_r, LF_MAXC] = rmax
            leafF[slot_r, LF_VALUE] = bf[:, BF_ROUT]
            leafI[slot_r] = 0
            leafI[slot_r, LI_BEGIN] = beg_l + lc
            leafI[slot_r, LI_COUNT] = cnt_l - lc
            leafI[slot_r, LI_COUNTG] = bi[:, BI_RC]
            leafI[slot_r, LI_DEPTH] = depth_new
            leafF[slot_l, LF_SG] = bf[:, BF_LG]
            leafF[slot_l, LF_SH] = bf[:, BF_LH]
            leafF[slot_l, LF_MINC] = lmin
            leafF[slot_l, LF_MAXC] = lmax
            leafF[slot_l, LF_VALUE] = bf[:, BF_LOUT]
            leafI[slot_l, LI_COUNT] = lc
            leafI[slot_l, LI_COUNTG] = bi[:, BI_LC]
            leafI[slot_l, LI_DEPTH] = depth_new
            bestF[slot_l], bestI[slot_l] = vf[:k], vi[:k]
            bestF[slot_r], bestI[slot_r] = vf[k:], vi[k:]
            done += k
            rounds += 1

        return SpecResult(
            rid=cur[RID].clone(), rounds=rounds, n_exec=done,
            execF=execF[:Sm1], execI=execI[:Sm1], execB=execB[:Sm1],
            bestF=bestF[:S], leafF=leafF[:S], leafI=leafI[:S],
            block_begin=leafI[:S, LI_BEGIN].copy(),
            block_cnt=leafI[:S, LI_COUNT].copy())

    return build


# ---------------------------------------------------------------------------
# host-side exact leaf-wise replay
# ---------------------------------------------------------------------------
def cover_values(execF, execI, committed, n_exec: int, size: int
                 ) -> np.ndarray:
    """Covering committed value of each physical block (slot): walk the
    executed splits in order; a committed split sets its children's
    values, a discarded one passes its parent's covering value to the
    right child's block. A slot's splits come in increasing execution
    order, so later committed splits overwrite correctly (JAX package:
    `replay_leafwise`, level_builder.py:571-584)."""
    cover = np.zeros(size, np.float32)
    for e in range(n_exec):
        sl = int(execI[e, SI_SLOT])
        if committed[e]:
            cover[sl] = execF[e, SF_LOUT]
            cover[e + 1] = execF[e, SF_ROUT]
        else:
            cover[e + 1] = cover[sl]
    return cover


def replay_leafwise(spec, num_leaves: int):
    """Replay the reference's priority-queue growth over the speculated
    splits. Returns (TreeRecord, exact): only executed splits can be
    committed, and ``exact`` is False when the replay needed a split
    beyond the speculation frontier while budget remained. Gain ties pop
    the lowest slot first. The record's block_* fields are the physical
    blocks (``spec.leafI``'s begin and count lanes) with their covering
    committed values, for the score update of a level build."""
    n_exec = int(spec.n_exec)
    execF = np.asarray(spec.execF)
    execI = np.asarray(spec.execI)
    execB = np.asarray(spec.execB)
    bestF = np.asarray(spec.bestF)
    leafI = np.asarray(spec.leafI)
    S = bestF.shape[0]
    Lm1 = max(num_leaves - 1, 1)

    # per-slot chain of executed splits, in execution order
    nxt = np.full(max(n_exec, 1), -1, np.int64)
    first_exec_of_slot = np.full(S, -1, np.int64)
    for e in range(n_exec - 1, -1, -1):
        sl = int(execI[e, SI_SLOT])
        nxt[e] = first_exec_of_slot[sl]
        first_exec_of_slot[sl] = e

    exact = True
    heap = []

    def push(slot: int, e_after: int):
        e = first_exec_of_slot[slot]
        while e != -1 and e < e_after:
            e = nxt[e]
        if e != -1:
            gain = float(execF[e, SF_GAIN])
            if gain > 0.0:
                heapq.heappush(heap, (-gain, slot, e))
        elif float(bestF[slot, BF_GAIN]) > 0.0:
            # frontier: an unexecuted positive candidate
            heapq.heappush(heap, (-float(bestF[slot, BF_GAIN]), slot, -1))

    push(0, 0)
    chosen = []          # (slot, exec_idx) in replay order
    budget = Lm1 if num_leaves > 1 else 0
    while heap and len(chosen) < budget:
        _, slot, e = heapq.heappop(heap)
        if e == -1:
            exact = False      # speculation too shallow for this path
            continue
        chosen.append((slot, e))
        push(slot, e + 1)
        push(e + 1, e + 1)

    L = max(num_leaves, 1)
    rec_leaf = np.zeros(Lm1, np.int32)
    recF = np.zeros((Lm1, 3), np.float32)         # lout, rout, gain
    recI = np.zeros((Lm1, 6), np.int32)     # feat, thr, dl, lc, rc, iscat
    recB = np.zeros((Lm1, 8), np.int64)           # bitset words
    leaf_value = np.zeros(L, np.float32)
    committed = np.zeros(max(n_exec, 1), bool)
    final_of_slot = np.full(S, -1, np.int64)
    final_of_slot[0] = 0
    for s_idx, (slot, e) in enumerate(chosen):
        fl = int(final_of_slot[slot])
        committed[e] = True
        final_of_slot[e + 1] = s_idx + 1
        rec_leaf[s_idx] = fl
        recF[s_idx] = (execF[e, SF_LOUT], execF[e, SF_ROUT],
                       execF[e, SF_GAIN])
        recI[s_idx] = (execI[e, SI_FEAT], execI[e, SI_THR],
                       execI[e, SI_DEFLEFT], execI[e, SI_LC],
                       execI[e, SI_RC], execI[e, SI_ISCAT])
        recB[s_idx] = execB[e]
        leaf_value[fl] = execF[e, SF_LOUT]
        leaf_value[s_idx + 1] = execF[e, SF_ROUT]

    record = TreeRecord(
        num_splits=len(chosen), leaf=rec_leaf, feature=recI[:, 0],
        threshold_bin=recI[:, 1], default_left=recI[:, 2] != 0,
        left_output=recF[:, 0], right_output=recF[:, 1],
        left_count=recI[:, 3], right_count=recI[:, 4], gain=recF[:, 2],
        leaf_value=leaf_value,
        leaf_begin=leafI[:L, LI_BEGIN].astype(np.int32),
        leaf_count=leafI[:L, LI_COUNT].astype(np.int32),
        block_begin=leafI[:, LI_BEGIN].astype(np.int32),
        block_cnt=leafI[:, LI_COUNT].astype(np.int32),
        block_value=cover_values(execF, execI, committed, n_exec, S),
        is_cat=recI[:, 5] != 0, cat_bitset=recB)
    return record, exact
