"""What the aligned engine takes from the level builder (port of the host
parts of lightgbm_tpu/models/level_builder.py): the speculated-split
record lanes, the speculation slot count, and the exact leaf-wise replay
of the reference's priority queue (`serial_tree_learner.cpp:173-237`)
over the speculated splits, on the host in numpy. The level-build program
itself and its kernel (B5) are a later slice.
"""
from __future__ import annotations

import heapq

import numpy as np

from .device_learner import BF_GAIN, LI_BEGIN, LI_COUNT, TreeRecord

# speculated-split record lanes (execution order e; right child slot e+1)
SF_GAIN, SF_LOUT, SF_ROUT, SF_IVAL = range(4)
SF_W = 4
SI_SLOT, SI_FEAT, SI_THR, SI_DEFLEFT, SI_ISCAT, SI_LC, SI_RC = range(7)
SI_W = 8


def spec_slots(num_leaves: int, factor: float) -> int:
    """Speculation slot count S: ~factor x num_leaves, min num_leaves+1."""
    return max(int(np.ceil(factor * num_leaves)), num_leaves + 1)


def replay_leafwise(spec, num_leaves: int):
    """Replay the reference's priority-queue growth over the speculated
    splits. Returns (TreeRecord, exact): only executed splits can be
    committed, and ``exact`` is False when the replay needed a split
    beyond the speculation frontier while budget remained. Gain ties pop
    the lowest slot first."""
    n_exec = int(spec.n_exec)
    execF = np.asarray(spec.execF)
    execI = np.asarray(spec.execI)
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
    recI = np.zeros((Lm1, 5), np.int32)           # feat, thr, dl, lc, rc
    leaf_value = np.zeros(L, np.float32)
    final_of_slot = np.full(S, -1, np.int64)
    final_of_slot[0] = 0
    for s_idx, (slot, e) in enumerate(chosen):
        fl = int(final_of_slot[slot])
        final_of_slot[e + 1] = s_idx + 1
        rec_leaf[s_idx] = fl
        recF[s_idx] = (execF[e, SF_LOUT], execF[e, SF_ROUT],
                       execF[e, SF_GAIN])
        recI[s_idx] = (execI[e, SI_FEAT], execI[e, SI_THR],
                       execI[e, SI_DEFLEFT], execI[e, SI_LC],
                       execI[e, SI_RC])
        leaf_value[fl] = execF[e, SF_LOUT]
        leaf_value[s_idx + 1] = execF[e, SF_ROUT]

    record = TreeRecord(
        num_splits=len(chosen), leaf=rec_leaf, feature=recI[:, 0],
        threshold_bin=recI[:, 1], default_left=recI[:, 2] != 0,
        left_output=recF[:, 0], right_output=recF[:, 1],
        left_count=recI[:, 3], right_count=recI[:, 4], gain=recF[:, 2],
        leaf_value=leaf_value,
        leaf_begin=leafI[:L, LI_BEGIN].astype(np.int32),
        leaf_count=leafI[:L, LI_COUNT].astype(np.int32))
    return record, exact
