"""Tree-ensemble prediction on the device (port of
lightgbm_tpu/ops/predict.py: `TreePredictor.predict_raw` and
`predict_raw_values`).

All rows advance one level per step through the stacked node arrays of
every tree at once, in f64 with the decision semantics of
`Tree::NumericalDecision` / `CategoricalDecision` (tree.h:216-270); the
per-tree values are summed in tree order, as the reference's host walk
does. This module reaches no kernel of its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.tree import Tree

MISSING_NONE_C, MISSING_ZERO_C, MISSING_NAN_C = 0, 1, 2

# rows per traversal chunk, times the tree count, bounds the [T, rows]
# frontier tensors
_FRONTIER_CELLS = 1 << 24


def stack_trees(trees: List[Tree]) -> Dict[str, np.ndarray]:
    """Stack per-tree node arrays into [T, max_nodes] matrices (+ flat
    categorical bitsets) for batched traversal over raw feature values
    (reference `stack_trees(binned=False)`)."""
    t_count = len(trees)
    max_nodes = max(max(t.num_leaves - 1, 1) for t in trees)
    max_leaves = max(t.num_leaves for t in trees)

    def zeros(dtype):
        return np.zeros((t_count, max_nodes), dtype=dtype)

    sf, dt, lc, rc = zeros(np.int64), zeros(np.int64), zeros(np.int64), \
        zeros(np.int64)
    thr = zeros(np.float64)
    cat_start, cat_len = zeros(np.int64), zeros(np.int64)
    leaf_val = np.zeros((t_count, max_leaves), np.float64)
    words: List[int] = []
    num_leaves = np.zeros(t_count, np.int64)
    max_depth = 1
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        num_leaves[i] = t.num_leaves
        if n > 0:
            sf[i, :n] = t.split_feature[:n]
            thr[i, :n] = t.threshold[:n]
            dt[i, :n] = t.decision_type[:n]
            lc[i, :n] = t.left_child[:n]
            rc[i, :n] = t.right_child[:n]
            stack = [(0, 1)]
            while stack:
                node, d = stack.pop()
                max_depth = max(max_depth, d)
                for c in (t.left_child[node], t.right_child[node]):
                    if c >= 0:
                        stack.append((int(c), d + 1))
        leaf_val[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        start = len(words)
        words.extend(int(w) for w in t.cat_threshold)
        for node in range(n):
            if t.node_is_categorical(node):
                ci = int(t.threshold_in_bin[node])
                cat_start[i, node] = start + t.cat_boundaries[ci]
                cat_len[i, node] = (t.cat_boundaries[ci + 1]
                                    - t.cat_boundaries[ci])
    return {
        "split_feature": sf, "threshold": thr, "decision_type": dt,
        "left_child": lc, "right_child": rc, "cat_start": cat_start,
        "cat_len": cat_len, "cat_words": np.asarray(words or [0], np.int64),
        "leaf_value": leaf_val, "num_leaves": num_leaves,
        "max_depth": max_depth, "has_cat": bool(np.any(dt[:, :] & 1)),
    }


def _leaves_chunk(X: torch.Tensor, stk: Dict[str, torch.Tensor],
                  max_depth: int, has_cat: bool) -> torch.Tensor:
    """[T, n] leaf index of every tree for the rows of X [n, F] (f64)."""
    n = X.shape[0]
    t_count = stk["left_child"].shape[0]
    rows = torch.arange(n, device=X.device)[None, :]

    def take(a, idx):
        return torch.gather(a, 1, idx)

    node = torch.zeros((t_count, n), dtype=torch.int64, device=X.device)
    node[stk["num_leaves"] <= 1] = -1
    for _ in range(max_depth):
        safe = node.clamp(min=0)
        fval = X[rows, take(stk["split_feature"], safe)]        # [T, n]
        d = take(stk["decision_type"], safe)
        default_left = (d & 2) != 0
        mt = (d >> 2) & 3
        isnan = torch.isnan(fval)
        # NaN -> 0 unless missing type is NaN (tree.h:218-222)
        fv = torch.where(isnan & (mt != MISSING_NAN_C), 0.0, fval)
        is_default = (((mt == MISSING_ZERO_C) & (torch.abs(fv) <= 1e-35))
                      | ((mt == MISSING_NAN_C) & torch.isnan(fv)))
        go_left = torch.where(is_default, default_left,
                              fv <= take(stk["threshold"], safe))
        if has_cat:
            # categorical: NaN -> right under missing NaN, else category
            # 0; negative categories go right
            iv = torch.where(isnan, 0.0, fval).trunc().long()
            w = iv >> 5
            ok = (iv >= 0) & (w < take(stk["cat_len"], safe)) \
                & ~(isnan & (mt == MISSING_NAN_C))
            words = stk["cat_words"]
            widx = (take(stk["cat_start"], safe) + w).clamp(
                0, words.shape[0] - 1)
            bit = ((words[widx] >> (iv.clamp(min=0) & 31)) & 1) != 0
            go_left = torch.where((d & 1) != 0, ok & bit, go_left)
        nxt = torch.where(go_left, take(stk["left_child"], safe),
                          take(stk["right_child"], safe))
        node = torch.where(node >= 0, nxt, node)
    return ~node


def predict_raw_values(trees: List[Tree], X, leaf_index: bool = False,
                       device: Optional[torch.device] = None) -> np.ndarray:
    """Raw prediction over raw feature values: [N] summed leaf values in
    f64, or [N, T] leaf indices when ``leaf_index``."""
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    X = torch.as_tensor(np.asarray(X, np.float64), device=device)
    n = X.shape[0]
    if not trees:
        return np.zeros((n, 0), np.int32) if leaf_index else np.zeros(n)
    host = stack_trees(trees)
    stk = {k: torch.as_tensor(v, device=device) for k, v in host.items()
           if isinstance(v, np.ndarray)}
    t_count = len(trees)
    rows_per = max(1, _FRONTIER_CELLS // t_count)
    out = torch.zeros(n, dtype=torch.float64, device=device)
    leaves_out = []
    for lo in range(0, n, rows_per):
        leaves = _leaves_chunk(X[lo:lo + rows_per], stk, host["max_depth"],
                               host["has_cat"])
        if leaf_index:
            leaves_out.append(leaves.t().to(torch.int32))
            continue
        vals = torch.gather(stk["leaf_value"], 1, leaves)
        acc = out[lo:lo + rows_per]
        for t in range(t_count):        # tree order, as the reference sums
            acc += vals[t]
    if leaf_index:
        return torch.cat(leaves_out).cpu().numpy()
    return out.cpu().numpy()


class TreePredictor:
    """Batched prediction over a list of trees."""

    def __init__(self, trees: List[Tree],
                 device: Optional[torch.device] = None) -> None:
        self.trees = trees
        self.device = device

    def predict_raw(self, X) -> np.ndarray:
        """Raw-value prediction [N] (reference Predictor path,
        predictor.hpp:66-115)."""
        return predict_raw_values(self.trees, X, device=self.device)
