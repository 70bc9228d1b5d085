"""Tree-ensemble prediction on the device (port of
lightgbm_tpu/ops/predict.py: `TreePredictor.predict_raw`,
`predict_raw_values`, `predict_binned_leaves` and `flatten_forest`).

All rows advance one level per step through the stacked node arrays of
every tree at once, in f64 with the decision semantics of
`Tree::NumericalDecision` / `CategoricalDecision` (tree.h:216-270); the
per-tree values are added in tree order, as the reference's host walk
does, each to its class, and prediction early stopping stops a row's adds
once its margin passes (reference prediction_early_stop.cpp).
`predict_binned_leaves` walks the binned matrix (uint8, uint16 or
EFB-bundled) by the trees' bin thresholds instead, as continued training
replays an init model onto the training and validation scores.
`flatten_forest` lays the trees out for the native CPU predictor
(`native.predict_forest`). This module reaches no kernel of its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.tree import Tree
from .bins import take_bins

MISSING_NONE_C, MISSING_ZERO_C, MISSING_NAN_C = 0, 1, 2

# rows per traversal chunk, times the tree count, bounds the [T, rows]
# frontier tensors
_FRONTIER_CELLS = 1 << 24


def stack_trees(trees: List[Tree], binned: bool = False
                ) -> Dict[str, np.ndarray]:
    """Stack per-tree node arrays into [T, max_nodes] matrices (+ flat
    categorical bitsets) for batched traversal over raw feature values,
    or, ``binned``, over the binned matrix: the inner feature, bin
    threshold, default and bin count of each node and the bitsets over
    bins (JAX package: `stack_trees`)."""
    t_count = len(trees)
    max_nodes = max(max(t.num_leaves - 1, 1) for t in trees)
    max_leaves = max(t.num_leaves for t in trees)

    def zeros(dtype):
        return np.zeros((t_count, max_nodes), dtype=dtype)

    sf, dt, lc, rc = zeros(np.int64), zeros(np.int64), zeros(np.int64), \
        zeros(np.int64)
    thr = zeros(np.float64)
    thr_bin, dbin, nbin = zeros(np.int64), zeros(np.int64), zeros(np.int64)
    cat_start, cat_len = zeros(np.int64), zeros(np.int64)
    leaf_val = np.zeros((t_count, max_leaves), np.float64)
    words: List[int] = []
    num_leaves = np.zeros(t_count, np.int64)
    max_depth = 1
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        num_leaves[i] = t.num_leaves
        if n > 0:
            sf[i, :n] = (t.split_feature_inner if binned
                         else t.split_feature)[:n]
            thr[i, :n] = t.threshold[:n]
            thr_bin[i, :n] = t.threshold_in_bin[:n]
            dbin[i, :n] = t.node_default_bin[:n]
            nbin[i, :n] = t.node_num_bin[:n]
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
        bounds = t.cat_boundaries_inner if binned else t.cat_boundaries
        words.extend(int(w) for w in (t.cat_threshold_inner if binned
                                      else t.cat_threshold))
        for node in range(n):
            if t.node_is_categorical(node):
                ci = int(t.threshold_in_bin[node])
                cat_start[i, node] = start + bounds[ci]
                cat_len[i, node] = bounds[ci + 1] - bounds[ci]
    return {
        "split_feature": sf, "threshold": thr, "threshold_in_bin": thr_bin,
        "default_bin": dbin, "num_bin": nbin, "decision_type": dt,
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
                       device: Optional[torch.device] = None,
                       num_class: int = 1,
                       early_stop: Optional[Tuple[int, float]] = None
                       ) -> np.ndarray:
    """Raw prediction over raw feature values in f64: [N] (one class) or
    [N, K] (``num_class`` K, tree i adding to class i % K), or [N, T]
    leaf indices when ``leaf_index``. ``early_stop`` = (freq in trees,
    margin): after every freq-th tree but the last, a row whose margin
    passes stops adding, |score| > margin for one class and the gap
    between its two largest scores for K (the native predictor's test,
    src/native/predictor.cpp)."""
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    X = torch.as_tensor(np.asarray(X, np.float64), device=device)
    n = X.shape[0]
    if not trees:
        if leaf_index:
            return np.zeros((n, 0), np.int32)
        return np.zeros(n) if num_class == 1 else np.zeros((n, num_class))
    host = stack_trees(trees)
    stk = {k: torch.as_tensor(v, device=device) for k, v in host.items()
           if isinstance(v, np.ndarray)}
    t_count = len(trees)
    rows_per = max(1, _FRONTIER_CELLS // t_count)
    out = torch.zeros((num_class, n), dtype=torch.float64, device=device)
    freq, margin = early_stop if early_stop is not None else (0, 0.0)
    leaves_out = []
    for lo in range(0, n, rows_per):
        leaves = _leaves_chunk(X[lo:lo + rows_per], stk, host["max_depth"],
                               host["has_cat"])
        if leaf_index:
            leaves_out.append(leaves.t().to(torch.int32))
            continue
        vals = torch.gather(stk["leaf_value"], 1, leaves)
        acc = out[:, lo:lo + rows_per]
        active = None
        for t in range(t_count):        # tree order, as the reference adds
            c = t % num_class
            if active is None:
                acc[c] += vals[t]
            else:
                acc[c] = torch.where(active, acc[c] + vals[t], acc[c])
            if freq > 0 and (t + 1) % freq == 0 and t + 1 < t_count:
                if num_class == 1:
                    passed = acc[0].abs() > margin
                else:
                    top = torch.topk(acc, 2, dim=0).values
                    passed = top[0] - top[1] > margin
                active = ~passed if active is None else active & ~passed
    if leaf_index:
        return torch.cat(leaves_out).cpu().numpy()
    res = out.cpu().numpy()
    return res[0] if num_class == 1 else res.T


def flatten_forest(trees: List[Tree], num_class: int = 1
                   ) -> Dict[str, np.ndarray]:
    """The trees' node arrays end to end for the native batch predictor
    (src/native/predictor.cpp; JAX package: `flatten_forest`), keyed as
    its C interface takes them."""
    t_count = len(trees)
    node_off = np.zeros(t_count + 1, np.int64)
    leaf_off = np.zeros(t_count + 1, np.int64)
    cat_bnd_off = np.zeros(t_count + 1, np.int64)
    cat_words_off = np.zeros(t_count + 1, np.int64)
    for i, t in enumerate(trees):
        node_off[i + 1] = node_off[i] + max(t.num_leaves - 1, 0)
        leaf_off[i + 1] = leaf_off[i] + t.num_leaves
        cat_bnd_off[i + 1] = cat_bnd_off[i] + len(t.cat_boundaries)
        cat_words_off[i + 1] = cat_words_off[i] + len(t.cat_threshold)
    total_nodes = max(int(node_off[-1]), 1)
    left = np.empty(total_nodes, np.int32)
    right = np.empty(total_nodes, np.int32)
    feat = np.zeros(total_nodes, np.int32)
    thresh = np.zeros(total_nodes, np.float64)
    dtype = np.zeros(total_nodes, np.int8)
    leaf_value = np.zeros(max(int(leaf_off[-1]), 1), np.float64)
    cat_boundaries = np.zeros(max(int(cat_bnd_off[-1]), 1), np.int32)
    cat_words = np.zeros(max(int(cat_words_off[-1]), 1), np.uint32)
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        a, b = int(node_off[i]), int(node_off[i + 1])
        if n > 0:
            left[a:b] = t.left_child[:n]
            right[a:b] = t.right_child[:n]
            feat[a:b] = t.split_feature[:n]
            thresh[a:b] = t.threshold[:n]
            dtype[a:b] = t.decision_type[:n]
        la, lb = int(leaf_off[i]), int(leaf_off[i + 1])
        leaf_value[la:lb] = t.leaf_value[:t.num_leaves]
        ca, cb = int(cat_bnd_off[i]), int(cat_bnd_off[i + 1])
        cat_boundaries[ca:cb] = np.asarray(t.cat_boundaries, np.int32)
        wa, wb = int(cat_words_off[i]), int(cat_words_off[i + 1])
        if wb > wa:
            cat_words[wa:wb] = np.asarray(t.cat_threshold, np.uint32)
    return {
        "node_off": node_off, "leaf_off": leaf_off,
        "left": left, "right": right, "feat": feat, "thresh": thresh,
        "dtype": dtype, "leaf_value": leaf_value,
        "cat_bnd_off": cat_bnd_off, "cat_boundaries": cat_boundaries,
        "cat_words_off": cat_words_off, "cat_words": cat_words,
        "num_leaves": np.asarray([t.num_leaves for t in trees], np.int32),
        "tree_class": (np.arange(t_count, dtype=np.int32)
                       % max(num_class, 1)),
    }


def predict_binned_leaves(trees: List[Tree], bins: torch.Tensor,
                          bundles=None) -> torch.Tensor:
    """[T, N] leaf index of every tree for each row of the binned matrix
    ``bins`` (uint8 or uint16 [N, F], or [N, G] storage columns with
    ``bundles``, a `BundleInfo`), on its device (JAX package:
    `TreePredictor.predict_binned_leaves`): every tree advances one
    level a step, by the bin semantics of `DenseBin::Split`
    (`ops/partition.py`)."""
    from .partition import bundle_unpack
    dev = bins.device
    n = bins.shape[0]
    if not trees:
        return torch.zeros((0, n), dtype=torch.int64, device=dev)
    host = stack_trees(trees, binned=True)
    stk = {k: torch.as_tensor(v, device=dev) for k, v in host.items()
           if isinstance(v, np.ndarray)}
    if bundles is not None:
        col, off, pk = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                        for a in (bundles.col, bundles.off, bundles.packed))
    t_count = len(trees)
    rows = torch.arange(n, device=dev)[None, :]

    def take(a, idx):
        return torch.gather(a, 1, idx)

    node = torch.zeros((t_count, n), dtype=torch.int64, device=dev)
    node[stk["num_leaves"] <= 1] = -1
    words = stk["cat_words"]
    for _ in range(host["max_depth"]):
        safe = node.clamp(min=0)
        feat = take(stk["split_feature"], safe)
        d = take(stk["decision_type"], safe)
        db = take(stk["default_bin"], safe)
        nb = take(stk["num_bin"], safe)
        if bundles is None:
            fval = take_bins(bins, rows, feat).long()
        else:
            fval = bundle_unpack(take_bins(bins, rows, col[feat]).long(),
                                 off[feat], pk[feat], db, nb)
        mt = (d >> 2) & 3
        is_default = torch.where(mt == MISSING_ZERO_C, fval == db,
                                 (mt == MISSING_NAN_C) & (fval == nb - 1))
        go_left = torch.where(is_default, (d & 2) != 0,
                              fval <= take(stk["threshold_in_bin"], safe))
        if host["has_cat"]:
            widx = (take(stk["cat_start"], safe) + (fval >> 5)).clamp(
                0, words.shape[0] - 1)
            cat_left = (((words[widx] >> (fval & 31)) & 1) != 0) \
                & ((fval >> 5) < take(stk["cat_len"], safe))
            go_left = torch.where((d & 1) != 0, cat_left, go_left)
        nxt = torch.where(go_left, take(stk["left_child"], safe),
                          take(stk["right_child"], safe))
        node = torch.where(node >= 0, nxt, node)
    return ~node


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
