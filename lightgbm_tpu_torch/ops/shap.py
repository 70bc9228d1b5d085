"""SHAP feature contributions for tree ensembles (port of
lightgbm_tpu/ops/shap.py).

Re-creates the reference `PredictContrib` path (`tree.h:123`,
`tree.cpp TreeSHAP`, the Lundberg & Lee exact TreeSHAP recursion): per
row and tree, the recursive path-weight computation, and the expected
value of the tree in the last column. It runs on the host, as in the JAX
package.

The JAX package copies the path into a fresh list of ``num_leaves + 2``
elements at every node it visits. Here, as in the reference's
`tree.cpp`, a tree has one preallocated path buffer, four flat lists
(feature, zero fraction, one fraction, weight), and a call at unique
depth ``d`` takes the segment that starts ``d`` elements after its
parent's. The arithmetic is the JAX package's, in its order, so the
values are its bits.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..models.tree import Tree


def _extend_path(fi, zf, of, pw, b: int, ud: int, zero_fraction: float,
                 one_fraction: float, feature_index: int) -> None:
    fi[b + ud] = feature_index
    zf[b + ud] = zero_fraction
    of[b + ud] = one_fraction
    pw[b + ud] = 1.0 if ud == 0 else 0.0
    for i in range(ud - 1, -1, -1):
        pw[b + i + 1] += one_fraction * pw[b + i] * (i + 1) / (ud + 1)
        pw[b + i] = zero_fraction * pw[b + i] * (ud - i) / (ud + 1)


def _unwind_path(fi, zf, of, pw, b: int, ud: int, path_index: int) -> None:
    one_fraction = of[b + path_index]
    zero_fraction = zf[b + path_index]
    next_one_portion = pw[b + ud]
    for i in range(ud - 1, -1, -1):
        if one_fraction != 0:
            tmp = pw[b + i]
            pw[b + i] = next_one_portion * (ud + 1) \
                / ((i + 1) * one_fraction)
            next_one_portion = tmp - pw[b + i] * zero_fraction \
                * (ud - i) / (ud + 1)
        else:
            pw[b + i] = pw[b + i] * (ud + 1) \
                / (zero_fraction * (ud - i))
    for i in range(path_index, ud):
        fi[b + i] = fi[b + i + 1]
        zf[b + i] = zf[b + i + 1]
        of[b + i] = of[b + i + 1]


def _unwound_path_sum(zf, of, pw, b: int, ud: int, path_index: int) -> float:
    one_fraction = of[b + path_index]
    zero_fraction = zf[b + path_index]
    next_one_portion = pw[b + ud]
    total = 0.0
    for i in range(ud - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (ud + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = pw[b + i] - tmp * zero_fraction \
                * (ud - i) / (ud + 1)
        else:
            total += pw[b + i] / (zero_fraction * (ud - i) / (ud + 1))
    return total


class _TreeShap:
    """One tree's node arrays as Python lists, its path buffer, and the
    recursion over them for one row at a time."""

    def __init__(self, tree: Tree) -> None:
        nl = tree.num_leaves
        self.tree = tree
        self.left = [int(v) for v in tree.left_child[:nl - 1]]
        self.right = [int(v) for v in tree.right_child[:nl - 1]]
        self.feat = [int(v) for v in tree.split_feature[:nl - 1]]
        self.thr = [float(v) for v in tree.threshold[:nl - 1]]
        self.dtype = [int(v) for v in tree.decision_type[:nl - 1]]
        self.icount = [float(v) for v in tree.internal_count[:nl - 1]]
        self.lcount = [float(v) for v in tree.leaf_count[:nl]]
        self.lvalue = [float(v) for v in tree.leaf_value[:nl]]
        depth = self._max_depth()
        size = (depth + 2) * (depth + 3) // 2
        self.fi = [-1] * size
        self.zf = [0.0] * size
        self.of = [0.0] * size
        self.pw = [0.0] * size

    def _max_depth(self) -> int:
        best, stack = 0, [(0, 0)]
        while stack:
            node, d = stack.pop()
            if node < 0:
                best = max(best, d)
            else:
                stack.append((self.left[node], d + 1))
                stack.append((self.right[node], d + 1))
        return best

    def _count(self, node: int) -> float:
        return self.lcount[~node] if node < 0 else self.icount[node]

    def expected_value(self, node: int) -> float:
        if node < 0:
            return self.lvalue[~node]
        lc, rc = self.left[node], self.right[node]
        lcount = self._count(lc)
        rcount = self._count(rc)
        total = lcount + rcount
        if total <= 0:
            return 0.0
        return (self.expected_value(lc) * lcount
                + self.expected_value(rc) * rcount) / total

    def _decide(self, node: int, x) -> int:
        """`Tree._decision` (the JAX package's `_decide`); a numerical
        node with no missing handling is decided here inline."""
        fval = float(x[self.feat[node]])
        if (self.dtype[node] & 13) == 0 and fval == fval:
            return self.left[node] if fval <= self.thr[node] \
                else self.right[node]
        return int(self.tree._decision(fval, node))

    def shap(self, x, phi, node: int, ud: int, pb: int, b: int,
             parent_zero: float, parent_one: float,
             parent_feature: int) -> None:
        fi, zf, of, pw = self.fi, self.zf, self.of, self.pw
        if ud > 0:
            fi[b:b + ud] = fi[pb:pb + ud]
            zf[b:b + ud] = zf[pb:pb + ud]
            of[b:b + ud] = of[pb:pb + ud]
            pw[b:b + ud] = pw[pb:pb + ud]
        _extend_path(fi, zf, of, pw, b, ud, parent_zero, parent_one,
                     parent_feature)
        if node < 0:
            leaf_value = self.lvalue[~node]
            for i in range(1, ud + 1):
                w = _unwound_path_sum(zf, of, pw, b, ud, i)
                phi[fi[b + i]] += w * (of[b + i] - zf[b + i]) * leaf_value
            return
        hot = self._decide(node, x)
        cold = self.right[node] if hot == self.left[node] \
            else self.left[node]
        hot_count = self._count(hot)
        cold_count = self._count(cold)
        total = self.icount[node]
        hot_zero = hot_count / total if total > 0 else 0.0
        cold_zero = cold_count / total if total > 0 else 0.0
        incoming_zero, incoming_one = 1.0, 1.0
        feature = self.feat[node]
        path_index = -1
        for i in range(1, ud + 1):
            if fi[b + i] == feature:
                path_index = i
                break
        if path_index >= 0:
            incoming_zero = zf[b + path_index]
            incoming_one = of[b + path_index]
            _unwind_path(fi, zf, of, pw, b, ud, path_index)
            ud -= 1
        nb = b + ud + 1
        self.shap(x, phi, hot, ud + 1, b, nb, hot_zero * incoming_zero,
                  incoming_one, feature)
        self.shap(x, phi, cold, ud + 1, b, nb, cold_zero * incoming_zero,
                  0.0, feature)


def predict_contrib(trees: List[Tree], X: np.ndarray,
                    num_class: int = 1) -> np.ndarray:
    """[N, F + 1] (or [N, K * (F + 1)] for K classes): the SHAP value of
    each feature and the expected value in the last column of each class
    block (the reference C API's contrib layout)."""
    X = np.asarray(X, np.float64)
    n, f = X.shape
    out = np.zeros((n, num_class, f + 1), np.float64)
    rows = [X[r].tolist() for r in range(n)]
    for ti, tree in enumerate(trees):
        cls = ti % num_class
        if tree.num_leaves <= 1:
            out[:, cls, f] += tree.leaf_value[0]
            continue
        ts = _TreeShap(tree)
        base = ts.expected_value(0)
        for r in range(n):
            phi = [0.0] * (f + 1)
            phi[f] += base
            ts.shap(rows[r], phi, 0, 0, 0, 0, 1.0, 1.0, -1)
            out[r, cls] += phi
    if num_class == 1:
        return out[:, 0, :]
    return out.reshape(n, num_class * (f + 1))
