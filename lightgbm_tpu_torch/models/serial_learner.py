"""Host-driven leaf-wise tree learner (port of
lightgbm_tpu/models/serial_learner.py).

Re-creates the reference `SerialTreeLearner` (`src/treelearner/
serial_tree_learner.cpp:173-892`) as the JAX package runs it for the
objectives that renew leaf outputs (regression_l1, quantile, mape) and for
the lazy CEGB penalty: best-first growth to ``num_leaves``, each step
histogramming the SMALLER child (kernel B1 on the card, its twin on the
CPU) and deriving the larger by parent-minus-smaller subtraction, the
split applied to the row partition and monotone mid-constraints passed to
the children. The split search is the finder alone, not the leaf-wise
program's root search (no root contraction); its gains come back to the
host as f64, where the feature mask, ``max_depth`` and the CEGB penalties
(split, coupled and lazy) act in f64 as in the JAX package, and a leaf
splits when its gain is strictly positive and finite. Forced splits
(``forcedsplits_filename``) are read from the leaf's histogram in f64
(`GatherInfoForThreshold`), ahead of the gain-driven growth. After the
tree is grown, `renew_tree_output` sets each leaf's output to the
objective's percentile of its rows' residuals, before shrinkage.

The learner never sees bundled bins: the JAX package's EFB gate keeps
bundling off for these objectives and for the lazy penalty.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..ops.histogram import leaf_histogram, subtract_histogram
from ..ops.partition import split_partition
from ..ops.split import make_split_finder
from ..utils.xla_math import sum_f32
from .device_learner import DeviceTreeLearner
from .tree import Tree

_MISSING_CODE_TO_C = {"none": 0, "zero": 1, "nan": 2}
# the finder's per-feature lanes read back to the host, f32 and int
_FL = ("gain", "left_g", "left_h", "right_g", "right_h", "left_output",
       "right_output")
_IL = ("threshold", "default_left", "left_c", "right_c")


def _pow2_pad(n: int, min_pad: int) -> int:
    return max(min_pad, 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0))


def _threshold_l1(s, l1):
    return np.sign(s) * np.maximum(np.abs(s) - l1, 0.0)


class _LeafInfo:
    __slots__ = ("begin", "count", "sum_g", "sum_h", "hist", "best",
                 "depth", "min_constraint", "max_constraint")

    def __init__(self, begin, count, sum_g, sum_h, depth=0,
                 min_constraint=-np.inf, max_constraint=np.inf):
        self.begin = begin
        self.count = count
        self.sum_g = sum_g
        self.sum_h = sum_h
        self.hist = None
        self.best = None
        self.depth = depth
        self.min_constraint = min_constraint
        self.max_constraint = max_constraint


class SerialTreeLearner(DeviceTreeLearner):
    """The reference `TreeLearner` contract on the host
    (`include/LightGBM/tree_learner.h`), sharing the device learner's
    binned matrix, metadata, feature-fraction draw and forced-split
    nodes."""

    def __init__(self, cfg: Config, dataset: Dataset,
                 device: torch.device) -> None:
        super().__init__(cfg, dataset, device)
        if self.bundled:
            raise ValueError("the host learner takes unbundled bins (the "
                             "EFB gate keeps bundling off for its runs)")
        # the finder jitted alone in the JAX package: no root forms, the
        # reported gain less the plain copy of the gain shift
        self.finder = make_split_finder(self.hyper, self.meta,
                                        self.max_bin_global, device)
        self.quant_bits, self.quant_why = 0, "host learner"
        # CEGB state (serial_tree_learner.cpp:110-115, 537-568): coupled
        # penalties charge a feature's cost once per MODEL, lazy penalties
        # once per (feature, row)
        self._cegb_host_on = (cfg.cegb_penalty_split > 0
                              or len(cfg.cegb_penalty_feature_coupled) > 0
                              or len(cfg.cegb_penalty_feature_lazy) > 0)
        self._cegb_feature_used = np.zeros(dataset.num_total_features, bool)
        self._cegb_lazy_marked: Dict[int, torch.Tensor] = {}
        self.indices: Optional[torch.Tensor] = None
        self._gh: Optional[torch.Tensor] = None

    def aligned_mode_gate(self, objective) -> Optional[str]:
        return "host SerialTreeLearner (leaf renewal or lazy CEGB)"

    # ------------------------------------------------------------------
    def _leaf_hist(self, leaf: _LeafInfo, contiguous: bool = False
                   ) -> torch.Tensor:
        """[F, B, 3] f32 histogram of a leaf's rows (f64 sums rounded to
        f32 once under ``tpu_use_f64_hist``)."""
        hist = leaf_histogram(self.bins, self._gh,
                              None if contiguous else self.indices,
                              leaf.begin, leaf.count, self.max_bin_global,
                              self.hist_precision)
        return hist.to(torch.float32)

    def _find_best(self, leaves, feature_mask) -> None:
        """Each leaf's best split (`_find_best` of the JAX package), one
        search over the batch and one read: the finder's f32 gains as f64
        on the host, the feature mask, the depth limit and the CEGB
        penalties in f64, the first feature of the largest gain."""
        dev = self.device

        def t(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        f32 = np.float32
        out = self.finder(
            torch.stack([lf.hist for lf in leaves]),
            t([f32(lf.sum_g) for lf in leaves], torch.float32),
            t([f32(lf.sum_h) for lf in leaves], torch.float32),
            t([lf.count for lf in leaves], torch.int32),
            t([f32(lf.min_constraint) for lf in leaves], torch.float32),
            t([f32(lf.max_constraint) for lf in leaves], torch.float32))
        words = out["cat_bitset"]
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        ints = torch.cat([torch.stack([out[k].to(torch.int32) for k in _IL],
                                      dim=1),
                          words.to(torch.int32).transpose(1, 2)], dim=1)
        both = torch.cat([torch.stack([out[k].to(torch.float32)
                                       for k in _FL], dim=1),
                          ints.view(torch.float32)], dim=1).cpu()
        fl = both[:, :len(_FL)].numpy()
        il = both[:, len(_FL):].contiguous().view(torch.int32).numpy() \
            .astype(np.int64)
        for i, leaf in enumerate(leaves):
            leaf.best = self._best_of(leaf, fl[i], il[i], feature_mask)

    def _best_of(self, leaf: _LeafInfo, fl: np.ndarray, il: np.ndarray,
                 feature_mask) -> dict:
        gain = np.asarray(fl[0], np.float64)
        if feature_mask is not None:
            gain = np.where(feature_mask, gain, -np.inf)
        # depth limit (BeforeFindBestSplit, serial_tree_learner.cpp:364-377)
        if 0 < self.cfg.max_depth <= leaf.depth:
            gain = np.full_like(gain, -np.inf)
        if self._cegb_host_on:
            gain = gain - self._cegb_penalties(leaf)
        f = int(np.argmax(gain))
        res = {"feature": f, "gain": float(gain[f]),
               "threshold": int(il[0, f]), "default_left": bool(il[1, f]),
               "left_g": float(fl[1, f]), "left_h": float(fl[2, f]),
               "left_c": int(il[2, f]), "right_g": float(fl[3, f]),
               "right_h": float(fl[4, f]), "right_c": int(il[3, f]),
               "left_output": float(fl[5, f]),
               "right_output": float(fl[6, f]),
               "is_cat": bool(self.meta["bin_type"][f] == 1)}
        if res["is_cat"]:
            w = il[4:, f] & 0xFFFFFFFF
            nb = min(int(self.meta["num_bin"][f]), 256)
            res["cat_bins"] = [b for b in range(nb)
                               if (int(w[b // 32]) >> (b % 32)) & 1]
        return res

    # ------------------------------------------------------------------
    def _cegb_penalties(self, leaf: _LeafInfo) -> np.ndarray:
        """Per-feature CEGB gain penalties of one leaf in f64 (reference
        serial_tree_learner.cpp:537-568 + CalculateOndemandCosts :488):
        the split penalty scales with the leaf's rows, a coupled penalty
        charges a feature no tree of the model used yet, a lazy penalty
        the leaf's rows that never passed a split on the feature."""
        cfg = self.cfg
        F = self.num_features
        pen = np.full(F, cfg.cegb_tradeoff * cfg.cegb_penalty_split
                      * leaf.count, np.float64)
        real = self.ds.real_feature_idx
        coupled = cfg.cegb_penalty_feature_coupled
        if len(coupled):
            c = np.asarray(coupled, np.float64)[real]
            pen += cfg.cegb_tradeoff * np.where(
                self._cegb_feature_used[real], 0.0, c)
        lazy = cfg.cegb_penalty_feature_lazy
        if len(lazy):
            lz = np.asarray(lazy, np.float64)[real]
            rows = self.indices[leaf.begin:leaf.begin + leaf.count].long()
            for f in range(F):
                if lz[f] == 0.0:
                    continue
                marked = self._cegb_lazy_marked.get(f)
                fresh = leaf.count if marked is None else int(
                    (~marked[rows]).sum())
                pen[f] += cfg.cegb_tradeoff * lz[f] * fresh
        return pen

    def _cegb_commit(self, f: int, begin: int, count: int) -> None:
        if not self._cegb_host_on:
            return
        self._cegb_feature_used[int(self.ds.real_feature_idx[f])] = True
        if len(self.cfg.cegb_penalty_feature_lazy):
            marked = self._cegb_lazy_marked.get(f)
            if marked is None:
                marked = torch.zeros(self.n, dtype=torch.bool,
                                     device=self.device)
                self._cegb_lazy_marked[f] = marked
            marked[self.indices[begin:begin + count].long()] = True

    # ------------------------------------------------------------------
    def _forced_split_info(self, leaf: _LeafInfo, f: int,
                           thr_bin: int) -> dict:
        """Split info AT a forced threshold from the leaf histogram in f64
        (reference GatherInfoForThreshold, feature_histogram.hpp:290+)."""
        cfg = self.cfg
        hist = leaf.hist[f].cpu().numpy().astype(np.float64)      # [B, 3]
        mapper = self.mappers[f]
        nb = mapper.num_bin
        hi = min(thr_bin + 1, nb)
        lg = hist[:hi, 0].sum()
        lh = hist[:hi, 1].sum()
        lc = int(round(hist[:hi, 2].sum()))
        if mapper.missing_type == "nan" and hi > nb - 1:
            # the NaN bin routes right under default_left=False
            lg -= hist[nb - 1, 0]
            lh -= hist[nb - 1, 1]
            lc -= int(round(hist[nb - 1, 2]))
        rg, rh = leaf.sum_g - lg, leaf.sum_h - lh
        rc = leaf.count - lc
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2

        def out(sg, sh):
            return float(-_threshold_l1(np.float64(sg), l1)
                         / (sh + l2)) if sh + l2 > 0 else 0.0

        def part_gain(sg, sh):
            t = _threshold_l1(np.float64(sg), l1)
            return float(t * t / (sh + l2)) if sh + l2 > 0 else 0.0

        gain = part_gain(lg, lh) + part_gain(rg, rh) \
            - part_gain(leaf.sum_g, leaf.sum_h)
        return {"feature": f, "gain": gain, "threshold": int(thr_bin),
                "default_left": False, "left_g": lg, "left_h": lh,
                "left_c": lc, "right_g": rg, "right_h": rh, "right_c": rc,
                "left_output": out(lg, lh), "right_output": out(rg, rh),
                "is_cat": False}

    def _apply_forced_splits(self, tree: Tree, leaves: Dict,
                             feature_mask) -> None:
        """BFS of the forced-splits JSON before the gain-driven growth
        (reference ForceSplits, serial_tree_learner.cpp:597-755): a node
        whose split would empty a child is skipped with its subtree."""
        nodes = self.forced
        q = [(0, 0)] if nodes else []
        head = 0
        while head < len(q) and tree.num_leaves < self.cfg.num_leaves:
            lid, nid = q[head]
            head += 1
            f, thr_bin, left, right = nodes[nid]
            b = self._forced_split_info(leaves[lid], f, thr_bin)
            if min(b["left_c"], b["right_c"]) < 1:
                continue
            right_leaf = self._commit_split(tree, leaves, lid, b,
                                            feature_mask)
            if left >= 0:
                q.append((lid, left))
            if right >= 0:
                q.append((right_leaf, right))

    def _commit_split(self, tree: Tree, leaves: Dict, best_leaf: int,
                      b: dict, feature_mask) -> int:
        """Apply one chosen split: the tree node, the partition, the CEGB
        marks and the children (smaller histogram + parent-minus-smaller,
        both searched). Shared by gain-driven growth and forced splits;
        returns the right leaf id."""
        cfg = self.cfg
        info = leaves[best_leaf]
        f = b["feature"]
        mapper = self.mappers[f]
        mt_c = _MISSING_CODE_TO_C[mapper.missing_type]
        real_feature = int(self.ds.real_feature_idx[f])
        bits = None
        if b["is_cat"]:
            cat_bins = b["cat_bins"]
            cats = [mapper.bin_2_categorical[bb] for bb in cat_bins
                    if bb < len(mapper.bin_2_categorical)]
            right_leaf = tree.split_categorical(
                best_leaf, f, real_feature, cat_bins, cats,
                b["left_output"], b["right_output"], b["left_c"],
                b["right_c"], b["gain"], mt_c,
                default_bin=mapper.default_bin, num_bin=mapper.num_bin)
            words = np.zeros(8, np.int64)
            for bb in cat_bins:
                words[bb // 32] |= 1 << (bb % 32)
            bits = torch.as_tensor(words, device=self.device)
        else:
            right_leaf = tree.split(
                best_leaf, f, real_feature, b["threshold"],
                mapper.bin_to_value(b["threshold"]), b["left_output"],
                b["right_output"], b["left_c"], b["right_c"], b["gain"],
                mt_c, b["default_left"], default_bin=mapper.default_bin,
                num_bin=mapper.num_bin)
        left_count = split_partition(
            self.indices, self.bins_T[f], info.begin, info.count,
            b["threshold"], b["default_left"], mt_c, mapper.default_bin,
            mapper.num_bin, bits)
        right_count = info.count - left_count
        self._cegb_commit(f, info.begin, info.count)

        lmin, lmax = info.min_constraint, info.max_constraint
        rmin, rmax = info.min_constraint, info.max_constraint
        mono = int(self.meta["monotone"][f]) if self._mono_any else 0
        if mono != 0:
            mid = (b["left_output"] + b["right_output"]) / 2.0
            if mono > 0:
                lmax = min(lmax, mid)
                rmin = max(rmin, mid)
            else:
                lmin = max(lmin, mid)
                rmax = min(rmax, mid)
        left = _LeafInfo(info.begin, left_count, b["left_g"], b["left_h"],
                         info.depth + 1, lmin, lmax)
        right = _LeafInfo(info.begin + left_count, right_count,
                          b["right_g"], b["right_h"], info.depth + 1,
                          rmin, rmax)
        smaller, larger = ((left, right) if left_count <= right_count
                           else (right, left))
        if tree.num_leaves < cfg.num_leaves:
            smaller.hist = self._leaf_hist(smaller)
            larger.hist = subtract_histogram(info.hist, smaller.hist)
            self._find_best([smaller, larger], feature_mask)
        leaves[best_leaf] = left
        leaves[right_leaf] = right
        info.hist = None
        return right_leaf

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_indices: Optional[torch.Tensor] = None,
              bag_count: Optional[int] = None
              ) -> Tuple[Tree, Dict[int, Tuple[int, int]]]:
        """Grow one tree (reference SerialTreeLearner::Train,
        serial_tree_learner.cpp:173-237) from the full-length [N]
        gradients; ``bag_indices`` (sorted row ids) restricts the rows.
        Returns the tree and each leaf's (begin, count) in the final
        partition (`self.indices`)."""
        cfg = self.cfg
        dev = self.device
        feature_mask = self.feature_mask()
        self._gh = torch.stack([grad, hess], dim=1).to(
            torch.float32).contiguous()
        contiguous = bag_indices is None
        if contiguous:
            count = self.n
            self.indices = torch.arange(self.n, dtype=torch.int32,
                                        device=dev)
        else:
            count = int(bag_count if bag_count is not None
                        else len(bag_indices))
            self.indices = bag_indices.to(device=dev, dtype=torch.int32,
                                          copy=True)
        root = _LeafInfo(0, count, 0.0, 0.0)
        root.hist = self._leaf_hist(root, contiguous)
        # the root's sums: XLA's f32 reduction over the leaf's rows padded
        # with zeros to the JAX package's bucket (`_root_sums`)
        padded = _pow2_pad(count, cfg.tpu_min_pad)
        gh = torch.zeros((padded, 2), dtype=torch.float32, device=dev)
        gh[:count] = self._gh[self.indices[:count].long()]
        sums = sum_f32(gh).cpu().numpy()
        root.sum_g, root.sum_h = float(sums[0]), float(sums[1])
        self._find_best([root], feature_mask)

        tree = Tree(cfg.num_leaves)
        leaves: Dict[int, _LeafInfo] = {0: root}
        self._apply_forced_splits(tree, leaves, feature_mask)
        while tree.num_leaves < cfg.num_leaves:
            # the first leaf of the largest positive finite gain
            # (serial_tree_learner.cpp:201-224)
            best_leaf, best_gain = -1, 0.0
            for lid in sorted(leaves):
                best = leaves[lid].best
                if best is not None and best["gain"] > best_gain \
                        and np.isfinite(best["gain"]):
                    best_leaf, best_gain = lid, best["gain"]
            if best_leaf < 0:
                break
            self._commit_split(tree, leaves, best_leaf,
                               leaves[best_leaf].best, feature_mask)
        self._gh = None
        return tree, {lid: (inf.begin, inf.count)
                      for lid, inf in leaves.items()}

    # ------------------------------------------------------------------
    def renew_tree_output(self, tree: Tree, leaf_begin_count: Dict,
                          objective, scores_np: np.ndarray,
                          label_np: np.ndarray,
                          weights_np: Optional[np.ndarray]) -> None:
        """Percentile leaf renewal of the L1 family (reference
        SerialTreeLearner::RenewTreeOutput, serial_tree_learner.cpp:
        854-892): each leaf's output the objective's percentile of its
        rows' residuals ``label - score`` (mape: weighted by its label
        weights), before shrinkage."""
        if not getattr(objective, "is_renew_tree_output", False):
            return
        idx_np = self.indices.cpu().numpy()
        for lid, (begin, count) in leaf_begin_count.items():
            rows = idx_np[begin:begin + count]
            resid = objective.residual(label_np[rows], scores_np[rows])
            if objective.name == "mape":
                w = objective._label_weight_np[rows]
            else:
                w = weights_np[rows] if weights_np is not None else None
            tree.leaf_value[lid] = objective.renew_leaf_output(resid, w)
