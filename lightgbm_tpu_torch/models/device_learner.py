"""Leaf-wise tree learner on the device (port of the serial path of
lightgbm_tpu/models/device_learner.py).

The JAX package grows a whole tree inside one `lax.while_loop`. Here the
same loop runs on the host as a sequence of launches, with one small host
read per split (the chosen leaf's split and the children's best splits):

- root: the identity partition, so the root histogram reads the head of
  ``bins`` contiguously (kernel B1 with no index slice); a bagged tree
  (`train`) starts from the bag's sorted row ids instead, and its root
  histogram is B1 over those gathered rows;
- each split: stable partition of the chosen leaf's slice, the smaller
  child's histogram (B1 over its slice of the partition), the larger
  child's by subtraction from the parent's stored histogram
  (`FeatureHistogram::Subtract`), and one split search for both children;
- ``max_depth``, ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf`` act
  exactly as in the reference; monotone constraints propagate to the
  children;
- forced splits (``forcedsplits_filename``, reference `ForceSplits`,
  serial_tree_learner.cpp:597-755): the JSON flattens to nodes, a BFS
  queue of (leaf, node) seeded with the root is popped ahead of the
  gain-driven choice, and each pop splits its leaf at the node's
  threshold, its sums read from the leaf's stored histogram
  (`forced_info`); a threshold that empties a child is skipped;
- CEGB (``cegb_penalty_split``, ``cegb_penalty_feature_coupled``,
  reference `CalculateOndemandCosts`): the split penalty scales with the
  leaf's row count, the coupled penalty charges a feature once per
  model; the penalty is taken off each feature's gain before the masks;
- quantized histograms (``tpu_quant_hist=on``): g and h are rounded
  stochastically to int8 or int16 once a tree (`quantize_gh`), every
  histogram sums the integers (kernel B1's integer branch) and is scaled
  back by the column's scale, as are the root's sums;
- bundled bins (`io/bundling.py`): the histograms and their store run
  over the G storage columns at ``hist_bins`` bins (a bundle holds up to
  256), each leaf's per-feature view is sliced out at its split search
  (`expand_hist`, the skipped default bins rebuilt from the leaf's
  totals), and the partition and the traversals read the split
  feature's storage column and unpack it (`bundle_unpack`).

The JAX package pads leaf slices to a table of bucket sizes because XLA
needs static shapes; launches here take the exact slice, so nothing is
padded.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..ops.histogram import leaf_histogram, quantize_gh, subtract_histogram
from ..io.bundling import expansion_map
from ..ops.partition import (MISSING_NAN_C, MISSING_ZERO_C, bundle_unpack,
                             categorical_goes_left, leaf_value_fill,
                             split_partition, unpermute_to_rows)
from ..ops.split import SplitHyper, make_split_finder
from ..utils import prng
from ..utils.xla_math import fma_f32, sum_f32
from .tree import Tree

# packed per-leaf "best split" float lanes (`pack_best_payload`)
BF_GAIN, BF_LG, BF_LH, BF_RG, BF_RH, BF_LOUT, BF_ROUT = range(7)
BF_W = 8
# packed per-leaf "best split" int lanes; a categorical split's bitset
# (8 words over bins, values in [0, 2^32)) in lanes BI_CAT0 .. BI_CAT0 + 7
BI_FEAT, BI_THR, BI_LC, BI_RC, BI_DEFLEFT, BI_ISCAT = range(6)
BI_CAT0 = 8
BI_W = 16
# packed per-leaf float / int state lanes of the aligned engine
LF_SG, LF_SH, LF_MINC, LF_MAXC, LF_VALUE = range(5)
LF_W = 8
LI_BEGIN, LI_COUNT, LI_COUNTG, LI_DEPTH = range(4)
LI_W = 8
# rows from which `auto` trains a non-pointwise objective on the aligned
# engine (the JAX package's row floor)
NON_POINTWISE_ROW_FLOOR = 1_000_000
# per-feature histogram cells (leaves x features x bins) one split search
# takes at once
EVAL_CELLS = 1 << 25



class TreeRecord(NamedTuple):
    """Per-split records of one grown tree (host arrays)."""
    num_splits: int
    leaf: np.ndarray               # i32[L-1] leaf id split at step s
    feature: np.ndarray            # i32[L-1] inner feature index
    threshold_bin: np.ndarray      # i32[L-1]
    default_left: np.ndarray       # bool[L-1]
    left_output: np.ndarray        # f32[L-1]
    right_output: np.ndarray       # f32[L-1]
    left_count: np.ndarray         # i32[L-1]
    right_count: np.ndarray        # i32[L-1]
    gain: np.ndarray               # f32[L-1]
    leaf_value: np.ndarray         # f32[L] final leaf outputs
    leaf_begin: np.ndarray         # i32[L] partition begins
    leaf_count: np.ndarray         # i32[L] partition counts
    is_cat: np.ndarray             # bool[L-1] categorical split
    cat_bitset: np.ndarray         # i64[L-1, 8] its left bins' bitset
    # a level build's physical partition is finer than its tree: the
    # score update runs over these blocks instead of the leaves
    block_begin: Optional[np.ndarray] = None   # i32[S] block starts
    block_cnt: Optional[np.ndarray] = None     # i32[S]
    block_value: Optional[np.ndarray] = None   # f32[S] covering value


def record_to_children(leaf_rec: np.ndarray, num_splits: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Child links from the split sequence: node s split leaf
    ``leaf_rec[s]`` into left = same leaf id, right = s+1. A child is the
    next node that splits that leaf, else ``~leaf``."""
    left = np.zeros(max(num_splits, 1), np.int32)
    right = np.zeros(max(num_splits, 1), np.int32)
    node_of_leaf = {}
    for s in range(num_splits - 1, -1, -1):
        lf = int(leaf_rec[s])
        left[s] = node_of_leaf.get(lf, ~lf)
        right[s] = node_of_leaf.get(s + 1, ~(s + 1))
        node_of_leaf[lf] = s
    return left, right


class DeviceTreeLearner:
    """Serial leaf-wise learner over a device-resident binned matrix."""

    def __init__(self, cfg: Config, dataset: Dataset,
                 device: torch.device) -> None:
        if cfg.tpu_grow_mode not in ("auto", "leafwise", "aligned",
                                     "level"):
            raise NotImplementedError(
                f"tpu_grow_mode={cfg.tpu_grow_mode!r}: the leaf-wise, "
                "aligned and level builders are ported")
        self.cfg = cfg
        self.ds = dataset
        self.device = device
        self.n = dataset.num_data
        self.num_features = dataset.num_features
        self.meta = dataset.feature_meta_arrays()
        self.has_cat = bool((self.meta["bin_type"] == 1).any())
        self.max_bin_global = int(self.meta["num_bin"].max()) \
            if self.num_features else 2
        self.bins = dataset.bins.to(device).contiguous()
        self._bins_T: Optional[torch.Tensor] = None
        self._init_bundles(dataset.bundles)
        self.hyper = SplitHyper.from_config(cfg)
        self.mappers = dataset.used_mappers()
        # forced splits: (feature, threshold bin, left node, right node)
        self.forced = self._forced_nodes()
        self.finder = make_split_finder(self.hyper, self.meta,
                                        self.max_bin_global, device,
                                        tested_report=bool(self.forced))
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self.hist_precision = "f64" if cfg.tpu_use_f64_hist else "f32"
        self._depth_limit = cfg.max_depth if cfg.max_depth > 0 else 1 << 30
        self._mono_any = bool(np.any(self.meta["monotone"] != 0))
        self._words: Optional[torch.Tensor] = None
        self.level_fallbacks = 0
        # (rounds, executed splits, exact) of the last level build
        self.level_last: Optional[Tuple[int, int, bool]] = None
        # quantized histograms: active bits (0 = f32 payloads) and why
        # not, and the per-tree sequence number of the rounding key
        self.quant_bits, self.quant_why = self._resolve_quant_bits(cfg)
        self._qseq = 0
        # CEGB: the split penalty an f32 row, and the features earlier
        # trees of the model used (their coupled penalty is paid)
        self._cegb_on = (cfg.cegb_penalty_split > 0
                         or len(cfg.cegb_penalty_feature_coupled) > 0)
        self._cegb_coupled_on = len(cfg.cegb_penalty_feature_coupled) > 0
        self._cegb_sp = np.float32(float(cfg.cegb_penalty_split)
                                   * float(cfg.cegb_tradeoff))
        self._cegb_used = np.zeros(self.num_features, bool)

    def _init_bundles(self, bnd) -> None:
        """The bundled view (JAX package: device_learner.py:267-288): the
        storage columns' count and bins (``num_storage_cols``,
        ``hist_bins``), each feature's storage column, offset and packing
        (``bcol``, ``boff``, ``bpk``, host arrays over features), and the
        expansion tables on the device (``_emap`` [F, B] flat indices into
        G x hist_bins, -1 for none; ``_edef`` [F, B] f32, 1 at a packed
        feature's default bin)."""
        F = self.num_features
        self.bundled = bnd is not None
        self.num_storage_cols = int(self.bins.shape[1])
        if not self.bundled:
            self.hist_bins = self.max_bin_global
            self.bcol = np.arange(F, dtype=np.int64)
            self.boff = np.zeros(F, np.int64)
            self.bpk = np.zeros(F, np.int64)
            return
        self.hist_bins = int(max(self.max_bin_global,
                                 int(bnd.group_num_bin.max())))
        m_idx, dmask = expansion_map(bnd, self.meta["num_bin"],
                                     self.meta["default_bin"],
                                     self.hist_bins)
        B = self.max_bin_global
        self._emap = torch.as_tensor(m_idx[:, :B].astype(np.int64),
                                     device=self.device)
        self._edef = torch.as_tensor(dmask[:, :B].astype(np.float32),
                                     device=self.device)
        self.bcol = bnd.col.astype(np.int64)
        self.boff = bnd.off.astype(np.int64)
        self.bpk = bnd.packed.astype(np.int64)

    def expand_hist(self, hist: torch.Tensor, sg, sh, cnt) -> torch.Tensor:
        """[K, G, hist_bins, 3] bundle histograms -> [K, F, B, 3]
        per-feature histograms (JAX package: `expand_hist`, the
        reference's FixHistogram, dataset.cpp:928-947): each feature's
        bins sliced out, a packed feature's default bin the leaf's totals
        (``sg``, ``sh``, ``cnt`` [K] f32 tensors) less its other bins,
        summed in f32 in XLA's order, the count rounded to an integer so
        that the min_data_in_leaf guards see exact counts."""
        k = hist.shape[0]
        flat = hist.reshape(k, -1, 3)
        safe = self._emap.clamp(0, flat.shape[1] - 1)
        out = flat[:, safe] * (self._emap >= 0)[None, :, :, None]
        totals = torch.stack([sg, sh, cnt], dim=1)                # [K, 3]
        fix = totals[:, None, :] - sum_f32(out, 2)
        fix[..., 2] = torch.round(fix[..., 2])
        return out + self._edef[None, :, :, None] * fix[:, :, None, :]

    def _resolve_quant_bits(self, cfg: Config) -> Tuple[int, Optional[str]]:
        """``tpu_quant_hist`` resolved to active bits (0: f32 payloads)
        and the reason when it does not quantize (JAX package:
        `_resolve_quant_bits`): off never; f64 histograms and gpu_use_dp
        never; the level builder never; on quantizes; auto quantizes in
        the JAX package only on a TPU, so never here."""
        mode = str(cfg.tpu_quant_hist).strip().lower()
        if mode == "off":
            return 0, "tpu_quant_hist=off"
        bits = 8 if int(cfg.tpu_quant_hist_bits) == 8 else 16
        if cfg.tpu_use_f64_hist or cfg.gpu_use_dp:
            prec = "f64" if cfg.tpu_use_f64_hist else "f32"
            return 0, f"hist_precision={prec} never quantizes"
        if cfg.tpu_grow_mode == "level":
            return 0, "tpu_grow_mode=level keeps f32 payloads"
        if mode == "on":
            return bits, None
        return 0, "auto: no TPU attached"

    def _next_qseq(self) -> int:
        """The sequence number of the next tree's rounding key."""
        self._qseq += 1
        return self._qseq

    def _forced_nodes(self):
        """The forced-splits JSON flattened to (inner feature, threshold
        bin, left node, right node) tuples, nodes indexed in the list
        (-1: no child); a node on an unused feature drops with its subtree
        (JAX package: `_forced_nodes`)."""
        if not self.cfg.forcedsplits_filename:
            return []
        import json
        with open(self.cfg.forcedsplits_filename) as fh:
            root = json.load(fh)
        out = []
        fmap = self.ds.used_feature_map

        def flat(node):
            if not isinstance(node, dict) or "feature" not in node:
                return -1
            real_f = int(node["feature"])
            f = int(fmap[real_f]) if real_f < len(fmap) else -1
            if f < 0:
                return -1
            idx = len(out)
            out.append(None)
            thr = int(self.mappers[f].values_to_bins(
                np.asarray([float(node["threshold"])]))[0])
            lft = flat(node.get("left"))
            rgt = flat(node.get("right"))
            out[idx] = (f, thr, lft, rgt)
            return idx

        flat(root)
        return out

    def _cegb_coupled_eff(self) -> np.ndarray:
        """f32 [F]: each feature's coupled penalty times the tradeoff,
        zero for the features earlier trees used (the once-per-model
        charge; JAX package: `_cegb_coupled_eff`)."""
        cp = np.zeros(self.num_features, np.float32)
        if self._cegb_coupled_on:
            arr = np.asarray(self.cfg.cegb_penalty_feature_coupled,
                             np.float64)
            real = np.asarray(self.ds.real_feature_idx)
            cp[:len(real)] = arr[real] * float(self.cfg.cegb_tradeoff)
            cp[self._cegb_used] = 0.0
        return cp

    def _cegb_note_record(self, rec: "TreeRecord") -> None:
        """Mark the features a grown tree split on as used by the model
        (JAX package: `_cegb_note_record`)."""
        if self._cegb_coupled_on:
            self._cegb_used[rec.feature[:rec.num_splits]] = True

    @property
    def bins_T(self) -> torch.Tensor:
        """Transposed bins [F, N]: the split feature's column is one
        contiguous row for the partition step."""
        if self._bins_T is None:
            self._bins_T = self.bins.t().contiguous()
        return self._bins_T

    def feature_mask(self) -> Optional[np.ndarray]:
        """The features one tree may split on (None: all), drawn as the
        JAX package draws them, once per call in the same order, so that
        its trees and the port's use the same subsets. Over every feature,
        bundled or not: the JAX package draws from the first G features
        of bundled data and masks the rest (ROADMAP C.24)."""
        frac = self.cfg.feature_fraction
        if frac >= 1.0:
            return None
        used_cnt = max(1, int(round(self.num_features * frac)))
        mask = np.zeros(self.num_features, bool)
        mask[self._feat_rng.choice(self.num_features, used_cnt,
                                   replace=False)] = True
        return mask

    def fmask_tensor(self, feature_mask: Optional[np.ndarray]
                     ) -> torch.Tensor:
        """The feature mask as f32 [F] on the device (all ones for None)."""
        if feature_mask is None:
            return torch.ones(self.num_features, dtype=torch.float32,
                              device=self.device)
        return torch.as_tensor(feature_mask.astype(np.float32),
                               device=self.device)

    # ------------------------------------------------------------------
    def _eval_leaves(self, hist, sg, sh, cnt, minc, maxc, depth, fmask,
                     root=False, cegb=None):
        """Best split of each leaf in a batch, on the device: hist
        [K, F, B, 3] f32 (bundled: [K, G, hist_bins, 3], expanded here)
        and host per-leaf sums -> host arrays (f32 [K,
        BF_W] BF_* lanes, i64 [K, BI_W] BI_* lanes), the reference's
        eval_leaf + pack_best_payload, read back in one copy. ``root``
        marks the leaf-wise builder's root search (`make_split_finder`);
        ``cegb`` is (used [F], coupled [F]) f32 under CEGB."""
        return self._unpack_eval(self._eval_leaves_dev(
            hist, sg, sh, cnt, minc, maxc, depth, fmask, root, cegb).cpu())

    @staticmethod
    def _unpack_eval(both: torch.Tensor):
        """(f32 [K, BF_W], i64 [K, BI_W]) from the read-back
        [K, BF_W + BI_W] f32 tensor (int lanes as f32 bits)."""
        vi = both[:, BF_W:].contiguous().view(torch.int32).numpy() \
            .astype(np.int64)
        vi[:, BI_CAT0:] &= 0xFFFFFFFF
        return both[:, :BF_W].numpy(), vi

    def _eval_leaves_dev(self, hist, sg, sh, cnt, minc, maxc, depth, fmask,
                         root=False, cegb=None) -> torch.Tensor:
        """`_eval_leaves` before the read: [K, BF_W + BI_W] f32 on the
        device, the BI_* lanes as int32 bits. A batch of more than
        ``EVAL_CELLS`` per-feature cells (a wide table's widest rounds)
        is searched a slice of leaves at a time, each leaf's search the
        same, so that the finder's temporaries stay bounded."""
        k = hist.shape[0]
        step = max(1, EVAL_CELLS // (self.num_features
                                     * self.max_bin_global))
        if k > step:
            return torch.cat([self._eval_leaves_dev(
                hist[i:i + step], sg[i:i + step], sh[i:i + step],
                cnt[i:i + step], minc[i:i + step], maxc[i:i + step],
                depth[i:i + step], fmask, root, cegb)
                for i in range(0, k, step)])
        dev = self.device

        def t(vals, dtype):
            return torch.tensor(np.asarray(vals), dtype=dtype, device=dev)

        if self.bundled:
            hist = self.expand_hist(hist, t(sg, torch.float32),
                                    t(sh, torch.float32),
                                    t(cnt, torch.float32))
        out = self.finder(hist, t(sg, torch.float32), t(sh, torch.float32),
                          t(cnt, torch.int32), t(minc, torch.float32),
                          t(maxc, torch.float32), root)
        gain = out["gain"]
        if cegb is not None:
            gain = gain - self._cegb_penalty(t(cnt, torch.float32), *cegb)
        gain = torch.where(fmask > 0, gain, float("-inf"))
        deep = t(np.asarray(depth) >= self._depth_limit, torch.bool)
        gain = torch.where(deep[:, None], float("-inf"), gain)
        f = torch.argmax(gain, dim=1, keepdim=True)

        def at(a):
            return torch.gather(a, 1, f)[:, 0]

        zf = torch.zeros(k, dtype=torch.float32, device=dev)
        vec_f = torch.stack([at(gain), at(out["left_g"]), at(out["left_h"]),
                             at(out["right_g"]), at(out["right_h"]),
                             at(out["left_output"]),
                             at(out["right_output"]), zf], dim=1)
        zi = torch.zeros(k, dtype=torch.int32, device=dev)
        cols = [f[:, 0].to(torch.int32), at(out["threshold"]).to(torch.int32),
                at(out["left_c"]).to(torch.int32),
                at(out["right_c"]).to(torch.int32),
                at(out["default_left"]).to(torch.int32)]
        if self.has_cat:
            # the winner's bitset words as int32 bits in BI_CAT0 on
            words = torch.gather(out["cat_bitset"], 1,
                                 f[:, :, None].expand(-1, -1, 8))[:, 0]
            words = torch.where(words >= 1 << 31, words - (1 << 32), words)
            vec_i = torch.cat([torch.stack(
                cols + [at(out["is_cat"]).to(torch.int32), zi, zi], dim=1),
                words.to(torch.int32)], dim=1)
        else:
            vec_i = torch.stack(cols + [zi] * (BI_W - len(cols)), dim=1)
        return torch.cat([vec_f, vec_i.view(torch.float32)], dim=1)

    def init_root_partition(self, bag_indices: Optional[torch.Tensor],
                            bag_cnt: int) -> Tuple[torch.Tensor, int]:
        """(row ids [count] int32 on the device, count) of one iteration's
        root (`DataPartition::Init`, data_partition.hpp:59): the bag's
        sorted row ids (a copy: `train` permutes it), or every row."""
        if bag_indices is None:
            return torch.arange(self.n, dtype=torch.int32,
                                device=self.device), self.n
        return bag_indices.to(device=self.device, dtype=torch.int32,
                              copy=True), int(bag_cnt)

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              indices: torch.Tensor, root_count: int,
              feature_mask: Optional[np.ndarray] = None
              ) -> Tuple[torch.Tensor, TreeRecord]:
        """Grow one tree on an explicit (bagged) root partition, the
        first ``root_count`` entries of ``indices``, which it permutes in
        place; returns (indices, TreeRecord). Its partition covers the
        bag alone, so the caller scores by traversal
        (`add_record_score`)."""
        return self._grow(grad, hess, feature_mask, indices, root_count)

    def train_fresh(self, grad: torch.Tensor, hess: torch.Tensor,
                    feature_mask: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, TreeRecord]:
        """Grow one tree on the full data from the identity partition;
        returns (final partition indices [N] int32, TreeRecord)."""
        return self._grow(grad, hess, feature_mask)

    def _cegb_penalty(self, cnt: torch.Tensor, used: np.ndarray,
                      coupled: np.ndarray) -> torch.Tensor:
        """[K, F] f32 CEGB penalty of K leaves of ``cnt`` rows (JAX
        package: `_cegb_pen`): the split penalty times the row count, plus
        the coupled penalty of each feature the tree has not used yet.
        The product is rounded before the add: XLA computes it on the
        leaf's scalar count, apart from the [F] add, so nothing is
        contracted (found against the JAX program's f64 trees)."""
        pen = cnt[:, None] * float(self._cegb_sp)
        if not self._cegb_coupled_on:
            return pen.expand(-1, self.num_features)
        c = torch.as_tensor(coupled * (np.float32(1.0) - used),
                            device=self.device)
        return pen + c[None, :]

    def _forced_info(self, ph: torch.Tensor, sg, sh, cntg: int, f: int,
                     thr: int):
        """(BF_* f32 lanes, BI_* int lanes) of the forced split of a leaf
        at (f, thr), from its stored histogram ``ph`` [F, B, 3] (bundled:
        expanded from [G, hist_bins, 3]) and its sums (JAX package:
        `forced_info`): the bins up to the threshold
        summed in f32 in XLA's order (`sum_f32`), less the
        NaN bin where the threshold takes it, the right side by
        difference, the gain and outputs of the plain leaf formula (L1
        and L2, no constraint)."""
        f32 = np.float32
        if self.bundled:
            ph = self.expand_hist(ph[None], *(
                torch.tensor([v], dtype=torch.float32, device=self.device)
                for v in (sg, sh, cntg)))[0]
        nbf = int(self.meta["num_bin"][f])
        hi = min(thr + 1, nbf)
        keep = torch.arange(ph.shape[1], device=ph.device) < hi
        acc = sum_f32(torch.where(keep[:, None], ph[f], 0.0)).cpu().numpy()
        row = ph[f].cpu().numpy()
        lg, lh, lcf = acc[0], acc[1], acc[2]
        if int(self.meta["missing_type"][f]) == 2 and hi > nbf - 1:
            last = row[min(max(nbf - 1, 0), row.shape[0] - 1)]
            lg, lh, lcf = lg - last[0], lh - last[1], lcf - last[2]
        lc = int(np.rint(lcf))
        sg, sh = f32(sg), f32(sh)
        rg, rh = f32(sg - lg), f32(sh - lh)
        l1, l2 = f32(self.hyper.lambda_l1), f32(self.hyper.lambda_l2)

        def tl1(v):
            return f32(np.sign(v) * max(f32(abs(v) - l1), f32(0.0)))

        def pgain(v, h):
            d = f32(h + l2)
            return f32(f32(tl1(v) * tl1(v)) / d) if d > 0 else f32(0.0)

        def outp(v, h):
            d = f32(h + l2)
            return f32(-tl1(v) / d) if d > 0 else f32(0.0)

        gain = f32(f32(pgain(lg, lh) + pgain(rg, rh)) - pgain(sg, sh))
        vf = np.zeros(BF_W, np.float32)
        vf[[BF_GAIN, BF_LG, BF_LH, BF_RG, BF_RH, BF_LOUT, BF_ROUT]] = (
            gain, lg, lh, rg, rh, outp(lg, lh), outp(rg, rh))
        vi = np.zeros(BI_W, np.int64)
        vi[[BI_FEAT, BI_THR, BI_LC, BI_RC]] = (f, thr, lc, cntg - lc)
        return vf, vi

    def _grow(self, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: Optional[np.ndarray],
              indices: Optional[torch.Tensor] = None,
              root_count: int = 0) -> Tuple[torch.Tensor, TreeRecord]:
        """The leaf-wise loop from the identity partition (``indices``
        None, the root read contiguously) or from the first
        ``root_count`` row ids of ``indices``."""
        cfg = self.cfg
        dev = self.device
        L = cfg.num_leaves
        Lm1 = max(L - 1, 1)
        BH = self.hist_bins
        prec = self.hist_precision
        nb, db, mt = (self.meta["num_bin"], self.meta["default_bin"],
                      self.meta["missing_type"])
        mono = self.meta["monotone"]
        gh = torch.stack([grad, hess], dim=1).to(torch.float32).contiguous()
        fmask = self.fmask_tensor(feature_mask)
        qscale = None
        if self.quant_bits:
            # one rounding key a tree over all N rows (after bagging's and
            # GOSS's reweighting): fold_in(PRNGKey(data_random_seed), qseq)
            key = prng.fold_in(prng.key(cfg.data_random_seed),
                               self._next_qseq())
            gh, qs = quantize_gh(gh, self.quant_bits, key)
            qscale = torch.cat([qs, torch.ones(1, dtype=torch.float32,
                                               device=dev)])

        def hist(idx, begin, count):
            return leaf_histogram(self.bins, gh, idx, begin, count, BH, prec)

        def in_units(h):
            # a quantized histogram back in gradient units: g and h by
            # their column's scale, the count as it is
            return h * qscale if qscale is not None \
                else h.to(torch.float32)

        if indices is None:
            # ---------- root: contiguous rows, no index slice
            n = self.n
            indices = torch.arange(n, dtype=torch.int32, device=dev)
            root_hist = in_units(hist(None, 0, n))
            root_gh = gh
        else:
            # ---------- root: the bag's rows, gathered
            n = root_count
            root_hist = in_units(hist(indices, 0, n))
            root_gh = gh[indices[:n].long()]
        if qscale is not None:
            # exact integer sums, rounded to f32 once, times the scale
            root_q = root_gh.long().sum(0).cpu().numpy()
            sums = torch.as_tensor(root_q.astype(np.float32),
                                   device=dev) * qscale[:2]
        else:
            sums = root_gh.double().sum(0) if prec == "f64" \
                else root_gh.sum(0)
        root_g, root_h = sums.to(torch.float32).cpu().numpy()
        store = torch.zeros((L, self.num_storage_cols, BH, 3),
                            dtype=torch.float32, device=dev)
        store[0] = root_hist
        # a quantized tree whose leaves all fit the JAX package's smallest
        # padded bucket: there its child histograms are inlined, not taken
        # from a switch, and XLA contracts the larger child's stored copy
        one_bucket = (qscale is not None
                      and 1 << max(n - 1, 0).bit_length()
                      <= int(cfg.tpu_min_pad))

        # ---------- host per-leaf state (f32 values as the reference keeps)
        leaf_sg = np.zeros(L, np.float32)
        leaf_sh = np.zeros(L, np.float32)
        leaf_min = np.full(L, -np.inf, np.float32)
        leaf_max = np.full(L, np.inf, np.float32)
        leaf_value = np.zeros(L, np.float32)
        leaf_begin = np.zeros(L, np.int64)
        leaf_count = np.zeros(L, np.int64)
        leaf_depth = np.zeros(L, np.int64)
        leaf_sg[0], leaf_sh[0], leaf_count[0] = root_g, root_h, n
        best_f = np.full((L, BF_W), -np.inf, np.float32)
        best_i = np.zeros((L, BI_W), np.int64)
        rec_leaf = np.zeros(Lm1, np.int32)
        rec_feat = np.zeros(Lm1, np.int32)
        rec_thr = np.zeros(Lm1, np.int32)
        rec_dl = np.zeros(Lm1, bool)
        rec_lout = np.zeros(Lm1, np.float32)
        rec_rout = np.zeros(Lm1, np.float32)
        rec_lc = np.zeros(Lm1, np.int32)
        rec_rc = np.zeros(Lm1, np.int32)
        rec_gain = np.zeros(Lm1, np.float32)
        rec_iscat = np.zeros(Lm1, bool)
        rec_bits = np.zeros((Lm1, 8), np.int64)
        # CEGB: the features this tree split on, and the coupled
        # penalties left to pay
        cegb = None
        if self._cegb_on:
            used = np.zeros(self.num_features, np.float32)
            cegb = (used, self._cegb_coupled_eff())
        # forced splits: the BFS queue of (leaf, node), node 0 at the root
        forced = self.forced
        queue = [(0, 0)] if forced else []
        qhead = 0

        vf, vi = self._eval_leaves(store[:1], [root_g], [root_h], [n],
                                   [-np.inf], [np.inf], [0], fmask,
                                   root=True, cegb=cegb)
        best_f[0], best_i[0] = vf[0], vi[0]
        if qscale is not None:
            # the JAX program's root search contracts the scale product of
            # the root's g sum into the right side's difference: g_right =
            # fma(sum q_g, scale_g, -g_left)
            best_f[0, BF_RG] = np.float32(
                float(np.float32(root_q[0])) * float(qscale[0])
                - float(best_f[0, BF_LG]))

        s = 0
        while s < L - 1 and (best_f[:, BF_GAIN].max() > 0.0
                             or qhead < len(queue)):
            new_leaf = s + 1
            node = None
            if qhead < len(queue):
                # a forced split ahead of the gain-driven choice
                bl, nid = queue[qhead]
                qhead += 1
                node = forced[nid]
                bf, bi = self._forced_info(
                    store[bl], leaf_sg[bl], leaf_sh[bl],
                    int(leaf_count[bl]), node[0], node[1])
                if min(bi[BI_LC], bi[BI_RC]) < 1:
                    continue            # a child would be empty: skipped
            else:
                bl = int(np.argmax(best_f[:, BF_GAIN]))
                bf, bi = best_f[bl].copy(), best_i[bl]
            f, thr = int(bi[BI_FEAT]), int(bi[BI_THR])
            dleft = bool(bi[BI_DEFLEFT])
            left_cnt_g, right_cnt_g = int(bi[BI_LC]), int(bi[BI_RC])
            begin, count = int(leaf_begin[bl]), int(leaf_count[bl])
            iscat = bool(bi[BI_ISCAT])
            words = bi[BI_CAT0:BI_CAT0 + 8]
            # the split feature's storage column, unpacked under bundling
            left_cnt = split_partition(
                indices, self.bins_T[int(self.bcol[f])], begin, count, thr,
                dleft, int(mt[f]), int(db[f]), int(nb[f]),
                torch.as_tensor(words, device=dev) if iscat else None,
                int(self.boff[f]), int(self.bpk[f]))
            right_cnt = count - left_cnt
            rec_iscat[s] = iscat
            rec_bits[s] = words

            rec_leaf[s], rec_feat[s], rec_thr[s] = bl, f, thr
            rec_dl[s] = dleft
            rec_lout[s], rec_rout[s] = bf[BF_LOUT], bf[BF_ROUT]
            rec_gain[s] = bf[BF_GAIN]
            rec_lc[s], rec_rc[s] = left_cnt_g, right_cnt_g

            depth = int(leaf_depth[bl]) + 1
            lmin = rmin = leaf_min[bl]
            lmax = rmax = leaf_max[bl]
            if self._mono_any and mono[f] != 0:
                mid = (bf[BF_LOUT] + bf[BF_ROUT]) / np.float32(2.0)
                if mono[f] > 0:
                    lmax, rmin = min(lmax, mid), max(rmin, mid)
                else:
                    lmin, rmax = max(lmin, mid), min(rmax, mid)
            leaf_sg[bl], leaf_sh[bl] = bf[BF_LG], bf[BF_LH]
            leaf_sg[new_leaf], leaf_sh[new_leaf] = bf[BF_RG], bf[BF_RH]
            leaf_min[bl], leaf_max[bl] = lmin, lmax
            leaf_min[new_leaf], leaf_max[new_leaf] = rmin, rmax
            leaf_value[bl], leaf_value[new_leaf] = bf[BF_LOUT], bf[BF_ROUT]
            leaf_begin[new_leaf] = begin + left_cnt
            leaf_count[bl], leaf_count[new_leaf] = left_cnt, right_cnt
            leaf_depth[bl] = leaf_depth[new_leaf] = depth

            # histogram the smaller child; larger = parent - smaller
            smaller_is_left = left_cnt_g <= right_cnt_g
            sm_begin = begin if smaller_is_left else begin + left_cnt
            sm_count = left_cnt if smaller_is_left else right_cnt
            raw = hist(indices, sm_begin, sm_count)
            sm_hist = in_units(raw)
            lg_hist = lg_store = subtract_histogram(store[bl], sm_hist)
            if one_bucket:
                # the JAX program stores the larger child with the scale
                # product contracted into the difference, and searches it
                # uncontracted
                lg_store = fma_f32(-raw, qscale, store[bl])
            left_hist, right_hist = ((sm_hist, lg_hist) if smaller_is_left
                                     else (lg_hist, sm_hist))
            store[bl] = sm_hist if smaller_is_left else lg_store
            store[new_leaf] = lg_store if smaller_is_left else sm_hist
            if cegb is not None:
                used[f] = 1.0           # its coupled penalty is paid

            vf, vi = self._eval_leaves(
                torch.stack([left_hist, right_hist]),
                [bf[BF_LG], bf[BF_RG]], [bf[BF_LH], bf[BF_RH]],
                [left_cnt_g, right_cnt_g], [lmin, rmin], [lmax, rmax],
                [depth, depth], fmask, cegb=cegb)
            best_f[bl], best_i[bl] = vf[0], vi[0]
            best_f[new_leaf], best_i[new_leaf] = vf[1], vi[1]
            if node is not None:
                # the node's children, left then right: the left child
                # keeps leaf bl, the right child is the new leaf
                if node[2] >= 0:
                    queue.append((bl, node[2]))
                if node[3] >= 0:
                    queue.append((new_leaf, node[3]))
            s += 1

        record = TreeRecord(
            num_splits=s, leaf=rec_leaf, feature=rec_feat,
            threshold_bin=rec_thr, default_left=rec_dl,
            left_output=rec_lout, right_output=rec_rout,
            left_count=rec_lc, right_count=rec_rc, gain=rec_gain,
            leaf_value=leaf_value,
            leaf_begin=leaf_begin.astype(np.int32),
            leaf_count=leaf_count.astype(np.int32),
            is_cat=rec_iscat, cat_bitset=rec_bits)
        self._cegb_note_record(record)
        return indices, record

    # ------------------------------------------------------------------
    def add_score_from_partition(self, score: torch.Tensor, class_id: int,
                                 record: TreeRecord, indices: torch.Tensor,
                                 scale: float) -> None:
        """score[class_id] += scale * tree(x) from the final partition:
        each leaf's rows are contiguous in `indices`, so the per-position
        value is a difference-array fill, scattered back to row order
        (reference `_partition_score_update`, device_learner.py:1643).
        A level-built record scores through its physical blocks and their
        covering values (`leaf_value_fill` skips empty blocks). The
        multiply-add is fused, as XLA fuses it."""
        dev = self.device
        if record.block_begin is not None:
            begin, count, value = (record.block_begin, record.block_cnt,
                                   record.block_value)
        else:
            begin, count, value = (record.leaf_begin, record.leaf_count,
                                   record.leaf_value)
        fill = leaf_value_fill(torch.as_tensor(begin, device=dev),
                               torch.as_tensor(count, device=dev),
                               torch.as_tensor(value, device=dev), self.n)
        delta = unpermute_to_rows(indices, fill, self.n)
        score[class_id] = fma_f32(delta, float(np.float32(scale)),
                                  score[class_id])

    def add_record_score(self, score_row: torch.Tensor, bins: torch.Tensor,
                         record: TreeRecord, scale: float) -> None:
        """score_row += scale * tree(x) over a binned matrix (a validation
        set, or the training bins after a bagged tree, whose partition
        misses the out-of-bag rows), by traversal of the record's tree."""
        leaves = traverse_record(bins, record, self.meta, self.ds.bundles)
        lv = torch.as_tensor(record.leaf_value, device=bins.device)
        score_row.copy_(fma_f32(lv[leaves], float(np.float32(scale)),
                                score_row))

    def record_to_tree(self, rec: TreeRecord, shrinkage: float = 1.0
                       ) -> Tree:
        """Host conversion of a TreeRecord into a full Tree (bin thresholds
        -> real values via the BinMappers)."""
        tree = Tree(self.cfg.num_leaves)
        mt_code = {"none": 0, "zero": 1, "nan": 2}
        for s in range(int(rec.num_splits)):
            f = int(rec.feature[s])
            mapper = self.mappers[f]
            if rec.is_cat[s]:
                # bins below min(num_bin, 256) whose bit is set; their
                # categories where the bin holds one (JAX package:
                # device_learner.py:1611-1625)
                words = rec.cat_bitset[s]
                bins_list = [b for b in range(min(mapper.num_bin, 256))
                             if (int(words[b // 32]) >> (b % 32)) & 1]
                cats = [mapper.bin_2_categorical[b] for b in bins_list
                        if b < len(mapper.bin_2_categorical)]
                tree.split_categorical(
                    int(rec.leaf[s]), f, int(self.ds.real_feature_idx[f]),
                    bins_list, cats, float(rec.left_output[s]),
                    float(rec.right_output[s]), int(rec.left_count[s]),
                    int(rec.right_count[s]), float(rec.gain[s]),
                    mt_code[mapper.missing_type],
                    default_bin=mapper.default_bin, num_bin=mapper.num_bin)
                continue
            thr_bin = int(rec.threshold_bin[s])
            tree.split(
                int(rec.leaf[s]), f, int(self.ds.real_feature_idx[f]),
                thr_bin, mapper.bin_to_value(thr_bin),
                float(rec.left_output[s]), float(rec.right_output[s]),
                int(rec.left_count[s]), int(rec.right_count[s]),
                float(rec.gain[s]), mt_code[mapper.missing_type],
                bool(rec.default_left[s]),
                default_bin=mapper.default_bin, num_bin=mapper.num_bin)
        if shrinkage != 1.0:
            tree.apply_shrinkage(shrinkage)
        return tree

    # ------------------------------------------------------------------
    def aligned_mode_gate(self, objective) -> Optional[str]:
        """First failing gate of the aligned engine
        (`models/aligned_builder.py`) as a short reason, or None when it
        can run (JAX package: `aligned_mode_gate`). The gates of the JAX
        package that decide its path are kept, so both packages choose
        the same one; the parts of the engine this port leaves out are
        gates of their own."""
        from ..ops.aligned import aligned_num_chunks
        from .level_builder import spec_slots
        cfg = self.cfg
        if cfg.tpu_grow_mode not in ("auto", "aligned"):
            return f"tpu_grow_mode={cfg.tpu_grow_mode}"
        if cfg.sequential_device_only:
            # forced splits and CEGB need the sequential leaf-wise loop
            return "sequential-only features (forced splits/CEGB)"
        if (str(cfg.tpu_quant_hist).strip().lower() == "on"
                and self.quant_bits > 0):
            # the quantized histograms live on the leaf-wise builder
            return "tpu_quant_hist=on (quantized hist rides the fused path)"
        if not (cfg.tpu_aligned_interpret or self.device.type == "cuda"):
            return "CUDA kernels unavailable (CPU device, " \
                "tpu_aligned_interpret off)"
        if cfg.tree_learner != "serial":
            return f"tree_learner={cfg.tree_learner} (data-parallel " \
                "aligned engine not ported)"
        if objective is None:
            return "no objective"
        S = spec_slots(cfg.num_leaves, float(cfg.tpu_level_spec))
        nc = aligned_num_chunks(self.n, cfg, S, self.num_features)
        if nc > 65535:
            return f"chunk count {nc} > 65535"
        if self.num_features > 1020:
            return f"num_features {self.num_features} > 1020"
        if self.bins.dtype != torch.uint8:
            return "bins not uint8"
        if self.num_features <= 0:
            return "no features"
        if cfg.num_leaves < 2:
            return "num_leaves < 2"
        if self.max_bin_global > 256 or self.hist_bins > 256:
            return "max_bin > 256"
        if objective.num_model_per_iteration != 1:
            # K score lanes and the class in the COMPACT meta lane: its
            # 7 label bits and 24 rid bits bound K and n
            if objective.num_model_per_iteration > 127:
                return "num_class > 127"
            if objective.mc_lane_mode() is None:
                return "objective lacks a multiclass lane mode"
            if self.n > (1 << 24):
                return "multiclass above 2^24 rows"
        # an objective whose gradients are not pointwise (ranking) pays a
        # row-order gradient round trip each iteration (EXT records); the
        # JAX package takes the engine for it from 1M rows, or when forced
        if not (objective.point_grad_fn() is not None
                or objective.num_model_per_iteration > 1
                or self.n >= NON_POINTWISE_ROW_FLOOR
                or cfg.tpu_grow_mode == "aligned"):
            return ("non-pointwise objective below the row floor "
                    f"({self.n} < {NON_POINTWISE_ROW_FLOOR} rows)")
        return None

    def aligned_mode_ok(self, objective) -> bool:
        return self.aligned_mode_gate(objective) is None

    # ------------------------------------------------------------------
    def level_mode_ok(self) -> bool:
        """True when the level builder (`level_builder.py`) grows this
        learner's unbagged trees (JAX package: `level_mode_ok`, serial
        only): the grow mode asks for it, the bins are uint8, and there is
        a feature and a split to make, no forced split or CEGB penalty
        needs the sequential loop, and the bins are not bundled (its
        packed words hold feature bins; bundled trees grow leaf-wise, as
        in the JAX package). A bagged iteration grows
        leaf-wise (`train`: the level records assume a full fresh root); a
        K-class iteration grows its trees here one by one; data-parallel
        training raises before a learner is built."""
        return (self.cfg.tpu_grow_mode == "level"
                and not self.cfg.sequential_device_only
                and not self.bundled
                and self.bins.dtype == torch.uint8
                and self.num_features > 0
                and self.cfg.num_leaves >= 2)

    @property
    def words_dev(self) -> torch.Tensor:
        """Packed bin words [ceil(F/4), N] int32 for the level builder,
        made on the device at first use."""
        if self._words is None:
            from .level_builder import pack_bin_words
            self._words = pack_bin_words(self.bins)
        return self._words

    def _level_train_fresh(self, grad: torch.Tensor, hess: torch.Tensor,
                           feature_mask: Optional[np.ndarray] = None):
        """Speculative level build + host leaf-wise replay: (row ids by
        position [N] int32, TreeRecord with the block tables), or None
        when speculation was too shallow for an exact replay (counted in
        ``level_fallbacks``; the caller then grows the tree leaf-wise).
        The build function is made per call, so nothing on the learner
        refers back to it."""
        from .level_builder import make_level_build_fn, replay_leafwise
        spec = make_level_build_fn(self)(self.words_dev, grad, hess,
                                         self.fmask_tensor(feature_mask))
        rec, exact = replay_leafwise(spec, self.cfg.num_leaves)
        self.level_last = (spec.rounds, spec.n_exec, exact)
        if not exact:
            self.level_fallbacks += 1
            return None
        return spec.rid, rec

    def aligned_engine(self, objective, init_row_scores=None,
                       bagged: bool = False, num_class: int = 1):
        """A new AlignedEngine over this learner's data (``bagged``: with
        a bag lane; ``num_class`` score lanes). The caller keeps it: the
        engine refers to the learner, and a reference back from the
        learner would hold its device buffers until the next cyclic
        garbage collection."""
        from .aligned_builder import AlignedEngine
        return AlignedEngine(self, objective, init_row_scores=init_row_scores,
                             bagged=bagged, num_class=num_class)


def traverse_record(bins: torch.Tensor, rec: TreeRecord, meta,
                    bundles=None) -> torch.Tensor:
    """[N] leaf index per row of one record's tree over binned data
    (reference `traverse_record`, device_learner.py:1693); ``bundles``
    (a `BundleInfo`) maps features to bundled storage columns."""
    ns = int(rec.num_splits)
    if ns == 0:
        return torch.zeros(bins.shape[0], dtype=torch.int64,
                           device=bins.device)
    left, right = record_to_children(rec.leaf, ns)
    feat = rec.feature[:ns].astype(np.int64)
    return _walk_binned(bins, left, right, feat,
                        rec.threshold_bin[:ns].astype(np.int32),
                        rec.default_left[:ns], meta["missing_type"][feat],
                        meta["default_bin"][feat], meta["num_bin"][feat],
                        rec.is_cat[:ns],
                        np.asarray(rec.cat_bitset[:ns], np.int64),
                        _node_bundles(bundles, feat))


def traverse_tree(bins: torch.Tensor, tree: Tree,
                  bundles=None) -> torch.Tensor:
    """[N] leaf index per row of a host `Tree` over binned data, from its
    bin thresholds and per-node bin metadata (JAX package:
    `TreePredictor.predict_binned_leaves`, bundled storage unpacked as its
    `_predict_binned_stacked` does); a leaf's index is the one its value
    has in ``tree.leaf_value``."""
    ns = tree.num_leaves - 1
    if ns <= 0:
        return torch.zeros(bins.shape[0], dtype=torch.int64,
                           device=bins.device)
    dt = tree.decision_type[:ns].astype(np.int64)
    is_cat = (dt & 1) != 0
    bits = np.zeros((ns, 8), np.int64)
    cb, words = tree.cat_boundaries_inner, tree.cat_threshold_inner
    for s in np.nonzero(is_cat)[0]:
        c = int(tree.threshold_in_bin[s])
        w = words[cb[c]:cb[c + 1]][:8]
        bits[s, :len(w)] = w
    feat = tree.split_feature_inner[:ns].astype(np.int64)
    return _walk_binned(bins, tree.left_child[:ns], tree.right_child[:ns],
                        feat, tree.threshold_in_bin[:ns].astype(np.int32),
                        (dt & 2) != 0, (dt >> 2) & 3,
                        tree.node_default_bin[:ns], tree.node_num_bin[:ns],
                        is_cat, bits, _node_bundles(bundles, feat))


def _node_bundles(bundles, feat: np.ndarray):
    """(storage column, offset, packed) of each node's feature, or None
    for unbundled bins."""
    if bundles is None:
        return None
    return (bundles.col[feat].astype(np.int64),
            bundles.off[feat].astype(np.int64),
            bundles.packed[feat].astype(np.int64))


def _walk_binned(bins, left, right, feat, thr, default_left, missing_type,
                 default_bin, num_bin, is_cat, cat_bits,
                 node_bundle=None) -> torch.Tensor:
    """[N] leaf index per row of the tree whose nodes (split order,
    parents first) the per-node host arrays describe; ``left``/``right``
    hold a child node or ``~leaf``; ``node_bundle`` (`_node_bundles`)
    reads each node's storage column and unpacks it."""
    n = bins.shape[0]
    dev = bins.device
    ns = len(feat)
    depth = np.zeros(ns, np.int64)
    for s in range(ns):          # parents precede children in split order
        for c in (left[s], right[s]):
            if c >= 0:
                depth[c] = depth[s] + 1

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    f_t, thr_t = t(feat), t(thr)
    dl_t = t(np.asarray(default_left, bool))
    mt_t = t(np.asarray(missing_type, np.int64))
    db_t = t(np.asarray(default_bin, np.int64))
    nb_t = t(np.asarray(num_bin, np.int64))
    l_t, r_t = t(np.asarray(left, np.int64)), t(np.asarray(right, np.int64))
    has_cat = bool(np.any(is_cat))
    if has_cat:
        cat_t = t(np.asarray(is_cat, bool))
        bits_t = t(cat_bits)                                      # [ns, 8]
    if node_bundle is not None:
        col_t, off_t, pk_t = (t(a) for a in node_bundle)
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(int(depth.max()) + 1):
        safe = node.clamp(min=0)
        if node_bundle is None:
            fval = bins[rows, f_t[safe]].to(torch.int32)
        else:
            fval = bundle_unpack(bins[rows, col_t[safe]].to(torch.int64),
                                 off_t[safe], pk_t[safe], db_t[safe],
                                 nb_t[safe]).to(torch.int32)
        base = fval <= thr_t[safe]
        m = mt_t[safe]
        is_default = torch.where(m == MISSING_ZERO_C, fval == db_t[safe],
                                 (m == MISSING_NAN_C)
                                 & (fval == nb_t[safe] - 1))
        goes_left = torch.where(is_default, dl_t[safe], base)
        if has_cat:
            # a categorical node routes by its bitset over bins alone
            goes_left = torch.where(
                cat_t[safe], categorical_goes_left(fval, bits_t[safe]),
                goes_left)
        nxt = torch.where(goes_left, l_t[safe], r_t[safe])
        node = torch.where(node >= 0, nxt, node)
    return ~node

