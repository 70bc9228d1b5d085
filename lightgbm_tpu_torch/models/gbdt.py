"""GBDT boosting driver (port of lightgbm_tpu/models/gbdt.py, plain GBDT).

The reference `GBDT` (`src/boosting/gbdt.cpp`): per-iteration gradients
from the objective, boost-from-average with the bias folded into the
first tree (`gbdt.cpp:343-412`), one tree per iteration, shrinkage,
train and valid score updates, and the batched trailing empty-tree trim.
Scores live on the device as ``[K, N]`` f32; metrics pull them to the
host once per eval.

A tree grows on the aligned engine (`aligned_builder.py`) when its gates
pass, else leaf-wise. For a non-pointwise objective (lambdarank) each
aligned iteration reads the engine's row-order scores on the device and
hands the objective's gradients to the engine. The aligned engine keeps
the training scores in a lane of its permuted records; ``train_score``
is synced from it lazily.
An aligned tree whose replay is not exact is not applied: that iteration
grows an exact leaf-wise tree instead. The JAX package pipelines its
aligned rounds to hide XLA's dispatch round trip; the port runs them
synchronously and knows each tree's exactness when the tree ends.

Under ``tpu_grow_mode=level`` a tree grows on the speculative level
builder (`level_builder.py`) from the objective's row-order gradients,
and an inexact replay grows that tree leaf-wise, as in the JAX package
(`device_learner.train_fresh`).

Bagging, GOSS, DART, RF and multiclass are later slices and raise here.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..ops.metrics import Metric, create_metrics
from ..ops.objectives import create_objective
from ..utils import log
from .aligned_builder import replay_spec
from .device_learner import DeviceTreeLearner
from .tree import Tree

K_EPSILON = 1e-15


class _ScoreUpdater:
    """Per-dataset raw scores on the device (reference ScoreUpdater,
    score_updater.hpp:27-85)."""

    def __init__(self, num_data: int, num_class: int,
                 init_score: Optional[np.ndarray],
                 device: torch.device) -> None:
        self.has_init_score = init_score is not None
        if init_score is not None:
            arr = np.asarray(init_score, np.float64).reshape(
                num_class, num_data).astype(np.float32)
            self.score = torch.as_tensor(arr, device=device)
        else:
            self.score = torch.zeros((num_class, num_data),
                                     dtype=torch.float32, device=device)

    def add_constant(self, val: float, class_id: int) -> None:
        self.score[class_id] += torch.tensor(val, dtype=torch.float32,
                                             device=self.score.device)

    def numpy(self) -> np.ndarray:
        return self.score.cpu().numpy().astype(np.float64)


def _check_supported(cfg: Config) -> None:
    if cfg.boosting != "gbdt":
        raise NotImplementedError(f"boosting={cfg.boosting!r} is not ported "
                                  "yet (plain gbdt only)")
    if cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                 or cfg.pos_bagging_fraction < 1.0
                                 or cfg.neg_bagging_fraction < 1.0):
        raise NotImplementedError("bagging is not ported yet")
    if cfg.num_tree_per_iteration != 1:
        raise NotImplementedError("multiclass is not ported yet")
    if cfg.tree_learner != "serial":
        raise NotImplementedError("distributed tree learners are not "
                                  "ported yet")
    if cfg.tpu_quant_hist.strip().lower() == "on":
        raise NotImplementedError("tpu_quant_hist=on: quantized histograms "
                                  "are not ported yet (ROADMAP A.2)")


class GBDT:
    """reference `GBDT` (gbdt.h:41+), single-class, no bagging."""

    def __init__(self, cfg: Config, train_data: Dataset,
                 device: torch.device) -> None:
        from ..utils.log import set_verbosity
        set_verbosity(int(cfg.verbosity))
        _check_supported(cfg)
        self.cfg = cfg
        self.device = device
        self.train_data = train_data
        self.num_data = train_data.num_data
        self.objective = create_objective(cfg)
        if self.objective is None:
            raise NotImplementedError("custom objectives (objective=none) "
                                      "are not ported yet")
        self.objective.init(train_data.metadata, self.num_data, device)
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = cfg.learning_rate
        self.models: List[Tree] = []
        self.iter = 0
        self.learner = DeviceTreeLearner(cfg, train_data, device)
        self.train_score = _ScoreUpdater(self.num_data, 1,
                                         train_data.metadata.init_score,
                                         device)
        self.valid_sets: List[Dataset] = []
        self.valid_scores: List[_ScoreUpdater] = []
        self.valid_metrics: List[List[Metric]] = []
        self.train_metrics: List[Metric] = create_metrics(cfg)
        for m in self.train_metrics:
            m.init(train_data.metadata, self.num_data)
        self._pending_numsplits: List[int] = []
        self.train_path: Optional[str] = None
        # (rounds, executed splits, exact) of every aligned / level tree
        self.aligned_stats: List[Tuple[int, int, bool]] = []
        self.level_stats: List[Tuple[int, int, bool]] = []
        self._aligned_eng = None
        self._train_score_stale = False
        if cfg.tpu_grow_mode == "aligned":
            why = self.learner.aligned_mode_gate(self.objective)
            if why is not None:
                raise NotImplementedError(
                    f"tpu_grow_mode=aligned, but the aligned engine cannot "
                    f"run: {why}")

    # ------------------------------------------------------------------
    def add_valid_dataset(self, ds: Dataset) -> None:
        """reference GBDT::AddValidDataset (gbdt.cpp:119-147)."""
        if self.models:
            raise NotImplementedError("adding a validation set after "
                                      "training began is not ported yet")
        self.valid_sets.append(ds)
        self.valid_scores.append(_ScoreUpdater(
            ds.num_data, 1, ds.metadata.init_score, self.device))
        ms = create_metrics(self.cfg)
        for m in ms:
            m.init(ds.metadata, ds.num_data)
        self.valid_metrics.append(ms)

    def boost_from_average(self, class_id: int) -> float:
        """reference GBDT::BoostFromAverage (gbdt.cpp:342-365)."""
        if (not self.models and not self.train_score.has_init_score
                and self.cfg.boost_from_average):
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self.train_score.add_constant(init_score, class_id)
                for su in self.valid_scores:
                    su.add_constant(init_score, class_id)
                return init_score
        return 0.0

    # ------------------------------------------------------------------
    def train_one_iter(self) -> bool:
        """reference GBDT::TrainOneIter (gbdt.cpp:367-448) along the JAX
        package's fused path (`_train_one_iter_fused`, gbdt.py:1518).
        Returns True when training should stop."""
        init_score = self.boost_from_average(0)
        fmask = self.learner.feature_mask()
        if not self.objective.need_train or \
                self.train_data.num_features == 0:
            self._append_constant_tree(0, init_score)
            if len(self.models) > 1:
                del self.models[-1]
            return True
        if self._aligned_eligible():
            self._log_train_path("aligned")
            return self._train_one_iter_aligned(init_score, fmask)
        if self.learner.level_mode_ok():
            self._log_train_path("level")
            return self._train_one_iter_level(init_score, fmask)
        self._log_train_path("leafwise")
        return self._train_one_iter_leafwise(init_score, fmask)

    def _train_one_iter_leafwise(self, init_score: float, fmask) -> bool:
        self._sync_train_score()
        g, h = self.objective.get_gradients(self.train_score.score)
        indices, rec = self.learner.train_fresh(g[0], h[0], fmask)
        self.learner.add_score_from_partition(
            self.train_score.score, 0, rec, indices, self.shrinkage_rate)
        return self._append_tree(rec, init_score)

    def _train_one_iter_level(self, init_score: float, fmask) -> bool:
        """One tree on the level builder; an inexact replay grows it
        leaf-wise on the same gradients."""
        lr = self.learner
        g, h = self.objective.get_gradients(self.train_score.score)
        out = lr._level_train_fresh(g[0], h[0], fmask)
        self.level_stats.append(lr.level_last)
        if out is None:
            log.info(f"level: inexact replay in iteration {self.iter} "
                     f"(fallback {lr.level_fallbacks}); growing it "
                     "leaf-wise")
            out = lr.train_fresh(g[0], h[0], fmask)
        rid, rec = out
        lr.add_score_from_partition(self.train_score.score, 0, rec, rid,
                                    self.shrinkage_rate)
        return self._append_tree(rec, init_score)

    def _append_tree(self, rec, init_score: float) -> bool:
        """Append one grown tree, add it to the validation scores, and
        run the batched empty-tree check."""
        tree = self.learner.record_to_tree(rec, self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.models.append(tree)
        for ds, su in zip(self.valid_sets, self.valid_scores):
            self.learner.add_record_score(su.score[0], ds.bins, rec,
                                          self.shrinkage_rate)
        self._pending_numsplits.append(int(rec.num_splits))
        self.iter += 1
        if len(self._pending_numsplits) >= 16:
            return self._trim_trailing_empty()
        return False

    # ------------------------------------------------------------------
    def _aligned_eligible(self) -> bool:
        """The aligned engine takes the iteration: single class, a
        trainable objective and every learner gate passing (JAX package:
        `_aligned_eligible`)."""
        return (self.num_tree_per_iteration == 1
                and self.objective.need_train
                and self.train_data.num_features > 0
                and self.learner.aligned_mode_ok(self.objective))

    def _log_train_path(self, path: str) -> None:
        """One INFO line naming the training path; when the aligned engine
        was not chosen, with its first failing gate."""
        if self.train_path == path:
            return
        self.train_path = path
        msg = f"training path: {path}"
        if path == "leafwise":
            why = self.learner.aligned_mode_gate(self.objective)
            msg += f" (aligned engine rejected: {why})"
        log.info(msg)

    def _train_one_iter_aligned(self, init_score: float, fmask) -> bool:
        """One tree on the aligned engine. An exact build has already
        updated the engine's score lane; an inexact one left it untouched
        and the iteration grows an exact leaf-wise tree instead."""
        eng = self._aligned_eng
        if eng is None:
            eng = self._aligned_eng = self.learner.aligned_engine(
                self.objective, init_row_scores=self.train_score.score[0])
        grads = None
        if eng.ext:
            # ranking: gradients in row order from the engine's scores,
            # gathered back into the records by rid (all on the device)
            g, h = self.objective.get_gradients(eng.row_scores()[None, :])
            grads = (g[0], h[0])
        spec, exact = eng.train_iter(self.shrinkage_rate, fmask, grads)
        self.aligned_stats.append((spec.rounds, spec.n_exec, exact))
        if not exact:
            eng.fallbacks += 1
            log.info(f"aligned: inexact replay in iteration {self.iter} "
                     f"(fallback {eng.fallbacks}); growing it leaf-wise")
            stop = self._train_one_iter_leafwise(init_score, fmask)
            eng.set_row_scores(self.train_score.score[0])
            return stop
        rec = replay_spec(spec, self.cfg.num_leaves)
        self._train_score_stale = True
        return self._append_tree(rec, init_score)

    def _sync_train_score(self) -> None:
        """Row-order training scores from the aligned engine's lane."""
        if self._train_score_stale:
            self.train_score.score[0] = self._aligned_eng.row_scores()
            self._train_score_stale = False

    def _append_constant_tree(self, k: int, init_score: float) -> Tree:
        """Constant tree carrying the init score (gbdt.cpp:413-433)."""
        t = Tree(2)
        if not self.models:
            output = (self.objective.boost_from_score(k)
                      if not self.objective.need_train else init_score)
            t.as_constant_tree(output)
            if abs(output) > K_EPSILON:
                self.train_score.add_constant(output, k)
                for su in self.valid_scores:
                    su.add_constant(output, k)
        self.models.append(t)
        return t

    def _trim_trailing_empty(self) -> bool:
        """Deferred empty-tree check (gbdt.cpp:436-444, batched as in the
        JAX package's fused path, gbdt.py:1499)."""
        ns = self._pending_numsplits
        self._pending_numsplits = []
        empty_trailing = 0
        for x in reversed(ns):
            if x != 0:
                break
            empty_trailing += 1
        if empty_trailing and len(self.models) > 1:
            drop = min(empty_trailing, len(self.models) - 1)
            del self.models[-drop:]
            self.iter -= drop
            return True
        return False

    # ------------------------------------------------------------------
    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        self._sync_train_score()
        return self._eval(self.train_score, self.train_metrics, "training")

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for i, (su, ms) in enumerate(zip(self.valid_scores,
                                         self.valid_metrics)):
            out.extend(self._eval(su, ms, f"valid_{i}"))
        return out

    def _eval(self, su, metrics: List[Metric],
              name: str) -> List[Tuple[str, str, float, bool]]:
        if not metrics:
            return []
        scores = su.numpy()
        return [(name, mname, float(val), m.bigger_is_better)
                for m in metrics for mname, val in m.eval(scores,
                                                          self.objective)]
