"""GBDT boosting loop (port of lightgbm_tpu/models/gbdt.py).

The reference `GBDT` (`src/boosting/gbdt.cpp`): per-iteration gradients
from the objective, boost-from-average with the bias folded into the
first tree (`gbdt.cpp:343-412`), one tree per class and iteration (K
for a K-class objective, from gradients computed once,
`gbdt.cpp:415-444`), shrinkage, train and valid score updates, and the
batched trailing empty-tree trim over whole iterations. Scores live on
the device as ``[K, N]`` f32; metrics pull them to the host once per
eval, or evaluate them there (AUC).

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
A K-class iteration on the aligned engine (`_train_one_iter_aligned_mc`)
writes the softmax probability lanes once from the pre-iteration
scores, keeps a copy of the K score lanes, and builds the K class trees
in turn, each added to its score lane when it ends; an inexact class
restores the copy and grows the whole iteration leaf-wise on the same
bag and feature masks (the JAX package's `_aligned_mc_fallback`).

An objective that renews its leaf outputs (regression_l1, quantile,
mape) and the lazy CEGB penalty train on the host `SerialTreeLearner`
(`serial_learner.py`), as in the JAX package (gbdt.py:155-201): a tree a
class from the iteration's gradients, its leaves renewed from the scores
before the tree, then shrunk, scored by traversal and given the bias
(`_train_one_iter_host`, gbdt.py:755-790). Custom gradients
(``train_one_iter(grad, hess)``, ``objective=none``) grow leaf-wise.

Under ``tpu_grow_mode=level`` a tree grows on the speculative level
builder (`level_builder.py`) from the objective's row-order gradients,
and an inexact replay grows that tree leaf-wise, as in the JAX package
(`device_learner.train_fresh`).

Bagging (`_bagging`, plain and pos/neg balanced, gbdt.cpp:159-275) draws
the JAX package's bag with the same numpy RNG calls in the same order.
On the aligned engine the bag is a mask in the records (`_maybe_rebag` ->
`AlignedEngine.set_bag`); elsewhere a bagged tree grows leaf-wise from
the bag's rows (`DeviceTreeLearner.train`) and scores every row by
traversal, and a bagged iteration under ``tpu_grow_mode=level`` grows
leaf-wise too. GOSS, DART and RF (`boosting_variants.py`) change the
hooks `get_training_score`, `_bagging` and `_post_bagging_gradients`, or
the iteration itself; the aligned engine takes an iteration only where
the class keeps the first two hooks, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..ops.metrics import Metric, create_metrics
from ..ops.objectives import create_objective
from ..ops.predict import predict_binned_leaves
from ..utils import log
from .aligned_builder import replay_spec
from .device_learner import DeviceTreeLearner, traverse_tree
from .serial_learner import SerialTreeLearner
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

    def multiply_score(self, factor: float, class_id: int) -> None:
        """reference ScoreUpdater::MultiplyScore (RF's running average),
        an f32 product."""
        self.score[class_id] *= torch.tensor(factor, dtype=torch.float32,
                                             device=self.score.device)

    def add_tree_by_leaves(self, leaves: torch.Tensor,
                           leaf_values: np.ndarray, class_id: int) -> None:
        """score[class_id] += the f32 leaf values (host array) of each
        row's leaf ``leaves`` [N]."""
        lv = torch.as_tensor(np.asarray(leaf_values, np.float32),
                             device=self.score.device)
        self.score[class_id] += lv[leaves]

    def numpy(self) -> np.ndarray:
        return self.score.cpu().numpy().astype(np.float64)


def _check_supported(cfg: Config) -> None:
    if cfg.tree_learner != "serial":
        raise NotImplementedError("distributed tree learners are not "
                                  "ported yet")


class GBDT:
    """reference `GBDT` (gbdt.h:41+)."""

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
        if self.objective is not None:
            self.objective.init(train_data.metadata, self.num_data, device)
            self.num_tree_per_iteration = \
                self.objective.num_model_per_iteration
        else:
            # custom gradients (objective=none): K from num_class
            self.num_tree_per_iteration = max(1, cfg.num_class)
        self.shrinkage_rate = cfg.learning_rate
        self.models: List[Tree] = []
        self.iter = 0
        # the host learner for leaf renewal and the lazy CEGB penalty
        self.use_host = bool(
            getattr(self.objective, "is_renew_tree_output", False)
            or cfg.forces_host_learner)
        self.learner = (SerialTreeLearner if self.use_host
                        else DeviceTreeLearner)(cfg, train_data, device)
        self.train_score = _ScoreUpdater(self.num_data,
                                         self.num_tree_per_iteration,
                                         train_data.metadata.init_score,
                                         device)
        self.valid_sets: List[Dataset] = []
        self.valid_scores: List[_ScoreUpdater] = []
        self.valid_metrics: List[List[Metric]] = []
        self.train_metrics: List[Metric] = create_metrics(cfg)
        for m in self.train_metrics:
            m.init(train_data.metadata, self.num_data)
        self._bag_rng = np.random.RandomState(cfg.bagging_seed)
        # the bag: sorted row ids, int32 on the device, and its [N] bool
        # mask there too
        self.bag_data_indices: Optional[torch.Tensor] = None
        self.bag_data_cnt = self.num_data
        self._bag_mask: Optional[torch.Tensor] = None
        self._label_np = (np.asarray(train_data.metadata.label, np.float64)
                          if train_data.metadata.label is not None
                          else np.zeros(self.num_data))
        self._weight_np = (np.asarray(train_data.metadata.weight, np.float64)
                           if train_data.metadata.weight is not None
                           else None)
        self._need_train = (self.objective is None
                            or self.objective.need_train)
        self._balanced_bagging = (
            cfg.objective == "binary"
            and (cfg.pos_bagging_fraction < 1.0
                 or cfg.neg_bagging_fraction < 1.0))
        self._pending_numsplits: List[int] = []
        self.train_path: Optional[str] = None
        # (rounds, executed splits, exact) of every aligned / level tree
        self.aligned_stats: List[Tuple[int, int, bool]] = []
        self.level_stats: List[Tuple[int, int, bool]] = []
        self._aligned_eng = None
        # set for good by `drop_aligned` (JAX package: _aligned_disabled)
        self._aligned_disabled = False
        self._train_score_stale = False
        if cfg.tpu_grow_mode == "aligned" and not self.use_host:
            why = self.learner.aligned_mode_gate(self.objective)
            if why is not None:
                raise NotImplementedError(
                    f"tpu_grow_mode=aligned, but the aligned engine cannot "
                    f"run: {why}")

    # ------------------------------------------------------------------
    def add_valid_dataset(self, ds: Dataset) -> None:
        """reference GBDT::AddValidDataset (gbdt.cpp:119-147). Where the
        model has trees already (continued training, or a set added after
        training), they are replayed onto the set's scores by its bins,
        tree i on class i % K, each an f32 add of its leaf values (JAX
        package: gbdt.py:316-324); not where the set's init scores are
        that model's raw predictions already (the CLI's ``input_model``,
        ROADMAP C.34)."""
        su = _ScoreUpdater(ds.num_data, self.num_tree_per_iteration,
                           ds.metadata.init_score, self.device)
        if self.models and not ds.init_score_from_model:
            leaves = predict_binned_leaves(self.models, ds.bins, ds.bundles)
            for i, tree in enumerate(self.models):
                su.add_tree_by_leaves(leaves[i],
                                      tree.leaf_value[:tree.num_leaves],
                                      i % self.num_tree_per_iteration)
        self.valid_sets.append(ds)
        self.valid_scores.append(su)
        ms = create_metrics(self.cfg)
        for m in ms:
            m.init(ds.metadata, ds.num_data)
        self.valid_metrics.append(ms)

    def boost_from_average(self, class_id: int) -> float:
        """reference GBDT::BoostFromAverage (gbdt.cpp:342-365)."""
        if (not self.models and not self.train_score.has_init_score
                and self.objective is not None
                and self.cfg.boost_from_average):
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self.train_score.add_constant(init_score, class_id)
                for su in self.valid_scores:
                    su.add_constant(init_score, class_id)
                return init_score
        return 0.0

    # ------------------------------------------------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """reference GBDT::TrainOneIter (gbdt.cpp:367-448) along the JAX
        package's fused path (`_train_one_iter_fused`, gbdt.py:1518):
        gradients of every class once, the bag, the hook on them, then a
        tree a class, each on a feature mask of its own; or on the host
        learner (`_train_one_iter_host`). ``grad`` and ``hess`` ([K * N]
        or [K, N], a custom objective's) replace the objective's
        gradients, with no boost from the average. Returns True when
        training should stop."""
        K = self.num_tree_per_iteration
        if grad is None or hess is None:
            init_scores = [self.boost_from_average(k) for k in range(K)]
            if (not self._need_train
                    or self.train_data.num_features == 0) \
                    and not self.use_host:
                for k in range(K):
                    self.learner.feature_mask()
                    self._append_constant_tree(k, init_scores)
                if len(self.models) > K:
                    del self.models[-K:]
                return True
            if not self.use_host and self._aligned_eligible():
                self._log_train_path("aligned")
                if K > 1:
                    return self._train_one_iter_aligned_mc(init_scores)
                return self._train_one_iter_aligned(init_scores[0])
            g, h = self.objective.get_gradients(self.get_training_score())
        else:
            init_scores = [0.0] * K

            def rows(a):
                return torch.as_tensor(
                    np.asarray(a, np.float32).reshape(K, self.num_data),
                    device=self.device)
            g, h = rows(grad), rows(hess)
        self._cur_grad, self._cur_hess = g, h
        self._bagging(self.iter)
        g, h = self._post_bagging_gradients(g, h)
        if self.use_host:
            self._log_train_path("host")
            return self._train_one_iter_host(g, h, init_scores)
        level = self.bag_data_indices is None \
            and self.learner.level_mode_ok()
        self._log_train_path("level" if level else "leafwise")
        for k in range(K):
            fmask = self.learner.feature_mask()
            rec = (self._grow_level(k, g[k], h[k], fmask) if level
                   else self._grow_leafwise(k, g[k], h[k], fmask))
            self._append_class_tree(rec, init_scores[k], k)
        return self._end_iter()

    def _train_one_iter_host(self, g, h, init_scores) -> bool:
        """One iteration on the host learner (JAX package's per-tree
        path, gbdt.py:755-790): a tree a class on the bag; a renewing
        objective sets its leaves from the scores before the tree, then
        the tree is shrunk, added to the scores by traversal and given
        the bias. An iteration without a split ends training at once."""
        K = self.num_tree_per_iteration
        should_continue = False
        for k in range(K):
            tree, leaf_map = Tree(2), {}
            if self._need_train and self.train_data.num_features > 0:
                tree, leaf_map = self.learner.train(
                    g[k], h[k], self.bag_data_indices, self.bag_data_cnt)
            if tree.num_leaves > 1:
                should_continue = True
                if getattr(self.objective, "is_renew_tree_output", False):
                    self.learner.renew_tree_output(
                        tree, leaf_map, self.objective,
                        self.train_score.numpy()[k], self._label_np,
                        self._weight_np)
                tree.apply_shrinkage(self.shrinkage_rate)
                self._update_score(tree, k)
                if abs(init_scores[k]) > K_EPSILON:
                    tree.add_bias(init_scores[k])
                self.models.append(tree)
            else:
                self._append_constant_tree(k, init_scores)
        if not should_continue:
            # keep the constant first iteration, drop later no-split ones
            # (gbdt.cpp:436-444)
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter += 1
        return False

    def drop_aligned(self) -> None:
        """Leave the aligned engine for good (custom gradients and
        rollback: its permuted score lanes cannot follow a tree grown or
        removed elsewhere; JAX package: `_drop_aligned`); the training
        scores come back to row order first."""
        self._sync_train_score()
        self._aligned_eng = None
        self._aligned_disabled = True

    def rollback_one_iter(self) -> None:
        """reference GBDT::RollbackOneIter (gbdt.cpp:450-466; JAX
        package: gbdt.py:1611-1635): the aligned engine is left for good
        (its score lanes hold the last iteration), the iteration's
        deferred empty-tree records are dropped, and its K trees are
        subtracted from the training and validation scores, each an f32
        add of the negated leaf values by binned traversal, before they
        leave the model."""
        K = self.num_tree_per_iteration
        if self.iter <= 0:
            return
        if self._aligned_eng is not None:
            self.drop_aligned()
        if self._pending_numsplits:
            del self._pending_numsplits[-K:]
        start = len(self.models) - K
        for k in range(K):
            tree = self.models[start + k]
            if tree.num_leaves > 1:
                self.apply_tree_to_score(self.train_score, self.learner.bins,
                                         tree, k, scale=-1.0)
                for ds, su in zip(self.valid_sets, self.valid_scores):
                    self.apply_tree_to_score(su, ds.bins, tree, k,
                                             scale=-1.0)
        del self.models[-K:]
        self.iter -= 1

    # ------------------------------------------------------------------
    def get_training_score(self) -> torch.Tensor:
        """Hook: the [K, N] scores the gradients come from (DART drops
        trees from them, dart.hpp:77-86)."""
        self._sync_train_score()
        return self.train_score.score

    def _post_bagging_gradients(self, g: torch.Tensor, h: torch.Tensor):
        """Hook: GOSS re-weights the sampled small-gradient rows
        (goss.hpp:102-108)."""
        return g, h

    def _will_bag(self) -> bool:
        cfg = self.cfg
        return bool(cfg.bagging_freq > 0
                    and (cfg.bagging_fraction < 1.0
                         or self._balanced_bagging))

    def _bagging(self, iter_idx: int) -> None:
        """reference GBDT::Bagging (gbdt.cpp:209-275) as the JAX package
        draws it (gbdt.py:332-356): on bagging_freq boundaries,
        ``choice(n, int(fraction * n), replace=False)`` of ``_bag_rng``, or
        under balanced bagging one ``rand`` over the positives, then one
        over the negatives. The draw stays on the host (the numpy stream
        is the JAX package's); the mask and the sorted row ids (the mask's
        nonzeros, the array the JAX package sorts) are made on the
        device."""
        cfg = self.cfg
        if not self._will_bag() or iter_idx % cfg.bagging_freq != 0:
            return
        n = self.num_data
        dev = self.device
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        if self._balanced_bagging:
            pos = self._label_np > 0
            take_pos = self._bag_rng.rand(int(pos.sum())) \
                < cfg.pos_bagging_fraction
            take_neg = self._bag_rng.rand(n - int(pos.sum())) \
                < cfg.neg_bagging_fraction
            take = np.empty(n, bool)
            take[pos], take[~pos] = take_pos, take_neg
            mask = torch.from_numpy(take).to(dev)
        else:
            cnt = int(cfg.bagging_fraction * n)
            sel = self._bag_rng.choice(n, cnt, replace=False)
            mask[torch.from_numpy(sel.astype(np.int32)).to(dev).long()] = True
        self._bag_mask = mask
        self.bag_data_indices = mask.nonzero()[:, 0].to(torch.int32)
        self.bag_data_cnt = int(self.bag_data_indices.numel())

    def apply_tree_to_score(self, su: _ScoreUpdater, bins: torch.Tensor,
                            tree: Tree, class_id: int,
                            scale: float = 1.0) -> None:
        """su.score[class_id] += scale * tree(x) by binned traversal of a
        host tree (JAX package: gbdt.py:318-324)."""
        su.add_tree_by_leaves(traverse_tree(bins, tree,
                                            self.train_data.bundles),
                              tree.leaf_value[:tree.num_leaves] * scale,
                              class_id)

    def _update_score(self, tree: Tree, class_id: int) -> None:
        """reference GBDT::UpdateScore (gbdt.cpp:487-506): the training
        and validation scores by binned traversal of a host tree."""
        self.apply_tree_to_score(self.train_score, self.learner.bins, tree,
                                 class_id)
        for ds, su in zip(self.valid_sets, self.valid_scores):
            self.apply_tree_to_score(su, ds.bins, tree, class_id)

    # ------------------------------------------------------------------
    def _grow_leafwise(self, k: int, g, h, fmask):
        """Class k's leaf-wise tree on (g, h) [N]: from the identity
        partition, or from the current bag's rows, scored by traversal so
        that the out-of-bag rows get their scores too. Returns its
        record, its training scores updated."""
        lr = self.learner
        if self.bag_data_indices is None:
            indices, rec = lr.train_fresh(g, h, fmask)
            lr.add_score_from_partition(self.train_score.score, k, rec,
                                        indices, self.shrinkage_rate)
        else:
            root, count = lr.init_root_partition(self.bag_data_indices,
                                                 self.bag_data_cnt)
            _, rec = lr.train(g, h, root, count, fmask)
            lr.add_record_score(self.train_score.score[k], lr.bins, rec,
                                self.shrinkage_rate)
        return rec

    def _grow_level(self, k: int, g, h, fmask):
        """Class k's tree on the level builder; an inexact replay grows
        it leaf-wise on the same gradients."""
        lr = self.learner
        out = lr._level_train_fresh(g, h, fmask)
        self.level_stats.append(lr.level_last)
        if out is None:
            log.info(f"level: inexact replay in iteration {self.iter} "
                     f"(fallback {lr.level_fallbacks}); growing it "
                     "leaf-wise")
            out = lr.train_fresh(g, h, fmask)
        rid, rec = out
        lr.add_score_from_partition(self.train_score.score, k, rec, rid,
                                    self.shrinkage_rate)
        return rec

    def _append_class_tree(self, rec, init_score: float, k: int) -> None:
        """Append class k's grown tree and add it to the validation
        scores."""
        tree = self.learner.record_to_tree(rec, self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.models.append(tree)
        for ds, su in zip(self.valid_sets, self.valid_scores):
            self.learner.add_record_score(su.score[k], ds.bins, rec,
                                          self.shrinkage_rate)
        self._pending_numsplits.append(int(rec.num_splits))

    def _end_iter(self) -> bool:
        """Close an iteration of K trees and run the batched empty-tree
        check."""
        self.iter += 1
        if len(self._pending_numsplits) >= 16 * self.num_tree_per_iteration:
            return self._trim_trailing_empty()
        return False

    # ------------------------------------------------------------------
    def _aligned_eligible(self) -> bool:
        """The aligned engine takes the iteration: a trainable objective,
        the class's gradient hooks GBDT's own, and every learner gate
        passing (JAX package: `_aligned_eligible`, and for K classes
        `_aligned_mc_eligible`)."""
        return (self._need_train
                and not self._aligned_disabled
                and self.train_data.num_features > 0
                and self.aligned_gate() is None)

    def aligned_gate(self) -> Optional[str]:
        """First failing gate of the aligned engine, or None: a variant
        whose hooks the engine's score lane cannot follow (DART's dropped
        scores, GOSS's re-weighted gradients), then the learner's."""
        if type(self).get_training_score is not GBDT.get_training_score \
                or type(self)._post_bagging_gradients \
                is not GBDT._post_bagging_gradients:
            return f"boosting={self.cfg.boosting} (its gradient hooks " \
                "keep the aligned engine out)"
        return self.learner.aligned_mode_gate(self.objective)

    def _log_train_path(self, path: str) -> None:
        """One INFO line naming the training path; when the aligned engine
        was not chosen, with its first failing gate."""
        if self.train_path == path:
            return
        self.train_path = path
        msg = f"training path: {path}"
        if path in ("leafwise", "host"):
            why = self.aligned_gate() or "bagged iteration"
            msg += f" (aligned engine rejected: {why})"
        log.info(msg)

    def _engine(self):
        """The aligned engine, made at the first aligned iteration from
        the current scores (K score lanes for K classes)."""
        if self._aligned_eng is None:
            K = self.num_tree_per_iteration
            self._aligned_eng = self.learner.aligned_engine(
                self.objective, init_row_scores=self.train_score.score,
                bagged=self._will_bag(), num_class=K)
        return self._aligned_eng

    def _train_one_iter_aligned(self, init_score: float) -> bool:
        """One tree on the aligned engine. An exact build has already
        updated the engine's score lane; an inexact one left it untouched
        and the iteration grows an exact leaf-wise tree instead, on the
        bag its round drew (the port knows a tree's exactness before the
        next draw)."""
        eng = self._engine()
        self._maybe_rebag(eng)
        fmask = self.learner.feature_mask()
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
            self._sync_train_score()
            g, h = self.objective.get_gradients(self.train_score.score)
            rec = self._grow_leafwise(0, g[0], h[0], fmask)
            self._append_class_tree(rec, init_score, 0)
            eng.set_row_scores(self.train_score.score)
            return self._end_iter()
        rec = replay_spec(spec, self.cfg.num_leaves)
        self._train_score_stale = True
        self._append_class_tree(rec, init_score, 0)
        return self._end_iter()

    def _train_one_iter_aligned_mc(self, init_scores) -> bool:
        """One K-class iteration on the aligned engine (JAX package:
        `_train_one_iter_aligned_mc`, its deferred application and
        exactness chain made plain steps): the bag, K feature masks, the
        probability lanes from the pre-iteration scores and a copy of
        the score lanes (`begin_iter_mc`), then class k's tree from its
        lane, added to its score lane at once. An inexact class j
        restores the copy and grows all K trees leaf-wise on the same bag
        and masks (`_aligned_mc_fallback`)."""
        K = self.num_tree_per_iteration
        eng = self._engine()
        self._maybe_rebag(eng)
        fmasks = [self.learner.feature_mask() for _ in range(K)]
        eng.begin_iter_mc()
        recs = []
        for k in range(K):
            spec, exact = eng.train_iter(self.shrinkage_rate, fmasks[k],
                                         class_k=k)
            self.aligned_stats.append((spec.rounds, spec.n_exec, exact))
            if not exact:
                return self._aligned_mc_fallback(eng, k, init_scores,
                                                 fmasks)
            recs.append(replay_spec(spec, self.cfg.num_leaves))
        self._train_score_stale = True
        for k, rec in enumerate(recs):
            self._append_class_tree(rec, init_scores[k], k)
        return self._end_iter()

    def _aligned_mc_fallback(self, eng, j: int, init_scores,
                             fmasks) -> bool:
        """Class j's build was inexact: the iteration's pre-iteration row
        scores come back from the engine's copy, the K trees grow
        leaf-wise from gradients of those scores on the iteration's bag
        and masks, and the engine's score lanes take the result."""
        eng.fallbacks += 1
        log.info(f"aligned: inexact replay of class {j} in iteration "
                 f"{self.iter} (fallback {eng.fallbacks}); growing the "
                 "iteration leaf-wise")
        self.train_score.score = eng.saved_row_scores()
        self._train_score_stale = False
        g, h = self.objective.get_gradients(self.train_score.score)
        for k in range(self.num_tree_per_iteration):
            rec = self._grow_leafwise(k, g[k], h[k], fmasks[k])
            self._append_class_tree(rec, init_scores[k], k)
        eng.set_row_scores(self.train_score.score)
        return self._end_iter()

    def _maybe_rebag(self, eng) -> None:
        """Draw the bag on bagging_freq boundaries and write it into the
        engine's records (gbdt.cpp:209-275; JAX package: gbdt.py:1231):
        the histograms and gradients honour it, the layout keeps every
        row, so out-of-bag rows still get scores."""
        if not (self._will_bag()
                and self.iter % self.cfg.bagging_freq == 0):
            return
        self._bagging(self.iter)
        eng.set_bag(self._bag_mask)

    def _sync_train_score(self) -> None:
        """Row-order training scores from the aligned engine's lanes."""
        if self._train_score_stale:
            self.train_score.score = self._aligned_eng.row_scores_all()
            self._train_score_stale = False

    def _append_constant_tree(self, k: int, init_scores) -> Tree:
        """Constant tree carrying the init score (gbdt.cpp:413-433): only
        the first iteration's constant trees hold an output."""
        t = Tree(2)
        if len(self.models) < self.num_tree_per_iteration:
            output = (self.objective.boost_from_score(k)
                      if not self._need_train else init_scores[k])
            t.as_constant_tree(output)
            if abs(output) > K_EPSILON:
                self.train_score.add_constant(output, k)
                for su in self.valid_scores:
                    su.add_constant(output, k)
        self.models.append(t)
        return t

    def _trim_trailing_empty(self) -> bool:
        """Deferred empty-tree check (gbdt.cpp:436-444, batched as in the
        JAX package's fused path, gbdt.py:1499): the trailing iterations
        whose K trees all have no split are dropped, the first one
        kept."""
        ns = self._pending_numsplits
        self._pending_numsplits = []
        k = self.num_tree_per_iteration
        empty_trailing = 0
        for it in range(len(ns) // k - 1, -1, -1):
            if max(ns[it * k:(it + 1) * k]) != 0:
                break
            empty_trailing += 1
        if empty_trailing and len(self.models) > k:
            drop = min(empty_trailing * k, len(self.models) - k)
            del self.models[-drop:]
            self.iter -= drop // k
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
        """The metrics in the user's order, each from its device form
        where it has one (the JAX package's `GBDT._eval`), else from the
        host scores, read once."""
        if not metrics:
            return []
        dev_vals = [m.eval_dev(su.score, self.objective) for m in metrics]
        scores = su.numpy() if any(d is None for d in dev_vals) else None
        out = []
        for m, dev in zip(metrics, dev_vals):
            pairs = dev if dev is not None else m.eval(scores,
                                                       self.objective)
            out.extend((name, mname, float(val), m.bigger_is_better)
                       for mname, val in pairs)
        return out
