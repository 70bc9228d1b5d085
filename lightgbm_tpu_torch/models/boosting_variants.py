"""Boosting variants: GOSS, DART, RF and the boosting factory (port of
lightgbm_tpu/models/boosting_variants.py).

Re-creates `src/boosting/goss.hpp`, `src/boosting/dart.hpp`,
`src/boosting/rf.hpp` and `Boosting::CreateBoosting`
(`src/boosting/boosting.cpp:35-69`). Each variant changes a hook of
`GBDT` (`get_training_score`, `_bagging`, `_post_bagging_gradients`) or,
for RF, the iteration itself, and trains leaf-wise (or on the host
learner for the renewing objectives): the aligned engine's score lane
cannot follow dropped scores or re-weighted gradients, as in the JAX
package. Every random draw is the JAX package's: GOSS's keys by
the port's Threefry (`utils/prng.py`) from a seed of ``_bag_rng``, DART's
drops from ``RandomState(drop_seed)`` in the same order of calls. A
K-class model drops, renormalizes and averages its K trees of an
iteration together, class by class (the JAX package's K loops).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..utils import prng
from .gbdt import GBDT, K_EPSILON
from .tree import Tree


def goss_select_body(g: torch.Tensor, h: torch.Tensor, seed: int, n: int,
                     top_k: int, other_k: int):
    """The GOSS selection (goss.hpp:96-134; JAX package:
    `goss_select_body`) on the device of ``g`` ([K, N] f32): |g * h|
    summed over classes, the threshold at the top_k'th value, and of the
    rest the other_k rows with the smallest uniform keys under
    ``PRNGKey(seed)``, ties broken by row index (a stable argsort).
    Returns the [N] keep-mask and the [N] f32 re-weight of the sampled
    small-gradient rows."""
    multiply = (n - top_k) / other_k
    a = (g * h).abs().sum(dim=0)
    threshold = torch.sort(a).values[n - top_k]
    big = a >= threshold
    u = prng.uniform(seed, n, device=g.device)
    order = torch.argsort(torch.where(big, 2.0, u), stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=g.device)
    rank[order] = torch.arange(n, device=g.device)
    sampled = ~big & (rank < other_k)
    mult = torch.where(sampled, torch.tensor(multiply, dtype=torch.float32,
                                             device=g.device), 1.0)
    return big | sampled, mult


class GOSS(GBDT):
    """Gradient-based one-side sampling (goss.hpp:25-160): keep the
    top_rate fraction by |g*h|, sample other_rate of the rest and
    up-weight their gradients by (1 - top_rate) / other_rate."""

    def __init__(self, cfg: Config, train_data: Dataset,
                 device: torch.device) -> None:
        super().__init__(cfg, train_data, device)
        if not (cfg.top_rate + cfg.other_rate <= 1.0):
            raise ValueError("top_rate + other_rate must be <= 1.0")
        if cfg.top_rate <= 0.0 or cfg.other_rate <= 0.0:
            raise ValueError("top_rate and other_rate must be positive")
        self._goss_multiplier = None

    def _bagging(self, iter_idx: int) -> None:
        """goss.hpp:141-160: no sampling during the first
        1 / learning_rate iterations; then the selection on the device,
        the bag's row ids its keep-mask's nonzeros."""
        cfg = self.cfg
        self._goss_multiplier = None
        if iter_idx < int(1.0 / cfg.learning_rate):
            self.bag_data_indices = None
            self.bag_data_cnt = self.num_data
            return
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        seed = int(self._bag_rng.randint(0, 2**31 - 1))
        mask, self._goss_multiplier = goss_select_body(
            self._cur_grad, self._cur_hess, seed, n, top_k, other_k)
        self.bag_data_indices = mask.nonzero()[:, 0].to(torch.int32)
        self.bag_data_cnt = int(self.bag_data_indices.numel())

    def _post_bagging_gradients(self, g, h):
        if self._goss_multiplier is None:
            return g, h
        m = self._goss_multiplier[None, :]
        return g * m, h * m


class DART(GBDT):
    """Dropouts meet Multiple Additive Regression Trees (dart.hpp:25-209):
    each iteration drops a random subset of the trees from the training
    scores before the gradients, then shrinks the new tree and renormalizes
    the dropped ones. Drops and renormalization act on the scores by
    binned traversal of the host trees."""

    def __init__(self, cfg: Config, train_data: Dataset,
                 device: torch.device) -> None:
        super().__init__(cfg, train_data, device)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self._drop_rng = np.random.RandomState(cfg.drop_seed)
        self._dropped_this_iter = False
        self.num_init_iteration = 0

    def get_training_score(self) -> torch.Tensor:
        if not self._dropped_this_iter:
            self._dropping_trees()
            self._dropped_this_iter = True
        return self.train_score.score

    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._dropped_this_iter = False
        if super().train_one_iter(grad, hess):
            return True
        # the tree_weight / sum_weight bookkeeping must stay aligned with
        # the models: stop at the first iteration without a split, at once
        K = self.num_tree_per_iteration
        if self._pending_numsplits and len(self.models) > K \
                and max(self._pending_numsplits[-K:]) == 0:
            del self.models[-K:]
            del self._pending_numsplits[-K:]
            self.iter -= 1
            return True
        self._normalize()
        if not self.cfg.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _dropping_trees(self) -> None:
        """dart.hpp:97-146: draw the dropped trees, negate each stored
        tree (the reference's Shrinkage(-1)) and add it, which takes it out
        of the training scores, then set this iteration's shrinkage."""
        cfg = self.cfg
        self.drop_index = []
        is_skip = self._drop_rng.rand() < cfg.skip_drop
        if not is_skip:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = (len(self.tree_weight) / self.sum_weight
                           if self.tree_weight else 1.0)
                if cfg.max_drop > 0 and self.sum_weight > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate \
                            * self.tree_weight[i] * inv_avg:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter)
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        # the stored sign matters: _normalize's two shrinkage steps go on
        # from -1 and must end at +k/(k+1)
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(K):
                t = self.models[i * K + c]
                if t.num_leaves > 1:
                    t.apply_shrinkage(-1.0)
                    self.apply_tree_to_score(self.train_score,
                                             self.learner.bins, t, c)
        k = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        elif k == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate \
                / (cfg.learning_rate + k)

    def _normalize(self) -> None:
        """dart.hpp:148-196: renormalize the dropped trees and patch the
        training and validation scores."""
        cfg = self.cfg
        k = float(len(self.drop_index))
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(K):
                t = self.models[i * K + c]
                if t.num_leaves <= 1:
                    continue
                if not cfg.xgboost_dart_mode:
                    t.apply_shrinkage(1.0 / (k + 1.0))
                    for ds, su in zip(self.valid_sets, self.valid_scores):
                        self.apply_tree_to_score(su, ds.bins, t, c)
                    t.apply_shrinkage(-k)
                else:
                    t.apply_shrinkage(self.shrinkage_rate)
                    for ds, su in zip(self.valid_sets, self.valid_scores):
                        self.apply_tree_to_score(su, ds.bins, t, c)
                    t.apply_shrinkage(-k / cfg.learning_rate)
                self.apply_tree_to_score(self.train_score,
                                         self.learner.bins, t, c)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] \
                        * (1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)


class RF(GBDT):
    """Random forest mode (rf.hpp:25-194): mandatory bagging, no
    shrinkage, one-time gradients from the constant init scores, and the
    running average of the trees as the output."""

    def __init__(self, cfg: Config, train_data: Dataset,
                 device: torch.device) -> None:
        super().__init__(cfg, train_data, device)
        if not (cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0):
            raise ValueError("RF needs bagging (bagging_freq > 0 and "
                             "0 < bagging_fraction < 1)")
        self.shrinkage_rate = 1.0
        self.average_output = True
        K = self.num_tree_per_iteration
        self.init_scores = [self.objective.boost_from_score(k)
                            if cfg.boost_from_average else 0.0
                            for k in range(K)]
        # rf.hpp:82-101: the gradients of the constant init scores, once
        const = torch.tensor(self.init_scores, dtype=torch.float32,
                             device=device)[:, None].expand(
                                 K, self.num_data).contiguous()
        self._rf_grad, self._rf_hess = self.objective.get_gradients(const)

    def aligned_gate(self) -> str:
        return "boosting=rf (one-time gradients, its own iteration)"

    def _build_rf_tree(self, k: int) -> Tree:
        """Class k's tree on the bag: leaf-wise, or on the host learner,
        where a renewing objective sets the leaves from the residuals of
        the constant init score (JAX package: boosting_variants.py:
        276-297)."""
        g, h = self._rf_grad[k], self._rf_hess[k]
        if self.use_host:
            self._log_train_path("host")
            tree, leaf_map = self.learner.train(g, h, self.bag_data_indices,
                                                self.bag_data_cnt)
            if tree.num_leaves > 1 and getattr(
                    self.objective, "is_renew_tree_output", False):
                self.learner.renew_tree_output(
                    tree, leaf_map, self.objective,
                    np.full(self.num_data, self.init_scores[k]),
                    self._label_np, self._weight_np)
            return tree
        self._log_train_path("leafwise")
        fmask = self.learner.feature_mask()
        root, count = self.learner.init_root_partition(
            self.bag_data_indices, self.bag_data_cnt)
        _, rec = self.learner.train(g, h, root, count, fmask)
        return self.learner.record_to_tree(rec, 1.0)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """rf.hpp:103-166: a tree a class on the bag, its bias the class's
        init score, folded into the running average of that class's
        scores (the one-time gradients; ``grad`` and ``hess`` are not
        read, as in the JAX package)."""
        self._bagging(self.iter)
        K = self.num_tree_per_iteration
        for k in range(K):
            tree = Tree(2)
            if self.objective.need_train \
                    and self.train_data.num_features > 0:
                tree = self._build_rf_tree(k)
            if tree.num_leaves > 1:
                if abs(self.init_scores[k]) > K_EPSILON:
                    tree.add_bias(self.init_scores[k])
                for su in [self.train_score] + self.valid_scores:
                    su.multiply_score(self.iter, k)
                self._update_score(tree, k)
                for su in [self.train_score] + self.valid_scores:
                    su.multiply_score(1.0 / (self.iter + 1), k)
            elif len(self.models) < K:
                tree.as_constant_tree(0.0 if self.objective.need_train
                                      else self.objective.boost_from_score(k))
            self.models.append(tree)
        self.iter += 1
        return False


def create_boosting(cfg: Config, train_data: Dataset,
                    device: torch.device) -> GBDT:
    """reference Boosting::CreateBoosting (boosting.cpp:35-69)."""
    variants = {"gbdt": GBDT, "goss": GOSS, "dart": DART, "rf": RF}
    if cfg.boosting not in variants:
        raise ValueError(f"Unknown boosting type: {cfg.boosting}")
    return variants[cfg.boosting](cfg, train_data, device)
