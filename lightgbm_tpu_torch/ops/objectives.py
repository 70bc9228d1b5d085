"""Objective functions (port of lightgbm_tpu/ops/objectives.py: the base
class, `RegressionL2`, `BinaryLogloss`, `MulticlassSoftmax`,
`MulticlassOVA` and `LambdarankNDCG`).

Gradients are f32 torch tensors on the device of the scores, computed
with the JAX package's f32 op order. Its ``exp`` is XLA's, which is not
correctly rounded and differs from every library ``exp`` in the last bit
for a few percent of inputs; `exp_f32` computes the same polynomial
with the same fused multiply-adds (`utils/xla_math.py`), so the port's
gradients are the JAX package's bit for bit, on the CPU and on CUDA
alike. Scores are laid out ``[num_tree_per_iteration, num_data]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Metadata
from ..utils.xla_math import exp_f32
from .rank import lambdarank_grad, rank_work
from .ranking import discount_table, max_dcg_at_k


class PointGrad(NamedTuple):
    """The pointwise gradient of a single-class objective, as a function
    of (score, label, weight|None) and as the parameters the aligned
    engine's CUDA kernels inline (JAX package: ``point_grad_fn``, its
    closure). ``kind`` is "binary" (logistic loss with ``sigmoid`` and the
    label weights) or "l2" (score - label, hessian 1)."""
    kind: str
    sigmoid: float = 1.0
    w_pos: float = 1.0
    w_neg: float = 1.0

    def __call__(self, score: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kind == "l2":
            g, h = score - label, torch.ones_like(score)
        else:
            sig = self.sigmoid
            pos = label > 0
            sl = torch.where(pos, 1.0, -1.0)
            lw = torch.where(pos, self.w_pos, self.w_neg)
            response = -sl * sig / (1.0 + exp_f32(sl * sig * score))
            absr = torch.abs(response)
            g = response * lw
            h = absr * (sig - absr) * lw
        if weight is not None:
            g = g * weight
            h = h * weight
        return g, h


class ObjectiveFunction:
    """Base class (reference objective_function.h:19)."""

    name = "none"
    is_constant_hessian = False
    is_renew_tree_output = False
    need_train = True

    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg
        self.num_class = 1
        self._label_np: Optional[np.ndarray] = None
        self._weight_np: Optional[np.ndarray] = None
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.device = device
        self._label_np = np.asarray(metadata.label, np.float32) \
            if metadata.label is not None else np.zeros(num_data, np.float32)
        self.label = torch.as_tensor(self._label_np, device=device)
        if metadata.weight is not None:
            self._weight_np = np.asarray(metadata.weight, np.float32)
            self.weight = torch.as_tensor(self._weight_np, device=device)

    def get_gradients(self, scores: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """grad/hess f32 [K, N] given scores [K, N]."""
        g, h = self._point_grad(scores[0], self.label)
        if self.weight is not None:
            g = g * self.weight
            h = h * self.weight
        return g[None, :], h[None, :]

    def _point_grad(self, score, label):
        raise NotImplementedError

    def point_grad_fn(self) -> Optional[PointGrad]:
        """The objective's gradient as a pure function of one row's
        values, or None when it is not pointwise: the aligned engine
        evaluates it in the records' permuted row order."""
        return None

    def mc_lane_mode(self) -> Optional[str]:
        """How a K-class objective's gradients read the aligned records:
        "prob" from a class's probability lane (softmax), "score" from its
        score lane (one-vs-all), None not lane-wise (single class,
        weighted)."""
        return None

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def __str__(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    """reference regression_objective.hpp (L2)."""
    name = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if self.cfg.reg_sqrt:
            # sqrt transform of label (regression_objective.hpp:88-100)
            self._label_np = (np.sign(self._label_np)
                              * np.sqrt(np.abs(self._label_np))).astype(
                                  np.float32)
            self.label = torch.as_tensor(self._label_np, device=device)
        if self.weight is not None:
            self.is_constant_hessian = False

    def _point_grad(self, score, label):
        return score - label, torch.ones_like(score)

    def point_grad_fn(self) -> PointGrad:
        return PointGrad("l2")

    def boost_from_score(self, class_id):
        # weighted mean (regression_objective.hpp:156-177)
        if self._weight_np is not None:
            return float(np.sum(self._label_np * self._weight_np)
                         / np.sum(self._weight_np))
        return float(np.mean(self._label_np))

    def convert_output(self, raw):
        if self.cfg.reg_sqrt:
            return np.sign(raw) * raw * raw
        return raw


class BinaryLogloss(ObjectiveFunction):
    """reference binary_objective.hpp."""
    name = "binary"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        pos = self._label_np > 0
        cnt_pos = int(pos.sum())
        cnt_neg = num_data - cnt_pos
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        # label weights (binary_objective.hpp:79-100)
        w_pos, w_neg = 1.0, 1.0
        if self.cfg.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.cfg.scale_pos_weight
        self._w_pos, self._w_neg = float(w_pos), float(w_neg)
        self._sign_label = torch.as_tensor(
            np.where(pos, 1.0, -1.0).astype(np.float32), device=device)
        self._label_weight = torch.as_tensor(
            np.where(pos, w_pos, w_neg).astype(np.float32), device=device)
        self.need_train = cnt_pos > 0 and cnt_neg > 0

    def point_grad_fn(self) -> PointGrad:
        return PointGrad("binary", float(self.cfg.sigmoid), self._w_pos,
                         self._w_neg)

    def get_gradients(self, scores):
        sig = float(self.cfg.sigmoid)
        label = self._sign_label
        response = -label * sig / (1.0 + exp_f32(label * sig
                                                      * scores[0]))
        absr = torch.abs(response)
        g = response * self._label_weight
        h = absr * (sig - absr) * self._label_weight
        if self.weight is not None:
            g = g * self.weight
            h = h * self.weight
        return g[None, :], h[None, :]

    def boost_from_score(self, class_id):
        # weighted average prob -> log odds / sigmoid
        # (binary_objective.hpp:136-153)
        if self._weight_np is not None:
            suml = float(np.sum((self._label_np > 0) * self._weight_np))
            sumw = float(np.sum(self._weight_np))
        else:
            suml = float(self._cnt_pos)
            sumw = float(self._cnt_pos + self._cnt_neg)
        pavg = min(max(suml / max(sumw, 1e-20), 1e-15), 1 - 1e-15)
        return math.log(pavg / (1.0 - pavg)) / self.cfg.sigmoid

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.cfg.sigmoid * raw))


def softmax_rows(scores: torch.Tensor) -> torch.Tensor:
    """[K, N] f32 softmax over the classes, in `jax.nn.softmax`'s order:
    the max by successive maximums, ``exp`` of the shifted scores, their
    sum class by class, then each quotient."""
    m = scores[0]
    for j in range(1, scores.shape[0]):
        m = torch.maximum(m, scores[j])
    e = exp_f32(scores - m[None, :])
    tot = e[0]
    for j in range(1, scores.shape[0]):
        tot = tot + e[j]
    return e / tot[None, :]


class MulticlassSoftmax(ObjectiveFunction):
    """reference multiclass_objective.hpp (softmax): p = softmax(scores),
    g = p - [label == k], h = 2 p (1 - p)."""
    name = "multiclass"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_class = cfg.num_class

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        li = self._label_np.astype(np.int32)
        if num_data and (li.min() < 0 or li.max() >= self.num_class):
            raise ValueError(f"Label must be in [0, {self.num_class})")
        self._label_int = torch.as_tensor(li.astype(np.int64),
                                          device=device)
        probs = np.zeros(self.num_class)
        w = (self._weight_np if self._weight_np is not None
             else np.ones(num_data, np.float32))
        np.add.at(probs, li, w)
        self._class_init_probs = probs / probs.sum()

    def get_gradients(self, scores):
        p = softmax_rows(scores)
        onehot = torch.arange(self.num_class, device=scores.device)[:, None] \
            == self._label_int[None, :]
        g = p - onehot.to(p.dtype)
        h = 2.0 * p * (1.0 - p)
        if self.weight is not None:
            g = g * self.weight[None, :]
            h = h * self.weight[None, :]
        return g, h

    def mc_lane_mode(self):
        return None if self.weight is not None else "prob"

    def boost_from_score(self, class_id):
        # avg_output = log(class prob) (multiclass_objective.hpp:118-126)
        return math.log(max(self._class_init_probs[class_id], 1e-300))

    def convert_output(self, raw):
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """reference multiclass_objective.hpp (one-vs-all): class k is a
    `BinaryLogloss` of the label ``label == k``, with its own label
    weights."""
    name = "multiclassova"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_class = cfg.num_class
        self._binary = [BinaryLogloss(cfg) for _ in range(cfg.num_class)]

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        li = self._label_np.astype(np.int32)
        for k, b in enumerate(self._binary):
            md = Metadata(num_data)
            md.set_label((li == k).astype(np.float32))
            md.weight = metadata.weight
            b.init(md, num_data, device)

    def get_gradients(self, scores):
        gs, hs = [], []
        for k, b in enumerate(self._binary):
            g, h = b.get_gradients(scores[k:k + 1])
            gs.append(g[0])
            hs.append(h[0])
        return torch.stack(gs), torch.stack(hs)

    def mc_lane_mode(self):
        return None if self.weight is not None else "score"

    def score_point_grad(self, k: int) -> PointGrad:
        """Class k's logistic gradient of its own score lane, its label
        ``label == k``."""
        return self._binary[k].point_grad_fn()

    def boost_from_score(self, class_id):
        return self._binary[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.cfg.sigmoid * raw))


# the JAX package's fused lambdarank kernel packs queries into tiles of
# 128-document subtiles (lightgbm_tpu/ops/pallas_rank.py:68)
RANK_SUBTILE = 128


class LambdarankNDCG(ObjectiveFunction):
    """reference rank_objective.hpp (LambdarankNDCG): the gradients of
    every query's pairs come from kernel B6 (`ops/rank.py`), in row order;
    row weights fold in after."""
    name = "lambdarank"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError("Lambdarank tasks require query information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        self.query_boundaries = qb
        nq = len(qb) - 1
        label_gain = np.asarray(self.cfg.label_gain, np.float64)
        labels = self._label_np.astype(np.int64)
        if num_data and int(labels.max()) >= len(label_gain):
            raise ValueError("label_gain too short for labels")
        # inverse max DCG at max_position (rank_objective.hpp:60-69)
        inv = np.zeros(nq, np.float64)
        for q in range(nq):
            m = max_dcg_at_k(self.cfg.max_position,
                             labels[qb[q]:qb[q + 1]], label_gain)
            inv[q] = 1.0 / m if m > 0 else 0.0
        longest = int(np.diff(qb).max()) if nq else 1

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype),
                                   device=device)

        self._qoff = t(qb, np.int32)
        self._label_i = t(labels, np.int32)
        self._gain = t(label_gain[labels].astype(np.float32), np.float32)
        self._inv = t(inv.astype(np.float32), np.float32)
        self._disc = t(discount_table(max(longest, 1)), np.float32)
        self._work = rank_work(qb, labels).to(device)
        self._lut_len = self._tabled_length(torch.device(device))

    def _tabled_length(self, device: torch.device) -> int:
        """The longest query that takes the sigmoid table, 0 for none: the
        JAX package applies ``tpu_rank_sigmoid_bins`` only in its fused
        kernel, which runs under ``tpu_rank_fused=on``, or under ``auto``
        when the accelerator is attached (here: the card), and takes the
        queries of at most ``tpu_rank_tile`` documents rounded up to its
        128-document subtile (lightgbm_tpu/ops/objectives.py:740-752);
        every other query takes the exact sigmoid."""
        mode = str(self.cfg.tpu_rank_fused).lower()
        fused = mode == "on" or (mode == "auto" and device.type == "cuda")
        if not fused or int(self.cfg.tpu_rank_sigmoid_bins) <= 0:
            return 0
        tile = max(RANK_SUBTILE, int(self.cfg.tpu_rank_tile))
        return -(-tile // RANK_SUBTILE) * RANK_SUBTILE

    def get_gradients(self, scores):
        g, h = lambdarank_grad(scores[0], self._qoff, self._label_i,
                               self._gain, self._inv, self._disc,
                               float(self.cfg.sigmoid),
                               int(self.cfg.tpu_rank_sigmoid_bins),
                               self._lut_len, work=self._work)
        if self.weight is not None:
            g = g * self.weight
            h = h * self.weight
        return g[None, :], h[None, :]


_OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss,
               "multiclass": MulticlassSoftmax,
               "multiclassova": MulticlassOVA, "lambdarank": LambdarankNDCG}


def create_objective(cfg: Config) -> Optional[ObjectiveFunction]:
    """reference ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:15)."""
    if cfg.objective in ("none", ""):
        return None
    cls = _OBJECTIVES.get(cfg.objective)
    if cls is None:
        raise NotImplementedError(
            f"objective {cfg.objective!r} is not ported yet (the port "
            f"has: {', '.join(sorted(_OBJECTIVES))})")
    return cls(cfg)
