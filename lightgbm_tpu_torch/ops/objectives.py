"""Objective functions (port of lightgbm_tpu/ops/objectives.py: the
regression family -- l2, l1, huber, fair, poisson, quantile, mape, gamma
and tweedie --, binary logloss, multiclass softmax and one-vs-all,
cross-entropy (xentropy, xentlambda) and lambdarank), with the
percentile leaf renewal of l1, quantile and mape.

Gradients are f32 torch tensors on the device of the scores, computed
with the JAX package's f32 op order. Its ``exp`` is XLA's, which is not
correctly rounded and differs from every library ``exp`` in the last bit
for a few percent of inputs; `exp_f32` computes the same polynomial
with the same fused multiply-adds (`utils/xla_math.py`), and the
products XLA's CPU backend contracts into an add are fused here too
(`fma_f32`), so the port's gradients are the JAX package's bit for bit,
on the CPU and on CUDA alike. Weighted xentlambda is the exception: its
``log1p`` is the library's, not XLA's (ROADMAP C.31). Scores are laid
out ``[num_tree_per_iteration, num_data]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Metadata
from ..utils.xla_math import exp_f32, fma_f32
from .rank import lambdarank_grad, rank_work
from .ranking import discount_table, max_dcg_at_k

_F32 = np.float32


class PointGrad(NamedTuple):
    """The pointwise gradient of a single-class objective, as a function
    of (score, label, weight|None) and as the kind and three f32
    constants the aligned engine's CUDA kernels inline (JAX package:
    ``point_grad_fn``, its closure). The kinds and their constants
    ``c0, c1, c2``, each an f32 value computed on the host as the JAX
    package computes it (a Python float rounded once):

    - "binary": logistic loss; sigmoid, w_pos, w_neg (the label weights);
    - "l2": score - label, hessian 1;
    - "l1": sign(score - label), hessian 1;
    - "huber": the difference clipped to +-alpha, hessian 1; alpha;
    - "fair": c x / (|x| + c), c^2 / (|x| + c)^2; c, c^2;
    - "poisson": exp(s) - label, exp(s + max_delta_step); max_delta_step;
    - "quantile": 1 - alpha or -alpha by the difference's sign, hessian
      1; 1 - alpha, -alpha;
    - "gamma": 1 - label exp(-s), label exp(-s);
    - "tweedie": -label e1 + e2, -label (1 - rho) e1 + (2 - rho) e2 with
      e1 = exp((1 - rho) s), e2 = exp((2 - rho) s); 1 - rho, 2 - rho;
    - "xentropy": z - label, z (1 - z) with z = 1 / (1 + exp(-s)).

    Where XLA's CPU backend fuses a product into the add that follows
    it, or reorders a product, the port does too (`fma_f32`; gamma's and
    tweedie's gradients, found against the JAX program's bits)."""
    kind: str
    c0: float = 1.0
    c1: float = 1.0
    c2: float = 1.0

    def __call__(self, score: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kind == "gamma":
            return _gamma(self, score, label, weight)
        g, h = _POINT_GRADS[self.kind](self, score, label)
        if weight is not None:
            g = g * weight
            h = h * weight
        return g, h


def _binary(pg, score, label):
    sig = pg.c0
    pos = label > 0
    sl = torch.where(pos, 1.0, -1.0)
    lw = torch.where(pos, pg.c1, pg.c2)
    response = -sl * sig / (1.0 + exp_f32(sl * sig * score))
    absr = torch.abs(response)
    return response * lw, absr * (sig - absr) * lw


def _l2(pg, score, label):
    return score - label, torch.ones_like(score)


def _l1(pg, score, label):
    return torch.sign(score - label), torch.ones_like(score)


def _huber(pg, score, label):
    diff = score - label
    g = torch.where(torch.abs(diff) <= pg.c0, diff, torch.sign(diff) * pg.c0)
    return g, torch.ones_like(score)


def _fair(pg, score, label):
    x = score - label
    d = torch.abs(x) + pg.c0
    # a true quotient: a Python number over a tensor is its reciprocal's
    # product in torch
    return pg.c0 * x / d, torch.full_like(d, pg.c1) / (d * d)


def _poisson(pg, score, label):
    return exp_f32(score) - label, exp_f32(score + pg.c0)


def _quantile(pg, score, label):
    g = torch.where(score - label >= 0, pg.c0, pg.c1).to(score.dtype)
    return g, torch.ones_like(score)


def _gamma(pg, score, label, weight=None):
    # XLA's forms differ with the weights: unweighted it rounds label *
    # exp(-s) once for g and h; weighted it contracts that product into
    # g's subtraction and takes h as (label w) exp(-s)
    e = exp_f32(-score)
    if weight is None:
        m = label * e
        return 1.0 - m, m
    return fma_f32(-label, e, 1.0) * weight, (label * weight) * e


def _tweedie(pg, score, label):
    e1 = exp_f32(pg.c0 * score)
    e2 = exp_f32(pg.c1 * score)
    g = fma_f32(-label, e1, e2)
    h = fma_f32(-label * pg.c0, e1, pg.c1 * e2)
    return g, h


def _xentropy(pg, score, label):
    z = 1.0 / (1.0 + exp_f32(-score))
    return z - label, z * (1.0 - z)


_POINT_GRADS = {"binary": _binary, "l2": _l2, "l1": _l1, "huber": _huber,
                "fair": _fair, "poisson": _poisson, "quantile": _quantile,
                "gamma": _gamma, "tweedie": _tweedie, "xentropy": _xentropy}


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
        g, h = self.point_grad_fn()(scores[0], self.label, self.weight)
        return g[None, :], h[None, :]

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

    def _mean_label(self) -> float:
        """The (weighted) mean label, the boost of l2 and its kin."""
        if self._weight_np is not None:
            return float(np.sum(self._label_np * self._weight_np)
                         / np.sum(self._weight_np))
        return float(np.mean(self._label_np))

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

    def point_grad_fn(self) -> PointGrad:
        return PointGrad("l2")

    def boost_from_score(self, class_id):
        # weighted mean (regression_objective.hpp:156-177)
        return self._mean_label()

    def convert_output(self, raw):
        if self.cfg.reg_sqrt:
            return np.sign(raw) * raw * raw
        return raw


def _percentile(data: np.ndarray, alpha: float) -> float:
    """reference PercentileFun (regression_objective.hpp:18-44)."""
    n = len(data)
    if n <= 1:
        return float(data[0]) if n else 0.0
    s = np.sort(data)
    float_pos = (1.0 - alpha) * n
    pos = int(float_pos)
    if pos < 1:
        return float(s[-1])
    if pos >= n:
        return float(s[0])
    bias = float_pos - pos
    v1 = s[n - pos]
    v2 = s[n - pos - 1]
    # scanned from the top for the alpha-percentile of the residuals
    return float(v1 - (v1 - v2) * bias)


def _weighted_percentile(data: np.ndarray, w: np.ndarray,
                         alpha: float) -> float:
    """reference WeightedPercentileFun (regression_objective.hpp:46-76)."""
    n = len(data)
    if n <= 1:
        return float(data[0]) if n else 0.0
    order = np.argsort(data, kind="stable")
    cdf = np.cumsum(w[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(data[order[pos]])
    v1 = data[order[pos - 1]]
    v2 = data[order[pos]]
    if cdf[pos] <= cdf[pos - 1]:
        return float(v2)
    return float(v1 + (v2 - v1) * (threshold - cdf[pos - 1])
                 / (cdf[pos] - cdf[pos - 1]))


class _PercentileRenewMixin:
    """Leaf-output renewal by residual percentile (reference
    RegressionL1loss::RenewTreeOutput, regression_objective.hpp:233-268):
    the host learner sets each leaf's output to the percentile of its
    rows' residuals before shrinkage."""
    is_renew_tree_output = True
    renew_alpha = 0.5

    def renew_leaf_output(self, residuals: np.ndarray,
                          weights: Optional[np.ndarray]) -> float:
        if len(residuals) == 0:
            return 0.0
        if weights is None:
            return _percentile(residuals, self.renew_alpha)
        return _weighted_percentile(residuals, weights, self.renew_alpha)

    def residual(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        return label - score


class RegressionL1(_PercentileRenewMixin, RegressionL2):
    name = "regression_l1"
    is_constant_hessian = True

    def point_grad_fn(self):
        return PointGrad("l1")

    def boost_from_score(self, class_id):
        if self._weight_np is not None:
            return _weighted_percentile(self._label_np, self._weight_np, 0.5)
        return _percentile(self._label_np, 0.5)


class RegressionHuber(RegressionL2):
    name = "huber"
    is_constant_hessian = True

    def point_grad_fn(self):
        return PointGrad("huber", float(_F32(self.cfg.alpha)))


class RegressionFair(ObjectiveFunction):
    name = "fair"

    def point_grad_fn(self):
        c = float(self.cfg.fair_c)
        # the JAX package's c * c is a Python float, rounded once
        return PointGrad("fair", float(_F32(c)), float(_F32(c * c)))

    def boost_from_score(self, class_id):
        # the reference's RegressionFairLoss keeps l2's mean boost
        return self._mean_label()


class _LogLinkMixin:
    """The log link's boost (the log of the mean label) and output."""

    def boost_from_score(self, class_id):
        return math.log(max(self._mean_label(), 1e-20))

    def convert_output(self, raw):
        return np.exp(raw)


class RegressionPoisson(_LogLinkMixin, ObjectiveFunction):
    name = "poisson"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if np.any(self._label_np < 0):
            raise ValueError("[poisson]: at least one target label is "
                             "negative")

    def point_grad_fn(self):
        return PointGrad("poisson",
                         float(_F32(self.cfg.poisson_max_delta_step)))


class RegressionQuantile(_PercentileRenewMixin, ObjectiveFunction):
    name = "quantile"
    is_constant_hessian = True

    @property
    def renew_alpha(self):
        return self.cfg.alpha

    def point_grad_fn(self):
        a = float(self.cfg.alpha)
        return PointGrad("quantile", float(_F32(1.0 - a)), float(_F32(-a)))

    def boost_from_score(self, class_id):
        if self._weight_np is not None:
            return _weighted_percentile(self._label_np, self._weight_np,
                                        self.cfg.alpha)
        return _percentile(self._label_np, self.cfg.alpha)


class RegressionMAPE(_PercentileRenewMixin, ObjectiveFunction):
    """Not pointwise for the engine: its label weights are stored in row
    order."""
    name = "mape"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        # label_weight = w / max(1, |label|) (regression_objective.hpp:575-589)
        w = (self._weight_np if self._weight_np is not None
             else np.ones(num_data, np.float32))
        self._label_weight_np = (w / np.maximum(1.0, np.abs(self._label_np))
                                 ).astype(np.float32)
        self._label_weight = torch.as_tensor(self._label_weight_np,
                                             device=device)

    def get_gradients(self, scores):
        g = torch.sign(scores[0] - self.label) * self._label_weight
        return g[None, :], self._label_weight[None, :].clone()

    def boost_from_score(self, class_id):
        return _weighted_percentile(self._label_np, self._label_weight_np,
                                    0.5)

    def renew_leaf_output(self, residuals, weights):
        # the weights here are the label weights (hpp:640-658)
        return _weighted_percentile(residuals, weights, 0.5)


class RegressionGamma(_LogLinkMixin, ObjectiveFunction):
    name = "gamma"

    def point_grad_fn(self):
        return PointGrad("gamma")


class RegressionTweedie(_LogLinkMixin, ObjectiveFunction):
    name = "tweedie"

    def point_grad_fn(self):
        rho = float(self.cfg.tweedie_variance_power)
        return PointGrad("tweedie", float(_F32(1 - rho)),
                         float(_F32(2 - rho)))


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


class _CrossEntropyBase(ObjectiveFunction):
    """Labels in [0, 1] (reference xentropy_objective.hpp)."""

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if np.any(self._label_np < 0) or np.any(self._label_np > 1):
            raise ValueError(f"[{self.name}]: labels must be in [0, 1]")

    def _mean_prob(self) -> float:
        if self._weight_np is not None:
            suml = float(np.sum(self._label_np * self._weight_np))
            sumw = float(np.sum(self._weight_np))
        else:
            suml = float(np.sum(self._label_np))
            sumw = float(len(self._label_np))
        return min(max(suml / max(sumw, 1e-20), 1e-15), 1 - 1e-15)


class CrossEntropy(_CrossEntropyBase):
    name = "xentropy"

    def point_grad_fn(self):
        return PointGrad("xentropy")

    def boost_from_score(self, class_id):
        # (xentropy_objective.hpp:116-133): log-odds of the mean label
        pavg = self._mean_prob()
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(_CrossEntropyBase):
    """Not pointwise for the engine: its weights are exposures inside the
    link, not factors of the gradient."""
    name = "xentlambda"

    def get_gradients(self, scores):
        """(xentropy_objective.hpp:185-224): weights act as exposure/trials
        under the log(1 + exp(score)) link. Unweighted it is xentropy's
        gradient; weighted, ``log1p`` is the library's (ROADMAP C.31)."""
        score = scores[0]
        if self.weight is None:
            g, h = PointGrad("xentropy")(score, self.label)
            return g[None, :], h[None, :]
        w, y = self.weight, self.label
        epf = exp_f32(score)
        hhat = torch.log1p(epf)
        z = 1.0 - exp_f32(-w * hhat)
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        h = a * (1.0 + y * b)
        return g[None, :], h[None, :]

    def boost_from_score(self, class_id):
        pavg = self._mean_prob()
        return math.log(math.log1p(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        return np.log1p(np.exp(raw))


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


_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(cfg: Config) -> Optional[ObjectiveFunction]:
    """reference ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:15)."""
    if cfg.objective in ("none", ""):
        return None
    cls = _OBJECTIVES.get(cfg.objective)
    if cls is None:
        raise ValueError(f"Unknown objective: {cfg.objective}")
    return cls(cfg)
