"""Evaluation metrics (copied from lightgbm_tpu/ops/metrics.py: the
regression family's -- l1, l2, rmse, quantile, huber, fair, poisson,
mape, gamma, gamma_deviance and tweedie --, binary logloss and error,
AUC, multi_logloss, multi_error, NDCG and MAP, and the cross-entropy
ones, xentropy, xentlambda and kldiv).

Re-creates the reference metric interface (`src/metric/*.hpp`, factory
`src/metric/metric.cpp:16-60`): `eval(raw_scores, objective)` applying
the objective's `ConvertOutput`, returning named values plus
`bigger_is_better` for early stopping (`include/LightGBM/metric.h`).
Host NumPy (f64): metrics run once per iteration over the label vector.
A metric with an `eval_dev` (AUC) evaluates the device scores instead,
and the training loop prefers it, as the JAX package's `GBDT._eval` does.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from .ranking import dcg_at_k, max_dcg_at_k

K_EPSILON = 1e-15


def _safe_log(x):
    return np.log(np.maximum(x, 1e-308))


class Metric:
    name: str = ""
    bigger_is_better: bool = False

    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, np.float64) \
            if metadata.label is not None else np.zeros(num_data)
        self.weight = (np.asarray(metadata.weight, np.float64)
                       if metadata.weight is not None else None)
        self.num_data = num_data
        self.sum_weights = (float(self.weight.sum()) if self.weight is not None
                            else float(num_data))

    def eval(self, scores: np.ndarray, objective) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def eval_dev(self, scores_dev, objective):
        """The metric over the [K, N] device scores, or None where it has
        only the host form."""
        return None


class _PointwiseMetric(Metric):
    """Weighted mean of a pointwise loss with ConvertOutput applied
    (reference RegressionMetric::Eval, regression_metric.hpp:50-95)."""
    use_convert = True

    def loss(self, label: np.ndarray, pred: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def average(self, sum_loss: float) -> float:
        return sum_loss / self.sum_weights

    def eval(self, scores, objective):
        pred = scores[0].astype(np.float64)
        if self.use_convert and objective is not None:
            pred = objective.convert_output(pred)
        pt = self.loss(self.label, pred)
        if self.weight is not None:
            s = float(np.sum(pt * self.weight))
        else:
            s = float(np.sum(pt))
        return [(self.name, self.average(s))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def loss(self, y, p):
        return (p - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def average(self, s):
        return math.sqrt(s / self.sum_weights)


class L1Metric(_PointwiseMetric):
    name = "l1"

    def loss(self, y, p):
        return np.abs(p - y)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def loss(self, y, p):
        delta = y - p
        return np.where(delta < 0, (self.cfg.alpha - 1.0) * delta,
                        self.cfg.alpha * delta)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def loss(self, y, p):
        d = p - y
        a = self.cfg.alpha
        return np.where(np.abs(d) <= a, 0.5 * d * d,
                        a * (np.abs(d) - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def loss(self, y, p):
        x = np.abs(p - y)
        c = self.cfg.fair_c
        return c * x - c * c * np.log(1.0 + x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def loss(self, y, p):
        p = np.maximum(p, 1e-10)
        return p - y * np.log(p)


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def loss(self, y, p):
        return np.abs(y - p) / np.maximum(1.0, np.abs(y))


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def loss(self, y, p):
        # (regression_metric.hpp:261-268)
        theta = -1.0 / p
        b = -_safe_log(-theta)
        c = _safe_log(y) - _safe_log(y)  # psi=1: log(y/1) - log(y) = 0
        return -((y * theta - b) + c)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def loss(self, y, p):
        tmp = y / (p + 1e-9)
        return tmp - _safe_log(tmp) - 1.0

    def average(self, s):
        return s * 2.0


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def loss(self, y, p):
        rho = self.cfg.tweedie_variance_power
        eps = 1e-10
        p = np.maximum(p, eps)
        a = y * np.exp((1 - rho) * np.log(p)) / (1 - rho)
        b = np.exp((2 - rho) * np.log(p)) / (2 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def loss(self, y, p):
        # (binary_metric.hpp:119-131)
        pos = y > 0
        neg_ok = (1.0 - p) > K_EPSILON
        pos_ok = p > K_EPSILON
        return np.where(pos, np.where(pos_ok, -np.log(np.maximum(p, 1e-300)),
                                      -np.log(K_EPSILON)),
                        np.where(neg_ok, -np.log(np.maximum(1 - p, 1e-300)),
                                 -np.log(K_EPSILON)))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def loss(self, y, p):
        return np.where(p <= 0.5, (y > 0).astype(float),
                        (y <= 0).astype(float))


class AUCMetric(Metric):
    """Weighted rank-sum AUC on raw scores (binary_metric.hpp:159-240)."""
    name = "auc"
    bigger_is_better = True

    def eval(self, scores, objective):
        score = scores[0].astype(np.float64)
        y = self.label > 0
        w = (self.weight if self.weight is not None
             else np.ones_like(score))
        order = np.argsort(score, kind="mergesort")
        s, ys, ws = score[order], y[order], w[order]
        # tie groups share the average rank: accumulate per distinct score
        pos_w = ws * ys
        neg_w = ws * (~ys)
        # cumulative negative weight strictly below each element + half ties
        group_id = np.zeros(len(s), np.int64)
        group_id[1:] = np.cumsum(np.diff(s) != 0)
        n_groups = group_id[-1] + 1 if len(s) else 0
        gsum_neg = np.bincount(group_id, weights=neg_w, minlength=n_groups)
        gsum_pos = np.bincount(group_id, weights=pos_w, minlength=n_groups)
        cum_neg_before = np.concatenate([[0], np.cumsum(gsum_neg)[:-1]])
        acc = float(np.sum(gsum_pos * (cum_neg_before + 0.5 * gsum_neg)))
        total_pos = float(pos_w.sum())
        total_neg = float(neg_w.sum())
        if total_pos <= 0 or total_neg <= 0:
            return [(self.name, 1.0)]
        return [(self.name, acc / (total_pos * total_neg))]

    def eval_dev(self, scores_dev, objective):
        """The JAX package's device AUC (`AUCMetric.eval_dev`) in f32 on
        the device of the scores: unweighted, integer counts a tie group,
        then f32 products and one f32 sum; weighted, f32 sums throughout
        (its ~1e-6 relative form). Sorted by score, ties grouped."""
        score = scores_dev[0]
        dev = score.device
        if getattr(self, "_y_dev", None) is None \
                or self._y_dev.device != dev:
            self._y_dev = torch.as_tensor(self.label > 0, device=dev)
            self._w_dev = (torch.as_tensor(self.weight, dtype=torch.float32,
                                           device=dev)
                           if self.weight is not None else None)
        n = score.shape[0]
        order = torch.argsort(score, stable=True)
        s = score[order]
        yo = self._y_dev[order]
        gid = torch.zeros(n, dtype=torch.int64, device=dev)
        gid[1:] = torch.cumsum((s[1:] != s[:-1]).long(), 0)
        if self._w_dev is not None:
            wo = self._w_dev[order]
            pos_w = wo * yo.float()
            neg_w = wo * (1.0 - yo.float())
            gneg = torch.zeros(n, dtype=torch.float32,
                               device=dev).index_add_(0, gid, neg_w)
            gpos = torch.zeros(n, dtype=torch.float32,
                               device=dev).index_add_(0, gid, pos_w)
        else:
            yi = yo.int()
            gpos = torch.zeros(n, dtype=torch.int32,
                               device=dev).index_add_(0, gid, yi)
            gneg = torch.zeros(n, dtype=torch.int32,
                               device=dev).index_add_(0, gid, 1 - yi)
        cumneg = torch.cumsum(gneg, 0, dtype=gneg.dtype)
        before = (cumneg - gneg).float()
        acc = torch.sum(gpos.float() * (before + 0.5 * gneg.float()))
        tp = gpos.sum().float()
        tn = gneg.sum().float()
        if float(tp) <= 0 or float(tn) <= 0:
            return [(self.name, 1.0)]
        return [(self.name, float(acc / torch.clamp(tp * tn, min=1e-30)))]


class MultiLoglossMetric(Metric):
    """reference multiclass_metric.hpp (MultiLogloss): the mean of
    -log p of the true class, p the objective's converted output."""
    name = "multi_logloss"

    def eval(self, scores, objective):
        k, n = scores.shape
        raw = scores.astype(np.float64).T
        p = objective.convert_output(raw) if objective is not None else raw
        li = self.label.astype(np.int64)
        pt = -np.log(np.maximum(p[np.arange(n), li], K_EPSILON))
        s = float(np.sum(pt * self.weight)) if self.weight is not None \
            else float(np.sum(pt))
        return [(self.name, s / self.sum_weights)]


class MultiErrorMetric(Metric):
    """reference multiclass_metric.hpp (MultiError): a row is an error
    when at least ``multi_error_top_k`` classes score above its true
    class's raw score."""
    name = "multi_error"

    def eval(self, scores, objective):
        k, n = scores.shape
        raw = scores.astype(np.float64).T
        li = self.label.astype(np.int64)
        true_score = raw[np.arange(n), li]
        rank = np.sum(raw > true_score[:, None], axis=1)
        pt = (rank >= self.cfg.multi_error_top_k).astype(np.float64)
        s = float(np.sum(pt * self.weight)) if self.weight is not None \
            else float(np.sum(pt))
        return [(self.name, s / self.sum_weights)]


class _RankMetric(Metric):
    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name} metric requires query information")
        self.qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.qb) - 1


class NDCGMetric(_RankMetric):
    """NDCG@k per query, averaged over queries; a query whose max DCG is
    0 counts 1 (reference rank_metric.hpp)."""
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.label_gain = np.asarray(self.cfg.label_gain, np.float64)
        self.eval_at = list(self.cfg.eval_at)
        li = self.label.astype(np.int64)
        self.max_dcgs = {
            k: np.asarray([
                max_dcg_at_k(k, li[self.qb[q]:self.qb[q + 1]],
                             self.label_gain)
                for q in range(self.num_queries)])
            for k in self.eval_at
        }

    def eval(self, scores, objective):
        score = scores[0].astype(np.float64)
        li = self.label.astype(np.int64)
        out = []
        for k in self.eval_at:
            accum = 0.0
            for q in range(self.num_queries):
                lo, hi = self.qb[q], self.qb[q + 1]
                m = self.max_dcgs[k][q]
                if m <= 0:
                    accum += 1.0
                else:
                    accum += dcg_at_k(k, li[lo:hi], score[lo:hi],
                                      self.label_gain) / m
            out.append((f"{self.name}@{k}", accum / self.num_queries))
        return out


class MAPMetric(_RankMetric):
    """MAP@k per query, averaged over queries; a query without a relevant
    row counts 1 (reference map_metric.hpp)."""
    name = "map"

    def eval(self, scores, objective):
        score = scores[0].astype(np.float64)
        y = (self.label > 0).astype(np.float64)
        out = []
        for k in self.cfg.eval_at:
            accum = 0.0
            for q in range(self.num_queries):
                lo, hi = self.qb[q], self.qb[q + 1]
                order = np.argsort(-score[lo:hi], kind="stable")
                rel = y[lo:hi][order][:k]
                hits = np.cumsum(rel)
                denom = np.arange(1, len(rel) + 1)
                npos = y[lo:hi].sum()
                if npos > 0:
                    accum += float(np.sum(rel * hits / denom)
                                   / min(npos, k))
                else:
                    accum += 1.0
            out.append((f"{self.name}@{k}", accum / self.num_queries))
        return out


class CrossEntropyMetric(_PointwiseMetric):
    name = "xentropy"

    def loss(self, y, p):
        p = np.clip(p, K_EPSILON, 1 - K_EPSILON)
        return -y * np.log(p) - (1 - y) * np.log(1 - p)


class CrossEntropyLambdaMetric(Metric):
    name = "xentlambda"

    def eval(self, scores, objective):
        # (xentropy_metric.hpp:166+): scores converted via the lambda link
        raw = scores[0].astype(np.float64)
        if objective is not None and objective.name == "xentlambda":
            lam = objective.convert_output(raw)
        else:
            lam = np.log1p(np.exp(raw))
        w = self.weight if self.weight is not None else np.ones_like(raw)
        y = self.label
        hhat = lam * w
        p = 1.0 - np.exp(-hhat)
        p = np.clip(p, K_EPSILON, 1 - K_EPSILON)
        pt = -y * np.log(p) - (1 - y) * np.log(1 - p)
        return [(self.name, float(np.sum(pt)) / self.num_data)]


class KLDivMetric(_PointwiseMetric):
    name = "kldiv"

    def loss(self, y, p):
        p = np.clip(p, K_EPSILON, 1 - K_EPSILON)
        yy = np.clip(y, K_EPSILON, 1 - K_EPSILON)
        # KL(y||p) = xent(y,p) - entropy(y)
        return (yy * np.log(yy) + (1 - yy) * np.log(1 - yy)
                - y * np.log(p) - (1 - y) * np.log(1 - p))


_METRICS = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric, "ndcg": NDCGMetric, "map": MAPMetric,
    "xentropy": CrossEntropyMetric, "xentlambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
}

_DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "xentropy": "xentropy",
    "xentlambda": "xentlambda", "lambdarank": "ndcg",
}


def metric_names(cfg: Config) -> List[str]:
    """Resolve configured metric list with the objective default
    (reference Config::CheckParamConflict + metric.cpp:16)."""
    names = [m for m in cfg.metric if m]
    if not names:
        default = _DEFAULT_METRIC_FOR_OBJECTIVE.get(cfg.objective)
        if default:
            names = [default]
    return [n for n in names if n != "none"]


def create_metrics(cfg: Config, names: Optional[Sequence[str]] = None
                   ) -> List[Metric]:
    out = []
    for n in (names if names is not None else metric_names(cfg)):
        cls = _METRICS.get(n)
        if cls is None:
            raise ValueError(f"Unknown metric: {n}")
        out.append(cls(cfg))
    return out
