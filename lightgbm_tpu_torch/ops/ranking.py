"""DCG arithmetic shared by the lambdarank objective and the NDCG metric
(copied from lightgbm_tpu/ops/ranking.py).

The reference `DCGCalculator` (`src/metric/dcg_calculator.cpp`):
discount 1/log2(2+i), label gains 2^label-1 (configurable), max DCG from
the labels sorted descending. Host numpy in f64.
"""
from __future__ import annotations

import numpy as np


def dcg_discounts(n: int) -> np.ndarray:
    """discount[i] = 1/log2(2+i) (reference dcg_calculator.cpp:Init)."""
    return 1.0 / np.log2(2.0 + np.arange(n, dtype=np.float64))


def discount_table(n: int) -> np.ndarray:
    """[n] f32 rank-position discounts: the f64 values rounded to f32
    once, the table both of the JAX package's gradient paths read."""
    return dcg_discounts(n).astype(np.float32)


def max_dcg_at_k(k: int, labels: np.ndarray, label_gain: np.ndarray) -> float:
    """reference DCGCalculator::CalMaxDCGAtK (dcg_calculator.cpp:53-77):
    accumulate discounts over labels sorted descending."""
    n = len(labels)
    k = min(k, n)
    if k <= 0:
        return 0.0
    sorted_gains = np.sort(label_gain[labels])[::-1]
    disc = dcg_discounts(k)
    return float(np.sum(sorted_gains[:k] * disc))


def dcg_at_k(k: int, labels: np.ndarray, scores: np.ndarray,
             label_gain: np.ndarray) -> float:
    """reference DCGCalculator::CalDCGAtK: DCG of score-sorted order."""
    n = len(labels)
    k = min(k, n)
    if k <= 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    disc = dcg_discounts(k)
    return float(np.sum(label_gain[labels[order[:k]]] * disc))
