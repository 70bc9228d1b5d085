"""Training entry point (port of lightgbm_tpu/engine.py `train`).

The reference engine loop (`python-package/lightgbm/engine.py:239-267`):
one boosting iteration per round, then the validation sets' metrics,
recorded in ``evals_result`` and printed every round when
``verbose_eval``, then the callbacks. Early stopping (a positive
``early_stopping_round`` or alias raises), callbacks that run before an
iteration, ``fobj``/``feval`` and ``cv`` are later slices.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

from .basic import Booster, Dataset

# the environment a callback receives (reference callback.py:10)
CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None,
          evals_result: Optional[Dict] = None,
          verbose_eval: bool = True,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """reference engine.py:19-280 (plain loop; each callback runs after
    its iteration's evaluation)."""
    if feval is not None:
        raise NotImplementedError("feval is not ported yet")
    params = dict(params)
    for alias in _EARLY_STOP_ALIASES:
        v = params.pop(alias, None)     # the JAX engine pops them too
        if v is not None and int(float(v)) > 0:
            raise NotImplementedError(
                f"{alias}={v}: early stopping is not ported yet (ROADMAP "
                "A.3); the JAX package would stop training early")
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    booster = Booster(params=params, train_set=train_set)
    valid_sets = valid_sets or []
    # the train set, when listed, takes the user's name for it (JAX
    # package: engine.py:83-101)
    train_data_name = "training"
    user_named = valid_names is not None
    if valid_names is None:
        valid_names = [f"valid_{i}" for i in range(len(valid_sets))]
    eval_train = False
    for vs, name in zip(valid_sets, valid_names):
        if vs is train_set:
            eval_train = True
            if user_named:
                train_data_name = name
            continue
        booster.add_valid(vs, name)
    booster.name_train_set = train_data_name
    if evals_result is not None:
        evals_result.clear()
    results = []
    for i in range(num_boost_round):
        booster.update()
        results = [(train_data_name, m, v, b)
                   for _, m, v, b in booster.eval_train()] \
            if eval_train else []
        if len(valid_sets) > int(eval_train):
            results = results + booster.eval_valid()
        if evals_result is not None:
            for data_name, eval_name, value, _ in results:
                evals_result.setdefault(data_name, collections.OrderedDict())
                evals_result[data_name].setdefault(eval_name, []).append(
                    value)
        if verbose_eval and results:
            print(f"[{i + 1}]\t" + "\t".join(
                f"{d}'s {m}: {v:g}" for d, m, v, _ in results))
        for cb in callbacks or []:
            cb(CallbackEnv(booster, params, i, 0, num_boost_round, results))
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, score, _ in results:
        booster.best_score[data_name][eval_name] = score
    return booster
