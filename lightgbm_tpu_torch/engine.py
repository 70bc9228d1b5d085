"""Training entry point (port of lightgbm_tpu/engine.py `train`).

The reference engine loop (`python-package/lightgbm/engine.py:239-267`):
the callbacks that run before an iteration, one boosting iteration, the
train set's and the validation sets' metrics and ``feval``'s values,
then the callbacks that run after it (`callback.py`: printing every
``verbose_eval`` rounds, ``evals_result``, early stopping), each group
sorted by ``order``. An `EarlyStopException` ends training and sets
``best_iteration`` (1-based) and ``best_score``. ``fobj`` trains from
custom gradients (``objective=none``). ``init_model`` and ``cv`` are
later slices (ROADMAP A.3); ``learning_rates`` raises, as
its callback calls ``Booster.reset_parameter``, which the JAX package's
`Booster` lacks.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import EarlyStopException

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates=None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """reference engine.py:19-280."""
    if learning_rates is not None:
        raise NotImplementedError(
            "learning_rates: its reset_parameter callback calls "
            "Booster.reset_parameter, which the JAX package's Booster "
            "lacks, so such a run fails there too (ROADMAP A.3)")
    params = dict(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOP_ALIASES:
        if alias in params:
            v = params.pop(alias)
            early_stopping_rounds = None if v is None else int(v)
    if fobj is not None:
        params["objective"] = "none"
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
    name_valid_sets = []
    for vs, name in zip(valid_sets, valid_names):
        if vs is train_set:
            eval_train = True
            if user_named:
                train_data_name = name
            continue
        booster.add_valid(vs, name)
        name_valid_sets.append(name)
    booster.name_train_set = train_data_name

    callbacks = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            int(early_stopping_rounds),
            bool(params.get("first_metric_only", False)),
            verbose=bool(verbose_eval)))
    if isinstance(verbose_eval, bool) and verbose_eval:
        callbacks.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int):
        callbacks.append(callback_mod.print_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    results: List = []
    for i in range(num_boost_round):
        for cb in before:
            cb(callback_mod.CallbackEnv(booster, params, i, 0,
                                        num_boost_round, None))
        booster.update(fobj=fobj)
        results = [(train_data_name, m, v, b)
                   for _, m, v, b in booster.eval_train()] \
            if eval_train else []
        if name_valid_sets:
            results = results + booster.eval_valid()
        if feval is not None:
            results = results + _run_feval(feval, booster, train_data_name,
                                           eval_train, name_valid_sets)
        try:
            for cb in after:
                cb(callback_mod.CallbackEnv(booster, params, i, 0,
                                            num_boost_round, results))
        except EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            results = es.best_score
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, score, _ in results or []:
        booster.best_score[data_name][eval_name] = score
    return booster


def _run_feval(feval, booster: Booster, train_name: str,
               include_train: bool, valid_names: List[str]):
    """``feval(preds, dataset)`` on the train set (when listed) and each
    validation set: raw scores, [N] for one class and [N, K] for K; a
    (name, value, bigger_is_better) tuple or a list of them (JAX package:
    engine.py:257-282)."""
    out = []
    gbdt = booster._gbdt
    if include_train:
        gbdt._sync_train_score()
        preds = gbdt.train_score.numpy()
        res = feval(preds[0] if preds.shape[0] == 1 else preds.T,
                    booster._train_set)
        out.extend(_norm_feval(res, train_name))
    for i, su in enumerate(gbdt.valid_scores):
        preds = su.numpy()
        res = feval(preds[0] if preds.shape[0] == 1 else preds.T,
                    booster._valid_sets_public[i])
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        out.extend(_norm_feval(res, name))
    return out


def _norm_feval(res, data_name):
    if isinstance(res, list):
        return [(data_name, n, v, b) for n, v, b in res]
    n, v, b = res
    return [(data_name, n, v, b)]
