"""Training callbacks (port of lightgbm_tpu/callback.py, reference
`python-package/lightgbm/callback.py:78-236`): `print_evaluation`,
`record_evaluation` and `early_stopping`, with the `EarlyStopException`
control flow `engine.train` relies on.

A callback is called with a `CallbackEnv` after each iteration's
evaluation, or before the iteration when it has ``before_iteration``
set; callbacks run in the order of their ``order`` attribute.
``reset_parameter`` is left out: the JAX package's `Booster` has no
``reset_parameter`` method, so a callback that calls it fails there
(ROADMAP A.3).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    """Raised by a callback to stop training: the 0-based best iteration
    and its evaluation result list."""

    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """Record each iteration's results into ``eval_result``:
    {data name: {metric name: [values]}}."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, []).append(result)
    _callback.order = 20
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no validation result has improved for
    ``stopping_rounds`` iterations (reference callback.py:174-236): the
    train set's own results never stop training; with
    ``first_metric_only`` only the first metric does; off under DART.
    It takes `cv`'s 5-field results too, which the JAX package's raises
    on (ROADMAP C.33)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            if verbose:
                print("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            print(f"Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds.")
        first_metric[0] = env.evaluation_result_list[0][1]
        for entry in env.evaluation_result_list:
            bigger_better = entry[3]
            best_iter.append(0)
            best_score_list.append(None)
            if bigger_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _stop(i: int, msg: str) -> None:
        if verbose:
            print(f"{msg}\n[{best_iter[i] + 1}]\t"
                  + "\t".join(_format_eval_result(x)
                              for x in best_score_list[i]))
        raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            # a result is (data, metric, value, bigger_is_better), and
            # cv's has its standard deviation fifth
            data_name, eval_name, score = env.evaluation_result_list[i][:3]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != eval_name:
                continue
            if data_name == "cv_agg" or env.model is None \
                    or data_name != env.model.name_train_set:
                if env.iteration - best_iter[i] >= stopping_rounds:
                    _stop(i, "Early stopping, best iteration is:")
                if env.iteration == env.end_iteration - 1:
                    _stop(i, "Did not meet early stopping. Best iteration "
                          "is:")
    _callback.order = 30
    return _callback
