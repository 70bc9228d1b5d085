"""Training entry points (port of lightgbm_tpu/engine.py: `train` and
`cv`).

The reference engine loop (`python-package/lightgbm/engine.py:239-267`):
the callbacks that run before an iteration, one boosting iteration, the
train set's and the validation sets' metrics and ``feval``'s values,
then the callbacks that run after it (`callback.py`: printing every
``verbose_eval`` rounds, ``evals_result``, early stopping), each group
sorted by ``order``. An `EarlyStopException` ends training and sets
``best_iteration`` (1-based) and ``best_score``. ``fobj`` trains from
custom gradients (``objective=none``). ``init_model`` (a `Booster` or a
model file of either package) continues training: its trees are
replayed onto the training scores by leaves over the binned matrix, in
the JAX package's order, boost-from-average is skipped, and the old
trees stay at the front of the model. ``learning_rates`` raises, as
its callback calls ``Booster.reset_parameter``, which the JAX package's
`Booster` lacks.

`cv` trains one booster a fold on `Dataset.subset`s of the training set,
the folds drawn with the JAX package's numpy draws (plain, stratified,
query-grouped, or the caller's ``folds``), and returns the mean and
standard deviation of each validation metric an iteration. Early
stopping reads the first four fields of its 5-field results (the JAX
package's `early_stopping` unpacks four and raises there; ROADMAP
C.33).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import EarlyStopException
from .config import Config
from .ops.predict import predict_binned_leaves

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
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List[int]] = "auto",
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
    cfg = _check_ported(params)
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    init_booster = None
    if isinstance(init_model, str):
        # only its trees are read; it runs where this run does
        init_booster = Booster(model_file=init_model,
                               params={"device_type": cfg.device_type})
    elif isinstance(init_model, Booster):
        init_booster = init_model
    booster = Booster(params=params, train_set=train_set)
    if init_booster is not None:
        _seed_from_model(booster, init_booster)
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


def _check_ported(params: Dict[str, Any]) -> Config:
    """The run's config; raises on the run options the port lacks rather
    than ignore them: tracing (ROADMAP A.9) and checkpoints (A.8)."""
    cfg = Config.from_params(params)
    if cfg.tpu_trace:
        raise NotImplementedError("tpu_trace: tracing is not ported yet "
                                  "(ROADMAP A.9)")
    if cfg.tpu_checkpoint_dir:
        raise NotImplementedError("tpu_checkpoint_dir: checkpoints are not "
                                  "ported yet (ROADMAP A.8)")
    return cfg


def _seed_from_model(booster: Booster, init_booster: Booster) -> None:
    """Continued training (reference engine.py:158-164; JAX package:
    `_seed_from_model`): the init model's trees, replayed by leaves over
    the binned training matrix onto the training scores one tree at a
    time in model order (tree i adds to class i % K, each an f32 add),
    become the initial scores; boost-from-average is skipped, and the old
    trees stay at the front of the model. A training set whose init
    scores already are the init model's raw predictions (the CLI's
    ``input_model``, as in reference application.cpp:90-93) is not
    replayed onto a second time, which the JAX package does (ROADMAP
    C.34)."""
    gbdt = booster._gbdt
    td = gbdt.train_data
    trees = init_booster.trees
    if not trees:
        return
    if not td.init_score_from_model:
        leaves = predict_binned_leaves(trees, td.bins, td.bundles)
        k = gbdt.num_tree_per_iteration
        for i, tree in enumerate(trees):
            gbdt.train_score.add_tree_by_leaves(
                leaves[i], tree.leaf_value[:tree.num_leaves], i % k)
    gbdt.train_score.has_init_score = True
    gbdt.models = list(trees) + gbdt.models


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


# ---------------------------------------------------------------------------
# cross validation (reference engine.py:283-580; JAX package: engine.py
# `cv`)
# ---------------------------------------------------------------------------
class _CVBooster:
    """The fold boosters; any other attribute is a method called on each
    of them, returning the list of their results."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """(train, test) `Dataset.subset` pairs of the folds: the caller's
    ``folds`` (an iterator of index pairs, or an object with ``split``,
    given the query of each row as ``groups``), else whole queries a fold
    when the data has groups, else stratified by label, else plain; the
    permutations are the JAX package's draws of
    ``np.random.RandomState(seed)`` in its order."""
    full_data = full_data.construct()
    num_data = full_data.num_data
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError("folds should be a generator or iterator")
        if hasattr(folds, "split"):
            group = full_data.get_group()
            if group is not None:
                flatted_group = np.repeat(
                    range(len(group)), repeats=np.asarray(group, np.int64))
            else:
                flatted_group = np.zeros(num_data, dtype=np.int64)
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label(),
                                groups=flatted_group)
    else:
        group = full_data.get_group()
        rng = np.random.RandomState(seed)
        all_idx = np.arange(num_data)
        if group is not None:
            group = np.asarray(group, np.int64)
            num_queries = len(group)
            q_perm = (rng.permutation(num_queries) if shuffle
                      else np.arange(num_queries))
            boundaries = np.concatenate([[0], np.cumsum(group)])
            folds = []
            for qf in np.array_split(q_perm, nfold):
                test_idx = np.concatenate(
                    [np.arange(boundaries[q], boundaries[q + 1])
                     for q in sorted(qf)]) if len(qf) else np.zeros(0, int)
                folds.append((np.setdiff1d(all_idx, test_idx), test_idx))
        elif stratified:
            y = np.asarray(full_data.get_label())
            test_sets: List[List[int]] = [[] for _ in range(nfold)]
            for cls in np.unique(y):
                cls_idx = np.nonzero(y == cls)[0]
                if shuffle:
                    cls_idx = cls_idx[rng.permutation(len(cls_idx))]
                for f, chunk in enumerate(np.array_split(cls_idx, nfold)):
                    test_sets[f].extend(chunk.tolist())
            folds = []
            for f in range(nfold):
                te = np.sort(np.asarray(test_sets[f], np.int64))
                folds.append((np.setdiff1d(all_idx, te), te))
        else:
            perm = (rng.permutation(num_data) if shuffle
                    else np.arange(num_data))
            folds = [(np.setdiff1d(all_idx, np.sort(c)), np.sort(c))
                     for c in np.array_split(perm, nfold)]
    return [(full_data.subset(np.sort(np.asarray(train_idx))),
             full_data.subset(np.sort(np.asarray(test_idx))))
            for train_idx, test_idx in folds]


def _agg_cv_result(raw_results):
    """The folds' results a metric: ("cv_agg", "<data> <metric>", mean,
    bigger_is_better, standard deviation) (reference
    engine.py:355-368)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = one_line[0] + " " + one_line[1]
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, [])
            cvmap[key].append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """reference engine.py:371-580: {"<data> <metric>-mean": [...],
    "-stdv": [...]} an iteration, cut at the best iteration when early
    stopping ends the run; ``return_cvbooster`` adds the fold boosters
    under "cvbooster". ``init_model``, ``feature_name`` and
    ``categorical_feature`` are taken and not used, as in the JAX
    package."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = dict(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if metrics is not None:
        params["metric"] = metrics
    cfg_obj = params.get("objective", "")
    stratified = stratified and str(cfg_obj).startswith(
        ("binary", "multiclass")) if cfg_obj else stratified

    _check_ported(params)
    train_set._update_params(params)
    folds_data = _make_n_folds(train_set, folds, nfold, params, seed,
                               stratified, shuffle)
    cvbooster = _CVBooster()
    for tr, te in folds_data:
        if fpreproc is not None:
            tr, te, tparams = fpreproc(tr, te, dict(params))
        else:
            tparams = params
        bst = Booster(params=tparams, train_set=tr)
        bst.add_valid(te, "valid")
        cvbooster.append(bst)

    results = collections.defaultdict(list)
    callbacks = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            int(early_stopping_rounds),
            bool(params.get("first_metric_only", False)),
            verbose=False))
    if isinstance(verbose_eval, bool) and verbose_eval:
        callbacks.append(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int):
        callbacks.append(callback_mod.print_evaluation(verbose_eval,
                                                       show_stdv))
    # in the order given, unsorted, as the JAX package's cv calls them
    before = [cb for cb in callbacks if getattr(cb, "before_iteration",
                                                False)]
    after = [cb for cb in callbacks if cb not in before]

    for i in range(num_boost_round):
        for cb in before:
            cb(callback_mod.CallbackEnv(cvbooster, params, i, 0,
                                        num_boost_round, None))
        raw = []
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            one = bst.eval_valid()
            if eval_train_metric:
                one = [("train " + d, m, v, b) for d, m, v, b
                       in bst.eval_train()] + one
            if feval is not None:
                one = one + _run_feval(feval, bst, "training", False,
                                       ["valid"])
            raw.append(one)
        res = _agg_cv_result(raw)
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in after:
                cb(callback_mod.CallbackEnv(cvbooster, params, i, 0,
                                            num_boost_round, res))
        except EarlyStopException as es:
            cvbooster.best_iteration = es.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
