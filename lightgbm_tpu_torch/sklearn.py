"""scikit-learn estimator wrappers (port of lightgbm_tpu/sklearn.py).

Re-creates `python-package/lightgbm/sklearn.py`: `LGBMModel` base +
`LGBMRegressor` / `LGBMClassifier` / `LGBMRanker`, with fit/predict,
eval sets, early stopping, feature importances, and sklearn get/set_params
compatibility. scikit-learn is optional: without it the estimators
derive from ``object`` and still fit and predict (through `engine.train`
on the run's device, ``cuda`` unless ``device_type=cpu`` is among their
keyword arguments), with no input validation.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train

try:
    from sklearn.base import BaseEstimator as _SKBase
    from sklearn.base import ClassifierMixin as _SKClassifier
    from sklearn.base import RegressorMixin as _SKRegressor
    _HAS_SKLEARN = True
except Exception:  # pragma: no cover - sklearn optional
    _SKBase = object

    class _SKClassifier:  # type: ignore
        pass

    class _SKRegressor:  # type: ignore
        pass
    _HAS_SKLEARN = False

# the conformance validation helpers need sklearn >= 1.6 (validate_data
# with ensure_all_finite); older versions keep the permissive pre-1.6
# behavior rather than crashing every fit/predict
try:
    from sklearn.utils.validation import validate_data as _sk_validate_data
except Exception:  # pragma: no cover - old sklearn
    _sk_validate_data = None


class _ObjectiveFunctionWrapper:
    """Wrap sklearn-style fobj(y_true, y_pred) into engine fobj
    (reference sklearn.py:33-110)."""

    def __init__(self, func: Callable) -> None:
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 "
                            f"arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Wrap sklearn-style feval (reference sklearn.py:112-185)."""

    def __init__(self, func: Callable) -> None:
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        return self.func(labels, preds)


class LGBMModel(_SKBase):
    """Base sklearn estimator (reference sklearn.py:187+)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, importance_type: str = "split",
                 **kwargs: Any) -> None:
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration = -1
        self._n_features = -1
        self._classes = None
        self._n_classes = -1
        self._objective = objective
        self._fobj = None

    # sklearn plumbing ---------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves, "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "silent": self.silent, "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            self._other_params[key] = value
        return self

    # sklearn conformance (check_estimator; reference
    # tests/python_package_test/test_sklearn.py:202) ---------------------
    def __sklearn_is_fitted__(self) -> bool:
        return self._Booster is not None

    if _HAS_SKLEARN:
        def __sklearn_tags__(self):
            tags = super().__sklearn_tags__()
            tags.input_tags.allow_nan = True    # NaN = missing value
            tags.input_tags.sparse = True       # CSR/CSC ingest
            return tags

    def _sk_validate_fit(self, X, y, classifier: bool = False):
        """sklearn-style input validation (sets n_features_in_, rejects
        complex/empty/inf input). DataFrames skip it to preserve the
        categorical-dtype handling; y stays as given for ranking."""
        if _sk_validate_data is None or hasattr(X, "columns"):
            self.n_features_in_ = np.asarray(X).shape[1]
            return X, np.asarray(y).reshape(-1)
        X, y = _sk_validate_data(self, X, y,
                                 accept_sparse=["csr", "csc"],
                                 ensure_all_finite="allow-nan",
                                 dtype=np.float64, multi_output=False)
        if classifier:
            from sklearn.utils.multiclass import check_classification_targets
            check_classification_targets(y)
        return X, y

    def _sk_validate_predict(self, X):
        if not _HAS_SKLEARN:
            return X
        from sklearn.exceptions import NotFittedError
        if self._Booster is None:
            raise NotFittedError(
                "This estimator is not fitted yet. Call 'fit' first.")
        if _sk_validate_data is None or hasattr(X, "columns") \
                or isinstance(X, str):
            return X
        return _sk_validate_data(self, X, accept_sparse=["csr", "csc"],
                                 ensure_all_finite="allow-nan",
                                 dtype=np.float64, reset=False)

    # ------------------------------------------------------------------
    def _make_train_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        if callable(self.objective):
            self._fobj = _ObjectiveFunctionWrapper(self.objective)
            params["objective"] = "none"
        else:
            self._fobj = None
            params["objective"] = self._objective or "regression"
        if self.random_state is not None:
            params["seed"] = self.random_state
            params["bagging_seed"] = self.random_state
            params["feature_fraction_seed"] = self.random_state
            params["drop_seed"] = self.random_state
            params["data_random_seed"] = self.random_state
        params["verbose"] = -1 if self.silent else 1
        # alias mapping sklearn -> native
        params["bagging_fraction"] = params.pop("subsample")
        params["bagging_freq"] = params.pop("subsample_freq")
        params["feature_fraction"] = params.pop("colsample_bytree")
        params["lambda_l1"] = params.pop("reg_alpha")
        params["lambda_l2"] = params.pop("reg_lambda")
        params["min_gain_to_split"] = params.pop("min_split_gain")
        params["min_sum_hessian_in_leaf"] = params.pop("min_child_weight")
        params["min_data_in_leaf"] = params.pop("min_child_samples")
        params["bin_construct_sample_cnt"] = params.pop("subsample_for_bin")
        params["boosting"] = params.pop("boosting_type")
        params.pop("random_state", None)
        params.pop("n_jobs", None)
        return params

    def _sample_weight_with_class_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        classes, counts = np.unique(y, return_counts=True)
        if self.class_weight == "balanced":
            wmap = {c: len(y) / (len(classes) * cnt)
                    for c, cnt in zip(classes, counts)}
        else:
            wmap = dict(self.class_weight)
        cw = np.asarray([wmap.get(v, 1.0) for v in y], np.float64)
        if sample_weight is None:
            return cw
        return cw * np.asarray(sample_weight, np.float64)

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        params = self._make_train_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        if not getattr(self, "_sk_prevalidated", False):
            X, y = self._sk_validate_fit(X, y)
        y = np.asarray(y).reshape(-1)
        sample_weight = self._sample_weight_with_class_weight(y, sample_weight)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                vi = (eval_init_score[i]
                      if eval_init_score is not None else None)
                valid_sets.append(Dataset(
                    vx, label=np.asarray(vy).reshape(-1), weight=vw,
                    group=vg, init_score=vi, reference=train_set,
                    params=params))
        feval = (_EvalFunctionWrapper(eval_metric)
                 if callable(eval_metric) else None)
        self._evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result, verbose_eval=verbose,
            callbacks=callbacks)
        self._n_features = (X.shape[1] if hasattr(X, "shape")
                            else np.asarray(X).shape[1])
        self.n_features_in_ = self._n_features
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, start_iteration=0,
                **kwargs):
        X = self._sk_validate_predict(X)   # raises NotFittedError
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib,
                                     start_iteration=start_iteration,
                                     **kwargs)

    # properties ---------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found, need to call fit first")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def objective_(self):
        return self._objective


class LGBMRegressor(_SKRegressor, LGBMModel):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if self._objective is None:
            self._objective = "regression"

    def fit(self, X, y, **kwargs) -> "LGBMRegressor":
        super().fit(X, y, **kwargs)
        return self


class LGBMClassifier(_SKClassifier, LGBMModel):
    def fit(self, X, y, **kwargs) -> "LGBMClassifier":
        X, y = self._sk_validate_fit(X, y, classifier=True)
        self._sk_prevalidated = True
        y = np.asarray(y).reshape(-1)
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        if self._objective is None or not callable(self._objective):
            if self._n_classes > 2:
                self._objective = self.objective or "multiclass"
                self._other_params["num_class"] = self._n_classes
            else:
                self._objective = self.objective or "binary"
        # re-map eval sets' labels
        if "eval_set" in kwargs and kwargs["eval_set"] is not None:
            es = kwargs["eval_set"]
            if isinstance(es, tuple):
                es = [es]
            label_map = {c: i for i, c in enumerate(self._classes)}
            kwargs["eval_set"] = [
                (vx, np.asarray([label_map[v] for v in np.asarray(vy)]))
                for vx, vy in es]
        try:
            super().fit(X, y_enc.astype(np.float64), **kwargs)
        finally:
            self._sk_prevalidated = False
        return self

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, start_iteration=0,
                **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib,
                                    start_iteration=start_iteration,
                                    **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return self._classes[np.argmax(result, axis=1)]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False,
                      start_iteration=0, **kwargs):
        result = super().predict(X, raw_score=raw_score,
                                 num_iteration=num_iteration,
                                 pred_leaf=pred_leaf,
                                 pred_contrib=pred_contrib,
                                 start_iteration=start_iteration,
                                 **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if self._objective is None:
            self._objective = "lambdarank"

    def fit(self, X, y, group=None, eval_group=None, eval_at=(1,),
            **kwargs) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        self._other_params["eval_at"] = list(eval_at)
        super().fit(X, y, group=group, eval_group=eval_group, **kwargs)
        return self
