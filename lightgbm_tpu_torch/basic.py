"""Public Dataset / Booster (port of lightgbm_tpu/basic.py: dense,
scipy CSR/CSC and pandas input and data files, row subsets, column
merges and the binary dataset file; every objective; gbdt, goss, dart
and rf boosting).

A `Dataset` takes a matrix, a DataFrame (its ``category`` columns
categorical, their categories kept in the model text as
``pandas_categorical``) or a path: a text file (CSV, TSV, space or
LibSVM, with its sidecars; `io/loader.py`) or a binary dataset file of
either package. `Booster.predict` walks the trees on the run's device
(``cuda`` unless the params ask for ``device_type=cpu``), over a matrix
or a data file, and gives SHAP values on the host with ``pred_contrib``
(`ops/shap.py`); `model_to_string` writes the JAX package's model text,
and a Booster loads model text written by either package. `refit`,
`rollback_one_iter`, `dump_model`, `feature_importance` and pickling
follow the JAX package's `Booster`. pandas is never imported here: a
frame is read through its own methods.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .config import Config, _to_bool, resolve_device
from .io.dataset import Dataset as _CoreDataset
from .io.dataset import Metadata
from .models.boosting_variants import create_boosting
from .models.gbdt import GBDT
from .models.model_text import (_feature_infos, dump_model_json,
                                load_model_from_string, save_model_to_string)
from .models.tree import Tree
from .ops.objectives import create_objective
from .ops.predict import flatten_forest, predict_raw_values


class LightGBMError(Exception):
    pass


def _is_sparse(data) -> bool:
    """A scipy sparse matrix (CSR, CSC, ...)."""
    return hasattr(data, "tocsc") and not isinstance(data, np.ndarray)


def _is_pandas(data) -> bool:
    """A DataFrame, known by its ``columns`` (pandas is not imported)."""
    return hasattr(data, "columns") and hasattr(data, "values")


def _to_matrix(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data if data.dtype in (np.float32, np.float64) \
            else data.astype(np.float64)
    if isinstance(data, (list, tuple)):
        return np.asarray(data, np.float64)
    if _is_pandas(data):
        return _data_from_pandas(data)[0]
    raise LightGBMError(f"Cannot convert data of type {type(data)} (the "
                        "port takes numpy matrices, scipy sparse ones and "
                        "pandas DataFrames)")


def _data_from_pandas(df, pandas_categorical=None):
    """DataFrame -> (matrix, feature names, categorical columns, their
    categories), as the JAX package reads it (basic.py:95-135, after the
    reference basic.py:255-298): a ``category`` column becomes its codes
    (NaN, code -1, is missing), an ``object`` column raises, and the
    column names become the feature names. With ``pandas_categorical``
    (the training frame's category lists, in categorical-column order)
    the codes are taken against those categories, so a frame with other
    categories predicts as the training frame did. Under pandas 3 a
    string column has the ``str`` dtype, not ``object``, and raises
    numpy's ValueError on its conversion to float, as in the JAX package
    (ROADMAP C.39)."""
    feature_names = [str(c) for c in df.columns]
    cat_cols = []
    cat_categories = []
    arrs = []
    cat_i = 0
    for i, col in enumerate(df.columns):
        s = df[col]
        if str(s.dtype) == "category":
            cat_cols.append(i)
            if pandas_categorical is not None:
                if cat_i >= len(pandas_categorical):
                    raise LightGBMError(
                        "train and predict DataFrames have different "
                        "numbers of categorical columns")
                s = s.cat.set_categories(list(pandas_categorical[cat_i]))
            cat_categories.append([c for c in s.cat.categories])
            cat_i += 1
            codes = s.cat.codes.to_numpy().astype(np.float64)
            arrs.append(np.where(codes < 0, np.nan, codes))
        elif s.dtype == object:
            raise LightGBMError(
                f"DataFrame.dtypes for column {col} must be int, float or "
                "bool (or category)")
        else:
            arrs.append(s.to_numpy().astype(np.float64))
    return np.column_stack(arrs) if arrs else np.empty((len(df), 0)), \
        feature_names, cat_cols, cat_categories


def _threshold_l1(s: np.ndarray, l1: float) -> np.ndarray:
    """The l1-thresholded gradient sums of refit (JAX package:
    `threshold_l1_host`)."""
    return np.sign(s) * np.maximum(np.abs(s) - l1, 0.0)


class Dataset:
    """Lazily-constructed dataset (reference basic.py:600+)."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int]] = "auto",
                 params: Optional[Dict] = None,
                 free_raw_data: bool = True) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._handle: Optional[_CoreDataset] = None
        self.used_indices: Optional[np.ndarray] = None
        self.pandas_categorical = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        ref = (self.reference.construct()._handle
               if self.reference is not None else None)
        if self.used_indices is not None:
            # a subset of the (constructed) reference: one gather of its
            # device bins, the mappers shared (JAX package: basic.py:167)
            self._handle = ref.subset(self.used_indices)
            if self.label is not None:
                self._handle.metadata.set_label(self.label)
            if self.group is not None:
                self._handle.metadata.set_group(self.group)
            return self
        cfg = Config.from_params(self.params)
        if isinstance(self.data, str):
            return self._construct_from_file(cfg, ref)
        names = (None if self.feature_name in ("auto", None)
                 else list(self.feature_name))
        raw_cats = (None if self.categorical_feature in ("auto", None)
                    else list(self.categorical_feature))
        # a DataFrame: its columns' names and its category columns, unless
        # given (JAX package: basic.py:215-222); CSR/CSC stays sparse
        # (`from_sparse`; basic.py:213-247); a dense matrix streams a
        # chunk at a time with ``tpu_stream_chunk_rows`` > 0
        # (`io/stream.py`: the same sample draw, so the same bins)
        sparse_in = _is_sparse(self.data)
        if _is_pandas(self.data):
            mat, pd_names, pd_cats, pd_categories = \
                _data_from_pandas(self.data)
            if names is None:
                names = pd_names
            if raw_cats is None and pd_cats:
                raw_cats = pd_cats
            self.pandas_categorical = pd_categories or None
        else:
            mat = self.data if sparse_in else _to_matrix(self.data)
        cats = None
        if raw_cats is not None:
            cats = []
            for c in raw_cats:
                if isinstance(c, str):
                    if names is None or c not in names:
                        raise LightGBMError(
                            f"Unknown categorical feature name: {c!r}")
                    cats.append(names.index(c))
                else:
                    cats.append(int(c))
        if not sparse_in and int(cfg.tpu_stream_chunk_rows) > 0:
            from .io.stream import stream_matrix as maker
        else:
            maker = (_CoreDataset.from_sparse if sparse_in
                     else _CoreDataset.from_matrix)
        self._handle = maker(
            mat,
            label=self.label, config=cfg,
            weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names,
            categorical_feature=cats, reference=ref,
            device=resolve_device(cfg))
        if self.free_raw_data:
            self.data = None
        return self

    def _construct_from_file(self, cfg: Config, ref) -> "Dataset":
        """A path (JAX package: basic.py:178-208): the constructor's
        categorical_feature folds into the config spec the loader reads;
        the labels, weights, groups and init scores given here override
        the file's."""
        if self.categorical_feature not in ("auto", None):
            cats = list(self.categorical_feature)
            if any(isinstance(c, str) for c in cats):
                cfg.categorical_feature = "name:" + ",".join(
                    str(c) for c in cats)
            else:
                cfg.categorical_feature = ",".join(str(int(c)) for c in cats)
        from .io.loader import DatasetLoader
        loader = DatasetLoader(cfg, device=resolve_device(cfg))
        if ref is not None:
            self._handle = loader.load_from_file_align_with_other_dataset(
                self.data, ref)
        else:
            self._handle = loader.load_from_file(self.data)
        md = self._handle.metadata
        if self.label is not None:
            md.set_label(self.label)
        if self.weight is not None:
            md.set_weight(self.weight)
        if self.group is not None:
            md.set_group(self.group)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this dataset, sharing its bin
        mappers, built at `construct` (reference basic.py subset)."""
        ds = Dataset(None, reference=self, params=params or self.params)
        ds.used_indices = np.asarray(used_indices, np.int64)
        return ds

    def save_binary(self, filename: str) -> "Dataset":
        """Write the JAX package's binary dataset file."""
        self.construct()
        self._handle.save_binary(filename)
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes (or boundaries) of the rows, in row order."""
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(init_score)
        return self

    def get_weight(self):
        if self._handle is not None \
                and self._handle.metadata.weight is not None:
            return np.asarray(self._handle.metadata.weight)
        return self.weight

    def get_group(self):
        """Query sizes, from the constructed dataset where it has them."""
        if self._handle is not None \
                and self._handle.metadata.query_boundaries is not None:
            return np.diff(self._handle.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        return self.init_score

    def get_field(self, name: str):
        """``label``, ``weight``, ``group`` or ``init_score``."""
        return {"label": self.get_label, "weight": self.get_weight,
                "group": self.get_group,
                "init_score": self.get_init_score}[name]()

    def set_field(self, name: str, data) -> "Dataset":
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group,
                "init_score": self.set_init_score}[name](data)

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features to this dataset's columns
        (reference LGBM_DatasetAddFeaturesFrom; JAX package:
        basic.py:339-346): both constructed over the same rows, their bin
        matrices joined on their device (`io.dataset.Dataset.
        add_features_from`)."""
        self.construct()
        other.construct()
        self._handle.add_features_from(other._handle)
        return self

    @property
    def num_data(self) -> int:
        return self.construct()._handle.num_data

    @property
    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features

    def get_label(self):
        if self._handle is not None and self._handle.metadata.label is not None:
            return np.asarray(self._handle.metadata.label)
        return self.label

    def _update_params(self, params) -> "Dataset":
        self.params.update(params or {})
        return self


class Booster:
    """reference basic.py:1578 Booster."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._gbdt: Optional[GBDT] = None
        self._loaded: Optional[Dict] = None
        self._name_valid_sets: List[str] = []
        self._train_set = train_set
        self._valid_sets_public: List[Dataset] = []
        self.name_train_set = "training"
        # the native predictor's flattened forest, keyed by the trees it
        # holds and the model's generation (bumped by each update)
        self._flat_cache: Optional[Tuple] = None
        self._model_gen = 0
        # a DataFrame's category lists, by categorical column
        self.pandas_categorical = None
        if model_file is not None:
            with open(model_file) as fh:
                self._init_from_string(fh.read())
        elif model_str is not None:
            self._init_from_string(model_str)
        elif train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set._update_params(self.params)
            train_set.construct()
            self.pandas_categorical = train_set.pandas_categorical
            self._cfg = Config.from_params(self.params)
            self.device = resolve_device(self._cfg)
            self._gbdt = create_boosting(self._cfg, train_set._handle,
                                         self.device)
        else:
            raise LightGBMError(
                "need at least one of train_set/model_file/model_str")

    def _init_from_string(self, text: str) -> None:
        for line in text.splitlines():
            if line.startswith("pandas_categorical:"):
                try:
                    self.pandas_categorical = json.loads(
                        line.split(":", 1)[1])
                except json.JSONDecodeError:
                    pass
        self._init_from_loaded(load_model_from_string(text))

    def _init_from_loaded(self, loaded: Dict) -> None:
        self._loaded = loaded
        # where the model trained says nothing about where it runs now
        params = {k: v for k, v in loaded.get("params", {}).items()
                  if k != "device_type"}
        self.params = {**params, **self.params}
        self._cfg = Config.from_params(
            {**self.params, "objective": loaded["objective"].split(" ")[0],
             "num_class": loaded.get("num_class", 1)})
        self.device = resolve_device(self._cfg)

    @property
    def trees(self) -> List[Tree]:
        if self._gbdt is not None:
            return self._gbdt.models
        return self._loaded["trees"] if self._loaded else []

    @property
    def num_tree_per_iteration(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.num_tree_per_iteration
        return self._loaded.get("num_tree_per_iteration", 1)

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data._update_params(self.params)
        data.construct()
        self._gbdt.add_valid_dataset(data._handle)
        self._name_valid_sets.append(name)
        self._valid_sets_public.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration (reference basic.py:1846). Returns True
        if training finished (cannot split any more). ``fobj(preds,
        train_set) -> (grad, hess)`` takes the raw training scores ([N],
        [N, K] for K classes) and gives the iteration's gradients; the
        aligned engine is left first, as it cannot follow the tree (JAX
        package: basic.py:466-492)."""
        self._model_gen += 1
        if fobj is None:
            return self._gbdt.train_one_iter()
        gbdt = self._gbdt
        gbdt.drop_aligned()
        scores = gbdt.train_score.numpy()
        k = self.num_tree_per_iteration
        grad, hess = fobj(scores[0] if k == 1 else scores.T,
                          self._train_set)
        return gbdt.train_one_iter(np.asarray(grad, np.float32).reshape(k, -1),
                                   np.asarray(hess, np.float32).reshape(k, -1))

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees and their scores
        (`GBDT.rollback_one_iter`); the next `predict` rebuilds its
        flattened forest."""
        self._gbdt.rollback_one_iter()
        self._model_gen += 1
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              leaf_preds=None, **kwargs) -> "Booster":
        """Refit the trees' leaf outputs to new data (reference
        basic.py:2337 -> `GBDT::RefitTree` gbdt.cpp:297-320; JAX package:
        basic.py:508-561): ``leaf = decay_rate * old + (1 - decay_rate) *
        new * shrinkage``, ``new`` the closed-form output of the new rows'
        gradient sums in each leaf, iteration by iteration from the
        refitted scores. The leaf indices come from the predictor (every
        tree, whatever ``best_iteration``) and the gradients from the
        objective on the booster's device; the sums are f64 on the host,
        `np.bincount` in the JAX package's order, so that the leaves keep
        its bits. The trees change in place."""
        import torch
        trees = self.trees
        if not trees:
            raise LightGBMError("No trees to refit")
        X = (np.asarray(data.toarray(), np.float64) if _is_sparse(data)
             else _to_matrix(data))
        label = np.asarray(label, np.float64).reshape(-1)
        n = len(X)
        k = self.num_tree_per_iteration
        if leaf_preds is None and self.device.type == "cpu":
            leaf_preds = self._predict_native(trees, X, k, 0, True, None)
        if leaf_preds is None:
            leaf_preds = predict_raw_values(trees, X, leaf_index=True,
                                            device=self.device, num_class=k)
        leaf_preds = np.asarray(leaf_preds, np.int64).reshape(n, len(trees))
        cfg = self._cfg
        objective = create_objective(cfg)
        if objective is None:
            raise LightGBMError("Cannot refit due to null objective function.")
        md = Metadata(n)
        md.set_label(label)
        objective.init(md, n, self.device)
        scores = np.zeros((k, n), np.float64)
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        mds = cfg.max_delta_step
        for it in range(len(trees) // k):
            g, h = objective.get_gradients(torch.as_tensor(
                scores.astype(np.float32), device=self.device))
            g = g.cpu().numpy().astype(np.float64)
            h = h.cpu().numpy().astype(np.float64)
            for tid in range(k):
                tree = trees[it * k + tid]
                lp = leaf_preds[:, it * k + tid]
                nl = tree.num_leaves
                sg = np.bincount(lp, weights=g[tid], minlength=nl)[:nl]
                sh = np.bincount(lp, weights=h[tid], minlength=nl)[:nl]
                out = -_threshold_l1(sg, l1) / (sh + l2 + 1e-15)
                if mds > 0:
                    out = np.clip(out, -mds, mds)
                new_vals = (decay_rate * tree.leaf_value[:nl]
                            + (1.0 - decay_rate) * out * tree.shrinkage)
                tree.leaf_value[:nl] = new_vals
                scores[tid] += new_vals[lp]
        self._model_gen += 1
        return self

    @property
    def current_iteration(self) -> int:
        return self._gbdt.iter if self._gbdt else \
            len(self.trees) // max(1, self.num_tree_per_iteration)

    def num_trees(self) -> int:
        return len(self.trees)

    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def eval_train(self):
        return self._gbdt.eval_train()

    def eval_valid(self):
        out = []
        for name, m, v, b in self._gbdt.eval_valid():
            i = int(name.split("_")[-1])
            if i < len(self._name_valid_sets):
                name = self._name_valid_sets[i]
            out.append((name, m, v, b))
        return out

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                **kwargs) -> np.ndarray:
        """Predictions for a dense or scipy sparse matrix [N, F_total]:
        probabilities (or the objective's output transform) unless
        ``raw_score``, [N] for one class and [N, K] for K; leaf indices
        [N, T] with ``pred_leaf``. ``start_iteration`` and
        ``num_iteration`` count iterations of K trees. A sparse matrix is
        made dense a block of rows at a time, under 256 MB of f64 a block
        (the reference's LGBM_BoosterPredictForCSR; JAX package:
        basic.py:658-670). A path predicts a data file's rows (reference
        LGBM_BoosterPredictForFile; ``header`` / ``data_has_header`` in
        the keyword arguments), read as `_read_predict_file` reads it.
        ``pred_early_stop`` (with ``pred_early_stop_freq`` and
        ``pred_early_stop_margin``, in the keyword arguments or the
        params) stops a row's trees early (`_early_stop`). A booster on
        the CPU predicts through the native predictor where the library
        builds, one on the card by the torch traversal. ``pred_contrib``
        gives SHAP values [N, F + 1] ([N, K (F + 1)] for K classes), the
        expected value last, on the host (`ops/shap.py`). A DataFrame's
        category codes are taken against the training frame's categories
        (``pandas_categorical``)."""
        if isinstance(data, str):
            data = self._read_predict_file(data, kwargs)
        if _is_sparse(data):
            csr = data.tocsr()
            rows_per = max(1, (256 << 20) // (8 * max(1, csr.shape[1])))
            return np.concatenate([
                self.predict(csr[lo:lo + rows_per].toarray(), num_iteration,
                             raw_score, pred_leaf, pred_contrib,
                             start_iteration=start_iteration, **kwargs)
                for lo in range(0, max(csr.shape[0], 1), rows_per)], axis=0)
        if self.pandas_categorical and _is_pandas(data):
            X = _data_from_pandas(data, self.pandas_categorical)[0]
        else:
            X = _to_matrix(data)
        k = self.num_tree_per_iteration
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        s_iter = max(int(start_iteration or 0), 0)
        trees = self.trees[s_iter * k:]
        if num_iteration > 0:
            trees = trees[:num_iteration * k]
        if pred_contrib and not pred_leaf:
            from .ops.shap import predict_contrib
            return predict_contrib(trees, X, k)
        early_stop = self._early_stop(kwargs, raw_score, pred_leaf)
        raw = (self._predict_native(trees, X, k, s_iter, pred_leaf,
                                    early_stop)
               if self.device.type == "cpu" and trees else None)
        if raw is None:
            raw = predict_raw_values(trees, X, leaf_index=pred_leaf,
                                     device=self.device, num_class=k,
                                     early_stop=early_stop)
        if pred_leaf:
            return raw.astype(np.int32)
        if self._is_average_output():
            raw = raw / max(1, len(trees) // k)
        if raw_score:
            return raw
        # an objective the port lacks raises here rather than returning
        # raw margins in place of its transformed output
        objective = (self._gbdt.objective if self._gbdt is not None
                     else create_objective(self._cfg))
        if objective is None:
            return raw
        if k > 1 and objective.name != "multiclass":
            return np.stack([objective.convert_output(raw[:, c])
                             for c in range(k)], axis=1)
        return objective.convert_output(raw)

    def _early_stop(self, kwargs: Dict, raw_score: bool,
                    pred_leaf: bool) -> Optional[Tuple[int, float]]:
        """(freq in trees, margin) of prediction early stopping, or None
        (JAX package: basic.py:689-694, 761-776): ``pred_early_stop``
        from the keyword arguments or the params, on only for a binary
        objective or K > 1 classes, and off with ``raw_score`` and
        ``pred_leaf``; ``pred_early_stop_freq`` counts iterations of K
        trees. The params' strings are read as the config reads them (a
        model file's ``[pred_early_stop: False]`` is false; ROADMAP
        C.37)."""
        opts = {**self.params, **kwargs}
        k = self.num_tree_per_iteration
        if not (_to_bool(opts.get("pred_early_stop", False))
                and not raw_score and not pred_leaf
                and (k > 1 or self._cfg.objective == "binary")):
            return None
        return (int(float(opts.get("pred_early_stop_freq", 10))) * k,
                float(opts.get("pred_early_stop_margin", 10.0)))

    def _predict_native(self, trees: List[Tree], X: np.ndarray, k: int,
                        s_iter: int, pred_leaf: bool,
                        early_stop) -> Optional[np.ndarray]:
        """A CPU booster's prediction through the native predictor
        (`native.predict_forest`, the JAX package's CPU route, early
        stopping inside it): raw scores [N] or [N, K], or leaf indices;
        None without the library. The flattened forest is cached, keyed
        as the JAX package keys it."""
        from . import native
        if not native.native_available():
            return None
        key = (len(trees), k, s_iter, self._model_gen)
        if self._flat_cache is not None and self._flat_cache[0] == key:
            flat = self._flat_cache[1]
        else:
            flat = flatten_forest(trees, k)
            self._flat_cache = (key, flat)
        if X.shape[1] <= int(flat["feat"].max(initial=-1)):
            raise ValueError(
                f"data has {X.shape[1]} features but the model was trained "
                f"with at least {int(flat['feat'].max()) + 1}")
        freq, margin = early_stop if early_stop is not None else (0, 0.0)
        return native.predict_forest(X, flat, k, pred_leaf, freq, margin)

    def _read_predict_file(self, path: str, kwargs: Dict) -> np.ndarray:
        """The feature matrix of a data file to predict (JAX package:
        basic.py:595-640): a file whose column count equals the model's
        feature count has no label column (reference predictor.hpp:185),
        with a warning where its first column looks like a label; LibSVM
        rows missing trailing features read them as zero."""
        from .io.file_io import open_file
        from .io.loader import DatasetLoader
        from .utils import log
        cfg = Config.from_params({**self.params, **kwargs})
        cfg.header = bool(kwargs.get("data_has_header",
                                     kwargs.get("header", cfg.header)))
        nf_model = (self._gbdt.train_data.num_total_features
                    if self._gbdt is not None else
                    self._loaded.get("max_feature_idx", -2) + 1)
        with open_file(path, errors="replace") as f:
            if cfg.header:
                f.readline()
            first = f.readline()
        ncols = 0
        if first.strip():
            if ":" in first and "," not in first:
                ncols = -1          # libsvm: sparse, keep default
            else:
                for sep in ("\t", ",", " "):
                    if sep in first:
                        ncols = len(first.rstrip("\r\n").split(sep))
                        break
        if ncols == nf_model:
            cfg.label_column = "-1"
            try:
                tok = first.replace("\t", ",").replace(" ", ",") \
                    .split(",")[0]
                v = float(tok)
                if np.isfinite(v) and v == int(v) and 0 <= v <= 100:
                    log.warning(
                        f"treating {path!r} as label-free because its "
                        f"column count ({ncols}) equals the model's "
                        f"feature count, but the first column looks "
                        f"label-like; if this file HAS labels, the "
                        f"features are mis-aligned — score a file "
                        f"with {nf_model + 1} columns or strip the "
                        f"label column")
            except ValueError:
                pass
        _, feats, _ex = DatasetLoader(cfg, device=self.device).parse_file(
            path)
        if ncols == -1 and nf_model > 0 and feats.shape[1] < nf_model:
            feats = np.pad(feats, ((0, 0), (0, nf_model - feats.shape[1])))
        return feats

    def _is_average_output(self) -> bool:
        """An RF model averages its trees: one this booster trained, or
        one whose model text says ``average_output``."""
        if self._loaded is not None:
            return bool(self._loaded.get("average_output"))
        return self._cfg.boosting == "rf"

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: int = -1) -> str:
        """The JAX package's model text; a DataFrame's category lists
        follow it on a ``pandas_categorical:`` line (basic.py:843-850)."""
        if self._gbdt is not None:
            ds = self._gbdt.train_data
            out = save_model_to_string(
                self._gbdt.models, self._cfg, self.num_tree_per_iteration,
                ds.num_total_features - 1, ds.feature_names,
                _feature_infos(ds.mappers), num_iteration,
                self._objective_string(self._gbdt.objective))
        else:
            fn = self._loaded.get("feature_names") or []
            out = save_model_to_string(
                self._loaded["trees"], self._cfg,
                self._loaded.get("num_tree_per_iteration", 1),
                self._loaded.get("max_feature_idx", max(len(fn) - 1, 0)),
                fn, self._loaded.get("feature_infos"), num_iteration,
                self._loaded.get("objective", ""))
        if self.pandas_categorical:
            try:
                out += "\npandas_categorical:" + json.dumps(
                    self.pandas_categorical) + "\n"
            except TypeError:
                pass
        return out

    @staticmethod
    def _objective_string(obj) -> str:
        """The model text's objective line (JAX package:
        basic.py:853-863)."""
        if obj is None:
            return ""
        extras = {
            "binary": lambda o: f" sigmoid:{o.cfg.sigmoid}",
            "multiclass": lambda o: f" num_class:{o.num_class}",
            "multiclassova": lambda o:
                f" num_class:{o.num_class} sigmoid:{o.cfg.sigmoid}",
        }
        return obj.name + extras.get(obj.name, lambda o: "")(obj)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as JSON-ready dicts (`dump_model_json`)."""
        if self._gbdt is not None:
            ds = self._gbdt.train_data
            return dump_model_json(
                self._gbdt.models, self._cfg, self.num_tree_per_iteration,
                ds.num_total_features - 1, ds.feature_names, num_iteration,
                self._objective_string(self._gbdt.objective))
        fn = self._loaded.get("feature_names") or []
        return dump_model_json(
            self._loaded["trees"], self._cfg,
            self._loaded.get("num_tree_per_iteration", 1),
            self._loaded.get("max_feature_idx", max(len(fn) - 1, 0)),
            fn, num_iteration, self._loaded.get("objective", ""))

    # ------------------------------------------------------------------
    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """Splits (``split``) or summed split gains (``gain``) of each
        feature over the first ``iteration`` iterations, or all
        (reference basic.py:2410+)."""
        if self._gbdt is not None:
            nf = self._gbdt.train_data.num_total_features
        else:
            nf = self._loaded.get("max_feature_idx", 0) + 1
        imp = np.zeros(nf)
        trees = self.trees
        if iteration and iteration > 0:
            trees = trees[:iteration * self.num_tree_per_iteration]
        for t in trees:
            for node in range(t.num_leaves - 1):
                f = t.split_feature[node]
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += t.split_gain[node]
        return imp

    def feature_name(self) -> List[str]:
        if self._gbdt is not None:
            return list(self._gbdt.train_data.feature_names)
        return list(self._loaded.get("feature_names") or [])

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of a feature's numerical split thresholds over every
        tree (reference basic.py:2470+): (hist, bin_edges), or with
        ``xgboost_style`` the (SplitValue, Count) rows of the non-empty
        bins, a DataFrame where pandas imports, else an array."""
        if isinstance(feature, str):
            names = self.feature_name()
            if feature not in names:
                raise LightGBMError(f"Unknown feature name {feature}")
            feature = names.index(feature)
        values = []
        for t in self.trees:
            for node in range(max(t.num_leaves - 1, 0)):
                if t.split_feature[node] == feature \
                        and not t.node_is_categorical(node):
                    values.append(float(t.threshold[node]))
        values = np.asarray(values, np.float64)
        if bins is None or (isinstance(bins, int)
                            and bins > len(np.unique(values))):
            bins = max(len(np.unique(values)), 1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            try:
                import pandas as pd
            except ImportError:
                return ret
            return pd.DataFrame(ret, columns=["SplitValue", "Count"])
        return hist, bin_edges

    def free_dataset(self) -> "Booster":
        return self

    # ------------------------------------------------------------------
    # copies and pickling go through the model text (JAX package:
    # basic.py:963-990), with the params, so the copy runs where the
    # original did
    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        clone = Booster(params=copy.deepcopy(self.params, memo),
                        model_str=self.model_to_string())
        clone.best_iteration = self.best_iteration
        clone.best_score = copy.deepcopy(self.best_score, memo)
        clone.params = copy.deepcopy(self.params, memo)
        clone.name_train_set = self.name_train_set
        return clone

    def __getstate__(self):
        return {"model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "params": self.params,
                "name_train_set": self.name_train_set}

    def __setstate__(self, state):
        self.__init__(params=dict(state.get("params", {})),
                      model_str=state["model_str"])
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self.params = state.get("params", {})
        self.name_train_set = state.get("name_train_set", "training")
