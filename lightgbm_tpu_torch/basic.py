"""Public Dataset / Booster (port of lightgbm_tpu/basic.py: dense and
scipy CSR/CSC input, binary, L2, multiclass (softmax and one-vs-all)
and lambdarank objectives; gbdt, goss, dart and rf boosting).

`Booster.predict` walks the trees on the run's device (``cuda`` unless
the params ask for ``device_type=cpu``); `model_to_string` writes the
JAX package's model text, and a Booster loads model text written by
either package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from .config import Config, resolve_device
from .io.dataset import Dataset as _CoreDataset
from .models.boosting_variants import create_boosting
from .models.gbdt import GBDT
from .models.model_text import (_feature_infos, load_model_from_string,
                                save_model_to_string)
from .models.tree import Tree
from .ops.objectives import create_objective
from .ops.predict import predict_raw_values


class LightGBMError(Exception):
    pass


def _is_sparse(data) -> bool:
    """A scipy sparse matrix (CSR, CSC, ...)."""
    return hasattr(data, "tocsc") and not isinstance(data, np.ndarray)


def _to_matrix(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data if data.dtype in (np.float32, np.float64) \
            else data.astype(np.float64)
    if isinstance(data, (list, tuple)):
        return np.asarray(data, np.float64)
    raise LightGBMError(f"Cannot convert data of type {type(data)} (the "
                        "port takes numpy matrices and scipy sparse ones)")


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

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        ref = (self.reference.construct()._handle
               if self.reference is not None else None)
        cfg = Config.from_params(self.params)
        names = (None if self.feature_name in ("auto", None)
                 else list(self.feature_name))
        cats = (None if self.categorical_feature in ("auto", None)
                else [int(c) for c in self.categorical_feature])
        # CSR/CSC stays sparse (`from_sparse`; JAX package:
        # basic.py:213-247)
        sparse_in = _is_sparse(self.data)
        maker = (_CoreDataset.from_sparse if sparse_in
                 else _CoreDataset.from_matrix)
        self._handle = maker(
            self.data if sparse_in else _to_matrix(self.data),
            label=self.label, config=cfg,
            weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names,
            categorical_feature=cats, reference=ref,
            device=resolve_device(cfg))
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def set_group(self, group) -> "Dataset":
        """Query sizes (or boundaries) of the rows, in row order."""
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_group(group)
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
            self._cfg = Config.from_params(self.params)
            self.device = resolve_device(self._cfg)
            self._gbdt = create_boosting(self._cfg, train_set._handle,
                                         self.device)
        else:
            raise LightGBMError(
                "need at least one of train_set/model_file/model_str")

    def _init_from_string(self, text: str) -> None:
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

    @property
    def current_iteration(self) -> int:
        return self._gbdt.iter if self._gbdt else \
            len(self.trees) // max(1, self.num_tree_per_iteration)

    def num_trees(self) -> int:
        return len(self.trees)

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
                start_iteration: int = 0) -> np.ndarray:
        """Predictions for a dense or scipy sparse matrix [N, F_total]:
        probabilities (or the objective's output transform) unless
        ``raw_score``, [N] for one class and [N, K] for K; leaf indices
        [N, T] with ``pred_leaf``. ``start_iteration`` and
        ``num_iteration`` count iterations of K trees. A sparse matrix is
        made dense a block of rows at a time, under 256 MB of f64 a block
        (the reference's LGBM_BoosterPredictForCSR; JAX package:
        basic.py:658-670)."""
        if _is_sparse(data):
            csr = data.tocsr()
            rows_per = max(1, (256 << 20) // (8 * max(1, csr.shape[1])))
            return np.concatenate([
                self.predict(csr[lo:lo + rows_per].toarray(), num_iteration,
                             raw_score, pred_leaf, start_iteration)
                for lo in range(0, max(csr.shape[0], 1), rows_per)], axis=0)
        X = _to_matrix(data)
        k = self.num_tree_per_iteration
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        trees = self.trees[max(int(start_iteration or 0), 0) * k:]
        if num_iteration > 0:
            trees = trees[:num_iteration * k]
        if pred_leaf:
            return predict_raw_values(trees, X, leaf_index=True,
                                      device=self.device)
        if k == 1:
            raw = predict_raw_values(trees, X, device=self.device)
        else:
            raw = np.stack([predict_raw_values(trees[c::k], X,
                                               device=self.device)
                            for c in range(k)], axis=1)
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

    def _is_average_output(self) -> bool:
        """An RF model averages its trees: one this booster trained, or
        one whose model text says ``average_output``."""
        if self._loaded is not None:
            return bool(self._loaded.get("average_output"))
        return self._cfg.boosting == "rf"

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: int = -1) -> str:
        if self._gbdt is not None:
            ds = self._gbdt.train_data
            return save_model_to_string(
                self._gbdt.models, self._cfg, self.num_tree_per_iteration,
                ds.num_total_features - 1, ds.feature_names,
                _feature_infos(ds.mappers), num_iteration,
                self._objective_string(self._gbdt.objective))
        fn = self._loaded.get("feature_names") or []
        return save_model_to_string(
            self._loaded["trees"], self._cfg,
            self._loaded.get("num_tree_per_iteration", 1),
            self._loaded.get("max_feature_idx", max(len(fn) - 1, 0)),
            fn, self._loaded.get("feature_infos"), num_iteration,
            self._loaded.get("objective", ""))

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
