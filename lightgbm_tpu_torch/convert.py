"""Carry a model trained by the JAX package into the port.

A GBDT's weights are its trees. `from_reference` builds a port
`Booster` from either the model text the JAX package writes
(``Booster.model_to_string()``) or the numpy arrays of its trees, so the
same model can be scored by both packages.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .basic import Booster
from .config import Config
from .models.model_text import save_model_to_string
from .models.tree import Tree

# per-node and per-leaf arrays of a `Tree` (lightgbm_tpu/models/tree.py)
NODE_FIELDS = ("split_feature", "split_feature_inner", "split_gain",
               "threshold", "threshold_in_bin", "decision_type",
               "left_child", "right_child", "internal_value",
               "internal_count", "node_default_bin", "node_num_bin")
LEAF_FIELDS = ("leaf_value", "leaf_count")
REQUIRED_FIELDS = ("num_leaves", "split_feature", "threshold",
                   "decision_type", "left_child", "right_child",
                   "leaf_value")


def tree_arrays(tree) -> Dict[str, object]:
    """The arrays of one tree object (of either package), trimmed to its
    live nodes and leaves."""
    nl = int(tree.num_leaves)
    out: Dict[str, object] = {"num_leaves": nl,
                              "shrinkage": float(tree.shrinkage),
                              "cat_boundaries": list(tree.cat_boundaries),
                              "cat_threshold": list(tree.cat_threshold)}
    for k in NODE_FIELDS:
        out[k] = np.asarray(getattr(tree, k))[:max(nl - 1, 0)].copy()
    for k in LEAF_FIELDS:
        out[k] = np.asarray(getattr(tree, k))[:nl].copy()
    return out


def tree_from_arrays(d: Dict[str, object]) -> Tree:
    """A port `Tree` from the arrays of one tree (`tree_arrays` layout;
    only `REQUIRED_FIELDS` must be present)."""
    missing = [k for k in REQUIRED_FIELDS if k not in d]
    if missing:
        raise ValueError(f"tree arrays lack {missing}")
    nl = int(d["num_leaves"])
    t = Tree(max(nl, 2))
    t.num_leaves = nl
    m = max(nl - 1, 0)
    for k in NODE_FIELDS:
        if k in d:
            getattr(t, k)[:m] = np.asarray(d[k])[:m]
    if "split_feature_inner" not in d:
        t.split_feature_inner[:m] = t.split_feature[:m]
    for k in LEAF_FIELDS:
        if k in d:
            getattr(t, k)[:nl] = np.asarray(d[k])[:nl]
    t.cat_boundaries = [int(x) for x in d.get("cat_boundaries", [0])]
    t.cat_threshold = [int(x) for x in d.get("cat_threshold", [])]
    t.num_cat = len(t.cat_boundaries) - 1
    t.shrinkage = float(d.get("shrinkage", 1.0))
    for node in range(m):
        for ch in (t.left_child[node], t.right_child[node]):
            if ch < 0:
                t.leaf_parent[~ch] = node
    return t


def from_reference(model_str: Optional[str] = None,
                   arrays: Optional[Dict[str, object]] = None,
                   params: Optional[Dict] = None) -> Booster:
    """Port Booster from a JAX-package model.

    model_str: the text of ``lightgbm_tpu.Booster.model_to_string()``.
    arrays: ``{"trees": [tree_arrays(t) for t in booster.trees],
    "objective": "binary sigmoid:1", "num_tree_per_iteration": 1,
    "feature_names": [...]}`` (objective defaults to ``regression``; a
    K-class model's ``num_tree_per_iteration`` is K, its trees in
    iteration order, class by class).
    params: runtime params of the port Booster, e.g.
    ``{"device_type": "cpu"}``.
    """
    if (model_str is None) == (arrays is None):
        raise ValueError("pass exactly one of model_str and arrays")
    if model_str is not None:
        return Booster(params=params, model_str=model_str)
    trees = [tree_from_arrays(d) for d in arrays["trees"]]
    objective = str(arrays.get("objective", "regression"))
    names = list(arrays.get("feature_names") or [])
    max_idx = max([len(names) - 1]
                  + [int(np.max(t.split_feature[:t.num_leaves - 1]))
                     for t in trees if t.num_leaves > 1])
    names = names or [f"Column_{i}" for i in range(max_idx + 1)]
    ntpi = int(arrays.get("num_tree_per_iteration", 1))
    cfg = Config.from_params({"objective": objective.split(" ")[0],
                              "num_class": ntpi, "device_type": "cpu"})
    text = save_model_to_string(trees, cfg, ntpi, max_idx, names,
                                objective_string=objective)
    return Booster(params=params, model_str=text)
