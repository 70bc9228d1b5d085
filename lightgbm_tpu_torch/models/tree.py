"""Decision tree model structure (copied from lightgbm_tpu/models/tree.py).

Re-creates the reference `Tree` (`include/LightGBM/tree.h`, `src/io/tree.cpp`):
array-of-nodes layout where internal nodes are numbered 0..num_leaves-2 and
leaves are referenced as `~leaf` (negative) in child links, categorical splits
as bitsets with per-node boundaries, decision_type bit packing
(kCategoricalMask=1, kDefaultLeftMask=2, missing type in bits 2-3), and the
reference's text model format (`Tree::ToString`, tree.cpp:206-239) so model
files interoperate.

Tree building happens on host (one Split per boosting step, driven by the
learner); batch prediction runs on the device (`ops/predict.py`) over
stacked tree arrays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


def _avoid_inf(x: float) -> float:
    """reference Common::AvoidInf: clamp +-inf/nan to +-1e300."""
    if math.isnan(x):
        return 0.0
    if x >= 1e300:
        return 1e300
    if x <= -1e300:
        return -1e300
    return float(x)


def construct_bitset(values: Sequence[int]) -> np.ndarray:
    """reference Common::ConstructBitset."""
    if len(values) == 0:
        return np.zeros(1, dtype=np.uint32)
    n_words = (max(values) // 32) + 1
    out = np.zeros(n_words, dtype=np.uint32)
    for v in values:
        out[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out


def find_in_bitset(bitset: np.ndarray, val: int) -> bool:
    """reference Common::FindInBitset."""
    w = val // 32
    if w >= len(bitset) or val < 0:
        return False
    return bool((int(bitset[w]) >> (val % 32)) & 1)


class Tree:
    """A single decision tree (reference tree.h:25+)."""

    def __init__(self, max_leaves: int) -> None:
        m = max(max_leaves, 2)
        self.max_leaves = m
        self.num_leaves = 1
        self.num_cat = 0
        # internal-node arrays (size max_leaves-1)
        self.left_child = np.zeros(m - 1, dtype=np.int32)
        self.right_child = np.zeros(m - 1, dtype=np.int32)
        self.split_feature_inner = np.zeros(m - 1, dtype=np.int32)
        self.split_feature = np.zeros(m - 1, dtype=np.int32)
        self.threshold_in_bin = np.zeros(m - 1, dtype=np.int32)
        self.threshold = np.zeros(m - 1, dtype=np.float64)
        self.decision_type = np.zeros(m - 1, dtype=np.int8)
        self.split_gain = np.zeros(m - 1, dtype=np.float64)
        self.internal_value = np.zeros(m - 1, dtype=np.float64)
        self.internal_count = np.zeros(m - 1, dtype=np.int32)
        # per-node binned-decision metadata (TPU addition: lets the binned
        # traversal run without dataset lookups; reference threads these from
        # FeatureGroup at predict time)
        self.node_default_bin = np.zeros(m - 1, dtype=np.int32)
        self.node_num_bin = np.zeros(m - 1, dtype=np.int32)
        # leaf arrays (size max_leaves)
        self.leaf_parent = np.zeros(m, dtype=np.int32)
        self.leaf_value = np.zeros(m, dtype=np.float64)
        self.leaf_count = np.zeros(m, dtype=np.int32)
        self.leaf_depth = np.zeros(m, dtype=np.int32)
        # categorical storage
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []          # uint32 bitset words
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []
        self.shrinkage = 1.0
        self.leaf_parent[0] = -1

    # ------------------------------------------------------------------
    def _split_common(self, leaf: int, feature: int, real_feature: int,
                      left_value: float, right_value: float, left_cnt: int,
                      right_cnt: int, gain: float) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = _avoid_inf(gain)
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.leaf_value[leaf] = left_value if not math.isnan(left_value) else 0.0
        self.leaf_value[self.num_leaves] = (right_value
                                            if not math.isnan(right_value)
                                            else 0.0)
        self.leaf_count[leaf] = left_cnt
        self.leaf_count[self.num_leaves] = right_cnt
        d = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] = d
        self.leaf_depth[self.num_leaves] = d
        return new_node

    def split(self, leaf: int, feature: int, real_feature: int,
              threshold_bin: int, threshold_double: float, left_value: float,
              right_value: float, left_cnt: int, right_cnt: int, gain: float,
              missing_type: int, default_left: bool,
              default_bin: int = 0, num_bin: int = 0) -> int:
        """Numerical split (reference tree.cpp:48-67). Returns new leaf id."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt, gain)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (missing_type & 3) << 2
        self.decision_type[node] = dt
        self.threshold_in_bin[node] = threshold_bin
        self.threshold[node] = _avoid_inf(threshold_double)
        self.node_default_bin[node] = default_bin
        self.node_num_bin[node] = num_bin
        self.num_leaves += 1
        return self.num_leaves - 1

    def split_categorical(self, leaf: int, feature: int, real_feature: int,
                          threshold_bins: Sequence[int],
                          threshold_cats: Sequence[int], left_value: float,
                          right_value: float, left_cnt: int, right_cnt: int,
                          gain: float, missing_type: int,
                          default_bin: int = 0, num_bin: int = 0) -> int:
        """Categorical split (reference tree.cpp:69-96): thresholds stored as
        bitsets over category values (outer) and bins (inner)."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt, gain)
        self.decision_type[node] = K_CATEGORICAL_MASK \
            | ((missing_type & 3) << 2)
        self.threshold_in_bin[node] = self.num_cat
        self.threshold[node] = self.num_cat
        self.node_default_bin[node] = default_bin
        self.node_num_bin[node] = num_bin
        self.num_cat += 1
        outer = construct_bitset([int(c) for c in threshold_cats])
        inner = construct_bitset([int(b) for b in threshold_bins])
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(outer))
        self.cat_threshold.extend(int(w) for w in outer)
        self.cat_boundaries_inner.append(
            self.cat_boundaries_inner[-1] + len(inner))
        self.cat_threshold_inner.extend(int(w) for w in inner)
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        """reference Tree::Shrinkage."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:self.num_leaves - 1] *= rate
        self.shrinkage *= rate

    def as_constant_tree(self, val: float) -> None:
        self.num_leaves = 1
        self.leaf_value[0] = val

    def add_bias(self, val: float) -> None:
        """Used by boost_from_average score folding (reference
        GBDT::BoostFromAverage alternative path)."""
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:self.num_leaves - 1] += val

    # ------------------------------------------------------------------
    def node_is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_CATEGORICAL_MASK)

    def node_missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def node_default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)

    # ------------------------------------------------------------------
    # text model round-trip (reference Tree::ToString tree.cpp:206-239 /
    # Tree::Tree(const char*) tree.cpp:472+)
    def to_string(self) -> str:
        nl = self.num_leaves
        lines = [f"num_leaves={nl}", f"num_cat={self.num_cat}"]

        def arr(name, a, n, fmt=str):
            lines.append(f"{name}=" + " ".join(fmt(x) for x in a[:n]))

        def fmt_f(x):
            return repr(float(x))

        arr("split_feature", self.split_feature, nl - 1)
        arr("split_gain", self.split_gain, nl - 1, fmt_f)
        arr("threshold", self.threshold, nl - 1, fmt_f)
        arr("decision_type", self.decision_type, nl - 1)
        arr("left_child", self.left_child, nl - 1)
        arr("right_child", self.right_child, nl - 1)
        arr("leaf_value", self.leaf_value, nl, fmt_f)
        arr("leaf_count", self.leaf_count, nl)
        arr("internal_value", self.internal_value, nl - 1, fmt_f)
        arr("internal_count", self.internal_count, nl - 1)
        # TPU additions required for binned traversal after load
        arr("split_feature_inner", self.split_feature_inner, nl - 1)
        arr("threshold_in_bin", self.threshold_in_bin, nl - 1)
        arr("node_default_bin", self.node_default_bin, nl - 1)
        arr("node_num_bin", self.node_num_bin, nl - 1)
        if self.num_cat > 0:
            arr("cat_boundaries", np.asarray(self.cat_boundaries),
                self.num_cat + 1)
            arr("cat_threshold", np.asarray(self.cat_threshold),
                len(self.cat_threshold))
            arr("cat_boundaries_inner", np.asarray(self.cat_boundaries_inner),
                self.num_cat + 1)
            arr("cat_threshold_inner", np.asarray(self.cat_threshold_inner),
                len(self.cat_threshold_inner))
        lines.append(f"shrinkage={repr(float(self.shrinkage))}")
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        nl = int(kv["num_leaves"])
        t = cls(max(nl, 2))
        t.num_leaves = nl
        t.num_cat = int(kv.get("num_cat", "0"))

        def geti(key, n, dtype=np.int32):
            if n <= 0 or key not in kv or not kv[key].strip():
                return np.zeros(max(n, 0), dtype=dtype)
            return np.asarray([int(x) for x in kv[key].split()], dtype=dtype)

        def getf(key, n):
            if n <= 0 or key not in kv or not kv[key].strip():
                return np.zeros(max(n, 0), dtype=np.float64)
            return np.asarray([float(x) for x in kv[key].split()],
                              dtype=np.float64)

        if nl > 1:
            t.split_feature[:nl - 1] = geti("split_feature", nl - 1)
            t.split_gain[:nl - 1] = getf("split_gain", nl - 1)
            t.threshold[:nl - 1] = getf("threshold", nl - 1)
            t.decision_type[:nl - 1] = geti("decision_type", nl - 1, np.int8)
            t.left_child[:nl - 1] = geti("left_child", nl - 1)
            t.right_child[:nl - 1] = geti("right_child", nl - 1)
            t.internal_value[:nl - 1] = getf("internal_value", nl - 1)
            t.internal_count[:nl - 1] = geti("internal_count", nl - 1)
            if "split_feature_inner" in kv:
                t.split_feature_inner[:nl - 1] = geti("split_feature_inner",
                                                      nl - 1)
                t.threshold_in_bin[:nl - 1] = geti("threshold_in_bin", nl - 1)
                t.node_default_bin[:nl - 1] = geti("node_default_bin", nl - 1)
                t.node_num_bin[:nl - 1] = geti("node_num_bin", nl - 1)
            else:
                t.split_feature_inner[:nl - 1] = t.split_feature[:nl - 1]
                # reference files carry the cat-bitset index in `threshold`
                # (tree.cpp Tree::Tree(const char*)); mirror it into
                # threshold_in_bin which the binned/_decision paths read
                cat_nodes = (t.decision_type[:nl - 1]
                             & K_CATEGORICAL_MASK) != 0
                t.threshold_in_bin[:nl - 1][cat_nodes] = \
                    t.threshold[:nl - 1][cat_nodes].astype(np.int32)
        t.leaf_value[:nl] = getf("leaf_value", nl)
        t.leaf_count[:nl] = geti("leaf_count", nl)
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
            if "cat_boundaries_inner" in kv:
                t.cat_boundaries_inner = [
                    int(x) for x in kv["cat_boundaries_inner"].split()]
                t.cat_threshold_inner = [
                    int(x) for x in kv["cat_threshold_inner"].split()]
            else:
                t.cat_boundaries_inner = list(t.cat_boundaries)
                t.cat_threshold_inner = list(t.cat_threshold)
        t.shrinkage = float(kv.get("shrinkage", "1"))
        # rebuild leaf parents/depths from child links
        if nl > 1:
            for node in range(nl - 1):
                for ch in (t.left_child[node], t.right_child[node]):
                    if ch < 0:
                        t.leaf_parent[~ch] = node
        return t
