"""Model text serialization at the ensemble level (copied from
lightgbm_tpu/models/model_text.py).

Re-creates the reference `gbdt_model_text.cpp` (`SaveModelToString` `:248`,
`LoadModelFromString` `:347`, JSON `DumpModel` `:19`): a `tree`-headed text
format with ensemble metadata, per-tree blocks, feature importances and the
parameter dump, so models round-trip and remain human-diffable against
reference model files.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from .tree import Tree

# runtime knobs stay out of the serialized parameter dump: runs that
# differ only in output paths, verbosity, topology or the device they
# ran on write the same model text (the JAX package's list, plus
# device_type: under tpu_use_f64_hist a CUDA run and a CPU run grow
# bit-identical trees)
_RUNTIME_ONLY_PARAMS = frozenset({
    "tpu_checkpoint_dir", "tpu_checkpoint_freq", "tpu_snapshot_keep",
    "tpu_fault_spec", "tpu_retry_max", "tpu_retry_backoff_s",
    "tpu_trace", "tpu_trace_dir", "tpu_compile_cache_dir",
    "snapshot_freq", "output_model", "input_model", "output_result",
    "num_threads", "verbosity",
    "tpu_serve_hbm_budget_mb", "tpu_serve_max_batch_wait_ms",
    "tpu_serve_max_batch_rows", "tpu_serve_watch_interval_s",
    "tpu_serve_warm_rows", "tpu_metrics", "tpu_serve_metrics_port",
    "tpu_serve_hold_s", "tpu_serve_trace", "tpu_serve_trace_dir",
    "tpu_serve_trace_sample", "tpu_serve_trace_ring", "tpu_serve_slo_ms",
    "tpu_serve_aot_dir", "tpu_serve_compact", "tpu_serve_compact_tol",
    # network front door (serving/frontend/): admission, shedding and
    # placement shape traffic, never the model
    "tpu_serve_port", "tpu_serve_qos", "tpu_serve_shed",
    "tpu_serve_shed_high", "tpu_serve_shed_low", "tpu_serve_admit_rows",
    "tpu_serve_devices", "tpu_serve_replicas",
    "tpu_profile", "tpu_profile_every",
    "tpu_profile_capture", "tpu_debug_locks",
    # timeline + straggler/anomaly watches: observability only
    "tpu_timeline", "tpu_straggler_threshold", "tpu_straggler_rounds",
    "tpu_anomaly_factor", "tpu_anomaly_window",
    # sweep-trainer infrastructure: the fleet's model bytes must match
    # the sequential twin's regardless of how the sweep was driven
    "tpu_sweep_mode", "tpu_sweep_checkpoint_dir",
    "tpu_sweep_checkpoint_freq", "tpu_sweep_hbm_budget_mb",
    "tpu_sweep_max_fleet",
    "tree_learner", "num_machines", "is_parallel", "is_parallel_find_bin",
    "tpu_dist_devices",
    # how the matrix was ingested does not change what it binned to
    "tpu_stream_chunk_rows", "tpu_stream_shard",
    "tpu_stream_pipeline_depth",
    # where a run executes does not change the trees it grows
    "device_type"})


def _feature_infos(mappers) -> List[str]:
    out = []
    for m in mappers:
        if m.is_trivial:
            out.append("none")
        elif m.bin_type == "categorical":
            out.append(":".join(str(c) for c in m.bin_2_categorical))
        else:
            out.append(f"[{m.min_val!r}:{m.max_val!r}]")
    return out


def save_model_to_string(models: List[Tree], cfg: Config,
                         num_tree_per_iteration: int,
                         max_feature_idx: int,
                         feature_names: List[str],
                         feature_infos: Optional[List[str]] = None,
                         num_iteration: int = -1,
                         objective_string: str = "") -> str:
    """reference GBDT::SaveModelToString (gbdt_model_text.cpp:248-345)."""
    lines = ["tree", "version=v2"]
    lines.append(f"num_class={max(1, cfg.num_class)}")
    lines.append(f"num_tree_per_iteration={num_tree_per_iteration}")
    lines.append("label_index=0")
    lines.append(f"max_feature_idx={max_feature_idx}")
    lines.append(f"objective={objective_string or cfg.objective}")
    if cfg.boosting == "rf":
        lines.append("average_output")
    lines.append("feature_names=" + " ".join(feature_names))
    lines.append("feature_infos=" + " ".join(feature_infos or
                                             ["none"] * len(feature_names)))
    if num_iteration < 0:
        used = models
    else:
        used = models[:num_iteration * num_tree_per_iteration]
    lines.append("tree_sizes=" + " ".join(
        str(len(("Tree=%d\n" % i) + t.to_string()))
        for i, t in enumerate(used)))
    lines.append("")
    for i, t in enumerate(used):
        lines.append(f"Tree={i}")
        lines.append(t.to_string().rstrip("\n"))
        lines.append("")
    lines.append("end of trees")
    lines.append("")
    # split feature importance (gbdt_model_text.cpp FeatureImportance)
    imp = np.zeros(max_feature_idx + 1)
    for t in used:
        for node in range(t.num_leaves - 1):
            if t.split_gain[node] > 0:
                imp[t.split_feature[node]] += 1
    pairs = sorted([(imp[i], i) for i in range(len(imp)) if imp[i] > 0],
                   reverse=True)
    lines.append("feature importances:")
    for v, i in pairs:
        lines.append(f"{feature_names[i]}={int(v)}")
    lines.append("")
    lines.append("parameters:")
    for k, v in sorted(cfg.to_dict().items()):
        if k in _RUNTIME_ONLY_PARAMS:
            continue
        if isinstance(v, list):
            v = ",".join(str(x) for x in v)
        lines.append(f"[{k}: {v}]")
    lines.append("end of parameters")
    lines.append("")
    return "\n".join(lines)


def load_model_from_string(text: str) -> Dict:
    """reference GBDT::LoadModelFromString (gbdt_model_text.cpp:347-450).
    Returns dict with keys: trees, num_class, num_tree_per_iteration,
    max_feature_idx, feature_names, objective, average_output, params."""
    out: Dict = {"trees": [], "params": {}, "average_output": False}
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if line.startswith("Tree="):
            # collect until blank line
            j = i + 1
            block = []
            while j < n and lines[j].strip() != "":
                block.append(lines[j])
                j += 1
            out["trees"].append(Tree.from_string("\n".join(block)))
            i = j
            continue
        if line == "end of trees":
            break
        if "=" in line and not line.startswith("["):
            k, v = line.split("=", 1)
            if k == "num_class":
                out["num_class"] = int(v)
            elif k == "num_tree_per_iteration":
                out["num_tree_per_iteration"] = int(v)
            elif k == "max_feature_idx":
                out["max_feature_idx"] = int(v)
            elif k == "label_index":
                out["label_index"] = int(v)
            elif k == "objective":
                out["objective"] = v
            elif k == "feature_names":
                out["feature_names"] = v.split(" ") if v else []
            elif k == "feature_infos":
                out["feature_infos"] = v.split(" ") if v else []
        elif line == "average_output":
            out["average_output"] = True
        i += 1
    # parameters trailer
    for j in range(i, n):
        line = lines[j].strip()
        if line.startswith("[") and ":" in line and line.endswith("]"):
            k, v = line[1:-1].split(":", 1)
            out["params"][k.strip()] = v.strip()
    out.setdefault("num_class", 1)
    out.setdefault("num_tree_per_iteration", 1)
    out.setdefault("objective", "regression")
    return out


# ---------------------------------------------------------------------------
# if-else C++ codegen (reference `GBDT::SaveModelToIfElse` /
# `Tree::ToIfElse`, gbdt_model_text.cpp:64-246, tree.cpp:314-470): emits a
# standalone translation unit with one nested-if function per tree plus a
# `Predict` aggregator, for deployment without the framework.
# ---------------------------------------------------------------------------
def _tree_to_if_else(tree: Tree, idx: int) -> str:
    lines = [f"double PredictTree{idx}(const double* arr) {{"]
    cat_decls = []
    for ci in range(len(tree.cat_boundaries) - 1):
        lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
        words = ", ".join(f"{int(w)}u" for w in tree.cat_threshold[lo:hi])
        cat_decls.append(
            f"  static const unsigned int cat_threshold_{idx}_{ci}[] = "
            f"{{{words}}};")
    lines.extend(cat_decls)

    def emit(node: int, depth: int) -> None:
        pad = "  " * (depth + 1)
        if node < 0:
            leaf = ~node
            lines.append(f"{pad}return {float(tree.leaf_value[leaf])!r};")
            return
        f = int(tree.split_feature[node])
        mt = tree.node_missing_type(node)
        if tree.node_is_categorical(node):
            # cat-bitset index lives in `threshold` in BOTH the native and
            # reference text formats (reference Tree::ToIfElse casts
            # threshold_[node]); threshold_in_bin is absent from reference
            # files and would silently pick bitset 0
            ci = int(tree.threshold[node])
            cond = (f"CategoricalDecision(arr[{f}], "
                    f"cat_threshold_{idx}_{ci}, "
                    f"{tree.cat_boundaries[ci + 1] - tree.cat_boundaries[ci]},"
                    f" {mt})")
        else:
            thr = float(tree.threshold[node])
            dl = "true" if tree.node_default_left(node) else "false"
            cond = f"NumericalDecision(arr[{f}], {thr!r}, {mt}, {dl})"
        lines.append(f"{pad}if ({cond}) {{")
        emit(int(tree.left_child[node]), depth + 1)
        lines.append(f"{pad}}} else {{")
        emit(int(tree.right_child[node]), depth + 1)
        lines.append(f"{pad}}}")

    if tree.num_leaves <= 1:
        lines.append(f"  return {float(tree.leaf_value[0])!r};")
    else:
        emit(0, 0)
    lines.append("}")
    return "\n".join(lines)


_IF_ELSE_PRELUDE = '''\
// Generated by lightgbm_tpu (reference: GBDT::SaveModelToIfElse,
// src/boosting/gbdt_model_text.cpp:64). Standalone single-row predictor.
#include <cmath>
#include <cstdint>

namespace {

inline bool IsZero(double v) { return v > -1e-35 && v < 1e-35; }

// missing_type: 0=None 1=Zero 2=NaN (include/LightGBM/bin.h:26-30)
inline bool NumericalDecision(double fval, double threshold,
                              int missing_type, bool default_left) {
  if (std::isnan(fval) && missing_type != 2) fval = 0.0;
  if ((missing_type == 1 && IsZero(fval)) ||
      (missing_type == 2 && std::isnan(fval))) {
    return default_left;
  }
  return fval <= threshold;
}

inline bool FindInBitset(const unsigned int* bits, int n, int pos) {
  int i1 = pos / 32;
  if (i1 >= n) return false;
  return (bits[i1] >> (pos % 32)) & 1;
}

inline bool CategoricalDecision(double fval, const unsigned int* bits,
                                int n_words, int missing_type) {
  int ival;
  if (std::isnan(fval)) {
    if (missing_type == 2) return false;
    ival = 0;
  } else {
    ival = static_cast<int>(fval);
    if (ival < 0) return false;
  }
  return FindInBitset(bits, n_words, ival);
}

}  // namespace

'''


def model_to_if_else(models: List[Tree], num_tree_per_iteration: int,
                     average_output: bool = False) -> str:
    """Emit a standalone C++ predictor for the ensemble (the CLI
    ``task=convert_model`` output, reference `application.h:84`)."""
    parts = [_IF_ELSE_PRELUDE]
    for i, t in enumerate(models):
        parts.append(_tree_to_if_else(t, i))
        parts.append("")
    n = len(models)
    k = max(1, num_tree_per_iteration)
    funs = ", ".join(f"PredictTree{i}" for i in range(n)) or ""
    parts.append(f"static double (*const kTreeFuns[{max(n, 1)}])"
                 f"(const double*) = {{{funs}}};")
    parts.append(f"""
extern "C" {{

const int kNumTrees = {n};
const int kNumTreePerIteration = {k};

// raw ensemble score for one class; output array len {k} for PredictMulti
double PredictRaw(const double* features, int class_id) {{
  double sum = 0.0;
  for (int i = class_id; i < kNumTrees; i += kNumTreePerIteration) {{
    sum += kTreeFuns[i](features);
  }}
  {"return kNumTrees ? sum / (kNumTrees / kNumTreePerIteration) : sum;"
   if average_output else "return sum;"}
}}

void PredictMulti(const double* features, double* out) {{
  for (int c = 0; c < kNumTreePerIteration; ++c) {{
    out[c] = PredictRaw(features, c);
  }}
}}

}}  // extern "C"
""")
    return "\n".join(parts)
