"""Typed configuration (copied from lightgbm_tpu/config.py).

The reference's parameter surface (`include/LightGBM/config.h:31+`,
parsing in `src/io/config.cpp:15-283`): one flat config with key=value
parsing, alias expansion and conflict checks, so `train.conf` files and
`train(params={...})` dicts written for the JAX package work unchanged.
Unknown keys (the JAX package's TPU knobs among them) are tolerated.

Differences from the copy's source: ``device_type`` defaults to
``cuda`` (``gpu`` is an alias, ``cpu`` runs the plain PyTorch versions
of every kernel), and of the TPU block only the knobs the port reads
are kept.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Alias table: maps every accepted alias to the canonical parameter name.
# Mirrors the generated table in the reference `src/io/config_auto.cpp`
# (source comments `include/LightGBM/config.h`, e.g. `alias = ...` lines).
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data",
    "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads",
    "nthreads": "num_threads", "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri",
    "fp": "feature_contri", "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename", "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "data_seed": "data_random_seed",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "model_input": "input_model", "model_in": "input_model",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "prediction_name": "output_result",
    "pred_name": "output_result", "name_pred": "output_result",
    "init_score_filename": "initscore_filename",
    "init_score_file": "initscore_filename", "init_score": "initscore_filename",
    "input_init_score": "initscore_filename",
    "valid_data_init_scores": "valid_initscore_filenames",
    "valid_data_initscores": "valid_initscore_filenames",
    "valid_init_score_file": "valid_initscore_filenames",
    "valid_init_score": "valid_initscore_filenames",
    "is_pre_partition": "pre_partition",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column",
    "query_column": "group_column", "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score", "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metrics": "metric", "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "map_eval_at": "eval_at",
    "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename", "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
}

# objective-name aliases (reference `config.h:106-126` descl2 lines,
# normalization in `src/objective/objective_function.cpp` / ParseObjectiveAlias)
_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression": "regression", "regression_l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "lambdarank": "lambdarank",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_METRIC_ALIASES: Dict[str, str] = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "kldiv": "kldiv", "kullback_leibler": "kldiv",
    "none": "none", "na": "none", "null": "none", "custom": "none",
}

_TREE_LEARNER_ALIASES: Dict[str, str] = {
    "serial": "serial",
    "feature": "feature", "feature_parallel": "feature",
    "data": "data", "data_parallel": "data",
    "voting": "voting", "voting_parallel": "voting",
}

_BOOSTING_ALIASES: Dict[str, str] = {
    "gbdt": "gbdt", "gbrt": "gbdt",
    "dart": "dart",
    "goss": "goss",
    "rf": "rf", "random_forest": "rf",
}

_DEVICE_ALIASES: Dict[str, str] = {
    "cpu": "cpu", "gpu": "cuda", "cuda": "cuda",
}


def _kv_list(value: Any, typ) -> list:
    """Parse 'a,b,c' strings / sequences into a typed list."""
    if value is None or value == "":
        return []
    if isinstance(value, str):
        parts = [p for p in value.replace(" ", "").split(",") if p != ""]
        return [typ(p) for p in parts]
    if isinstance(value, (list, tuple)):
        return [typ(v) for v in value]
    return [typ(value)]


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "+")
    return bool(v)


@dataclass
class Config:
    """All training/IO/prediction parameters (reference `config.h:31+`)."""

    # --- core (config.h:84-208)
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: int = 0

    # --- learning control (config.h:210-435)
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    verbosity: int = 1

    # --- IO / dataset (config.h:437-600)
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    histogram_pool_size: float = -1.0
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_initscore_filenames: List[str] = field(default_factory=list)
    pre_partition: bool = False
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    use_missing: bool = True
    zero_as_missing: bool = False
    two_round: bool = False
    save_binary: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""

    # --- prediction (config.h:602-648)
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    num_iteration_predict: int = -1
    start_iteration_predict: int = 0
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # --- objective (config.h:650-722)
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_position: int = 20
    label_gain: List[float] = field(default_factory=list)

    # --- metric (config.h:724-780)
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1

    # --- network (config.h:782-809)
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""


    # --- device block (the reference's gpu_* block, config.h:811-826)
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    # accumulate histograms in f64: f64 sums of f32 gradients are exact
    # at any realistic leaf size, so the result does not depend on the
    # order of the kernel's atomics and a CUDA run grows the same trees
    # as a CPU run
    tpu_use_f64_hist: bool = False
    # tree growth strategy: "auto" takes the aligned engine
    # (models/aligned_builder.py) when every gate of
    # DeviceTreeLearner.aligned_mode_gate passes, else leaf-wise;
    # "aligned" forces it and raises on a failing gate; "leafwise" forces
    # the leaf-wise builder; "level" takes the speculative level builder
    # (models/level_builder.py, kernel B5), with an inexact tree grown
    # leaf-wise
    tpu_grow_mode: str = "auto"
    # speculation slots of the aligned engine and the level builder as a
    # multiple of num_leaves
    tpu_level_spec: float = 4.5
    # aligned rows per chunk (0 = auto: 1024 up to 40 features, else 512)
    tpu_chunk: int = 0
    # run the aligned engine on the CPU through the kernels' plain twins
    # (the JAX package's flag for its interpret-mode kernels)
    tpu_aligned_interpret: bool = False
    # force the aligned engine's big-n layout (STANDARD records and the
    # exact i32 count pass, normally n > 2^24 only) at any row count
    tpu_force_big_n: bool = False
    # the JAX package's lambdarank knobs: its fused kernel (on / off /
    # auto = on when the accelerator is attached) and the tile of queries
    # it takes. The port's kernel takes every query length; the two say
    # which queries take the sigmoid table below, as in the JAX package
    tpu_rank_fused: str = "auto"
    tpu_rank_tile: int = 512
    # quantize the lambdarank sigmoid's input to this many cells over
    # [-50, 50], the reference's lookup table (rank_objective.hpp:71), in
    # the queries the fused kernel would take (queries of at most
    # tpu_rank_tile documents under fused on, or auto on the card); 0 =
    # exact sigmoid everywhere
    tpu_rank_sigmoid_bins: int = 0
    # quantized histograms (auto / on / off): under on the leaf-wise
    # builder rounds g and h stochastically to tpu_quant_hist_bits (8 or
    # 16) once a tree and sums the integers (kernel B1's integer branch);
    # auto and off never quantize, which is what the JAX package does
    # under auto off the TPU; f64 histograms, gpu_use_dp and the level
    # builder never quantize
    tpu_quant_hist: str = "auto"
    # the JAX package's TPU knobs, kept with its defaults so that both
    # packages write the same parameters block into the model text; the
    # port accepts them and they change nothing here: the histogram
    # chunk, the Pallas switch, the fused iteration program, the
    # smallest padded leaf, the mesh axis name, the serving engine's
    # predict policy, the sub-binned MXU accumulation and the VMEM budget
    # of the aligned move's histogram store (lightgbm_tpu/config.py:
    # 364-515); and the quantized histograms' width, which tpu_quant_hist
    # reads
    tpu_hist_chunk: int = 1 << 16
    tpu_use_pallas: bool = True
    tpu_fuse_iteration: bool = False
    tpu_min_pad: int = 1024
    tpu_mesh_axis: str = "data"
    tpu_predict_device: str = "auto"
    tpu_hist_subbin: str = "auto"
    tpu_hist_spill_vmem_mb: float = 48.0
    tpu_quant_hist_bits: int = 16

    # internal (set by trainer, reference config.h:832-833)
    is_parallel: bool = False
    is_parallel_find_bin: bool = False

    # ------------------------------------------------------------------
    @staticmethod
    def canonical_name(key: str) -> str:
        k = key.strip().lower()
        return _ALIASES.get(k, k)

    def __post_init__(self) -> None:
        if isinstance(self.task, dict):
            raise TypeError("Config() takes dataclass fields, not a params "
                            "dict — use Config.from_params({...})")

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]] = None) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> "Config":
        """Apply key=value params with alias expansion.

        First-one-wins among aliases of the same canonical key, matching the
        reference `KV2Map` + alias pass (`src/io/config.cpp:15-40`).
        """
        fields = {f.name: f for f in dataclasses.fields(self)}
        seen = set()
        for key, value in params.items():
            name = self.canonical_name(key)
            if name in seen:
                continue
            if name not in fields:
                # unknown keys are tolerated (reference warns); keep for users
                continue
            seen.add(name)
            f = fields[name]
            if f.type in ("int", int):
                setattr(self, name, int(float(value)))
            elif f.type in ("float", float):
                setattr(self, name, float(value))
            elif f.type in ("bool", bool):
                setattr(self, name, _to_bool(value))
            elif name in ("valid", "valid_initscore_filenames", "metric"):
                setattr(self, name, _kv_list(value, str))
            elif name in ("monotone_constraints",):
                setattr(self, name, _kv_list(value, int))
            elif name == "eval_at":
                setattr(self, name, sorted(_kv_list(value, int)))
            elif name in ("feature_contri", "label_gain",
                          "cegb_penalty_feature_lazy",
                          "cegb_penalty_feature_coupled"):
                setattr(self, name, _kv_list(value, float))
            else:
                setattr(self, name, str(value))
        self._normalize()
        self._check_conflicts()
        return self

    # ------------------------------------------------------------------
    def _normalize(self) -> None:
        """Normalize enum-ish strings (reference `config.cpp:121-151`)."""
        obj = self.objective.strip().lower()
        self.objective = _OBJECTIVE_ALIASES.get(obj, obj)
        self.boosting = _BOOSTING_ALIASES.get(self.boosting.strip().lower(),
                                              self.boosting.strip().lower())
        self.tree_learner = _TREE_LEARNER_ALIASES.get(
            self.tree_learner.strip().lower(), self.tree_learner.strip().lower())
        dev = self.device_type.strip().lower()
        if dev not in _DEVICE_ALIASES:
            raise ValueError(
                f"device_type must be cuda (alias gpu) or cpu, got {dev!r}")
        self.device_type = _DEVICE_ALIASES[dev]
        self.metric = [_METRIC_ALIASES.get(m.strip().lower(), m.strip().lower())
                       for m in self.metric]
        if not self.label_gain:
            # default label gain 2^i - 1 (reference config.h:715-722)
            self.label_gain = [float((1 << i) - 1) for i in range(31)]

    def _check_conflicts(self) -> None:
        """Parameter-conflict resolution (reference `CheckParamConflict`
        `src/io/config.cpp:204-283`)."""
        if self.tree_learner != "serial":
            self.is_parallel = True
            self.is_parallel_find_bin = True
        if self.boosting == "rf":
            if not (self.bagging_fraction < 1.0 or self.pos_bagging_fraction < 1.0
                    or self.neg_bagging_fraction < 1.0):
                self.bagging_fraction = 0.9
            if self.bagging_freq <= 0:
                self.bagging_freq = 1
        if self.boosting == "goss":
            # GOSS owns its sampling; plain bagging is disabled
            self.bagging_freq = 0
        if (self.pos_bagging_fraction < 1.0 or self.neg_bagging_fraction < 1.0) \
                and self.objective != "binary":
            self.pos_bagging_fraction = 1.0
            self.neg_bagging_fraction = 1.0
        if self.max_depth > 0:
            full = 1 << min(self.max_depth, 30)
            self.num_leaves = min(self.num_leaves, full)

    # ------------------------------------------------------------------
    @property
    def forces_host_learner(self) -> bool:
        """True when the config alone needs the host SerialTreeLearner:
        the per-(row, feature) lazy CEGB penalty (JAX package:
        `Config.forces_host_learner`), whose marks only the host
        `SerialTreeLearner` keeps."""
        return len(self.cegb_penalty_feature_lazy) > 0

    @property
    def sequential_device_only(self) -> bool:
        """True when the config needs the strictly sequential leaf-wise
        loop: forced splits and CEGB penalties depend on the order the
        splits are committed in, which the speculative aligned and level
        builders replay out of order (JAX package:
        `Config.sequential_device_only`)."""
        return bool(self.forcedsplits_filename) \
            or self.cegb_penalty_split > 0 \
            or len(self.cegb_penalty_feature_coupled) > 0 \
            or len(self.cegb_penalty_feature_lazy) > 0

    @property
    def num_tree_per_iteration(self) -> int:
        if self.objective == "multiclass" or self.objective == "multiclassova":
            return self.num_class
        return 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def clone(self) -> "Config":
        return dataclasses.replace(
            self,
            valid=list(self.valid),
            metric=list(self.metric),
            monotone_constraints=list(self.monotone_constraints),
            feature_contri=list(self.feature_contri),
            label_gain=list(self.label_gain),
            eval_at=list(self.eval_at),
        )


def resolve_device(cfg: Config):
    """The torch device a run uses: ``cuda`` unless the config asks for
    the CPU. Asking for ``cuda`` without a GPU raises — the port never
    falls back to the CPU on its own."""
    import torch
    if cfg.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_type=cuda but torch.cuda.is_available() is False; "
            "pass device_type=cpu to run on the CPU")
    return torch.device("cuda", max(cfg.gpu_device_id, 0))


def parse_config_file(text: str) -> Dict[str, str]:
    """Parse a reference-style `train.conf` (`key = value` lines, `#` comments;
    reference `Config::LoadFromString`, `src/io/config.cpp`)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out
