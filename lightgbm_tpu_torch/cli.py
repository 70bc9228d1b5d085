"""Command-line application: ``python -m lightgbm_tpu_torch
config=train.conf`` (port of lightgbm_tpu/cli.py).

Re-creates the reference CLI (`src/main.cpp`, `src/application/
application.cpp`): ``key=value`` args with a ``config=`` file
(`LoadParameters` `application.cpp:48-81`), task dispatch
train/predict/convert_model (`application.h:78-88`), periodic model
snapshots (`gbdt.cpp:289-293`), and prediction-result files compatible
with `Predictor` output (`src/application/predictor.hpp`). Training
reads its files through `io/loader.py` onto the run's device (``cuda``
unless ``device_type=cpu``) and trains through `engine.train`.
``task=refit`` waits for `Booster.refit` (ROADMAP A.5), ``task=serve``
for serving (A.6); tracing (A.9) and checkpoints (A.8) raise as
`engine.train` raises on them.
"""
from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .config import Config
from .engine import train as engine_train
from .io.file_io import open_file
from .io.loader import DatasetLoader


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    """``key=value`` tokens; ``config=file`` pulls in a config file whose
    entries CLI args override (reference `Application::LoadParameters`)."""
    cli: Dict[str, str] = {}
    for tok in argv:
        tok = tok.strip()
        if not tok or tok.startswith("#"):
            continue
        if "=" not in tok:
            raise LightGBMError(f"Unknown CLI argument: {tok!r}")
        k, v = tok.split("=", 1)
        cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    conf_file = cli.get("config", cli.get("config_file", ""))
    if conf_file:
        params.update(read_config_file(conf_file))
    params.update(cli)  # CLI wins over config file
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def read_config_file(path: str) -> Dict[str, str]:
    """``key = value`` lines, ``#`` comments (reference `Config::KV2Map`)."""
    if not os.path.isfile(path):
        raise LightGBMError(f"Config file {path} doesn't exist")
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _wrap_core(core, params) -> Dataset:
    d = Dataset(None, params=dict(params))
    d._handle = core
    d.free_raw_data = False
    return d


def _write_result(path: str, arr: np.ndarray) -> None:
    """One row a line, ``%g`` values, tab-separated columns."""
    with open_file(path, "w") as f:
        if arr.ndim == 1:
            for v in arr:
                f.write(f"{v:g}\n")
        else:
            for row in arr:
                f.write("\t".join(f"{v:g}" for v in row) + "\n")


class Application:
    """reference `Application` (`include/LightGBM/application.h:35-92`)."""

    def __init__(self, argv: List[str]) -> None:
        self.raw_params = parse_cli_args(argv)
        self.config = Config.from_params(self.raw_params)
        if self.config.num_threads > 0:
            os.environ.setdefault("OMP_NUM_THREADS",
                                  str(self.config.num_threads))

    # ------------------------------------------------------------------
    def run(self) -> int:
        task = self.config.task
        if task == "train":
            return self.train()
        elif task in ("predict", "prediction", "test"):
            self.predict()
        elif task in ("convert_model",):
            self.convert_model()
        elif task == "refit":
            raise NotImplementedError("task=refit needs Booster.refit, "
                                      "which is not ported yet (ROADMAP A.5)")
        elif task == "serve":
            raise NotImplementedError("task=serve: serving is not ported yet "
                                      "(ROADMAP A.6)")
        else:
            raise LightGBMError(f"Unknown task type {task}")
        return 0

    # ------------------------------------------------------------------
    def _load_train_data(self):
        cfg = self.config
        if not cfg.data:
            raise LightGBMError("No training data: set data=<file>")
        predict_fun = None
        if cfg.input_model and os.path.isfile(cfg.input_model):
            # continued training: prior model's raw predictions become the
            # init score (reference application.cpp:90-93)
            prior = Booster(params={"device_type": cfg.device_type},
                            model_file=cfg.input_model)
            predict_fun = lambda X: prior.predict(X, raw_score=True)  # noqa: E731
        loader = DatasetLoader(cfg, predict_fun=predict_fun)
        core = loader.load_from_file(cfg.data)
        train_set = _wrap_core(core, self.raw_params)
        valid_sets, valid_names = [], []
        for vf in cfg.valid:
            vcore = loader.load_from_file_align_with_other_dataset(vf, core)
            valid_sets.append(_wrap_core(vcore, self.raw_params))
            valid_names.append(os.path.basename(vf))
        return train_set, valid_sets, valid_names

    def train(self) -> int:
        cfg = self.config
        train_set, valid_sets, valid_names = self._load_train_data()
        if cfg.is_provide_training_metric:
            valid_sets = [train_set] + valid_sets
            valid_names = ["training"] + valid_names
        callbacks = []
        if cfg.snapshot_freq > 0 and cfg.output_model:
            callbacks.append(_snapshot_callback(cfg.output_model,
                                                cfg.snapshot_freq,
                                                cfg.tpu_snapshot_keep))
        booster = engine_train(
            dict(self.raw_params), train_set,
            num_boost_round=cfg.num_iterations,
            valid_sets=valid_sets, valid_names=valid_names,
            init_model=(cfg.input_model or None),
            verbose_eval=max(1, cfg.metric_freq),
            callbacks=callbacks)
        out = cfg.output_model or "LightGBM_model.txt"
        booster.save_model(out)
        print(f"Finished training. Model saved to {out}")
        return 0

    # ------------------------------------------------------------------
    def predict(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            raise LightGBMError("No model file: set input_model=<file>")
        if not cfg.data:
            raise LightGBMError("No prediction data: set data=<file>")
        booster = Booster(params=dict(self.raw_params),
                          model_file=cfg.input_model)
        num_iteration = cfg.num_iteration_predict
        # hand the PATH to Booster.predict: its file branch carries the
        # reference's label-free detection (predictor.hpp:185)
        preds = booster.predict(
            cfg.data,
            num_iteration=(num_iteration if num_iteration > 0 else None),
            raw_score=cfg.predict_raw_score,
            pred_leaf=cfg.predict_leaf_index,
            pred_contrib=cfg.predict_contrib,
            start_iteration=cfg.start_iteration_predict)
        out = cfg.output_result or "LightGBM_predict_result.txt"
        _write_result(out, np.atleast_1d(np.asarray(preds)))
        print(f"Finished prediction. Results saved to {out}")

    # ------------------------------------------------------------------
    def convert_model(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            raise LightGBMError("No model file: set input_model=<file>")
        from .models.model_text import model_to_if_else
        booster = Booster(params={"device_type": cfg.device_type},
                          model_file=cfg.input_model)
        out = cfg.convert_model or "gbdt_prediction.cpp"
        code = model_to_if_else(booster.trees,
                                booster.num_tree_per_iteration,
                                average_output=booster._is_average_output())
        with open_file(out, "w") as f:
            f.write(code)
        print(f"Finished converting model. Code saved to {out}")


def _atomic_write_text(path: str, text: str) -> None:
    """tmp + rename in the destination directory (same filesystem, so the
    rename is atomic); a reader never sees a torn file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp.{os.getpid()}.{os.path.basename(path)}")
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _prune_snapshots(output_model: str, keep: int) -> List[str]:
    """Rolling retention for ``<output_model>.snapshot_iter_K`` files:
    keep the newest `keep` by iteration number, delete the rest."""
    if keep <= 0:
        return []
    snaps = []
    for p in glob.glob(f"{output_model}.snapshot_iter_*"):
        tail = p.rsplit("snapshot_iter_", 1)[-1]
        if tail.isdigit():
            snaps.append((int(tail), p))
    snaps.sort()
    removed = []
    for _, p in (snaps[:-keep] if len(snaps) > keep else []):
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def _snapshot_callback(output_model: str, freq: int, keep: int = 3):
    """Periodic model snapshots (reference gbdt.cpp:289-293), written
    atomically with rolling retention of the newest `keep` files (JAX
    package: cli.py:367)."""
    def _cb(env):
        it = env.iteration + 1
        if it % freq == 0:
            _atomic_write_text(f"{output_model}.snapshot_iter_{it}",
                               env.model.model_to_string())
            _prune_snapshots(output_model, keep)
    _cb.order = 100
    return _cb


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: python -m lightgbm_tpu_torch config=train.conf "
              "[key=value ...]")
        return 1
    try:
        rc = Application(argv).run()
    except LightGBMError as e:
        print(f"[LightGBM-TPU] [Fatal] {e}", file=sys.stderr)
        return 1
    return int(rc or 0)


if __name__ == "__main__":
    sys.exit(main())
