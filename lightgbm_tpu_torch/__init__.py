"""lightgbm_tpu_torch: the JAX package's GBDT, ported to PyTorch with
hand-written CUDA kernels for one NVIDIA H100.

Same API and model text as ``lightgbm_tpu``; entry points run on the
``cuda`` device unless the params say ``device_type=cpu``. See ROADMAP.md
for what is ported so far.
"""
from .basic import Booster, Dataset, LightGBMError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation)
from .config import Config
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train",
           "early_stopping", "print_evaluation", "record_evaluation",
           "EarlyStopException"]
