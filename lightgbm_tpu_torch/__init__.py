"""lightgbm_tpu_torch: the JAX package's GBDT, ported to PyTorch with
hand-written CUDA kernels for one NVIDIA H100.

Same API and model text as ``lightgbm_tpu``; entry points run on the
``cuda`` device unless the params say ``device_type=cpu``. See ROADMAP.md
for what is ported so far. The sklearn estimators and the plotting
functions are exported where their module imports; scikit-learn,
matplotlib, graphviz and pandas are optional, imported only where used.
"""
from .basic import Booster, Dataset, LightGBMError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import cv, train

__version__ = "2.2.4"  # capability parity target (reference VERSION.txt)

__all__ = [
    "Dataset", "Booster", "Config", "LightGBMError",
    "train", "cv",
    "early_stopping", "print_evaluation", "record_evaluation",
    "reset_parameter", "EarlyStopException",
]

try:  # sklearn API is optional (mirrors the reference's compat gating)
    from .sklearn import (LGBMClassifier, LGBMModel, LGBMRanker,
                          LGBMRegressor)
    __all__ += ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]
except ImportError:  # pragma: no cover
    pass

try:  # plotting is optional (matplotlib / graphviz)
    from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                           plot_split_value_histogram, plot_tree)
    __all__ += ["plot_importance", "plot_split_value_histogram",
                "plot_metric", "plot_tree", "create_tree_digraph"]
except ImportError:  # pragma: no cover
    pass
