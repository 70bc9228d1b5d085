"""Import hygiene of the port: `lightgbm_tpu_torch` and `chip_smoke.py`
import neither JAX nor the JAX package, and the default device is the
card, never a silent CPU fallback."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_import_leaves_jax_out():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, "
            "lightgbm_tpu_torch.ops.aligned, lightgbm_tpu_torch.ops.rank, "
            "lightgbm_tpu_torch.ops.ranking, "
            "lightgbm_tpu_torch.models.level_builder, "
            "lightgbm_tpu_torch.models.aligned_builder, "
            "lightgbm_tpu_torch.ops.proto, "
            "lightgbm_tpu_torch.tools.proto_aligned, "
            "lightgbm_tpu_torch.tools.proto_roll; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                f"{os.path.relpath(path, ROOT)} imports {name}"


def test_cuda_without_gpu_raises(monkeypatch):
    import torch

    import lightgbm_tpu_torch as tlgb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = [[0.0, 1.0], [1.0, 0.0], [2.0, 1.0], [3.0, 0.0]]
    for params in ({}, {"device_type": "cuda"}, {"device": "gpu"}):
        with pytest.raises(RuntimeError, match="cuda"):
            tlgb.train({"objective": "binary", "verbosity": -1, **params},
                       tlgb.Dataset(X, label=[0, 1, 0, 1]),
                       num_boost_round=1)


def test_import_and_fit_without_optional_modules():
    """scikit-learn, matplotlib, graphviz and pandas are optional (the
    machine with the card has none of them): with their imports blocked
    the package imports, exports the estimators and the plotting
    functions, and `LGBMClassifier` fits and predicts; a plotting call
    raises ImportError."""
    code = "\n".join([
        "import sys",
        "for m in ('sklearn', 'matplotlib', 'pandas', 'graphviz'):",
        "    sys.modules[m] = None",
        "import numpy as np",
        "import lightgbm_tpu_torch as lgb",
        "from lightgbm_tpu_torch import sklearn as sk",
        "assert not sk._HAS_SKLEARN",
        "assert {'LGBMClassifier', 'LGBMRanker', 'plot_importance',",
        "        'reset_parameter'} <= set(lgb.__all__)",
        "rng = np.random.RandomState(0)",
        "X = rng.standard_normal((300, 4)); y = (X[:, 0] > 0).astype(int)",
        "clf = lgb.LGBMClassifier(n_estimators=3, num_leaves=7,",
        "                         verbosity=-1, device_type='cpu').fit(X, y)",
        "p = clf.predict_proba(X)",
        "assert p.shape == (300, 2) and np.allclose(p.sum(1), 1.0)",
        "assert (clf.predict(X) == y).mean() > 0.8",
        "c = clf.predict(X[:5], pred_contrib=True)",
        "assert c.shape == (5, 5)",
        "try:",
        "    lgb.plot_importance(clf)",
        "except ImportError:",
        "    pass",
        "else:",
        "    raise AssertionError('plot_importance without matplotlib')",
        "loaded = [m for m in ('sklearn', 'matplotlib', 'pandas', 'graphviz')",
        "          if sys.modules.get(m) is not None]",
        "assert not loaded, loaded",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
