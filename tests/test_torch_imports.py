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
