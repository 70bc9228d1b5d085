"""Tests of the port that need the card: the CUDA histogram kernel against
its plain twin, and f64 training on the card against the CPU. They import
neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import histogram as H


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _mk(n, f, max_bin, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, (n, f)).astype(np.uint8)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return bins, np.stack([g, h], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [63, 255])
def test_kernel_matches_plain_on_gpu(cuda, max_bin):
    """f64 equal to the twin; f32 counts equal and grad/hess within
    1e-5 of the rows' sum of |g| (|h|), over a leaf slice and the root."""
    bins, gh = _mk(50000, 28, max_bin, seed=6)
    tb = torch.tensor(bins, device=cuda)
    tgh = torch.tensor(gh, device=cuda)
    perm = torch.randperm(50000, device=cuda).to(torch.int32)
    H.reset_launches()
    for idx, begin, count in ((perm, 1000, 20000), (None, 0, 50000)):
        got = H.leaf_histogram(tb, tgh, idx, begin, count, max_bin, "f64")
        ref = H.histogram_plain(tb, tgh, idx, begin, count, max_bin, "f64")
        assert torch.equal(got, ref)
        got = H.leaf_histogram(tb, tgh, idx, begin, count, max_bin)
        ref = H.histogram_plain(tb, tgh, idx, begin, count, max_bin)
        assert torch.equal(got[..., 2], ref[..., 2])
        rows = idx[begin:begin + count].long() if idx is not None \
            else slice(0, count)
        scale = tgh[rows].abs().sum(0)
        assert bool(((got[..., :2] - ref[..., :2]).abs()
                     <= 1e-5 * scale).all())
    assert H.LAUNCHES == {"f32": 2, "f64": 2}


@pytest.mark.cuda
def test_f64_training_on_gpu_equals_cpu(cuda):
    """tpu_use_f64_hist: the trees grown on the card are the CPU's."""
    rng = np.random.RandomState(1)
    X = rng.standard_normal((3000, 8))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.standard_normal(3000) > 0)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "tpu_use_f64_hist": True, "verbosity": -1}
    texts = {}
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = tlgb.train({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y.astype(np.float64)),
                         num_boost_round=3, verbose_eval=False)
        assert (H.LAUNCHES["f64"] > 0) == (dev == "cuda")
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    assert texts["cuda"] == texts["cpu"]
