"""The f32 arithmetic of XLA's CPU backend, reproduced in PyTorch.

The JAX package's numbers come from XLA, which contracts every ``a * b
+ c`` of f32 values into one fused multiply-add and computes ``exp``
with its own polynomial. The port computes the gradients and the score
updates the same way, so both packages feed the same bits into every
histogram and grow the same trees. Both functions are plain tensor code
and give the same bits on the CPU and on CUDA.

The split scan's per-side gain ``-(2 reg out + (h + l2) out^2)`` is
contracted as XLA's CPU backend contracts it (the first product fused
into the add), so two directions that tie up to rounding pick the same
winner in both packages. The parent's gain shift, the same expression
evaluated once per leaf, XLA contracts in two ways in two fusions: as the
side gains where each threshold's gain is tested against it, and with
the second product fused into the add where it is subtracted from the
reported gain. The port keeps both copies (`ops/split.py::_leaf_gain`,
`_leaf_gain_tested`), so the ``split_gain`` written to the model text,
and which noise-level splits are taken, are the JAX package's bit for
bit.

XLA's CPU backend sums an f32 axis of more than 32 elements in windows
of 32 (its tree-reduction rewrite: the axis padded with zeros to a
multiple of 32, the padding split evenly before and after, each window
summed in order, then the windows' sums by the same rule); `sum_f32`
follows it.
"""
from __future__ import annotations

import numpy as np
import torch


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, computed in f64: the product of
    two f32 values is exact there."""
    return (a.double() * b + c).float()


# XLA's f32 exp (its CPU backend's Cephes polynomial): n = floor(x log2 e
# + 1/2), a = x - n ln 2 in two fused steps, e^a by a degree-7
# polynomial, times 2^n; results below the smallest normal flush to 0
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_F32 = np.float32


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor, bit-identical to XLA's f32 exp."""
    x = x.clamp(-87.8, 88.8)
    n = torch.floor(fma_f32(x, float(_F32(1.44269504088896341)), 0.5))
    n = n.clamp(-127.0, 127.0)
    a = fma_f32(n, -0.693359375, x)
    a = fma_f32(n, float(_F32(2.12194440e-4)), a)
    z = fma_f32(a, float(_F32(_EXP_POLY[0])), float(_F32(_EXP_POLY[1])))
    for c in _EXP_POLY[2:]:
        z = fma_f32(z, a, float(_F32(c)))
    z = 1.0 + fma_f32(z, a * a, a)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = z * two_n
    return torch.where(y < float(np.finfo(np.float32).tiny),
                       torch.zeros_like(y), y)


def sum_f32(v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """f32 sum of ``v`` over ``dim`` in the order of XLA's CPU reduction,
    on the tensor's device: in order for 32 elements or fewer, else by
    windows of 32 of the zero-padded axis, recursively."""
    v = v.movedim(dim, 0)
    n = v.shape[0]
    if n > 32:
        pad = -n % 32
        lo = pad // 2
        z = v.new_zeros((lo,) + v.shape[1:])
        z2 = v.new_zeros((pad - lo,) + v.shape[1:])
        w = torch.cat([z, v, z2]).reshape((-1, 32) + v.shape[1:])
        return sum_f32(sum_f32(w, 1), 0)
    acc = torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
    for x in v:
        acc = acc + x
    return acc
