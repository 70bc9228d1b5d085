"""JAX's default random numbers, reproduced in PyTorch.

GOSS draws its sampling keys with ``jax.random.uniform(PRNGKey(seed),
(n,))`` in the JAX package, and the quantized histograms their rounding
noise with ``jax.random.uniform(fold_in(PRNGKey(seed), qseq), (n, 2))``.
The port draws the same f32 values bit for bit: Threefry-2x32 (20
rounds, Salmon et al. 2011, the key schedule of
``jax._src.prng.threefry2x32``) over the counters of the partitionable
scheme, the 64-bit position (row-major over the shape) split into its
high and low words; a 32-bit draw is the xor of the two output words;
the float is ``(bits >> 9) | 0x3F800000`` read as f32, less 1. A key is
a pair of 32-bit words: ``PRNGKey(seed)`` is ``(0, seed)`` for a 32-bit
seed, and ``fold_in(key, data)`` is Threefry of ``key`` over the counter
``(0, data)``.

Words are held in int64 tensors masked to 32 bits, since PyTorch's
uint32 lacks most arithmetic; every op is exact, so the CPU and the card
give the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def key(seed: int) -> Key:
    """``PRNGKey(seed)`` of a 32-bit seed: the words (0, seed)."""
    return 0, int(seed) & _M32


def _threefry(k: Key, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under key ``k``; the
    words are ints or int64 tensors in [0, 2^32)."""
    k1, k2 = k
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` of a 32-bit ``data``."""
    return _threefry(k, 0, int(data) & _M32)


def random_bits_key(k: Key, n: int, device=None) -> torch.Tensor:
    """[n] int64 in [0, 2^32): the first n 32-bit draws under key ``k``
    (a shape of n elements, in row-major order)."""
    pos = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = _threefry(k, pos >> 32, pos & _M32)
    return x0 ^ x1


def random_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """[n] int64 in [0, 2^32): the 32-bit draws of ``PRNGKey(seed)``."""
    return random_bits_key(key(seed), n, device)


def uniform_key(k: Key, shape, device=None) -> torch.Tensor:
    """f32 in [0, 1) of ``shape``: ``jax.random.uniform(k, shape)``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= int(d)
    bits = (random_bits_key(k, n, device) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def uniform(seed: int, n: int, device=None) -> torch.Tensor:
    """[n] f32 in [0, 1): ``jax.random.uniform(PRNGKey(seed), (n,))``."""
    return uniform_key(key(seed), n, device)
