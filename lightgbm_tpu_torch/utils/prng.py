"""JAX's default random numbers, reproduced in PyTorch.

GOSS draws its sampling keys with ``jax.random.uniform(PRNGKey(seed),
(n,))`` in the JAX package. The port draws the same f32 values bit for
bit: Threefry-2x32 (20 rounds, Salmon et al. 2011, the key schedule of
``jax._src.prng.threefry2x32``) over the counters of the partitionable
scheme, the 64-bit position split into its high and low words; a 32-bit
draw is the xor of the two output words; the float is ``(bits >> 9) |
0x3F800000`` read as f32, less 1.

Words are held in int64 tensors masked to 32 bits, since PyTorch's
uint32 lacks most arithmetic; every op is exact, so the CPU and the card
give the same bits.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def random_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """[n] int64 in [0, 2^32): the 32-bit draws of ``PRNGKey(seed)``,
    whose key is (0, seed) for a 32-bit seed."""
    k1, k2 = 0, int(seed) & _M32
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    x0 = ((pos >> 32) + ks[0]) & _M32
    x1 = ((pos & _M32) + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0 ^ x1


def uniform(seed: int, n: int, device=None) -> torch.Tensor:
    """[n] f32 in [0, 1): ``jax.random.uniform(PRNGKey(seed), (n,))``."""
    bits = (random_bits(seed, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
