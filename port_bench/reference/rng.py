"""threefry2x32 in partitionable mode, the random stream the renderer
documents (jax.random's `PRNGKey`, `split`, `fold_in`, `uniform`).

Written from the algorithm (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011; 5 x 4 rounds with key injection) for the
benchmark's reference; it imports nothing of the program. Keys are pairs
of 32-bit words; on tensors the words are int64 masked to 32 bits, so a
key can differ from lane to lane.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k1, k2, x1, x2):
    """The block hash of the count (x1, x2) under the key (k1, k2);
    Python ints or int64 tensors, elementwise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int):
    """The key of a 32-bit seed."""
    return (0, seed & MASK)


def fold_in(k, data):
    """Key k with `data` folded in; data an int or an int64 tensor."""
    return threefry(k[0], k[1], 0, data & MASK)


def split(k):
    """The two keys split from k."""
    return [threefry(k[0], k[1], 0, i) for i in range(2)]


def unit_float(bits, dtype=torch.float32):
    """[0, 1) from the top 23 bits: the mantissa under exponent 0, less
    one."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(dtype)


def uniform_at(k1, k2, counter, dtype=torch.float32):
    """Element `counter` of a flat `uniform(key, shape)` draw, per lane
    (k1, k2, counter: int64 tensors or ints that broadcast)."""
    b1, b2 = threefry(k1, k2, counter >> 32, counter & MASK)
    return unit_float(b1 ^ b2, dtype)
