"""Bit-exact threefry2x32 randomness, the port of `jax.random`'s stream.

The JAX package draws every random number from `jax.random` with the
threefry2x32 generator in partitionable mode (the jax 0.9 default). This
module reproduces that stream bit for bit, so a render of the port can be
held against the JAX package and the goldens pixel by pixel:

  * `PRNGKey`, `split`, `fold_in` on single keys run in Python integers on
    the host (two 32-bit words; no device round trip);
  * `uniform`, `fold_in_lanes` and `lane_uniform` hash whole tensors on
    the tensor's device: on a CUDA device `uniform` and `lane_uniform`
    launch one hand-written kernel each (csrc/rng.cu, 32-bit registers),
    elsewhere they run their plain versions `uniform_plain` and
    `lane_uniform_plain` (int64 tensor ops, any device), the twins the
    tests hold to jax.random and the kernels to bit for bit.
    ops/_build.py launches the kernels and counts them.

Tensors carry the 32-bit words in int64 masked to 32 bits: CUDA support
for `torch.uint32` shifts and adds is patchy, and int64 holds every
intermediate of the rotate (x << 29 < 2^61) exactly.

Algorithm as in jax/_src/prng.py: `_threefry2x32_lowering` (5 x 4 rounds
with key injection), `_threefry_split_foldlike`, `_threefry_fold_in`,
`_threefry_random_bits_partitionable` (bits1 ^ bits2 over a 64-bit iota)
and jax/_src/random.py `_uniform` (23 mantissa bits under exponent 0).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import obs
from .ops import _build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple  # (k1, k2): two Python ints in [0, 2^32)

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block hash.

    Works elementwise on Python ints or int64 tensors (broadcasting);
    every value is a 32-bit word in [0, 2^32). Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: words (0, seed)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`: hash of the count (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> list:
    """`jax.random.split(key, num)`: key i is the hash of the count (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits_to_unit_float(bits):
    """23 random mantissa bits under exponent 0, minus one: [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


@obs.spanned("rng.draw", lambda key, shape, device=None:
             {"n": shape[0] if shape else 1, "words": math.prod(shape)})
def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 on `device`: one kernel
    on a CUDA device, `uniform_plain` elsewhere."""
    n = math.prod(shape)
    obs.count("rng.words", n)
    if device is not None and torch.device(device).type == "cuda":
        return _uniform_cuda(key, shape, n, torch.device(device))
    return uniform_plain(key, shape, device)


def uniform_plain(key: Key, shape, device=None) -> torch.Tensor:
    """`uniform` in int64 tensor ops on any device: the twin of csrc/rng.cu
    `threefry_uniform_kernel`."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], lo >> 32, lo & MASK)
    return _bits_to_unit_float(b1 ^ b2).reshape(shape)


def fold_in_lanes(key: Key, data: torch.Tensor):
    """`vmap(lambda d: fold_in(key, d))(data)` as two (n,) int64 words."""
    return threefry2x32(key[0], key[1], 0, data.to(torch.int64) & MASK)


@obs.spanned("rng.draw", lambda it_key, pos, D:
             {"n": pos.shape[0], "words": pos.shape[0] * D})
def lane_uniform(it_key: Key, pos: torch.Tensor, D: int) -> torch.Tensor:
    """(n, D) uniforms keyed by (iteration, original lane id): the port of
    adapt_tpu/renderer/compact.py `lane_uniform` — a per-lane fold_in on
    `pos`, then `uniform(lane_key, (D,))`. One kernel on a CUDA tensor,
    `lane_uniform_plain` elsewhere."""
    obs.count("rng.words", pos.shape[0] * D)
    if pos.device.type == "cuda":
        return _lane_uniform_cuda(it_key, pos, D)
    return lane_uniform_plain(it_key, pos, D)


def lane_uniform_plain(it_key: Key, pos: torch.Tensor,
                       D: int) -> torch.Tensor:
    """`lane_uniform` in int64 tensor ops on any device: the twin of
    csrc/rng.cu `threefry_lane_uniform_kernel`."""
    k1, k2 = fold_in_lanes(it_key, pos)
    j = torch.arange(D, dtype=torch.int64, device=pos.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], 0, j)
    return _bits_to_unit_float(b1 ^ b2)


_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_LIB = _build.Library(__name__, "rng", {
    "lane_uniform": ("threefry_lane_uniform", "threefry_lane_uniform_kernel",
                     [_U32, _U32, _P, _I, _I, _I, _P, _P]),
    "uniform": ("threefry_uniform", "threefry_uniform_kernel",
                [_U32, _U32, ctypes.c_longlong, _P, _P])})
# each wrapper's kernel, by the name the profiler gives it
kernel_names = _LIB.kernel_names


def _lane_uniform_cuda(key, pos, D):
    """`lane_uniform` on a CUDA tensor: one threefry_lane_uniform_kernel."""
    if pos.dim() != 1 or pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pos: want a 1-D int32 or int64 tensor, got "
                         f"{pos.dtype} of shape {tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError("pos: must be contiguous")
    D = int(D)
    if D < 1:
        raise ValueError(f"D: want at least 1, got {D}")
    n = pos.shape[0]
    if n >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"sizes n={n}, D={D} do not fit in 32-bit ints")
    out = torch.empty((n, D), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    _LIB.launch("lane_uniform", pos.device, n,
                key[0] & MASK, key[1] & MASK, pos.data_ptr(),
                int(pos.dtype == torch.int64), n, D, out.data_ptr())
    return out


def _uniform_cuda(key, shape, n, device):
    """`uniform` on a CUDA device: one threefry_uniform_kernel."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if n == 0:
        return out
    _LIB.launch("uniform", device, n,
                key[0] & MASK, key[1] & MASK, n, out.data_ptr())
    return out
