"""Sorted film splat: CUDA kernel B4 and its plain PyTorch version.

`splat_sorted_accumulate(film, idx, rgb)` is the port of the Pallas TPU
kernel adapt_tpu/ops/splat_pallas.py `_splat_kernel` (via its
`splat_sorted_accumulate`): film (P, 3) plus, for every pixel p, the sum of
the rgb rows whose id is p, over a stream sorted by pixel id. Ids outside
[0, P) are ignored (BDPT's `drop` sentinel is P). The TPU kernel's
MAX_WIN and its scatter fallback exist for a static VMEM window and have
no counterpart: in the CUDA kernel (csrc/splat.cu) a block of 256 pixels
finds its window of the stream once, each pixel thread finds its segment
inside the window and adds it in stream order (from shared memory, chunk
by chunk, in a block that holds a long segment).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `splat_sorted_accumulate_plain`, which adds in the kernel's
order (segment offsets by searchsorted, then one pixel-parallel add per
position in the segments), so the two agree bit for bit. ops/_build.py
launches the kernel and counts it. The sort stays with the caller.
"""
from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library(__name__, "splat", {
    "splat_sorted_accumulate": ("splat_sorted_accumulate", "splat_kernel",
                                [_P, _P, _P, _I, _I, _P, _P])})
# the wrapper's kernel, by the name the profiler gives it
kernel_names = _LIB.kernel_names


def _segments(idx, P):
    """(lo, hi): per pixel p, the range of the sorted idx holding p."""
    offs = torch.searchsorted(
        idx, torch.arange(P + 1, dtype=idx.dtype, device=idx.device))
    return offs[:-1], offs[1:]


def splat_sorted_accumulate_plain(film, idx, rgb):
    """Plain PyTorch version of `splat_sorted_accumulate` (any device)."""
    P, M = film.shape[0], idx.shape[0]
    acc = torch.zeros_like(film)
    if M:
        lo, hi = _segments(idx, P)
        n = hi - lo
        longest = int(obs.host_read(n.max(), "splat.longest")) if P else 0
        for j in range(longest):
            take = j < n
            row = torch.clamp(lo + j, max=M - 1)
            acc = acc + torch.where(take[:, None], rgb[row], 0.0)
    return film + acc


def _checked(film, idx, rgb):
    P, M = film.shape[0], idx.shape[0]
    for name, x, shape, dtype in (("film", film, (P, 3), torch.float32),
                                  ("idx", idx, (M,), torch.int32),
                                  ("rgb", rgb, (M, 3), torch.float32)):
        if x.device != film.device or x.dtype != dtype \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} of shape {shape} on "
                             f"{film.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if max(P + 1, M) >= 2 ** 31:
        raise ValueError(f"sizes P={P}, M={M} do not fit in 32-bit ids")
    return P, M


def splat_sorted_accumulate(film, idx, rgb):
    """film (P, 3) f32 + the sorted stream's per-pixel sums, as a new
    tensor. idx (M,) i32 ascending; rgb (M, 3) f32."""
    P, M = _checked(film, idx, rgb)
    if film.device.type == "cpu":
        return splat_sorted_accumulate_plain(film, idx, rgb)
    if film.device.type != "cuda":
        raise ValueError(f"no kernel for device {film.device}")
    out = torch.empty_like(film)
    if P == 0:
        return out
    _LIB.launch("splat_sorted_accumulate", film.device, M,
                film.data_ptr(), idx.data_ptr(), rgb.data_ptr(), P, M,
                out.data_ptr())
    return out
