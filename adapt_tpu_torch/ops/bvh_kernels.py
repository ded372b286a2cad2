"""BVH closest-hit and any-hit: CUDA kernels and their PyTorch twin.

`bvh_closest_hit` and `bvh_any_hit` are the port of the Pallas TPU kernels
adapt_tpu/ops/cluster_pallas.py `_closest_sl_kernel` (via
`cluster_closest_raw`) and `_any_sl_kernel` (via `cluster_any_hit`): the
whole-scene closest hit and any hit before far, on scenes too large for
the brute-force tier. On a CUDA tensor each wrapper launches its
hand-written kernel (csrc/bvh_intersect.cu, built by ops/_build.py) or
raises; on a CPU tensor it runs the plain twin, ops/bvh.py `walk`, which
walks the same tables in the same order. The closest-hit kernel reads the
tables' float4 rows (`bvh_node_v4`, `bvh_prim_v4`), the any-hit kernel
and the twin the (M, 9) and (P, 14) packs. `launches` counts kernel
launches per wrapper; `kernel_info` reads what the compiler and the card
give each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import bvh
from .intersect_kernels import _check, _is_cpu

launches = {"bvh_closest_hit": 0, "bvh_any_hit": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def bvh_closest_hit_plain(scene, ray_o, ray_d, far0):
    """Twin of `bvh_closest_hit` in plain PyTorch (any device)."""
    return bvh.walk(scene, ray_o, ray_d, far0)


def bvh_any_hit_plain(scene, ray_o, ray_d, far0):
    """Twin of `bvh_any_hit` in plain PyTorch (any device)."""
    return bvh.walk(scene, ray_o, ray_d, far0, any_hit=True)[1] >= 0


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from . import _build
    lib = _build.load("bvh_intersect")
    if not getattr(lib, "_typed", False):
        lib.bvh_closest_hit.argtypes = [_P, _P, _P, _I, _P, _I, _P, _P, _P,
                                        _P, _P, _P, _P]
        lib.bvh_any_hit.argtypes = [_P, _P, _P, _I, _P, _I, _P, _P, _P]
        lib.bvh_kernel_info.argtypes = [_I, _P]
        lib.bvh_closest_hit.restype = lib.bvh_any_hit.restype = ctypes.c_int
        lib.bvh_kernel_info.restype = ctypes.c_int
        lib._typed = True
    return lib


# the tables each kernel reads: (field, row width)
CLOSEST_TABLES = (("bvh_node_v4", 8), ("bvh_prim_v4", 16))
ANY_TABLES = (("bvh_node_pack", 9), ("bvh_prim_pack", 14))


def _operands(scene, ray_o, ray_d, far0, tables):
    """Device, type and shape checks of everything a kernel reads, and the
    16-byte alignment of its tables (the closest-hit kernel loads their
    rows as float4s); contiguous rays. The tables must already be
    contiguous."""
    n = ray_o.shape[0]
    packs = [getattr(scene, name) for name, _w in tables]
    for name, x, shape in (
            ("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)),
            ("far0", far0, (n,)),
            *((name, x, (x.shape[0], w))
              for (name, w), x in zip(tables, packs))):
        if x.device != ray_o.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want float32 of shape {shape} on "
                             f"{ray_o.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for (name, _w), x in zip(tables, packs):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if n >= 2 ** 30:
        raise ValueError(f"{n} rays do not fit the kernels' 32-bit ray ids")
    return (ray_o.contiguous(), ray_d.contiguous(), far0.contiguous(), n,
            *packs)


def bvh_closest_hit(scene, ray_o, ray_d, far0):
    """Closest prim hit strictly before far0 for a ray batch.

    Returns (t, prim, u, v): t = far0, prim = -1 and u = v = 0 on a miss;
    prim is the global prim id, u/v the triangle barycentrics
    (o + t d).U - cu and (o + t d).V - cv."""
    if _is_cpu(ray_o):
        return bvh_closest_hit_plain(scene, ray_o, ray_d, far0)
    ro, rd, far, n, nodes, prims = _operands(scene, ray_o, ray_d, far0,
                                             CLOSEST_TABLES)
    t = torch.empty(n, device=ro.device)
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    u = torch.empty(n, device=ro.device)
    v = torch.empty(n, device=ro.device)
    if n == 0:
        return t, prim, u, v
    next_ray = torch.zeros(1, dtype=torch.int32, device=ro.device)
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    err = _lib().bvh_closest_hit(
        ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n, nodes.data_ptr(),
        nodes.shape[0], prims.data_ptr(), t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), next_ray.data_ptr(), stream)
    _check(err, "bvh_closest_hit")
    launches["bvh_closest_hit"] += 1
    return t, prim, u, v


def bvh_any_hit(scene, ray_o, ray_d, far0):
    """True where any prim lies strictly before far0."""
    if _is_cpu(ray_o):
        return bvh_any_hit_plain(scene, ray_o, ray_d, far0)
    ro, rd, far, n, nodes, prims = _operands(scene, ray_o, ray_d, far0,
                                             ANY_TABLES)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    if n == 0:
        return occ
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    err = _lib().bvh_any_hit(ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                             nodes.data_ptr(), nodes.shape[0],
                             prims.data_ptr(), occ.data_ptr(), stream)
    _check(err, "bvh_any_hit")
    launches["bvh_any_hit"] += 1
    return occ


def kernel_info(n):
    """{kernel: (registers a thread, spilled bytes a thread, blocks of
    BLOCK threads resident on one SM, SMs, BLOCK, waves)} for n rays: the
    closest-hit kernel runs one wave of persistent warps whatever n, so its
    "waves" is the rays each resident thread takes; the any-hit kernel
    gives a thread one ray, so its waves are n over the resident threads,
    rounded up. Needs the card."""
    lib = _lib()
    out = {}
    for which, name in ((0, "bvh_closest_hit"), (1, "bvh_any_hit")):
        vals = (ctypes.c_int * 5)()
        _check(lib.bvh_kernel_info(which, ctypes.addressof(vals)),
               f"{name} info")
        regs, spill, per_sm, sms, block = vals
        resident = per_sm * sms * block
        waves = n / resident if which == 0 else -(-n // resident)
        out[name] = (regs, spill, per_sm, sms, block, waves)
    return out
