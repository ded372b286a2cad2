"""BVH closest-hit and any-hit: CUDA kernels and their PyTorch twin.

`bvh_closest_hit` and `bvh_any_hit` are the port of the Pallas TPU kernels
adapt_tpu/ops/cluster_pallas.py `_closest_sl_kernel` (via
`cluster_closest_raw`) and `_any_sl_kernel` (via `cluster_any_hit`): the
whole-scene closest hit and any hit before far, on scenes too large for
the brute-force tier. On a CUDA tensor each wrapper launches its
hand-written kernel (csrc/bvh_intersect.cu, built by ops/_build.py) or
raises; on a CPU tensor it runs the plain twin, ops/bvh.py `walk`, which
walks the same tables in the same order. `launches` counts kernel
launches per wrapper.
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
                                        _P, _P, _P]
        lib.bvh_any_hit.argtypes = [_P, _P, _P, _I, _P, _I, _P, _P, _P]
        lib.bvh_closest_hit.restype = lib.bvh_any_hit.restype = ctypes.c_int
        lib._typed = True
    return lib


def _operands(scene, ray_o, ray_d, far0):
    """Device, type and shape checks of everything the kernels read;
    contiguous rays. The BVH tables must already be contiguous."""
    n = ray_o.shape[0]
    nodes, prims = scene.bvh_node_pack, scene.bvh_prim_pack
    for name, x, shape in (
            ("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)),
            ("far0", far0, (n,)),
            ("bvh_node_pack", nodes, (nodes.shape[0], 9)),
            ("bvh_prim_pack", prims, (prims.shape[0], 14))):
        if x.device != ray_o.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want float32 of shape {shape} on "
                             f"{ray_o.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, x in (("bvh_node_pack", nodes), ("bvh_prim_pack", prims)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return (ray_o.contiguous(), ray_d.contiguous(), far0.contiguous(), n,
            nodes, prims)


def bvh_closest_hit(scene, ray_o, ray_d, far0):
    """Closest prim hit strictly before far0 for a ray batch.

    Returns (t, prim, u, v): t = far0, prim = -1 and u = v = 0 on a miss;
    prim is the global prim id, u/v the triangle barycentrics
    (o + t d).U - cu and (o + t d).V - cv."""
    if _is_cpu(ray_o):
        return bvh_closest_hit_plain(scene, ray_o, ray_d, far0)
    ro, rd, far, n, nodes, prims = _operands(scene, ray_o, ray_d, far0)
    t = torch.empty(n, device=ro.device)
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    u = torch.empty(n, device=ro.device)
    v = torch.empty(n, device=ro.device)
    if n == 0:
        return t, prim, u, v
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    err = _lib().bvh_closest_hit(
        ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n, nodes.data_ptr(),
        nodes.shape[0], prims.data_ptr(), t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), stream)
    _check(err, "bvh_closest_hit")
    launches["bvh_closest_hit"] += 1
    return t, prim, u, v


def bvh_any_hit(scene, ray_o, ray_d, far0):
    """True where any prim lies strictly before far0."""
    if _is_cpu(ray_o):
        return bvh_any_hit_plain(scene, ray_o, ray_d, far0)
    ro, rd, far, n, nodes, prims = _operands(scene, ray_o, ray_d, far0)
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
