"""The card's peaks and the byte bound of each hand-written kernel's
wrapper call: the least time one NVIDIA H100 could take to read the
call's inputs and write its outputs once at its HBM bandwidth.

Each input and output is counted once, from the call's shapes and not from
whatever the kernel reads again: the rays in (origin, direction and far,
28 bytes, of a lane that walks; its far alone, 4 bytes, of a dead lane,
whose output depends on nothing else), the hits out, and the scene table
the kernel reads. Arithmetic from chip_smoke.py `_bound` and `_ray_bytes`
(there with an operations bound beside it), frozen here as the yardstick.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at 700 W
RAY_EPS = 1e-4                # a lane walks where its far exceeds it


def ray_bytes(n, walking):
    return walking * 28 + (n - walking) * 4


def _table_bytes(*tables):
    return sum(t.numel() * t.element_size() for t in tables)


def tri_closest_hit(scene, n, walking):
    """B1: rays in; t, row, u, v, normal, object out (32 B)."""
    return ray_bytes(n, walking) + _table_bytes(
        scene.tri_geo, scene.tri_ng, scene.tri_obj) + n * 32


def tri_any_hit(scene, n, walking):
    """B2: rays in; one occlusion byte out."""
    return ray_bytes(n, walking) + _table_bytes(scene.tri_geo) + n


def bvh_closest_hit(scene, n, walking):
    """B5a: rays in; t, prim, u, v out (16 B); the packed BVH."""
    return ray_bytes(n, walking) + _table_bytes(
        scene.bvh_node_v4, scene.bvh_prim_v4) + n * 16


def bvh_any_hit(scene, n, walking):
    """B5b: rays in; one occlusion byte out; the packed BVH."""
    return ray_bytes(n, walking) + _table_bytes(
        scene.bvh_node_v4, scene.bvh_prim_v4) + n


# wrapper -> bytes(scene, rays, walking rays)
BYTES = {"tri_closest_hit": tri_closest_hit, "tri_any_hit": tri_any_hit,
         "bvh_closest_hit": bvh_closest_hit, "bvh_any_hit": bvh_any_hit}


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3
