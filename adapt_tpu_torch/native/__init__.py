"""The binned-SAH BVH builder, native C++ loaded over a plain C ABI.

`bvh_builder.cpp` is a copy of the JAX package's builder (kBins=16,
kLeafMax=4, DFS order with skip offsets, single-threaded and so
deterministic). It compiles with g++ at first use, with the flags of
adapt_tpu/native/Makefile, into build/adapt_tpu_torch/. There is no
fallback: a different builder would give a different tree, and the
port's tables must equal the JAX package's. A failed build raises.
"""
from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from ..ops import _build

SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
# adapt_tpu/native/Makefile:3-4, compile and link in one call
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall", "-shared")


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's BVH builder is built "
                           "from source at first use")
    return cxx


def _lib() -> ctypes.CDLL:
    lib = _build.compiled("bvh_builder", SRC, _gxx, CXX_FLAGS)
    if not getattr(lib, "_typed", False):
        f32 = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.bvh_build.argtypes = [f32, ctypes.c_int64, ctypes.c_int32, f32,
                                  i32, i32]
        lib.bvh_build.restype = ctypes.c_int
        lib._typed = True
    return lib


def bvh_build(aabbs: np.ndarray):
    """Binned-SAH BVH with skip-offset linearization.

    aabbs: (P, 6) float32 [lo, hi]. Returns (node_f (M,6) float32,
    node_i (M,3) int32 [base, count, skip], prim_order (P,) int32)."""
    P = aabbs.shape[0]
    if P == 0:
        return (np.zeros((0, 6), np.float32), np.zeros((0, 3), np.int32),
                np.zeros(0, np.int32))
    aabbs = np.ascontiguousarray(aabbs, np.float32)
    max_nodes = max(4 * P, 64)
    node_f = np.empty((max_nodes, 6), np.float32)
    node_i = np.empty((max_nodes, 3), np.int32)
    order = np.empty(P, np.int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    m = _lib().bvh_build(aabbs.ctypes.data_as(f32), P, max_nodes,
                         node_f.ctypes.data_as(f32),
                         node_i.ctypes.data_as(i32), order.ctypes.data_as(i32))
    if m <= 0:
        raise RuntimeError(f"bvh_build failed ({m}) on {P} prims")
    return node_f[:m].copy(), node_i[:m].copy(), order
