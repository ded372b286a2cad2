"""The BVH builder in C++ loaded over a plain C ABI, and the mitsuba3
`.vol` reader and writer in numpy.

`bvh_builder.cpp` is a copy of the JAX package's binned-SAH BVH builder
(kBins=16, kLeafMax=4, DFS order with skip offsets, single-threaded and so
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

from .. import obs
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


@obs.spanned("setup.scene.bvh", lambda aabbs: {"prims": aabbs.shape[0]},
             setup=True)
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


# a .vol's header: "VOL", version 3, int32 encoding (1: float32), int32
# x, y, z and channels, six float32 bounds; then the float32 payload laid
# out [z][y][x][channel]
VOL_HEADER = 48


def _vol_dims(path, head):
    """(x, y, z, channels) of a .vol's header bytes. Raises ValueError
    with the error code of the JAX package's C++ reader
    (adapt_tpu/native/vol_loader.cpp `vol_read_header`)."""
    def bad(rc):
        return ValueError(f"bad .vol file '{path}' (error {rc})")
    if head[:3] != b"VOL" or head[3:4] != b"\x03":
        raise bad(-2)
    if len(head) < 8 or np.frombuffer(head, np.int32, 1, 4)[0] != 1:
        raise bad(-3)
    if len(head) < 24:
        raise bad(-4)
    x, y, z, c = np.frombuffer(head, np.int32, 4, 8).tolist()
    # non-positive dims would make a nonsense payload size
    if min(x, y, z) <= 0:
        raise bad(-6)
    if c not in (1, 3, 6):
        raise bad(-5)
    return x, y, z, c


def vol_file_to_numpy(path: str, force_mono: bool = False) -> np.ndarray:
    """Read a mitsuba3 .vol into (Z, Y, X, 3) float32, or (Z, Y, X) of
    channel 0 with force_mono: one channel broadcast to three, six cut to
    the first three (reference vol2numpy.cpp:124-131). Raises ValueError
    on a bad header or a short payload."""
    try:
        f = open(path, "rb")
    except OSError:
        raise ValueError(f"bad .vol file '{path}' (error -1)") from None
    with f:
        head = f.read(VOL_HEADER)
        x, y, z, c = _vol_dims(path, head)
        n = z * y * x * c
        grid = np.fromfile(f, np.float32, n)
    if len(head) < VOL_HEADER or grid.size != n:
        raise ValueError(".vol payload read failed (-6)")
    grid = grid.reshape(z, y, x, c)
    if force_mono:
        return np.ascontiguousarray(grid[..., 0])
    if c == 1:
        return np.repeat(grid, 3, axis=-1)
    return np.ascontiguousarray(grid[..., :3])


def write_vol(path: str, grid: np.ndarray) -> None:
    """Write a (Z, Y, X) or (Z, Y, X, C) float32 grid as mitsuba3 .vol
    (version 3, float32 encoding, a unit bounding box)."""
    if grid.ndim == 3:
        grid = grid[..., None]
    z, y, x, c = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL\x03")
        np.array([1, x, y, z, c], np.int32).tofile(f)
        np.array([0, 0, 0, 1, 1, 1], np.float32).tofile(f)  # bbox
        grid.astype(np.float32).tofile(f)
