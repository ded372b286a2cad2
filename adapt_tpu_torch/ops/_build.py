"""Build the port's native code at first use and load it with ctypes.

Each `csrc/*.cu` file compiles with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds); the BVH
builder (native/bvh_builder.cpp) compiles with g++ the same way. Both go
under `build/adapt_tpu_torch/` at the repository root. The file name
carries a hash of the source and the flags: an edited source builds anew,
and an unchanged one is loaded from the last build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import obs

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adapt_tpu_torch"
# -fmad=false: no FMA contraction, so every product and sum rounds once, as
# in the JAX package and the PyTorch twins (ops/intersect_kernels.py)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
build_seconds: dict = {}   # library name -> seconds its compiler call took


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the GPU")


def compiled(name: str, src: Path, compiler, flags) -> ctypes.CDLL:
    """The loaded library `name` built from `src` by `compiler()` (a
    callable giving the compiler's path, asked only when a build is
    needed) with `flags`. A failed build raises."""
    if name in _LIBS:
        return _LIBS[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}_{digest}.so"
    with obs.setup_span("setup.lib", lib=name, built=0) as sp:
        if not so.exists():
            sp.set(built=1)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            subprocess.run([compiler(), *flags, "-o", str(tmp), str(src)],
                           check=True)
            build_seconds[name] = time.perf_counter() - t0
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return compiled(name, CSRC / f"{name}.cu", _nvcc, NVCC_FLAGS)
