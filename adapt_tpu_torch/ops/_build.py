"""Build the port's native code at first use, load it with ctypes, and
launch its hand-written kernels.

Each `csrc/*.cu` file compiles with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds); the BVH
builder (native/bvh_builder.cpp) compiles with g++ the same way. Both go
under `build/adapt_tpu_torch/` at the repository root. The file name
carries a hash of the source and the flags: an edited source builds anew,
and an unchanged one is loaded from the last build.

A kernel module declares its library once, beside its wrappers
(`Library`), and launches every kernel through `Library.launch`: on the
current CUDA stream of the operands' device, inside the span
`kernel.<wrapper>`, a non-zero status raised, the launch counted in
`launches`, the one record of launch counts (obs.py exports it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .. import obs

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adapt_tpu_torch"
# -fmad=false: no FMA contraction, so every product and sum rounds once, as
# in the JAX package and the PyTorch twins (ops/intersect_kernels.py)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
build_seconds: dict = {}   # library name -> seconds its compiler call took
launches: dict = {}        # {module: {wrapper: launches}}, kept always
libraries: dict = {}       # {module: its Library}, in declaration order


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


def _failed(what, err) -> RuntimeError:
    return RuntimeError(f"{what}: CUDA launch failed with error {err}")


def reset_launches():
    """Zero every launch count."""
    for counts in launches.values():
        for k in counts:
            counts[k] = 0


class Library:
    """A kernel module's library, csrc/<name>.cu, as the module declares
    it: `kernels` {wrapper: (entry point, the name the profiler gives its
    kernel, argument types)}, the stream last; `queries` {entry point:
    argument types} of entries that launch nothing. Every entry returns an
    int status, 0 on success. Built, loaded and typed at the first call.
    `refused(wrapper, err, args)` may give the exception a non-zero status
    of a launch raises (None: the default RuntimeError)."""

    def __init__(self, module, name, kernels, queries=None, refused=None):
        self.name = name
        self.kernels = kernels
        self.queries = queries or {}
        self.refused = refused
        self.kernel_names = {w: k for w, (_e, k, _a) in kernels.items()}
        self._spans = {w: "kernel." + w for w in kernels}
        self._fns = None
        module = module.rsplit(".", 1)[-1]
        self.counts = launches[module] = dict.fromkeys(kernels, 0)
        libraries[module] = self

    def entries(self):
        """{wrapper or query entry: its typed entry point}, the library
        built or loaded at the first call."""
        if self._fns is None:
            lib = load(self.name)
            typed = {w: (e, a) for w, (e, _k, a) in self.kernels.items()}
            typed.update((e, (e, a)) for e, a in self.queries.items())
            fns = {}
            for key, (entry, argtypes) in typed.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[key] = fn
            self._fns = fns
        return self._fns

    def launch(self, wrapper, device, n, *args):
        """Launch `wrapper`'s kernel with `args` on the current CUDA stream
        of `device`, inside the span `kernel.<wrapper>` (attribute n);
        raise on a non-zero status, else count the launch."""
        stream = torch.cuda.current_stream(device).cuda_stream
        with obs.span(self._spans[wrapper], n=n):
            err = (self._fns or self.entries())[wrapper](*args, stream)
        if err:
            raise (self.refused and self.refused(wrapper, err, args)) \
                or _failed(wrapper, err)
        self.counts[wrapper] += 1

    def query(self, entry, what, *args):
        """Call the query `entry` with `args`; raise on a non-zero status."""
        err = (self._fns or self.entries())[entry](*args)
        if err:
            raise _failed(what, err)
