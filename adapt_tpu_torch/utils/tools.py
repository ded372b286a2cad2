"""Timing and file helpers (copy of adapt_tpu/utils/tools.py; reference
utils/tools.py:17-50).

TicToc stopwatch, a @timing decorator used on heavyweight host steps
(scene parsing, texture packing), and the mkdir-on-demand path helper.
"""
from __future__ import annotations

import functools
import os
import time


class TicToc:
    """Stopwatch (reference tools.py:17-26)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Seconds since the last tic()."""
        return time.perf_counter() - self._t0

    def toc_tic(self) -> float:
        dt = self.toc()
        self.tic()
        return dt


def timing(label: str | None = None):
    """Decorator printing the wall time of each call
    (reference tools.py:28-38)."""
    def deco(fn):
        name = label or fn.__name__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[timing] {name}: {time.perf_counter() - t0:.3f} s")
            return out

        return wrapped
    return deco


def folder_path(path: str) -> str:
    """mkdir -p and return the path (reference tools.py:40-50)."""
    os.makedirs(path, exist_ok=True)
    return path
