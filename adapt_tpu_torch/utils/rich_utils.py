"""Rich progress extras: a speed column for the render loop (copy of
adapt_tpu/utils/rich_utils.py).

Fills the same UI slot as the reference's it/s column (utils/rich_utils.py)
but is an original implementation: it keeps its own short sliding window of
(time, completed) samples per task, so the displayed rate tracks the
CURRENT dispatch cadence (recent-window mean) rather than rich's
whole-run estimate: the first passes pay the kernels' builds, and a
whole-run average undersells the steady state.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque

try:
    from rich.progress import ProgressColumn
    from rich.text import Text
except ImportError:                      # pragma: no cover
    ProgressColumn = object
    Text = None


class ItersPerSecColumn(ProgressColumn):
    """Sliding-window iterations-per-second column.

    window: seconds of history used for the rate estimate."""

    def __init__(self, suffix: str = "it/s", window: float = 8.0):
        super().__init__()
        self.suffix = suffix
        self.window = float(window)
        self._hist: dict = defaultdict(deque)   # task.id -> (t, completed)

    def _rate(self, task):
        h = self._hist[task.id]
        now = time.monotonic()
        if not h or task.completed != h[-1][1]:
            h.append((now, task.completed))
        while len(h) > 1 and now - h[0][0] > self.window:
            h.popleft()
        t0, c0 = h[0]
        dt = now - t0
        if dt <= 0 or task.completed <= c0:
            return None
        return (task.completed - c0) / dt

    def render(self, task):
        if task.finished:
            rate = (task.completed / task.elapsed) if task.elapsed else None
        else:
            rate = self._rate(task)
        if rate is None:
            return Text("-- " + self.suffix, style="progress.data.speed")
        return Text(f"{rate:.2f} {self.suffix}",
                    style="progress.data.speed")
