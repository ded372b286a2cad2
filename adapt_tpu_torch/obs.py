"""The port's tracing: spans at the layer boundaries of a pass and of
set-up, and counters taken where the work happens.

    with obs.recording():           # or under a torch.profiler session
        renderer.render()
    rec = obs.export()              # {clock, spans, counters, dropped}

Recording is on while a torch.profiler session is active
(`torch.autograd._profiler_enabled()`) or inside `recording()`.
Otherwise `span()` returns one shared no-op context after one flag test:
it allocates no span, launches no device operation and reads nothing
back, and `count`, `lanes`, `tally` and `annotate` return after the
same test.
Set-up spans (`setup_span`: a handful a process) are recorded always.
Under the profiler each recorded span also opens a profiler range of its
name (`torch.profiler.record_function`, in its C++ form), so a chrome
trace carries the program's layer names on the device trace's own
timeline.

A span holds its name, id, the id of the span open around it (0: none),
the pass it belongs to (the `cnt` of the enclosing `render.pass`, shared
by every span of one pass), start and end in ns, and attributes (ints, or
a short name such as a strategy case or a tier).
The clock is the profiler's: ns since the unix epoch, as kineto's
`trace_start_ns()` plus an event's `time_range` in us. A span reads
`time.perf_counter_ns()`, offset by an anchor against `time.time_ns()`
taken as each outermost span opens, so the spans of one tree share an
anchor and the clock does not drift across a long run. A span's interval
encloses its profiler event.

Span names: `setup.*` (set-up), `render.*` (a pass and its camera rays),
`pt.*`, `vpt.*`, `bdpt.*` (the integrators' loops and connections;
`bdpt.bin`, with its strategy case and lanes, a transient binning),
`rng.*`, `isect.*`, `kernel.<wrapper>` (a hand-written kernel's launch on
CUDA), `shade.*`, `light.*`, `vol.*`. None equals a range name the
benchmark sets around calls into the program (port_bench/drivers), nor
"pass".

Counters (all in `export()["counters"]`): `launches` (the kernel
wrappers' own dicts, counted always), `build_seconds` (ops/_build.py),
`rng.words` (uniforms drawn), `lanes.issued` (the wavefront's width, each
bounce), `lanes.live` (an int64 device accumulator of each bounce's live
lanes: added on the device, read once by `export()`), `compact.splits`,
`compact.overflows`, `transient.offered` (the lanes BDPT's transient
binning is offered, `bdpt.bin`'s `lanes`), `transient.binned` (the
histogram entries it keeps: a device counter, `tally`, one int64 slot
added on the device, read once by `export()`), and by site `host.reads`
and `host.read_wait_ns` (every deliberate device-to-host read goes
through `host_read`).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch

PASS = "render.pass"
MAX_SPANS = 1 << 18
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
# the profiler's range, in its C++ form where torch has it: a tenth of
# `torch.profiler.record_function`'s cost a range under the profiler
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _Off:
    """The shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class Span:
    """One recorded span; `set(**attrs)` adds attributes."""
    __slots__ = ("tracer", "name", "id", "parent", "pass_id", "start",
                 "end", "attrs", "_rf")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self._rf = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        if _profiling():
            self._rf = _range(self.name)
        self.tracer._open(self)
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.tracer._close(self)
        return False


class Tracer:
    """The spans and counters of one process (`TRACER`); callers go
    through the module's functions. A thread keeps its own stack of open
    spans; ids come from one counter and closed spans go to one list."""

    def __init__(self, cap=MAX_SPANS):
        self.cap = cap
        self.forced = 0               # depth of open `recording()` blocks
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self):
        with self._lock:
            self.closed = []          # closed spans' records, in order
            self.dropped = 0
            self._ids = itertools.count(1)
            self.counts = {}
            self.reads = {}
            self.wait_ns = {}
            self.live = {}            # device -> int64 accumulators
            self.tallies = {}         # (name, device) -> one int64 slot

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, sp):
        st = self._stack()
        if st:
            top = st[-1]
            sp.parent, sp.pass_id = top.id, top.pass_id
        else:
            sp.parent, sp.pass_id = 0, None
            self._local.anchor = time.time_ns() - _now()
        if sp.name == PASS:
            sp.pass_id = sp.attrs.get("cnt")
        sp.id = next(self._ids)
        st.append(sp)
        sp.start = _now() + self._local.anchor

    def _close(self, sp):
        sp.end = _now() + self._local.anchor
        st = self._stack()
        if st[-1] is sp:
            st.pop()
        else:
            st.remove(sp)
        if len(self.closed) < self.cap:
            # a tuple of plain values, which the garbage collector stops
            # tracking (a span object it would walk at every collection)
            self.closed.append((sp.name, sp.id, sp.parent, sp.pass_id,
                                sp.start, sp.end, sp.attrs))
        else:
            with self._lock:
                self.dropped += 1

    def add(self, name, n):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n


TRACER = Tracer()


def span(name, **attrs):
    """A span around a layer's call, or `OFF` while not recording."""
    if TRACER.forced or _profiling():
        return Span(TRACER, name, attrs)
    return OFF


def setup_span(name, **attrs):
    """A set-up span: recorded always."""
    return Span(TRACER, name, attrs)


def spanned(name, attrs=None, setup=False):
    """Decorator: each call of the function inside span `name`;
    `attrs(*args, **kw)` gives its attributes, asked only while recording
    (setup: a set-up span, recorded always)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not (setup or TRACER.forced or _profiling()):
                return fn(*args, **kw)
            with Span(TRACER, name, attrs(*args, **kw) if attrs else {}):
                return fn(*args, **kw)
        return wrapped
    return deco


def annotate(**attrs):
    """Add attributes to the innermost open span of this thread."""
    if TRACER.forced or _profiling():
        st = TRACER._stack()
        if st:
            st[-1].attrs.update(attrs)


def count(name, n=1):
    """Add n to the counter `name`."""
    if TRACER.forced or _profiling():
        TRACER.add(name, int(n))


def lanes(active):
    """One bounce's lanes: its width to `lanes.issued` on the host, its
    live lanes to the device's `lanes.live` accumulator: one int64 slot a
    lane, `active` added into its first slots (one device operation, no
    read; a reduction would take three)."""
    if not (TRACER.forced or _profiling()):
        return
    n = int(active.shape[0])
    TRACER.add("lanes.issued", n)
    with TRACER._lock:
        acc = TRACER.live.get(active.device)
        if acc is None or acc[-1].shape[0] < n:
            # a wider wavefront than any before: a new accumulator
            acc = TRACER.live.setdefault(active.device, [])
            acc.append(torch.zeros(n, dtype=torch.int64,
                                   device=active.device))
    acc[-1][:n].add_(active)


def tally(name, mask):
    """A device counter: the True entries of `mask` added into the int64
    slot `name` on mask's device (a sum and an add, no read; `export()`
    reads each slot once)."""
    if not (TRACER.forced or _profiling()):
        return
    with TRACER._lock:
        slot = TRACER.tallies.get((name, mask.device))
        if slot is None:
            slot = TRACER.tallies[(name, mask.device)] = torch.zeros(
                1, dtype=torch.int64, device=mask.device)
    slot.add_(mask.sum())


def host_read(t, site):
    """`t` on the host (`t.cpu()`): a deliberate device-to-host read,
    counted and timed by site while recording."""
    if not (TRACER.forced or _profiling()):
        return t.cpu()
    t0 = _now()
    out = t.cpu()
    wait = _now() - t0
    with TRACER._lock:
        TRACER.reads[site] = TRACER.reads.get(site, 0) + 1
        TRACER.wait_ns[site] = TRACER.wait_ns.get(site, 0) + wait
    return out


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    with TRACER._lock:
        TRACER.forced += 1
    try:
        yield
    finally:
        with TRACER._lock:
            TRACER.forced -= 1


def reset():
    """Drop every recorded span and counter (the `launches` dicts and
    `build_seconds` are their modules' own and stay)."""
    TRACER.reset()


def export() -> dict:
    """{"clock", "spans", "counters", "dropped"}: the spans in the order
    they closed, each {"name", "id", "parent", "pass", "start_ns",
    "end_ns", "attrs"}. Reads the live-lane accumulators from the device
    (one read each)."""
    from . import rng
    from .ops import _build, bvh_kernels, cluster_kernels, intersect_kernels
    from .ops import splat
    t = TRACER
    with t._lock:
        closed, counts = list(t.closed), dict(t.counts)
        reads, wait_ns = dict(t.reads), dict(t.wait_ns)
        live, dropped = list(t.live.values()), t.dropped
        tallies = dict(t.tallies)
    counters = {
        "launches": {m.__name__.rsplit(".", 1)[-1]: dict(m.launches)
                     for m in (intersect_kernels, bvh_kernels, splat,
                               cluster_kernels, rng)},
        "build_seconds": dict(_build.build_seconds),
        "rng.words": counts.get("rng.words", 0),
        "lanes.issued": counts.get("lanes.issued", 0),
        "lanes.live": sum(int(a.sum().item()) for acc in live
                          for a in acc),
        "compact.splits": counts.get("compact.splits", 0),
        "compact.overflows": counts.get("compact.overflows", 0),
        "transient.offered": counts.get("transient.offered", 0),
        "transient.binned": sum(int(v.item()) for (n, _d), v
                                in tallies.items()
                                if n == "transient.binned"),
        "host.reads": reads, "host.read_wait_ns": wait_ns}
    spans = [{"name": n, "id": i, "parent": p, "pass": c, "start_ns": s,
              "end_ns": e, "attrs": dict(a)}
             for n, i, p, c, s, e, a in closed]
    return {"clock": {"unit": "ns", "epoch": "unix",
                      "source": "perf_counter_ns + time.time_ns() anchor, "
                                "the profiler's host clock"},
            "spans": spans, "counters": counters, "dropped": dropped}
