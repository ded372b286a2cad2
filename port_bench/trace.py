"""The traced passes of a `--trace 1` run: torch.profiler over whole
passes, with a range set from the benchmark around each call into a layer
of the program, and each launch of a hand-written kernel recorded with the
ranges open at its wrapper call and the operands its byte bound needs.

The ranges are the traffic driver's (`ranges()`: PT's in drivers/pt.py).
Range tables, the attribution of ctypes-launched kernels to ranges by
launch order, and the busy arithmetic are frozen from
adapt_tpu_torch/profile_pt.py; the busy time here is the union of the
kernel intervals, so overlapping kernels count once.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import bounds

# the port's hand-written kernels (csrc/), by the prefix of their names
OWN_PREFIXES = ("tri_", "bvh_", "splat_", "cluster_")


def own_wrappers():
    """[(module, wrapper, kernel name)] of every hand-written kernel."""
    from adapt_tpu_torch.ops import bvh_kernels, intersect_kernels, splat
    return [(m, w, k) for m in (intersect_kernels, bvh_kernels, splat)
            for w, k in m.kernel_names.items()]


class Recorder:
    """Wraps the program's layers while installed: ranges, and one record
    (wrapper, ranges open, rays, far) per own-kernel call."""

    def __init__(self, ranges):
        self.ranges = ranges
        self.opened = []
        self.calls = []
        self._saved = []

    def _ranged(self, fn, name):
        def wrapped(*args, **kw):
            self.opened.append(name)
            try:
                with torch.profiler.record_function(name):
                    return fn(*args, **kw)
            finally:
                self.opened.pop()
        return wrapped

    def _recorded(self, fn, wrapper, kernel):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if wrapper in bounds.BYTES:
                scene, ray_o, _ray_d, far = args[:4]
                self.calls.append((kernel, tuple(self.opened), wrapper,
                                   scene, ray_o.shape[0], far))
            else:
                self.calls.append((kernel, tuple(self.opened), wrapper,
                                   None, 0, None))
            return out
        return wrapped

    @contextlib.contextmanager
    def installed(self):
        self._saved = [(m, a, getattr(m, a)) for m, a, _ in self.ranges]
        for m, a, name in self.ranges:
            setattr(m, a, self._ranged(getattr(m, a), name))
        for m, w, k in own_wrappers():
            self._saved.append((m, w, getattr(m, w)))
            setattr(m, w, self._recorded(getattr(m, w), w, k))
        try:
            yield self
        finally:
            for m, a, fn in reversed(self._saved):
                setattr(m, a, fn)


def short(name):
    """A kernel's name without `void`, namespaces and the template's
    tail: at most 100 characters."""
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:100]


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def traced_passes(drv, renderer, passes, sync):
    """Profile `passes` whole passes (`drv.step(renderer)`) under the
    driver's ranges; returns the record the per-layer readers read. Raises
    when the profiler saw no kernel (a CUDA graph hides its kernels from
    it)."""
    rec = Recorder(drv.ranges())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with rec.installed(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            with torch.profiler.record_function("pass"):
                drv.step(renderer)
                sync()
        wall = time.perf_counter() - t0
    return reduce(prof.events(), rec, passes, wall, rec.ranges)


def reduce(events, rec, passes, wall, ranges):
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler saw no kernel in the traced passes")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us, gaps = _union(spans)

    by_name = {}
    for e in kernels:
        name = short(e.name)
        by_name[name] = by_name.get(name, 0.0) \
            + e.time_range.elapsed_us() / 1e6
    names = [n for *_, n in ranges]
    host = [e for e in events if e.device_type != cuda]
    layer = {}
    for name in names:
        hits = [e for e in host if e.name == name]
        if hits:
            layer[name] = dict(
                calls=len(hits),
                host_ms=sum(e.cpu_time_total for e in hits) / 1e3,
                device_ms=sum(e.device_time_total for e in hits) / 1e3)

    # own kernels: the k-th kernel of a name is the k-th launch recorded
    own_ms, bound_ms, matched = 0.0, 0.0, True
    by_kernel = {}
    for call in rec.calls:
        by_kernel.setdefault(call[0], []).append(call)
    for kname, calls in by_kernel.items():
        evs = sorted((e for e in kernels
                      if e.name.removeprefix("void ").startswith(kname)),
                     key=lambda e: e.time_range.start)
        if len(evs) != len(calls):
            matched = False
            continue
        for e, (_k, opened, wrapper, scene, n, far) in zip(evs, calls):
            ms = e.time_range.elapsed_us() / 1e3
            if wrapper not in bounds.BYTES:
                matched = False
                continue
            walking = int((far > bounds.RAY_EPS).sum())
            own_ms += ms
            bound_ms += bounds.bound_ms(
                bounds.BYTES[wrapper](scene, n, walking))
            for name in set(opened):
                if name in layer:
                    layer[name]["own_device_ms"] = \
                        layer[name].get("own_device_ms", 0.0) + ms
    own_total = sum(s for n, s in by_name.items()
                    if n.startswith(OWN_PREFIXES))

    # idle gaps on the device, by the innermost range open on the host
    ranged = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name in names or e.name == "pass"),
                    key=lambda r: r[1] - r[0])
    idle = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = next((n for a, b, n in ranged if a <= mid <= b),
                     "outside the traced ranges")
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    return dict(passes=passes, window_s=wall, busy_s=busy_us / 1e6,
                launches=len(kernels), layer=layer,
                own_device_s=own_total,
                own_bound_ms=bound_ms if matched and own_ms else None,
                own_matched_ms=own_ms if matched else None,
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
                idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]))
