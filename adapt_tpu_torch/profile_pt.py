"""Where the time of a PT (VPT, BDPT) pass goes on the GPU: wall time per
spp, device busy and idle share, launches per spp, and device and host time
by the program's own spans (adapt_tpu_torch/obs.py).

    python -m adapt_tpu_torch.profile_pt scenes/cbox knot290k.xml --spp 2
    python -m adapt_tpu_torch.profile_pt scenes/cbox knot290k.xml --tier qpick
    python -m adapt_tpu_torch.profile_pt scenes/vpt cbox.xml --renderer vpt
    python -m adapt_tpu_torch.profile_pt scenes/cbox cbox.xml \
        --renderer bdpt --max-bounce 6
    python -m adapt_tpu_torch.profile_pt scenes/cbox bunny.xml \
        --renderer bdpt --spp 1 --runs 2
    python -m adapt_tpu_torch.profile_pt scenes/cbox cbox-rgbvol.xml \
        --renderer vpt --spp 1
    python -m adapt_tpu_torch.profile_pt scenes/trans cbox-point.xml \
        --renderer bdpt --spp 1 --runs 1

Loads the scene on the CUDA device, renders one warm-up spp (which also
runs the auto-compaction probe), times `--runs` unprofiled render_batch
calls of `--spp` samples (host clock around work that ends in a
synchronize), then traces one more under torch.profiler, where the
program records a span at each layer boundary and opens a profiler range
of the span's name. One row a span name: calls, device time of the
kernels launched inside it (the port's own kernels too: the profiler ties
a ctypes launch to the ranges open around it), host time and self time
(less its child spans). The device's idle gaps are attributed to the
innermost span open at their midpoint, on the clock the spans share with
the profiler. `--tier` names the kernels of the big-scene tier
(`RenderConfig.big_tier`: bvh, sweep or qpick). Prints the rows, the idle
gaps by span, the host reads by site, the program's counters, the
kernels that take the most device time and the port's own kernels (those
of ops/_build.py's libraries), and a JSON summary (also written to
`--out` when given). Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

from . import obs
from .ops import _build
from .ops.intersect import BIG_TIERS
from .renderer import bdpt, pt, vpt
from .scene.compile import load_scene

RENDERERS = {"pt": pt.Renderer, "vpt": vpt.VolumeRenderer, "bdpt": bdpt.BDPT}
TOP = 8               # kernels listed by device time


def _union(intervals):
    """(total length of the union of (start, end) intervals, the gaps
    between them)."""
    total, gaps, cur = 0, [], None
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


def _self_ns(spans):
    """{span id: its ns less the union of its children's}."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append((s["start_ns"], s["end_ns"]))
    return {s["id"]: s["end_ns"] - s["start_ns"]
            - _union(kids.get(s["id"], ()))[0] for s in spans}


def _idle_by_span(gaps, spans):
    """{innermost span open at each (start_ns, end_ns) gap's midpoint:
    seconds}, by a sweep over the nested spans."""
    marks = [(s["start_ns"], 0, s["start_ns"] - s["end_ns"], s)
             for s in spans]
    marks += [(s["end_ns"], 2, s["end_ns"] - s["start_ns"], s)
              for s in spans]
    marks += [((a + b) // 2, 1, b - a, None) for a, b in gaps]
    opened, out = [], {}
    for _t, kind, x, s in sorted(marks, key=lambda m: m[:3]):
        if kind == 0:
            opened.append(s)
        elif kind == 2:
            opened.remove(s)
        else:
            label = opened[-1]["name"] if opened \
                else "outside the program's spans"
            out[label] = out.get(label, 0.0) + x / 1e9
    return out


def _timed(r, spp):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_batch(spp)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("directory")
    ap.add_argument("file")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--max-bounce", type=int, default=0,
                    help="override the scene's max_bounce (0: keep)")
    ap.add_argument("--renderer", choices=tuple(RENDERERS), default="pt")
    ap.add_argument("--tier", choices=BIG_TIERS, default="bvh",
                    help="kernels of the big-scene tier (big_tier)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    scene, cfg, _ = load_scene(args.directory, args.file)
    cfg = dataclasses.replace(cfg, big_tier=args.tier)
    if args.max_bounce:
        cfg = dataclasses.replace(cfg, max_bounce=args.max_bounce)
    r = RENDERERS[args.renderer](scene, cfg, seed=0)
    r.render_batch(1)
    walls = [_timed(r, args.spp) / args.spp for _ in range(args.runs)]
    wall = statistics.median(walls)

    obs.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = _timed(r, args.spp) / args.spp
    rec = obs.export()
    spans = rec["spans"]

    spp = args.spp
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not e.is_user_annotation]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    busy_us, gaps = _union([(e.time_range.start, e.time_range.end)
                            for e in kernels])
    busy = busy_us / 1e3 / spp
    idle = _idle_by_span([(t0 + round(a * 1e3), t0 + round(b * 1e3))
                          for a, b in gaps], spans)
    self_ns = _self_ns(spans)
    device = {}
    for e in events:
        if e.device_type != cuda:
            device[e.name] = device.get(e.name, 0.0) + e.device_time_total
    rows = {}
    for s in spans:
        row = rows.setdefault(s["name"], [0, 0, 0])
        row[0] += 1
        row[1] += s["end_ns"] - s["start_ns"]
        row[2] += self_ns[s["id"]]
    rows = [{"range": name, "calls": n / spp,
             "device_ms": device.get(name, 0.0) / 1e3 / spp,
             "host_ms": host / 1e6 / spp, "self_host_ms": own / 1e6 / spp,
             "host_ms_per_call": host / 1e6 / n}
            for name, (n, host, own) in sorted(rows.items(),
                                               key=lambda kv: -kv[1][1])]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / spp
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    own_names = tuple(k for lib in _build.libraries.values()
                      for k in lib.kernel_names.values())
    own = {k: v for k, v in by_name.items()
           if k.removeprefix("void ").startswith(own_names)}
    c = rec["counters"]
    reads = {site: {"reads": n / spp,
                    "wait_ms": c["host.read_wait_ns"][site] / 1e6 / spp}
             for site, n in c["host.reads"].items()}
    out = {"scene": args.file, "w": cfg.w, "h": cfg.h,
           "max_bounce": cfg.max_bounce, "spp": spp, "card": card,
           "renderer": args.renderer, "tier": args.tier,
           "schedule": list(getattr(r, "schedule", None)
                            or getattr(r, "_sched", None) or ()),
           "ms_per_spp": [1e3 * w for w in walls],
           "profiled_ms_per_spp": 1e3 * prof_wall,
           "device_busy_ms_per_spp": busy,
           "idle_share": 1.0 - busy / (1e3 * wall),
           "kernels_per_spp": len(kernels) / spp, "ranges": rows,
           "idle_s_by_span": dict(sorted(idle.items(),
                                         key=lambda kv: -kv[1])),
           "host_reads_per_spp": reads,
           "live_lane_share": c["lanes.live"] / c["lanes.issued"]
           if c["lanes.issued"] else None,
           "counters_per_spp": {k: c[k] / spp for k in (
               "rng.words", "lanes.issued", "compact.splits",
               "compact.overflows", "transient.offered",
               "transient.binned")},
           "dropped_spans": rec["dropped"],
           "top_kernels_ms_per_spp": dict(top),
           "own_kernels_ms_per_spp": own}
    print(f"{args.file} {cfg.w}x{cfg.h} mb {cfg.max_bounce} tier "
          f"{args.tier} [{card}]: "
          f"ms/spp {', '.join(f'{1e3 * w:.3f}' for w in walls)} "
          f"(profiled {1e3 * prof_wall:.3f}); device busy {busy:.3f} ms/spp,"
          f" idle share {out['idle_share']:.3f}; "
          f"{out['kernels_per_spp']:.0f} kernels/spp; schedule "
          f"{out['schedule']}; live lanes {out['live_lane_share']}; "
          f"{out['counters_per_spp']}")
    for row in rows:
        print(f"  {row['range']:<24} calls {row['calls']:>6.1f}  device "
              f"{row['device_ms']:9.3f} ms  host {row['host_ms']:9.3f} ms, "
              f"self {row['self_host_ms']:8.3f} "
              f"({row['host_ms_per_call']:.4f} a call)")
    for name, s in out["idle_s_by_span"].items():
        print(f"  idle in {name:<24} {1e3 * s / spp:9.3f} ms/spp")
    for site, v in reads.items():
        print(f"  host read {site:<22} {v['reads']:7.1f} a spp, wait "
              f"{v['wait_ms']:.3f} ms/spp")
    for name, ms in top + sorted(own.items()):
        print(f"  kernel {name[:60]:<60} {ms:9.3f} ms/spp")
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
