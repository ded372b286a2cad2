"""Where the time of a PT (VPT, BDPT) pass goes on the GPU: wall time per
spp, device busy and idle share, launches per spp, and device and host time
by range.

    python -m adapt_tpu_torch.profile_pt scenes/cbox knot290k.xml --spp 2
    python -m adapt_tpu_torch.profile_pt scenes/cbox knot290k.xml --tier qpick
    python -m adapt_tpu_torch.profile_pt scenes/vpt cbox.xml --renderer vpt
    python -m adapt_tpu_torch.profile_pt scenes/cbox cbox.xml \
        --renderer bdpt --max-bounce 6
    python -m adapt_tpu_torch.profile_pt scenes/cbox bunny.xml \
        --renderer bdpt --spp 1 --runs 2
    python -m adapt_tpu_torch.profile_pt scenes/cbox cbox-rgbvol.xml \
        --renderer vpt --spp 1

Loads the scene on the CUDA device, renders one warm-up spp (which also
runs the auto-compaction probe), times `--runs` unprofiled render_batch
calls of `--spp` samples (host clock around work that ends in a
synchronize), then traces one more under torch.profiler with one range per
stage of the bounce loop (for BDPT: the two walks, and each connection
case; under `--tier qpick`, PT's front pass and sort, tile picks, unsort
and winner read-out; a grid volume's delta and ratio tracking), and one
around each brute-force kernel's wrapper
(B1, B2, B3: its host time a call). A range's device time counts the
PyTorch kernels launched inside it; the port's own kernels (launched
through ctypes, which the profiler ties to no range) are attributed to
the ranges open when their wrapper launched them, in launch order, and
shown beside ("own"). `--tier` names the kernels of the big-scene tier
(`RenderConfig.big_tier`: bvh, sweep or qpick). Prints one line per
range, the kernels that take the most device time and the port's own
kernels, and a JSON summary (also written to `--out` when given). Needs
one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

from . import rng
from .ops import bvh_kernels, bxdf_ops, cluster_kernels, emitter_ops
from .ops import intersect_kernels, medium_ops, splat, volume_ops
from .ops.intersect import BIG_TIERS
from .renderer import bdpt, compact, pt, vpt
from .scene.compile import load_scene

_SHADING = (
    (bxdf_ops, "surface_sample", "surface_sample"),
    (bxdf_ops, "surface_eval", "surface_eval"),
    (bxdf_ops, "surface_pdf", "surface_pdf"),
    (bxdf_ops, "gather_mat", "gather_mat"),
)
# the brute-force kernels' wrappers, timed on their own (host ms a call)
_WRAPPERS = (
    (intersect_kernels, "tri_closest_hit", "B1 wrapper"),
    (intersect_kernels, "tri_any_hit", "B2 wrapper"),
    (intersect_kernels, "tri_track_hits", "B3 wrapper"),
)
# the grid volume's march (ops/volume_ops.py): delta tracking on each
# segment, ratio tracking in each track_ray
_VOLUME = (
    (volume_ops, "sample_distance_delta_tracking", "delta tracking"),
    (volume_ops, "eval_tr_ratio_tracking", "ratio tracking"),
)
# (module, attribute, range name): the stages a pass spends time in, per
# renderer; ranges may nest (track_ray holds ray_track_hits)
RANGES = {
    "pt": ((rng, "lane_uniform", "rng.lane_uniform"),
           (pt, "ray_intersect", "ray_intersect"),
           (pt, "get_uv_item", "texture fetch"),
           (pt, "does_intersect", "does_intersect"),
           (cluster_kernels, "_front_sort", "qpick front + sort"),
           (cluster_kernels, "tile_picks", "qpick tile_picks"),
           (cluster_kernels, "_unsort", "qpick unsort"),
           (cluster_kernels, "resolve_winner", "resolve_winner"),
           *_SHADING,
           (pt, "camera_rays", "camera_rays"),
           (compact, "run_compacted", "bounce loop"), *_WRAPPERS),
    "vpt": ((rng, "lane_uniform", "rng.lane_uniform"),
            (vpt, "ray_intersect", "ray_intersect"),
            (vpt, "get_uv_item", "texture fetch"),
            (vpt, "track_ray", "track_ray"),
            (vpt, "_track_loop", "_track_loop"),
            (vpt, "ray_track_hits", "ray_track_hits"),
            (medium_ops, "sample_mfp", "sample_mfp"),
            (medium_ops, "phase_sample", "phase_sample"),
            (medium_ops, "phase_eval", "phase_eval"),
            (emitter_ops, "sample_hit", "sample_hit"),
            *_VOLUME, *_SHADING,
            (vpt, "camera_rays", "camera_rays"),
            (compact, "run_compacted", "iteration loop"), *_WRAPPERS),
    # "{case}": one range per connection case (s0, t1, s1, gen)
    "bdpt": ((rng, "uniform", "rng.uniform"),
             (bdpt, "generate_eye_path", "eye walk"),
             (bdpt, "generate_light_path", "light walk"),
             (bdpt, "ray_intersect", "ray_intersect"),
             (bdpt, "get_uv_item", "texture fetch"),
             (bdpt, "connect_strategy", "connect {case}"),
             (bdpt, "eval_vertex", "eval_vertex"),
             (bdpt, "pdf_vertex", "pdf_vertex"),
             (bdpt, "_mis_weight", "_mis_weight"),
             (bdpt, "track_ray", "track_ray"),
             (vpt, "_track_loop", "_track_loop"),
             (vpt, "ray_track_hits", "ray_track_hits"),
             (medium_ops, "sample_mfp", "sample_mfp"),
             (medium_ops, "phase_sample", "phase_sample"),
             (emitter_ops, "sample_hit", "sample_hit"),
             *_VOLUME, *_SHADING,
             (bdpt, "splat_sorted_accumulate", "film splat"), *_WRAPPERS),
}
CASES = ("s0", "t1", "s1", "gen")
TOP = 8               # kernels listed by device time
# the port's hand-written kernels (csrc/), always listed
OWN_KERNELS = ("tri_", "bvh_", "splat_", "cluster_")
# (module, wrapper, its launch counter, kernel): the wrappers whose
# launches are attributed to the ranges open at the call (BDPT calls the
# film splat by the name it imported)
_OWN = tuple((at, wrapper, ops.launches, kernel)
             for at, ops in ((bvh_kernels, bvh_kernels),
                             (intersect_kernels, intersect_kernels),
                             (bdpt, splat))
             for wrapper, kernel in ops.kernel_names.items())


def _ranged(fn, name, opened):
    """fn inside a profiler range; `opened` lists the ranges open now,
    innermost last."""
    def wrapped(*args, **kw):
        full = name.format(case=kw.get("case"))
        opened.append(full)
        try:
            with torch.profiler.record_function(full):
                return fn(*args, **kw)
        finally:
            opened.pop()
    return wrapped


def _recorded(fn, counter, key, opened, calls):
    """fn, appending the open ranges to `calls` at each launch that
    counter[key] counts."""
    def wrapped(*args, **kw):
        before = counter[key]
        out = fn(*args, **kw)
        calls.extend([tuple(opened)] * (counter[key] - before))
        return out
    return wrapped


def _own_by_range(kernels, calls, spp):
    """{range: device ms/spp of the port's kernels launched inside it}:
    the k-th kernel of a name on the card is the k-th launch its wrapper
    counted (one stream). A name whose counts disagree is left out."""
    out = {}
    for kname, opened in calls.items():
        evs = sorted((e for e in kernels
                      if e.name.removeprefix("void ").startswith(kname)),
                     key=lambda e: e.time_range.start)
        if len(evs) != len(opened):
            continue
        for e, ranges in zip(evs, opened):
            for name in set(ranges):
                out[name] = out.get(name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / spp
    return out


def _names(ranges):
    """Every range name, "{case}" ones once per case."""
    return [n.format(case=c) for _, _, n in ranges
            for c in (CASES if "{case}" in n else (None,))]


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
    ap.add_argument("--renderer", choices=tuple(RANGES), default="pt")
    ap.add_argument("--tier", choices=BIG_TIERS, default="bvh",
                    help="kernels of the big-scene tier (big_tier)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    ranges = RANGES[args.renderer]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    scene, cfg, _ = load_scene(args.directory, args.file)
    cfg = dataclasses.replace(cfg, big_tier=args.tier)
    if args.max_bounce:
        cfg = dataclasses.replace(cfg, max_bounce=args.max_bounce)
    r = {"pt": pt.Renderer, "vpt": vpt.VolumeRenderer,
         "bdpt": bdpt.BDPT}[args.renderer](scene, cfg, seed=0)
    r.render_batch(1)
    walls = [_timed(r, args.spp) / args.spp for _ in range(args.runs)]
    wall = statistics.median(walls)

    saved = [(m, a, getattr(m, a)) for m, a, _ in ranges]
    opened = []
    for (m, a, name), (_, _, fn) in zip(ranges, saved):
        setattr(m, a, _ranged(fn, name, opened))
    calls = {k: [] for *_, k in _OWN}
    saved += [(m, a, getattr(m, a)) for m, a, _, _ in _OWN]
    for m, a, counter, k in _OWN:
        setattr(m, a, _recorded(getattr(m, a), counter, a, opened,
                                calls[k]))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            prof_wall = _timed(r, args.spp) / args.spp
    finally:
        for m, a, fn in reversed(saved):
            setattr(m, a, fn)

    spp = args.spp
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / spp
    own_in = _own_by_range(kernels, calls, spp)
    rows = []
    for name in _names(ranges):
        hits = [e for e in events if e.name == name and e.device_type != cuda]
        if hits:      # device ms: the kernels launched inside the range
            host = sum(e.cpu_time_total for e in hits) / 1e3
            rows.append({
                "range": name, "calls": len(hits) / spp,
                "device_ms": sum(e.device_time_total for e in hits) / 1e3
                / spp, "own_device_ms": own_in.get(name, 0.0),
                "host_ms": host / spp, "host_ms_per_call": host / len(hits)})
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / spp
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    own = {k: v for k, v in by_name.items()
           if k.removeprefix("void ").startswith(OWN_KERNELS)}
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
           "top_kernels_ms_per_spp": dict(top),
           "own_kernels_ms_per_spp": own}
    print(f"{args.file} {cfg.w}x{cfg.h} mb {cfg.max_bounce} tier "
          f"{args.tier} [{card}]: "
          f"ms/spp {', '.join(f'{1e3 * w:.3f}' for w in walls)} "
          f"(profiled {1e3 * prof_wall:.3f}); device busy {busy:.3f} ms/spp,"
          f" idle share {out['idle_share']:.3f}; "
          f"{out['kernels_per_spp']:.0f} kernels/spp; schedule "
          f"{out['schedule']}")
    for row in rows:
        print(f"  {row['range']:<20} calls {row['calls']:>6.1f}  device "
              f"{row['device_ms']:9.3f} ms (+ own {row['own_device_ms']:.3f})"
              f"  host {row['host_ms']:9.3f} ms "
              f"({row['host_ms_per_call']:.4f} a call)")
    for name, ms in top + sorted(own.items()):
        print(f"  kernel {name[:60]:<60} {ms:9.3f} ms/spp")
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
