#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adapt_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs nvcc and g++ (the kernels build from csrc/, the BVH builder from
native/, all into build/adapt_tpu_torch/, started together) and one CUDA
device. Each phase prints one line; any failure ends the run with a
non-zero exit and no result line.

1. device: the card's name and power limit, the build times, knot290k's
   procedural mesh (scripts/gen_procedural.py `ensure`) and the knot290k
   scene's set-up time (parse, BVH build, upload);
2. kernels: each hand-written CUDA kernel against its plain PyTorch twin
   at 512^2 shapes (262,144 rays a batch): the brute-force pair on cbox,
   the BVH pair on knot290k (primary rays; bounce rays from the primary
   hits in seeded random directions with 15% dead lanes; shadow rays to
   the point light). Hit ids and occlusion exactly equal, t within rtol
   2e-6, u/v within rtol 2e-5 atol 2e-6 (same operation order: 0
   expected; the BVH closest hit bit-equal); times by CUDA events, median
   of 5 single calls, and each kernel's bound; 2b also gives the BVH
   kernels' device times (a CUDA graph of 10 calls, no host time), their
   registers, spills, blocks resident per SM and waves;
   2c: the media-walk kernel on the vpt cbox (NEE shadow rays from the
   primary hits to area-light samples at K = 2; bounce rays with 15% dead
   lanes at K = 2 and, every triangle an interface, at K = 7): every
   output exactly equal to the twin's, with the null-hit, overflow and
   blocker shares; 2d: the film-splat kernel on four 512^2 streams of
   1,572,864 updates (the t=1 stream of one BDPT cbox pass at 6 bounces, a
   uniform one with 10% dropped, one whose first 1024-pixel tile holds
   70,000 updates, and the uniform one with 200,000 of its updates moved
   to one pixel), bit-equal to its plain version, with index_add_'s time
   beside it, single calls and device times; 2e: the five cluster kernels
   on knot290k (the all-cluster
   sweep's closest hit and any hit, the queue-pick schedule's front pass
   and its two pick passes on the picks the schedule itself derives):
   every output bit-equal to the plain version's, the sweep kernels also
   against the BVH kernels on the same rays (under 1e-4 of lanes may
   differ: the two prim tests round u and v in another order, so a ray
   grazing an edge may take the neighbour), with times and bounds;
3. golden: render_pass_pt on the card at the settings of
   tests/test_goldens.py against tests/goldens/cbox_pt_48.npy; 3b: the
   same for render_pass_vpt against tests/goldens/vptcbox_48.npy; 3c: for
   render_pass_bdpt against tests/goldens/cbox_bdpt_48.npy;
4. cbox main path: Renderer on cbox 512^2 at 8 bounces (bench.py's
   setting), render_batch of a few spp with the launch counts read around
   it; the image must be finite with mean > 0.05 and match the same render
   with the twins in place of the kernels under the goldens' bounds;
5. knot290k main path: Renderer on knot290k.xml at its own settings (512^2,
   12 bounces, auto-compaction): the derived schedule, one warm-up spp,
   then render_batch of a few spp with 12 launches of each BVH kernel per
   spp and none of the brute-force ones; the image equal to the same
   render with no compaction, and at 64^2 the render with the twins in
   place matches under the goldens' bounds;
6. vpt cbox main path: VolumeRenderer on scenes/vpt/cbox.xml at its own
   settings (512^2, 16 bounces, 24 iterations, schedule ((7, 2), (13, 8))):
   one warm-up spp, then render_batch of a few spp with one media-walk
   launch per iteration and shadow ray; the image equal to the same render
   with no compaction, and at 64^2 the render with the twins in place
   matches under the goldens' bounds;
7. BDPT main path: BDPT on cbox 512^2 at 6 bounces (the JAX package's
   bench row, scripts/bench_all.py:74-78): one warm-up spp, then
   render_batch of a few spp with the launch counts the code gives (12
   closest hits, 3 media walks and 1 film splat per spp); the image
   finite, and at 64^2 the render with the twins in place matches under
   the goldens' bounds;
8. transient BDPT: one render_pass_bdpt on scenes/trans/cbox-point.xml at
   its own settings (512^2, 12 bounces, 400 time bins): bins and counts of
   the right shape, finite, some counts; the any-hit and film-splat kernels
   launched, the media walk not;
9. cluster tier main paths: Renderer on knot290k.xml at its own settings
   (512^2, 12 bounces, auto-compaction) with `big_tier="sweep"` and with
   `big_tier="qpick"`: one warm-up spp, then render_batch of a few spp
   with the launch counts the code gives (sweep: 12 sweep closest hits and
   12 sweep any hits per spp and no BVH kernel; queue-pick: 24 front
   passes, 24 + 24 pick passes and 12 + 12 BVH cleanup walks per spp); each
   image against phase 5's BVH-tier image of the same seed: the mean under
   the goldens' bound, every pixel within 5e-2 but for at most 1e-4 of
   them, whose path took another prim at a grazed edge (`_check_tier`);
   ms/spp of each tier beside the BVH tier's.

Then one JSON line of per-kernel numbers, the card line again, and the
result line {"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPP = 4            # cbox main-path samples per pixel (after one warm-up spp)
KNOT_SPP = 3       # knot290k main-path samples per pixel (after one warm-up)
VPT_SPP = 3        # vpt cbox main-path samples per pixel (after one warm-up)
BDPT_SPP = 3       # BDPT cbox main-path samples per pixel (after one warm-up)
REPS = 5           # kernel timing repetitions (median)
# largest share of lanes on which a cluster sweep kernel may take another
# prim than the BVH kernel (the two round u and v in another order)
LANES_DIFFER = 1e-4
# largest share of pixels of a cluster-tier image that may lie 5e-2 or more
# from the BVH tier's (a path that took the neighbour prim at a grazed
# edge); 1.53e-5 and 3.81e-6 were measured on knot290k at 4 spp
PIXELS_DIFFER = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 operations/s outside
# the tensor cores; a kernel's bound is the larger of its two times
HBM_BPS = 3.35e12
F32_OPS = 67e12
# operations of one (ray, triangle) test of csrc/tri_intersect.cu: six
# 3-term dots (5 each), the flat test, t, u, v and the five compares
TRI_PAIR_OPS = 47
KERNELS = {
    "tri_closest_hit": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                        "adapt_tpu/ops/intersect_pallas.py:58"),
    "tri_any_hit": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                    "adapt_tpu/ops/intersect_pallas.py:109"),
    "bvh_closest_hit": ("adapt_tpu_torch/csrc/bvh_intersect.cu",
                        "adapt_tpu/ops/cluster_pallas.py:647"),
    "bvh_any_hit": ("adapt_tpu_torch/csrc/bvh_intersect.cu",
                    "adapt_tpu/ops/cluster_pallas.py:766"),
    "tri_track_hits": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                       "adapt_tpu/ops/intersect_pallas.py:131"),
    "splat_sorted_accumulate": ("adapt_tpu_torch/csrc/splat.cu",
                                "adapt_tpu/ops/splat_pallas.py:52"),
    "cluster_closest_hit": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                            "adapt_tpu/ops/cluster_pallas.py:513"),
    "cluster_any_hit": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                        "adapt_tpu/ops/cluster_pallas.py:600"),
    "cluster_front": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                      "adapt_tpu/ops/cluster_pallas.py:1515"),
    "cluster_pick_closest": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                             "adapt_tpu/ops/cluster_pallas.py:1385"),
    "cluster_pick_any": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                         "adapt_tpu/ops/cluster_pallas.py:1691"),
}


def _require(ok, what):
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def _shown(launches):
    """The kernels a run launched, for a phase's line."""
    return {k: n for k, n in launches.items() if n}


def _check(img, ref):
    """tests/test_goldens.py `_check`: mean within 1e-3 relative, every
    value within 5e-2. Returns (max abs diff, mean, reference mean)."""
    _require(img.shape == ref.shape, f"shape {img.shape} vs {ref.shape}")
    _require(abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3),
             f"mean {img.mean()} vs {ref.mean()}")
    err = float(abs(img - ref).max())
    _require(err < 5e-2, f"max abs diff {err}")
    return err, float(img.mean()), float(ref.mean())


def _check_tier(img, ref):
    """A cluster-tier image against the BVH tier's from the same seed: the
    mean within 1e-3 relative, as the goldens' `_check` holds it. The two
    tiers round u and v in another order, so a ray that grazes an edge may
    take another prim and its pixel another path: up to PIXELS_DIFFER of
    the pixels may lie beyond the goldens' 5e-2, every other pixel within
    it. Returns (largest difference of the pixels within 5e-2, share of
    pixels beyond it, largest difference)."""
    _require(img.shape == ref.shape, f"shape {img.shape} vs {ref.shape}")
    _require(abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3),
             f"mean {img.mean()} vs {ref.mean()}")
    diff = abs(img - ref).max(axis=-1)
    beyond = float((diff >= 5e-2).mean())
    _require(beyond <= PIXELS_DIFFER,
             f"{beyond} of the pixels differ by 5e-2 or more")
    return float(diff[diff < 5e-2].max()), beyond, float(diff.max())


def _time_ms(torch, fn, reps=REPS):
    """Median over reps of one call, by CUDA events, after a warm-up
    (none when reps == 1)."""
    if reps > 1:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(torch, fn, calls=10):
    """Device ms of one call: the median over 5 replays of a CUDA graph of
    `calls` calls (after two calls on a side stream), by CUDA events. The
    host's time to issue a call, which `_time_ms` includes, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _bound(nbytes, ops):
    """(least ms the card could take, what sets it)."""
    b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _close(torch, got, want, far, name):
    """Kernel outputs (t, id, u, v, ...) against the twin's; returns the
    max abs difference of the floats."""
    t, ids, u, v = got[:4]
    wt, wids, wu, wv = want[:4]
    _require(torch.equal(ids, wids), f"{name}: hit ids differ from the twin")
    torch.testing.assert_close(t, wt, rtol=2e-6, atol=0.0)
    torch.testing.assert_close(u, wu, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(v, wv, rtol=2e-5, atol=2e-6)
    _require(bool((t[far < 0] == -3e38).all()),
             f"{name}: a dead lane did not come back with t = -3e38")
    _require(float((ids >= 0).float().mean()) > 0.2, f"{name}: few hits")
    return max(float((a - b).abs().max()) for a, b in
               ((t, wt), (u, wu), (v, wv)))


def knot_mesh():
    """Write knot290k.xml's one procedural mesh if it is missing, with
    scripts/gen_procedural.py `ensure` (numpy only: the script's
    `ensure_all` also writes grid volumes through the JAX package, which
    this script never loads)."""
    spec = importlib.util.spec_from_file_location(
        "gen_procedural", os.path.join(ROOT, "scripts", "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with contextlib.redirect_stdout(io.StringIO()):
        gen.ensure("knot290k.obj", 1450, 100)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import numpy as np
    from adapt_tpu_torch import native, rng
    from adapt_tpu_torch.ops import _build, bvh, bvh_kernels as BK
    from adapt_tpu_torch.ops import cluster_kernels as CK
    from adapt_tpu_torch.ops import emitter_ops, intersect_kernels as K
    from adapt_tpu_torch.ops import splat as S
    from adapt_tpu_torch.ops.intersect import DEAD, _is_null_obj
    from adapt_tpu_torch.parsers.xml_parser import scene_parsing
    from adapt_tpu_torch.renderer import bdpt as B, pt, vpt
    from adapt_tpu_torch.renderer.base import camera_rays
    from adapt_tpu_torch.scene import compile as C

    def reset():
        K.reset_launches()
        BK.reset_launches()
        S.reset_launches()
        CK.reset_launches()

    def counts():
        return {**K.launches, **BK.launches, **S.launches, **CK.launches}

    none = {k: 0 for k in KERNELS}

    # ---- 1. device, builds, assets, set-up ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        for f in [ex.submit(fn) for fn in (K._lib, BK._lib, S._lib, CK._lib,
                                           native._lib)]:
            f.result()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    knot_mesh()
    gen_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cbox_dir = os.path.join(ROOT, "scenes", "cbox")
    t0 = time.perf_counter()
    parsed = scene_parsing(cbox_dir, "knot290k.xml")
    parse_s = time.perf_counter() - t0
    bvh_s = []
    build_bvh = C.bvh_build

    def timed_build(aabbs):
        t = time.perf_counter()
        out = build_bvh(aabbs)
        bvh_s.append(time.perf_counter() - t)
        return out
    C.bvh_build = timed_build
    t0 = time.perf_counter()
    kscene, kcfg = C.compile_scene(*parsed, device="cpu")
    compile_s = time.perf_counter() - t0
    C.bvh_build = build_bvh
    t0 = time.perf_counter()
    kscene = kscene.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    _require(kscene.n_prims == 290010 and kcfg.max_bounce == 12
             and (kcfg.w, kcfg.h) == (512, 512), "knot290k settings")
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | builds started together, all done in "
          f"{build_s:.2f} s {_build.build_seconds} | knot mesh {gen_s:.2f} s | "
          f"knot290k set-up: parse {parse_s:.2f} s, compile {compile_s:.2f} "
          f"s of which BVH build {bvh_s[0]:.2f} s "
          f"({kscene.bvh_node_pack.shape[0]} nodes), upload {upload_s:.3f} "
          f"s", flush=True)

    # ---- 2a. brute-force kernels against their twins, cbox 512^2 ----
    scene, cfg0, _ = C.load_scene(cbox_dir, "cbox.xml")
    cfg = dataclasses.replace(cfg0, max_bounce=8)        # bench.py:35
    ro, rd = camera_rays(scene, cfg, rng.split(rng.PRNGKey(0))[1], 1)
    ro = ro.contiguous()
    N = ro.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    t_j = 0.1 + 11.9 * torch.rand((N, 1), generator=g, device=dev)
    bo = ro + rd * t_j
    bd = torch.randn((N, 3), generator=g, device=dev)
    bd = bd / bd.norm(dim=-1, keepdim=True)
    alive = torch.rand(N, generator=g, device=dev) > 0.15
    far_b = torch.where(alive, K.FAR, DEAD)
    far_p = torch.full((N,), K.FAR, device=dev)
    hit_t = K.tri_closest_hit_plain(scene, ro, rd, far_p)[0]
    so = ro + torch.where(hit_t < K.FAR, hit_t, 0.0)[:, None] * rd
    to_l = scene.emit_pos[0] - so
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None]
    far_s = torch.where(alive, dist - K.RAY_EPS, DEAD)

    errs = {k: 0.0 for k in KERNELS}
    for o, d, far in ((ro, rd, far_p), (bo, bd, far_b)):
        got = K.tri_closest_hit(scene, o, d, far)
        want = K.tri_closest_hit_plain(scene, o, d, far)
        _require(torch.equal(got[5], want[5]) and torch.equal(got[4], want[4]),
                 "closest-hit objects / normals differ from the twin")
        errs["tri_closest_hit"] = max(errs["tri_closest_hit"], _close(
            torch, got, want, far, "tri_closest_hit"))
    n_occ = 0
    for o, d, far in ((so, sd, far_s), (bo, bd, far_b)):
        occ = K.tri_any_hit(scene, o, d, far)
        _require(torch.equal(occ, K.tri_any_hit_plain(scene, o, d, far)),
                 "tri_any_hit: occlusion differs from the twin")
        _require(not bool(occ[far < 0].any()), "a dead lane is occluded")
        n_occ += int(occ.sum())
    _require(n_occ > 0, "no shadow ray was occluded")
    times = {
        "tri_closest_hit": (
            _time_ms(torch, lambda: K.tri_closest_hit(scene, bo, bd, far_b)),
            _time_ms(torch, lambda: K.tri_closest_hit_plain(scene, bo, bd,
                                                            far_b))),
        "tri_any_hit": (
            _time_ms(torch, lambda: K.tri_any_hit(scene, so, sd, far_s)),
            _time_ms(torch, lambda: K.tri_any_hit_plain(scene, so, sd,
                                                        far_s)))}
    # bounds: rays, far and the tables read once, outputs written once;
    # the closest hit tests every pair, the any hit each ray's rows up to
    # its first occluder (what these rays need)
    T = scene.tri_n.shape[0]
    geo_t, _u, _v, valid = K._hit_tables(K.tri_table(scene)[0], so, sd)
    first = torch.where(valid & (geo_t < far_s[:, None]),
                        torch.arange(T, device=dev), T).amin(dim=1)
    any_pairs = int(torch.where(far_s < 0, 0,
                                torch.clamp(first + 1, max=T)).sum())
    bounds = {
        "tri_closest_hit": _bound(N * 28 + T * 64 + N * 32,
                                  N * T * TRI_PAIR_OPS),
        "tri_any_hit": _bound(N * 28 + T * 48 + N, any_pairs * TRI_PAIR_OPS)}
    print("phase 2a brute-force kernels vs twins, cbox, %d rays: " % N
          + "; ".join(f"{k} exact ids, max abs err {errs[k]:.3g}, kernel "
                      f"{t:.4f} ms, twin {p:.4f} ms, bound "
                      f"{bounds[k][0]:.4f} ms ({bounds[k][1]})"
                      for k, (t, p) in times.items()) + f" [{card}]",
          flush=True)

    # ---- 2b. BVH kernels against their twin, knot290k 512^2 ----
    kro, krd = camera_rays(kscene, kcfg, rng.split(rng.PRNGKey(1))[1], 1)
    kro = kro.contiguous()
    kfar_p = torch.full((N,), K.FAR, device=dev)
    pt_t, p_prim = BK.bvh_closest_hit(kscene, kro, krd, kfar_p)[:2]
    kalive = (p_prim >= 0) & (torch.rand(N, generator=g, device=dev) > 0.15)
    kbo = kro + torch.where(kalive, pt_t, 0.0)[:, None] * krd
    kbd = torch.randn((N, 3), generator=g, device=dev)
    kbd = kbd / kbd.norm(dim=-1, keepdim=True)
    kfar_b = torch.where(kalive, K.FAR, DEAD)
    kto_l = kscene.emit_pos[0] - kbo
    kdist = kto_l.norm(dim=-1)
    ksd = kto_l / kdist[:, None]
    kfar_s = torch.where(kalive, kdist - K.RAY_EPS, DEAD)
    work = {}
    for o, d, far, tag in ((kro, krd, kfar_p, "primary"),
                           (kbo, kbd, kfar_b, "bounce")):
        got = BK.bvh_closest_hit(kscene, o, d, far)
        want = bvh.walk(kscene, o, d, far, stats=True)
        errs["bvh_closest_hit"] = max(errs["bvh_closest_hit"], _close(
            torch, got, want, far, f"bvh_closest_hit ({tag} rays)"))
        _require(all(torch.equal(a, b) for a, b in zip(got, want[:4])),
                 f"bvh_closest_hit ({tag} rays): not bit-equal to the twin")
        work[("bvh_closest_hit", tag)] = (int(want[4].sum()),
                                          int(want[5].sum()))
    for o, d, far, tag in ((kbo, ksd, kfar_s, "shadow"),
                           (kbo, kbd, kfar_b, "bounce")):
        occ = BK.bvh_any_hit(kscene, o, d, far)
        want = bvh.walk(kscene, o, d, far, any_hit=True, stats=True)
        _require(torch.equal(occ, want[1] >= 0),
                 f"bvh_any_hit ({tag} rays): occlusion differs from the twin")
        _require(not bool(occ[far < 0].any()), "a dead lane is occluded")
        work[("bvh_any_hit", tag)] = (int(want[4].sum()), int(want[5].sum()))
    _require(0 < int(BK.bvh_any_hit(kscene, kbo, ksd, kfar_s).sum())
             < int(kalive.sum()), "shadow rays all or none occluded")
    ktimes = {
        "bvh_closest_hit": (
            _time_ms(torch, lambda: BK.bvh_closest_hit(kscene, kbo, kbd,
                                                       kfar_b)),
            _time_ms(torch, lambda: BK.bvh_closest_hit_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "bvh_any_hit": (
            _time_ms(torch, lambda: BK.bvh_any_hit(kscene, kbo, ksd,
                                                   kfar_s)),
            _time_ms(torch, lambda: BK.bvh_any_hit_plain(
                kscene, kbo, ksd, kfar_s), reps=1))}
    times.update(ktimes)
    # bounds: rays, far and both tables read once, outputs written once;
    # operations: the node visits and prim tests these rays need (twin)
    tables = 4 * (kscene.bvh_node_pack.numel() + kscene.bvh_prim_pack.numel())
    for k, tag, out_bytes in (("bvh_closest_hit", "bounce", 16),
                              ("bvh_any_hit", "shadow", 1)):
        visits, tests = work[(k, tag)]
        bounds[k] = _bound(N * 28 + tables + N * out_bytes,
                           visits * bvh.NODE_OPS + tests * bvh.PRIM_OPS)
    # what the compiler and the card give each kernel: the closest hit
    # runs one wave of persistent warps (its "waves" are the rays a
    # resident thread takes), the any hit one thread a ray
    kinfo = BK.kernel_info(N)
    kdevice = {
        "bvh_closest_hit": (
            _graph_ms(torch, lambda: BK.bvh_closest_hit(kscene, kbo, kbd,
                                                        kfar_b)),
            _graph_ms(torch, lambda: BK.bvh_closest_hit(kscene, kro, krd,
                                                        kfar_p))),
        "bvh_any_hit": (
            _graph_ms(torch, lambda: BK.bvh_any_hit(kscene, kbo, ksd,
                                                    kfar_s)),
            _graph_ms(torch, lambda: BK.bvh_any_hit(kscene, kbo, kbd,
                                                    kfar_b)))}
    print("phase 2b BVH kernels vs twin, knot290k, %d rays: " % N
          + "; ".join(f"{k} exact ids, max abs err {errs[k]:.3g}, kernel "
                      f"{t:.4f} ms (device {kdevice[k][0]:.4f}; "
                      + ("primary rays" if k == "bvh_closest_hit"
                         else "bounce rays")
                      + f" {kdevice[k][1]:.4f}), twin {p:.4f} ms (one "
                      f"call), bound {bounds[k][0]:.4f} ms ({bounds[k][1]})"
                      for k, (t, p) in ktimes.items())
          + " | node visits / prim tests per ray: " + ", ".join(
              f"{k} {tag} {v / N:.2f} / {s / N:.2f}"
              for (k, tag), (v, s) in work.items())
          + " | " + "; ".join(
              f"{k}: {r} registers, {sp} B spilled, {b} blocks of {bs} "
              f"resident per SM x {sms} SMs, "
              + (f"one wave, {w:.2f} rays per resident thread"
                 if k == "bvh_closest_hit" else f"{w} waves")
              for k, (r, sp, b, sms, bs, w) in kinfo.items())
          + f" [{card}]", flush=True)

    # ---- 2e. cluster kernels against their plain versions, knot290k ----
    NC, CM = kscene.n_clusters, kscene.cluster_size
    _require(kscene.cl_rows.shape == (NC * CM, 18) and CM == 256
             and int(kscene.cl_count.sum()) == kscene.n_prims,
             "knot290k cluster tables")

    def same(got, want, name):
        """Every output of the kernel equal to the plain version's, bit
        for bit; returns the largest absolute difference of the floats."""
        err = 0.0
        for a, b in zip(got, want):
            _require(a.dtype == b.dtype and torch.equal(a, b),
                     f"{name}: an output differs from the plain version")
            if a.is_floating_point():
                err = max(err, float((a - b).abs().max()))
        return err

    cwork, vs_bvh = {}, {}
    for o, d, far, tag in ((kro, krd, kfar_p, "primary"),
                           (kbo, kbd, kfar_b, "bounce")):
        name = "cluster_closest_hit"
        got = CK.cluster_closest_hit(kscene, o, d, far)
        *want, boxes, prims, whole = CK.cluster_closest_hit_plain(
            kscene, o, d, far, stats=True)
        errs[name] = max(errs[name], same(got, want, f"{name} ({tag} rays)"))
        _require(bool((got[0][far < 0] == -3e38).all()),
                 f"{name}: a dead lane did not come back with t = -3e38")
        _require(float((got[1] >= 0).float().mean()) > 0.2,
                 f"{name} ({tag} rays): few hits")
        cwork[(name, tag)] = (boxes, prims, whole)
        b_t, b_prim = BK.bvh_closest_hit(kscene, o, d, far)[:2]
        differ = got[1] != b_prim
        vs_bvh[(name, tag)] = float(differ.float().mean())
        torch.testing.assert_close(got[0][~differ], b_t[~differ], rtol=2e-6,
                                   atol=0.0)
    for o, d, far, tag in ((kbo, ksd, kfar_s, "shadow"),
                           (kbo, kbd, kfar_b, "bounce")):
        name = "cluster_any_hit"
        occ = CK.cluster_any_hit(kscene, o, d, far)
        want, boxes, prims, whole = CK.cluster_any_hit_plain(
            kscene, o, d, far, stats=True)
        same([occ], [want], f"{name} ({tag} rays)")
        _require(not bool(occ[far < 0].any()), "a dead lane is occluded")
        cwork[(name, tag)] = (boxes, prims, whole)
        vs_bvh[(name, tag)] = float(
            (occ != BK.bvh_any_hit(kscene, o, d, far)).float().mean())
    _require(max(vs_bvh.values()) < LANES_DIFFER,
             f"sweep kernels differ from the BVH kernels: {vs_bvh}")
    for o, d, far, tag in ((kro, krd, kfar_p, "primary"),
                           (kbo, kbd, kfar_b, "bounce"),
                           (kbo, ksd, kfar_s, "shadow")):
        got = CK.cluster_front(kscene, o, d, far)
        errs["cluster_front"] = max(errs["cluster_front"], same(
            got, CK.cluster_front_plain(kscene, o, d, far),
            f"cluster_front ({tag} rays)"))
        _require(bool((got[0][far < 0] == NC).all()),
                 "cluster_front: a dead lane enters a cluster")
    # the pick passes on the picks the schedule derives: bounce rays for
    # the closest hit, shadow rays for the any hit, both in sorted order
    _perm, pro, prd, pfar, pcid, pnxt = CK._front_sort(kscene, kbo, kbd,
                                                       kfar_b)
    ppicks, pcovered = CK.tile_picks(pcid, NC, CK.QP_P)
    p_t, p_wid = pfar, torch.full_like(pcid, -1)
    pick_in = []
    for p in range(CK.QP_P):
        name = "cluster_pick_closest"
        got = CK.cluster_pick_closest(kscene, pro, prd, p_t, p_wid, ppicks[p])
        *want, tests, whole = CK.cluster_pick_closest_plain(
            kscene, pro, prd, p_t, p_wid, ppicks[p], stats=True)
        errs[name] = max(errs[name], same(got, want, f"{name} (pass {p})"))
        pick_in.append((p_t, p_wid, ppicks[p], tests, whole))
        p_t, p_wid = got
    pick_hits = float((p_wid >= 0).float().mean())
    _require(pick_hits > 0, "cluster_pick_closest: no hit")
    entering = pcid < NC
    resid = entering & (~pcovered | (pnxt < p_t))
    pick_shares = (float(entering.float().mean()),
                   float((pcovered & entering).float().mean()),
                   float(resid.float().mean()))
    _perm, aro, ard, afar, acid, _nxt = CK._front_sort(kscene, kbo, ksd,
                                                       kfar_s)
    apicks, _cov = CK.tile_picks(acid, NC, CK.QP_P)
    any_in = []
    a_occ = torch.zeros_like(afar, dtype=torch.bool)
    for p in range(CK.QP_P):
        name = "cluster_pick_any"
        occ = CK.cluster_pick_any(kscene, aro, ard, afar, apicks[p])
        want, tests, whole = CK.cluster_pick_any_plain(
            kscene, aro, ard, afar, apicks[p], stats=True)
        same([occ], [want], f"{name} (pass {p})")
        any_in.append((apicks[p], tests, whole))
        a_occ |= occ
    _require(bool(a_occ.any()) and not bool(a_occ[afar < 0].any()),
             "cluster_pick_any: no lane or a dead lane occluded")
    t0_, w0_, pk0, pick_tests, pick_whole = pick_in[0]
    apk0, any_tests, any_whole = any_in[0]
    ctimes = {
        "cluster_closest_hit": (
            _time_ms(torch, lambda: CK.cluster_closest_hit(kscene, kbo, kbd,
                                                           kfar_b)),
            _time_ms(torch, lambda: CK.cluster_closest_hit_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "cluster_any_hit": (
            _time_ms(torch, lambda: CK.cluster_any_hit(kscene, kbo, ksd,
                                                       kfar_s)),
            _time_ms(torch, lambda: CK.cluster_any_hit_plain(
                kscene, kbo, ksd, kfar_s), reps=1)),
        "cluster_front": (
            _time_ms(torch, lambda: CK.cluster_front(kscene, kbo, kbd,
                                                     kfar_b)),
            _time_ms(torch, lambda: CK.cluster_front_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "cluster_pick_closest": (
            _time_ms(torch, lambda: CK.cluster_pick_closest(
                kscene, pro, prd, t0_, w0_, pk0)),
            _time_ms(torch, lambda: CK.cluster_pick_closest_plain(
                kscene, pro, prd, t0_, w0_, pk0), reps=1)),
        "cluster_pick_any": (
            _time_ms(torch, lambda: CK.cluster_pick_any(kscene, aro, ard,
                                                        afar, apk0)),
            _time_ms(torch, lambda: CK.cluster_pick_any_plain(
                kscene, aro, ard, afar, apk0), reps=1))}
    times.update(ctimes)
    # bounds. Bytes: what a kernel must read once and write once. A sweep:
    # rays and far of every lane, the cluster boxes and counts, the boxes
    # of the live chunks and the live rows (72 B each; padding slots are
    # never read), its outputs. A pick pass: the picks, the counts and live
    # rows of its distinct picked clusters, the rays (24 B) of the lanes in
    # tiles that have a pick (the others are never loaded), and per lane
    # far, wid0, t and wid (closest) or the flag (any, whose far is read
    # in tiles with a pick only). Operations: the box tests and (ray, row)
    # tests these rays need as the plain versions count them, a row test
    # that stops at its plane distance charged PLANE_OPS, a whole one
    # PRIM_OPS.
    def row_ops(tests, whole):
        return tests * CK.PLANE_OPS + whole * (CK.PRIM_OPS - CK.PLANE_OPS)

    live_chunks = int(((kscene.cl_count + 127) // 128).sum())
    sweep_tables = (NC * (24 + 4) + live_chunks * 24
                    + int(kscene.cl_count.sum()) * 72)
    for k, tag, out_bytes in (("cluster_closest_hit", "bounce", 36),
                              ("cluster_any_hit", "shadow", 1)):
        boxes, prims, whole = cwork[(k, tag)]
        bounds[k] = _bound(N * 28 + sweep_tables + N * out_bytes,
                           boxes * CK.BOX_OPS + row_ops(prims, whole))
    bounds["cluster_front"] = _bound(
        N * 28 + NC * 24 + N * 8,
        int((kfar_b > K.RAY_EPS).sum()) * NC * CK.BOX_OPS)
    pick_bytes = {}
    for k, pk, tests, whole, lane_b, active_b in (
            ("cluster_pick_closest", pk0, pick_tests, pick_whole, 16, 24),
            ("cluster_pick_any", apk0, any_tests, any_whole, 1, 28)):
        tiles = torch.nonzero(pk >= 0).squeeze(1)
        active = int(torch.clamp(N - tiles * CK.TILE, max=CK.TILE).sum())
        picked = torch.unique(pk[pk >= 0]).long()
        rows_b = 72 * int(kscene.cl_count[picked].sum())
        pick_bytes[k] = (picked.numel(), rows_b, active)
        bounds[k] = _bound(pk.numel() * 4 + picked.numel() * 4 + rows_b
                           + active * active_b + N * lane_b,
                           row_ops(tests, whole))
    print("phase 2e cluster kernels vs plain, knot290k (%d clusters of %d "
          "slots), %d rays: every output bit-equal; " % (NC, CM, N)
          + "; ".join(f"{k} max abs err {errs[k]:.3g}, kernel {t:.4f} ms, "
                      f"plain {p:.4f} ms (one call), bound "
                      f"{bounds[k][0]:.4f} ms ({bounds[k][1]})"
                      for k, (t, p) in ctimes.items())
          + " | box tests / row tests per ray: " + ", ".join(
              f"{k} {tag} {b / N:.1f} / {r / N:.1f}"
              for (k, tag), (b, r, _w) in cwork.items())
          + " | whole row tests per ray: " + ", ".join(
              f"{k} {tag} {w / N:.2f}"
              for (k, tag), (_b, _r, w) in cwork.items())
          + f"; pick pass 0: closest {pick_tests / N:.1f} ({pick_whole / N:.2f}"
          f" whole), any {any_tests / N:.1f} ({any_whole / N:.2f} whole) row "
          "tests per ray; " + ", ".join(
              f"{k} reads {c} clusters' {b} B of live rows and the rays of "
              f"{a} lanes" for k, (c, b, a) in pick_bytes.items())
          + " | bounce rays entering a "
          f"cluster {pick_shares[0]:.4f}, covered by {CK.QP_P} picks "
          f"{pick_shares[1]:.4f}, hit in a pick pass {pick_hits:.4f}, left to "
          f"the cleanup {pick_shares[2]:.4f} | "
          "share of lanes differing from the BVH kernels: " + ", ".join(
              f"{k} {tag} {v:.3g}" for (k, tag), v in vs_bvh.items())
          + f" | BVH kernels on the same rays: closest "
          f"{times['bvh_closest_hit'][0]:.4f} ms, any "
          f"{times['bvh_any_hit'][0]:.4f} ms [{card}]", flush=True)

    # ---- 2c. media-walk kernel against its twin, vpt cbox 512^2 ----
    vscene, vcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "vpt"),
                                   "cbox.xml")
    _require(vcfg.max_bounce == 16 and (vcfg.w, vcfg.h) == (512, 512)
             and vcfg.n_null_objs == 1, "vpt cbox settings")
    vro, vrd = camera_rays(vscene, vcfg, rng.split(rng.PRNGKey(2))[1], 1)
    vro = vro.contiguous()
    v_t = K.tri_closest_hit_plain(vscene, vro, vrd, far_p)[0]
    v_hit = v_t < K.FAR
    v_p = vro + torch.where(v_hit, v_t, 0.0)[:, None] * vrd
    e_pos = emitter_ops.sample_hit(
        vscene, vcfg, torch.zeros(N, dtype=torch.int32, device=dev), v_p,
        torch.rand((N, 3), generator=g, device=dev))[0]
    v_to = e_pos - v_p
    v_dist = v_to.norm(dim=-1)
    v_sd = v_to / v_dist[:, None]
    v_far_s = K.far_bound(v_p, v_dist, v_hit)
    v_bd = torch.randn((N, 3), generator=g, device=dev)
    v_bd = v_bd / v_bd.norm(dim=-1, keepdim=True)
    v_far_b = torch.where(
        v_hit & (torch.rand(N, generator=g, device=dev) > 0.15), K.FAR, DEAD)
    null_f = _is_null_obj(vscene, vscene.tri_obj)
    all_f = torch.ones_like(null_f)
    track_sets = (("shadow", v_sd, v_far_s, 2, null_f),
                  ("bounce", v_bd, v_far_b, 2, null_f),
                  ("bounce all-null", v_bd, v_far_b, 7, all_f))
    shares = []
    for tag, d, far, k, nf in track_sets:
        got = K.tri_track_hits(vscene, v_p, d, far, k, nf)
        want = K.tri_track_hits_plain(vscene, v_p, d, far, k, nf)
        for name, a, b in zip(("t_null", "obj_null", "dn_null", "t_blk",
                               "obj_blk", "dn_blk", "overflow"), got, want):
            _require(a.dtype == b.dtype and torch.equal(a, b),
                     f"tri_track_hits ({tag}): {name} differs from the twin")
        for i in (0, 2, 3, 5):                 # the float outputs
            errs["tri_track_hits"] = max(
                errs["tri_track_hits"], float((got[i] - want[i]).abs().max()))
        live = far > K.RAY_EPS
        _require(not bool((got[0][:, ~live] < K.FAR).any()
                          | got[6][~live].any()),
                 f"tri_track_hits ({tag}): a dead lane has hits")
        nl = max(int(live.sum()), 1)
        shares.append((tag, k, float(((got[0][0] < K.FAR) & live).sum()) / nl,
                       float((got[6] & live).sum()) / nl,
                       float(((got[3] < K.FAR) & live).sum()) / nl))
    _require(all(sh[2] > 0 for sh in shares), "no null interface was hit")
    _require(shares[1][4] > 0, "no bounce ray was blocked")
    times["tri_track_hits"] = (
        _time_ms(torch, lambda: K.tri_track_hits(vscene, v_p, v_sd, v_far_s,
                                                 2, null_f)),
        _time_ms(torch, lambda: K.tri_track_hits_plain(vscene, v_p, v_sd,
                                                       v_far_s, 2, null_f)))
    # bound: rays and far read once, the table (12 + 3 floats, obj, flag
    # per row) read once, 3 K + 4 outputs written once; operations: every
    # (ray, triangle) test that a lane able to hit needs, once
    VT = vscene.tri_n.shape[0]
    walking = int((v_far_s > K.RAY_EPS).sum())
    bounds["tri_track_hits"] = _bound(
        N * 28 + VT * 65 + N * (2 * 12 + 13), walking * VT * TRI_PAIR_OPS)
    tt, tp = times["tri_track_hits"]
    print(f"phase 2c media-walk kernel vs twin, vpt cbox, {N} rays, "
          f"{VT} triangles ({int(null_f.sum())} null): every output equal, "
          f"max abs err {errs['tri_track_hits']:.3g}; "
          + "; ".join(f"{tag} K={k}: null-hit share {a:.4f}, overflow share "
                      f"{o:.5f}, blocked share {b:.4f}"
                      for tag, k, a, o, b in shares)
          + f" (shares of live lanes) | shadow K=2: kernel {tt:.4f} ms, twin "
          f"{tp:.4f} ms, bound {bounds['tri_track_hits'][0]:.4f} ms "
          f"({bounds['tri_track_hits'][1]}) [{card}]", flush=True)

    # ---- 2d. film-splat kernel against its plain version, 512^2 ----
    bcfg = dataclasses.replace(cfg0, max_bounce=6)  # scripts/bench_all.py:74-78
    P = bcfg.n_pixels
    t1_stream = []

    def capture(film, idx, rgb):
        t1_stream.append((film, idx, rgb))
        return S.splat_sorted_accumulate(film, idx, rgb)
    B.splat_sorted_accumulate = capture
    try:
        B.render_pass_bdpt(scene, bcfg, rng.PRNGKey(3), 1)
    finally:
        B.splat_sorted_accumulate = S.splat_sorted_accumulate
    _require(len(t1_stream) == 1, "one film splat a BDPT pass")
    film1, idx1, rgb1 = t1_stream[0]
    M = idx1.shape[0]
    _require(M == len(B._strategy_groups(bcfg, 6)["t1"]) * P,
             f"t=1 stream of {M} updates")

    def splat_stream(hot):
        """M sorted updates with random rgb over a random film: 10% dropped
        (id P) and the rest uniform, or `hot` of them in pixels [0, 1024)."""
        ids = torch.randint(0, P, (M,), generator=g, device=dev,
                            dtype=torch.int32)
        if hot:
            ids[:hot] = torch.randint(0, 1024, (hot,), generator=g,
                                      device=dev, dtype=torch.int32)
        else:
            ids = torch.where(torch.rand(M, generator=g, device=dev) < 0.1,
                              P, ids)
        return (torch.rand((P, 3), generator=g, device=dev),
                torch.sort(ids).values.contiguous(),
                torch.rand((M, 3), generator=g, device=dev))

    def hot_stream(n_hot):
        """The uniform stream with its first n_hot updates moved to one
        pixel: a segment longer than the kernel stages at a time."""
        film, idx, rgb = splat_stream(0)
        idx[:n_hot] = 4321
        return film, torch.sort(idx).values.contiguous(), rgb
    streams = (("bdpt t=1", (film1, idx1, rgb1)),
               ("uniform", splat_stream(0)),
               ("skewed", splat_stream(70000)),
               ("one pixel 200000", hot_stream(200000)))
    _require(int((streams[2][1][1] < 1024).sum()) >= 65536,
             "the skewed stream's first tile holds 65,536 updates")
    splat_rows = []
    for tag, (film, idx, rgb) in streams:
        got = S.splat_sorted_accumulate(film, idx, rgb)
        want = S.splat_sorted_accumulate_plain(film, idx, rgb)
        _require(torch.equal(got, want),
                 f"splat_sorted_accumulate ({tag}): differs from the plain "
                 "version")
        errs["splat_sorted_accumulate"] = max(
            errs["splat_sorted_accumulate"], float((got - want).abs().max()))
        kept = idx < P
        ik, rk = idx[kept], rgb[kept]
        lib = torch.index_add(film, 0, ik, rk)
        torch.testing.assert_close(lib, got, rtol=1e-5, atol=1e-5)
        nk = int(kept.sum())
        mx = int(torch.bincount(idx[kept], minlength=P).max()) if nk else 0
        # bound: each kept update's id and rgb read once, the film read and
        # the output written once; 3 adds an update
        splat_rows.append((
            tag, nk,
            _time_ms(torch, lambda: S.splat_sorted_accumulate(film, idx,
                                                              rgb)),
            _time_ms(torch, lambda: S.splat_sorted_accumulate_plain(
                film, idx, rgb), reps=REPS if mx < 1000 else 1),
            _bound(nk * 16 + P * 24, 3 * nk),
            _time_ms(torch, lambda: torch.index_add(film, 0, ik, rk)), mx,
            _graph_ms(torch, lambda: S.splat_sorted_accumulate(film, idx,
                                                               rgb)),
            _graph_ms(torch, lambda: torch.index_add(film, 0, ik, rk))))
    # the JSON line takes the uniform stream: the main path's shapes with
    # every pixel at work (the main path's own t=1 stream keeps nothing on
    # cbox, see phase 7)
    _tag, _nk, sk, sp, sb, sl, _mx, _kb, _lb = splat_rows[1]
    times["splat_sorted_accumulate"] = (sk, sp, sl)
    bounds["splat_sorted_accumulate"] = sb
    print(f"phase 2d film-splat kernel vs plain, {P} pixels, {M} updates: "
          "bit-equal on every stream; " + "; ".join(
              f"{tag}: {nk} kept (most in one pixel {mx}), kernel {k:.4f} ms,"
              f" plain {p:.4f} ms{' (one call)' if mx >= 1000 else ''}, "
              f"bound {b[0]:.4f} ms ({b[1]}), index_add_ {lb:.4f} ms; "
              f"device: kernel {kb:.4f}, index_add_ {ib:.4f} ms"
              for tag, nk, k, p, b, lb, mx, kb, ib in splat_rows)
          + f" [{card}]", flush=True)

    # ---- 3. golden on the card ----
    w = 48                                   # tests/test_goldens.py:25-29
    small = dataclasses.replace(
        cfg0, w=w, h=w, focal=cfg0.focal * w / 512, end_x=w, end_y=w,
        max_bounce=3, anti_alias=False, stratified_sampling=False,
        use_rr=False)
    reset()
    img = pt.render_pass_pt(scene, small, rng.PRNGKey(42), 1)
    golden_launches = counts()
    _require(golden_launches["tri_closest_hit"] > 0
             and golden_launches["tri_any_hit"] > 0,
             f"a kernel did not launch: {golden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_pt_48.npy")))
    print(f"phase 3 golden cbox_pt_48 on cuda: max abs diff {err:.3g}, mean "
          f"{mean:.6f} vs {ref_mean:.6f}, launches {_shown(golden_launches)}",
          flush=True)

    # ---- 3b. vpt golden on the card ----
    vsmall = dataclasses.replace(
        vcfg, w=w, h=w, focal=vcfg.focal * w / 512, end_x=w, end_y=w,
        max_bounce=3, anti_alias=False, stratified_sampling=False,
        use_rr=False)
    reset()
    img = vpt.render_pass_vpt(vscene, vsmall, rng.PRNGKey(42), 1)
    vgolden_launches = counts()
    _require(vgolden_launches["tri_track_hits"] > 0
             and vgolden_launches["tri_closest_hit"] > 0,
             f"a kernel did not launch: {vgolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "vptcbox_48.npy")))
    print(f"phase 3b golden vptcbox_48 on cuda: max abs diff {err:.3g}, mean "
          f"{mean:.6f} vs {ref_mean:.6f}, launches {_shown(vgolden_launches)}",
          flush=True)

    # ---- 3c. BDPT golden on the card ----
    reset()
    img, _, _ = B.render_pass_bdpt(scene, small, rng.PRNGKey(42), 1)
    bgolden_launches = counts()
    _require(bgolden_launches["tri_closest_hit"] > 0
             and bgolden_launches["tri_track_hits"] > 0
             and bgolden_launches["splat_sorted_accumulate"] > 0,
             f"a kernel did not launch: {bgolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_bdpt_48.npy")))
    print(f"phase 3c golden cbox_bdpt_48 on cuda: max abs diff {err:.3g}, "
          f"mean {mean:.6f} vs {ref_mean:.6f}, launches "
          f"{_shown(bgolden_launches)}",
          flush=True)

    @contextlib.contextmanager
    def twins():
        """The path's wrappers swapped for their plain twins."""
        saved = (K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits,
                 BK.bvh_closest_hit, BK.bvh_any_hit,
                 B.splat_sorted_accumulate)
        K.tri_closest_hit = K.tri_closest_hit_plain
        K.tri_any_hit = K.tri_any_hit_plain
        K.tri_track_hits = K.tri_track_hits_plain
        BK.bvh_closest_hit = BK.bvh_closest_hit_plain
        BK.bvh_any_hit = BK.bvh_any_hit_plain
        B.splat_sorted_accumulate = S.splat_sorted_accumulate_plain
        try:
            yield
        finally:
            (K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits,
             BK.bvh_closest_hit, BK.bvh_any_hit,
             B.splat_sorted_accumulate) = saved

    def timed_batch(r, spp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_batch(spp)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def rays_per_spp(c):
        return c.n_pixels * (1 + c.max_bounce * c.num_shadow_ray
                             + (c.max_bounce - 1))    # bench.py:61-63

    # ---- 4. cbox main path at full size ----
    r = pt.Renderer(scene, cfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, SPP)
    launches = counts()
    image = r.image()
    _require(image.shape == (cfg.h, cfg.w, 3), f"image shape {image.shape}")
    _require(bool(np.isfinite(image).all()) and image.mean() > 0.05,
             f"image not finite or too dark (mean {image.mean()})")
    want = {**none, "tri_closest_hit": SPP * cfg.max_bounce,
            "tri_any_hit": SPP * cfg.max_bounce * cfg.num_shadow_ray}
    _require(launches == want, f"cbox launch counts {launches}, want {want}")
    r_twin = pt.Renderer(scene, cfg, seed=0)
    with twins():
        r_twin.render_batch(1)
        dt_twin = timed_batch(r_twin, SPP)
    twin_err, _, _ = _check(image, r_twin.image())
    rays = rays_per_spp(cfg)
    print(f"phase 4 main path cbox {cfg.w}x{cfg.h} mb {cfg.max_bounce}, "
          f"{SPP} spp: {1e3 * dt / SPP:.2f} ms/spp, "
          f"{rays * SPP / dt / 1e6:.3f} Mrays/s [{card}]; twins in place: "
          f"{1e3 * dt_twin / SPP:.2f} ms/spp, "
          f"{rays * SPP / dt_twin / 1e6:.3f} Mrays/s [{card}]; image mean "
          f"{image.mean():.6f}, max abs diff to twins {twin_err:.3g}; "
          f"launches {_shown(launches)}", flush=True)

    # ---- 5. knot290k main path at full size, auto-compaction ----
    r = pt.Renderer(kscene, kcfg, seed=0)
    _require(r._auto, "knot290k is under the auto-compaction gate")
    t0 = time.perf_counter()
    r.render_batch(1)                 # the alive probe + one warm-up spp
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sched = r._sched
    reset()
    dt = dt_knot = timed_batch(r, KNOT_SPP)
    klaunches = counts()
    kimage = r.image()
    _require(kimage.shape == (kcfg.h, kcfg.w, 3), f"shape {kimage.shape}")
    _require(bool(np.isfinite(kimage).all()) and kimage.mean() > 0,
             f"image not finite or black (mean {kimage.mean()})")
    want = {**none, "bvh_closest_hit": KNOT_SPP * kcfg.max_bounce,
            "bvh_any_hit": KNOT_SPP * kcfg.max_bounce * kcfg.num_shadow_ray}
    _require(klaunches == want,
             f"knot290k launch counts {klaunches}, want {want}")
    plain = pt.Renderer(kscene, kcfg, seed=0)
    plain._sched = ()                 # the same render without compaction
    plain.render_batch(1)
    dt_plain = timed_batch(plain, KNOT_SPP)
    _require(torch.equal(plain.color, r.color),
             "the compacted render differs from the uncompacted one")
    w = 64
    small = dataclasses.replace(kcfg, w=w, h=w, focal=kcfg.focal * w / 512,
                                end_x=w, end_y=w)
    rk = pt.Renderer(kscene, small, seed=1)
    rk.render_batch(1)
    rt = pt.Renderer(kscene, small, seed=1)
    with twins():
        rt.render_batch(1)
    ktwin_err, _, _ = _check(rk.image(), rt.image())
    rays = rays_per_spp(kcfg)
    print(f"phase 5 main path knot290k {kcfg.w}x{kcfg.h} mb "
          f"{kcfg.max_bounce}, schedule {sched}, {KNOT_SPP} spp: "
          f"{dt / KNOT_SPP:.4f} s/spp, {rays * KNOT_SPP / dt / 1e6:.3f} "
          f"Mrays/s [{card}]; uncompacted: {dt_plain / KNOT_SPP:.4f} s/spp, "
          f"{rays * KNOT_SPP / dt_plain / 1e6:.3f} Mrays/s, image equal; "
          f"probe + warm-up spp {warm_s:.2f} s; image mean "
          f"{kimage.mean():.6f}; 64^2 max abs diff to twins {ktwin_err:.3g}; "
          f"launches {_shown(klaunches)}", flush=True)

    # ---- 6. vpt cbox main path at full size ----
    iters = vcfg.max_bounce + vpt.NULL_BUDGET
    r = vpt.VolumeRenderer(vscene, vcfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, VPT_SPP)
    vlaunches = counts()
    vimage = r.image()
    _require(vimage.shape == (vcfg.h, vcfg.w, 3), f"shape {vimage.shape}")
    _require(bool(np.isfinite(vimage).all()) and vimage.mean() > 0,
             f"image not finite or black (mean {vimage.mean()})")
    _require(vlaunches["tri_track_hits"]
             == VPT_SPP * iters * vcfg.num_shadow_ray
             and vlaunches["tri_closest_hit"] >= VPT_SPP * iters
             and vlaunches["tri_any_hit"] == 0
             and vlaunches["bvh_closest_hit"] == vlaunches["bvh_any_hit"] == 0
             and vlaunches["splat_sorted_accumulate"] == 0,
             f"vpt launch counts {vlaunches}")
    plain = vpt.VolumeRenderer(vscene, vcfg, seed=0, schedule=())
    plain.render_batch(1)
    dt_plain = timed_batch(plain, VPT_SPP)
    _require(torch.equal(plain.color, r.color),
             "the compacted vpt render differs from the uncompacted one")
    w = 64
    small = dataclasses.replace(vcfg, w=w, h=w, focal=vcfg.focal * w / 512,
                                end_x=w, end_y=w)
    rv = vpt.VolumeRenderer(vscene, small, seed=1)
    rv.render_batch(1)
    rt = vpt.VolumeRenderer(vscene, small, seed=1)
    with twins():
        rt.render_batch(1)
    vtwin_err, _, _ = _check(rv.image(), rt.image())
    print(f"phase 6 main path vpt cbox {vcfg.w}x{vcfg.h} mb "
          f"{vcfg.max_bounce}, {iters} iterations, schedule {r.schedule}, "
          f"{VPT_SPP} spp: {1e3 * dt / VPT_SPP:.2f} ms/spp [{card}]; "
          f"uncompacted: {1e3 * dt_plain / VPT_SPP:.2f} ms/spp, image equal; "
          f"image mean {vimage.mean():.6f}; 64^2 max abs diff to twins "
          f"{vtwin_err:.3g}; launches {_shown(vlaunches)}", flush=True)

    # ---- 7. BDPT main path at full size ----
    groups = B._strategy_groups(bcfg, bcfg.max_bounce)
    Q = max(1, B.FLAT_LANES // P)
    chunks = {case: -(-len(rows) // Q) for case, rows in groups.items()}
    r = B.BDPT(scene, bcfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, BDPT_SPP)
    blaunches = counts()
    bimage = r.image()
    _require(bimage.shape == (bcfg.h, bcfg.w, 3), f"shape {bimage.shape}")
    _require(bool(np.isfinite(bimage).all()) and bimage.mean() > 0,
             f"image not finite or black (mean {bimage.mean()})")
    # two walks of max_bounce closest hits; one media walk for each chunk
    # of the t1, s1 and gen groups (no null surface, so no overflow
    # fallback); one film splat a pass
    want = {**none, "tri_closest_hit": BDPT_SPP * 2 * bcfg.max_bounce,
            "tri_track_hits": BDPT_SPP * (chunks["t1"] + chunks["s1"]
                                          + chunks["gen"]),
            "splat_sorted_accumulate": BDPT_SPP}
    _require(blaunches == want,
             f"BDPT launch counts {blaunches}, want {want}")
    w = 64
    small = dataclasses.replace(bcfg, w=w, h=w, focal=bcfg.focal * w / 512,
                                end_x=w, end_y=w)
    rb = B.BDPT(scene, small, seed=1)
    rb.render_batch(1)
    rt = B.BDPT(scene, small, seed=1)
    with twins():
        rt.render_batch(1)
    btwin_err, _, _ = _check(rb.image(), rt.image())
    print(f"phase 7 main path BDPT cbox {bcfg.w}x{bcfg.h} mb "
          f"{bcfg.max_bounce}, {sum(map(len, groups.values()))} strategies "
          f"in chunks {chunks}, {BDPT_SPP} spp: {1e3 * dt / BDPT_SPP:.2f} "
          f"ms/spp [{card}]; image mean {bimage.mean():.6f}; 64^2 max abs "
          f"diff to twins {btwin_err:.3g}; launches {_shown(blaunches)}",
          flush=True)

    # ---- 8. transient BDPT at full size ----
    tscene, tcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "trans"),
                                   "cbox-point.xml")
    _require(tcfg.transient and tcfg.t_bins == 400 and tcfg.max_bounce == 12
             and (tcfg.w, tcfg.h) == (512, 512), "trans cbox-point settings")
    torch.cuda.reset_peak_memory_stats()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tcolor, tbins, tcnts = B.render_pass_bdpt(tscene, tcfg, rng.PRNGKey(5), 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tlaunches = counts()
    _require(tuple(tbins.shape) == (P, 400, 3)
             and tuple(tcnts.shape) == (P, 400), "transient shapes")
    _require(bool(torch.isfinite(tbins).all() & torch.isfinite(tcolor).all()),
             "transient bins or image not finite")
    n_cnt = int(tcnts.sum())
    _require(n_cnt > 0 and bool((tcnts >= 0).all()), "no transient counts")
    _require(tlaunches["tri_any_hit"] > 0
             and tlaunches["splat_sorted_accumulate"] == 1
             and tlaunches["tri_track_hits"] == 0,
             f"transient launch counts {tlaunches}")
    print(f"phase 8 transient BDPT trans/cbox-point {tcfg.w}x{tcfg.h} mb "
          f"{tcfg.max_bounce}, {tcfg.t_bins} bins: {1e3 * dt:.2f} ms per pass "
          f"[{card}]; {n_cnt} samples binned, {int((tcnts > 0).sum())} bins "
          f"filled; image mean {float(tcolor.mean()):.6f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{_shown(tlaunches)}", flush=True)

    # ---- 9. knot290k main path under the two cluster-tier schedules ----
    per = kcfg.max_bounce
    shadows = kcfg.max_bounce * kcfg.num_shadow_ray
    tier_want = {
        "sweep": {**none, "cluster_closest_hit": KNOT_SPP * per,
                  "cluster_any_hit": KNOT_SPP * shadows},
        "qpick": {**none, "cluster_front": KNOT_SPP * (per + shadows),
                  "cluster_pick_closest": KNOT_SPP * per * CK.QP_P,
                  "cluster_pick_any": KNOT_SPP * shadows * CK.QP_P,
                  "bvh_closest_hit": KNOT_SPP * per,
                  "bvh_any_hit": KNOT_SPP * shadows}}
    tier_launches, tier_rows = {}, []
    for tier, want in tier_want.items():
        r = pt.Renderer(kscene, dataclasses.replace(kcfg, big_tier=tier),
                        seed=0)
        _require(r._auto, "knot290k is under the auto-compaction gate")
        r.render_batch(1)             # the alive probe + one warm-up spp
        reset()
        dt_tier = timed_batch(r, KNOT_SPP)
        tier_launches[tier] = counts()
        _require(tier_launches[tier] == want,
                 f"{tier} launch counts {tier_launches[tier]}, want {want}")
        timage = r.image()
        _require(bool(np.isfinite(timage).all()),
                 f"{tier}: image not finite")
        tier_rows.append((tier, dt_tier, r._sched,
                          *_check_tier(timage, kimage)))
    print(f"phase 9 main path knot290k {kcfg.w}x{kcfg.h} mb "
          f"{kcfg.max_bounce}, {KNOT_SPP} spp, cluster tier: " + "; ".join(
              f"{tier}: {1e3 * d / KNOT_SPP:.2f} ms/spp, "
              f"{rays_per_spp(kcfg) * KNOT_SPP / d / 1e6:.3f} Mrays/s, "
              f"schedule {sc}, against the BVH tier's image {sh:.3g} of the "
              f"pixels differ by 5e-2 or more (most {mx:.3g}), the others by "
              f"at most {e:.3g}, launches "
              f"{_shown(tier_launches[tier])}"
              for tier, d, sc, e, sh, mx in tier_rows)
          + f"; BVH tier (phase 5): {1e3 * dt_knot / KNOT_SPP:.2f} ms/spp "
          f"[{card}]", flush=True)

    path_launches = {**{k: launches[k] for k in ("tri_closest_hit",
                                                 "tri_any_hit")},
                     **{k: klaunches[k] for k in ("bvh_closest_hit",
                                                  "bvh_any_hit")},
                     "tri_track_hits": vlaunches["tri_track_hits"],
                     "splat_sorted_accumulate":
                         blaunches["splat_sorted_accumulate"],
                     **{k: tier_launches["sweep"][k] for k in (
                         "cluster_closest_hit", "cluster_any_hit")},
                     **{k: tier_launches["qpick"][k] for k in (
                         "cluster_front", "cluster_pick_closest",
                         "cluster_pick_any")}}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": times[k][2] if len(times[k]) > 2 else None}
        for k, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
