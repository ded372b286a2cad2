"""The brute-force closest hit (B1), any hit (B2) and media walk (B3)
against a baseline build of them, in one process on one card.

    python -m adapt_tpu_torch.tri_ab BASELINE.cu [--spp 2] [--sass DIR]
        [--baseline-only] [--b2-only] [--extra OTHER.cu ...]

BASELINE.cu is another csrc/tri_intersect.cu whose closest hit takes the
current arguments. Its media-walk entry point either takes the current
row lists too, or (as that of commit 88b64af: `git show
88b64af:adapt_tpu_torch/csrc/tri_intersect.cu > build/base.cu`) a (T,)
bool null-flag table, `tri_track_hits(ro, rd, far0, n, geo, ng, obj,
null_tab, T, K, t_null, obj_null, dn_null, t_blk, obj_blk, dn_blk,
overflow, stream)`; the source says which (the row lists are named
`solid_rows`). It is built beside the current source with the same
flags. A patched copy of the current source times another design choice
(the null-row cap, say).

On chip_smoke.py's sets (`cbox_rays`: cbox 512^2 primary and bounce rays,
and the bounce rays with 50% and 80% of their lanes dead; `vpt_rays`: the
vpt cbox's shadow rays at K = 2, and with 50% dead) and B2's (the cbox
shadow rays, with 50% and 80% of their lanes dead; the direct preview's
shadow rays at 512^2, chip_smoke.py `direct_rays`; the shadow rays of
one transient BDPT pass on trans/cbox-point.xml at its own settings, each
of its any-hit calls, recorded with the plain version in place and timed
together), every build is held bit-equal to the plain versions, then
timed in turns baseline, current, current, baseline: single calls and kernel-only device times (chip_smoke.py `_time_ms`, `_graph_ms`: a CUDA
graph of 10 calls reading the scene's prebuilt tables); a null-flag
baseline also with the table build its wrappers did on every call
(`tri_table`, and the null flags by `_is_null_obj`), inside the call as
they were (on the sets with no extra dead lanes); and ms/spp of PT on cbox
(512^2, 8 bounces) and of VPT on the vpt cbox (its own settings) with each
build in place, a null-flag baseline with its per-call table build.
`--baseline-only` times the baseline alone (no current build is loaded).
`--b2-only` times B2's sets alone (no B1 or B3 set, no render). Each
`--extra` file is one more build with the current entry points (a
patched copy of the current source: another design choice), held and
timed on B2's sets only, in turns baseline, current, extras, extras in
reverse, current, baseline.
Then per build and kernel: registers, shared and local bytes
(`cuobjdump -res-usage`) and the blocks of 256 threads one SM holds by
them, and the SASS loops (pick_ab.py `sass_of`, `sass_loops`: instructions
with the LDS, LDG and MUFU among them; with `--sass DIR` the listings).
Prints one line per turn, the card's name and power limit, and a JSON
line. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from .pick_ab import sass_of, sass_loops
from .sweep_ab import ROOT, card_name

TRI_KERNELS = ("tri_closest_kernel", "tri_any_kernel", "tri_track_kernel")


def baseline_kernels(path, name="tri_baseline"):
    """(library, {"closest": fn, "any": fn, "track": fn}, flags) of the
    baseline build (the library `name`) with the current wrappers'
    arguments and outputs;
    flags is True where its media walk takes a null-flag table. Each fn
    takes a keyword `build`: True makes the tables inside the call, as a
    null-flag baseline's wrappers did; False reads the scene's prebuilt
    ones (the kernel alone)."""
    from .ops import _build, intersect_kernels as K
    from .ops.intersect import _is_null_obj
    flags = "solid_rows" not in Path(path).read_text()
    lib = _build.compiled(name, Path(path), _build._nvcc,
                          _build.NVCC_FLAGS)
    if flags:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.tri_closest_hit.argtypes = [P, P, P, I, P, P, P, I] + [P] * 7
        lib.tri_any_hit.argtypes = [P, P, P, I, P, I, P, P]
        lib.tri_track_hits.argtypes = [P, P, P, I, P, P, P, P, I, I] \
            + [P] * 8
        for fn in (lib.tri_closest_hit, lib.tri_any_hit,
                   lib.tri_track_hits):
            fn.restype = I
    else:
        K.typed(lib)
    ones = {}

    def tables(scene, build):
        if build:
            return K.tri_table(scene)
        return scene.tri_geo, scene.tri_ng, scene.tri_obj

    def closest(scene, ray_o, ray_d, far0, build=False):
        geo, ng, obj = tables(scene, build)
        ray_o, ray_d, far0 = ray_o.contiguous(), ray_d.contiguous(), \
            far0.contiguous()
        n = ray_o.shape[0]
        if n == 0:
            return K.tri_closest_hit_plain(scene, ray_o, ray_d, far0)
        t, u, v = (torch.empty(n, device=ray_o.device) for _ in range(3))
        row, obj_out = (torch.empty(n, dtype=torch.int32,
                                    device=ray_o.device) for _ in range(2))
        ng_out = torch.empty((n, 3), device=ray_o.device)
        K._check(lib.tri_closest_hit(
            ray_o.data_ptr(), ray_d.data_ptr(), far0.data_ptr(), n,
            geo.data_ptr(), ng.data_ptr(), obj.data_ptr(), geo.shape[0],
            t.data_ptr(), row.data_ptr(), u.data_ptr(), v.data_ptr(),
            ng_out.data_ptr(), obj_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "baseline tri_closest_hit")
        return t, row, u, v, ng_out, obj_out

    def any_hit(scene, ray_o, ray_d, far0, build=False):
        geo = tables(scene, build)[0]
        ray_o, ray_d, far0 = ray_o.contiguous(), ray_d.contiguous(), \
            far0.contiguous()
        n = ray_o.shape[0]
        if n == 0:
            return K.tri_any_hit_plain(scene, ray_o, ray_d, far0)
        occ = torch.empty(n, dtype=torch.bool, device=ray_o.device)
        K._check(lib.tri_any_hit(
            ray_o.data_ptr(), ray_d.data_ptr(), far0.data_ptr(), n,
            geo.data_ptr(), geo.shape[0], occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "baseline tri_any_hit")
        return occ

    def track(scene, ray_o, ray_d, far0, k, all_null=False, build=False):
        if not flags:
            return rows_track(scene, ray_o, ray_d, far0, k, all_null)
        geo, ng, obj = tables(scene, build)
        T = geo.shape[0]
        if build:
            null = torch.ones(T, dtype=torch.bool, device=ray_o.device) \
                if all_null else _is_null_obj(scene, scene.tri_obj)
        elif all_null:
            null = ones.setdefault(id(scene), torch.ones_like(scene.tri_null))
        else:
            null = scene.tri_null
        ray_o, ray_d, far0 = ray_o.contiguous(), ray_d.contiguous(), \
            far0.contiguous()
        n = ray_o.shape[0]
        if n == 0:
            return K.tri_track_hits_plain(scene, ray_o, ray_d, far0, k, null)
        dev = ray_o.device
        t_k, d_k = (torch.empty((k, n), device=dev) for _ in range(2))
        o_k = torch.empty((k, n), dtype=torch.int32, device=dev)
        tb, db = (torch.empty(n, device=dev) for _ in range(2))
        ob = torch.empty(n, dtype=torch.int32, device=dev)
        ov = torch.empty(n, dtype=torch.bool, device=dev)
        K._check(lib.tri_track_hits(
            ray_o.data_ptr(), ray_d.data_ptr(), far0.data_ptr(), n,
            geo.data_ptr(), ng.data_ptr(), obj.data_ptr(), null.data_ptr(),
            T, k, t_k.data_ptr(), o_k.data_ptr(), d_k.data_ptr(),
            tb.data_ptr(), ob.data_ptr(), db.data_ptr(), ov.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "baseline tri_track_hits")
        return t_k, o_k, d_k, tb, ob, db, ov

    def rows_track(scene, ray_o, ray_d, far0, k, all_null):
        (ro, rd, far, n, geo, ng, obj), (solid_p, n_solid, null_p) = \
            K._track_operands(scene, ray_o, ray_d, far0, all_null)
        T = geo.shape[0]
        if n == 0:
            return K.tri_track_hits_plain(scene, ray_o, ray_d, far0, k,
                                          K.null_flags(scene, all_null))
        dev = ro.device
        t_k, d_k = (torch.empty((k, n), device=dev) for _ in range(2))
        o_k = torch.empty((k, n), dtype=torch.int32, device=dev)
        tb, db = (torch.empty(n, device=dev) for _ in range(2))
        ob = torch.empty(n, dtype=torch.int32, device=dev)
        ov = torch.empty(n, dtype=torch.bool, device=dev)
        K._check(lib.tri_track_hits(
            ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n, geo.data_ptr(),
            ng.data_ptr(), obj.data_ptr(), solid_p, n_solid, null_p,
            T - n_solid, k, t_k.data_ptr(), o_k.data_ptr(), d_k.data_ptr(),
            tb.data_ptr(), ob.data_ptr(), db.data_ptr(), ov.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "baseline tri_track_hits")
        return t_k, o_k, d_k, tb, ob, db, ov
    return lib, {"closest": closest, "any": any_hit, "track": track}, flags


def transient_rays(C, K):
    """(scene, calls): trans/cbox-point.xml at its own settings and the
    shadow rays of one transient BDPT pass there, (ro, rd, far) of each
    any-hit call, recorded with the plain version in place."""
    from . import rng
    from .renderer import bdpt
    scene, cfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "trans"),
                                 "cbox-point.xml")
    calls, saved = [], K.tri_any_hit

    def record(s, o, d, far):
        calls.append(tuple(x.contiguous().clone() for x in (o, d, far)))
        return K.tri_any_hit_plain(s, o, d, far)
    K.tri_any_hit = record
    try:
        bdpt.render_pass_bdpt(scene, cfg, rng.PRNGKey(5), 1)
    finally:
        K.tri_any_hit = saved
    return scene, calls


def resources(so_path):
    """{kernel: (registers, shared bytes, local bytes, blocks of 256
    threads one SM holds)} of the library's triangle kernels, from
    `cuobjdump -res-usage`; blocks by registers (allocated 256 a warp),
    shared memory (228 KB an SM, 1 KB reserved a block) and 2,048 threads
    an SM."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "cuobjdump")
    text = subprocess.run([str(cuobjdump), "-res-usage", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = next((k for k in TRI_KERNELS if k in m.group(1)), None)
            continue
        m = re.search(r"REG:(\d+).*?SHARED:(\d+).*?LOCAL:(\d+)", line)
        if m and fn:
            reg, shared, local = map(int, m.groups())
            warp_regs = -(-reg * 32 // 256) * 256
            blocks = min(65536 // (8 * warp_regs),
                         233472 // (shared + 1024), 2048 // 256)
            out[fn] = (reg, shared, local, blocks)
            fn = None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="an earlier csrc/tri_intersect.cu")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--sass", help="a directory for the kernels' listings")
    ap.add_argument("--baseline-only", action="store_true")
    ap.add_argument("--b2-only", action="store_true",
                    help="time B2's sets alone")
    ap.add_argument("--extra", action="append", default=[],
                    help="another build with the current entry points, "
                    "timed on B2's sets (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tri_ab: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from .ops import intersect_kernels as K
    from .renderer import pt, vpt
    from .scene import compile as C

    card = card_name()
    base_lib, base, flags = baseline_kernels(args.baseline)
    builds = {"baseline": base}
    libs = {"baseline": base_lib}
    if not args.baseline_only:
        libs["current"] = K._lib()
        builds["current"] = {"closest": K.tri_closest_hit,
                             "any": K.tri_any_hit, "track": K.tri_track_hits}
    extras = [f"extra{i}" for i in range(len(args.extra))]
    for name, path in zip(extras, args.extra):
        libs[name], builds[name], _ = baseline_kernels(path, f"tri_{name}")
    dev = torch.device("cuda")
    scene, cfg0, _ = C.load_scene(os.path.join(ROOT, "scenes", "cbox"),
                                  "cbox.xml")
    cfg = dataclasses.replace(cfg0, max_bounce=8)        # bench.py:35
    vscene, vcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "vpt"),
                                   "cbox.xml")
    g = torch.Generator(device=dev).manual_seed(0)
    rays = cs.cbox_rays(torch, scene, cfg, g)
    vrays = cs.vpt_rays(torch, vscene, vcfg, g)
    N = rays["primary"][0].shape[0]
    b1_sets = {"primary": rays["primary"], "bounce": rays["bounce"]}
    # sparse wavefronts, as late bounces leave them: the bounce rays with
    # half and four fifths of their lanes dead, scattered
    gd = torch.Generator(device=dev).manual_seed(1)
    bo, bd, _bfar = rays["bounce"]
    for share in (50, 80):
        b1_sets[f"bounce {share}% dead"] = (bo, bd, torch.where(
            torch.rand(N, generator=gd, device=dev) < share / 100, K.DEAD,
            K.FAR))
    # every build bit-equal to the plain versions, on its own tables
    for tag, (o, d, far) in b1_sets.items():
        want = K.tri_closest_hit_plain(scene, o, d, far)
        for name, fns in builds.items():
            for build in ((False, True) if name == "baseline" and flags
                          else (None,)):
                kw = {} if build is None else {"build": build}
                got = fns["closest"](scene, o, d, far, **kw)
                cs._require(all(torch.equal(a, b) for a, b in
                                zip(got, want)),
                            f"{name} closest hit ({tag}) differs from the "
                            "plain version")
    # B2's sets: the cbox shadow rays, with half and four fifths of their
    # lanes dead; the direct preview's at 512^2; a transient pass's calls
    so, sd, sfar = rays["shadow"]
    g2 = torch.Generator(device=dev).manual_seed(2)
    b2_sets = {"shadow": (scene, [(so, sd, sfar)])}
    for share in (50, 80):
        b2_sets[f"shadow {share}% dead"] = (scene, [(so, sd, torch.where(
            torch.rand(N, generator=g2, device=dev) < share / 100, K.DEAD,
            sfar))])
    b2_sets["direct 512^2"] = (scene, [cs.direct_rays(torch, scene, cfg0)])
    tscene, tcalls = transient_rays(C, K)
    b2_sets[f"transient pass ({len(tcalls)} calls)"] = (tscene, tcalls)
    for tag, (sc, calls) in b2_sets.items():
        for o, d, far in calls:
            want = K.tri_any_hit_plain(sc, o, d, far)
            for name, fns in builds.items():
                cs._require(torch.equal(fns["any"](sc, o, d, far), want),
                            f"{name} any hit ({tag}) differs from the "
                            "plain version")
    vo, vd, vfar = vrays["shadow"]
    vbo, vbd, vbfar = vrays["bounce"]
    vfar50 = torch.where(torch.rand(N, generator=gd, device=dev) < 0.5,
                         K.DEAD, vfar)
    for o, d, far, k, all_null in ((vo, vd, vfar, 2, False),
                                   (vo, vd, vfar50, 2, False),
                                   (vbo, vbd, vbfar, 7, True)):
        want = K.tri_track_hits_plain(vscene, o, d, far, k,
                                      K.null_flags(vscene, all_null))
        for name, fns in builds.items():
            for build in ((False, True) if name == "baseline" and flags
                          else (None,)):
                kw = {} if build is None else {"build": build}
                got = fns["track"](vscene, o, d, far, k, all_null, **kw)
                cs._require(all(torch.equal(a, b) for a, b in
                                zip(got, want)),
                            f"{name} media walk (K={k}) differs from the "
                            "plain version")

    def timed_render(r):
        r.render_batch(1)                     # warm-up sample
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_batch(args.spp)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.spp

    def turn(name):
        fns = builds[name]
        row = {"build": name}
        calls = {}
        for tag, (sc, rays_) in b2_sets.items():
            calls[f"B2 {tag}"] = (lambda sc=sc, rays_=rays_: [
                fns["any"](sc, o, d, far) for o, d, far in rays_])
        if args.b2_only or name in extras:
            for key, call in calls.items():
                row[f"{key} ms"] = cs._time_ms(torch, call)
                row[f"{key} device_ms"] = cs._graph_ms(torch, call)
            print(f"{name}: " + "; ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k != "build")
                + f" [{card}]", flush=True)
            return row
        for tag, (o, d, far) in b1_sets.items():
            calls[f"B1 {tag}"] = (lambda o=o, d=d, far=far, **kw:
                                  fns["closest"](scene, o, d, far, **kw))
        calls["B3 shadow"] = (lambda **kw: fns["track"](
            vscene, vo, vd, vfar, 2, False, **kw))
        calls["B3 shadow 50% dead"] = (lambda **kw: fns["track"](
            vscene, vo, vd, vfar50, 2, False, **kw))
        for key, call in calls.items():
            row[f"{key} ms"] = cs._time_ms(torch, call)
            row[f"{key} device_ms"] = cs._graph_ms(torch, call)
            if name == "baseline" and flags and "dead" not in key \
                    and not key.startswith("B2"):
                row[f"{key} ms, table build"] = cs._time_ms(
                    torch, lambda: call(build=True))
                row[f"{key} device_ms, table build"] = cs._graph_ms(
                    torch, lambda: call(build=True))
        if name in ("baseline", "current"):
            saved = K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits
            extra = {"build": True} if name == "baseline" and flags else {}
            K.tri_closest_hit = (lambda *a: fns["closest"](*a, **extra))
            K.tri_any_hit = (lambda *a: fns["any"](*a, **extra))
            K.tri_track_hits = (lambda *a, **kw: fns["track"](*a, **kw,
                                                              **extra))
            try:
                row["cbox ms/spp"] = timed_render(pt.Renderer(scene, cfg,
                                                              seed=0))
                row["vpt cbox ms/spp"] = timed_render(
                    vpt.VolumeRenderer(vscene, vcfg, seed=0))
            finally:
                K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits = saved
        print(f"{name}: " + "; ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "build")
            + f" [{card}]", flush=True)
        return row

    order = ["baseline"] if args.baseline_only else \
        ["baseline", "current", *extras, *extras[::-1], "current",
         "baseline"]
    turns = [turn(name) for name in order]
    if args.baseline_only:
        turns.append(turn("baseline"))

    res, sass = {}, {}
    for name, lib in libs.items():
        res[name] = resources(lib._name)
        for kernel in TRI_KERNELS:
            body = sass_of(lib._name, kernel)
            if args.sass:
                Path(args.sass).mkdir(parents=True, exist_ok=True)
                tag = re.sub(r"\W", "_", name)
                Path(args.sass, f"{tag}_{kernel}.sass").write_text(
                    "\n".join(body) + "\n")
            sass[f"{name} {kernel}"] = sass_loops(body)
        print(f"{name}: " + "; ".join(
            f"{k} {r} registers, {sh} B shared, {lo} B local, {b} blocks of "
            f"256 an SM" for k, (r, sh, lo, b) in res[name].items()),
            flush=True)
    for key, loops in sass.items():
        print(f"SASS {key}: loops (first-last address, instructions, loads "
              "among them): " + "; ".join(
                  f"{a:#x}-{b:#x} {n} {kinds}" for a, b, n, kinds in loops),
              flush=True)
    print(card)
    print(json.dumps({"card": card, "rays": N, "spp": args.spp,
                      "extras": dict(zip(extras, args.extra)),
                      "b2_sets": {tag: [int((far > K.RAY_EPS).sum())
                                        for _o, _d, far in rays_]
                                  for tag, (_s, rays_) in b2_sets.items()},
                      "turns": turns, "resources": res,
                      "sass_loops": sass}))


if __name__ == "__main__":
    main()
