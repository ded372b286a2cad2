"""The pick passes (B6d, B6e) against a baseline build of them, in one
process on one card.

    python -m adapt_tpu_torch.pick_ab BASELINE.cu [--spp 3]

BASELINE.cu is an earlier csrc/cluster_intersect.cu whose pick entry
points take the 18-wide rows `cl_rows` where the current ones take
`cl_rows_v4`, with the same arguments otherwise: `cluster_pick_closest(
picks, ro, rd, far0, wid0, n, cl_count, rows, CM, t, wid, stream)` and
`cluster_pick_any(picks, ro, rd, far0, n, cl_count, rows, CM, occ,
stream)`, e.g. those of commit 6b13bb9 (`git show
6b13bb9:adapt_tpu_torch/csrc/cluster_intersect.cu > build/base.cu`). It is
built beside the current source with the same flags. On knot290k (512^2,
12 bounces), with sweep_ab.py `knot_rays` (262,144 rays a batch), the
schedule's own picks: the bounce rays' front pass, sort and tile picks for
B6d (pass 0 from far and wid -1, pass 1 from pass 0's t and wid, as
`qpick_closest` chains them) and the shadow rays' for B6e (both passes
from far). Both builds are held bit-equal to the plain versions on those
passes and on chip_smoke.py's tie set, and the queue-pick cleanup's
residual set (front_any_ab.py `residual_rays`) must come out the same with
either build's B6e in place. Then they are timed in turns baseline,
current, current, baseline: single calls and CUDA-graph device times
(chip_smoke.py `_time_ms`, `_graph_ms`) of B6d on pass 0 and pass 1 and
of B6e on pass 0 and pass 1, and ms/spp of the renderer under
`big_tier="qpick"` with each build's pair in place; per pass, the share of
tiles with a pick and the live rows of their clusters. Last, the SASS of both
builds' pick kernels (`cuobjdump -sass`): the instructions of each loop
(a backward branch and its target), with the shared, global and
special-function loads among them, and with `--sass DIR` each kernel's
listing in DIR. Prints one line per turn, the loops, the card's name and
power limit, and a JSON line. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import collections
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

from .front_any_ab import residual_rays
from .sweep_ab import ROOT, card_name, knot_rays

PICK_KERNELS = ("cluster_pick_closest_kernel", "cluster_pick_any_kernel")


def baseline_kernels(path):
    """(ctypes library, (closest, any) wrappers) of the baseline build,
    with the current wrappers' arguments and outputs."""
    from .ops import _build, cluster_kernels as CK
    from .ops.intersect_kernels import _check
    lib = _build.compiled("pick_baseline", Path(path), _build._nvcc,
                          _build.NVCC_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cluster_pick_closest.argtypes = [P, P, P, P, P, I, P, P, I, P, P, P]
    lib.cluster_pick_any.argtypes = [P, P, P, P, I, P, P, I, P, P]
    lib.cluster_pick_closest.restype = lib.cluster_pick_any.restype = I

    def closest(scene, ray_o, ray_d, far0, wid0, picks):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        t = torch.empty(n, device=ro.device)
        wid = torch.empty(n, dtype=torch.int32, device=ro.device)
        _check(lib.cluster_pick_closest(
            picks.data_ptr(), ro.data_ptr(), rd.data_ptr(), far.data_ptr(),
            wid0.data_ptr(), n, scene.cl_count.data_ptr(),
            scene.cl_rows.data_ptr(), scene.cluster_size, t.data_ptr(),
            wid.data_ptr(), CK._stream(ro)), "baseline cluster_pick_closest")
        return t, wid

    def any_hit(scene, ray_o, ray_d, far0, picks):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        occ = torch.empty(n, dtype=torch.bool, device=ro.device)
        _check(lib.cluster_pick_any(
            picks.data_ptr(), ro.data_ptr(), rd.data_ptr(), far.data_ptr(),
            n, scene.cl_count.data_ptr(), scene.cl_rows.data_ptr(),
            scene.cluster_size, occ.data_ptr(), CK._stream(ro)),
            "baseline cluster_pick_any")
        return occ
    return lib, (closest, any_hit)


def sass_of(so_path, kernel):
    """The SASS listing of `kernel` in the library `so_path`, as lines."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            body.append(line)
    return body


def sass_loops(body):
    """The loops of a SASS listing (`sass_of`): for each backward branch,
    (first address, last address, instructions from its target to the
    branch, {opcode: count} of the LDS / LDG / MUFU / BAR / SYNCS among
    them), innermost (fewest instructions) first."""
    addr_of, code, label = {}, [], None
    for line in body:
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            label = lab.group(1)
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        addr = int(ins.group(1), 16)
        if label:
            addr_of[label] = addr
            label = None
        code.append((addr, ins.group(2)))
    loops = []
    for addr, op in code:
        m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", op)
        if not m:
            continue
        tgt = m.group(1)
        start = int(tgt, 16) if tgt.startswith("0x") else addr_of.get(tgt)
        if start is None or start > addr:
            continue
        span = [o.split()[o.startswith("@")].split(".")[0]
                for a, o in code if start <= a <= addr]
        kinds = collections.Counter(
            o for o in span if o in ("LDS", "LDG", "MUFU", "BAR", "SYNCS"))
        loops.append((start, addr, len(span), dict(kinds)))
    return sorted(loops, key=lambda x: x[2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="an earlier csrc/cluster_intersect.cu")
    ap.add_argument("--spp", type=int, default=3)
    ap.add_argument("--sass", help="a directory for the kernels' listings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pick_ab: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from .ops import cluster_kernels as CK
    from .ops.intersect_kernels import FAR
    from .renderer import pt

    card = card_name()
    base_lib, base = baseline_kernels(args.baseline)
    kernels = {"current": (CK.cluster_pick_closest, CK.cluster_pick_any),
               "baseline": base}
    scene, cfg, rays = knot_rays()
    C = scene.n_clusters
    N = rays["bounce"][0].shape[0]
    tro, trd, tdist = cs.tie_rays(torch, scene, cs.TIE_RAYS, 7)
    sets = {}
    for tag, (o, d, far) in (("bounce", rays["bounce"]),
                             ("tie", (tro, trd, torch.full_like(tdist, FAR))),
                             ("shadow", rays["shadow"]),
                             ("tie any", (tro, trd, tdist))):
        _perm, o, d, far, cid, _nxt = CK._front_sort(scene, o, d, far)
        sets[tag] = (o, d, far, CK.tile_picks(cid, C, CK.QP_P)[0])
    # the closest-hit passes chained as qpick_closest chains them: pass
    # p's inputs (t, wid), from the plain versions
    chained = {}
    for tag in ("bounce", "tie"):
        o, d, far, picks = sets[tag]
        t, wid = far, torch.full(far.shape, -1, dtype=torch.int32,
                                 device=far.device)
        for p, pk in enumerate(picks):
            chained[(tag, p)] = (t, wid)
            want = CK.cluster_pick_closest_plain(scene, o, d, t, wid, pk)
            for build, (closest, _any) in kernels.items():
                got = closest(scene, o, d, t, wid, pk)
                cs._require(all(torch.equal(a, b) for a, b in
                                zip(got, want)),
                            f"{build} pick closest ({tag} rays, pass {p}) "
                            "differs from the plain version")
            t, wid = want
    for tag in ("shadow", "tie any"):
        o, d, far, picks = sets[tag]
        for p, pk in enumerate(picks):
            want = CK.cluster_pick_any_plain(scene, o, d, far, pk)
            for build, (_closest, any_hit) in kernels.items():
                cs._require(torch.equal(any_hit(scene, o, d, far, pk), want),
                            f"{build} pick any ({tag} rays, pass {p}) "
                            "differs from the plain version")
    saved = CK.cluster_pick_closest, CK.cluster_pick_any
    residual = {}
    try:
        for build, (_closest, any_hit) in kernels.items():
            CK.cluster_pick_any = any_hit
            residual[build] = residual_rays(scene, *rays["shadow"])[2]
            CK.cluster_pick_any = saved[1]
    finally:
        CK.cluster_pick_closest, CK.cluster_pick_any = saved
    cs._require(torch.equal(residual["current"], residual["baseline"]),
                "the queue-pick residual set differs between the builds")

    turns = []
    try:
        for build in ("baseline", "current", "current", "baseline"):
            closest, any_hit = kernels[build]
            row = {"build": build}
            o, d, _far, picks = sets["bounce"]
            for p, pk in enumerate(picks):
                t, wid = chained[("bounce", p)]

                def call(t=t, wid=wid, pk=pk):
                    return closest(scene, o, d, t, wid, pk)
                row[f"closest_pass{p}_ms"] = cs._time_ms(torch, call)
                row[f"closest_pass{p}_device_ms"] = cs._graph_ms(torch, call)
            o, d, far, picks = sets["shadow"]
            for p, pk in enumerate(picks):
                def call(pk=pk):
                    return any_hit(scene, o, d, far, pk)
                row[f"any_pass{p}_ms"] = cs._time_ms(torch, call)
                row[f"any_pass{p}_device_ms"] = cs._graph_ms(torch, call)
            CK.cluster_pick_closest, CK.cluster_pick_any = closest, any_hit
            r = pt.Renderer(scene, dataclasses.replace(cfg, big_tier="qpick"),
                            seed=0)
            r.render_batch(1)                # the alive probe + a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_batch(args.spp)
            torch.cuda.synchronize()
            row["qpick_ms_per_spp"] = 1e3 * (time.perf_counter() - t0) \
                / args.spp
            CK.cluster_pick_closest, CK.cluster_pick_any = saved
            turns.append(row)
            print(f"{build}: B6d pass 0 {row['closest_pass0_ms']:.4f} ms "
                  f"(device {row['closest_pass0_device_ms']:.4f}), pass 1 "
                  f"{row['closest_pass1_ms']:.4f} (device "
                  f"{row['closest_pass1_device_ms']:.4f}); B6e pass 0 "
                  f"{row['any_pass0_ms']:.4f} ms (device "
                  f"{row['any_pass0_device_ms']:.4f}), pass 1 "
                  f"{row['any_pass1_ms']:.4f} (device "
                  f"{row['any_pass1_device_ms']:.4f}); knot290k qpick tier "
                  f"{row['qpick_ms_per_spp']:.2f} ms/spp [{card}]",
                  flush=True)
    finally:
        CK.cluster_pick_closest, CK.cluster_pick_any = saved

    sass = {}
    for build, lib in (("current", CK._lib()), ("baseline", base_lib)):
        for kernel in PICK_KERNELS:
            body = sass_of(lib._name, kernel)
            if args.sass:
                Path(args.sass).mkdir(parents=True, exist_ok=True)
                Path(args.sass, f"{build}_{kernel}.sass").write_text(
                    "\n".join(body) + "\n")
            loops = sass_loops(body)
            sass[f"{build} {kernel}"] = loops
            print(f"SASS {build} {kernel}: loops (first-last address, "
                  "instructions, loads among them): " + "; ".join(
                      f"{a:#x}-{b:#x} {n} {kinds}" for a, b, n, kinds
                      in loops), flush=True)
    # per pass: the share of tiles with a pick, and the live rows of the
    # picked clusters over the active tiles (mean, most): a pass lasts as
    # long as its longest tiles
    tiles = {}
    for tag in ("bounce", "shadow"):
        for p, pk in enumerate(sets[tag][3]):
            rows = scene.cl_count[pk[pk >= 0].long()].float()
            tiles[f"{tag} pass {p}"] = (float((pk >= 0).float().mean()),
                                        float(rows.mean()), int(rows.max()))
    print("tiles (active share, live rows of an active tile: mean, most): "
          + "; ".join(f"{k} {a:.4f}, {m:.1f}, {x}"
                      for k, (a, m, x) in tiles.items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "rays": N, "spp": args.spp,
                      "tiles": tiles,
                      "live_residual": float((residual["current"] > 0)
                                             .float().mean()),
                      "turns": turns, "sass_loops": sass}))


if __name__ == "__main__":
    main()
