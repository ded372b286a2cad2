"""The sweep kernels (B6a, B6b) against a baseline build of them, in one
process on one card.

    python -m adapt_tpu_torch.sweep_ab BASELINE.cu [--spp 3]

BASELINE.cu is an earlier csrc/cluster_intersect.cu whose sweep entry
points read the 18-wide rows only, e.g. the one-thread-a-ray kernels of
commit 0633ac4 (`git show 0633ac4:adapt_tpu_torch/csrc/cluster_intersect.cu
> build/baseline.cu`); it is built beside the current source with the same
flags. On knot290k (512^2, 12 bounces), 262,144 rays a batch as in
chip_smoke.py phase 2e (bounce rays from the primary hits in seeded random
directions, 15% dead lanes; shadow rays to the point light; its tie set),
both builds are held bit-equal to the plain versions, then timed in turns
baseline, current, current, baseline: single calls and CUDA-graph device
times of each kernel (chip_smoke.py `_time_ms`, `_graph_ms`), and ms/spp of
the renderer under `big_tier="sweep"` with each build's pair of kernels.
Prints one line per turn, the card's name and power limit, and a JSON line.
Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def baseline_kernels(path):
    """(closest, any) wrappers of the baseline build, with the current
    wrappers' arguments and outputs."""
    from .ops import _build, cluster_kernels as CK
    from .ops.intersect_kernels import _check
    lib = _build.compiled("cluster_baseline", Path(path), _build._nvcc,
                          _build.NVCC_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cluster_closest_hit.argtypes = [P, P, P, I, P, P, P, P, I, I,
                                        I] + [P] * 8
    lib.cluster_any_hit.argtypes = [P, P, P, I, P, P, P, P, I, I, I, P, P]
    lib.cluster_closest_hit.restype = lib.cluster_any_hit.restype = I

    def tables(scene):
        return (scene.cl_aabb.data_ptr(), scene.cl_chunk.data_ptr(),
                scene.cl_count.data_ptr(), scene.cl_rows.data_ptr(),
                scene.n_clusters, scene.cl_chunk.shape[1],
                scene.cluster_size)

    def closest(scene, ray_o, ray_d, far0):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        t, u, v = (torch.empty(n, device=ro.device) for _ in range(3))
        gid, obj, sph = (torch.empty(n, dtype=torch.int32, device=ro.device)
                         for _ in range(3))
        n_g = torch.empty((n, 3), device=ro.device)
        _check(lib.cluster_closest_hit(
            ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n, *tables(scene),
            t.data_ptr(), gid.data_ptr(), u.data_ptr(), v.data_ptr(),
            n_g.data_ptr(), obj.data_ptr(), sph.data_ptr(), CK._stream(ro)),
            "baseline cluster_closest_hit")
        if CK._has_spheres(scene):
            u, v = CK._sphere_uv(n_g, sph > 0, u, v)
        return t, gid, u, v, n_g, obj

    def any_hit(scene, ray_o, ray_d, far0):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        occ = torch.empty(n, dtype=torch.bool, device=ro.device)
        _check(lib.cluster_any_hit(
            ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n, *tables(scene),
            occ.data_ptr(), CK._stream(ro)), "baseline cluster_any_hit")
        return occ
    return closest, any_hit


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def knot_rays():
    """(scene, cfg, rays) on the card: knot290k and its 262,144 primary
    rays, the bounce rays from their hits in seeded random directions (15%
    dead lanes) and the shadow rays to the point light, as
    {name: (ro, rd, far)} for "primary", "bounce" and "shadow"."""
    import chip_smoke as cs
    from . import rng
    from .ops import cluster_kernels as CK, intersect_kernels as K
    from .renderer.base import camera_rays
    from .scene import compile as C
    cs.knot_mesh()
    scene, cfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "cbox"),
                                 "knot290k.xml")
    dev = scene.device
    ro, rd = camera_rays(scene, cfg, rng.split(rng.PRNGKey(1))[1], 1)
    ro = ro.contiguous()
    N = ro.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    far_p = torch.full((N,), K.FAR, device=dev)
    t_p, gid_p = CK.cluster_closest_hit(scene, ro, rd, far_p)[:2]
    alive = (gid_p >= 0) & (torch.rand(N, generator=g, device=dev) > 0.15)
    bo = ro + torch.where(alive, t_p, 0.0)[:, None] * rd
    bd = torch.randn((N, 3), generator=g, device=dev)
    bd = bd / bd.norm(dim=-1, keepdim=True)
    far_b = torch.where(alive, K.FAR, K.DEAD)
    to_l = scene.emit_pos[0] - bo
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None]
    far_s = torch.where(alive, dist - K.RAY_EPS, K.DEAD)
    return scene, cfg, {"primary": (ro, rd, far_p), "bounce": (bo, bd, far_b),
                        "shadow": (bo, sd, far_s)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="an earlier csrc/cluster_intersect.cu")
    ap.add_argument("--spp", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ab: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from .ops import cluster_kernels as CK, intersect_kernels as K
    from .renderer import pt

    card = card_name()
    kernels = {"current": (CK.cluster_closest_hit, CK.cluster_any_hit),
               "baseline": baseline_kernels(args.baseline)}
    scene, cfg, rays = knot_rays()
    bo, bd, far_b = rays["bounce"]
    _bo, sd, far_s = rays["shadow"]
    N = bo.shape[0]
    tro, trd, tdist = cs.tie_rays(torch, scene, cs.TIE_RAYS, 7)
    tfar = torch.full_like(tdist, K.FAR)
    for o, d, far, tag in ((bo, bd, far_b, "bounce"),
                           (tro, trd, tfar, "tie")):
        want = CK.cluster_closest_hit_plain(scene, o, d, far)
        for build, (closest, _any) in kernels.items():
            got = closest(scene, o, d, far)
            cs._require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{build} closest hit ({tag} rays) differs from "
                        "the plain version")
    for o, d, far, tag in ((bo, sd, far_s, "shadow"),
                           (tro, trd, tdist, "tie")):
        want = CK.cluster_any_hit_plain(scene, o, d, far)
        for build, (_closest, any_hit) in kernels.items():
            cs._require(torch.equal(any_hit(scene, o, d, far), want),
                        f"{build} any hit ({tag} rays) differs from the "
                        "plain version")

    rcfg = dataclasses.replace(cfg, big_tier="sweep")
    saved = CK.cluster_closest_hit, CK.cluster_any_hit
    turns = []
    try:
        for build in ("baseline", "current", "current", "baseline"):
            closest, any_hit = kernels[build]
            row = {"build": build}
            for name, fn in (
                    ("closest", lambda: closest(scene, bo, bd, far_b)),
                    ("any", lambda: any_hit(scene, bo, sd, far_s))):
                row[f"{name}_ms"] = cs._time_ms(torch, fn)
                row[f"{name}_device_ms"] = cs._graph_ms(torch, fn)
            CK.cluster_closest_hit, CK.cluster_any_hit = closest, any_hit
            r = pt.Renderer(scene, rcfg, seed=0)
            r.render_batch(1)                # the alive probe + a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_batch(args.spp)
            torch.cuda.synchronize()
            row["ms_per_spp"] = 1e3 * (time.perf_counter() - t0) / args.spp
            CK.cluster_closest_hit, CK.cluster_any_hit = saved
            turns.append(row)
            print(f"{build}: B6a bounce {row['closest_ms']:.4f} ms (device "
                  f"{row['closest_device_ms']:.4f}), B6b shadow "
                  f"{row['any_ms']:.4f} ms (device "
                  f"{row['any_device_ms']:.4f}), knot290k sweep tier "
                  f"{row['ms_per_spp']:.2f} ms/spp [{card}]", flush=True)
    finally:
        CK.cluster_closest_hit, CK.cluster_any_hit = saved
    print(card)
    print(json.dumps({"card": card, "rays": N, "spp": args.spp,
                      "turns": turns}))


if __name__ == "__main__":
    main()
