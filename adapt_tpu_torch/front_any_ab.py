"""The front pass (B6c) and the BVH any hit (B5b) against a baseline build
of them, in one process on one card.

    python -m adapt_tpu_torch.front_any_ab CLUSTER.cu BVH.cu [--spp 3]

CLUSTER.cu is an earlier csrc/cluster_intersect.cu whose front entry
point reads the (C, 6) box table, `cluster_front(ro, rd, far0, n, cl_front,
C, cid, nxt, stream)`; BVH.cu an earlier csrc/bvh_intersect.cu whose
any-hit entry point reads the (M, 9) and (P, 14) packs, `bvh_any_hit(ro,
rd, far0, n, nodes, M, prims, occ, stream)`: those of commit 3a02e60
(`git show 3a02e60:adapt_tpu_torch/csrc/cluster_intersect.cu >
build/base_cluster.cu`, the same for bvh_intersect.cu). Both are built
beside the current sources with the same flags. On knot290k (512^2, 12
bounces), with sweep_ab.py `knot_rays` (262,144 primary, bounce and shadow
rays), chip_smoke.py's tie and adversarial sets and the queue-pick
cleanup's residual set of the shadow rays (its own front pass, sort and
pick passes; the other lanes dead), both builds are held to the plain
versions (B6c bit-equal to `cluster_front_plain`, B5b equal to
`bvh.walk(any_hit=True)`), then timed in turns baseline, current,
current, baseline: single calls and CUDA-graph device times (chip_smoke.py
`_time_ms`, `_graph_ms`) of B6c on bounce and primary rays and of B5b on
shadow, bounce and residual rays, and ms/spp of the renderer under
`big_tier="qpick"` (both kernels) and the default BVH tier (B5b) with each
build's pair in place. Prints one line per turn, the card's name and
power limit, and a JSON line. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from .sweep_ab import ROOT, card_name, knot_rays


def baseline_kernels(cluster_src, bvh_src):
    """(front, any hit) wrappers of the baseline builds, with the current
    wrappers' arguments and outputs."""
    from .ops import _build, bvh_kernels as BK, cluster_kernels as CK
    from .ops.intersect_kernels import _check
    clib = _build.compiled("front_baseline", Path(cluster_src), _build._nvcc,
                           _build.NVCC_FLAGS)
    blib = _build.compiled("any_baseline", Path(bvh_src), _build._nvcc,
                           _build.NVCC_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    clib.cluster_front.argtypes = [P, P, P, I, P, I, P, P, P]
    blib.bvh_any_hit.argtypes = [P, P, P, I, P, I, P, P, P]
    clib.cluster_front.restype = blib.bvh_any_hit.restype = I

    def front(scene, ray_o, ray_d, far0):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        cid = torch.empty(n, dtype=torch.int32, device=ro.device)
        nxt = torch.empty(n, device=ro.device)
        _check(clib.cluster_front(
            ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
            scene.cl_front.data_ptr(), scene.n_clusters, cid.data_ptr(),
            nxt.data_ptr(), CK._stream(ro)), "baseline cluster_front")
        return cid, nxt

    def any_hit(scene, ray_o, ray_d, far0):
        ro, rd, far, n = CK._operands(scene, ray_o, ray_d, far0)
        nodes, prims = scene.bvh_node_pack, scene.bvh_prim_pack
        occ = torch.empty(n, dtype=torch.bool, device=ro.device)
        _check(blib.bvh_any_hit(
            ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
            nodes.data_ptr(), nodes.shape[0], prims.data_ptr(),
            occ.data_ptr(), CK._stream(ro)), "baseline bvh_any_hit")
        return occ
    return front, any_hit


def residual_rays(scene, ro, rd, far):
    """Queue-pick's cleanup set of an any-hit batch (ops/cluster_kernels.py
    `qpick_any`): the sorted rays, far kept on the residual lanes and -3e38
    on the others."""
    from .ops import cluster_kernels as CK
    from .ops.intersect_kernels import DEAD
    C = scene.n_clusters
    _perm, qro, qrd, qfar, cid, nxt = CK._front_sort(scene, ro, rd, far)
    picks, covered = CK.tile_picks(cid, C, CK.QP_P)
    occ = torch.zeros_like(covered)
    for p in range(CK.QP_P):
        occ |= CK.cluster_pick_any(scene, qro, qrd, qfar, picks[p])
    res = (cid < C) & ~occ & (~covered | (nxt < CK.BIG))
    return qro, qrd, torch.where(res, qfar, DEAD)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cluster", help="an earlier csrc/cluster_intersect.cu")
    ap.add_argument("bvh", help="an earlier csrc/bvh_intersect.cu")
    ap.add_argument("--spp", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("front_any_ab: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from .ops import bvh_kernels as BK, cluster_kernels as CK
    from .ops.intersect_kernels import FAR, RAY_EPS
    from .renderer import pt

    card = card_name()
    kernels = {"current": (CK.cluster_front, BK.bvh_any_hit),
               "baseline": baseline_kernels(args.cluster, args.bvh)}
    scene, cfg, rays = knot_rays()
    N = rays["bounce"][0].shape[0]
    tro, trd, tdist = cs.tie_rays(torch, scene, cs.TIE_RAYS, 7)
    rays["tie"] = (tro, trd, torch.full_like(tdist, FAR))
    rays["adversarial"] = cs.adversarial_rays(torch, scene, N, 11)
    rays["residual"] = residual_rays(scene, *rays["shadow"])
    for tag in ("primary", "bounce", "shadow", "tie", "adversarial"):
        want = CK.cluster_front_plain(scene, *rays[tag])
        for build, (front, _any) in kernels.items():
            got = front(scene, *rays[tag])
            cs._require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{build} front pass ({tag} rays) differs from the "
                        "plain version")
    for tag in ("shadow", "bounce", "residual", "adversarial"):
        want = BK.bvh_any_hit_plain(scene, *rays[tag])
        for build, (_front, any_hit) in kernels.items():
            cs._require(torch.equal(any_hit(scene, *rays[tag]), want),
                        f"{build} any hit ({tag} rays) differs from the "
                        "twin")

    saved = CK.cluster_front, BK.bvh_any_hit
    turns = []
    try:
        for build in ("baseline", "current", "current", "baseline"):
            front, any_hit = kernels[build]
            row = {"build": build}
            for name, fn, tags in (
                    ("front", front, ("bounce", "primary")),
                    ("any", any_hit, ("shadow", "bounce", "residual"))):
                for tag in tags:
                    def call(fn=fn, tag=tag):
                        return fn(scene, *rays[tag])
                    row[f"{name}_{tag}_ms"] = cs._time_ms(torch, call)
                    row[f"{name}_{tag}_device_ms"] = cs._graph_ms(torch, call)
            CK.cluster_front, BK.bvh_any_hit = front, any_hit
            for tier in ("qpick", "bvh"):
                r = pt.Renderer(scene, dataclasses.replace(cfg, big_tier=tier),
                                seed=0)
                r.render_batch(1)            # the alive probe + a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render_batch(args.spp)
                torch.cuda.synchronize()
                row[f"{tier}_ms_per_spp"] = \
                    1e3 * (time.perf_counter() - t0) / args.spp
            CK.cluster_front, BK.bvh_any_hit = saved
            turns.append(row)
            print(f"{build}: B6c bounce {row['front_bounce_ms']:.4f} ms "
                  f"(device {row['front_bounce_device_ms']:.4f}; primary "
                  f"{row['front_primary_device_ms']:.4f}), B5b shadow "
                  f"{row['any_shadow_ms']:.4f} ms (device "
                  f"{row['any_shadow_device_ms']:.4f}; bounce "
                  f"{row['any_bounce_device_ms']:.4f}, qpick residual "
                  f"{row['any_residual_device_ms']:.4f}), knot290k qpick "
                  f"tier {row['qpick_ms_per_spp']:.2f} ms/spp, BVH tier "
                  f"{row['bvh_ms_per_spp']:.2f} ms/spp [{card}]", flush=True)
    finally:
        CK.cluster_front, BK.bvh_any_hit = saved
    print(card)
    print(json.dumps({"card": card, "rays": N, "spp": args.spp,
                      "live_residual": float((rays["residual"][2] > RAY_EPS)
                                             .float().mean()),
                      "turns": turns}))


if __name__ == "__main__":
    main()
