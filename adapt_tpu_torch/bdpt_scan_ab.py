"""BDPT on cbox-volgrid.xml at 640^2 and 12 bounces (chip_smoke.py phase
17) with a baseline tree's package and with this one's, in turns, each
in a process of its own on one card.

    python -m adapt_tpu_torch.bdpt_scan_ab BASELINE_ROOT [--spp 1]
        [--turns 1]

BASELINE_ROOT holds another commit's tree (`git archive` unpacked into a
git-ignored directory); its package renders as it is. This tree renders
with each of two designs of the march in the groups the JAX package
scans (renderer/bdpt.py `scan_form`: at 640^2 the 66 `gen` strategies in
7 chunks of 10): "blocks", the shipped one (one media walk and one
ratio-tracking march a chunk, a key a block of N lanes,
ops/volume_ops.py `_setup`), and "per-strategy" (`track_ray` called once
a strategy: a media walk and a march each). Every process renders one
64^2 pass at 3 bounces first (the kernels' build and load, not timed),
then `--spp` samples at full size from a new renderer, timed to
`torch.cuda.synchronize()` with every tracking call recorded
(`volume_ops.record_marches`, as chip_smoke does). A turn is baseline,
blocks, per-strategy, per-strategy, blocks, baseline.

Prints one line per process (ms/spp, media-walk launches, tracking calls
and march steps an spp, the image's mean), whether the two designs'
images have one mean (they draw the same numbers), the card's name and
power limit, and a JSON line. Run from the repository's root: the scene's .vol
file resolves against the working directory (`python -m
adapt_tpu_torch.scene.assets` writes it where missing). Needs the card
and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from .sweep_ab import ROOT, card_name

VARIANTS = ("baseline", "blocks", "per-strategy")

# one process's render; argv: the package's root, the variant, spp
CHILD = r'''
import dataclasses, json, sys, time
root, variant, spp = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
import torch
from adapt_tpu_torch.ops import intersect_kernels as K, volume_ops as V
from adapt_tpu_torch.renderer import bdpt as B
from adapt_tpu_torch.scene.assets import load_volume
if variant == "per-strategy":
    track = B.track_ray

    def per_strategy(scene, cfg, p, d, depth, key=None, thp=None,
                     active=None):
        if not isinstance(key, list):
            return track(scene, cfg, p, d, depth, key=key, thp=thp,
                         active=active)
        n = p.shape[0] // len(key)
        parts = [track(scene, cfg, p[i * n:(i + 1) * n],
                       d[i * n:(i + 1) * n], depth[i * n:(i + 1) * n],
                       key=k, thp=None if thp is None
                       else thp[i * n:(i + 1) * n],
                       active=None if active is None
                       else active[i * n:(i + 1) * n])
                 for i, k in enumerate(key)]
        return (torch.cat([tr for tr, _ in parts]),
                torch.cat([t for _, t in parts]))
    B.track_ray = per_strategy
scene, cfg, _ = load_volume("scenes/cbox", "cbox-volgrid.xml", "cuda")
cfg = dataclasses.replace(cfg, max_bounce=12)
small = dataclasses.replace(cfg, w=64, h=64, focal=cfg.focal * 64 / 512,
                            end_x=64, end_y=64, max_bounce=3)
B.BDPT(scene, small, seed=1).render_batch(1)
r = B.BDPT(scene, cfg, seed=0)
K.reset_launches()
with V.record_marches() as calls:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_batch(spp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
print(json.dumps(dict(
    variant=variant, ms=1e3 * dt / spp,
    b3=K.launches["tri_track_hits"] / spp, calls=len(calls) / spp,
    steps=sum(c["steps"] for c in calls) / spp,
    mean=float(r.image().mean()))))
'''


def run(root, variant, spp):
    """One process's render: its JSON dict."""
    p = subprocess.run(
        [sys.executable, "-c", CHILD, str(root), variant, str(spp)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise SystemExit(f"bdpt_scan_ab: {variant} failed: "
                         f"{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="root of the baseline tree")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    roots = {"baseline": os.path.abspath(args.baseline),
             "blocks": str(ROOT), "per-strategy": str(ROOT)}
    card = card_name()
    out = {v: [] for v in VARIANTS}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for _ in range(args.turns):
        for v in order:
            res = run(roots[v], v, args.spp)
            out[v].append(res)
            print(f"{v}: {res['ms']:.2f} ms/spp, media walk {res['b3']:g} "
                  f"launches, {res['calls']:g} tracking calls and "
                  f"{res['steps']:g} march steps an spp, image mean "
                  f"{res['mean']:.6f} [{card}]", flush=True)
    # the two designs draw the same numbers: the same image
    means = {r["mean"] for v in ("blocks", "per-strategy") for r in out[v]}
    print(f"the designs' image means: {sorted(means)} (equal: "
          f"{len(means) == 1})")
    print(card)
    print(json.dumps({v: dict(ms=[r["ms"] for r in rs],
                              median_ms=statistics.median(
                                  r["ms"] for r in rs),
                              b3=rs[0]["b3"], calls=rs[0]["calls"],
                              mean=rs[0]["mean"])
                      for v, rs in out.items()}))


if __name__ == "__main__":
    main()
