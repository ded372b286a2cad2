"""Multi-device dry run on the CPU (port of __graft_entry__.py
`dryrun_multichip`).

    python -m adapt_tpu_torch.dryrun 4

`dryrun_multichip(n)` starts a fresh subprocess that runs n gloo ranks on
the CPU (parallel/sharding.py), each rank one process. Over the mesh
`make_mesh(n)` every rank takes one step of each sharded renderer: the
unidirectional path tracer (averaged over 'spp'), BDPT (its t = 1 splat
plane summed over 'px') and VPT on the grid volume of cbox-volgrid.xml
(ratio and delta tracking inside each shard, no collective in the
march). It raises, with the subprocess's output, if any step fails.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small(name, w, device, max_bounce=2):
    from .scene.assets import load_volume
    from .scene.compile import load_scene
    load = load_volume if name == "cbox-volgrid.xml" else load_scene
    scene, cfg, _ = load(os.path.join(HERE, "scenes", "cbox"), name,
                         device=device)
    cfg = dataclasses.replace(
        cfg, w=w, h=w, focal=cfg.focal * w / min(cfg.w, cfg.h),
        max_bounce=max_bounce, start_x=0, end_x=w, start_y=0, end_y=w)
    return scene, cfg


def _body(rank, world, device):
    """One step of each sharded renderer over make_mesh(world)."""
    from .parallel.sharding import MultiChipRenderer, make_mesh
    from .renderer.vpt import trace_vpt

    mesh = make_mesh(world)
    w = 32                       # the pixel count must divide the px axis
    while (w * w) % mesh.shape["px"]:
        w *= 2
    scene, cfg = _small("cbox.xml", w, device)
    out = MultiChipRenderer(scene, cfg, mesh).render()
    assert out.shape == (cfg.n_pixels, 3) and bool(out.isfinite().all())
    assert MultiChipRenderer(scene, cfg, mesh).image().shape == (w, w, 3)
    out = MultiChipRenderer(scene, cfg, mesh, bdpt=True).render()
    assert out.shape == (cfg.n_pixels, 3) and bool(out.isfinite().all())
    vs, vcfg = _small("cbox-volgrid.xml", w, device)
    assert vcfg.volume_kind
    out = MultiChipRenderer(vs, vcfg, mesh, trace_fn=trace_vpt).render()
    assert out.shape == (vcfg.n_pixels, 3) and bool(out.isfinite().all())
    if rank == 0:
        print(f"dryrun: {world} ranks, mesh {mesh.shape}: pt, bdpt and "
              f"grid-volume vpt stepped", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run over n_devices gloo CPU ranks in a subprocess (one
    intra-op thread a rank); raises RuntimeError when it fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "adapt_tpu_torch.dryrun", str(int(n_devices))],
        cwd=HERE, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) subprocess failed "
            f"(rc={proc.returncode})\nstdout:\n{proc.stdout}\n"
            f"stderr:\n{proc.stderr}")


def main(argv=None):
    from .parallel.sharding import run_ranks
    from .scene.assets import vol_assets
    n = int((argv if argv is not None else sys.argv[1:])[0])
    vol_assets()                 # the volume's grid, where it is missing
    run_ranks(_body, n, device="cpu")
    print("dryrun body ok")


if __name__ == "__main__":
    main()
