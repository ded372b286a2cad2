"""The port's CLI: progressive rendering main loop (port of render.py).

    python -m adapt_tpu_torch.render --scene cbox --name cbox.xml --type pt

Headless progressive loop with a rich progress bar, checkpoint and resume,
transient export, a torch.profiler trace, watermark and image output, with
the flags of the JAX package's `render.py` (parsers/opts.py). Renderer
dispatch by --type {pt, vpt, bdpt, ao, direct} (reference render.py:33-34).

It renders on the CUDA device unless `--arch cpu` asks for the CPU, where
every kernel's plain PyTorch version runs; `--arch cuda` without a card
exits with an error. `--no_cache` is accepted and does nothing (the port
has no compile cache); `--debug` raises after a pass whose film holds a
NaN or an infinity.

`--multichip N` renders pt, vpt or bdpt with parallel/sharding.py's
MultiChipRenderer over N ranks, one process a device (-1: every visible
card; on --arch cpu, one rank a core up to 8). The CLI starts its ranks
itself (torch.multiprocessing), or joins the group torchrun made when it
runs under torchrun. The backend is NCCL on cuda and gloo on cpu. Rank 0
prints, writes the image and the checkpoint. Transient BDPT shards the
'spp' axis only.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import time

import numpy as np

from .parsers.opts import get_options

RENDERERS = {"pt": ("pt", "Renderer"), "vpt": ("vpt", "VolumeRenderer"),
             "bdpt": ("bdpt", "BDPT"), "ao": ("ssao", "SSAORenderer"),
             "direct": ("direct", "DirectRenderer")}


def build_renderer(opts, scene, cfg, world=None):
    """The renderer of --type; with `world` ranks (--multichip) the
    MultiChipRenderer over all of them."""
    if world is not None:
        from .parallel.sharding import MultiChipRenderer, make_mesh
        if opts.type == "bdpt":
            kw = {"bdpt": True}
        elif opts.type == "vpt":
            from .renderer.vpt import trace_vpt
            kw = {"trace_fn": trace_vpt}
        elif opts.type == "pt":
            kw = {}
        else:
            raise SystemExit(f"--multichip supports pt/vpt/bdpt, not "
                             f"{opts.type}")
        # transient BDPT scales over independent sample batches (px = 1)
        spp_par = world if (opts.type == "bdpt" and cfg.transient) else None
        mesh = make_mesh(world, spp_parallel=spp_par)
        if mesh.rank == 0:
            print(f"multichip mesh: {mesh.shape} over {world} devices")
        return MultiChipRenderer(scene, cfg, mesh, seed=opts.seed, **kw)
    mod_name, cls_name = RENDERERS[opts.type]
    mod = importlib.import_module(f"adapt_tpu_torch.renderer.{mod_name}")
    return getattr(mod, cls_name)(scene, cfg, seed=opts.seed)


def checkpoint_path(opts, cfg):
    """Renderer type and resolution go in the file name, so --width /
    --height overrides of one scene keep distinct checkpoints (render.py's
    names)."""
    os.makedirs("./checkpoint", exist_ok=True)
    return (f"./checkpoint/{opts.img_name}-{opts.scene}-{opts.type}"
            f"-{cfg.w}x{cfg.h}.pkl")


def save_check_point(rdr, opts):
    with open(checkpoint_path(opts, rdr.cfg), "wb") as f:
        pickle.dump(rdr.get_check_point(), f)


def export_transient_profile(rdr, opts, configs):
    """Export one image per time bin (reference render.py:36-58)."""
    from .utils.imaging import apply_watermark, write_image
    frames = rdr.transient_frames()          # (T, h, w, 3)
    qnt = opts.normalize if opts.normalize > 0 else 0.99
    frames = frames / max(np.quantile(frames, qnt), 1e-6)
    out_dir = os.path.join(opts.output_path, f"{opts.scene}-transient")
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        if not opts.no_watermark:
            frame = apply_watermark(frame)
        write_image(os.path.join(out_dir, f"{i:04d}.{opts.img_ext}"), frame)
    np.save(os.path.join(out_dir, "frames.npy"), frames)
    print(f"transient profile: {len(frames)} frames -> {out_dir}")
    if opts.analyze:
        from .utils.tdom_analyze import analyze_frames
        analyze_frames(frames, out_dir,
                       interval=float(configs.get("interval", 1.0)),
                       start_time=float(configs.get("min_time", 0.0)),
                       viz=True)


def _progress():
    """A rich progress bar, or None where rich is not installed."""
    try:
        from rich.progress import (BarColumn, MofNCompleteColumn, Progress,
                                   TextColumn, TimeElapsedColumn,
                                   TimeRemainingColumn)
    except ImportError:
        return None
    from .utils.rich_utils import ItersPerSecColumn
    return Progress(TextColumn("[bold blue]render"), BarColumn(),
                    MofNCompleteColumn(), ItersPerSecColumn(),
                    TimeElapsedColumn(), TimeRemainingColumn())


def _silent(*_a, **_k):
    pass


def _hold_preview(preview):
    """Keep serving the final frame until SIGTERM or Ctrl-C, as the
    reference's window outlives its render loop (render.py:129-152).
    ADAPT_SERVE_AFTER=0 exits at once; a number serves that many
    seconds."""
    hold = os.environ.get("ADAPT_SERVE_AFTER", "")
    if hold != "0":
        import signal
        import threading
        done = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: done.set())
        print("render finished; preview still serving (Ctrl-C to exit)",
              flush=True)
        try:
            done.wait(float(hold) if hold else None)
        except KeyboardInterrupt:
            pass
    preview.stop()


def main(argv=None):
    opts = get_options(argv)
    import torch
    if opts.arch == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--arch cuda: torch.cuda.is_available() is false "
                         "(--arch cpu renders on the CPU)")
    if not opts.multichip:
        return render(opts)
    from .parallel import sharding
    if sharding.under_torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dev = sharding.init_ranks(rank, world, None, opts.arch)
        try:
            render(opts, world, dev)
        finally:
            sharding.dist.destroy_process_group()
        return
    if opts.multichip > 0:
        world = opts.multichip
    elif opts.arch == "cuda":
        world = torch.cuda.device_count()
    else:
        world = min(os.cpu_count() or 1, 8)
    if opts.arch == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--multichip {world} --arch cuda: one rank a card, "
                         f"and {torch.cuda.device_count()} card(s) are "
                         f"visible")
    sharding.run_ranks(_rank_render, world, opts, device=opts.arch)


def _rank_render(rank, world, device, opts):
    render(opts, world, device)


def render(opts, world=None, device=None):
    """The progressive render of parsed options; world/device: this
    rank's world size and device under --multichip (rank 0 prints and
    writes)."""
    import torch
    t_start = time.time()
    lead = world is None or torch.distributed.get_rank() == 0
    from . import obs
    from .scene.compile import load_scene
    from .utils.imaging import (apply_watermark, quantile_normalize,
                                write_image)

    scene, cfg, configs = load_scene(
        os.path.join(opts.input_path, opts.scene), opts.name,
        device=opts.arch if device is None else device)
    if opts.width > 0 or opts.height > 0 or opts.max_bounce > 0:
        w = opts.width or cfg.w
        h = opts.height or cfg.h
        cfg = dataclasses.replace(
            cfg, w=w, h=h, focal=cfg.focal * min(w, h) / min(cfg.w, cfg.h),
            start_x=0, end_x=w, start_y=0, end_y=h,
            max_bounce=opts.max_bounce or cfg.max_bounce)
    if opts.true_unwarped:
        if not cfg.transient:
            raise SystemExit("--true_unwarped needs a transient scene "
                             "(decomposition key in the XML)")
        cfg = dataclasses.replace(cfg, unwarp=True)
    rdr = build_renderer(opts, scene, cfg, world)
    where = (f"cuda ({torch.cuda.get_device_name(scene.device)})"
             if scene.device.type == "cuda" else "cpu")
    say = print if lead else _silent
    say(f"scene '{opts.scene}/{opts.name}' loaded: {scene.n_prims} "
        f"prims, {cfg.w}x{cfg.h}, renderer={opts.type}, device={where}")

    preview = None
    if opts.serve >= 0 and lead:
        from .utils.preview import PreviewServer
        preview = PreviewServer(port=opts.serve,
                                name=f"{opts.scene}/{opts.name}")
        say(f"live preview: http://localhost:{preview.port}/")

    if opts.load and os.path.exists(checkpoint_path(opts, cfg)):
        with open(checkpoint_path(opts, cfg), "rb") as f:
            rdr.load_check_point(pickle.load(f))
        say(f"resumed from checkpoint at {rdr.cnt} iterations")

    iter_num = opts.iter_num if opts.iter_num > 0 \
        else configs.get("sample_count", 64)

    prof = None
    if opts.profile and lead:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if scene.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def loop_body(i):
        if opts.batch_spp > 1:
            rdr.render_batch(opts.batch_spp)
        else:
            rdr.render()
        if opts.debug and not bool(torch.isfinite(rdr.color).all()):
            raise FloatingPointError(
                f"--debug: the film holds a NaN or an infinity after pass "
                f"{i + 1} ({rdr.cnt} spp)")
        if not lead:
            return
        if opts.save_iter > 0 and (i + 1) % opts.save_iter == 0:
            save_check_point(rdr, opts)
        if opts.output_freq > 0 and (i + 1) % opts.output_freq == 0:
            write_image(os.path.join(opts.output_path,
                                     f"{opts.img_name}_{i + 1:05d}.png"),
                        rdr.image())
        if preview is not None and preview.due():
            preview.update(rdr.image(), rdr.cnt)

    progress = _progress() if lead else None
    try:
        if progress is not None:
            with progress:
                task = progress.add_task("render", total=iter_num)
                for i in range(iter_num):
                    loop_body(i)
                    progress.advance(task)
        else:
            for i in range(iter_num):
                loop_body(i)
    except KeyboardInterrupt:
        say("interrupted; saving checkpoint")
        if lead:
            save_check_point(rdr, opts)
        raise SystemExit(1)
    if not lead:
        return

    if prof is not None:
        if scene.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs("./profiler_trace", exist_ok=True)
        prof.export_chrome_trace("./profiler_trace/trace.json")
        with open("./profiler_trace/program.json", "w") as fh:
            json.dump(obs.export(), fh)
        say("profiler trace and the program's spans written to "
            "./profiler_trace")
    if preview is not None:
        preview.update(rdr.image(), rdr.cnt, min_interval=0.0)

    save_check_point(rdr, opts)
    img = rdr.image()
    if opts.normalize > 0:
        img = quantile_normalize(img, opts.normalize)
    if not opts.no_watermark:
        img = apply_watermark(img)
    if not opts.no_save_fig:
        out = os.path.join(opts.output_path,
                           f"{opts.img_name}.{opts.img_ext}")
        write_image(out, img)
        say(f"image written to {out}")

    if getattr(rdr, "is_transient", False):
        export_transient_profile(rdr, opts, configs)

    spp = rdr.cnt
    dt = time.time() - t_start
    say(f"done: {spp} spp in {dt:.2f}s ({spp / max(dt, 1e-9):.2f} it/s) "
        f"on {where}")

    if preview is not None:
        _hold_preview(preview)


if __name__ == "__main__":
    main()
