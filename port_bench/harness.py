"""One run of one cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by its name in BENCHMARK.json:
`configs/<config>.json` (the scene and the values changed from it),
`traffic/<traffic>.json` (its driver, passes of warm-up, passes traced),
`drivers/<driver>.py` (how the traffic drives the program, its reference
and its traced ranges), `limits/<cell>.json` (pixels compared and the
limit of each number compared) and `metrics/<metric>.py` (a reader of the
run's record).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import assets

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "adapt_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, missing files, a forbidden
    module)."""


def manifest(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} is missing")
    return json.loads(path.read_text())


def cell(bench, workload, base=HERE):
    """(workload entry, config dict, traffic dict, limits dict); the
    traffic and limits files under `base`."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise Refused(f"no workload named {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return (w, json.loads((ROOT / conf["file"]).read_text()),
            json.loads((base / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
            json.loads((base / "limits" / f"{workload}.json").read_text()))


def metric_names(bench, workload, kind):
    """Names of the `kind` ("end_to_end" or "per_layer") metrics this
    cell reports, in the manifest's order."""
    return [m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic, base=HERE):
    """drivers/<traffic["driver"]>.py under `base` (see drivers/pt.py for
    what a driver exposes)."""
    name = traffic["driver"]
    return _load(base / "drivers" / f"{name}.py", f"port_bench_driver_{name}")


def reader(name, base=HERE):
    """metrics/<name>.py's `read(record)`, under `base`."""
    return _load(base / "metrics" / f"{name}.py",
                 f"port_bench_metric_{name}").read


def read_metrics(bench, names, record, base=HERE):
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    out = {}
    for name in names:
        value = reader(name, base)(record)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def seed32(seed: int) -> int:
    """The renderer takes a 32-bit signed seed."""
    return int(seed) % (2 ** 31)


def sample_pixels(seed, n_pixels, count):
    """`count` distinct flat pixel ids drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels),
                              replace=False))


def compare(prog, ref):
    """The numbers a cell may compare: the share of sampled pixel channels
    that differ from the reference by more than 1e-4 of their value (and
    1e-6 of the film's mean), and the largest difference over the mean of
    the reference's film. A cell's limits file names those it compares."""
    prog, ref = prog.double(), ref.double()
    scale = float(ref.abs().mean()) or 1.0
    diff = (prog - ref).abs()
    off = diff > 1e-4 * ref.abs() + 1e-6 * scale
    if not bool(prog.isfinite().all()):
        return {"mismatch_share": 1.0, "max_gap": float("inf")}
    return {"mismatch_share": float(off.double().mean()),
            "max_gap": float(diff.max()) / scale}


def reference_pixels(drv, config, limits, seed, device):
    """(reference scene, the sampled flat pixel ids on `device`)."""
    import torch
    sc = drv.reference_scene(ROOT / config["scene"], config["overrides"])
    return sc, torch.as_tensor(
        sample_pixels(seed, sc.w * sc.h, limits["sample_pixels"]),
        device=device)


def check(drv, film, config, limits, seed, passes, device):
    """(correct, {name: {"value", "limit"}}): the film after `passes`
    passes against the reference's, on the sampled pixels."""
    sc, pix = reference_pixels(drv, config, limits, seed, device)
    prog = film.reshape(-1, 3)[pix].float()
    ref = drv.reference(sc, seed32(seed), passes, pix)
    out = {k: {"value": v, "limit": limits[k]}
           for k, v in compare(prog, ref).items() if k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out


def device_info(torch, chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(workload, seed, seconds, trace, t_start, device="cuda",
        bench=None, base=HERE, renderer_hook=None):
    """One run; returns the result dict (printed by run.py). device="cpu",
    a `bench` dict and a `base` directory of data files serve the CPU
    tests; renderer_hook(renderer) may replace the renderer the window
    drives (the planted faults)."""
    bench = bench or manifest()
    w, config, traffic, limits = cell(bench, workload, base)
    drv = driver(traffic, base)
    build = ROOT / "build" / "port_bench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < w["chips"]:
            raise Refused(f"{workload} needs {w['chips']} CUDA card(s)")
        torch.cuda.set_device(0)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from adapt_tpu_torch.scene.compile import load_scene
    t0 = time.perf_counter()
    assets.ensure(ROOT, config["assets"])
    scene_path = ROOT / config["scene"]
    scene, cfg, _ = load_scene(str(scene_path.parent), scene_path.name,
                               device=device)
    cfg = dataclasses.replace(cfg, **config["overrides"])
    scene_load_s = time.perf_counter() - t0
    r = drv.make(scene, cfg, seed32(seed), traffic)
    if renderer_hook is not None:
        r = renderer_hook(r)
    for _ in range(traffic["warmup_passes"]):
        drv.step(r)
    sync()
    record = {"setup_s": time.perf_counter() - t_start,
              "scene_load_s": scene_load_s, "n_pixels": cfg.n_pixels,
              "spp_per_pass": traffic["spp_per_pass"]}

    traced = None
    if trace:
        from . import trace as tr
        traced = tr.traced_passes(drv, r, traffic["traced_passes"], sync)
    times = []
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        drv.step(r)
        sync()
        b = time.perf_counter()
        times.append(b - a)
        if b - w0 >= seconds:
            break
    record.update(pass_s=times, window_s=b - w0, trace=traced)
    passes = traffic["warmup_passes"] + len(times) \
        + (traffic["traced_passes"] if trace else 0)
    info = device_info(torch, w["chips"]) if device == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": 1,
         "memory_peak_bytes": 0}
    if traced is not None:
        info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])

    film = drv.film(r).detach().clone()
    del r, scene
    if device == "cuda":
        torch.cuda.empty_cache()
    correct, numbers = check(drv, film, config, limits, seed, passes,
                             film.device)
    kind = "per_layer" if trace else "end_to_end"
    result = {"correct": correct, "attempted": len(times), "failed": 0,
              "metrics": read_metrics(bench, metric_names(bench, workload,
                                                          kind), record,
                                      base),
              "device": info}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"][:10],
                               "idle_gaps": traced["idle_gaps"][:10]}
    result["checks"] = numbers
    # last, so that whatever the check or a reader loaded counts too
    bad = forbidden_modules()
    if bad:
        raise Refused(f"loaded forbidden modules: {', '.join(bad)}")
    return result
