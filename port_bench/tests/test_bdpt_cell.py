"""The trans-bdpt cell at a tiny size on the CPU (the program on its
kernels' plain twins): a sound run is correct; the bfloat16 control and
three planted faults (every time one bin late, the s = 1 strategies
dropped, MIS off) are not; the two readers of the cell's per-layer metrics
on synthetic records; and the driver's contract."""
import dataclasses
import json
import re
import shutil
import time

import pytest
import torch

from port_bench import control, harness

from .test_manifest import DRIVER

CELL = "trans-bdpt"


def tiny_trans_bench(tmp):
    """(bench, base): BENCHMARK.json with the trans-cbox-point scene at
    16x16, 3 bounces and 8 bins of 4.0 beside a copy of its meshes, and a
    data directory copied from port_bench's, 2,048 entries compared."""
    src = harness.HERE / "scenes"
    shutil.copytree(src / "meshes", tmp / "meshes")
    (tmp / "trans").mkdir()
    xml = (src / "trans" / "cbox-point.xml").read_text()
    for name, value in (("width", 16), ("height", 16), ("max_bounce", 3),
                        ("sample_count", 8), ("interval", "4.0")):
        xml = re.sub(rf'name="{name}" value="[^"]*"',
                     f'name="{name}" value="{value}"', xml)
    (tmp / "trans" / "cbox-point.xml").write_text(xml)
    base = tmp / "data"
    for sub in ("traffic", "drivers", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, base / sub)
    limits = json.loads((base / "limits" / f"{CELL}.json").read_text())
    limits["sample_pixels"] = 2048
    (base / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = harness.manifest()
    conf = json.loads((harness.ROOT / "port_bench/configs/"
                       "trans-cbox-point.json").read_text())
    conf["scene"] = str(tmp / "trans" / "cbox-point.xml")
    (base / "configs").mkdir()
    (base / "configs" / "trans-cbox-point.json").write_text(json.dumps(conf))
    for c in bench["configs"]:
        c["file"] = str(base / "configs" / f"{c['name']}.json")
    return bench, base


def _run(tmp_path, hook=None):
    bench, base = tiny_trans_bench(tmp_path)
    return harness.run(CELL, 2 ** 33 + 7, 0.3, 0, time.perf_counter(),
                       device="cpu", bench=bench, base=base,
                       renderer_hook=hook)


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"], res["checks"]
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}


def test_the_control_fails(tmp_path):
    bench, base = tiny_trans_bench(tmp_path)
    got, limits = control.numbers(CELL, 77, 3, "cpu", bench, base)
    assert any(got[k] > limits[k] for k in got), got


def test_every_time_one_bin_late_fails(tmp_path, monkeypatch):
    from adapt_tpu_torch.renderer import bdpt
    inner = bdpt.bin_transient

    def late(cfg, bins, cnts, case, radiance, raster, p_time, *rest):
        return inner(cfg, bins, cnts, case, radiance, raster,
                     p_time + cfg.t_interval, *rest)
    monkeypatch.setattr(bdpt, "bin_transient", late)
    res = _run(tmp_path)
    assert not res["correct"], res["checks"]


def test_the_s1_strategies_dropped_fails(tmp_path, monkeypatch):
    from adapt_tpu_torch.renderer import bdpt
    inner = bdpt.connect_strategy

    def no_s1(*args, case=None, **kw):
        radiance, raster, p_time, warp = inner(*args, case=case, **kw)
        if case == "s1":
            radiance = torch.zeros_like(radiance)
        return radiance, raster, p_time, warp
    monkeypatch.setattr(bdpt, "connect_strategy", no_s1)
    res = _run(tmp_path)
    assert not res["correct"], res["checks"]


def test_mis_off_fails(tmp_path):
    def no_mis(r):
        r.cfg = dataclasses.replace(r.cfg, use_mis=False)
        return r
    res = _run(tmp_path, no_mis)
    assert not res["correct"], res["checks"]


def _span(i, name, parent, a, b):
    return {"id": i, "name": name, "parent": parent, "start_ns": a,
            "end_ns": b, "attrs": {}, "pass": 1}


def test_the_readers_arithmetic(monkeypatch):
    from port_bench import program_trace
    connect = harness.reader("connect_device_ms_per_spp")
    binning = harness.reader("transient_bin_host_ms_per_spp")
    layer = {"connect": {"calls": 60, "host_ms": 900.0, "device_ms": 300.0}}
    rec = {"trace": {"passes": 2, "layer": layer}, "spp_per_pass": 1}
    assert connect(rec) == pytest.approx(150.0)
    assert connect({"trace": {"passes": 2, "layer": {}},
                    "spp_per_pass": 1}) is None
    assert connect({"trace": None, "spp_per_pass": 1}) is None
    # two passes; the inner bdpt.bin (a nested call) counts once, inside
    # its outer one
    spans = [_span(1, "render.pass", 0, 0, 10_000_000),
             _span(2, "bdpt.bin", 1, 1_000_000, 4_000_000),
             _span(3, "bdpt.bin", 2, 2_000_000, 3_000_000),
             _span(4, "render.pass", 0, 20_000_000, 30_000_000),
             _span(5, "bdpt.bin", 4, 21_000_000, 22_000_000),
             _span(6, "bdpt.binx", 4, 23_000_000, 29_000_000)]
    monkeypatch.setattr(program_trace, "export", lambda rec: {
        "spans": spans, "samples": 2})
    assert binning({"trace": {"passes": 2}}) == pytest.approx(
        (3.0 + 1.0 + 6.0) / 2)
    monkeypatch.setattr(program_trace, "export", lambda rec: {
        "spans": spans[:1] + spans[3:4], "samples": 2})
    assert binning({"trace": {"passes": 2}}) is None
    monkeypatch.setattr(program_trace, "export", lambda rec: None)
    assert binning({"trace": {"passes": 2}}) is None


def test_the_driver_keeps_the_contract():
    bench = harness.manifest()
    _w, conf, traffic, limits = harness.cell(bench, CELL)
    drv = harness.driver(traffic)
    assert all(callable(getattr(drv, f)) for f in DRIVER)
    assert conf["overrides"] == {} and conf["reduced"] == {}
    names = {name for *_, name in drv.ranges()}
    assert {"eye walk", "light walk", "rng.uniform", "connect",
            "transient bin", "B1 wrapper", "B3 wrapper",
            "B4 wrapper"} <= names
    assert all(hasattr(m, a) for m, a, _ in drv.ranges())
    sc = drv.reference_scene(harness.ROOT / conf["scene"], conf["overrides"])
    st = sc.scene.settings
    assert (sc.scene.w, sc.scene.h, st["max_bounce"],
            st["num_shadow_ray"]) == (512, 512, 12, 1)
    assert (sc.bins, sc.t_min, sc.interval) == (400, 8.0, 0.1)
    assert sc.w * sc.h == 512 * 512 * 400
    assert limits["sample_pixels"] <= sc.w * sc.h
