"""The port's tracing (adapt_tpu_torch/obs.py) on the CPU: nothing is
recorded while it is off, a recorded pass has the spans and counters the
renderer's work implies, recording leaves every film bit-equal, spans sit
on the profiler's clock, and no span takes the name of a range the
benchmark sets."""
import dataclasses
import gc
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from adapt_tpu_torch import obs, rng
from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.renderer import bdpt, pt, vpt
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR

ROOT = Path(__file__).resolve().parents[1]


def _small(cfg, w=24, h=20, **kw):
    return dataclasses.replace(cfg, w=w, h=h, end_x=w, end_y=h,
                               focal=cfg.focal * h / 512, **kw)


@pytest.fixture(scope="module")
def cbox():
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return scene, _small(cfg, max_bounce=8)


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _kids(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_off_records_nothing(cbox):
    scene, cfg = cbox
    assert obs.span("pt.bounce", b=0) is obs.OFF
    pt.Renderer(scene, cfg, seed=5).render()
    out = obs.export()
    assert out["spans"] == [] and out["dropped"] == 0
    c = out["counters"]
    assert (c["rng.words"], c["lanes.issued"], c["lanes.live"],
            c["compact.splits"], c["compact.overflows"]) == (0, 0, 0, 0, 0)
    assert c["host.reads"] == {} and c["host.read_wait_ns"] == {}
    assert set(c["launches"]) == {"intersect_kernels", "bvh_kernels",
                                  "splat", "cluster_kernels", "rng",
                                  "shade_kernels"}


def test_a_recorded_pass(cbox):
    scene, cfg = cbox
    r = pt.Renderer(scene, cfg, seed=5)
    key = r.key
    with obs.recording():
        r.render()
    out = obs.export()
    spans = out["spans"]
    passes = [s for s in spans if s["name"] == obs.PASS]
    assert len(passes) == 1 and passes[0]["parent"] == 0
    assert passes[0]["attrs"] == {"cnt": 1, "spp": 1}
    bounces = [s for s in spans if s["name"] == "pt.bounce"]
    assert [b["attrs"]["b"] for b in bounces] == list(range(8))
    assert all(b["parent"] == passes[0]["id"] for b in bounces)
    assert {s["pass"] for s in spans} == {1}
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    # every child lies inside its parent
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        p = by_id.get(s["parent"])
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    assert {k["name"] for k in _kids(spans, bounces[1])} \
        >= {"rng.draw", "shade.sample", "light.sample", "isect.any",
            "isect.closest"}

    # the draws: N x D uniforms a bounce, and the camera's N x 2
    N = cfg.w * cfg.h
    D = 7 + 4 * max(cfg.num_shadow_ray, 1)
    assert cfg.anti_alias
    c = out["counters"]
    assert c["rng.words"] == 8 * N * D + 2 * N
    assert c["lanes.issued"] == 8 * N
    # the live lanes: the probe's alive counts of the same pass
    _, sub = rng.split(key)
    k_trace, k_cam = rng.split(sub)
    ray_o, ray_d = camera_rays(scene, cfg, k_cam, 1)
    _, counts = pt.trace_pt(scene, cfg, k_trace, ray_o, ray_d,
                            collect_alive=True)
    assert c["lanes.live"] == int(counts.sum())
    assert 0 < c["lanes.live"] < c["lanes.issued"]


@pytest.fixture(scope="module")
def trans():
    scene, cfg, _ = load_scene(SCENE_DIR + "/trans/", "cbox-point.xml",
                               device="cpu")
    return scene, _small(cfg, max_bounce=3, t_bins=8, t_interval=4.0)


def test_transient_counters(trans):
    """Off, the binning's counters stay 0 and allocate nothing (so launch
    nothing); under recording, a `bdpt.bin` span a group (4 groups of 3
    strategies at 3 bounces, each one chunk), `transient.offered` the
    lanes offered (the spans' `lanes`) and `transient.binned` the entries
    kept: one count each in the pass's histogram of counts."""
    scene, cfg = trans
    bdpt.BDPT(scene, cfg, seed=11).render()
    out = obs.export()
    assert out["spans"] == [] and obs.TRACER.tallies == {}
    c = out["counters"]
    assert (c["transient.offered"], c["transient.binned"]) == (0, 0)
    r = bdpt.BDPT(scene, cfg, seed=11)
    with obs.recording():
        r.render()
    out = obs.export()
    bins = [s for s in out["spans"] if s["name"] == "bdpt.bin"]
    N = cfg.w * cfg.h
    assert [(s["attrs"]["case"], s["attrs"]["lanes"]) for s in bins] \
        == [("s0", 3 * N), ("t1", 3 * N), ("s1", 3 * N), ("gen", 3 * N)]
    c = out["counters"]
    assert c["transient.offered"] == 12 * N
    assert c["transient.binned"] == int(r.time_cnts.sum()) > 0


def _render(make, passes=1):
    r = make()
    for _ in range(passes):
        r.render()
    return r.color.clone()


@pytest.mark.parametrize("kind", ["pt", "vpt", "bdpt"])
def test_films_bit_equal_with_recording(kind):
    if kind == "vpt":
        scene, cfg, _ = load_scene(SCENE_DIR + "/vpt/", "cbox.xml",
                                   device="cpu")
        cfg = _small(cfg, 16, 16, max_bounce=4)
        make = lambda: vpt.VolumeRenderer(scene, cfg, seed=3)  # noqa: E731
    else:
        scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                                   device="cpu")
        cfg = _small(cfg, 16, 16, max_bounce=4)
        cls = pt.Renderer if kind == "pt" else bdpt.BDPT
        make = lambda: cls(scene, cfg, seed=3)  # noqa: E731
    off = _render(make)
    with obs.recording():
        on = _render(make)
    assert torch.equal(off, on)
    names = {s["name"] for s in obs.export()["spans"]}
    assert obs.PASS in names
    assert {"pt": "pt.bounce", "vpt": "vpt.iter",
            "bdpt": "bdpt.eye_walk"}[kind] in names


def test_spans_sit_on_the_profilers_clock(cbox):
    """Each span opens its profiler range inside itself: its start and end
    lie within 100 us of its event's (kineto's trace_start_ns() plus the
    event's time_range), after a first pass has warmed the profiler. The
    gap is the profiler's own cost of opening and closing the range."""
    scene, cfg = cbox
    r = pt.Renderer(scene, dataclasses.replace(cfg, max_bounce=3), seed=5)
    acts = [torch.profiler.ProfilerActivity.CPU]
    gc.disable()                   # a collection inside a span is no skew
    try:
        with torch.profiler.profile(activities=acts) as prof:
            r.render()
            obs.reset()
            r.render()
    finally:
        gc.enable()
    spans = obs.export()["spans"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(
            (t0 + round(e.time_range.start * 1e3),
             t0 + round(e.time_range.end * 1e3)))
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    assert set(by_name) >= {obs.PASS, "pt.bounce", "rng.draw"}
    for name, mine in by_name.items():
        # the last of each name's events are this pass's, in order
        theirs = sorted(events[name])[-len(mine):]
        for s, (a, b) in zip(sorted(mine, key=lambda s: s["start_ns"]),
                             theirs):
            assert abs(s["start_ns"] - a) < 100_000, (name, s, a)
            assert abs(s["end_ns"] - b) < 100_000, (name, s, b)


def _program_span_names():
    """Every span name the program's sources give, and the launch spans
    ops/_build.py opens for each kernel wrapper a module declares."""
    names = set()
    for path in (ROOT / "adapt_tpu_torch").rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(
            r'obs\.(?:span|setup_span|spanned)\(\s*"([^"]+)"', text))
    names.add(obs.PASS)
    names |= {"kernel." + w for lib in _build.libraries.values()
              for w in lib.kernels}
    return names


def test_no_span_is_named_after_a_benchmark_range():
    spec = importlib.util.spec_from_file_location(
        "drivers_pt", ROOT / "port_bench" / "drivers" / "pt.py")
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    ranges = {name for *_, name in drv.ranges()} | {"pass"}
    names = _program_span_names()
    assert {"pt.bounce", "rng.draw", "shade.eval", "setup.lib",
            "kernel.tri_closest_hit", "kernel.bvh_any_hit"} <= names
    assert not names & ranges


def test_the_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(obs.TRACER, "cap", 3)
    with obs.recording():
        for i in range(5):
            with obs.span("render.camera", n=i):
                pass
    out = obs.export()
    assert [s["attrs"]["n"] for s in out["spans"]] == [0, 1, 2]
    assert out["dropped"] == 2
    obs.reset()
    assert obs.export()["dropped"] == 0


def test_host_reads_are_counted_by_site():
    t = torch.arange(4)
    assert obs.host_read(t, "x") is t
    assert obs.export()["counters"]["host.reads"] == {}
    with obs.recording():
        obs.host_read(t, "x")
        obs.host_read(t.sum(), "x")
    c = obs.export()["counters"]
    assert c["host.reads"] == {"x": 2} and c["host.read_wait_ns"]["x"] >= 0


def test_profile_pt_attributes_by_span():
    """profile_pt's arithmetic on spans: self time, and each idle gap on
    the device to the innermost span open at its midpoint."""
    from adapt_tpu_torch import profile_pt

    def sp(i, name, parent, a, b):
        return {"id": i, "name": name, "parent": parent, "start_ns": a,
                "end_ns": b}
    spans = [sp(1, "render.pass", 0, 0, 100), sp(2, "pt.bounce", 1, 10, 60),
             sp(3, "rng.draw", 2, 20, 30), sp(4, "isect.any", 2, 25, 40),
             sp(5, "pt.bounce", 1, 60, 90)]
    assert profile_pt._self_ns(spans) == {1: 20, 2: 30, 3: 10, 4: 15,
                                          5: 30}
    idle = profile_pt._idle_by_span(
        [(21, 23), (50, 56), (60, 62), (95, 99), (110, 120)], spans)
    assert idle == pytest.approx({"rng.draw": 2e-9, "pt.bounce": 8e-9,
                                  "render.pass": 4e-9,
                                  "outside the program's spans": 1e-8})


SEAM_SRC = r"""
extern "C" int twice(int a, int *out, void *stream) {
    *out = 2 * a + (int)(long)stream;
    return a < 0 ? a : 0;
}
extern "C" int info(int which, int *out) { *out = which; return which < 0 ? 5 : 0; }
"""


def test_launch_seam_types_launches_checks_and_counts(tmp_path, monkeypatch):
    """ops/_build.py's launch path, on a stand-in library built with g++
    and a stand-in stream: the entry points typed from the declaration,
    the stream passed last, the `kernel.<wrapper>` span with its `n`, a
    non-zero status raised (through `refused` where it gives an
    exception) and left uncounted, and the count in `launches`, which
    obs.export() reports."""
    for name in ("_LIBS", "launches", "libraries"):
        monkeypatch.setattr(_build, name, {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "seam.cpp"
    src.write_text(SEAM_SRC)
    monkeypatch.setattr(_build, "load", lambda name: _build.compiled(
        name, src, lambda: "g++", ("-shared", "-fPIC")))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: (
        type("Stream", (), {"cuda_stream": 7})))
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int

    def refused(wrapper, err, args):
        return ValueError(f"{wrapper} refused {args[0]}") if err == -2 \
            else None
    lib = _build.Library("pkg.seam_kernels", "seam", {
        "double": ("twice", "twice_kernel", [I, P, P])},
        queries={"info": [I, P]}, refused=refused)
    assert lib.kernel_names == {"double": "twice_kernel"}
    assert _build.launches == {"seam_kernels": {"double": 0}}
    out = ctypes.c_int()
    with obs.recording():
        lib.launch("double", "cuda", 5, 20, ctypes.addressof(out))
    assert out.value == 47 and _build.launches["seam_kernels"]["double"] == 1
    spans = obs.export()["spans"]
    assert [(s["name"], s["attrs"]) for s in spans if
            s["name"].startswith("kernel.")] == [("kernel.double", {"n": 5})]
    assert obs.export()["counters"]["launches"] == {
        "seam_kernels": {"double": 1}}
    with pytest.raises(RuntimeError,
                       match="^double: CUDA launch failed with error -3$"):
        lib.launch("double", "cuda", 1, -3, ctypes.addressof(out))
    with pytest.raises(ValueError, match="^double refused -2$"):
        lib.launch("double", "cuda", 1, -2, ctypes.addressof(out))
    assert _build.launches["seam_kernels"]["double"] == 1
    lib.query("info", "double info", 3, ctypes.addressof(out))
    assert out.value == 3
    with pytest.raises(RuntimeError, match="^double info: CUDA launch"):
        lib.query("info", "double info", -1, ctypes.addressof(out))
    _build.reset_launches()
    assert _build.launches == {"seam_kernels": {"double": 0}}
