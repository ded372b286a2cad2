"""The readers of the program's own spans and counters
(port_bench/program_trace.py and the four metrics on it) on a planted
export, on a real recorded pass, and where they must stay silent."""
import sys

import pytest

from port_bench import harness, program_trace

READERS = ("bounce_self_host_ms_per_spp", "shade_host_ms_per_spp",
           "live_lane_share", "setup_program_s")
MS = 1_000_000                     # ns


def span(i, name, parent, start, end, **attrs):
    return {"name": name, "id": i, "parent": parent, "pass": None,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": attrs}


def planted():
    """Two passes; each bounce of 100 ms has children covering 80 ms of
    it (two overlapping, one with a kernel nested deeper), 40 ms of them
    outermost shading (an eval holding a texture fetch, a light sample);
    set-up outside the passes and one library load inside a kernel."""
    spans = [span(1, "setup.scene", 0, 0, 3000),
             span(2, "setup.scene.parse", 1, 0, 1000),
             span(3, "setup.scene.bvh", 1, 1000, 2500),
             span(4, "setup.lib", 3, 1000, 1200)]
    nid = 5
    for p in range(2):
        base = 10_000 + 1000 * p
        pass_id = nid
        spans.append(span(pass_id, "render.pass", 0, base, base + 500,
                          cnt=p + 1, spp=1))
        b = nid + 1
        spans += [span(b, "pt.bounce", pass_id, base + 100, base + 200),
                  span(b + 1, "rng.draw", b, base + 110, base + 130),
                  span(b + 2, "isect.closest", b, base + 120, base + 150),
                  span(b + 3, "kernel.tri_closest_hit", b + 2, base + 125,
                       base + 140),
                  span(b + 4, "shade.eval", b, base + 170, base + 200),
                  span(b + 5, "shade.texture", b + 4, base + 175,
                       base + 180),
                  span(b + 6, "light.sample", b, base + 160, base + 170),
                  span(b + 7, "pt.compact", pass_id, base + 200,
                       base + 210)]
        nid = b + 8
    spans.append(span(nid, "setup.lib", spans[-5]["id"], 11_125, 11_126))
    return {"clock": {}, "spans": spans, "dropped": 0,
            "counters": {"lanes.issued": 1000, "lanes.live": 460}}


def rec(passes=2, spp=1):
    return {"trace": {"passes": passes}, "spp_per_pass": spp}


@pytest.fixture
def plant(monkeypatch):
    from adapt_tpu_torch import obs
    monkeypatch.setattr(obs, "export", planted)


def read(name, r):
    return harness.reader(name)(r)


def test_readers_on_a_planted_export(plant):
    # each bounce: 100 ms less the children's union [110, 150] and
    # [160, 200] (the kernel inside isect.closest adds nothing): 20 ms
    assert read("bounce_self_host_ms_per_spp", rec()) == pytest.approx(
        20.0)
    # outermost shading: the eval (30 ms, its texture inside) and the
    # light sample (10 ms) a bounce
    assert read("shade_host_ms_per_spp", rec()) == pytest.approx(40.0)
    assert read("live_lane_share", rec()) == pytest.approx(46.0)
    # set-up: the scene (3 s, its parse, BVH and library inside) and the
    # library loaded inside a kernel's span (1 ms)
    assert read("setup_program_s", rec()) == pytest.approx(3.001)
    # two samples a pass halve the per-sample readings
    assert read("bounce_self_host_ms_per_spp", rec(spp=2)) \
        == pytest.approx(10.0)


def test_self_time_clips_children_to_the_span():
    spans = [span(1, "pt.bounce", 0, 0, 10),
             span(2, "rng.draw", 1, -5, 2),
             span(3, "isect.any", 1, 8, 30)]
    assert program_trace.self_ns(spans, ("pt.bounce",)) == 6 * MS


def test_readers_are_silent_when_the_passes_disagree(plant):
    for name in READERS:
        assert read(name, rec(passes=3)) is None
        assert read(name, {"trace": None, "spp_per_pass": 1}) is None


def test_readers_are_silent_without_the_module(monkeypatch):
    import adapt_tpu_torch
    monkeypatch.delattr(adapt_tpu_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "adapt_tpu_torch.obs", None)
    for name in READERS:
        assert read(name, rec()) is None


def test_readers_on_a_recorded_pass(tmp_path):
    """Two tiny cbox passes recorded by the program itself: every reader
    gives a number, the shares and times in their ranges."""
    from adapt_tpu_torch import obs
    from adapt_tpu_torch.renderer import pt
    from adapt_tpu_torch.scene.compile import load_scene

    from .common import tiny_scene
    obs.reset()
    try:
        xml = tiny_scene(tmp_path)
        scene, cfg, _ = load_scene(str(xml.parent), xml.name, device="cpu")
        r = pt.Renderer(scene, cfg, seed=9)
        with obs.recording():
            r.render()
            r.render()
        got = {n: read(n, rec()) for n in READERS}
    finally:
        obs.reset()
    assert 0 < got["live_lane_share"] < 100
    assert got["bounce_self_host_ms_per_spp"] > 0
    assert got["shade_host_ms_per_spp"] > 0
    assert got["setup_program_s"] > 0
