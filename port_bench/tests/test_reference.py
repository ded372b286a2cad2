"""The reference against the program at a tiny size on the CPU (the
program on its kernels' plain twins), the control, and the planted
faults: each has to make `correct` false."""
import dataclasses
import time

import pytest
import torch

from port_bench import control, harness
from port_bench.reference import pt as ref_pt
from port_bench.reference import scene as ref_scene

from .common import tiny_bench, tiny_scene


@pytest.mark.parametrize("name, bounces, passes", [
    ("cbox.xml", 8, 4),        # the brute-force tier
    ("bunny.xml", 6, 2),       # textures, glass, Fresnel blend, spot lights
    ("bunny.xml", 10, 1),      # the same at the cell's 10 bounces
])
def test_reference_film_equals_the_program_film(tmp_path, name, bounces,
                                                passes):
    from adapt_tpu_torch.renderer.pt import Renderer
    from adapt_tpu_torch.scene.compile import load_scene
    xml = tiny_scene(tmp_path, name)
    scene, cfg, _ = load_scene(str(xml.parent), xml.name, device="cpu")
    cfg = dataclasses.replace(cfg, max_bounce=bounces)
    seed = harness.seed32(2 ** 31 + 987654321)
    r = Renderer(scene, cfg, seed=seed)
    for _ in range(passes):
        r.render()
    pix = torch.arange(cfg.n_pixels)
    sc = ref_scene.load(str(xml), {"max_bounce": bounces})
    assert ref_pt.walks_a_tree(sc.prims.shape[0]) == cfg.use_bvh
    ref = ref_pt.film(sc, seed, passes, pix, lanes=256)
    assert ref.abs().mean() > 0.1
    assert torch.equal(r.color.reshape(-1, 3), ref)


def test_the_reference_refuses_what_it_cannot_render(tmp_path):
    xml = tiny_scene(tmp_path)
    text = xml.read_text().replace('type="point"', 'type="area"')
    xml.write_text(text)
    try:
        ref_scene.load(str(xml), {})
    except NotImplementedError as err:
        assert "area" in str(err)
    else:
        raise AssertionError("an area light was accepted")


def test_the_control_fails(tmp_path):
    bench, base = tiny_bench(tmp_path)
    got, limits = control.numbers("cbox-pt", 77, 3, "cpu", bench, base)
    assert any(got[k] > limits[k] for k in got), got


def _run(tmp_path, hook):
    bench, base = tiny_bench(tmp_path)
    return harness.run("cbox-pt", 2 ** 33 + 1, 0.3, 0, time.perf_counter(),
                       device="cpu", bench=bench, base=base,
                       renderer_hook=hook)


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path, None)
    assert res["correct"], res["checks"]


def test_a_pass_that_leaves_the_film_unchanged_fails(tmp_path):
    def hook(r):
        def unchanged(*_args):
            time.sleep(0.02)       # a pass's time, without its work
            return r.color
        r.render = unchanged
        return r
    assert not _run(tmp_path, hook)["correct"]


def test_half_the_pixels_left_out_fails(tmp_path):
    def hook(r):
        inner = r.render_pass

        def half(key, cnt):
            out = inner(key, cnt).clone()
            out[1::2] = 0.0
            return out
        r.render_pass = half
        return r
    assert not _run(tmp_path, hook)["correct"]


def test_an_answer_altered_where_it_is_made_fails(tmp_path):
    def hook(r):
        inner = r.render_pass

        def altered(key, cnt):
            out = inner(key, cnt).clone()
            out[:, 0] *= 1.001
            return out
        r.render_pass = altered
        return r
    res = _run(tmp_path, hook)
    assert not res["correct"], res["checks"]
