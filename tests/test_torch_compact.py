"""Length-compaction of the port's PT bounce loop, and auto-compaction.

* `derive_schedule` / `parse_schedule` equal the JAX package's on the
  profiles of tests/test_pt_compact.py.
* A compacted pass equals the plain one exactly (the per-lane draws are
  keyed by original lane id), the overflow branch included.
* The auto-compaction Renderer equals the plain one, and its probe's
  alive counts equal JAX `probe_alive_pt`'s.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer import compact as jcompact
from adapt_tpu.renderer import pt as jpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.convert import key_from_numpy
from adapt_tpu_torch.renderer import compact, pt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR

KNOT = [0.929, 0.708, 0.582, 0.488, 0.314, 0.234,
        0.169, 0.122, 0.086, 0.029, 0.008, 0.006]
ORB = [0.971, 0.173, 0.095, 0.038, 0.018, 0.007, 0.005, 0.002,
       0.001] + [0.001] * 15


@pytest.mark.parametrize("profile,iters", [
    (KNOT, 12), (ORB, 24), ([0.9] * 8, 8), ([0.2, 0.1], 2),
    (np.linspace(1.0, 0.0, 16), 16)])
def test_derive_schedule_equals_jax(profile, iters):
    got = compact.derive_schedule(profile, iters)
    assert got == jcompact.derive_schedule(profile, iters)
    for at, div in got:
        assert profile[at - 1] * div <= 0.7


def test_parse_schedule_equals_jax():
    for s in ("", "8:4,14:16", " 5:2 , 9:8,", "3:2"):
        assert compact.parse_schedule(s) == jcompact.parse_schedule(s)


def _cbox(w, **kw):
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return scene, dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                                      end_x=w, end_y=w, **kw)


@pytest.mark.parametrize("schedule", [((3, 2),), ((2, 2), (5, 4), (7, 16))])
def test_compaction_exact(schedule):
    scene, cfg = _cbox(32, max_bounce=8, rr_bounce_th=1, rr_threshold=0.6)
    base = pt.render_pass_pt(scene, cfg, rng.PRNGKey(3), 1, schedule=())
    comp = pt.render_pass_pt(scene, cfg, rng.PRNGKey(3), 1,
                             schedule=schedule)
    assert torch.equal(comp, base)
    assert base.mean() > 0.01


def test_compaction_overflow_branch_exact(monkeypatch):
    """Without roulette nearly every lane lives past bounce 2, so the
    split to 1/32 of the width overflows and the pass stays wide: its
    lanes take the JAX package's order (alive first) at the full width,
    and the second split is dropped."""
    scene, cfg = _cbox(16, max_bounce=5, use_rr=False)
    widths = []
    take = compact.take

    def spy(x, idx):
        if isinstance(x, dict) and "pos" in x:   # the loop state
            widths.append(idx.shape[0])
        return take(x, idx)
    monkeypatch.setattr(compact, "take", spy)
    base = pt.render_pass_pt(scene, cfg, rng.PRNGKey(3), 1, schedule=())
    comp = pt.render_pass_pt(scene, cfg, rng.PRNGKey(3), 1,
                             schedule=((2, 32), (3, 64)))
    assert widths == [16 * 16]                 # reordered, never narrowed
    assert torch.equal(comp, base)
    narrow = pt.render_pass_pt(scene, cfg, rng.PRNGKey(3), 1,
                               schedule=((4, 2),))
    assert widths == [16 * 16, 16 * 16 // 2]
    assert torch.equal(narrow, base)


def test_probe_alive_equals_jax():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    kw = dict(w=32, h=32, focal=cfg.focal * 32 / 512, end_x=32, end_y=32,
              max_bounce=6)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 0x5EED)
    jrad, jcounts = jpt.probe_alive_pt(jscene, dataclasses.replace(jcfg, **kw),
                                       jkey, jnp.int32(1))
    rad, counts = pt.probe_alive_pt(scene, dataclasses.replace(cfg, **kw),
                                    key_from_numpy(jax.random.key_data(jkey)),
                                    1)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert (counts[1:] <= counts[:-1]).all() and 0 < counts[0] <= 32 * 32
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), atol=5e-2)


def test_auto_compaction_renderer_exact(monkeypatch):
    """A Renderer over the auto-compaction gate derives a schedule from
    its probe and accumulates the same image as one under the gate."""
    scene, cfg = _cbox(32, max_bounce=8, rr_bounce_th=1, rr_threshold=0.6)
    monkeypatch.setattr(pt, "_AUTO_MIN_PRIMS", 1)
    auto = pt.Renderer(scene, cfg, seed=2)
    assert auto._auto
    auto.render()
    auto.render_batch(2)
    assert auto._sched                          # a real schedule ran
    monkeypatch.setattr(pt, "_AUTO_MIN_PRIMS", 10 ** 9)
    plain = pt.Renderer(scene, cfg, seed=2)
    assert not plain._auto
    plain.render()
    plain.render_batch(2)
    assert plain._schedule() == ()
    assert torch.equal(auto.color, plain.color)
    assert auto.cnt == plain.cnt == 3
