"""The port's scene tables equal the JAX package's, leaf for leaf (the
medium tables, pre0/pre1/pre2 and the object AABBs included).

PT renders every scene the JAX package's PT renders, null BSDFs (medium
boundaries) included, against the JAX render; what the parser cannot read
(a Mie medium) refuses at load, and no shipped scene declares one.
"""
import dataclasses
import glob
import xml.etree.ElementTree as xet

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer.pt import Renderer as JaxRenderer, \
    render_pass_pt as jax_render_pass_pt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch.convert import LEAF_NAMES, scene_from_numpy, \
    scene_leaves
from adapt_tpu_torch.renderer.pt import Renderer, render_pass_pt
from adapt_tpu_torch import rng
from adapt_tpu_torch.constants import MediumTag
from adapt_tpu_torch.scene.compile import load_scene
from adapt_tpu_torch.scene.medium import MediumRec

from conftest import SCENE_DIR
from test_torch_pt import _close


def _assert_leaves_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("scene_file", [("cbox", "cbox.xml"),
                                        ("csphere", "single-ball.xml"),
                                        ("vpt", "cbox.xml")])
def test_leaves_and_config_match_jax(scene_file):
    d, f = scene_file
    jscene, jcfg, _ = jax_load_scene(f"{SCENE_DIR}/{d}/", f)
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/{d}/", f, device="cpu")
    fields = dataclasses.asdict(cfg)
    assert fields.pop("big_tier") == "bvh"      # the port's own field
    assert fields == dataclasses.asdict(jcfg)
    jleaves = scene_leaves(jscene)
    assert set(jleaves) == set(LEAF_NAMES)
    _assert_leaves_equal(scene_leaves(scene), jleaves)
    # carried across from the JAX objects
    conv, ccfg = scene_from_numpy(jleaves, dataclasses.asdict(jcfg),
                                   device="cpu")
    assert ccfg == cfg
    _assert_leaves_equal(scene_leaves(conv), jleaves)


def test_cbox_is_the_slice():
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/cbox/", "cbox.xml", device="cpu")
    assert scene.tri_n.shape[0] == 34 and scene.sph_center.shape[0] == 0
    assert scene.obj_start.shape[0] == 7
    assert cfg.brdf_types == (1,) and cfg.emitter_kinds == (0,)
    assert cfg.has_v_normal and not cfg.use_bvh
    assert not cfg.use_pallas and not cfg.use_cluster


@pytest.mark.parametrize("scene_file", [
    ("csphere", "single-ball.xml", {"has_normal_map": True}),   # renders
    ("vpt", "cbox.xml", {}),                 # null BSDFs under PT
    ("cbox", "cbox-volgrid.xml", {})])                          # grid volumes
def test_pt_renders_as_jax(scene_file):
    """PT renders what the JAX package's PT renders, against its render.
    Null BSDFs (vpt/cbox.xml's medium boundaries), which PT refused until
    ROADMAP item 11, pass a ray through as a delta of weight 1
    (ops/bxdf_ops.py). A configuration that declares a normal map, which
    PT refused until textures were ported, renders as the JAX package's
    does (single-ball has no normal texture, so the map's fetch finds none
    and n_s stays); tests/test_torch_texture.py holds real maps. A scene
    with a grid volume, which PT refused until grid volumes were ported,
    renders as the JAX package's PT renders it: without the volume, which
    only VPT and BDPT read."""
    from test_torch_volume import volume_assets
    volume_assets()
    d, f, change = scene_file
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/{d}/", f, device="cpu")
    cfg = dataclasses.replace(cfg, w=8, h=8, end_x=8, end_y=8, **change)
    jscene, jcfg, _ = jax_load_scene(f"{SCENE_DIR}/{d}/", f)
    jcfg = dataclasses.replace(jcfg, w=8, h=8, end_x=8, end_y=8, **change)
    assert cfg.has_null_bsdf == (d == "vpt")
    img = render_pass_pt(scene, cfg, rng.PRNGKey(0), 1)
    ref = jax_render_pass_pt(jscene, jcfg, jax.random.PRNGKey(0),
                             jnp.int32(1))
    _close(img.numpy(), ref)
    assert img.mean() > 0.0
    Renderer(scene, cfg)


def test_pt_renderer_on_null_bsdfs():
    """Renderer.render_batch on vpt/cbox.xml (a null-BSDF box of HG
    medium, which PT crosses without reading the medium) at 16^2, 4
    bounces, RR from bounce 2: the JAX Renderer's stream and image."""
    def cut(c):
        return dataclasses.replace(c, w=16, h=16, focal=c.focal * 16 / 512,
                                   end_x=16, end_y=16, max_bounce=4,
                                   rr_bounce_th=2)
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/vpt/", "cbox.xml",
                               device="cpu")
    jscene, jcfg, _ = jax_load_scene(f"{SCENE_DIR}/vpt/", "cbox.xml")
    assert cfg.has_null_bsdf and cfg.n_null_objs > 0
    r, jr = Renderer(scene, cut(cfg), seed=5), JaxRenderer(jscene, cut(jcfg),
                                                           seed=5)
    r.render_batch(2)
    jr.render_batch(2)
    _close(r.image(), jr.image())
    assert r.cnt == 2 and r.image().mean() > 0.05


def test_shipped_media_are_rendered_kinds():
    """Every <medium> of every shipped scene parses to a kind the
    renderers take (HG, multi-HG, Rayleigh or transparent), so a scene's
    `medium_kinds` never leaves {HG, MULTI_HG, RAYLEIGH}; the one kind
    outside them, Mie, refuses when it parses, as in the JAX package."""
    files = glob.glob(f"{SCENE_DIR}/**/*.xml", recursive=True)
    kinds = {}
    for path in files:
        for elem in xet.parse(path).getroot().iter("medium"):
            kinds[MediumRec(elem).type_id] = path
    assert len(files) >= 30 and MediumTag.HG in kinds
    assert set(kinds) <= {MediumTag.HG, MediumTag.MULTI_HG,
                          MediumTag.RAYLEIGH, MediumTag.TRANSPARENT}, kinds
    with pytest.raises(NotImplementedError, match="mie"):
        MediumRec(xet.fromstring('<medium type="mie"/>'))


def test_pt_takes_single_ball():
    """csphere/single-ball.xml (blinn-phong and specular BRDFs on spheres,
    a sphere area light) renders under PT now."""
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/csphere/", "single-ball.xml",
                               device="cpu")
    cfg = dataclasses.replace(cfg, w=8, h=8, focal=cfg.focal * 8 / 512,
                              end_x=8, end_y=8, max_bounce=3)
    img = render_pass_pt(scene, cfg, rng.PRNGKey(0), 1)
    assert img.shape == (64, 3) and torch.isfinite(img).all()
    assert img.mean() > 0.0
    Renderer(scene, cfg)


def test_scene_to_device_keeps_tables():
    scene, _, _ = load_scene(f"{SCENE_DIR}/cbox/", "cbox.xml", device="cpu")
    moved = scene.to("cpu")
    assert moved is not scene
    _assert_leaves_equal(scene_leaves(moved), scene_leaves(scene))
