"""The port's spot and collimated lights against the JAX package, the
volumetric tracer on vpt/balls.xml, and the gate of the PT and VPT slice.

* Op level: `sample_hit`, `sample_le` and `direction_pdf` on one emitter
  table of all four kinds (balls-multi's sphere area light beside a
  point, a spot and a collimated light), at lanes inside and outside the
  spot's cone and in front of, beside and behind the collimated beam's
  origin (the reference's quirk keeps full intensity behind it). Flags
  (in cone, lit) are equal; floats within rtol 1e-5, atol 1e-6.
* Whole slice: `render_pass_vpt` on vpt/balls.xml (a spot light, an HG
  medium) at 48^2, 6 bounces, pass 1, key 42, against the JAX render and
  `vptballs_48.npy` under tests/test_goldens.py `_check` (the JAX render
  meets the golden too); a PT pass of trans/cbox-collimated.xml against
  the JAX render, with MIS and without (with MIS the JAX package weighs a
  collimated light of nonzero radius by 0: its sample_hit pdf is 0 and it
  is not a delta position, so only a MIS-free pass shows its light).
* The gate: PT, VPT and BDPT take all eight csphere scenes,
  vpt/balls.xml and trans/cbox-collimated.xml (BDPT on balls-multi is
  held to the JAX package in tests/test_torch_mixture.py).
"""
import contextlib
import dataclasses
import importlib.util
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.constants import EmitterTag
from adapt_tpu.ops import emitter_ops as jem
from adapt_tpu.renderer import pt as jpt, vpt as jvpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.ops import emitter_ops as tem
from adapt_tpu_torch.renderer import bdpt, pt, vpt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_torch_pt import _close

N = 4096
RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.join(os.path.dirname(__file__), "..")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _near(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _f32(x):
    return np.asarray(x, np.float32)


# the four lights: a point, balls-multi's own sphere area light, a spot
# aimed down and a collimated beam along +z of radius 0.5
_SPOT_COS = np.cos(np.deg2rad(30.0))
_COLL_O = (2.78, 2.0, 1.0)


def _emitters(scene_e):
    """Emitter table rows (numpy) of the four lights; scene_e: the
    scene's own (area) emitter row 0."""
    inten = _f32([[6.0, 5.0, 4.0], scene_e["intensity"], [50.0, 40.0, 30.0],
                  [8.0, 8.0, 8.0]])
    return dict(
        emit_kind=np.int32([EmitterTag.POINT, EmitterTag.AREA,
                            EmitterTag.SPOT, EmitterTag.COLLIMATED]),
        emit_intensity=inten,
        emit_pos=_f32([[2.78, 5.0, 2.8], scene_e["pos"], [2.78, 5.4, 2.8],
                       _COLL_O]),
        emit_dir=_f32([[0, 1, 0], scene_e["dir"], [0, -1, 0], [0, 0, 1]]),
        emit_inv_area=_f32([1.0, scene_e["inv_area"], 1.0,
                            1.0 / (np.pi * 0.25)]),
        emit_r=_f32([0.0, 0.0, _SPOT_COS, 0.5]),
        emit_bits=np.int32([1, scene_e["bits"], 1, 2]),
        emit_obj=np.int32([-1, scene_e["obj"], -1, -1]),
        emit_time=_f32([0, 0, 0, 0]))


@pytest.fixture(scope="module")
def four_lights():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                     "balls-multi.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "balls-multi.xml",
                               device="cpu")
    own = dict(intensity=scene.emit_intensity[0].numpy(),
               pos=scene.emit_pos[0].numpy(), dir=scene.emit_dir[0].numpy(),
               inv_area=scene.emit_inv_area[0].item(),
               bits=scene.emit_bits[0].item(), obj=scene.emit_obj[0].item())
    rows = _emitters(own)
    kw = dict(emitter_kinds=(0, 1, 2, 4), n_emitters=4)
    jscene = dataclasses.replace(
        jscene, **{k: jnp.asarray(v) for k, v in rows.items()})
    scene = dataclasses.replace(scene, **{k: _t(v) for k, v in rows.items()})
    return (jscene, dataclasses.replace(jcfg, **kw), scene,
            dataclasses.replace(cfg, **kw))


def _hit_points(g, n):
    """Points in the box; a third around the spot's cone edge, a third
    around the collimated beam, in front of and behind its origin."""
    p = g.uniform([0.0, 0.0, -1.0], [5.5, 5.5, 5.5], (n, 3))
    k = n // 3
    ang = np.deg2rad(g.uniform(20.0, 40.0, k))        # across the cone
    phi = g.uniform(0, 2 * np.pi, k)
    dist = g.uniform(0.5, 5.0, k)
    p[:k] = np.array([2.78, 5.4, 2.8]) + dist[:, None] * np.stack(
        [np.sin(ang) * np.cos(phi), -np.cos(ang), np.sin(ang) * np.sin(phi)],
        1)
    rad = g.uniform(0.0, 1.0, k)                      # across the radius
    p[k:2 * k] = np.array(_COLL_O) + np.stack(
        [rad * np.cos(phi), rad * np.sin(phi), g.uniform(-3.0, 4.0, k)], 1)
    return _f32(p)


def test_sample_hit_all_kinds(four_lights):
    jscene, jcfg, scene, cfg = four_lights
    g = np.random.default_rng(0)
    p = _hit_points(g, N)
    u = _f32(g.uniform(size=(N, 3)))
    for eid in (np.full(N, 2, np.int32), np.full(N, 3, np.int32),
                g.integers(0, 4, N).astype(np.int32)):
        got = tem.sample_hit(scene, cfg, _t(eid), _t(p), _t(u))
        want = jem.sample_hit(jscene, jcfg, jnp.asarray(eid), jnp.asarray(p),
                              jnp.asarray(u))
        for a, b in zip(got, want):
            _near(a, b)
    # the spot, eid 2: lit inside the cone only, falling off with d^2
    got = tem.sample_hit(scene, cfg, _t(np.full(N, 2, np.int32)), _t(p),
                         _t(u))
    to = p - _f32([2.78, 5.4, 2.8])
    cos = -to[:, 1] / np.linalg.norm(to, axis=1)
    lit = got[1].amax(dim=-1).numpy() > 0
    clear = np.abs(cos - _SPOT_COS) > 1e-4
    np.testing.assert_array_equal(lit[clear], (cos > _SPOT_COS)[clear])
    assert lit.any() and not lit.all()


def test_collimated_quirk_behind_origin(four_lights):
    """Behind the beam's origin the reference keeps full intensity toward
    the emitter's position; in front of it, within the radius, the sample
    is the point's projection onto the origin plane."""
    jscene, jcfg, scene, cfg = four_lights
    g = np.random.default_rng(1)
    p = _hit_points(g, N)
    u = _f32(g.uniform(size=(N, 3)))
    eid = np.full(N, 3, np.int32)
    pos, inten, pdf, normal = tem.sample_hit(scene, cfg, _t(eid), _t(p),
                                             _t(u))
    proj = p[:, 2] - _COLL_O[2]
    off = np.hypot(p[:, 0] - _COLL_O[0], p[:, 1] - _COLL_O[1])
    behind = proj <= 0.0
    inside = ~behind & (off < 0.5)
    lit = inten.amax(dim=-1).numpy() > 0
    assert behind.sum() > 100 and inside.sum() > 100
    assert lit[behind].all() and lit[inside].all()
    assert not lit[~behind & (off > 0.5 + 1e-4)].any()
    np.testing.assert_array_equal(pos.numpy()[behind],
                                  np.broadcast_to(_f32(_COLL_O),
                                                  (behind.sum(), 3)))
    np.testing.assert_allclose(pos.numpy()[inside][:, 2], _COLL_O[2],
                               atol=1e-5)
    assert (pdf == 0).all()
    _near(normal, jem.sample_hit(jscene, jcfg, jnp.asarray(eid),
                                 jnp.asarray(p), jnp.asarray(u))[3])


def test_sample_le_and_direction_pdf(four_lights):
    jscene, jcfg, scene, cfg = four_lights
    g = np.random.default_rng(2)
    eid = g.integers(0, 4, N).astype(np.int32)
    u = _f32(g.uniform(size=(N, 5)))
    u[:8, :2] = 0.5                          # the disk's centre lanes
    got = tem.sample_le(scene, cfg, _t(eid), _t(u))
    want = jem.sample_le(jscene, jcfg, jnp.asarray(eid), jnp.asarray(u))
    for a, b in zip(got, want):
        _near(a, b)
    ray_o, ray_d, _pp, _pd, normal = got
    spot = eid == 2
    cos = -ray_d.numpy()[spot, 1]
    assert (cos >= _SPOT_COS - 1e-6).all()            # inside the cone
    coll = eid == 3
    np.testing.assert_allclose(ray_o.numpy()[coll][:, 2], _COLL_O[2],
                               atol=1e-6)             # on the origin disk
    off = np.hypot(ray_o.numpy()[coll][:, 0] - _COLL_O[0],
                   ray_o.numpy()[coll][:, 1] - _COLL_O[1])
    assert (off <= 0.5 + 1e-6).all()
    d = torch.nn.functional.normalize(_t(_f32(g.normal(size=(N, 3)))),
                                      dim=-1)
    _near(tem.direction_pdf(scene, cfg, _t(eid), d, normal),
          jem.direction_pdf(jscene, jcfg, jnp.asarray(eid),
                            jnp.asarray(d.numpy()),
                            jnp.asarray(normal.numpy())))


# ------------------------------ whole slice ------------------------------

def test_vpt_balls_pass_matches_jax_and_golden():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/vpt/", "balls.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/vpt/", "balls.xml",
                               device="cpu")
    assert cfg.emitter_kinds == (EmitterTag.SPOT,) and cfg.medium_kinds
    img = vpt.render_pass_vpt(scene, _small(cfg, mb=6), rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), "vptballs_48.npy")
    ref = jvpt.render_pass_vpt(jscene, _small(jcfg, mb=6),
                               jax.random.PRNGKey(42), jnp.int32(1))
    _check(ref, "vptballs_48.npy")    # the golden is the JAX package's
    _close(img.numpy(), ref)
    assert img.mean() > 0.05


@pytest.mark.parametrize("mis,w", [(True, 48), (False, 48), (False, 47)],
                         ids=["mis", "no_mis", "no_mis_centre"])
def test_collimated_pt_pass_matches_jax(mis, w):
    """The beam (radius 0.05) starts beside the camera and lights a spot
    on the back wall narrower than a 48^2 pixel, between the centre
    pixels' rays: at 48^2 the pass is black in both packages, with MIS
    and without. An odd width puts the centre pixel's ray on the beam's
    axis: without MIS that pixel is lit."""
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/trans/",
                                     "cbox-collimated.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/trans/", "cbox-collimated.xml",
                               device="cpu")
    assert cfg.emitter_kinds == (EmitterTag.COLLIMATED,)
    img = pt.render_pass_pt(scene, dataclasses.replace(_small(cfg, w=w, mb=6),
                                                       use_mis=mis),
                            rng.PRNGKey(42), 1)
    ref = jpt.render_pass_pt(jscene,
                             dataclasses.replace(_small(jcfg, w=w, mb=6),
                                                 use_mis=mis),
                             jax.random.PRNGKey(42), jnp.int32(1))
    _close(img.numpy(), ref)
    lit = (img.amax(dim=-1) > 0).sum().item()
    assert lit == (1 if w % 2 and not mis else 0)


# ------------------------- every renderer takes it -------------------------

_OPEN = [("csphere", f) for f in (
    "balls-glossy.xml", "balls-mono.xml", "balls-multi-showcase.xml",
    "balls-multi.xml", "big.xml", "mix-balls.xml", "single-ball.xml",
    "whiskey.xml")] + [("vpt", "balls.xml"), ("trans", "cbox-collimated.xml")]


def _whiskey_standins():
    """whiskey.xml's meshes are generated stand-ins
    (scripts/gen_procedural.py), made here under the port tests' lock."""
    from test_torch_bvh import _asset_lock
    spec = importlib.util.spec_from_file_location(
        "gen_procedural", os.path.join(REPO, "scripts", "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with _asset_lock(), contextlib.redirect_stdout(io.StringIO()):
        gen.ensure_scene_standins("csphere", "whiskey.xml")


@pytest.mark.parametrize("scene_file", _OPEN,
                         ids=[f"{d}/{f}" for d, f in _OPEN])
def test_pt_and_vpt_take_the_scene(scene_file):
    d, f = scene_file
    if f == "whiskey.xml":
        _whiskey_standins()
    scene, cfg, _ = load_scene(f"{SCENE_DIR}/{d}/", f, device="cpu")
    assert set(cfg.brdf_types) - {1} or cfg.bsdf_types \
        or set(cfg.emitter_kinds) - {0}
    small = dataclasses.replace(cfg, w=8, h=8, start_x=0, end_x=8,
                                start_y=0, end_y=8)
    for make in (pt.Renderer, vpt.VolumeRenderer, bdpt.BDPT):
        assert make(scene, small).cnt == 0
