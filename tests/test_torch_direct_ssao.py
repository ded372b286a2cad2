"""The port's direct preview and SSAO against the JAX package and the
goldens, on the CPU at 48^2 (tests/test_goldens.py's settings).

Same scene, same key (jax.random.PRNGKey(42) / the port's rng.PRNGKey(42)):
* `uniform_hemisphere` on shared numpy uniforms;
* `render_pass_direct`: color, depth and normal, with the shadow mask of
  the same shadow rays equal on every lane whose primary ray hit (a miss
  lane's shadow ray starts FAR = 1e7 out, where an f32 ULP is 1, and
  its color is 0 whatever the mask);
* `depth_prepass` within 1e-4 (the t of a hit rounds alike but for XLA's
  FMAs: each of the 64 samples may differ by an f32 ULP of t);
* `render_pass_ssao`: every pixel within 1 / smp_hemisphere (one offset
  may rasterize onto the neighbouring depth texel where the two packages
  round a direction differently), the mean within 1e-4;
* both passes under the goldens' `_check`;
* `DirectRenderer` / `SSAORenderer`: two passes against the JAX
  renderers', and a checkpoint taken after the first pass that resumes
  into a new renderer bit for bit;
* both previews on cbox-volgrid.xml, a scene with a grid volume that
  they read nothing of (as the JAX package's), at 24^2 against the JAX
  passes under the same bounds.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import intersect as jintersect
from adapt_tpu.ops.math3d import norm as jax_norm
from adapt_tpu.ops.sampling import uniform_hemisphere as jax_hemisphere
from adapt_tpu.renderer import direct as jdirect, ssao as jssao
from adapt_tpu.renderer.base import camera_rays as jax_camera_rays
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.ops import intersect
from adapt_tpu_torch.ops.sampling import uniform_hemisphere
from adapt_tpu_torch.renderer import direct, ssao
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.scene.assets import load_volume
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small

# XLA on the CPU contracts a*b + c into FMAs where the port rounds each
# product and sum: the shading and the maps agree to a few f32 ULPs of
# values up to ~20 (depth) and ~1 (color, normal); measured 3.4e-6, 1.9e-6
# and 6e-8
ATOL = {"color": 2e-5, "depth": 2e-5, "normal": 1e-6}


@pytest.fixture(scope="module")
def cbox():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return jscene, _small(jcfg), scene, _small(cfg)


@pytest.fixture(scope="module")
def depth_maps(cbox):
    jscene, jcfg, scene, cfg = cbox
    return (np.asarray(jssao.depth_prepass(jscene, jcfg,
                                           jax.random.PRNGKey(42))),
            ssao.depth_prepass(scene, cfg, rng.PRNGKey(42)))


def test_uniform_hemisphere_equal_jax():
    u = np.random.default_rng(0).random((2, 4096), dtype=np.float32)
    jd, jpdf = jax_hemisphere(jnp.asarray(u[0]), jnp.asarray(u[1]))
    d, pdf = uniform_hemisphere(torch.from_numpy(u[0]),
                                torch.from_numpy(u[1]))
    # cos, sin and sqrt of XLA and of PyTorch may differ by an ULP
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=3e-7)
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    assert (d[:, 1] >= 0).all()


def test_direct_pass_matches_jax_and_golden(cbox):
    jscene, jcfg, scene, cfg = cbox
    got = direct.render_pass_direct(scene, cfg, rng.PRNGKey(42), 1)
    want = jdirect.render_pass_direct(jscene, jcfg, jax.random.PRNGKey(42),
                                      jnp.int32(1))
    for name, g, w in zip(("color", "depth", "normal"), got, want):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL[name], err_msg=name)
    _check(got[0].numpy(), "cbox_direct_48.npy")
    # the shadow rays of both packages: the same occluded lanes
    ro, rd = camera_rays(scene, cfg, rng.PRNGKey(42), 1)
    it = intersect.ray_intersect(scene, cfg, ro, rd)
    hit_p, ld, dist = direct.shadow_rays(scene, ro, rd, it.t)
    shadowed = intersect.does_intersect(scene, cfg, hit_p, ld, dist)
    jo, jd = jax_camera_rays(jscene, jcfg, jax.random.PRNGKey(42),
                             jnp.int32(1))
    jit_ = jintersect.ray_intersect(jscene, jcfg, jo, jd)
    jp = jo + jit_.t[..., None] * jd
    to_l = jscene.emit_pos[0][None, :] - jp
    jdist = jax_norm(to_l)
    jshadowed = np.asarray(jintersect.does_intersect(
        jscene, jcfg, jp, to_l / jnp.maximum(jdist[..., None], 1e-12),
        jdist))
    hit = it.is_hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jit_.obj_id) >= 0)
    np.testing.assert_array_equal(shadowed.numpy()[hit], jshadowed[hit])
    assert 0.05 < float(shadowed[it.is_hit].float().mean()) < 0.95


def test_depth_prepass_matches_jax(cbox, depth_maps):
    jdm, dm = depth_maps
    assert dm.shape == (48 * 48,) and dm.device.type == "cpu"
    np.testing.assert_allclose(dm.numpy(), jdm, rtol=0, atol=1e-4)
    assert (dm > 0).float().mean() > 0.9


def test_ssao_pass_matches_jax_and_golden(cbox, depth_maps):
    jscene, jcfg, scene, cfg = cbox
    jdm, dm = depth_maps
    got = ssao.render_pass_ssao(scene, cfg, rng.PRNGKey(42), 1, dm).numpy()
    want = np.asarray(jssao.render_pass_ssao(
        jscene, jcfg, jax.random.PRNGKey(42), jnp.int32(1),
        jnp.asarray(jdm)))
    assert got.shape == want.shape == (48 * 48, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1.0 / cfg.smp_hemisphere)
    assert abs(got.mean() - want.mean()) < 1e-4
    _check(got, "cbox_ao_48.npy")


@pytest.mark.parametrize("kind", ["direct", "ssao"])
def test_renderer_two_passes_and_checkpoint(cbox, kind):
    jscene, jcfg, scene, cfg = cbox
    jcls, cls = {"direct": (jdirect.DirectRenderer, direct.DirectRenderer),
                 "ssao": (jssao.SSAORenderer, ssao.SSAORenderer)}[kind]
    r, jr = cls(scene, cfg, seed=3), jcls(jscene, jcfg, seed=3)
    r.render()
    chk = r.get_check_point()
    r.render()
    jr.render()
    jr.render()
    assert r.cnt == 2
    tol = ATOL["color"] if kind == "direct" else 1.0 / cfg.smp_hemisphere
    np.testing.assert_allclose(r.pixels.numpy(), np.asarray(jr.pixels),
                               rtol=0, atol=tol)
    if kind == "direct":
        np.testing.assert_allclose(r.depth.numpy(), np.asarray(jr.depth),
                                   rtol=0, atol=ATOL["depth"])
        np.testing.assert_allclose(r.normal.numpy(), np.asarray(jr.normal),
                                   rtol=0, atol=ATOL["normal"])
    resumed = cls(scene, cfg, seed=7)
    resumed.load_check_point(chk)
    resumed.render()
    assert torch.equal(resumed.color, r.color) and resumed.cnt == 2


@pytest.mark.parametrize("kind", ["direct", "ssao"])
def test_preview_on_a_grid_volume(kind):
    """cbox-volgrid.xml, which the previews refused until grid volumes
    were ported: a pass at 24^2 against the JAX package's (which reads no
    volume either), and the renderer's first pass finite."""
    from test_torch_volume import volume_assets
    volume_assets()
    d = SCENE_DIR + "/cbox/"
    jscene, jcfg, _ = jax_load_scene(d, "cbox-volgrid.xml")
    scene, cfg, _ = load_volume(d, "cbox-volgrid.xml", "cpu")
    jcfg, cfg = _small(jcfg, 24), _small(cfg, 24)
    assert cfg.volume_kind
    if kind == "direct":
        got = direct.render_pass_direct(scene, cfg, rng.PRNGKey(42), 1)
        want = jdirect.render_pass_direct(
            jscene, jcfg, jax.random.PRNGKey(42), jnp.int32(1))
        for name, g, w in zip(("color", "depth", "normal"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL[name], err_msg=name)
        r = direct.DirectRenderer(scene, cfg)
    else:
        dm = ssao.depth_prepass(scene, cfg, rng.PRNGKey(42))
        jdm = jssao.depth_prepass(jscene, jcfg, jax.random.PRNGKey(42))
        np.testing.assert_allclose(dm.numpy(), np.asarray(jdm), rtol=0,
                                   atol=1e-4)
        got = ssao.render_pass_ssao(scene, cfg, rng.PRNGKey(42), 1,
                                    dm).numpy()
        want = np.asarray(jssao.render_pass_ssao(
            jscene, jcfg, jax.random.PRNGKey(42), jnp.int32(1), jdm))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1.0 / cfg.smp_hemisphere)
        assert abs(got.mean() - want.mean()) < 1e-4
        got = (got,)
        r = ssao.SSAORenderer(scene, cfg)
    assert got[0].mean() > 0.01
    r.render()
    assert np.isfinite(r.image()).all() and r.image().mean() > 0.01
