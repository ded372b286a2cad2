"""The port's volumetric path tracer against the goldens and the JAX package.

* Medium ops (HG with g < 0, g ~ 0, g > 0; multi-HG; Rayleigh;
  mean-free-path sampling; transmittance), the area-light `sample_hit` and
  the NULL BSDF dispatch against their JAX counterparts on the same numpy
  inputs: within rtol 1e-5, atol 1e-6 (transcendentals and XLA's fused
  multiply-adds differ by ULPs between the two).
* `render_pass_vpt` at the golden settings against `vptcbox_48.npy` under
  tests/test_goldens.py `_check`, and against the JAX render under
  tests/test_torch_pt.py `_close`; a world-medium scene (cbox.xml's HG
  world, a point light) against the JAX render.
* `VolumeRenderer.render_batch` with russian roulette against the JAX
  package's `render_batch(..., fuse=1)`, and its checkpoint.
* A compacted pass equal to the uncompacted one, bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import bxdf_ops as jbxdf, emitter_ops as jemit, \
    medium_ops as jmed
from adapt_tpu.ops.intersect import Interaction as JInteraction
from adapt_tpu.renderer import vpt as jvpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.constants import MediumTag
from adapt_tpu_torch.ops import _build, bxdf_ops, emitter_ops, medium_ops
from adapt_tpu_torch.ops.intersect import Interaction
from adapt_tpu_torch.renderer import vpt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_torch_pt import _close

RTOL, ATOL = 1e-5, 1e-6


def _near(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def vcbox():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/vpt/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/vpt/", "cbox.xml", device="cpu")
    return jscene, jcfg, scene, cfg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("g_val", [-0.6, 3e-5, 2e-4, 0.7],
                         ids=["back", "iso", "tiny", "fwd"])
def test_hg_matches_jax(g_val):
    u = np.random.default_rng(1).uniform(size=512).astype(np.float32)
    g = np.full(512, g_val, np.float32)
    c = medium_ops.sample_hg(_t(g), _t(u))
    _near(c, jmed.sample_hg(jnp.asarray(g), jnp.asarray(u)))
    _near(medium_ops.eval_hg(_t(g), c),
          jmed.eval_hg(jnp.asarray(g), jnp.asarray(c.numpy())))
    if g_val < -0.1:        # the sign-kept divisor: backscatter on average
        assert c.mean() < -0.3


def _phase_inputs(n=600, seed=2):
    g = np.random.default_rng(seed)
    kind = g.choice([MediumTag.HG, MediumTag.MULTI_HG, MediumTag.RAYLEIGH],
                    n).astype(np.int32)
    par = g.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    par[::5, 0] = 0.0
    pdf = g.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    pdf /= pdf.sum(1, keepdims=True)
    incid = g.normal(size=(n, 3)).astype(np.float32)
    incid /= np.linalg.norm(incid, axis=1, keepdims=True)
    out = g.normal(size=(n, 3)).astype(np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    u = g.uniform(size=(n, 3)).astype(np.float32)
    return kind, par, pdf, incid, out, u


def test_phase_sample_and_eval_match_jax():
    kind, par, pdf, incid, out, u = _phase_inputs()
    kinds = (MediumTag.HG, MediumTag.MULTI_HG, MediumTag.RAYLEIGH)
    d, val = medium_ops.phase_sample(_t(kind), _t(par), _t(pdf), _t(incid),
                                     _t(u), kinds)
    jd, jval = jmed.phase_sample(*map(jnp.asarray, (kind, par, pdf, incid,
                                                    u)), kinds)
    _near(d, jd)
    _near(val, jval)
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    _near(medium_ops.phase_eval(_t(kind), _t(par), _t(pdf), _t(incid),
                                _t(out), kinds),
          jmed.phase_eval(*map(jnp.asarray, (kind, par, pdf, incid, out)),
                          kinds))
    # kinds absent from present_kinds sample the isotropic function
    _, iso = medium_ops.phase_sample(_t(kind), _t(par), _t(pdf), _t(incid),
                                     _t(u), ())
    assert (iso == np.float32(0.25 / np.pi)).all()


def test_mfp_and_transmittance_match_jax():
    g = np.random.default_rng(4)
    n = 800
    u_e = g.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    u_s = (u_e * g.uniform(0.0, 1.0, (n, 3))).astype(np.float32)
    u_e[::9] = 0.0
    scat = g.uniform(size=n) > 0.2
    depth = g.uniform(0.0, 6.0, n).astype(np.float32)
    depth[::11] = 0.0
    depth[::13] = -3e38          # dead lanes: masked, never multiplied
    u = g.uniform(size=(n, 2)).astype(np.float32)
    got = medium_ops.sample_mfp(_t(u_e), _t(u_s), _t(scat), _t(depth), _t(u))
    want = jmed.sample_mfp(*map(jnp.asarray, (u_e, u_s, scat, depth, u)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _near(got[1], want[1])
    _near(got[2], want[2])
    assert np.isfinite(got[2].numpy()).all()
    assert got[0].numpy().mean() > 0.2
    seg = np.abs(depth).clip(max=6.0)
    _near(medium_ops.transmittance(_t(u_e), _t(scat), _t(seg)),
          jmed.transmittance(*map(jnp.asarray, (u_e, scat, seg))))


def _sample_hit_pair(jscene, jcfg, scene, cfg, n=500, seed=6):
    g = np.random.default_rng(seed)
    lo = scene.obj_aabb_min.numpy().min(0)
    hi = scene.obj_aabb_max.numpy().max(0)
    p = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    u = g.uniform(size=(n, 3)).astype(np.float32)
    eid = np.zeros(n, np.int32)
    got = emitter_ops.sample_hit(scene, cfg, _t(eid), _t(p), _t(u))
    want = jemit.sample_hit(jscene, jcfg, jnp.asarray(eid), jnp.asarray(p),
                            jnp.asarray(u))
    for a, b in zip(got, want):
        _near(a, b)
    return got


def test_area_light_sample_hit_matches_jax(vcbox):
    jscene, jcfg, scene, cfg = vcbox
    pos, inten, pdf, normal = _sample_hit_pair(jscene, jcfg, scene, cfg)
    assert (inten.amax(dim=-1) > 0).float().mean() > 0.5
    # the sphere branch: csphere's ball made the light
    js, jc, _ = jax_load_scene(SCENE_DIR + "/csphere/", "single-ball.xml")
    s, c, _ = load_scene(SCENE_DIR + "/csphere/", "single-ball.xml",
                         device="cpu")
    ball = int(torch.nonzero(s.obj_is_sphere)[0, 0])
    js = dataclasses.replace(js, emit_obj=jnp.asarray([ball], jnp.int32))
    s = dataclasses.replace(s, emit_obj=torch.tensor([ball],
                                                     dtype=torch.int32))
    pos, *_ = _sample_hit_pair(js, jc, s, c, seed=8)
    r = (pos - s.sph_center[0]).norm(dim=-1)
    np.testing.assert_allclose(r.numpy(), s.sph_radius[0].item(), rtol=1e-5)


def test_null_bsdf_dispatch_matches_jax(vcbox):
    jscene, jcfg, scene, cfg = vcbox
    assert cfg.bsdf_types == (-1,) and cfg.brdf_types == (1,)
    g = np.random.default_rng(9)
    n = 400
    obj = g.integers(0, scene.obj_start.shape[0], n).astype(np.int32)
    n_g = g.normal(size=(n, 3)).astype(np.float32)
    n_g /= np.linalg.norm(n_g, axis=1, keepdims=True)
    incid = g.normal(size=(n, 3)).astype(np.float32)
    incid /= np.linalg.norm(incid, axis=1, keepdims=True)
    out = np.where(g.uniform(size=(n, 1)) < 0.3, incid,
                   g.normal(size=(n, 3))).astype(np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    u = g.uniform(size=(n, 6)).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    it = Interaction(obj_id=_t(obj), prim_id=_t(obj), t=_t(zeros + 1),
                     n_g=_t(n_g), n_s=_t(n_g), uv=_t(np.zeros((n, 2),
                                                              np.float32)))
    jit = JInteraction(obj_id=jnp.asarray(obj), prim_id=jnp.asarray(obj),
                       t=jnp.asarray(zeros + 1), n_g=jnp.asarray(n_g),
                       n_s=jnp.asarray(n_g),
                       uv=jnp.zeros((n, 2), jnp.float32), tex=None)
    mat = bxdf_ops.gather_mat(scene, _t(obj))
    jmat = jbxdf.gather_mat(jscene, jnp.asarray(obj))
    w = scene.world_medium.ior[0]
    jw = jscene.world_medium.ior[0]
    got = bxdf_ops.surface_sample(cfg, mat, it, _t(incid), _t(u), w)
    want = jbxdf.surface_sample(jcfg, jmat, jit, jnp.asarray(incid),
                                jnp.asarray(u), jw)
    for a, b in zip(got, want):
        _near(a, b)
    null = mat.is_bsdf & (mat.kind < 0)
    assert null.any() and torch.equal(got[0][null], _t(incid)[null])
    _near(bxdf_ops.surface_eval(cfg, mat, it, _t(incid), _t(out), w),
          jbxdf.surface_eval(jcfg, jmat, jit, jnp.asarray(incid),
                             jnp.asarray(out), jw))
    pdf = bxdf_ops.surface_pdf(cfg, mat, it, _t(out), _t(incid), w)
    _near(pdf, jbxdf.surface_pdf(jcfg, jmat, jit, jnp.asarray(out),
                                 jnp.asarray(incid), jw))
    assert (pdf[null] == 1.0).any() and (pdf[null] == 0.0).any()


def test_golden_and_jax_pass(vcbox):
    jscene, jcfg, scene, cfg = vcbox
    _build.reset_launches()
    img = vpt.render_pass_vpt(scene, _small(cfg), rng.PRNGKey(42), 1)
    # the CPU path runs the twins: no kernel launches
    assert not any(_build.launches["intersect_kernels"].values())
    _check(img.numpy(), "vptcbox_48.npy")
    ref = jvpt.render_pass_vpt(jscene, _small(jcfg), jax.random.PRNGKey(42),
                               jnp.int32(1))
    _close(img.numpy(), ref)


def test_world_medium_pass_matches_jax():
    """cbox.xml under the volumetric tracer: an HG world medium fills free
    space (world bound, world-medium rows) and a point light."""
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml", device="cpu")
    assert cfg.world_scattering and not cfg.has_null_bsdf
    kw = dict(w=24, h=24, focal=cfg.focal * 24 / 512, end_x=24, end_y=24,
              max_bounce=4)
    img = vpt.render_pass_vpt(scene, dataclasses.replace(cfg, **kw),
                              rng.PRNGKey(3), 1)
    ref = jvpt.render_pass_vpt(jscene, dataclasses.replace(jcfg, **kw),
                               jax.random.PRNGKey(3), jnp.int32(1))
    _close(img.numpy(), ref)
    assert img.mean() > 0.02


def _progressive_cfg(cfg, w=16):
    """Jittered, stratified; russian roulette from bounce 2 on below a
    throughput of 0.9, so that it fires within 4 bounces, and differs from
    a roulette keyed to the iteration on lanes whose bounce count lags it
    (a null crossing after the first bounce)."""
    return dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                               end_x=w, end_y=w, max_bounce=4,
                               rr_bounce_th=2, rr_threshold=0.9)


def test_render_batch_matches_jax_fuse1_and_checkpoint(vcbox):
    jscene, jcfg, scene, cfg = vcbox
    jr = jvpt.VolumeRenderer(jscene, _progressive_cfg(jcfg), seed=5)
    r = vpt.VolumeRenderer(scene, _progressive_cfg(cfg), seed=5)
    assert cfg.use_rr
    jr.render_batch(2, fuse=1)
    r.render_batch(2)
    _close(r.image(), jr.image())
    np.testing.assert_array_equal(r.get_check_point()["key"],
                                  jr.get_check_point()["key"])
    assert r.image().mean() > 0.05
    r2 = vpt.VolumeRenderer(scene, _progressive_cfg(cfg), seed=0)
    r2.load_check_point(r.get_check_point())
    r.render()
    r2.render()
    np.testing.assert_array_equal(r2.image(), r.image())


@pytest.mark.parametrize("schedule", [((3, 2), (6, 4), (9, 8)), ((1, 64),)],
                         ids=["splits", "overflow"])
def test_compacted_pass_equals_uncompacted(vcbox, schedule):
    """Draws are keyed by (iteration, original lane), so a pass compacted
    at any splits (here scaled to 256 lanes; the second schedule's prefix
    is too narrow and takes the overflow branch) equals the plain one."""
    _, _, scene, cfg = vcbox
    c = dataclasses.replace(_progressive_cfg(cfg), max_bounce=6)
    plain = vpt.render_pass_vpt(scene, c, rng.PRNGKey(7), 3, schedule=())
    comp = vpt.render_pass_vpt(scene, c, rng.PRNGKey(7), 3,
                               schedule=schedule)
    assert torch.equal(plain, comp)
    assert plain.mean() > 0.05


def test_vpt_gate(tmp_path):
    """The volumetric tracer refuses nothing the JAX package's renders;
    PT's gate still refuses the vpt cbox (tests/test_torch_scene.py). Grid
    volumes, which it refused until they were ported, render: a 12^2 pass
    of cbox-volgrid.xml (tests/test_torch_volume.py holds the passes to
    the JAX renders). Textures, which it refused until they were ported,
    render: the vpt cbox with the two-tone floor of
    tests/test_torch_texture.py, 24^2, 3 bounces, against the JAX
    render."""
    import chip_smoke
    from adapt_tpu_torch.scene.assets import load_volume
    from test_torch_volume import volume_assets
    volume_assets()
    vscene, vcfg, _ = load_volume(SCENE_DIR + "/cbox/",
                                  "cbox-volgrid.xml", "cpu")
    vpt.VolumeRenderer(vscene, vcfg)
    vimg = vpt.render_pass_vpt(vscene, _small(vcfg, 12), rng.PRNGKey(0), 1)
    assert torch.isfinite(vimg).all() and vimg.mean() > 0.01
    scene, cfg, _ = load_scene(SCENE_DIR + "/vpt/", "cbox.xml", device="cpu")
    from test_torch_texture import _load_both
    jscene, jcfg, tscene, tcfg = _load_both(
        *chip_smoke.twotone_cbox(str(tmp_path), "vpt", "cbox.xml"))
    assert tscene.tex["albedo"].present
    vpt.VolumeRenderer(tscene, tcfg)
    img = vpt.render_pass_vpt(tscene, _small(tcfg, 24), rng.PRNGKey(42), 1)
    ref = jvpt.render_pass_vpt(jscene, _small(jcfg, 24),
                               jax.random.PRNGKey(42), jnp.int32(1))
    _close(img.numpy(), ref)
    plain = vpt.render_pass_vpt(scene, _small(cfg, 24), rng.PRNGKey(42), 1)
    assert (img - plain).abs().max() > 1e-2
