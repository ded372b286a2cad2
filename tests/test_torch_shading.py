"""Shading ops of the port against the JAX package on the same inputs.

math3d, cosine_hemisphere, the lambertian sample/eval/pdf dispatch and the
point-light functions, fed identical numpy uniforms, normals and object
ids; agreement to 1e-6 relative to each quantity's scale. The outputs
are unit vectors, cosines, pdfs and throughputs of order one, so that is
rtol 1e-6 with atol 1e-6: XLA on the CPU fuses multiply-adds and the two
libraries' cos/sin differ in the last ULP, which shows as ~2e-7 absolute
on a small component of a unit vector.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import bxdf_ops as jbx, emitter_ops as jem
from adapt_tpu.ops import math3d as jm, sampling as js
from adapt_tpu.ops.intersect import Interaction as JInteraction
from adapt_tpu.renderer import pt as jpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch.ops import bxdf_ops as tbx, emitter_ops as tem
from adapt_tpu_torch.ops import math3d as tm, sampling as ts
from adapt_tpu_torch.ops.intersect import Interaction
from adapt_tpu_torch import rng
from adapt_tpu_torch.renderer import pt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_torch_pt import _close

N = 4096


def _near(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def cbox():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return jscene, jcfg, scene, cfg


def test_math3d():
    g = np.random.default_rng(0)
    a = g.normal(size=(N, 3)).astype(np.float32)
    b = g.normal(size=(N, 3)).astype(np.float32)
    a[:8] = 0.0                                   # zero vectors
    anchor = _unit(g, N)
    anchor[:4] = [0.0, 1.0, 0.0]                  # parallel fallback
    anchor[4:8] = [0.0, -1.0, 0.0]                # antiparallel fallback
    ta, tb, tanc = (torch.from_numpy(x) for x in (a, b, anchor))
    _near(tm.dot(ta, tb), jm.dot(a, b))
    _near(tm.norm(ta), jm.norm(a))
    _near(tm.normalize(ta), jm.normalize(a))
    _near(tm.safe_normalize(ta), jm.safe_normalize(a))
    _near(tm.cross(ta, tb), jnp.cross(a, b))
    _near(tm.delocalize_rotate(tanc, tb), jm.delocalize_rotate(anchor, b))


def test_sampling():
    g = np.random.default_rng(1)
    u1, u2 = g.uniform(size=(2, N)).astype(np.float32)
    d, pdf = ts.cosine_hemisphere(torch.from_numpy(u1), torch.from_numpy(u2))
    jd, jpdf = js.cosine_hemisphere(u1, u2)
    _near(d, jd)
    _near(pdf, jpdf)
    pa = g.uniform(0, 2, N).astype(np.float32)
    pb = g.uniform(0, 2, N).astype(np.float32)
    pa[:16] = 0.0
    _near(ts.balance_heuristic(torch.from_numpy(pa), torch.from_numpy(pb)),
          js.balance_heuristic(pa, pb))


def _inputs(seed, O):
    g = np.random.default_rng(seed)
    n_s = _unit(g, N)
    n_g = _unit(g, N)
    # keep n_g within 90 degrees of n_s, like a mesh's two normals
    n_g = np.where((n_g * n_s).sum(-1, keepdims=True) < 0, -n_g, n_g)
    obj = g.integers(-1, O, N).astype(np.int32)
    incid = _unit(g, N)
    u = g.uniform(size=(N, 6)).astype(np.float32)
    return obj, n_g, n_s, incid, u, _unit(g, N)


def _interactions(obj, n_g, n_s):
    z = np.zeros(N, np.float32)
    uv = np.zeros((N, 2), np.float32)
    j = JInteraction(obj_id=jnp.asarray(obj), prim_id=jnp.asarray(obj * 0),
                     t=jnp.asarray(z), n_g=jnp.asarray(n_g),
                     n_s=jnp.asarray(n_s), uv=jnp.asarray(uv), tex=None)
    t = Interaction(obj_id=torch.from_numpy(obj),
                    prim_id=torch.from_numpy(obj * 0), t=torch.from_numpy(z),
                    n_g=torch.from_numpy(n_g), n_s=torch.from_numpy(n_s),
                    uv=torch.from_numpy(uv))
    return j, t


@pytest.mark.parametrize("two_sides", [False, True])
def test_lambertian_surface_ops(cbox, two_sides):
    jscene, jcfg, scene, cfg = cbox
    jcfg = dataclasses.replace(jcfg, brdf_two_sides=two_sides)
    cfg = dataclasses.replace(cfg, brdf_two_sides=two_sides)
    obj, n_g, n_s, incid, u, out = _inputs(2, scene.mat_kd.shape[0])
    jit, tit = _interactions(obj, n_g, n_s)
    jmat = jbx.gather_mat(jscene, jnp.asarray(obj))
    tmat = tbx.gather_mat(scene, torch.from_numpy(obj))
    for f in dataclasses.fields(tmat):
        _near(getattr(tmat, f.name), getattr(jmat, f.name))
    w_ior = scene.world_medium.ior[0]
    jw_ior = jscene.world_medium.ior[0]
    t_in, t_u, t_out = (torch.from_numpy(x) for x in (incid, u, out))
    got = tbx.surface_sample(cfg, tmat, tit, t_in, t_u, w_ior)
    want = jbx.surface_sample(jcfg, jmat, jit, incid, u, jw_ior,
                              scene=jscene)
    for a, b in zip(got, want):
        _near(a, b)
    _near(tbx.surface_eval(cfg, tmat, tit, t_in, t_out, w_ior),
          jbx.surface_eval(jcfg, jmat, jit, incid, out, jw_ior,
                           scene=jscene))
    _near(tbx.surface_pdf(cfg, tmat, tit, t_out, t_in, w_ior),
          jbx.surface_pdf(jcfg, jmat, jit, out, incid, jw_ior,
                          scene=jscene))


def test_unported_bxdf_raises(tmp_path):
    """BxDF mixtures, which the port refused at compile until they were
    ported, load and render: a mixture of one diffuse component at
    p_d = 1 renders as the JAX package's does (its op-level and
    multi-component passes are in tests/test_torch_mixture.py)."""
    from test_mixture import _SCENE_TMPL
    mixed = """
  <brdf type="lambertian" id="base">
    <rgb name="k_d" value="0.7, 0.5, 0.3"/>
  </brdf>
  <brdf type="mixture" id="ball">
    <ref name="diffuse" id="base"/>
    <float name="p_d" value="1.0"/>
  </brdf>"""
    (tmp_path / "scene.xml").write_text(
        _SCENE_TMPL.format(materials=mixed, max_bounce=3))
    jscene, jcfg, _ = jax_load_scene(str(tmp_path), "scene.xml")
    assert jscene.mixture is not None
    scene, cfg, _ = load_scene(str(tmp_path), "scene.xml", device="cpu")
    assert scene.mixture is not None
    np.testing.assert_array_equal(scene.obj_mixture.numpy(),
                                  np.asarray(jscene.obj_mixture))
    img = pt.render_pass_pt(scene, cfg, rng.PRNGKey(5), 1)
    ref = jpt.render_pass_pt(jscene, jcfg, jax.random.PRNGKey(5),
                             jnp.int32(1))
    _close(img.numpy(), ref)
    assert img.mean() > 0.01


def test_point_light(cbox):
    jscene, jcfg, scene, cfg = cbox
    g = np.random.default_rng(4)
    u_pick = g.uniform(size=N).astype(np.float32)
    hit_light = g.integers(-1, cfg.n_emitters, N).astype(np.int32)
    got = tem.sample_light_index(cfg, torch.from_numpy(u_pick),
                                 torch.from_numpy(hit_light))
    want = jem.sample_light_index(jcfg, u_pick, jnp.asarray(hit_light))
    for a, b in zip(got, want):
        _near(a, b)
    # a scene with several lights takes the exclusion branch
    cfg3 = dataclasses.replace(cfg, n_emitters=3)
    jcfg3 = dataclasses.replace(jcfg, n_emitters=3)
    hl3 = g.integers(-1, 3, N).astype(np.int32)
    for a, b in zip(tem.sample_light_index(cfg3, torch.from_numpy(u_pick),
                                           torch.from_numpy(hl3)),
                    jem.sample_light_index(jcfg3, u_pick, jnp.asarray(hl3))):
        _near(a, b)

    eid = np.zeros(N, np.int32)
    hit_pos = g.uniform(0.0, 5.5, (N, 3)).astype(np.float32)
    hit_pos[:8] = scene.emit_pos[0].numpy()       # on the light: clamped
    u_hit = g.uniform(size=(N, 3)).astype(np.float32)
    got = tem.sample_hit(scene, cfg, torch.from_numpy(eid),
                         torch.from_numpy(hit_pos), torch.from_numpy(u_hit))
    want = jem.sample_hit(jscene, jcfg, jnp.asarray(eid), jnp.asarray(hit_pos),
                          jnp.asarray(u_hit))
    for a, b in zip(got, want):
        _near(a, b)

    d, n = _unit(g, N), _unit(g, N)
    depth = g.uniform(0.1, 9.0, N).astype(np.float32)
    te, td, tn, tdep = (torch.from_numpy(x) for x in (eid, d, n, depth))
    _near(tem.eval_le(scene, te, td, tn),
          jem.eval_le(jscene, jnp.asarray(eid), d, n))
    _near(tem.solid_angle_pdf(scene, te, tn, tdep, td),
          jem.solid_angle_pdf(jscene, jnp.asarray(eid), n, depth, d))
    _near(tem.is_delta_pos(scene, te), jem.is_delta_pos(jscene,
                                                        jnp.asarray(eid)))
