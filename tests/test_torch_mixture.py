"""The port's BxDF mixtures against the JAX package, op by op and as whole
passes, and BDPT on csphere/balls-multi.xml (every BRDF the scene has, a
det-refraction ball, a sphere area light).

* Op level: the compiled mixture table and material rows equal the JAX
  package's; `mixture_eval`, `mixture_pdf` and `mixture_sample` and the
  mixture overlay of `surface_eval/pdf/sample` on the same numpy inputs,
  for the two-lambertian mixture of tests/test_mixture.py and for one of
  a lambertian, a GGX microfacet and a det-refraction BSDF whose
  proportions leave 0.1 absorbed: picks and flags equal, floats within
  rtol 1e-5, atol 1e-6 (the microfacet's GGX terms within
  test_torch_materials.py's `_GGX_RTOL`).
* Whole passes: PT on the three-component mixture scene (32^2, its own 3
  bounces, key 42) and BDPT on balls-multi at 24^2, 3 bounces, each
  against the JAX render under tests/test_torch_pt.py `_close` and
  against a golden written once from the JAX package (`mixture_pt_32`,
  `csphere_multi_bdpt_24`) under tests/test_goldens.py `_check`. BDPT on
  balls-multi, measured: max abs 2.8e-3 from the JAX render on 4 of 1,728
  values (pow of the Fresnel blend's exponent 1000 and the MIS sweep's
  order, ROADMAP queue C), mean within 1.1e-4 relative.
* BDPT on the mixture scene (16^2, 2 bounces) against the JAX render:
  the walk's continuation ignores the mixture, as the JAX package's does
  (ROADMAP queue C).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import bxdf_ops as jbx, mixture_ops as jmx
from adapt_tpu.ops.intersect import Interaction as JInteraction
from adapt_tpu.renderer import bdpt as jbdpt, pt as jpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.convert import MIXTURE_NAMES, scene_leaves
from adapt_tpu_torch.ops import bxdf_ops as tbx, mixture_ops as tmx
from adapt_tpu_torch.ops.intersect import Interaction
from adapt_tpu_torch.renderer import bdpt, pt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_mixture import _SCENE_TMPL
from test_torch_materials import _GGX_RTOL, _near, _t, _unit
from test_torch_pt import _close

N = 4096

# tests/test_mixture.py test_mixture_e2e_two_lambertians_direct_blend
TWO_LAMBERTIANS = """
  <brdf type="lambertian" id="a">
    <rgb name="k_d" value="0.8, 0.2, 0.6"/>
  </brdf>
  <brdf type="lambertian" id="b">
    <rgb name="k_d" value="0.2, 0.6, 0.4"/>
  </brdf>
  <brdf type="mixture" id="ball">
    <ref name="diffuse" id="a"/>
    <ref name="glossy" id="b"/>
    <float name="p_d" value="0.5"/>
    <float name="p_g" value="0.5"/>
  </brdf>"""

# three components of three kinds, 0.1 of the picks absorbed
THREE_KINDS = """
  <brdf type="lambertian" id="a">
    <rgb name="k_d" value="0.7, 0.5, 0.3"/>
  </brdf>
  <brdf type="microfacet" id="c">
    <rgb name="k_d" value="0.9"/>
    <rgb name="k_s" value="1.0, 1.5, 0"/>
    <rgb name="roughness" value="0.35, 0.35, 0"/>
  </brdf>
  <bsdf type="det-refraction" id="glass">
    <rgb name="k_d" value="#FAFAFA"/>
    <medium type="transparent">
      <rgb name="u_a" value="0.0"/>
      <rgb name="u_s" value="0.0"/>
      <rgb name="par" value="0.0"/>
      <float name="ior" value="1.5"/>
    </medium>
  </bsdf>
  <brdf type="mixture" id="ball">
    <ref name="diffuse" id="a"/>
    <ref name="glossy" id="c"/>
    <ref name="transmit" id="glass"/>
    <float name="p_d" value="0.4"/>
    <float name="p_g" value="0.3"/>
    <float name="p_t" value="0.2"/>
  </brdf>"""

_MIXES = {"two_lambertians": TWO_LAMBERTIANS, "three_kinds": THREE_KINDS}


def _mixture_scene(tmp_path, materials, max_bounce=3):
    (tmp_path / "scene.xml").write_text(
        _SCENE_TMPL.format(materials=materials, max_bounce=max_bounce))
    jscene, jcfg, _ = jax_load_scene(str(tmp_path), "scene.xml")
    scene, cfg, _ = load_scene(str(tmp_path), "scene.xml", device="cpu")
    return jscene, jcfg, scene, cfg


@pytest.fixture(scope="module", params=list(_MIXES))
def mixed(request, tmp_path_factory):
    return _mixture_scene(tmp_path_factory.mktemp(request.param),
                          _MIXES[request.param])


def test_tables_equal_jax(mixed):
    """The mixture table, obj_mixture and the component rows appended to
    the material tables, leaf for leaf."""
    jscene, jcfg, scene, cfg = mixed
    assert scene.mixture is not None and jscene.mixture is not None
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "big_tier"} == dataclasses.asdict(jcfg)
    got, want = scene_leaves(scene), scene_leaves(jscene)
    assert set(MIXTURE_NAMES) <= set(want)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the mixture's own row is not in the dispatch tables
    assert 8 not in cfg.brdf_types


def _inputs(scene, seed, n=N):
    """Lanes on the mixture object (row 0), on its component rows and
    missing (-1); random normals and directions, both sides; uniforms."""
    g = np.random.default_rng(seed)
    rows = scene.mat_type.shape[0]
    obj = g.integers(-1, rows, n).astype(np.int32)
    obj[: n // 2] = 0
    n_g = _unit(g, n)
    flip = np.where(g.uniform(size=(n, 1)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    n_s = n_g * flip
    incid, out = _unit(g, n), _unit(g, n)
    u = g.uniform(size=(n, 6)).astype(np.float32)
    return obj, n_g, n_s, incid, out, u


def _its(obj, n_g, n_s):
    n = obj.shape[0]
    zero_i = np.zeros(n, np.int32)
    zero_f = np.zeros(n, np.float32)
    uv = np.zeros((n, 2), np.float32)
    return (Interaction(obj_id=_t(obj), prim_id=_t(zero_i), t=_t(zero_f),
                        n_g=_t(n_g), n_s=_t(n_s), uv=_t(uv)),
            JInteraction(obj_id=jnp.asarray(obj), prim_id=jnp.asarray(zero_i),
                         t=jnp.asarray(zero_f), n_g=jnp.asarray(n_g),
                         n_s=jnp.asarray(n_s), uv=jnp.asarray(uv), tex=None))


def _rtol(cfg):
    return _GGX_RTOL if 3 in cfg.brdf_types else 1e-5


@pytest.mark.parametrize("mode", [-1, 0, 1], ids=["uni", "rad", "imp"])
def test_mixture_ops_match_jax(mixed, mode):
    jscene, jcfg, scene, cfg = mixed
    obj, n_g, n_s, incid, out, u = _inputs(scene, 3 + mode)
    tit, jit = _its(obj, n_g, n_s)
    mix_id = np.zeros(N, np.int32)
    w_ior, jw_ior = scene.world_medium.ior[0], jscene.world_medium.ior[0]
    rtol = _rtol(cfg)
    args = (_t(incid), _t(out))
    _near(tmx.mixture_eval(scene, cfg, scene.mixture, _t(mix_id), tit,
                           *args, w_ior, mode),
          jmx.mixture_eval(jscene, jcfg, jscene.mixture, jnp.asarray(mix_id),
                           jit, incid, out, jw_ior, mode), rtol=rtol)
    _near(tmx.mixture_pdf(scene, cfg, scene.mixture, _t(mix_id), tit,
                          _t(out), _t(incid), w_ior),
          jmx.mixture_pdf(jscene, jcfg, jscene.mixture, jnp.asarray(mix_id),
                          jit, out, incid, jw_ior), rtol=rtol)
    got = tmx.mixture_sample(scene, cfg, scene.mixture, _t(mix_id), tit,
                             _t(incid), _t(u), w_ior, mode)
    want = jmx.mixture_sample(jscene, jcfg, jscene.mixture,
                              jnp.asarray(mix_id), jit, incid, u, jw_ior,
                              mode)
    for a, b in zip(got, want):
        _near(a, b, rtol=rtol)
    # every component was picked, and the absorbed remainder where it is
    probs = scene.mixture.probs[0].numpy()
    picked = np.searchsorted(np.cumsum(probs), u[:, 5], side="right")
    assert set(np.unique(picked)) == {i for i in range(4) if probs[i] > 0} \
        | ({4} if probs.sum() < 1.0 - 1e-6 else set())


@pytest.mark.parametrize("two_sides", [False, True])
def test_surface_overlay_matches_jax(mixed, two_sides):
    """surface_eval / pdf / sample with scene=: mixture lanes take the
    mixture, the others their own row."""
    jscene, jcfg, scene, cfg = mixed
    cfg = dataclasses.replace(cfg, brdf_two_sides=two_sides)
    jcfg = dataclasses.replace(jcfg, brdf_two_sides=two_sides)
    obj, n_g, n_s, incid, out, u = _inputs(scene, 11 + two_sides)
    tit, jit = _its(obj, n_g, n_s)
    tmat = tbx.gather_mat(scene, _t(obj))
    jmat = jbx.gather_mat(jscene, jnp.asarray(obj))
    w_ior, jw_ior = scene.world_medium.ior[0], jscene.world_medium.ior[0]
    rtol = _rtol(cfg)
    for a, b in zip(tbx.surface_sample(cfg, tmat, tit, _t(incid), _t(u),
                                       w_ior, scene=scene),
                    jbx.surface_sample(jcfg, jmat, jit, incid, u, jw_ior,
                                       scene=jscene)):
        _near(a, b, rtol=rtol)
    _near(tbx.surface_eval(cfg, tmat, tit, _t(incid), _t(out), w_ior,
                           scene=scene),
          jbx.surface_eval(jcfg, jmat, jit, incid, out, jw_ior,
                           scene=jscene), rtol=rtol)
    _near(tbx.surface_pdf(cfg, tmat, tit, _t(out), _t(incid), w_ior,
                          scene=scene),
          jbx.surface_pdf(jcfg, jmat, jit, out, incid, jw_ior,
                          scene=jscene), rtol=rtol)


def test_mixture_pt_pass_matches_jax_and_golden(tmp_path):
    """PT through the whole parse -> compile -> render path on the
    three-component mixture scene, at its own settings (32^2, 3 bounces,
    no RR, no jitter)."""
    jscene, jcfg, scene, cfg = _mixture_scene(tmp_path, THREE_KINDS)
    img = pt.render_pass_pt(scene, cfg, rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), "mixture_pt_32.npy")
    ref = jpt.render_pass_pt(jscene, jcfg, jax.random.PRNGKey(42),
                             jnp.int32(1))
    _check(ref, "mixture_pt_32.npy")
    _close(img.numpy(), ref)
    assert img.mean() > 0.01


def test_balls_multi_bdpt_pass_matches_jax_and_golden():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                     "balls-multi.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "balls-multi.xml",
                               device="cpu")
    assert set(cfg.brdf_types) == {0, 1, 2, 4, 5} and cfg.bsdf_types == (0,)
    img, _, _ = bdpt.render_pass_bdpt(scene, _small(cfg, w=24),
                                      rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), "csphere_multi_bdpt_24.npy")
    ref, _, _ = jbdpt.render_pass_bdpt(jscene, _small(jcfg, w=24),
                                       jax.random.PRNGKey(42), jnp.int32(1))
    _check(ref, "csphere_multi_bdpt_24.npy")
    _close(img.numpy(), ref)
    assert img.mean() > 0.01


def test_mixture_bdpt_pass_matches_jax(tmp_path):
    """BDPT on the three-component mixture scene (16^2, 2 bounces)
    against the JAX render. The JAX package's walk samples a mixture
    lane's continuation without the mixture overlay (bdpt.py:553 passes
    no scene to surface_sample: the lane samples its own placeholder row)
    while its connections evaluate the mixture; the port keeps that."""
    jscene, jcfg, scene, cfg = _mixture_scene(tmp_path, THREE_KINDS)
    c = dataclasses.replace(cfg, w=16, h=16, end_x=16, end_y=16,
                            focal=cfg.focal * 16 / 32, max_bounce=2)
    jc = dataclasses.replace(jcfg, w=16, h=16, end_x=16, end_y=16,
                             focal=jcfg.focal * 16 / 32, max_bounce=2)
    img, _, _ = bdpt.render_pass_bdpt(scene, c, rng.PRNGKey(42), 1)
    ref, _, _ = jbdpt.render_pass_bdpt(jscene, jc, jax.random.PRNGKey(42),
                                       jnp.int32(1))
    assert not torch.isnan(img).any()
    _close(img.numpy(), ref)
    assert img.mean() > 0.001
