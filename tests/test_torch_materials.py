"""The port's BRDFs, refracting BSDFs and geometric optics against the JAX
package, op by op and as whole renders.

* Op level: geo_optics, the cone / modified-Phong / Fresnel-hemisphere /
  concentric-disk samplers, the rotation helpers, every BRDF's eval,
  sample and pdf, and the det-refraction and lambertian BSDFs' sample,
  eval and pdf under TRANSPORT_UNI, _RAD and _IMP, fed identical numpy
  inputs (lanes at total internal reflection and at the leak guard
  included). Flags and lobe choices (is_specular, do_refract, total
  reflection) are equal; floats agree within rtol 1e-5, atol 1e-6, apart
  from three ill-conditioned functions whose bounds below state their
  measured worst error: lobes raised to large exponents (`_POW_RTOL`),
  the GGX distribution at small roughness (`_GGX_RTOL`) and
  convert_to_raw near the normal (`_RAW_ATOL`).
* The sphere test against the JAX package's on grazing rays: equal but
  for one ULP (its cancellation made the port's plain-order dot products
  miss the JAX hit by up to 1e-4 relative before).
* Whole slice: `render_pass_pt` on csphere/balls-multi.xml and
  mix-balls.xml at 48^2, 6 bounces, pass 1, key 42, against the JAX render
  and a golden written from the JAX package, under tests/test_goldens.py
  `_check`; the JAX render meets the golden too. A progressive
  `Renderer` of balls-multi (four shadow rays a bounce) against
  `jpt.Renderer` for two passes.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.constants import (BRDFTag, BSDFTag, TRANSPORT_IMP,
                                 TRANSPORT_RAD, TRANSPORT_UNI)
from adapt_tpu.ops import bxdf_ops as jbx, geo_optics as jgo
from adapt_tpu.ops import math3d as jm, sampling as js
from adapt_tpu.ops.intersect import Interaction as JInteraction, \
    _sphere_hit as j_sphere_hit
from adapt_tpu.renderer import pt as jpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.ops import bxdf_ops as tbx, geo_optics as tgo
from adapt_tpu_torch.ops import math3d as tm, sampling as ts
from adapt_tpu_torch.ops.intersect import Interaction, \
    _sphere_hit as t_sphere_hit
from adapt_tpu_torch.renderer import pt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_torch_pt import _close

N = 4096
RTOL, ATOL = 1e-5, 1e-6
# torch's and XLA's pow and tan differ by one ULP; an exponent n (the
# mod-Phong lobe's alpha, up to 200 here; balls-multi's Fresnel blend n_v,
# 1000) turns that into n ULPs of the lobe. Measured worst relative error
# on these inputs: mod_phong_hemisphere 1.2e-5, the Fresnel blend's eval,
# sample and pdf 2.1e-4
_POW_RTOL = 5e-4
# D of GGX at alpha 0.02 divides by alpha^2 (cos^2 + e)^2, so one ULP of
# the local half vector moves it by more: measured worst 1.1e-5
_GGX_RTOL = 5e-5
# sin_theta = sqrt(1 - cos^2) of a direction within a degree of the
# normal turns one ULP of cos into 1e-3 of sin_theta, cos_phi, sin_phi:
# measured worst 1.2e-3 absolute, on 8 of 4096 lanes
_RAW_ATOL = 3e-3

ALL_BRDFS = (BRDFTag.BLINN_PHONG, BRDFTag.LAMBERTIAN, BRDFTag.SPECULAR,
             BRDFTag.MICROFACET, BRDFTag.MOD_PHONG, BRDFTag.FRESNEL_BLEND,
             BRDFTag.OREN_NAYAR, BRDFTag.THIN_COAT)
_MODES = {"uni": TRANSPORT_UNI, "rad": TRANSPORT_RAD, "imp": TRANSPORT_IMP}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _near(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    assert got.dtype == want.dtype
    # rtol may be per lane: np.isclose's own bound, NaNs equal
    err = np.abs(got.astype(np.float64) - want)
    ok = (err <= atol + np.asarray(rtol) * np.abs(want)) \
        | (np.isnan(got) & np.isnan(want))
    assert ok.all(), (f"{(~ok).sum()} of {ok.size} differ; worst abs "
                      f"{err[~ok].max()}, rel "
                      f"{(err / np.abs(want))[~ok].max()}")


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _f32(x):
    return np.asarray(x, np.float32)


# ------------------------------ geo optics ------------------------------

def test_geo_optics():
    g = np.random.default_rng(0)
    ray, n = _unit(g, N), _unit(g, N)
    cos = _f32(np.sum(ray * n, -1))
    ni = _f32(g.choice([1.0, 1.5, 1.33], N))
    nr = _f32(g.choice([1.0, 1.5, 2.4], N))
    cos[:64] = _f32(g.uniform(-0.3, 0.3, 64))     # grazing: TIR for ni > nr
    tr, tn, tc, tni, tnr = map(_t, (ray, n, cos, ni, nr))
    for fn in ("inci_reflect_dir", "exit_reflect_dir"):
        for a, b in zip(getattr(tgo, fn)(tr, tn), getattr(jgo, fn)(ray, n)):
            _near(a, b)
    rs = _f32(g.uniform(0, 1, (N, 3)))
    _near(tgo.schlick_fresnel(_t(rs), tc.abs()),
          jgo.schlick_fresnel(rs, np.abs(cos)))
    cr = _f32(g.uniform(0, 1, N))
    _near(tgo.fresnel_equation(tni, tnr, tc.abs(), _t(cr)),
          jgo.fresnel_equation(ni, nr, np.abs(cos), cr))
    _near(tgo.fresnel_equation(1.0, tnr, tc.abs(), _t(cr)),
          jgo.fresnel_equation(1.0, nr, np.abs(cos), cr))
    _near(tgo.fresnel_eval(tc, tni, tnr), jgo.fresnel_eval(cos, ni, nr))
    _near(tgo.refraction_cos2(tc, tni, tnr), jgo.refraction_cos2(cos, ni, nr))
    tir = tgo.is_total_reflection(tc, tni, tnr)
    _near(tir, jgo.is_total_reflection(cos, ni, nr))
    assert tir.any() and not tir.all()
    got = tgo.snell_refraction(tr, tn, tc, tni, tnr)
    want = jgo.snell_refraction(ray, n, cos, ni, nr)
    for a, b in zip(got, want):
        _near(a, b)
    assert (got[0][tir] == 0).all()
    # scalar iors, as the thin coat passes them
    for a, b in zip(tgo.snell_refraction(tr, tn, tc, 1.0, 1.5),
                    jgo.snell_refraction(ray, n, cos, 1.0, 1.5)):
        _near(a, b)


# ------------------------------ samplers ------------------------------

def test_samplers():
    g = np.random.default_rng(1)
    u1, u2 = _f32(g.uniform(size=(2, N)))
    u1[:4] = [0.0, 0.25, 0.5, 0.75]              # quadrant edges
    u2[4:8] = 0.5                                # disk: oy = 0
    u1[8:12] = 0.5                               # disk: ox = 0
    cos_r = _f32(g.uniform(0.5, 1.0, N))
    _near(ts.uniform_cone(_t(u1), _t(u2), _t(cos_r)),
          js.uniform_cone(u1, u2, cos_r))
    alpha = _f32(g.uniform(1.0, 200.0, N))
    for a, b in zip(ts.mod_phong_hemisphere(_t(u1), _t(u2), _t(alpha)),
                    js.mod_phong_hemisphere(u1, u2, alpha)):
        _near(a, b, rtol=_POW_RTOL)
    # balls-multi's anisotropic exponents and a milder pair
    nu = _f32(np.where(np.arange(N) % 2, 10.0, 4.0))
    nv = _f32(np.where(np.arange(N) % 2, 1000.0, 30.0))
    for a, b in zip(ts.fresnel_hemisphere(_t(u1), _t(u2), _t(nu), _t(nv)),
                    js.fresnel_hemisphere(u1, u2, nu, nv)):
        _near(a, b, rtol=_POW_RTOL)
    disk = ts.concentric_disk(_t(u1), _t(u2))
    _near(disk, js.concentric_disk(u1, u2))
    assert (disk[4:12] == 0).all()


def test_rotations():
    g = np.random.default_rng(2)
    a, b, v = _unit(g, N), _unit(g, N), _unit(g, N)
    b[:4] = a[:4]                                 # parallel
    b[4:8] = -a[4:8]                              # antiparallel
    a[8:12] = [0.0, 1.0, 0.0]                     # anchor along +y
    a[12:16] = [0.0, -1.0, 0.0]
    ta, tb, tv = map(_t, (a, b, v))
    _near(tm.rotation_between(ta, tb), jm.rotation_between(a, b))
    _near(tm.rotation_from_y(tb), jm.rotation_from_y(b))
    _near(tm.localize_rotate(ta, tv), jm.localize_rotate(a, v))
    _near(tm.world_frame(ta, tb, tv), jm.world_frame(a, b, v))
    v[16:20] = a[16:20]                           # sin_theta ~ 0
    raw = tm.convert_to_raw(_t(v), ta)
    want = np.asarray(jm.convert_to_raw(v, a))
    steep = want[:, 1] < 0.2
    _near(raw[~steep], want[~steep])
    _near(raw[steep], want[steep], atol=_RAW_ATOL)
    assert steep.sum() < 128


# ------------------------------ materials ------------------------------

def _mat_rows(g, kind, n, is_bsdf=False):
    """Per-lane material parameters of one tag, as the scene compiler
    makes them (scene/bxdf.py), varied per lane."""
    kd = _f32(g.uniform(0.05, 0.95, (n, 3)))
    ks = _f32(g.uniform(0.0, 0.4, (n, 3)))
    kg = _f32(np.repeat(g.uniform(1.0, 60.0, (n, 1)), 3, 1))
    ior = _f32(np.ones(n))
    if is_bsdf:
        ior = _f32(g.choice([1.33, 1.5, 2.4], n))
    elif kind == BRDFTag.MICROFACET:
        kg = _f32(np.stack([g.uniform(0.02, 0.8, n), g.uniform(0.02, 0.8, n),
                            np.ones(n)], 1))
        ks = _f32(np.stack([np.ones(n), g.choice([1.33, 1.5, 2.0], n),
                            np.zeros(n)], 1))
    elif kind == BRDFTag.FRESNEL_BLEND:
        nu = np.where(np.arange(n) % 2, 10.0, g.uniform(1.0, 50.0, n))
        nv = np.where(np.arange(n) % 2, 1000.0, g.uniform(1.0, 50.0, n))
        kg = _f32(np.stack([nu, nv, np.sqrt((nu + 1) * (nv + 1))
                            / (8 * np.pi)], 1))
    elif kind in (BRDFTag.OREN_NAYAR, BRDFTag.THIN_COAT):
        sig = np.deg2rad(g.uniform(0.0, 40.0, n)) ** 2
        kg = _f32(np.stack([1.0 - sig / (2.0 * (sig + 0.33)),
                            0.45 * sig / (sig + 0.09),
                            g.choice([1.0, 1.5, 1.8], n)], 1))
    mean = _f32(np.stack([kd.mean(1), ks.mean(1), kg.mean(1)], 1))
    is_delta = np.full(n, kind == BRDFTag.SPECULAR and not is_bsdf) \
        | (is_bsdf & (kind != BSDFTag.LAMBERTIAN))
    return dict(kind=np.full(n, kind, np.int32),
                is_bsdf=np.full(n, is_bsdf), is_delta=is_delta, kd=kd, ks=ks,
                kg=kg, mean=mean, ior=ior, emit=np.full(n, -1, np.int32))


def _mats(rows):
    return (jbx.MatParams(**{k: jnp.asarray(v) for k, v in rows.items()}),
            tbx.MatParams(**{k: _t(v) for k, v in rows.items()}))


def _its(n_g, n_s):
    n = n_g.shape[0]
    obj, z, uv = np.zeros(n, np.int32), np.ones(n, np.float32), \
        np.zeros((n, 2), np.float32)
    j = JInteraction(obj_id=jnp.asarray(obj), prim_id=jnp.asarray(obj),
                     t=jnp.asarray(z), n_g=jnp.asarray(n_g),
                     n_s=jnp.asarray(n_s), uv=jnp.asarray(uv), tex=None)
    t = Interaction(obj_id=_t(obj), prim_id=_t(obj), t=_t(z), n_g=_t(n_g),
                    n_s=_t(n_s), uv=_t(uv))
    return j, t


def _surface_inputs(seed, n=N, both_sides=False):
    """Shading normals, geometric normals tilted up to ~25 degrees from
    them (so sampled directions cross the leak guard), an arriving ray
    into the surface (either side when both_sides), a scattered
    direction and six uniforms per lane."""
    g = np.random.default_rng(seed)
    n_s = _unit(g, n)
    n_g = n_s + 0.45 * _unit(g, n)
    n_g = _f32(n_g / np.linalg.norm(n_g, axis=-1, keepdims=True))
    incid = _unit(g, n)
    into = np.sum(incid * n_s, -1, keepdims=True) > 0
    if not both_sides:
        incid = _f32(np.where(into, -incid, incid))
    out = _unit(g, n)
    # a quarter of the lanes scatter near the mirror direction, where the
    # specular lobes and the det-refraction eval live
    mirror = incid - 2 * np.sum(incid * n_s, -1, keepdims=True) * n_s
    near = g.uniform(size=(n, 1)) < 0.25
    out = np.where(near, mirror + 0.01 * _unit(g, n), out)
    out = _f32(out / np.linalg.norm(out, axis=-1, keepdims=True))
    u = _f32(g.uniform(size=(n, 6)))
    return n_g, n_s, incid, out, u


def _cfgs(brdfs=(), bsdfs=()):
    jcfg, cfg = _balls_cfgs()
    kw = dict(brdf_types=tuple(brdfs), bsdf_types=tuple(bsdfs))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


_CFG_CACHE = {}


def _balls_cfgs():
    if not _CFG_CACHE:
        _, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                    "balls-multi.xml")
        _, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "balls-multi.xml",
                               device="cpu")
        _CFG_CACHE["c"] = (jcfg, cfg)
    return _CFG_CACHE["c"]


_EVALS = {BRDFTag.BLINN_PHONG: "eval_blinn_phong",
          BRDFTag.MOD_PHONG: "eval_mod_phong",
          BRDFTag.FRESNEL_BLEND: "eval_fresnel_blend",
          BRDFTag.OREN_NAYAR: "eval_oren_nayar",
          BRDFTag.THIN_COAT: "eval_thin_coat",
          BRDFTag.MICROFACET: "eval_microfacet"}


def _rtol(kind):
    """The float bound of each lane's material tag."""
    r = np.full(np.shape(kind), RTOL)
    r[np.asarray(kind) == BRDFTag.FRESNEL_BLEND] = _POW_RTOL
    r[np.asarray(kind) == BRDFTag.MICROFACET] = _GGX_RTOL
    return r if r.ndim else float(r)


@pytest.mark.parametrize("tag", ALL_BRDFS)
def test_brdf_eval(tag):
    g = np.random.default_rng(10 + tag)
    jmat, tmat = _mats(_mat_rows(g, tag, N))
    n_g, n_s, incid, out, _u = _surface_inputs(20 + tag)
    jit, tit = _its(n_g, n_s)
    if tag in _EVALS:
        _near(getattr(tbx, _EVALS[tag])(tmat, tit, _t(incid), _t(out)),
              getattr(jbx, _EVALS[tag])(jmat, jit, incid, out),
              rtol=_rtol(tag))
    jcfg, cfg = _cfgs(brdfs=(tag,))
    got = tbx.brdf_eval(cfg, tmat, tit, _t(incid), _t(out))
    _near(got, jbx.brdf_eval(jcfg, jmat, jit, incid, out), rtol=_rtol(tag))
    if tag != BRDFTag.SPECULAR:
        assert (got.amax(dim=-1) > 0).float().mean() > 0.2
    if tag == BRDFTag.THIN_COAT:
        _near(tbx._thin_coat_fresnel(tmat, tit, _t(incid)),
              jbx._thin_coat_fresnel(jmat, jit, incid))


@pytest.mark.parametrize("tag", ALL_BRDFS)
def test_brdf_sample_and_pdf(tag):
    g = np.random.default_rng(30 + tag)
    jmat, tmat = _mats(_mat_rows(g, tag, N))
    n_g, n_s, incid, out, u = _surface_inputs(40 + tag)
    jit, tit = _its(n_g, n_s)
    jcfg, cfg = _cfgs(brdfs=(tag,))
    got = tbx.brdf_sample(cfg, tmat, tit, _t(incid), _t(u))
    want = jbx.brdf_sample(jcfg, jmat, jit, incid, u)
    for a, b in zip(got, want):
        _near(a, b, rtol=_rtol(tag))
    d, spec, pdf, is_spec = got
    leak = tm.dot(d, _t(n_g)) <= 0.0
    assert leak.any() and (spec[leak] == 0).all()      # the leak guard
    # the delta flag: the specular BRDF, and the thin coat's mirror lobe
    if tag == BRDFTag.SPECULAR:
        assert is_spec.all()
    elif tag == BRDFTag.THIN_COAT:
        assert is_spec.any() and not is_spec.all()
    else:
        assert not is_spec.any()
    _near(tbx.brdf_pdf(cfg, tmat, tit, _t(out), _t(incid)),
          jbx.brdf_pdf(jcfg, jmat, jit, out, incid), rtol=_rtol(tag))
    # the pdf of the sampled directions themselves
    dn = d.numpy()
    _near(tbx.brdf_pdf(cfg, tmat, tit, d, _t(incid)),
          jbx.brdf_pdf(jcfg, jmat, jit, dn, incid), rtol=_rtol(tag))
    if tag == BRDFTag.MICROFACET:
        _near(tbx._ggx_pdf(tmat, tit, _t(incid), _t(out)),
              jbx._ggx_pdf(jmat, jit, incid, out))


@pytest.mark.parametrize("mode", list(_MODES), ids=list(_MODES))
@pytest.mark.parametrize("tag", [BSDFTag.DET_REFRACTION, BSDFTag.LAMBERTIAN,
                                 BSDFTag.NULL], ids=["det", "lam", "null"])
def test_bsdf_ops(tag, mode):
    g = np.random.default_rng(50 + tag)
    jmat, tmat = _mats(_mat_rows(g, tag, N, is_bsdf=True))
    n_g, n_s, incid, out, u = _surface_inputs(60 + tag, both_sides=True)
    jit, tit = _its(n_g, n_g)
    m = _MODES[mode]
    jcfg, cfg = _cfgs(bsdfs=(tag,))
    w_ior = np.float32(1.0)
    jw, tw = jnp.asarray(w_ior), torch.tensor(w_ior)
    got = tbx.bsdf_sample(cfg, tmat, tit, _t(incid), _t(u), tw, m)
    want = jbx.bsdf_sample(jcfg, jmat, jit, incid, u, jw, m)
    for a, b in zip(got, want):
        _near(a, b)
    _near(tbx.bsdf_eval(cfg, tmat, tit, _t(incid), _t(out), tw, m),
          jbx.bsdf_eval(jcfg, jmat, jit, incid, out, jw, m))
    _near(tbx.bsdf_pdf(cfg, tmat, tit, _t(out), _t(incid), tw),
          jbx.bsdf_pdf(jcfg, jmat, jit, out, incid, jw))
    # eval and pdf at the sampled directions (refracted ones included)
    d = got[0]
    _near(tbx.bsdf_eval(cfg, tmat, tit, _t(incid), d, tw, m),
          jbx.bsdf_eval(jcfg, jmat, jit, incid, d.numpy(), jw, m))
    _near(tbx.bsdf_pdf(cfg, tmat, tit, d, _t(incid), tw),
          jbx.bsdf_pdf(jcfg, jmat, jit, d.numpy(), incid, jw))
    # lanes at total internal reflection, leaving the denser side
    cos = tm.dot(_t(incid), _t(n_g))
    ni = torch.where(cos < 0, 1.0, tmat.ior)
    nr = torch.where(cos < 0, tmat.ior, 1.0)
    tir = tgo.is_total_reflection(cos, ni, nr)
    if tag != BSDFTag.NULL:
        # both arms reflect there, a delta event
        assert tir.any() and got[3][tir].all()


def _all_tag_rows(g, n):
    per = n // 11
    rows = [_mat_rows(g, t, per) for t in ALL_BRDFS] \
        + [_mat_rows(g, t, per, is_bsdf=True)
           for t in (BSDFTag.DET_REFRACTION, BSDFTag.LAMBERTIAN,
                     BSDFTag.NULL)]
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    perm = g.permutation(per * 11)
    return {k: v[perm] for k, v in cat.items()}, per * 11


@pytest.mark.parametrize("mode", list(_MODES), ids=list(_MODES))
@pytest.mark.parametrize("two_sides", [False, True])
def test_surface_dispatch_all_tags(two_sides, mode):
    """One wavefront of every BRDF and BSDF through the unified dispatch,
    as PT and VPT call it."""
    g = np.random.default_rng(70)
    rows, n = _all_tag_rows(g, N)
    jmat, tmat = _mats(rows)
    n_g, n_s, incid, out, u = _surface_inputs(71, n, both_sides=True)
    jit, tit = _its(n_g, n_s)
    jcfg, cfg = _cfgs(ALL_BRDFS, (BSDFTag.NULL, BSDFTag.DET_REFRACTION,
                                  BSDFTag.LAMBERTIAN))
    jcfg = dataclasses.replace(jcfg, brdf_two_sides=two_sides)
    cfg = dataclasses.replace(cfg, brdf_two_sides=two_sides)
    m = _MODES[mode]
    tw, jw = torch.tensor(1.0), jnp.float32(1.0)
    # BSDF lanes carry BSDFTag kinds (0 = det-refraction, 1 =
    # lambertian), which must not pick up the BRDF bounds
    rtol = _rtol(np.where(rows["is_bsdf"], -2, rows["kind"]))
    got = tbx.surface_sample(cfg, tmat, tit, _t(incid), _t(u), tw, m)
    want = jbx.surface_sample(jcfg, jmat, jit, incid, u, jw, m)
    for a, b in zip(got, want):
        _near(a, b, rtol=rtol[:, None] if a.ndim == 2 else rtol)
    _near(tbx.surface_eval(cfg, tmat, tit, _t(incid), _t(out), tw, m),
          jbx.surface_eval(jcfg, jmat, jit, incid, out, jw, m),
          rtol=rtol[:, None])
    _near(tbx.surface_pdf(cfg, tmat, tit, _t(out), _t(incid), tw),
          jbx.surface_pdf(jcfg, jmat, jit, out, incid, jw), rtol=rtol)


# ------------------------------ sphere prims ------------------------------

def test_sphere_hit_grazing():
    """Rays from balls-multi's camera at its spheres, a third of them
    grazing. The JAX package's test computes cn2 and proj as fused
    multiply-add chains (an einsum, a fused sum) on the CPU; the port's
    fma_dot takes them so, and the cancellation in cn2 - proj^2 leaves
    one ULP of difference at most (it was up to 1.4e-3 absolute with
    plain dot products)."""
    g = np.random.default_rng(80)
    n = 30000
    center = _f32([[4.2, 0.5, 4.1], [1.7, 1.2, 1.9], [0.9, 0.5, 0.6]])
    radius = _f32([0.5, 1.2, 0.5])
    o = _f32(np.array([2.78, 2.73, -8.0]) + g.normal(size=(n, 3)) * 0.01)
    pick = g.integers(0, 3, n)
    r = radius[pick, None] * np.where(g.uniform(size=(n, 1)) < 0.33,
                                      1.0 + g.uniform(-1e-3, 1e-3, (n, 1)),
                                      g.uniform(0, 1.1, (n, 1)))
    tgt = center[pick] + _unit(g, n) * r
    d = _f32((tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True))
    want = np.asarray(jax.jit(j_sphere_hit)(o, d, center, radius))
    got = t_sphere_hit(_t(o), _t(d), _t(center), _t(radius)).numpy()
    assert ((got > 0) == (want > 0)).all()
    hit = want > 0
    assert hit.mean() > 0.3
    ulp = np.abs(got[hit].view(np.int32).astype(np.int64)
                 - want[hit].view(np.int32))
    assert ulp.max() <= 1, ulp.max()


# ------------------------------ whole slice ------------------------------

_PT_SCENES = {"multi": ("balls-multi.xml", "csphere_multi_pt_48.npy"),
              "mix": ("mix-balls.xml", "csphere_mix_pt_48.npy")}


@pytest.fixture(scope="module", params=list(_PT_SCENES))
def csphere(request):
    f, golden = _PT_SCENES[request.param]
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/", f)
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", f, device="cpu")
    return jscene, jcfg, scene, cfg, golden


def test_pass_matches_jax_and_golden(csphere):
    jscene, jcfg, scene, cfg, golden = csphere
    img = pt.render_pass_pt(scene, _small(cfg, mb=6), rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), golden)
    ref = jpt.render_pass_pt(jscene, _small(jcfg, mb=6),
                             jax.random.PRNGKey(42), jnp.int32(1))
    _check(ref, golden)               # the golden is the JAX package's
    _close(img.numpy(), ref)
    assert img.mean() > 0.02


def test_renderer_multi_shadow_rays_matches_jax():
    """balls-multi declares four shadow rays a bounce: the progressive
    renderer (jittered, stratified, russian roulette from bounce 2) for
    two passes against the JAX package's."""
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                     "balls-multi.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "balls-multi.xml",
                               device="cpu")
    assert cfg.num_shadow_ray == 4

    def small(c):
        return dataclasses.replace(c, w=24, h=24, focal=c.focal * 24 / 512,
                                   end_x=24, end_y=24, max_bounce=5,
                                   rr_bounce_th=2)
    jr = jpt.Renderer(jscene, small(jcfg), seed=3)
    r = pt.Renderer(scene, small(cfg), seed=3)
    for _ in range(2):
        jr.render()
        r.render()
        _close(r.image(), jr.image())
    assert r.cnt == jr.cnt
    np.testing.assert_array_equal(r.get_check_point()["key"],
                                  jr.get_check_point()["key"])
    assert r.image().mean() > 0.01
