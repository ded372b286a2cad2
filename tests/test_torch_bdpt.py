"""The port's bidirectional path tracer against the goldens and the JAX
package.

Tolerances, and why:

* Walks (`generate_eye_path`, `generate_light_path`) on the same key:
  vertex types, object and emitter ids, bits and vertex counts exactly
  equal. Floats differ because XLA contracts multiply-adds into FMAs on the
  CPU (and rotates camera rays with them) while the port rounds every
  operation. Normals within atol 1e-5. Directions within atol 1e-4 and
  positions and times within rtol 1e-3, atol 1e-4 (scene units; the box
  is 5.6 across): the HG phase sampling's local frame amplifies a
  direction's ulps near its pole (1e-5 measured after 2 bounces), and a
  long medium segment carries that into the next vertex (3.4e-4 over 8
  units). Densities and throughputs within rtol 1e-3 (a 1/d^2 conversion
  amplifies a position's ulps at short distances).
* Connections and MIS on identical buffers (the JAX walk carried across by
  convert.py): raster ids equal; radiance, times and weights within rtol
  1e-4, atol 1e-6. The MIS sweep tables run the JAX package's associative
  scan in order (~1 ulp per factor). A grazing connection can flip its
  visibility between the two roundings (measured: one lane of 3,072, at a
  cosine of 2.4e-3), so at most 1 in 1,000 lanes may differ.
* Whole passes: tests/test_goldens.py `_check` bounds (mean within 1e-3
  relative, every pixel within 5e-2). Transient counts: a grazing
  connection (a cosine or a visibility test at its sign) can flip under
  those ulps and move one sample in or out of a bin, so at most 1 in 10^4
  cells may differ, by at most 2 samples.
* The MIS sum-to-1 invariant: 1e-3, as tests/test_bdpt_mis.py holds it.
"""
import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer import bdpt as JB
from adapt_tpu.ops import emitter_ops as jemit
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.constants import (VERTEX_CAMERA, VERTEX_EMITTER,
                                       VERTEX_SURFACE)
from adapt_tpu_torch.convert import (key_from_numpy,
                                     vertex_buffers_from_numpy,
                                     vertex_buffers_to_numpy)
from adapt_tpu_torch.ops import emitter_ops
from adapt_tpu_torch.ops.math3d import dot, normalize
from adapt_tpu_torch.renderer import bdpt as B
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_bdpt_mis import _build_path, _make_buffers, _strategy_weights
from test_goldens import _check, _small
from test_torch_pt import _close

RTOL, ATOL = 1e-4, 1e-6
INTS = ("vtype", "obj_id", "emit_id", "bits")


def _cut(cfg, w=32, mb=3, **kw):
    return dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                               end_x=w, end_y=w, max_bounce=mb, **kw)


def _load(directory, file):
    jscene, jcfg, _ = jax_load_scene(directory, file)
    scene, cfg, _ = load_scene(directory, file, device="cpu")
    return jscene, jcfg, scene, cfg


@pytest.fixture(scope="module")
def cbox():
    return _load(SCENE_DIR + "/cbox/", "cbox.xml")


@pytest.fixture(scope="module")
def area_cbox(tmp_path_factory):
    """cbox.xml with its commented-out luminaire and area emitter enabled
    (beside the point light), written outside the repository."""
    with open(os.path.join(SCENE_DIR, "cbox", "cbox.xml")) as fh:
        xml = fh.read()
    for pat in (r'<!-- (<emitter type="area".*?</emitter>) -->',
                r'<!-- (<shape type="obj">\s*<string name="filename" '
                r'value="../meshes/cornell/cbox_luminaire.obj"/>.*?'
                r'</shape>) -->'):
        xml, n = re.subn(pat, r"\1", xml, flags=re.S)
        assert n == 1
    meshes = os.path.abspath(os.path.join(SCENE_DIR, "meshes"))
    xml = xml.replace('value="../meshes/', f'value="{meshes}/')
    d = tmp_path_factory.mktemp("area_cbox")
    (d / "cbox-area.xml").write_text(xml)
    out = _load(str(d) + "/", "cbox-area.xml")
    assert out[3].emitter_kinds == (0, 1) and out[3].n_emitters == 2
    return out


@pytest.fixture(scope="module")
def trans():
    return _load(SCENE_DIR + "/trans/", "cbox-point.xml")


def _np(x):
    return np.asarray(x)


# --------------------------------- walks ---------------------------------

@pytest.fixture(scope="module")
def walks(area_cbox):
    """Both subpaths of one pass on the area-light cbox (cbox's HG world
    medium: mean free paths and phase sampling; point and area emission)
    at 32^2, 3 bounces, by both packages."""
    jscene, jcfg, scene, cfg = area_cbox
    c, jc = _cut(cfg), _cut(jcfg)
    jkey = jax.random.PRNGKey(17)
    _, jk_cam, jk_lit, jk_con = jax.random.split(jkey, 4)
    jcam = JB.generate_eye_path(jscene, jc, jk_cam, jnp.int32(2), 3)
    jlit = JB.generate_light_path(jscene, jc, jk_lit, 3)
    _, k_cam, k_lit, k_con = rng.split(key_from_numpy(jkey), 4)
    cam = B.generate_eye_path(scene, c, k_cam, 2, 3)
    lit = B.generate_light_path(scene, c, k_lit, 3)
    return dict(c=c, jc=jc, jcam=jcam, jlit=jlit, cam=cam, lit=lit,
                k_con=k_con, jk_con=jk_con, scene=scene, jscene=jscene)


@pytest.mark.parametrize("side", ["cam", "lit"])
def test_walk_matches_jax(walks, side):
    buf, vnum = walks[side]
    jbuf, jvnum = walks["j" + side]
    np.testing.assert_array_equal(vnum.numpy(), _np(jvnum))
    assert vnum.max() == 4 and (vnum > 1).float().mean() > 0.5
    got = vertex_buffers_to_numpy(buf)
    for k in INTS:
        np.testing.assert_array_equal(got[k], _np(jbuf[k]), err_msg=k)
    for k in ("pos", "time"):
        np.testing.assert_allclose(got[k], _np(jbuf[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    for k in ("n_s", "n_g"):
        np.testing.assert_allclose(got[k], _np(jbuf[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["ray_in"], _np(jbuf["ray_in"]), rtol=0,
                               atol=1e-4)
    for k in ("pdf_fwd", "pdf_bwd", "beta"):
        np.testing.assert_allclose(got[k], _np(jbuf[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    # the world medium placed medium vertices on some lanes
    assert (got["vtype"] == 1).any() and (got["vtype"] == 0).any()


def test_sample_le_matches_jax(area_cbox):
    """Point and area branches, five uniforms each lane."""
    jscene, jcfg, scene, cfg = area_cbox
    g = np.random.default_rng(3)
    n = 600
    eid = g.integers(0, 2, n).astype(np.int32)
    u = g.uniform(size=(n, 5)).astype(np.float32)
    got = emitter_ops.sample_le(scene, cfg, torch.from_numpy(eid),
                                torch.from_numpy(u))
    want = jemit.sample_le(jscene, jcfg, jnp.asarray(eid), jnp.asarray(u))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)
    area = eid == int(np.argmax(scene.emit_kind.numpy() == 1))
    assert area.any() and (~area).any()


def test_sample_camera_matches_jax(cbox):
    """Raster ids, importance and pdf of camera connections from points
    all around the camera, both ways along each direction: the ids must be
    equal (a differently rounded rotation would move a splat across a pixel
    boundary)."""
    jscene, jcfg, scene, cfg = cbox
    c, jc = _cut(cfg, w=64), _cut(jcfg, w=64)
    g = np.random.default_rng(9)
    d = g.normal(size=(4000, 3)).astype(np.float32)
    d[:2000, 2] = np.abs(d[:2000, 2]) * 4.0      # mostly through the film
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.concatenate([d, -d]).astype(np.float32)
    depth = g.uniform(0.5, 9.0, size=d.shape[0]).astype(np.float32)
    got = B.sample_camera(scene, c, torch.from_numpy(d),
                          torch.from_numpy(depth))
    want = JB.sample_camera(jscene, jc, jnp.asarray(d), jnp.asarray(depth))
    for k in (2, 3):
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    for k in (0, 1):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=1e-5,
                                   atol=0)
    assert (got[2] >= 0).sum() > 500


def test_fold_in_of_large_data_matches_jax():
    """The flat groups' visibility key folds 1 << 31 (bdpt.py:1222)."""
    jkey = jax.random.PRNGKey(77)
    for data in (1 << 31, (1 << 32) - 1, 12):
        want = jax.random.key_data(jax.random.fold_in(jkey, data)) \
            if hasattr(jax.random, "key_data") else \
            jax.random.fold_in(jkey, data)
        assert rng.fold_in(key_from_numpy(jkey), data) == \
            key_from_numpy(want)


# -------------------------- connections and MIS --------------------------

@pytest.fixture(scope="module")
def same_buffers(walks):
    """The JAX walk's buffers carried into the port."""
    jcb, jcv = walks["jcam"]
    jlb, jlv = walks["jlit"]
    cb = vertex_buffers_from_numpy({k: None if v is None else _np(v)
                                    for k, v in jcb.items()}, device="cpu")
    lb = vertex_buffers_from_numpy({k: None if v is None else _np(v)
                                    for k, v in jlb.items()}, device="cpu")
    back = vertex_buffers_to_numpy(cb)
    for k, v in jcb.items():
        if v is not None:
            np.testing.assert_array_equal(back[k], _np(v))
    return (cb, torch.from_numpy(np.array(jcv)), lb,
            torch.from_numpy(np.array(jlv)))


@pytest.mark.parametrize("case", ["s0", "t1", "s1", "gen"])
def test_connect_strategy_matches_jax(walks, same_buffers, case):
    """Each case's flat group on the same buffers. On these scenes the JAX
    package's t=1 connections never land on the film: connect_strategy
    hands sample_camera the direction away from the camera, so only a
    vertex behind the camera could pass its tests. The port keeps that
    (the goldens hold it); t=1 raster ids are all -1 in both."""
    scene, jscene = walks["scene"], walks["jscene"]
    c, jc = walks["c"], walks["jc"]
    cb, cv, lb, lv = same_buffers
    jcb, jcv = walks["jcam"]
    jlb, jlv = walks["jlit"]
    rows = B._strategy_groups(c, 3)[case]
    assert rows == JB_groups(jc, 3)[case]
    got = B.connect_strategy(scene, c, walks["k_con"], cb, cv, lb, lv, rows,
                             case=case)
    want = JB.connect_strategy(jscene, jc, walks["jk_con"], jcb, jcv, jlb,
                               jlv, 0, 0, case=case, rows=rows)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    _lanes_close([got[0], got[2][:, None], got[3][:, None]],
                 [want[0], want[2][:, None], want[3][:, None]])
    lit = got[0].amax(dim=-1) > 0
    if case == "t1":
        assert not lit.any() and (got[1] == -1).all()
    else:
        assert lit.any()


def _lanes_close(got, want, frac=1e-3):
    """Every lane's values within RTOL/ATOL, but for at most `frac` of the
    lanes (at least one): a grazing connection (a cosine of 2e-3, a shadow
    ray along a face) can flip its visibility between the two packages'
    roundings, and with it the lane's radiance and time."""
    a = np.concatenate([np.asarray(x) for x in got], axis=1)
    b = np.concatenate([np.asarray(x) for x in want], axis=1)
    bad = ~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=1)
    assert bad.sum() <= max(1, frac * len(bad)), np.where(bad)[0]


def JB_groups(jcfg, max_bnc):
    """The JAX pass's strategy table (bdpt_pass_core's enumeration)."""
    t_hi = min(jcfg.end_t - 1, max_bnc + 1)
    s_hi = min(jcfg.end_s - 1, max_bnc + 1)
    groups = {"s0": [], "t1": [], "s1": [], "gen": []}
    k = 0
    for t in range(max(jcfg.start_t, 1), t_hi + 1):
        for s in range(max(jcfg.start_s, 0), s_hi + 1):
            if (s == 1 and t == 1) or not 0 <= s + t - 2 <= jcfg.max_bounce:
                continue
            k += 1
            groups[JB._strategy_case(s, t)].append((s, t, k))
    return groups


@pytest.mark.parametrize("case", ["s0", "gen"])
def test_mis_weight_matches_jax(walks, same_buffers, case):
    """_mis_weight on its own, flat rows, sides read from the buffers."""
    scene, jscene = walks["scene"], walks["jscene"]
    cb, _, lb, _ = same_buffers
    jcb, _ = walks["jcam"]
    jlb, _ = walks["jlit"]
    rows = [r[:2] for r in B._strategy_groups(walks["c"], 3)[case]]
    cam_side = B._stack_rows(rows, lambda s, t: B._vertex_at(cb, t - 1))
    jcam_side = JB._stack_rows(rows, lambda s, t: JB._vertex_at(jcb, t - 1))
    if case == "s0":
        lit_side = B._null_vertex(cam_side["vtype"].shape[0], "cpu")
        jlit_side = JB._null_vertex(jcam_side["vtype"].shape[0], False)
    else:
        lit_side = B._stack_rows(rows, lambda s, t: B._vertex_at(lb, s - 1))
        jlit_side = JB._stack_rows(rows,
                                   lambda s, t: JB._vertex_at(jlb, s - 1))
    got = B._mis_weight(scene, walks["c"], cb, lb, cam_side, lit_side, 0, 0,
                        case=case, rows=rows)
    want = JB._mis_weight(jscene, walks["jc"], jcb, jlb, jcam_side,
                          jlit_side, 0, 0, case=case, rows=rows)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    assert ((got > 0) & (got < 1)).any()


# ---------------------- MIS invariant on an area light ----------------------

def _t(x):
    return torch.from_numpy(np.array(x))


def _port_buffers(scene, cfg, path):
    """tests/test_bdpt_mis.py `_make_buffers` with the port's own pdf
    bookkeeping (pdf_vertex, _convert_density, _get_pdf_bwd): what
    bdpt_random_walk stores along the fixed path."""
    x0, (x1, n1, o1), (x2, n2, o2), (x3, n3, lo), eid = path
    cam = B._vertex_buffers(1, 5, "cpu")
    lit = B._vertex_buffers(1, 5, "cpu")
    fs = B.B_IN_FSPACE
    one3 = torch.ones(3)
    no = torch.zeros(1, dtype=torch.bool)

    def put(buf, k, **vals):
        for name, v in vals.items():
            buf[name][k, 0] = torch.as_tensor(v, dtype=buf[name].dtype)

    def pdf_v(buf, k, ray_in, out_dir):
        return B.pdf_vertex(scene, cfg, B._static_vertex(buf, k),
                            ray_in[None], out_dir[None])[0]

    def conv(pdf_sa, a, b, n_b):
        return B._convert_density(pdf_sa.reshape(1), (b - a)[None],
                                  n_b[None], no)[0]

    def bwd(pos, n, has_n, pdf_sa, nxt):
        return B._get_pdf_bwd(pos[None], n[None],
                              torch.tensor([has_n]), pdf_sa.reshape(1),
                              nxt[None])[0]

    put(cam, 0, vtype=VERTEX_CAMERA, obj_id=-1, emit_id=-1,
        bits=B.B_POS_DELTA | fs, pos=x0, beta=one3)
    d01, d12, d23 = normalize(x1 - x0), normalize(x2 - x1), \
        normalize(x3 - x2)
    put(cam, 1, vtype=VERTEX_SURFACE, obj_id=o1, emit_id=-1, bits=fs, pos=x1,
        n_s=n1, n_g=n1, ray_in=d01, pdf_fwd=conv(torch.zeros(()), x0, x1, n1),
        beta=one3)
    c2 = conv(pdf_v(cam, 1, d01, d12), x1, x2, n2)
    cam["pdf_bwd"][0, 0] = bwd(x0, torch.zeros(3), False,
                               pdf_v(cam, 1, -d12, -d01), x1)
    put(cam, 2, vtype=VERTEX_SURFACE, obj_id=o2, emit_id=-1, bits=fs, pos=x2,
        n_s=n2, n_g=n2, ray_in=d12, pdf_fwd=c2, beta=one3)
    c3 = conv(pdf_v(cam, 2, d12, d23), x2, x3, n3)
    cam["pdf_bwd"][1, 0] = bwd(x1, n1, True, pdf_v(cam, 2, -d23, -d12), x2)
    put(cam, 3, vtype=VERTEX_SURFACE, obj_id=lo, emit_id=eid,
        bits=B.B_IS_AREA | fs, pos=x3, n_s=n3, n_g=n3, ray_in=d23,
        pdf_fwd=c3, beta=one3)

    put(lit, 0, vtype=VERTEX_EMITTER, obj_id=lo, emit_id=eid,
        bits=scene.emit_bits[eid], pos=x3, n_s=n3, n_g=n3,
        pdf_fwd=scene.emit_inv_area[eid] / float(max(cfg.n_emitters, 1)),
        time=scene.emit_time[eid], beta=one3)
    d32, d21, d10 = normalize(x2 - x3), normalize(x1 - x2), \
        normalize(x0 - x1)
    pdf_dir_le = torch.clamp(dot(d32, n3), min=0.0) / np.pi
    put(lit, 1, vtype=VERTEX_SURFACE, obj_id=o2, emit_id=-1, bits=fs, pos=x2,
        n_s=n2, n_g=n2, ray_in=d32, pdf_fwd=conv(pdf_dir_le, x3, x2, n2),
        beta=one3)
    l2 = conv(pdf_v(lit, 1, d32, d21), x2, x1, n1)
    lit["pdf_bwd"][0, 0] = bwd(x3, n3, True, pdf_v(lit, 1, -d21, -d32), x2)
    put(lit, 2, vtype=VERTEX_SURFACE, obj_id=o1, emit_id=-1, bits=fs, pos=x1,
        n_s=n1, n_g=n1, ray_in=d21, pdf_fwd=l2, beta=one3)
    lit["pdf_bwd"][1, 0] = bwd(x2, n2, True, pdf_v(lit, 2, -d10, -d21), x1)
    return cam, lit


def _port_weights(scene, cfg, cam, lit, path, n_verts):
    """MIS weight of every (s, t) split with s + t == n_verts
    (tests/test_bdpt_mis.py `_strategy_weights` on the port)."""
    x0, (x3, n3, lo), eid = path[0], path[3], path[4]
    out = {}
    for t in range(1, n_verts + 1):
        s = n_verts - t
        if t == 1:
            cam_side = B._null_vertex(1, "cpu")
            cn = B._cam_normal(scene)[None]
            cam_side.update(vtype=torch.tensor([VERTEX_CAMERA],
                                               dtype=torch.int32),
                            bits=torch.tensor([B.B_POS_DELTA | B.B_IN_FSPACE],
                                              dtype=torch.int32),
                            pos=x0[None], n_s=cn, n_g=cn)
        else:
            cam_side = B._static_vertex(cam, t - 1)
        if s == 0:
            lit_side = B._null_vertex(1, "cpu")
        elif s == 1:
            e = torch.tensor([eid], dtype=torch.int32)
            lit_side = B._null_vertex(1, "cpu")
            lit_side.update(
                vtype=torch.tensor([VERTEX_EMITTER], dtype=torch.int32),
                obj_id=lo.reshape(1).to(torch.int32), emit_id=e,
                bits=scene.emit_bits[e],
                pdf_fwd=B._area_pdf(scene, cfg, e) / float(max(
                    cfg.n_emitters, 1)),
                n_s=n3[None], n_g=n3[None], pos=x3[None])
        else:
            lit_side = B._static_vertex(lit, s - 1)
        out[(s, t)] = float(B._mis_weight(scene, cfg, cam, lit, cam_side,
                                          lit_side, s, t)[0])
    return out


@pytest.fixture(scope="module")
def mis_path(area_cbox):
    jscene, jcfg, scene, cfg = area_cbox
    jpath = _build_path(jscene, jcfg)
    x0, (x1, n1, o1), (x2, n2, o2), (x3, n3, lo), eid = jpath
    path = (_t(x0), (_t(x1), _t(n1), _t(o1)), (_t(x2), _t(n2), _t(o2)),
            (_t(x3), _t(n3), _t(lo)), int(eid))
    cam, lit = _port_buffers(scene, cfg, path)
    return jpath, path, cam, lit


def test_mis_weights_sum_to_one(area_cbox, mis_path):
    """All four splits of a 4-vertex path ending on the area light (light
    tracing, general connection, NEE, unidirectional hit) weight to a
    partition of unity, with the port's own buffer bookkeeping; the
    buffers and weights agree with the JAX package's on the same path."""
    jscene, jcfg, scene, cfg = area_cbox
    jpath, path, cam, lit = mis_path
    w = _port_weights(scene, cfg, cam, lit, path, 4)
    assert all(0.0 <= v <= 1.0 for v in w.values()), w
    assert abs(sum(w.values()) - 1.0) < 1e-3, w
    assert max(w.values()) < 0.999          # more than one strategy counts
    jcam, jlit = _make_buffers(jscene, jcfg, jpath)
    for got, want in ((cam, jcam), (lit, jlit)):
        g = vertex_buffers_to_numpy(got)
        for k in ("pdf_fwd", "pdf_bwd", "pos", "bits", "vtype"):
            np.testing.assert_allclose(g[k], _np(want[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    jw = _strategy_weights(jscene, jcfg, jcam, jlit, jpath, 4)
    for k, v in w.items():
        assert abs(v - jw[k]) < 1e-4, (k, v, jw[k])


def test_mis_weight_perturbation_detected(area_cbox, mis_path):
    """Scaling the stored camera-side area pdf of x2 (the NEE strategy's
    endpoint denominator) must break the partition of unity."""
    _, _, scene, cfg = area_cbox
    _, path, cam, lit = mis_path
    bad = dict(cam)
    bad["pdf_fwd"] = cam["pdf_fwd"].clone()
    bad["pdf_fwd"][2, 0] *= 10.0
    w = _port_weights(scene, cfg, bad, lit, path, 4)
    assert abs(sum(w.values()) - 1.0) > 1e-2, w


# ------------------------------ whole passes ------------------------------

def test_golden_and_jax_pass(cbox):
    jscene, jcfg, scene, cfg = cbox
    img, bins, cnts = B.render_pass_bdpt(scene, _small(cfg),
                                         rng.PRNGKey(42), 1)
    assert bins is None and cnts is None
    _check(img.numpy(), "cbox_bdpt_48.npy")
    ref, _, _ = JB.render_pass_bdpt(jscene, _small(jcfg),
                                    jax.random.PRNGKey(42), jnp.int32(1))
    _close(img.numpy(), ref)


def test_area_light_pass_matches_jax(area_cbox):
    jscene, jcfg, scene, cfg = area_cbox
    img, _, _ = B.render_pass_bdpt(scene, _cut(cfg), rng.PRNGKey(8), 3)
    ref, _, _ = JB.render_pass_bdpt(jscene, _cut(jcfg),
                                    jax.random.PRNGKey(8), jnp.int32(3))
    _close(img.numpy(), ref)
    assert img.mean() > 0.05


def test_null_bsdf_pass_matches_jax():
    """scenes/vpt/cbox.xml: a null-BSDF box of HG medium under an area
    light. The walks take the per-lane slot writes (a null crossing
    advances a ray without placing a vertex) and the connections walk the
    media through the null boundary."""
    jscene, jcfg, scene, cfg = _load(SCENE_DIR + "/vpt/", "cbox.xml")
    assert cfg.has_null_bsdf
    c, jc = _cut(cfg, w=24), _cut(jcfg, w=24)
    img, _, _ = B.render_pass_bdpt(scene, c, rng.PRNGKey(6), 1)
    ref, _, _ = JB.render_pass_bdpt(jscene, jc, jax.random.PRNGKey(6),
                                    jnp.int32(1))
    _close(img.numpy(), ref)
    assert img.mean() > 0.05


def _counts_close(cnts, ref):
    diff = np.abs(cnts.astype(np.int64) - ref)
    assert (diff != 0).mean() <= 1e-4 and diff.max() <= 2, diff.max()


@pytest.mark.parametrize("variant", ["full", "crop_unwarp_modulated"])
def test_transient_pass_matches_jax(trans, variant):
    """trans/cbox-point.xml (400 bins of 0.1 from 8.0, no media: the
    shadow rays take the any-hit kernel's path). The second variant traces
    a crop window only, bins crop-locally, subtracts the camera leg
    (unwarp) and applies the AMCW modulation."""
    jscene, jcfg, scene, cfg = trans
    assert cfg.transient and cfg.t_bins == 400 and not cfg.medium_kinds
    kw = dict(unwarp=True, modulated=True, start_x=6, end_x=22, start_y=10,
              end_y=26) if variant != "full" else {}
    c, jc = _cut(cfg, w=28), _cut(jcfg, w=28)
    c, jc = dataclasses.replace(c, **kw), dataclasses.replace(jc, **kw)
    img, bins, cnts = B.render_pass_bdpt(scene, c, rng.PRNGKey(5), 2)
    ref, rbins, rcnts = JB.render_pass_bdpt(jscene, jc,
                                            jax.random.PRNGKey(5),
                                            jnp.int32(2))
    n = 28 * 28 if variant == "full" else 16 * 16
    assert bins.shape == (n, 400, 3) and cnts.shape == (n, 400)
    _close(img.numpy(), ref)
    _close(bins.numpy(), rbins)
    _counts_close(cnts.numpy(), _np(rcnts))
    assert cnts.sum() > 100
    if variant != "full":
        mask = np.zeros(c.n_pixels, bool)
        mask[B.crop_pix_ids(c).numpy()] = True
        # light-tracing splats are crop-clipped: nothing outside the window
        assert (img.numpy()[~mask] == 0).all() and img[mask].sum() > 0


# ------------------------------- round trips -------------------------------

def test_render_batch_is_the_jax_stream(cbox):
    """BDPT.render_batch = the sum of passes keyed fold_in(sub, i), with
    sub split off the renderer's key, as the JAX package's render_batch;
    the checkpoint key follows it."""
    jscene, jcfg, scene, cfg = cbox
    c = _cut(cfg, w=16, mb=2)
    r = B.BDPT(scene, c, seed=4)
    key0 = r.key
    r.render_batch(2)
    key1, sub = rng.split(key0)
    want = sum(torch.nan_to_num(B.render_pass_bdpt(
        scene, c, rng.fold_in(sub, i), 1 + i)[0], nan=0.0)
        for i in range(2)) / 2
    np.testing.assert_array_equal(r.pixels.reshape(-1, 3).numpy(),
                                  want.numpy())
    jkey, _ = jax.random.split(jax.random.PRNGKey(4))
    np.testing.assert_array_equal(r.get_check_point()["key"],
                                  _np(jax.random.key_data(jkey)
                                      if hasattr(jax.random, "key_data")
                                      else jkey))
    assert r.key == key1 and r.cnt == 2 and r.image().mean() > 0.05


def test_transient_checkpoint_roundtrip(trans):
    _, _, scene, cfg = trans
    c = _cut(cfg, w=12, mb=3)
    r = B.BDPT(scene, c, seed=2)
    r.render()
    r.render()
    chk = r.get_check_point()
    assert chk["time_bins"].shape == (144, 400, 3)
    r2 = B.BDPT(scene, c, seed=0)
    r2.load_check_point(chk)
    r.render()
    r2.render()
    np.testing.assert_array_equal(r2.image(), r.image())
    assert torch.equal(r2.time_cnts, r.time_cnts)
    assert torch.equal(r2.time_bins, r.time_bins)
    frames = r.transient_frames()
    assert frames.shape == (400, 12, 12, 3) and np.isfinite(frames).all()
    bad = dict(chk, t_interval=0.2)
    with pytest.raises(ValueError, match="t_interval"):
        B.BDPT(scene, c).load_check_point(bad)
    steady = dataclasses.replace(c, decomposition="none")
    with pytest.raises(ValueError, match="steady-state"):
        B.BDPT(scene, steady).load_check_point(chk)


def test_bdpt_gate(cbox):
    """BDPT refuses nothing the JAX package's renders.
    csphere/single-ball.xml (Blinn-Phong and specular BRDFs, a sphere area
    light), which it refused until item 9, renders: 12^2, 2 bounces,
    against the JAX render. A grid volume, which it refused until item 14,
    renders: an 8^2 pass of cbox-volgrid.xml (tests/test_torch_volume.py
    holds a pass to the JAX render)."""
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "single-ball.xml",
                               device="cpu")
    B.BDPT(scene, cfg)
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                     "single-ball.xml")
    img, _, _ = B.render_pass_bdpt(scene, _small(cfg, w=12, mb=2),
                                   rng.PRNGKey(42), 1)
    ref, _, _ = JB.render_pass_bdpt(jscene, _small(jcfg, w=12, mb=2),
                                    jax.random.PRNGKey(42), jnp.int32(1))
    _close(img.numpy(), ref)
    assert img.mean() > 0.01
    from adapt_tpu_torch.scene.assets import load_volume
    from test_torch_volume import volume_assets
    volume_assets()
    vscene, vcfg, _ = load_volume(SCENE_DIR + "/cbox/",
                                  "cbox-volgrid.xml", "cpu")
    B.BDPT(vscene, vcfg)
    vimg, _, _ = B.render_pass_bdpt(vscene, _small(vcfg, w=8, mb=2),
                                    rng.PRNGKey(0), 1)
    assert torch.isfinite(vimg).all() and vimg.mean() > 0.01
