"""The port's textures against the JAX package, op by op and as whole
passes, and BDPT on a reduced textured bunny.

* Op level, on numpy-seeded inputs: `_bilinear`; `query_texture` on
  image and checkerboard records, coordinates that wrap at w - 1, h - 1
  and below 0, and lanes of untextured and missing objects; `get_uv_item`
  on camera hits of a scene whose floor (cbox_floor.obj, with `vt`) and
  sphere carry textures; `process_ns` with a normal map (the floor) and
  a bump map (the sphere). Exactly equal, but `process_ns`'s rotations
  within rtol 1e-5, atol 1e-6 (XLA's fused multiply-adds).
* The compiled tables: every TextureTable leaf, the atlas and `prim_uv`
  equal the JAX package's, on the reduced bunny; the full bunny.xml
  (65,290 triangles, its three JPEG textures) loads with every texture
  and passes the PT, VPT and BDPT gates; BDPT's `tex` vertex plane
  crosses convert.py's layouts unchanged.
* Whole passes at tests/test_goldens.py `_small` settings, key 42: PT on
  cbox with the two-tone floor of tests/test_texture.py (48^2, 3
  bounces) and BDPT on the reduced bunny (bunny.xml with its four
  generated meshes swapped for the tracked 495-face bunny.obj, as
  tests/test_bvh.py does: the textures, glass, the Fresnel blend, three
  spot lights and the HG world kept, on the BVH tier; 48^2, 3 bounces),
  each against the JAX render under tests/test_torch_pt.py `_close` and
  a golden written once from the JAX package (`cbox_tex_pt_48`,
  `bunny_bdpt_48`) under `_check`. Measured: 2.1e-6 and 2.7e-5 max abs
  from the JAX renders.

The scenes read their JPEGs and meshes from scripts/gen_procedural.py,
made here under the lock tests/test_torch_bvh.py makes them under
(`bunny_assets`); every load asserts that each texture it names loaded
(`chip_smoke.load_textured`): a missing file would otherwise render
untextured with only a warning, as the JAX package's loader does.
"""
import dataclasses
import os
import subprocess
import sys
import xml.etree.ElementTree as xet

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from adapt_tpu.ops import texture_ops as jtx
from adapt_tpu.ops.intersect import Interaction as JInteraction
from adapt_tpu.renderer import bdpt as jbdpt, pt as jpt
from adapt_tpu.scene.compile import TextureTable as JTable, \
    load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.convert import scene_leaves, \
    vertex_buffers_from_numpy, vertex_buffers_to_numpy
from adapt_tpu_torch.ops import texture_ops as ttx
from adapt_tpu_torch.ops.intersect import ray_intersect
from adapt_tpu_torch.renderer import bdpt, pt, vpt
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.scene.compile import TextureTable

import chip_smoke
from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_torch_bvh import _asset_lock
from test_torch_pt import _close

RTOL, ATOL = 1e-5, 1e-6


def bunny_assets(meshes=False):
    """The bunny's three JPEGs (and, with meshes, its four generated
    meshes) from scripts/gen_procedural.py, under the procedural meshes'
    lock (chip_smoke.bunny_assets)."""
    with _asset_lock():
        chip_smoke.bunny_assets(meshes=meshes)


def _write_png(path, arr):
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _load_both(directory, file):
    scene, cfg, _ = chip_smoke.load_textured(directory, file, device="cpu")
    jscene, jcfg, _ = jax_load_scene(directory, file)
    return jscene, jcfg, scene, cfg


# ------------------------------- op level -------------------------------

def _tables(g, n_obj=6, size=96):
    """A port table and the JAX one from the same numpy rows: image
    records at offsets in a random atlas, a checkerboard, untextured."""
    atlas = g.uniform(size=(size, size, 3)).astype(np.float32)
    mode = np.array([0, 0, 1, -255, 0, 1], np.int32)[:n_obj]
    w = np.array([32, 17, 0, 0, 96, 0], np.float32)[:n_obj]
    h = np.array([24, 40, 0, 0, 96, 0], np.float32)[:n_obj]
    off_x = np.array([0, 40, 0, 0, 0, 0], np.int32)[:n_obj]
    off_y = np.array([0, 50, 0, 0, 0, 0], np.int32)[:n_obj]
    su = np.array([1.0, 2.5, 3.0, 1.0, 0.5, 1.0], np.float32)[:n_obj]
    sv = np.array([1.0, 0.75, 2.0, 1.0, 1.5, 1.0], np.float32)[:n_obj]
    c1 = g.uniform(size=(n_obj, 3)).astype(np.float32)
    c2 = g.uniform(size=(n_obj, 3)).astype(np.float32)
    rows = dict(mode=mode, off_x=off_x, off_y=off_y, w=w, h=h, scale_u=su,
                scale_v=sv, c1=c1, c2=c2, atlas=atlas)
    return (TextureTable(**{k: torch.from_numpy(v) for k, v in rows.items()},
                         present=True),
            JTable(**{k: jnp.asarray(v) for k, v in rows.items()},
                   present=True))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bilinear_matches_jax():
    g = np.random.default_rng(0)
    table, jtable = _tables(g)
    n = 5000
    x = g.uniform(-1.0, 97.0, n).astype(np.float32)
    y = g.uniform(-1.0, 97.0, n).astype(np.float32)
    x[:8] = [0, 95, 95.5, 96, 0.999999, 94.99999, 47, -0.5]   # edges
    y[:8] = [0, 95, 0.5, 12, 95.5, 95.99, 96, 3]
    _equal(ttx._bilinear(table.atlas, torch.from_numpy(x),
                         torch.from_numpy(y)),
           jtx._bilinear(jtable.atlas, jnp.asarray(x), jnp.asarray(y)))


def test_query_texture_matches_jax():
    """Image and checkerboard records, untextured objects and misses; u, v
    over several periods both ways, and exactly at the wrap: su = k (w-1)
    lands on texel 0, as the reference's float mod does."""
    g = np.random.default_rng(1)
    table, jtable = _tables(g)
    n = 6000
    obj = g.integers(-1, 6, n).astype(np.int32)
    u = g.uniform(-3.0, 3.0, n).astype(np.float32)
    v = g.uniform(-3.0, 3.0, n).astype(np.float32)
    # object 0 (32 x 24, scale 1): u = k (w - 1) / w wraps exactly
    obj[:6] = 0
    u[:6] = np.float32([31 / 32, 62 / 32, -31 / 32, 0.0, 1.0, 0.5])
    v[:6] = np.float32([23 / 24, 0.0, 1.0, -23 / 24, 46 / 24, 0.5])
    got = ttx.query_texture(table, torch.from_numpy(obj),
                            torch.from_numpy(u), torch.from_numpy(v))
    want = jtx.query_texture(jtable, jnp.asarray(obj), jnp.asarray(u),
                             jnp.asarray(v))
    for a, b in zip(got, want):
        _equal(a, b)
    valid = got[1].numpy()
    assert valid.any() and not valid.all()
    assert (got[0].numpy()[~valid] == -1.0).all()
    assert (got[0].numpy()[valid] >= 0.0).all()
    # an untextured tag is free: the sentinel everywhere
    absent = dataclasses.replace(table, present=False)
    color, ok = ttx.query_texture(absent, torch.from_numpy(obj),
                                  torch.from_numpy(u), torch.from_numpy(v))
    assert (color == -1.0).all() and not ok.any()


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """cbox with a two-tone albedo and a normal map on the floor and a
    sphere with the albedo and a bump map: both packages' scenes, and the
    port's camera hits at 32^2 as numpy arrays."""
    tmp = str(tmp_path_factory.mktemp("mapped"))
    chip_smoke.twotone_cbox(tmp)
    g = np.random.default_rng(7)
    _write_png(os.path.join(tmp, "nmap.png"),
               g.uniform(0.2, 1.0, (40, 56, 3)).astype(np.float32))
    _write_png(os.path.join(tmp, "bmap.png"),
               g.uniform(0.2, 1.0, (48, 32, 3)).astype(np.float32))
    tree = xet.parse(os.path.join(tmp, "scene.xml"))
    root = tree.getroot()
    chip_smoke.add_texture(root, "nmap", os.path.join(tmp, "nmap.png"),
                            "normal")
    chip_smoke.add_texture(root, "bmap", os.path.join(tmp, "bmap.png"),
                            "bump")
    chip_smoke.ref_texture(chip_smoke.floor_shape(root), "nmap", "normal")
    ball = xet.SubElement(root, "shape", {"type": "sphere"})
    xet.SubElement(ball, "point", {"name": "center", "x": "3.8", "y": "3.6",
                                   "z": "1.5"})
    xet.SubElement(ball, "float", {"name": "radius", "value": "0.9"})
    xet.SubElement(ball, "ref", {"type": "material", "id": "box"})
    chip_smoke.ref_texture(ball, "twotone")
    chip_smoke.ref_texture(ball, "bmap", "bump")
    tree.write(os.path.join(tmp, "scene.xml"))
    jscene, jcfg, scene, cfg = _load_both(tmp, "scene.xml")
    assert cfg.has_normal_map and cfg.has_bump_map
    c = dataclasses.replace(cfg, w=32, h=32, focal=cfg.focal * 32 / 512,
                            end_x=32, end_y=32)
    ro, rd = camera_rays(scene, c, rng.PRNGKey(3), 1)
    it = ray_intersect(scene, c, ro, rd)
    arrays = {f.name: getattr(it, f.name).numpy()
              for f in dataclasses.fields(it) if f.name != "tex"}
    return jscene, jcfg, scene, cfg, arrays


def _interactions(arrays):
    from adapt_tpu_torch.ops.intersect import Interaction
    return (Interaction(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
            JInteraction(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         tex=None))


def test_get_uv_item_matches_jax(mapped):
    """Floor triangles interpolate their `vt` uvs; sphere hits take their
    local uv; other objects and misses are untextured."""
    jscene, _, scene, _, arrays = mapped
    it, jit = _interactions(arrays)
    sphere = scene.obj_is_sphere.numpy()[np.maximum(arrays["obj_id"], 0)]
    floor_obj = int(np.nonzero(scene.tex["normal"].mode.numpy() == 0)[0][0])
    hits = arrays["obj_id"]
    assert ((hits >= 0) & (sphere > 0)).sum() > 20
    assert (hits == floor_obj).sum() > 20
    for tag in ("albedo", "normal", "bump"):
        got = ttx.get_uv_item(scene, scene.tex[tag], it)
        want = jtx.get_uv_item(jscene, jscene.tex[tag], jit)
        for a, b in zip(got, want):
            _equal(a, b)
        assert got[1].any()


def test_process_ns_matches_jax(mapped):
    jscene, jcfg, scene, cfg, arrays = mapped
    it, jit = _interactions(arrays)
    for normal, bump in ((True, False), (False, True), (True, True)):
        c = dataclasses.replace(cfg, has_normal_map=normal,
                                has_bump_map=bump)
        jc = dataclasses.replace(jcfg, has_normal_map=normal,
                                 has_bump_map=bump)
        got = ttx.process_ns(scene, c, it).n_s.numpy()
        want = np.asarray(jtx.process_ns(jscene, jc, jit).n_s)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert (np.abs(got - arrays["n_s"]).max(-1) > 1e-3).sum() > 20
    plain = dataclasses.replace(cfg, has_normal_map=False,
                                has_bump_map=False)
    assert ttx.process_ns(scene, plain, it) is it


# ------------------------------ the tables ------------------------------

@pytest.fixture(scope="module")
def rbunny(tmp_path_factory):
    bunny_assets()
    return _load_both(*chip_smoke.reduced_bunny(
        str(tmp_path_factory.mktemp("rb"))))


def test_tables_equal_jax(rbunny):
    """Every texture leaf (the 720^2 albedo atlas of the three 256^2
    JPEGs included), the vertex uvs and the rest, leaf for leaf."""
    jscene, jcfg, scene, cfg = rbunny
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "big_tier"} == dataclasses.asdict(jcfg)
    got, want = scene_leaves(scene), scene_leaves(jscene)
    assert got.keys() == want.keys() and "tex.albedo.atlas" in want
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert scene.tex["albedo"].atlas.shape == (720, 720, 3)
    assert scene.prim_uv.shape == (scene.n_prims, 3, 2)
    assert cfg.use_bvh


def test_bunny_assets_import_no_jax():
    """chip_smoke.py writes the bunny's meshes and JPEGs with
    scripts/gen_procedural.py's `ensure_at` and `ensure_texture` (numpy
    and PIL) without loading the JAX package."""
    code = ("import fcntl, os, sys; import chip_smoke; "
            "d = os.path.join('scenes', 'meshes', 'procedural'); "
            "os.makedirs(d, exist_ok=True); "
            "fh = open(os.path.join(d, '.lock'), 'w'); "
            "fcntl.flock(fh, fcntl.LOCK_EX); chip_smoke.bunny_assets(); "
            "bad = [m for m in sys.modules if m in ('jax', 'adapt_tpu') "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=chip_smoke.ROOT,
                   check=True, timeout=300)


def test_bunny_takes_every_renderer():
    """The full bunny.xml at its own settings: the textures load, the
    BVH tier holds its 65,290 triangles, and PT's, VPT's and BDPT's
    renderers take it (at 8^2)."""
    bunny_assets(meshes=True)
    scene, cfg, _ = chip_smoke.load_textured(
        os.path.join(SCENE_DIR, "cbox"), "bunny.xml", device="cpu")
    assert scene.n_prims == 65290 and cfg.use_bvh
    assert (cfg.w, cfg.h, cfg.max_bounce) == (800, 800, 10)
    assert cfg.brdf_types == (1, 5) and cfg.bsdf_types == (0,)
    assert cfg.emitter_kinds == (2,) and cfg.world_scattering
    small = dataclasses.replace(cfg, w=8, h=8, end_x=8, end_y=8)
    for make in (pt.Renderer, vpt.VolumeRenderer, bdpt.BDPT):
        assert make(scene, small).cnt == 0


def test_vertex_buffers_carry_the_tex_plane():
    """BDPT vertex buffers of a textured scene cross from the JAX layout
    (tex (3, D, N)) to the port's ((D, N, 3)) and back unchanged, and the
    port's own textured buffers have that layout, filled with -1."""
    g = np.random.default_rng(5)
    jbuf = {k: (np.asarray(v) if v is None else
                g.uniform(-1, 1, np.shape(v)).astype(np.asarray(v).dtype))
            for k, v in jbdpt._vertex_buffers(7, 4, True).items()}
    buf = vertex_buffers_from_numpy(jbuf, device="cpu")
    assert buf["tex"].shape == (4, 7, 3)
    np.testing.assert_array_equal(buf["tex"].numpy(),
                                  np.moveaxis(jbuf["tex"], 0, -1))
    back = vertex_buffers_to_numpy(buf)
    for k, v in jbuf.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    own = bdpt._vertex_buffers(7, 4, "cpu", has_tex=True)
    assert own["tex"].shape == (4, 7, 3) and (own["tex"] == -1.0).all()
    assert bdpt._vertex_buffers(7, 4, "cpu")["tex"] is None


# ----------------------------- whole passes -----------------------------

def test_textured_cbox_pt_pass_matches_jax_and_golden(tmp_path):
    jscene, jcfg, scene, cfg = _load_both(
        *chip_smoke.twotone_cbox(str(tmp_path)))
    img = pt.render_pass_pt(scene, _small(cfg), rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), "cbox_tex_pt_48.npy")
    ref = jpt.render_pass_pt(jscene, _small(jcfg), jax.random.PRNGKey(42),
                             jnp.int32(1))
    _check(ref, "cbox_tex_pt_48.npy")
    _close(img.numpy(), ref)
    # the floor shows both tones (tests/test_texture.py's check)
    floor = img.numpy().reshape(48, 48, 3)[:, :12].reshape(-1, 3)
    lit = floor[floor.max(-1) > 0.01]
    assert (lit[:, 0] > 2 * lit[:, 2]).mean() > 0.1
    assert (lit[:, 2] > 2 * lit[:, 0]).mean() > 0.1


def test_reduced_bunny_bdpt_pass_matches_jax_and_golden(rbunny):
    jscene, jcfg, scene, cfg = rbunny
    img, _, _ = bdpt.render_pass_bdpt(scene, _small(cfg), rng.PRNGKey(42), 1)
    assert not torch.isnan(img).any()
    _check(img.numpy(), "bunny_bdpt_48.npy")
    ref, _, _ = jbdpt.render_pass_bdpt(jscene, _small(jcfg),
                                       jax.random.PRNGKey(42), jnp.int32(1))
    _check(ref, "bunny_bdpt_48.npy")
    _close(img.numpy(), ref)
    # the same pass without its textures differs on the textured floor
    plain = dataclasses.replace(scene, tex={
        k: dataclasses.replace(t, present=False)
        for k, t in scene.tex.items()})
    img0, _, _ = bdpt.render_pass_bdpt(plain, _small(cfg), rng.PRNGKey(42),
                                       1)
    assert (img - img0).abs().max() > 1e-2
