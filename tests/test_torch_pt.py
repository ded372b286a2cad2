"""The port's path tracer against the goldens and the JAX package.

Same scene, same key, same settings: camera rays, a golden-setting pass,
and progressive Renderer calls must agree with JAX under the goldens'
`_check` bounds (mean within 1e-3 relative, every pixel within 5e-2).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer import pt as jpt
from adapt_tpu.renderer.base import camera_rays as jax_camera_rays
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.convert import key_from_numpy
from adapt_tpu_torch.ops import intersect_kernels, splat
from adapt_tpu_torch.renderer import bdpt, pt
from adapt_tpu_torch.renderer.base import camera_rays, crop_pix_ids
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _check, _small

REPO = os.path.join(os.path.dirname(__file__), "..")


def _close(img, ref):
    """tests/test_goldens.py `_check` against an array instead of a file."""
    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3)
    assert np.abs(img - ref).max() < 5e-2, np.abs(img - ref).max()


@pytest.fixture(scope="module")
def cbox():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return jscene, jcfg, scene, cfg


@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("cnt", [1, 6])
def test_camera_rays_equal_jax(cbox, stratified, cnt):
    jscene, jcfg, scene, cfg = cbox
    w, h = 24, 16
    kw = dict(w=w, h=h, focal=cfg.focal * w / 512, end_x=w, end_y=h,
              stratified_sampling=stratified)
    jkey = jax.random.PRNGKey(cnt + 3)
    jo, jd = jax_camera_rays(jscene, dataclasses.replace(jcfg, **kw), jkey,
                             jnp.int32(cnt))
    o, d = camera_rays(scene, dataclasses.replace(cfg, **kw),
                       key_from_numpy(jkey), cnt)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    # jitter and pinhole math are bit-equal; XLA fuses the 3x3 rotation's
    # multiply-adds on the CPU, so directions agree to an f32 ULP
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=3e-7)


def test_golden_and_jax_pass(cbox):
    jscene, jcfg, scene, cfg = cbox
    img = pt.render_pass_pt(scene, _small(cfg), rng.PRNGKey(42), 1)
    _check(img.numpy(), "cbox_pt_48.npy")
    ref = jpt.render_pass_pt(jscene, _small(jcfg), jax.random.PRNGKey(42),
                             jnp.int32(1))
    _close(img.numpy(), ref)


def _progressive_cfg(cfg, w=24):
    """Jittered, stratified, russian roulette from bounce 2 on."""
    return dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                               end_x=w, end_y=w, max_bounce=4,
                               rr_bounce_th=2)


def test_renderer_render_matches_jax(cbox):
    jscene, jcfg, scene, cfg = cbox
    jr = jpt.Renderer(jscene, _progressive_cfg(jcfg), seed=3)
    r = pt.Renderer(scene, _progressive_cfg(cfg), seed=3)
    for _ in range(2):
        jr.render()
        r.render()
        _close(r.image(), jr.image())
        assert r.cnt == jr.cnt
    jchk, chk = jr.get_check_point(), r.get_check_point()
    assert chk.keys() == jchk.keys()
    np.testing.assert_array_equal(chk["key"], jchk["key"])
    assert r.image().mean() > 0.05


def test_render_batch_and_checkpoint(cbox):
    """render_batch draws the JAX package's fuse=1 stream; a checkpoint
    resumes it exactly."""
    jscene, jcfg, scene, cfg = cbox
    jr = jpt.Renderer(jscene, _progressive_cfg(jcfg, 16), seed=5)
    r = pt.Renderer(scene, _progressive_cfg(cfg, 16), seed=5)
    jr.render_batch(2)
    r.render_batch(2)
    _close(r.image(), jr.image())
    np.testing.assert_array_equal(r.get_check_point()["key"],
                                  jr.get_check_point()["key"])
    r2 = pt.Renderer(scene, _progressive_cfg(cfg, 16), seed=0)
    r2.load_check_point(r.get_check_point())
    r.render()
    r2.render()
    np.testing.assert_array_equal(r2.image(), r.image())
    with pytest.raises(ValueError, match="mismatch"):
        pt.Renderer(scene, _progressive_cfg(cfg, 8)).load_check_point(
            r.get_check_point())


def test_knot_scene_pass_matches_jax():
    """The BVH tier end to end: knot2k-test (2,000 triangles, a sphere
    and the cbox walls) at 24^2 and its own 12 bounces, RR and MIS on."""
    from test_torch_bvh import knot_assets
    knot_assets()
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml",
                               device="cpu")
    kw = dict(w=24, h=24, focal=cfg.focal * 24 / 512, end_x=24, end_y=24)
    assert cfg.max_bounce == 12 and cfg.use_bvh
    ref = jpt.render_pass_pt(jscene, dataclasses.replace(jcfg, **kw),
                             jax.random.PRNGKey(9), jnp.int32(1))
    img = pt.render_pass_pt(scene, dataclasses.replace(cfg, **kw),
                            rng.PRNGKey(9), 1)
    _close(img.numpy(), ref)
    assert img.mean() > 0.05


def test_crop_window(cbox):
    _, _, scene, cfg = cbox
    cfg = dataclasses.replace(_small(cfg, 16), start_x=4, end_x=12,
                              start_y=2, end_y=6)
    ids = crop_pix_ids(cfg)
    assert ids.shape == (32,)
    img = pt.render_pass_pt(scene, cfg, rng.PRNGKey(1), 1)
    mask = torch.zeros(cfg.n_pixels, dtype=torch.bool)
    mask[ids] = True
    assert (img[~mask] == 0).all() and img[mask].sum() > 0


def test_cpu_path_uses_twins_not_kernels(cbox):
    """PT, and BDPT (whose walks, visibility and film splat reach the
    closest-hit, media-walk and film-splat wrappers), on CPU tensors take
    the plain versions: no kernel launches."""
    _, _, scene, cfg = cbox
    intersect_kernels.reset_launches()
    splat.reset_launches()
    pt.render_pass_pt(scene, _small(cfg, 8), rng.PRNGKey(0), 1)
    img, _, _ = bdpt.render_pass_bdpt(
        scene, dataclasses.replace(_small(cfg, 8), max_bounce=2),
        rng.PRNGKey(0), 1)
    assert img.device.type == "cpu" and torch.isfinite(img).all()
    assert intersect_kernels.launches == {"tri_closest_hit": 0,
                                          "tri_any_hit": 0,
                                          "tri_track_hits": 0}
    assert splat.launches == {"splat_sorted_accumulate": 0}


def test_port_imports_no_jax():
    code = ("import sys; import adapt_tpu_torch.renderer.pt, "
            "adapt_tpu_torch.renderer.vpt, adapt_tpu_torch.ops.medium_ops, "
            "adapt_tpu_torch.renderer.bdpt, adapt_tpu_torch.ops.splat, "
            "adapt_tpu_torch.convert, adapt_tpu_torch.profile_pt; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chip_smoke_mesh_step_imports_no_jax():
    """chip_smoke.py's set-up writes knot290k's mesh without loading the
    JAX package (scripts/gen_procedural.py's `ensure_all` would, through
    its volume writer). Holds the lock tests/test_torch_bvh.py generates
    the meshes under."""
    code = ("import fcntl, os, sys; import chip_smoke; "
            "d = os.path.join('scenes', 'meshes', 'procedural'); "
            "os.makedirs(d, exist_ok=True); "
            "fh = open(os.path.join(d, '.lock'), 'w'); "
            "fcntl.flock(fh, fcntl.LOCK_EX); chip_smoke.knot_mesh(); "
            "assert os.path.getsize(os.path.join(d, 'knot290k.obj')) > 0; "
            "bad = [m for m in sys.modules if m in ('jax', 'adapt_tpu') "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
