"""The port's apps: utils.tools, `remove_fireflies`, the post-process CLI,
the scene previewer and the multi-device dry run, on the CPU.

* `TicToc`, `timing` and `folder_path` as tests/test_tools.py holds the
  JAX package's;
* `remove_fireflies` equal to the JAX package's on tests/test_imaging.py's
  images and on a noisy film;
* the post-process CLI (`adapt_tpu_torch.post_processing.main`) on a
  .npy film and a PNG;
* `scene_viz`'s frames (normal, depth, direct) at 32^2 against the same
  frames made with the JAX package's functions, the one-shot CLI
  (in-process) with its <lookat> line, and a `--serve` flythrough key
  and frame as tests/test_cli.py drives scene_viz.py;
* `dryrun_multichip(4)`: four gloo ranks, one step of PT, BDPT and
  grid-volume VPT each.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from adapt_tpu.ops.intersect import ray_intersect as jax_ray_intersect
from adapt_tpu.renderer.base import camera_rays as jax_camera_rays
from adapt_tpu.renderer.direct import render_pass_direct as jax_direct
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu.utils.imaging import remove_fireflies as jax_fireflies
from adapt_tpu_torch import scene_viz
from adapt_tpu_torch.dryrun import dryrun_multichip
from adapt_tpu_torch.ops.math3d import fov2focal
from adapt_tpu_torch.scene.compile import load_scene
from adapt_tpu_torch.utils.imaging import remove_fireflies
from adapt_tpu_torch.utils.tools import TicToc, folder_path, timing

from conftest import SCENE_DIR

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="2")
    env.update(kw)
    return env


# --------------------------------- tools -------------------------------------

def test_tictoc():
    t = TicToc()
    time.sleep(0.01)
    dt = t.toc_tic()
    assert 0.005 < dt < 5.0
    assert t.toc() < 1.0


def test_timing_decorator(capsys):
    @timing("lbl")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert "[timing] lbl:" in capsys.readouterr().out


def test_folder_path(tmp_path):
    p = os.path.join(str(tmp_path), "a", "b")
    assert folder_path(p) == p and os.path.isdir(p)


# -------------------------------- fireflies ----------------------------------

def _firefly_images():
    rng = np.random.default_rng(0)
    one = rng.uniform(0.2, 0.4, (32, 32, 3)).astype(np.float32)
    one[16, 16] = 50.0
    noisy = rng.gamma(0.5, 0.3, (48, 40, 3)).astype(np.float32)
    noisy[rng.integers(0, 48, 30), rng.integers(0, 40, 30)] *= 40.0
    return [one, np.full((16, 16, 3), 5.0, np.float32), noisy]


@pytest.mark.parametrize("thresh", [1.5, 3.0])
def test_remove_fireflies_equals_jax(thresh):
    for img in _firefly_images():
        out = remove_fireflies(img, thresh)
        np.testing.assert_array_equal(out, jax_fireflies(img, thresh))
    one = _firefly_images()[0]
    out = remove_fireflies(one, 1.5)
    assert out[16, 16].mean() < 1.0
    mask = np.ones((32, 32), bool)
    mask[16, 16] = False
    assert np.array_equal(out[mask], one[mask])


def test_post_processing_cli(tmp_path, monkeypatch, capsys):
    """A .npy film is cleaned as it is and stays linear; a PNG is read as
    display-encoded RGB; both report the pixels they changed."""
    from adapt_tpu_torch import post_processing
    monkeypatch.chdir(tmp_path)
    img = _firefly_images()[2]
    np.save("film.npy", img)
    post_processing.main(["--input", "film.npy", "--passes", "2"])
    want = jax_fireflies(jax_fireflies(img, 1.5), 1.5)
    changed = int((np.abs(img - want).max(-1) > 1e-6).sum())
    assert f"{changed} firefly pixels cleaned -> film-clean.npy" \
        in capsys.readouterr().out
    np.testing.assert_array_equal(np.load("film-clean.npy"), want)
    from PIL import Image
    u8 = (np.clip(img / img.max() * 8.0, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(u8).save("img.png")
    post_processing.main(["--input", "img.png", "--output", "o/clean.png"])
    back = np.asarray(Image.open(os.path.join("o", "clean.png")))
    want = jax_fireflies(u8.astype(np.float32) / 255, 1.5)
    np.testing.assert_array_equal(back, (want * 255).astype(np.uint8))


# -------------------------------- scene_viz ----------------------------------

@pytest.fixture(scope="module")
def viz():
    """Both packages' cbox at the previewer's settings, 32^2."""
    import dataclasses
    r = 32
    out = []
    for load, kw in ((jax_load_scene, {}), (load_scene, {"device": "cpu"})):
        scene, cfg, configs = load(os.path.join(SCENE_DIR, "cbox"),
                                   "cbox.xml", **kw)
        out += [scene, dataclasses.replace(
            cfg, w=r, h=r, focal=fov2focal(configs["fov"], r), start_x=0,
            end_x=r, start_y=0, end_y=r, anti_alias=False,
            stratified_sampling=False)]
    return out


def _jax_frame(scene, cfg, origin, direction, mode):
    """scene_viz.py's render_frame on the JAX package."""
    import dataclasses
    from adapt_tpu.ops.math3d import np_rotation_between
    cam_r = np_rotation_between(np.float32([0, 0, 1]),
                                direction.astype(np.float32))
    sc = dataclasses.replace(scene, cam_r=jnp.asarray(cam_r),
                             cam_t=jnp.asarray(origin.astype(np.float32)))
    if mode == "direct":
        img, _d, _n = jax_direct(sc, cfg, jax.random.PRNGKey(0),
                                 jnp.int32(0))
        img = np.clip(np.asarray(img), 0.0, 1.0) ** (1 / 2.2)
    else:
        ro, rd = jax_camera_rays(sc, cfg, jax.random.PRNGKey(0),
                                 jnp.int32(0))
        it = jax_ray_intersect(sc, cfg, ro, rd)
        if mode == "normal":
            img = np.asarray(jnp.where(it.is_hit[..., None],
                                       it.n_s * 0.5 + 0.5, 0.0))
        else:
            t = np.asarray(jnp.where(it.is_hit, it.t, 0.0))
            img = np.repeat((t / max(t.max(), 1e-6))[:, None], 3, -1)
    return np.swapaxes(img.reshape(cfg.w, cfg.w, 3), 0, 1)[::-1]


@pytest.mark.parametrize("mode", ["normal", "depth", "direct"])
def test_scene_viz_frames_equal_jax(viz, mode):
    """The scene camera and a moved pose. Measured at most 6.0e-8
    (normal), 2.4e-7 (depth) and 6.0e-7 (direct) apart; bound 1e-5."""
    jscene, jcfg, scene, cfg = viz
    render_frame = scene_viz.frame_renderer(scene, cfg)
    poses = [(scene.cam_t.numpy(),
              scene.cam_r.numpy() @ np.float32([0, 0, 1])),
             (np.float32([2.6, 2.9, -6.5]), np.float32([0.1, -0.05, 1.0]))]
    for origin, direction in poses:
        direction = direction / np.linalg.norm(direction)
        got = render_frame(origin, direction, mode)
        want = _jax_frame(jscene, jcfg, origin, direction, mode)
        assert got.shape == (32, 32, 3) and got.max() > 0.05
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_scene_viz_one_shot(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    scene_viz.main(["--input_path", os.path.join(REPO, "scenes"), "--arch",
                    "cpu", "--res", "32", "--mode", "depth", "--out",
                    "o/v.png", "--origin", "2.78,2.73,-8", "--target",
                    "2.78,2.73,-7"])
    assert '<lookat target="2.78, 2.73, -7" origin="2.78, 2.73, -8" ' \
        'up="0, 1, 0"/>' in capsys.readouterr().out
    from PIL import Image
    img = np.asarray(Image.open(os.path.join("o", "v.png")))
    assert img.shape == (32, 32, 3) and img.max() > 0


def _read_port(proc, marker, lines):
    for line in proc.stdout:
        lines.append(line)
        if marker in line:
            return int(line.rsplit(":", 1)[1].strip().rstrip("/"))
    return None


def test_scene_viz_flythrough(tmp_path):
    """--serve: a key moves the camera and returns the live <lookat>
    line; another turns it; the frame is a PNG (tests/test_cli.py's
    drive of scene_viz.py)."""
    tmp = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "adapt_tpu_torch.scene_viz", "--input_path",
         os.path.join(REPO, "scenes"), "--scene", "cbox", "--name",
         "cbox.xml", "--res", "32", "--arch", "cpu", "--serve", "0"],
        cwd=tmp, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = _read_port(proc, "flythrough: http", lines)
        assert port, "".join(lines)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/key?k=w", timeout=60) as rsp:
            j = json.loads(rsp.read())
        assert "<lookat" in j["lookat"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/key?k=L", timeout=60) as rsp:
            j2 = json.loads(rsp.read())
        assert j2["version"] > j["version"]
        assert j2["lookat"] != j["lookat"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame.png", timeout=60) as rsp:
            png = rsp.read()
        assert png[:4] == b"\x89PNG"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --------------------------------- dry run -----------------------------------

def test_dryrun_multichip():
    dryrun_multichip(4)
