"""The port's multi-device renderer (adapt_tpu_torch/parallel/sharding.py)
on gloo CPU ranks: mesh shapes, PT and VPT.

One spawn of 8 ranks (tests/test_torch_ranks.py `pt_vpt_body`, one
intra-op thread a rank) renders every case of this file while the JAX package's
MultiChipRenderer renders the same cases on the suite's 8 virtual CPU
devices (tests/conftest.py):

* PT on cbox over an 8-way 'px' mesh: equal to the port's single-process
  shards (same per-shard keys), and within tests/test_parallel.py's 1e-4
  of the JAX package's image;
* VPT on vpt/cbox.xml over 2 x 4 ('spp' x 'px'), two renders: equal to the
  mean of the two 'spp' groups' single-process shards, within 1e-4 of
  the JAX package's;
* PT with a crop window on a 4-way mesh: zero outside, within 1e-4 of the
  JAX package's inside;
* a checkpoint round trip on a 2 x 2 mesh.

tests/test_torch_parallel_bdpt.py holds BDPT, its crop and transient
BDPT.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_ranks as TR
from adapt_tpu.parallel.sharding import MultiChipRenderer as JaxMultiChip
from adapt_tpu.parallel.sharding import make_mesh as jax_make_mesh
from adapt_tpu.renderer.vpt import trace_vpt as jax_trace_vpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.parallel import sharding
from adapt_tpu_torch.renderer.pt import trace_pt
from adapt_tpu_torch.renderer.vpt import trace_vpt

from conftest import SCENE_DIR

# tests/test_parallel.py's bound between a sharded image and the
# single-device passes; the port's and the JAX package's measured at most
# 2.3e-6 (PT), 4.3e-6 (VPT), 3.6e-7 (crop)
JAX_ATOL = 1e-4


def _spawn(body, world, out):
    """Start `world` gloo ranks on body in the background; returns a
    function that waits for them."""
    os.environ["OMP_NUM_THREADS"] = "1"
    ctx = sharding.run_ranks(body, world, out, device="cpu", join=False)

    def wait():
        while not ctx.join():
            pass
        return dict(np.load(out))
    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's films from the ranks, the JAX package's)."""
    out = str(tmp_path_factory.mktemp("ranks") / "pt_vpt.npz")
    threads = os.environ.get("OMP_NUM_THREADS")
    wait = _spawn(TR.pt_vpt_body, 8, out)
    try:
        jax_res = {}
        js, jc, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
        r = JaxMultiChip(js, TR.small(jc, 32, 2),
                         jax_make_mesh(8, spp_parallel=1), seed=3)
        jax_res["pt"] = np.asarray(r.render())
        vs, vc, _ = jax_load_scene(SCENE_DIR + "/vpt/", "cbox.xml")
        r = JaxMultiChip(vs, TR.small(vc, 16, 2),
                         jax_make_mesh(8, spp_parallel=2),
                         trace_fn=jax_trace_vpt, seed=1)
        r.render()
        jax_res["vpt"] = np.asarray(r.render())
        r = JaxMultiChip(js, TR.crop(jc), jax_make_mesh(4, spp_parallel=1),
                         seed=3)
        jax_res["crop_pt"] = np.asarray(r.render())
        port = wait()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return port, jax_res


def test_mesh_shapes_and_refusals():
    assert sharding.mesh_shape(8) == (2, 4)
    assert sharding.mesh_shape(8, spp_parallel=4) == (4, 2)
    assert sharding.mesh_shape(4) == (2, 2)
    assert sharding.mesh_shape(1) == (1, 1)
    with pytest.raises(ValueError):
        sharding.mesh_shape(6, spp_parallel=4)
    # no process group: the world is this one process
    mesh = sharding.make_mesh()
    assert mesh.shape == {"spp": 1, "px": 1} and mesh.rank == 0
    assert mesh.spp_group is None and mesh.px_group is None
    with pytest.raises(ValueError):
        sharding.make_mesh(2)
    # the JAX package's default split
    assert dict(jax_make_mesh(8).shape) == dict(
        zip(("spp", "px"), sharding.mesh_shape(8)))


def test_pt_px_mesh(runs):
    """8-way pixel sharding: the film equals the single-process shards
    exactly and the JAX package's within 1e-4."""
    port, jax_res = runs
    scene, cfg, _ = TR.load("cbox", "cbox.xml")
    cfg = TR.small(cfg, 32, 2)
    _, sub = rng.split(rng.PRNGKey(3))
    ref = TR.shard_film(scene, cfg, sub, 1, 8, trace_pt)
    assert np.isfinite(port["pt"]).all() and port["pt"].max() > 0.01
    np.testing.assert_array_equal(port["pt"], ref.numpy())
    assert np.abs(port["pt"] - jax_res["pt"]).max() < JAX_ATOL


def test_vpt_spp_px_mesh(runs):
    """2 'spp' groups x 4 'px' shards, two renders: 4 spp, the second
    pass equal to the mean of its groups' single-process shards (a gloo
    sum of two operands rounds as one add), the film within 1e-4 of the
    JAX package's."""
    port, jax_res = runs
    assert int(port["vpt_cnt"]) == 4
    scene, cfg, _ = TR.load("vpt", "cbox.xml")
    cfg = TR.small(cfg, 16, 2)
    key = rng.PRNGKey(1)
    film = torch.zeros((cfg.n_pixels, 3))
    for cnt in (2, 4):
        key, sub = rng.split(key)
        film = film + TR.shard_film(scene, cfg, sub, 2, 4, trace_vpt, cnt)
    assert np.isfinite(port["vpt"]).all() and port["vpt"].max() > 0.01
    np.testing.assert_array_equal(port["vpt"], film.numpy())
    assert np.abs(port["vpt"] - jax_res["vpt"]).max() < JAX_ATOL


def test_crop_pt(runs):
    """A crop window: zero outside it, the single-process shards' pixels
    inside it, within 1e-4 of the JAX package's."""
    port, jax_res = runs
    scene, cfg, _ = TR.load("cbox", "cbox.xml")
    cfg = TR.crop(cfg)
    i = np.arange(16)[:, None]
    j = np.arange(16)[None, :]
    mask = ((i >= 4) & (i < 12) & (j >= 2) & (j < 14)).reshape(-1)
    out = port["crop_pt"]
    assert np.isfinite(out).all() and (out[~mask] == 0.0).all()
    assert out[mask].max() > 0.01
    _, sub = rng.split(rng.PRNGKey(3))
    ref = TR.shard_film(scene, cfg, sub, 1, 4, trace_pt).numpy()
    np.testing.assert_array_equal(out[mask], ref[mask])
    assert np.abs(out - jax_res["crop_pt"]).max() < JAX_ATOL


def test_checkpoint_round_trip(runs):
    """get_check_point after one render, load_check_point into a renderer
    of another seed, one more render: the film and count of a renderer
    that rendered twice; a BDPT renderer refuses the PT checkpoint."""
    port, _ = runs
    assert list(port["ck_cnt"]) == [4, 4]
    np.testing.assert_array_equal(port["ck_resumed"], port["ck_straight"])
    assert bool(port["ck_refused"])


def test_checkpoint_in_process():
    """The checkpoint's schema on the one-process mesh: the JAX package's
    keys, and a mismatch on a config key refused before any change."""
    scene, cfg, _ = TR.load("cbox", "cbox.xml")
    cfg = TR.small(cfg, 8, 1)
    r = sharding.MultiChipRenderer(scene, cfg, sharding.make_mesh(), seed=2)
    r.render()
    chk = r.get_check_point()
    assert chk["renderer"] == "MultiChip-trace_pt" and chk["counter"] == 1
    assert chk["accumulation"].shape == (64, 3)
    other = sharding.MultiChipRenderer(
        scene, dataclasses.replace(cfg, max_bounce=2), sharding.make_mesh())
    with pytest.raises(ValueError):
        other.load_check_point(chk)
    assert other.cnt == 0
    assert r.image().shape == (8, 8, 3)
