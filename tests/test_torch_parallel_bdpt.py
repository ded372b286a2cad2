"""The port's multi-device BDPT (adapt_tpu_torch/parallel/sharding.py) on
gloo CPU ranks.

One spawn of 4 ranks (tests/test_torch_ranks.py `bdpt_body`, one
intra-op thread a rank) renders every case while the JAX package's
MultiChipRenderer renders the same on the suite's virtual CPU devices:

* BDPT on csphere/single-ball.xml over a 4-way 'px' mesh: the t = 1
  splat planes summed over 'px' equal the single-process shards' summed
  by hand (measured equal; bound 1e-6 relative, as gloo may sum the four
  planes in another order), and the JAX package's image within
  tests/test_parallel.py's rtol 1e-4, atol 1e-6;
* the BDPT crop: zero outside the window, the JAX package's inside
  within the same bound;
* transient BDPT over a 4-way 'spp' mesh: the histograms' counts equal
  the sum of the four single-process passes' and the JAX package's; the
  bins and color within tests/test_parallel.py's rtol 2e-5, atol 1e-7 of
  both; a 'px' mesh refused.
"""
import dataclasses
import os

import numpy as np
import pytest

import test_torch_ranks as TR
from adapt_tpu.parallel.sharding import MultiChipRenderer as JaxMultiChip
from adapt_tpu.parallel.sharding import make_mesh as jax_make_mesh
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.renderer.bdpt import render_pass_bdpt

from conftest import SCENE_DIR
from test_torch_parallel import _spawn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's results from the ranks, the JAX package's)."""
    out = str(tmp_path_factory.mktemp("ranks") / "bdpt.npz")
    threads = os.environ.get("OMP_NUM_THREADS")
    wait = _spawn(TR.bdpt_body, 4, out)
    try:
        jax_res = {}
        bs, bc, _ = jax_load_scene(SCENE_DIR + "/csphere/", "single-ball.xml")
        bc = TR.small(bc, 16, 3, world_scattering=False, medium_kinds=(),
                      has_null_bsdf=False)
        px4 = jax_make_mesh(4, spp_parallel=1)
        jax_res["bdpt"] = np.asarray(
            JaxMultiChip(bs, bc, px4, seed=5, bdpt=True).render())
        js, jc, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
        jax_res["crop_bdpt"] = np.asarray(
            JaxMultiChip(js, TR.crop(jc), px4, seed=5, bdpt=True).render())
        ts, tc, _ = jax_load_scene(SCENE_DIR + "/trans/", "cbox-point.xml")
        tc = TR.crop(tc, 4, 12)
        tc = dataclasses.replace(tc, max_bounce=3)
        r = JaxMultiChip(ts, tc, jax_make_mesh(4, spp_parallel=4), seed=11,
                         bdpt=True)
        r.render()
        jax_res.update(tr_color=np.asarray(r.color) / r.cnt,
                       tr_bins=np.asarray(r.time_bins),
                       tr_cnts=np.asarray(r.time_cnts))
        port = wait()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return port, jax_res


def test_bdpt_px_mesh_splat_sum(runs):
    """Pixel-sharded subpaths, the t = 1 splat plane summed over 'px':
    the single-process shards summed by hand (measured equal) and the
    JAX package's image (measured 3.1e-5 absolute, inside rtol 1e-4)."""
    port, jax_res = runs
    scene, cfg, _ = TR.load("csphere", "single-ball.xml")
    cfg = TR.small(cfg, 16, 3, world_scattering=False, medium_kinds=(),
                   has_null_bsdf=False)
    _, sub = rng.split(rng.PRNGKey(5))
    ref = TR.shard_film(scene, cfg, sub, 1, 4).numpy()
    out = port["bdpt"]
    assert np.isfinite(out).all() and out.max() > 0.01
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out, jax_res["bdpt"], rtol=1e-4, atol=1e-6)


def test_crop_bdpt(runs):
    """Only the crop's pixels are sharded: zero outside the window, lit
    inside, the JAX package's within rtol 1e-4 (measured 2.6e-5
    absolute)."""
    port, jax_res = runs
    i = np.arange(16)[:, None]
    j = np.arange(16)[None, :]
    mask = ((i >= 4) & (i < 12) & (j >= 2) & (j < 14)).reshape(-1)
    out = port["crop_bdpt"]
    assert np.isfinite(out).all() and (out[~mask] == 0.0).all()
    assert out[mask].max() > 0.01
    np.testing.assert_allclose(out, jax_res["crop_bdpt"], rtol=1e-4,
                               atol=1e-6)


def test_transient_bdpt_spp_mesh(runs):
    """Four 'spp' ranks: the counts equal the sum of the four
    single-process passes (same folded keys) and the JAX package's; bins
    and color within rtol 2e-5, atol 1e-7 (measured 1.4e-6 and 4.8e-7
    absolute from the JAX package's); a 'px' mesh is refused."""
    port, jax_res = runs
    assert bool(port["tr_px_refused"]) and int(port["tr_cnt"]) == 4
    scene, cfg, _ = TR.load("trans", "cbox-point.xml")
    cfg = dataclasses.replace(TR.crop(cfg, 4, 12), max_bounce=3)
    assert cfg.transient
    sub = rng.split(rng.PRNGKey(11))[1]
    exp_bins = exp_cnts = exp_color = 0
    for i in range(4):
        color, bins, cnts = render_pass_bdpt(scene, cfg,
                                             rng.fold_in(sub, i), 4)
        exp_bins = exp_bins + bins.numpy()
        exp_cnts = exp_cnts + cnts.numpy()
        exp_color = exp_color + np.nan_to_num(color.numpy()) / 4
    assert (port["tr_cnts"] == exp_cnts).all()
    assert (port["tr_cnts"] == jax_res["tr_cnts"]).all()
    assert port["tr_bins"].sum() > 0
    for ref in (exp_bins, jax_res["tr_bins"]):
        np.testing.assert_allclose(port["tr_bins"], ref, rtol=2e-5,
                                   atol=1e-7)
    for ref in (exp_color, jax_res["tr_color"]):
        np.testing.assert_allclose(port["tr_color"], ref, rtol=2e-5,
                                   atol=1e-7)
