"""BDPT's scan-form strategy groups against the JAX package.

The JAX package runs a strategy group flat while it needs at most
FLAT_MAX_CHUNKS chunks of FLAT_LANES // N strategies, and as a `lax.scan`
over its strategies beyond that (adapt_tpu/renderer/bdpt.py:1418-1450):
at full size the `gen` group of cbox-volgrid (640^2, 12 bounces), of the
bunny (800^2, 10) and of the transient cbox-point (512^2, 12). The scan
gives each strategy the ratio-tracking key of its own sub-key, adds its
radiance to the film strategy after strategy and bins it alone. The port
keeps those semantics in its chunks. Small frames always run flat, so
each test sets FLAT_MAX_CHUNKS = 0 in both packages, as
tests/test_bdpt.py's scan test does, and renders with a jit of its own
(the module's jit may hold a trace of the flat form).

* The blocked march: a ratio- or delta-tracking call with a key for each
  block of lanes equals the calls of each block alone, bit for bit, at
  N = 1,024 (one round a block) and 8,192 (rounds of 1,024 a block).
* Whole passes under tests/test_torch_pt.py `_close` (the goldens'
  bounds, as `test_volume_pass_matches_jax_and_golden` holds BDPT on
  cbox-volgrid): cbox-volgrid at 24^2, 3 bounces, and a transient
  trans/cbox-point.xml pass at 24^2, 3 bounces, 8 bins of 5.0 (crop and
  unwarp too), bins and counts as tests/test_torch_bdpt.py holds them.
* The test bites: the flat form's film on cbox-volgrid (the port before
  the scan form) lies outside those bounds from the JAX scan's, measured
  max abs 0.176 and mean 1.55e-3 relative (bounds 5e-2 and 1e-3).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer import bdpt as JB
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.ops import volume_ops as V
from adapt_tpu_torch.renderer import bdpt as B
from adapt_tpu_torch.scene.assets import load_volume
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_goldens import _small
from test_torch_bdpt import _counts_close
from test_torch_pt import _close
from test_torch_volume import _rays, _t, volume_assets

CBOX = SCENE_DIR + "/cbox/"
W, MB = 24, 3


def _jax_pass(jscene, jcfg, seed, cnt):
    """The JAX package's render_pass_bdpt in the scan form, by a jit of
    its own (the module's may hold the flat form's trace of jcfg)."""
    fn = jax.jit(JB.render_pass_bdpt.__wrapped__, static_argnames=("cfg",))
    saved, JB.FLAT_MAX_CHUNKS = JB.FLAT_MAX_CHUNKS, 0
    try:
        out = fn(jscene, jcfg, jax.random.PRNGKey(seed), jnp.int32(cnt))
        return [None if x is None else np.asarray(x) for x in out]
    finally:
        JB.FLAT_MAX_CHUNKS = saved


@pytest.fixture(scope="module")
def volgrid():
    """(port scene, port cfg, the JAX scan form's film) of cbox-volgrid
    at W^2, MB bounces, key 42."""
    volume_assets()
    jscene, jcfg, _ = jax_load_scene(CBOX, "cbox-volgrid.xml")
    scene, cfg, _ = load_volume(CBOX, "cbox-volgrid.xml", "cpu")
    ref = _jax_pass(jscene, _small(jcfg, W, MB), 42, 1)[0]
    return scene, _small(cfg, W, MB), ref


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("track", ["ratio", "delta"])
def test_blocked_march_equals_its_calls(n, track):
    """Three blocks of n lanes, each with its key, in one call: each
    block's outputs equal its own call's, and the record counts the
    blocks and the most rounds of one."""
    volume_assets()
    scene, cfg, _ = load_volume(CBOX, "cbox-volgrid.xml", "cpu")
    vol, kind = scene.volume, cfg.volume_kind
    fn = {"ratio": V.eval_tr_ratio_tracking,
          "delta": V.sample_distance_delta_tracking}[track]
    keys = [rng.PRNGKey(k) for k in (3, 4, 5)]
    blocks = [_rays(scene, n, n + b) for b in range(3)]
    args = [torch.cat([_t(r[i]) for r in blocks]) for i in (0, 1, 3, 2)]
    act = torch.cat([_t(r[4]) for r in blocks])
    with V.record_marches() as calls:
        got = fn(vol, kind, keys, *args, active=act)
    rounds = []
    for b, (key, r) in enumerate(zip(keys, blocks)):
        with V.record_marches() as one:
            want = fn(vol, kind, key, _t(r[0]), _t(r[1]), _t(r[3]),
                      _t(r[2]), active=_t(r[4]))
        rounds.append(one[0]["rounds"])
        lanes = slice(b * n, (b + 1) * n)
        if track == "ratio":
            assert torch.equal(got[lanes], want)
        else:
            assert torch.equal(got[0][lanes], want[0])
            assert torch.equal(got[1][lanes], want[1])
            assert (want[0] > 0).any()
    assert calls[0]["blocks"] == 3 and calls[0]["rounds"] == max(rounds)
    assert (max(rounds) >= 2) == (n > V.COMPACT_MIN)


def test_scan_form_volgrid_matches_jax(volgrid, monkeypatch):
    """cbox-volgrid under the scan form (every group scans): the port's
    film against the JAX package's, and the group forms it took."""
    scene, cfg, ref = volgrid
    monkeypatch.setattr(B, "FLAT_MAX_CHUNKS", 0)
    groups = B._strategy_groups(cfg, cfg.max_bounce)
    assert all(B.scan_form(len(t), cfg.n_pixels) for t in groups.values())
    img = B.render_pass_bdpt(scene, cfg, rng.PRNGKey(42), 1)[0].numpy()
    _close(img, ref)
    assert img.mean() > 0.01


def test_flat_form_misses_the_jax_scan(volgrid):
    """The flat form (FLAT_MAX_CHUNKS as shipped: a 24^2 frame runs flat)
    draws the connections' transmittance from the flat form's one key, so
    its film lies outside the bounds from the JAX scan form's."""
    scene, cfg, ref = volgrid
    assert not B.scan_form(len(B._strategy_groups(cfg, MB)["gen"]),
                           cfg.n_pixels)
    img = B.render_pass_bdpt(scene, cfg, rng.PRNGKey(42), 1)[0].numpy()
    gap = np.abs(img - ref).max()
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert gap >= 5e-2 or rel >= 1e-3, (gap, rel)
    with pytest.raises(AssertionError):
        _close(img, ref)


@pytest.mark.parametrize("variant", ["full", "crop_unwarp"])
def test_scan_form_transient_matches_jax(variant, monkeypatch):
    """trans/cbox-point.xml (cbox with a point light, no media) as a
    transient pass of 8 bins of 5.0 from 8.0 under the scan form: film,
    bins and counts against the JAX package's; the crop variant bins
    crop-locally and subtracts the camera leg."""
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/trans/", "cbox-point.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/trans/", "cbox-point.xml",
                               device="cpu")
    kw = dict(t_bins=8, t_interval=5.0)
    if variant != "full":
        kw.update(unwarp=True, start_x=4, end_x=20, start_y=6, end_y=22)
    c = dataclasses.replace(_small(cfg, W, MB), **kw)
    jc = dataclasses.replace(_small(jcfg, W, MB), **kw)
    assert c.transient and c.t_min == 8.0
    monkeypatch.setattr(B, "FLAT_MAX_CHUNKS", 0)
    img, bins, cnts = B.render_pass_bdpt(scene, c, rng.PRNGKey(5), 2)
    ref, rbins, rcnts = _jax_pass(jscene, jc, 5, 2)
    n = W * W if variant == "full" else 16 * 16
    assert bins.shape == (n, 8, 3) and cnts.shape == (n, 8)
    _close(img.numpy(), ref)
    _close(bins.numpy(), rbins)
    _counts_close(cnts.numpy(), rcnts)
    assert cnts.sum() > 100
