"""The port's media-walk intersection against the JAX package's.

* `ray_track_hits` (kernel B3's twin plus the sphere roots) against the
  JAX one, whose triangle part is the Pallas kernel `_track_kernel` run in
  interpret mode with use_pallas=True, as tests/test_khit.py runs it:
  object ids and overflow exactly equal; t and dn within rtol 1e-6. XLA
  on the CPU fuses the dots' multiply-adds (tests/test_torch_intersect.py),
  which moves each dot by an ULP of its terms: dn gets an atol of 2e-7
  (unit-sized terms), and a triangle hit's t the bound `_fma_bounds`
  propagates through t = (d - o.n) / (dir.n) for its row.
* B3's output contract on hand-made rays through the vpt cbox's null box.
* `track_ray`'s K-hit walk against the JAX track_ray (same walk, interpret
  mode) and the port's own sequential `_track_loop`, on the vpt cbox and
  on tests/test_khit.py's eps-layered two-box scene, and the forced K = 1
  overflow fallback.
* The CUDA kernel against its twin (needs the card; skips here).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import intersect_pallas
from adapt_tpu.ops.intersect import ray_track_hits as jax_ray_track_hits
from adapt_tpu.renderer.vpt import track_ray as jax_track_ray
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch.ops import _build, intersect_kernels
from adapt_tpu_torch.ops.intersect import FAR, RAY_EPS, _is_null_obj, \
    ray_k_hits, ray_track_hits
from adapt_tpu_torch.renderer import vpt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR
from test_khit import _EPS_XML, _cube_obj
from test_torch_intersect import _fma_bounds

NAMES = ("t_null", "obj_null", "dn_null", "t_blk", "obj_blk", "dn_blk",
         "overflow")


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    old = intersect_pallas._INTERPRET
    intersect_pallas._INTERPRET = True
    yield
    intersect_pallas._INTERPRET = old


_SCENES = {}


def _scenes(folder, xml):
    """(JAX scene, JAX cfg with use_pallas, port scene, port cfg), loaded
    once per module."""
    if (folder, xml) not in _SCENES:
        js, jc, _ = jax_load_scene(f"{SCENE_DIR}/{folder}/", xml)
        s, c, _ = load_scene(f"{SCENE_DIR}/{folder}/", xml, device="cpu")
        _SCENES[folder, xml] = (js, dataclasses.replace(jc, use_pallas=True),
                                s, c)
    return _SCENES[folder, xml]


def _rand_rays(scene, n, seed):
    """numpy rays: origins uniform in the scene's box grown by 10%, unit
    directions (as tests/test_khit.py:39-47)."""
    g = np.random.default_rng(seed)
    lo = scene.obj_aabb_min.numpy().min(0)
    hi = scene.obj_aabb_max.numpy().max(0)
    o = g.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                  (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _t_slack(scene, o, d, t):
    """Per-element FMA bound of hit distances t ((K,N) or (N,)): the
    triangle row whose twin t equals it, through `_fma_bounds`; 0 where
    no triangle gives it (misses, sphere roots)."""
    geo = intersect_kernels.tri_table(scene)[0]
    tt, _u, _v, valid = intersect_kernels._hit_tables(
        geo, torch.from_numpy(o), torch.from_numpy(d))
    out = []
    for tk in np.atleast_2d(t):
        match = (valid & (tt == torch.from_numpy(tk)[:, None])).numpy()
        row = np.where(match.any(1), match.argmax(1), -1)
        out.append(_fma_bounds(scene, o, d, row, tk)[0])
    return np.reshape(out, np.shape(t))


def _assert_track_close(got, want, scene=None, o=None, d=None):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype != np.float32:
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        slack = 2e-7 if name.startswith("dn") else (
            0.0 if scene is None else _t_slack(scene, o, d, a))
        err = np.abs(a.astype(np.float64) - b)
        assert (err <= 1e-6 * np.abs(b) + slack).all(), (name, err.max())


@pytest.mark.parametrize("case", [
    ("vpt", "cbox.xml", 2, False),
    ("cbox", "cbox.xml", 7, True),
    ("csphere", "single-ball.xml", 7, True),
    ("csphere", "single-ball.xml", 2, False),
], ids=["vpt-K2", "cbox-allnull-K7", "csphere-allnull-K7", "csphere-K2"])
def test_ray_track_hits_matches_jax(case):
    folder, xml, K, all_null = case
    js, jc, s, c = _scenes(folder, xml)
    o, d = _rand_rays(s, 400, seed=K + len(folder))
    g = np.random.default_rng(5)
    max_t = g.uniform(0.5, 9.0, o.shape[0]).astype(np.float32)
    alive = g.uniform(size=o.shape[0]) > 0.15
    want = jax_ray_track_hits(js, jc, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(max_t), alive=jnp.asarray(alive),
                              K=K, all_null=all_null)
    got = ray_track_hits(s, c, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(max_t),
                         alive=torch.from_numpy(alive), K=K,
                         all_null=all_null)
    _assert_track_close(got, want, s, o, d)
    # real work compared: interfaces or blockers found, dead lanes empty
    found = (got[0].numpy()[0] < FAR) | (got[3].numpy() < FAR)
    assert found.mean() > 0.3
    if folder == "vpt":
        assert (got[0].numpy()[0] < FAR).any()
    assert (got[0].numpy()[:, ~alive] == np.float32(FAR)).all()
    assert not got[6].numpy()[~alive].any()
    if all_null:
        np.testing.assert_array_equal(
            got[0].numpy(),
            ray_k_hits(s, c, torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(max_t), alive=torch.from_numpy(alive),
                       K=K)[0].numpy())


def _down_rays(scene):
    """Four rays straight down from y = 3 through the null box's top
    (y 1.6501) and bottom (y 1e-4) onto the floor (y 0)."""
    null_obj = int(torch.nonzero(scene.mat_is_bsdf
                                 & (scene.mat_type < 0))[0, 0])
    lo = scene.obj_aabb_min[null_obj].numpy()
    hi = scene.obj_aabb_max[null_obj].numpy()
    c = 0.5 * (lo + hi)
    xz = [(0.1, 0.05), (-0.2, 0.1), (0.05, -0.25), (0.15, 0.2)]
    o = np.array([[c[0] + a, 3.0, c[2] + b] for a, b in xz], np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (len(xz), 1))
    return null_obj, o, d


def test_track_hits_contract():
    """B3's outputs on rays whose interfaces are known: the box's top and
    bottom (null) then the floor (the blocker)."""
    js, jc, s, c = _scenes("vpt", "cbox.xml")
    null_obj, o, d = _down_rays(s)
    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    flags = _is_null_obj(s, s.tri_obj)
    assert torch.equal(s.tri_null, flags)
    n = o.shape[0]

    def run(far, K):
        return intersect_kernels.tri_track_hits(s, ro, rd, far, K)

    # K = 3: top (entering, dn < 0), bottom (leaving), one empty slot; the
    # floor blocks at t = 3
    t, obj, dn, tb, ob, db, ov = run(torch.full((n,), FAR), 3)
    np.testing.assert_allclose(t[0].numpy(), 3.0 - 1.6501, rtol=1e-5)
    np.testing.assert_allclose(t[1].numpy(), 3.0 - 1e-4, rtol=1e-6)
    assert (obj[:2] == null_obj).all() and (dn[0] < 0).all() \
        and (dn[1] > 0).all()
    assert (t[2] == FAR).all() and (obj[2] == -1).all() and (dn[2] == 0).all()
    np.testing.assert_allclose(tb.numpy(), 3.0, rtol=1e-6)
    assert (ob == 1).all() and (db < 0).all() and not ov.any()
    # K = 1: the bottom is left over before the blocker -> overflow
    assert run(torch.full((n,), FAR), 1)[6].all()
    # far before the box: nothing; the blocker reports FAR, not far0
    t, obj, dn, tb, ob, db, ov = run(torch.full((n,), 1.0), 2)
    assert (t == FAR).all() and (obj == -1).all() and (dn == 0).all()
    assert (tb == FAR).all() and (ob == -1).all() and (db == 0).all()
    assert not ov.any()
    # far between the interfaces: the top only, no blocker
    t, obj, dn, tb, ob, db, ov = run(torch.full((n,), 2.0), 2)
    assert (t[0] < 2.0).all() and (t[1] == FAR).all() and (tb == FAR).all()
    # dead lanes: no hits, no overflow
    t, obj, dn, tb, ob, db, ov = run(torch.full((n,), -3e38), 1)
    assert (t == FAR).all() and (tb == FAR).all() and not ov.any()
    # the same contract in the Pallas kernel
    for far, K in ((FAR, 3), (1.0, 2), (-3e38, 1)):
        far_t = np.full(n, far, np.float32)
        want = intersect_pallas.tri_track_hits(
            js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far_t), K,
            jnp.asarray(flags.numpy()))
        _assert_track_close(run(torch.from_numpy(far_t), K), want, s, o, d)


def _depth_rays(scene, n, seed):
    o, d = _rand_rays(scene, n, seed)
    return o, d, np.full(n, 6.0, np.float32), np.arange(n) % 5 != 0


def test_track_ray_khit_matches_jax_and_loop():
    js, jc, s, c = _scenes("vpt", "cbox.xml")
    o, d, depth, active = _depth_rays(s, 128, 7)
    tr_j, acc_j = jax_track_ray(js, jc, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(depth),
                                active=jnp.asarray(active))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(depth))
    act = torch.from_numpy(active)
    tr, acc = vpt.track_ray(s, c, *args, active=act)
    np.testing.assert_allclose(tr.numpy()[active], np.asarray(tr_j)[active],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc.numpy()[active],
                               np.asarray(acc_j)[active], rtol=1e-5,
                               atol=1e-6)
    # the sequential walk: same transmittance up to the global-t rounding
    tr_l, acc_l = vpt._track_loop(s, c, *args, act)
    np.testing.assert_allclose(tr.numpy()[active], tr_l.numpy()[active],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(acc.numpy()[active], acc_l.numpy()[active],
                               rtol=1e-4, atol=1e-5)
    assert (tr.numpy()[active] == 0).any() and (tr.numpy() < 1).any()


def test_track_khit_overflow_falls_back(monkeypatch):
    """K forced to 1: lanes crossing the null box's two interfaces
    overflow the extraction and re-walk through the exact sequential
    loop, which runs only on those lanes."""
    js, jc, s, c = _scenes("vpt", "cbox.xml")
    o, d, depth, _ = _depth_rays(s, 128, 11)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(depth))
    c1 = dataclasses.replace(c, n_null_objs=0)          # K = 1
    ovf = ray_track_hits(s, c1, *args, K=1)[6]
    assert ovf.any()
    walked = []
    loop = vpt._track_loop

    def spy(scene, cfg, start_p, ray_d, dep, active):
        walked.append(active.clone())
        return loop(scene, cfg, start_p, ray_d, dep, active)

    monkeypatch.setattr(vpt, "_track_loop", spy)
    tr, acc = vpt.track_ray(s, c1, *args)
    assert len(walked) == 1 and torch.equal(walked[0], ovf)
    tr_l, acc_l = loop(s, c, *args, None)
    np.testing.assert_allclose(tr.numpy(), tr_l.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), acc_l.numpy(), rtol=1e-4,
                               atol=1e-5)
    # the JAX package's sequential walk agrees too
    tr_j, acc_j = jax_track_ray(js, dataclasses.replace(jc, use_pallas=False),
                                jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(depth))
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_j), rtol=1e-4,
                               atol=1e-6)


def test_track_khit_eps_layered_nulls(tmp_path):
    """Null interfaces exactly RAY_EPS apart (tests/test_khit.py:238-283):
    the chain accepts the second one with CHAIN_SEP = 0.5 RAY_EPS headroom,
    with no overflow, and agrees with the sequential walk and the JAX
    package's K-hit walk."""
    (tmp_path / "boxA.obj").write_text(_cube_obj(0.0, 1.0))
    (tmp_path / "boxB.obj").write_text(_cube_obj(1.0 + RAY_EPS, 2.0))
    (tmp_path / "scene.xml").write_text(_EPS_XML)
    js, jc, _ = jax_load_scene(str(tmp_path), "scene.xml")
    s, c, _ = load_scene(str(tmp_path), "scene.xml", device="cpu")
    assert c.n_null_objs == 2
    n = 64
    g = np.random.default_rng(23)
    o = np.stack([np.full(n, -0.5), g.uniform(0.1, 0.9, n),
                  g.uniform(0.1, 0.9, n)], -1).astype(np.float32)
    d = np.stack([np.ones(n), g.uniform(-0.05, 0.05, n),
                  g.uniform(-0.05, 0.05, n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = np.full(n, 4.0, np.float32)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(depth))
    assert not ray_track_hits(s, c, *args, K=2 * c.n_null_objs)[6].any()
    tr, acc = vpt.track_ray(s, c, *args)
    tr_l, acc_l = vpt._track_loop(s, c, *args, None)
    np.testing.assert_allclose(tr.numpy(), tr_l.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), acc_l.numpy(), rtol=1e-4,
                               atol=1e-5)
    tr_j, acc_j = jax_track_ray(js, dataclasses.replace(jc, use_pallas=True),
                                jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(depth))
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-5,
                               atol=1e-6)
    assert (acc.numpy() > 4.0).all()          # boxB's ior 1.2 was crossed


def test_track_hits_refuses_other_tiers_and_devices():
    _, _, s, c = _scenes("vpt", "cbox.xml")
    ro = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        intersect_kernels.tri_track_hits(s, ro, ro, ro[:, 0], 2)
    with pytest.raises(ValueError, match="K must be"):
        intersect_kernels.tri_track_hits(s, ro, ro, ro[:, 0], 0)
    with pytest.raises(ValueError, match="brute-force"):
        ray_track_hits(dataclasses.replace(s, tri_n=s.tri_n[:0]), c,
                       torch.zeros((4, 3)), torch.ones((4, 3)), None)


@pytest.mark.cuda
def test_track_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, s, c = _scenes("vpt", "cbox.xml")
    o, d = _rand_rays(s, 5000, 3)
    far = np.random.default_rng(3).uniform(-1.0, 9.0, 5000).astype(np.float32)
    far[::7] = -3e38
    dev = s.to("cuda")
    args = [torch.from_numpy(x).cuda() for x in (o, d, far)]
    before = _build.launches["intersect_kernels"]["tri_track_hits"]
    # the scene's null rows, every row null (above the kernel's null-row
    # cap), and the null rows layered at and above the cap: exact
    # duplicates and copies RAY_EPS behind (chip_smoke.py `null_layers`)
    from test_torch_bvh import _smoke
    from adapt_tpu_torch.scene import compile as C
    smoke = _smoke()
    cap = intersect_kernels.NULL_CAP
    dup = min(12, cap - 12)
    cases = [(dev, 2, False), (dev, 7, True),
             (smoke.null_layers(torch, C, dev, dup, cap - 12 - dup), 3,
              False),
             (smoke.null_layers(torch, C, dev, 12, 12), 3, False)]
    for scene, K, all_null in cases:
        got = intersect_kernels.tri_track_hits(scene, *args, K, all_null)
        want = intersect_kernels.tri_track_hits_plain(
            scene, *args, K, intersect_kernels.null_flags(scene, all_null))
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                          err_msg=name)
    assert _build.launches["intersect_kernels"]["tri_track_hits"] \
        == before + len(cases)
