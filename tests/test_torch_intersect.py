"""The port's intersection against the JAX package's, on identical rays.

* The plain twins of the CUDA kernels against the Pallas kernels
  `tri_closest_hit` / `tri_any_hit` run in interpret mode.
* The port's `ray_intersect` / `does_intersect` against the JAX ones.
* The CUDA kernels against their twins (needs the card; skips here).

Hit ids must agree exactly; t within rtol 2e-6 and uv within rtol 2e-5,
atol 2e-6 (tests/test_pallas_intersect.py:58-66), widened by the FMA
rounding of the JAX side: XLA on the CPU contracts a*b + c into a fused
multiply-add, while the kernels and twins round every product and sum
in the order the JAX code writes them (`-fmad=false`). Near a ray's
origin the plane offset d - o.n cancels, and one ULP of its terms is then
a large share of t, so each float gets the bound `_fma_bounds` propagates
from 4 ULPs of every dot's terms.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu.ops import intersect_pallas
from adapt_tpu.ops.intersect import ray_intersect as jax_ray_intersect
from adapt_tpu.ops.intersect import does_intersect as jax_does_intersect
from adapt_tpu_torch.ops import _build, intersect_kernels
from adapt_tpu_torch.ops.intersect import ray_intersect, does_intersect
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    old = intersect_pallas._INTERPRET
    intersect_pallas._INTERPRET = True
    yield
    intersect_pallas._INTERPRET = old


def _small(cfg, w, h=None):
    h = h or w
    return dataclasses.replace(
        cfg, w=w, h=h, focal=cfg.focal * w / 512, end_x=w, end_y=h,
        anti_alias=False, stratified_sampling=False)


@pytest.fixture(scope="module")
def cbox():
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    return jscene, _small(jcfg, 32), scene, _small(cfg, 32)


def _rays(scene, cfg, seed):
    """numpy rays: camera rays, plus origins jittered along them into the
    box (the camera sits 8 units in front of it) with random unit
    directions (as tests/test_pallas_intersect.py:40-48)."""
    ro, rd = camera_rays(scene, cfg, None, 0)
    ro, rd = ro.numpy(), rd.numpy()
    g = np.random.default_rng(seed)
    t = g.uniform(8.5, 12.0, (ro.shape[0], 1)).astype(np.float32)
    d2 = g.normal(size=rd.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return (np.concatenate([ro, ro + rd * t]).astype(np.float32),
            np.concatenate([rd, d2]).astype(np.float32))


def _far(n, seed):
    """Finite far values with some dead lanes (-3e38)."""
    g = np.random.default_rng(seed)
    far = g.uniform(0.5, 8.0, n).astype(np.float32)
    far[::7] = -3e38
    return far


def _fma_bounds(scene, ro, rd, row, t):
    """Per-lane (t, u, v) tolerances: the stated rtol/atol plus 4 f32 ULPs
    of each dot's terms carried through t = (d - o.n) / (dir.n) and
    u = o.U + t dir.U - cu (0 extra on a miss, where t is far0 exactly)."""
    geo = intersect_kernels.tri_table(scene)[0].numpy().astype(np.float64)
    g = geo[np.maximum(row, 0)]
    o, d = ro.astype(np.float64), rd.astype(np.float64)
    t = np.where(row >= 0, t, 0.0).astype(np.float64)
    ulp = 4 * np.finfo(np.float32).eps

    def terms(x, c):
        return np.abs(x * g[:, c:c + 3]).sum(1)

    d_n = np.maximum(np.abs((d * g[:, 0:3]).sum(1)), 1e-30)
    e_t = ulp * (terms(o, 0) + np.abs(g[:, 3]) + np.abs(t) * terms(d, 0)) \
        / d_n
    e_t = np.where(row >= 0, e_t, 0.0)

    def e_uv(c):
        e = ulp * (terms(o, c) + np.abs(t) * terms(d, c) + np.abs(g[:, c + 3]))
        return np.where(row >= 0, e + e_t * np.abs((d * g[:, c:c + 3]).sum(1)),
                        0.0)
    return e_t, e_uv(4), e_uv(8)


def _within(got, want, rtol, atol, extra, name):
    err = np.abs(got.astype(np.float64) - want)
    lim = rtol * np.abs(want) + atol + extra
    assert (err <= lim).all(), (name, err.max(), (err - lim).max())


def _close(scene, ro, rd, got, want):
    t, row, u, v, ng, obj = [np.asarray(x) for x in got]
    wt, wrow, wu, wv, wng, wobj = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(row, wrow)
    np.testing.assert_array_equal(obj, wobj)
    e_t, e_u, e_v = _fma_bounds(scene, ro, rd, row, wt)
    _within(t, wt, 2e-6, 0.0, e_t, "t")
    _within(u, wu, 2e-5, 2e-6, e_u, "u")
    _within(v, wv, 2e-5, 2e-6, e_v, "v")
    np.testing.assert_array_equal(ng, wng)


@pytest.mark.parametrize("seed", [5, 11])
@pytest.mark.parametrize("clipped", [False, True])
def test_twins_match_pallas_kernels(cbox, seed, clipped):
    jscene, _, scene, cfg = cbox
    ro, rd = _rays(scene, cfg, seed)
    n = ro.shape[0]
    far = _far(n, seed) if clipped else np.full(n, 1e7, np.float32)
    want = intersect_pallas.tri_closest_hit(
        jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far))
    got = intersect_kernels.tri_closest_hit(
        scene, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(far))
    _close(scene, ro, rd, got, want)
    assert (np.asarray(got[1]) >= 0).mean() > 0.2      # real hits compared
    occ = intersect_pallas.tri_any_hit(jscene, jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.asarray(far))
    got_occ = intersect_kernels.tri_any_hit(
        scene, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(far))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(occ))


def _interaction_close(scene, ro, rd, got, want):
    np.testing.assert_array_equal(got.obj_id.numpy(), np.asarray(want.obj_id))
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(want.prim_id))
    # cbox is all triangles: tri row == global prim id on a hit
    row = np.where(got.obj_id.numpy() >= 0, got.prim_id.numpy(), -1)
    wt, wuv = np.asarray(want.t), np.asarray(want.uv)
    e_t, e_u, e_v = _fma_bounds(scene, ro, rd, row, wt)
    _within(got.t.numpy(), wt, 2e-6, 0.0, e_t, "t")
    _within(got.uv.numpy()[:, 0], wuv[:, 0], 2e-5, 2e-6, e_u, "u")
    _within(got.uv.numpy()[:, 1], wuv[:, 1], 2e-5, 2e-6, e_v, "v")
    np.testing.assert_array_equal(got.n_g.numpy(), np.asarray(want.n_g))
    # the interpolated shading normal moves with (u, v)
    _within(got.n_s.numpy(), np.asarray(want.n_s), 1e-5, 1e-6,
            2 * (e_u + e_v)[:, None], "n_s")


@pytest.mark.parametrize("seed", [3, 8])
def test_ray_intersect_matches_jax(cbox, seed):
    jscene, jcfg, scene, cfg = cbox
    ro, rd = _rays(scene, cfg, seed)
    alive = np.random.default_rng(seed).uniform(size=ro.shape[0]) > 0.2
    for kw, jkw in (({}, {}),
                    ({"alive": torch.from_numpy(alive)},
                     {"alive": jnp.asarray(alive)})):
        want = jax_ray_intersect(jscene, jcfg, jnp.asarray(ro),
                                 jnp.asarray(rd), **jkw)
        got = ray_intersect(scene, cfg, torch.from_numpy(ro),
                            torch.from_numpy(rd), **kw)
        _interaction_close(scene, ro, rd, got, want)
    # dead lanes come back with t = -3e38 and no hit
    assert (got.t.numpy()[~alive] == np.float32(-3e38)).all()
    assert (got.obj_id.numpy()[~alive] == -1).all()


@pytest.mark.parametrize("seed", [4, 9])
def test_does_intersect_matches_jax(cbox, seed):
    jscene, jcfg, scene, cfg = cbox
    ro, rd = _rays(scene, cfg, seed)
    g = np.random.default_rng(seed)
    max_t = g.uniform(0.5, 8.0, ro.shape[0]).astype(np.float32)
    alive = g.uniform(size=ro.shape[0]) > 0.2
    want = jax_does_intersect(jscene, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(max_t), alive=jnp.asarray(alive))
    got = does_intersect(scene, cfg, torch.from_numpy(ro),
                         torch.from_numpy(rd), torch.from_numpy(max_t),
                         alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[~alive].any()
    assert got.numpy().mean() > 0.05


def test_sphere_scene_matches_jax():
    """Triangles and spheres combined (csphere), ray counts of any size."""
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/csphere/",
                                     "single-ball.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "single-ball.xml",
                               device="cpu")
    jcfg, cfg = _small(jcfg, 17, 13), _small(cfg, 17, 13)
    ro, rd = _rays(scene, cfg, 2)
    want = jax_ray_intersect(jscene, jcfg, jnp.asarray(ro), jnp.asarray(rd))
    got = ray_intersect(scene, cfg, torch.from_numpy(ro),
                        torch.from_numpy(rd))
    np.testing.assert_array_equal(got.obj_id.numpy(),
                                  np.asarray(want.obj_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=2e-6)
    assert scene.sph_center.shape[0] > 0
    max_t = np.full(ro.shape[0], 2.0, np.float32)
    np.testing.assert_array_equal(
        does_intersect(scene, cfg, torch.from_numpy(ro),
                       torch.from_numpy(rd), torch.from_numpy(max_t)).numpy(),
        np.asarray(jax_does_intersect(jscene, jcfg, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(max_t))))


def test_wrapper_refuses_other_devices(cbox):
    _, _, scene, cfg = cbox
    ro = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        intersect_kernels.tri_closest_hit(scene, ro, ro, ro[:, 0])


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cbox):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, scene, cfg = cbox
    ro, rd = _rays(scene, cfg, 21)
    n = ro.shape[0]
    far = _far(n, 21)
    dev = scene.to("cuda")
    args = [torch.from_numpy(x).cuda() for x in (ro, rd, far)]
    before = dict(_build.launches["intersect_kernels"])
    # the seeded rays, all lanes dead, far0 = 2e7 > FAR (a ray with no
    # valid row takes row 0 at t = FAR), rays at shared vertices and edges
    # (chip_smoke.py `tie_rays`) with an odd count, and four fifths dead
    from test_torch_bvh import _smoke
    tro, trd, _ = _smoke().tie_rays(torch, dev, 1001, 4)
    sparse = torch.from_numpy(np.arange(n) % 5 != 0).cuda()
    sets = [args, [args[0], args[1], torch.full_like(args[2], -3e38)],
            [args[0], args[1], torch.where(args[2] > 0, 2e7, -3e38)],
            [tro, trd, torch.full((1001,), 1e7, device="cuda")],
            # four fifths dead: the kernel splits a ray's rows
            [args[0], args[1], torch.where(sparse, -3e38, 2e7)]]
    for ray_set in sets:
        got = intersect_kernels.tri_closest_hit(dev, *ray_set)
        want = intersect_kernels.tri_closest_hit_plain(dev, *ray_set)
        # both round every operation once: bit-equal
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    occ = intersect_kernels.tri_any_hit(dev, *args)
    np.testing.assert_array_equal(
        occ.cpu().numpy(),
        intersect_kernels.tri_any_hit_plain(dev, *args).cpu().numpy())
    assert _build.launches["intersect_kernels"]["tri_closest_hit"] \
        == before["tri_closest_hit"] + len(sets)
    assert _build.launches["intersect_kernels"]["tri_any_hit"] \
        == before["tri_any_hit"] + 1
