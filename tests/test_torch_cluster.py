"""The port's cluster tier against the JAX package's, on identical inputs.

Scene: knot2k-test.xml (2,011 prims, one of them a sphere; 12 clusters of
256 slots). Rays are made with numpy from a seed (tests/test_torch_bvh.py
`_rays`: primary, bounce and shadow rays with 15% dead lanes). The JAX
side runs its Pallas kernels in interpret mode under the schedule each test
names (`cluster_pallas.SHORTLIST` / `QPICK` / `QP_P` set and restored
around the call); the port runs its plain versions, as every wrapper does
on a CPU tensor.

* the cluster-cut tables equal the JAX package's bit for bit after the
  layout change;
* each of the five plain versions against the Pallas kernel it stands for:
  `cluster_front_plain` / `_front_candidates`, `cluster_pick_closest_plain`
  / `_single_pass`, `cluster_pick_any_plain` / the `_single_any_kernel`
  call, `cluster_closest_hit_plain` / `cluster_closest_hit` and
  `cluster_any_hit_plain` / `cluster_any_hit` with SHORTLIST off;
* `ray_intersect` / `does_intersect` under "sweep" and "qpick" against the
  JAX calls under the same schedule and against the port's own BVH tier;
* one small PT pass under each tier against the JAX pass.

Tolerances. Ids, object ids, occlusion, front clusters and winner slots
are compared exactly. Floats: the port rounds every product and sum once,
in the order the JAX code writes them, while XLA on the CPU contracts
a*b + c into fused multiply-adds. So t gets rtol 2e-6 plus
tests/test_torch_bvh.py `_fma_bounds` (4 f32 ULPs of every dot's terms,
carried through t = (d - o.n) / (dir.n) and the sphere root: these rays
start ten units from the knot, so a dot's terms are large beside t), u and
v rtol 2e-4 atol 5e-5 (near-zero barycentrics cancel dot products of
magnitude ~1e2), n_g rtol 2e-5 atol 2e-6: the bounds tests/test_cluster.py
holds the same kernels to against the cursor walk. The front pass's second
entry distance is compared exactly: a slab test is differences times a
reciprocal, with nothing for XLA to contract, and the JAX package inflates
its boxes op by op outside any jit, as the port does in numpy.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adapt_tpu.ops import cluster_pallas as cp
from adapt_tpu.ops.intersect import does_intersect as jax_does_intersect
from adapt_tpu.ops.intersect import ray_intersect as jax_ray_intersect
from adapt_tpu.renderer import pt as jpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import rng
from adapt_tpu_torch.convert import scene_from_numpy, scene_leaves
from adapt_tpu_torch.ops import bvh_kernels, cluster_kernels as ck
from adapt_tpu_torch.ops import intersect_kernels
from adapt_tpu_torch.ops.intersect import does_intersect, ray_intersect
from adapt_tpu_torch.renderer import pt
from adapt_tpu_torch.scene.compile import CLUSTER_MAX, load_scene

from conftest import SCENE_DIR
from test_torch_bvh import _fma_bounds, _rays, _small, _within, knot_assets

REPO = os.path.join(os.path.dirname(__file__), "..")
DEAD = np.float32(-3e38)


@contextlib.contextmanager
def jax_schedule(shortlist=True, qpick=False, p=2):
    """The JAX package's kernels in interpret mode under one schedule:
    SHORTLIST off is the all-cluster sweep, QPICK on the queue-pick
    schedule with p pick passes."""
    old = cp._INTERPRET, cp.SHORTLIST, cp.QPICK, cp.QP_P
    cp._INTERPRET, cp.SHORTLIST, cp.QPICK, cp.QP_P = True, shortlist, qpick, p
    try:
        yield
    finally:
        cp._INTERPRET, cp.SHORTLIST, cp.QPICK, cp.QP_P = old


@pytest.fixture(scope="module")
def knot():
    knot_assets()
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml",
                               device="cpu")
    assert cfg.use_bvh and cfg.big_tier == "bvh"
    assert scene.sph_center.shape[0] == 1 and scene.n_clusters == 12
    return jscene, _small(jcfg, 24), scene, _small(cfg, 24)


def _batch(scene, cfg, seed, max_t_fill=0.0):
    """(numpy dict, torch dict) of one ray batch: ro, rd, far0 (15% dead
    lanes at -3e38; the shadow third clipped at the light)."""
    ro, rd, alive, max_t = _rays(scene, cfg, seed)
    mt = np.where(max_t > 0, max_t, max_t_fill).astype(np.float32)
    far0 = intersect_kernels.far_bound(
        torch.from_numpy(ro), torch.from_numpy(mt),
        torch.from_numpy(alive)).numpy()
    arrs = dict(ro=ro, rd=rd, far0=far0)
    return arrs, {k: torch.from_numpy(v) for k, v in arrs.items()}


def _j(arrs, *names):
    return [jnp.asarray(arrs[n]) for n in names]


def _t_close(scene, ro, rd, gid, t, want_t):
    """t within rtol 2e-6 plus the FMA bound of each lane's winner."""
    e_t = _fma_bounds(scene, ro, rd, gid, want_t)[0]
    _within(t, want_t, 2e-6, 0.0, e_t, "t")


def _attrs_close(scene, gid, got, want):
    """(u, v, n_g) of a hit: triangle lanes within the bounds of
    tests/test_cluster.py; sphere lanes within atol 1e-4, as
    tests/test_torch_bvh.py holds them (a sphere's normal and uv are
    angles of the hit point, which t's bound moves by at most t's error
    over the radius)."""
    sph = scene.prim_is_sphere.numpy()[np.maximum(gid, 0)] & (gid >= 0)
    for (a, b), (rtol, atol) in zip(zip(got, want),
                                    ((2e-4, 5e-5), (2e-4, 5e-5),
                                     (2e-5, 2e-6))):
        np.testing.assert_allclose(a[~sph], b[~sph], rtol=rtol, atol=atol)
        np.testing.assert_allclose(a[sph], b[sph], rtol=0, atol=1e-4)
    return sph


# ------------------------------- the tables -------------------------------

def test_tables_equal_jax(knot):
    jscene, _, scene, _ = knot
    C, CM = scene.n_clusters, scene.cluster_size
    assert CM == CLUSTER_MAX == np.asarray(jscene.cl_rows).shape[2]
    np.testing.assert_array_equal(scene.cl_aabb.numpy(),
                                  np.asarray(jscene.cl_aabb)[:, :6])
    # both of the JAX package's row tables: field-major and prim-major
    rows = scene.cl_rows.numpy()
    assert rows.dtype == np.float32 and rows.shape == (C * CM, 18)
    np.testing.assert_array_equal(
        rows, np.asarray(jscene.cl_rows_pm)[:, :18])
    np.testing.assert_array_equal(
        rows.reshape(C, CM, 18),
        np.asarray(jscene.cl_rows).transpose(0, 2, 1)[:, :, :18])
    jchunk = np.asarray(jscene.cl_chunk)                     # (C*8, K)
    K = jchunk.shape[1]
    np.testing.assert_array_equal(
        scene.cl_chunk.numpy(),
        jchunk.reshape(C, 8, K)[:, :6].transpose(0, 2, 1))
    # every prim in exactly one cluster, in its leading slots
    gid = rows[:, 13].astype(np.int64).reshape(C, CM)
    live = gid >= 0
    np.testing.assert_array_equal(np.sort(gid[live]),
                                  np.arange(scene.n_prims))
    count = scene.cl_count.numpy()
    np.testing.assert_array_equal(count, live.sum(1))
    assert (live == (np.arange(CM)[None] < count[:, None])).all()
    np.testing.assert_array_equal(
        rows[scene.cl_slot.numpy(), 13], np.arange(scene.n_prims))
    # the inflated boxes hold the raw ones
    front = scene.cl_front.numpy()
    assert (front[:, :3] < scene.cl_aabb.numpy()[:, :3]).all()
    assert (front[:, 3:] > scene.cl_aabb.numpy()[:, 3:]).all()


def test_tables_cross_from_jax(knot):
    """`scene_leaves` of a JAX scene and `scene_from_numpy` carry the
    cluster tables across in the port's layout."""
    jscene, jcfg, scene, _ = knot
    fields = dataclasses.asdict(jcfg)
    conv, _ = scene_from_numpy(scene_leaves(jscene), fields, device="cpu")
    for name in ("cl_aabb", "cl_front", "cl_rows", "cl_chunk", "cl_count",
                 "cl_slot"):
        got, want = getattr(conv, name), getattr(scene, name)
        assert got.dtype == want.dtype and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)


def test_small_scene_gets_placeholder_tables():
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                               device="cpu")
    assert not cfg.use_bvh and scene.n_clusters == 1
    assert int(scene.cl_count.sum()) == 0
    assert (scene.cl_slot.numpy() == -1).all()
    # an accidental sweep misses
    ro = torch.zeros((5, 3))
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(5, 3).contiguous()
    far0 = torch.full((5,), 1e7)
    t, gid = ck.cluster_closest_hit(scene, ro, rd, far0)[:2]
    assert (gid == -1).all() and torch.equal(t, far0)
    assert not ck.cluster_any_hit(scene, ro, rd, far0).any()


# --------------------------- kernel by kernel ---------------------------

@pytest.mark.parametrize("seed", [3, 7])
def test_front_matches_jax(knot, seed):
    jscene, _, scene, cfg = knot
    arrs, tt = _batch(scene, cfg, seed, max_t_fill=2.0)
    with jax_schedule():
        jcid, jnxt = cp._front_candidates(jscene, *_j(arrs, "ro", "rd",
                                                      "far0"))
    cid, nxt = ck.cluster_front_plain(scene, tt["ro"], tt["rd"], tt["far0"])
    assert cid.dtype == torch.int32
    np.testing.assert_array_equal(cid.numpy(), np.asarray(jcid))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    C = scene.n_clusters
    dead = arrs["far0"] < 0
    assert (cid.numpy()[dead] == C).all()            # dead lanes enter none
    assert (nxt.numpy()[cid.numpy() == C] == np.float32(3e38)).all()
    assert 0.3 < (cid.numpy() < C).mean()
    assert (nxt.numpy() < 3e38).mean() > 0.1         # a second cluster


def _pick_inputs(scene, cfg, seed):
    """Rays sorted as the schedule sorts them, with picks, far and wid0
    fixed by the test: each tile's first or second distinct front cluster
    (some tiles -1), far tightened on a third of the lanes, wid0 a
    mixture of -1 and earlier slots."""
    arrs, tt = _batch(scene, cfg, seed, max_t_fill=0.0)
    perm, ro, rd, far, cid, _nxt = ck._front_sort(scene, tt["ro"], tt["rd"],
                                                  tt["far0"])
    picks, _cov = ck.tile_picks(cid, scene.n_clusters, 2)
    g = np.random.default_rng(seed)
    nt = picks[0].shape[0]
    pick = torch.where(torch.from_numpy(g.uniform(size=nt) < 0.5),
                       picks[0], picks[1])
    pick = torch.where(torch.from_numpy(g.uniform(size=nt) < 0.15),
                       torch.tensor(-1, dtype=torch.int32), pick)
    n = ro.shape[0]
    far = torch.where(torch.from_numpy(g.uniform(size=n) < 0.33) & (far > 0),
                      torch.tensor(9.5), far)
    wid0 = torch.from_numpy(np.where(
        g.uniform(size=n) < 0.5, -1,
        g.integers(0, scene.cl_rows.shape[0], n)).astype(np.int32))
    assert (pick >= 0).sum() >= nt // 3 and (pick == -1).any()
    return ro.contiguous(), rd.contiguous(), far, wid0, pick


def _blocked(ro, rd, far):
    """The JAX package's ray blocks (padded to LANE_B lanes)."""
    return cp._ray_blocks(jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
                          jnp.asarray(far.numpy()))


@pytest.mark.parametrize("seed", [5, 9])
def test_pick_closest_matches_jax(knot, seed):
    jscene, _, scene, cfg = knot
    ro, rd, far, wid0, pick = _pick_inputs(scene, cfg, seed)
    n = ro.shape[0]
    assert cp.LANE_B == ck.TILE
    rob, rdb, farb, Np = _blocked(ro, rd, far)
    widb = jnp.pad(jnp.asarray(wid0.numpy()).reshape(n, 1),
                   ((0, Np - n), (0, 0)), constant_values=-1)
    with jax_schedule():
        jt, jwid = cp._single_pass(jscene, rob, rdb, farb, Np, widb,
                                   jnp.asarray(pick.numpy()).reshape(1, -1))
    t, wid, tests, whole = ck.cluster_pick_closest_plain(
        scene, ro, rd, far, wid0, pick, stats=True)
    np.testing.assert_array_equal(wid.numpy(), np.asarray(jwid)[:n, 0])
    gid = np.where(wid.numpy() >= 0, scene.cl_rows.numpy()[
        np.maximum(wid.numpy(), 0), 13].astype(np.int64), -1)
    _t_close(scene, ro.numpy(), rd.numpy(), np.where(
        wid.numpy() != wid0.numpy(), gid, -1), t.numpy(),
        np.asarray(jt)[:n, 0])
    moved = wid.numpy() != wid0.numpy()
    assert moved.mean() > 0.1                        # real improvements
    assert (t.numpy()[~moved] == far.numpy()[~moved]).all()
    assert (t.numpy()[far.numpy() < 0] == DEAD).all()
    # the count: every lane of an active tile against its live rows
    lanes = np.minimum(ck.TILE, n - np.arange(pick.shape[0]) * ck.TILE)
    act = pick.numpy() >= 0
    assert tests == int((lanes[act] * scene.cl_count.numpy()[
        pick.numpy()[act]]).sum())
    # a row goes past its plane distance at least where it improves t
    assert moved.sum() <= whole < tests


@pytest.mark.parametrize("seed", [5, 9])
def test_pick_any_matches_jax(knot, seed):
    """B6e against the call `qpick_any` makes for one pick pass."""
    jscene, _, scene, cfg = knot
    ro, rd, far, _wid0, pick = _pick_inputs(scene, cfg, seed)
    n = ro.shape[0]
    rob, rdb, farb, Np = _blocked(ro, rd, far)
    nt = Np // cp.LANE_B
    ray = pl.BlockSpec((cp.LANE_B, 3), lambda i, *_: (i, 0),
                       memory_space=pltpu.VMEM)
    col = pl.BlockSpec((cp.LANE_B, 1), lambda i, *_: (i, 0),
                       memory_space=pltpu.VMEM)
    rows = pl.BlockSpec(memory_space=pl.ANY)
    _C, F, CM = jscene.cl_rows.shape
    jocc = pl.pallas_call(
        functools.partial(cp._single_any_kernel, cp._tri_only(jscene)),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nt,),
            in_specs=[ray, ray, col, rows], out_specs=col,
            scratch_shapes=[pltpu.VMEM((F, CM), jnp.float32),
                            pltpu.SemaphoreType.DMA(())]),
        out_shape=jax.ShapeDtypeStruct((Np, 1), jnp.bool_),
        interpret=True,
    )(jnp.asarray(pick.numpy()).reshape(1, nt), rob, rdb, farb,
      jscene.cl_rows)
    occ, tests, whole = ck.cluster_pick_any_plain(scene, ro, rd, far, pick,
                                                  stats=True)
    assert int(occ.sum()) <= whole < tests           # a hit is a whole test
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc)[:n, 0])
    assert 0.02 < occ.numpy().mean() < 0.98
    assert not occ.numpy()[far.numpy() < 0].any()


@pytest.mark.parametrize("seed", [3, 7])
def test_sweep_closest_matches_jax(knot, seed):
    jscene, _, scene, cfg = knot
    arrs, tt = _batch(scene, cfg, seed, max_t_fill=0.0)
    with jax_schedule(shortlist=False):
        want = cp.cluster_closest_hit(jscene, *_j(arrs, "ro", "rd", "far0"))
    got = ck.cluster_closest_hit_plain(scene, tt["ro"], tt["rd"], tt["far0"])
    t, gid, u, v, n_g, obj = [x.numpy() for x in got]
    wt, wgid, wu, wv, wng, wobj = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gid, wgid)
    np.testing.assert_array_equal(obj, wobj)
    _t_close(scene, arrs["ro"], arrs["rd"], gid, t, wt)
    _attrs_close(scene, gid, (u, v, n_g), (wu, wv, wng))
    # the sphere flag the kernel writes, against the scene's own
    _t, wid, _occ, (boxes, prims, whole) = ck._sweep_plain(
        scene, tt["ro"], tt["rd"], tt["far0"], stats=True)
    is_sph = ck._finish(scene, wid, got[0], tt["ro"], tt["rd"])[5].numpy()
    np.testing.assert_array_equal(
        is_sph, (gid >= 0) & np.asarray(jscene.prim_is_sphere)[
            np.maximum(gid, 0)])
    assert is_sph.sum() > 10                         # sphere lanes compared
    assert (gid >= 0).mean() > 0.3
    dead = arrs["far0"] < 0
    assert (t[dead] == DEAD).all() and (gid[dead] == -1).all()
    assert (n_g[gid < 0] == np.float32([1, 0, 0])).all()
    # the work counted: at least C box tests a live lane, a row test a hit
    live = int((~dead).sum())
    assert boxes >= live * scene.n_clusters
    assert prims > whole >= (gid >= 0).sum()


@pytest.mark.parametrize("max_t", [None, 2.0])
def test_sweep_any_matches_jax(knot, max_t):
    jscene, _, scene, cfg = knot
    ro, rd, alive, _ = _rays(scene, cfg, 9)
    n = ro.shape[0]
    mt = None if max_t is None else np.full(n, max_t, np.float32)
    far0 = intersect_kernels.far_bound(
        torch.from_numpy(ro), None if mt is None else torch.from_numpy(mt),
        torch.from_numpy(alive))
    with jax_schedule(shortlist=False):
        want = cp.cluster_any_hit(jscene, jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(far0.numpy()))
    got, boxes, prims, whole = ck.cluster_any_hit_plain(
        scene, torch.from_numpy(ro), torch.from_numpy(rd), far0, stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < got.numpy().mean() < 0.95
    assert not got.numpy()[~alive].any()
    assert boxes > 0 and prims > whole >= int(got.sum())


def test_resolve_winner_matches_jax(knot):
    jscene, _, scene, cfg = knot
    arrs, tt = _batch(scene, cfg, 15)
    t, wid = ck.qpick_closest(scene, tt["ro"], tt["rd"], tt["far0"])
    got = ck.resolve_winner(scene, wid, t, tt["ro"], tt["rd"])
    want = cp._resolve_winner(jscene, jnp.asarray(wid.numpy()),
                              jnp.asarray(t.numpy()), *_j(arrs, "ro", "rd"))
    gid, u, v, n_g, obj = [x.numpy() for x in got]
    wgid, wu, wv, wng, wobj = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gid, wgid)
    np.testing.assert_array_equal(obj, wobj)
    sph = _attrs_close(scene, gid, (u, v, n_g), (wu, wv, wng))
    assert sph.sum() > 5
    assert (wid.numpy() < 0).any() and (wid.numpy() >= 0).mean() > 0.3


def test_tile_picks_match_jax(knot):
    _, _, scene, cfg = knot
    _arrs, tt = _batch(scene, cfg, 19)
    cid = ck._front_sort(scene, tt["ro"], tt["rd"], tt["far0"])[4]
    C, n = scene.n_clusters, cid.shape[0]
    Np = -(-n // ck.TILE) * ck.TILE
    for P in (0, 1, 2, 3):
        picks, covered = ck.tile_picks(cid, C, P)
        jpicks, jcov = cp._tile_picks(
            jnp.pad(jnp.asarray(cid.numpy()), (0, Np - n),
                    constant_values=C), Np, C, P)
        assert len(picks) == len(jpicks) == P
        for a, b in zip(picks, jpicks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(covered.numpy(), np.asarray(jcov)[:n])
    assert 0.0 < covered.numpy().mean() < 1.0 or C <= 3


# ------------------------------ the schedules ------------------------------

def _interaction_matches(scene, ro, rd, got, want, alive):
    """Interaction of the port against the JAX package's (same schedule)
    on the live lanes; dead lanes are misses."""
    a = alive
    np.testing.assert_array_equal(got.prim_id.numpy()[a],
                                  np.asarray(want.prim_id)[a])
    np.testing.assert_array_equal(got.obj_id.numpy()[a],
                                  np.asarray(want.obj_id)[a])
    assert (got.obj_id.numpy()[~a] == -1).all()
    assert (got.t.numpy()[~a] == DEAD).all()
    hit = np.where(got.obj_id.numpy() >= 0, got.prim_id.numpy(), -1)
    _t_close(scene, ro[a], rd[a], hit[a], got.t.numpy()[a],
             np.asarray(want.t)[a])
    uv, wuv = got.uv.numpy()[a], np.asarray(want.uv)[a]
    _attrs_close(scene, hit[a], (uv[:, 0], uv[:, 1], got.n_g.numpy()[a]),
                 (wuv[:, 0], wuv[:, 1], np.asarray(want.n_g)[a]))
    # the shading normal interpolates vertex normals by u and v
    np.testing.assert_allclose(got.n_s.numpy()[a], np.asarray(want.n_s)[a],
                               rtol=0, atol=1e-4)


def _masks(seed, n):
    g = np.random.default_rng(seed)
    max_t = np.where(g.uniform(size=n) < 0.5, 2.0, -1.0).astype(np.float32)
    return max_t, g.uniform(size=n) < 0.8


SCHEDULES = [("sweep", dict(shortlist=False), None)] + [
    ("qpick", dict(qpick=True, p=p), p) for p in (0, 1, 2, 3)]


@pytest.mark.parametrize("tier,flags,p", SCHEDULES,
                         ids=[f"{t}-{p}" for t, _f, p in SCHEDULES])
def test_tiers_match_jax_and_bvh(knot, monkeypatch, tier, flags, p):
    """`ray_intersect` and `does_intersect` under each schedule, with
    max_t clipping and alive masks: against the JAX calls under the same
    schedule, and against the port's own BVH tier (same ids and occlusion;
    t bit-equal, as both divide the same plane distance; u, v rounded in
    another order, so within the bounds above)."""
    jscene, jcfg, scene, cfg = knot
    if p is not None:
        monkeypatch.setattr(ck, "QP_P", p)
    ro, rd, _alive, _mt = _rays(scene, cfg, 33)
    n = ro.shape[0]
    max_t, alive = _masks(5, n)
    jargs = [jnp.asarray(ro), jnp.asarray(rd)]
    targs = [torch.from_numpy(ro), torch.from_numpy(rd)]
    tkw = dict(max_t=torch.from_numpy(max_t), alive=torch.from_numpy(alive))
    tcfg = dataclasses.replace(cfg, big_tier=tier)
    with jax_schedule(**flags):
        jcl = dataclasses.replace(jcfg, use_cluster=True)
        want = jax_ray_intersect(jscene, jcl, *jargs,
                                 max_t=jnp.asarray(max_t),
                                 alive=jnp.asarray(alive))
        want_occ = jax_does_intersect(jscene, jcl, *jargs,
                                      max_t=jnp.asarray(max_t),
                                      alive=jnp.asarray(alive))
    got = ray_intersect(scene, tcfg, *targs, **tkw)
    _interaction_matches(scene, ro, rd, got, want, alive)
    occ = does_intersect(scene, tcfg, *targs, **tkw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert not occ.numpy()[~alive].any() and occ.numpy().mean() > 0.05
    ref = ray_intersect(scene, cfg, *targs, **tkw)          # the BVH tier
    assert torch.equal(got.prim_id, ref.prim_id)
    assert torch.equal(got.obj_id, ref.obj_id)
    assert torch.equal(got.t, ref.t)
    torch.testing.assert_close(got.uv, ref.uv, rtol=2e-4, atol=5e-5)
    torch.testing.assert_close(got.n_g, ref.n_g, rtol=2e-5, atol=2e-6)
    assert torch.equal(occ, does_intersect(scene, cfg, *targs, **tkw))
    sph = scene.prim_is_sphere[got.prim_id.long()] & (got.obj_id >= 0)
    assert sph.sum() > 5 and (got.obj_id >= 0).float().mean() > 0.2


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of calls into each plain version through its wrapper."""
    calls = {}
    for mod, name in ((bvh_kernels, "bvh_closest_hit_plain"),
                      (bvh_kernels, "bvh_any_hit_plain"),
                      (ck, "cluster_closest_hit_plain"),
                      (ck, "cluster_any_hit_plain"),
                      (ck, "cluster_front_plain"),
                      (ck, "cluster_pick_closest_plain"),
                      (ck, "cluster_pick_any_plain")):
        def counted(*a, _fn=getattr(mod, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("tier,want", [
    ("bvh", {"bvh_closest_hit_plain": 1, "bvh_any_hit_plain": 1}),
    ("sweep", {"cluster_closest_hit_plain": 1, "cluster_any_hit_plain": 1}),
    ("qpick", {"cluster_front_plain": 2, "cluster_pick_closest_plain": 2,
               "cluster_pick_any_plain": 2, "bvh_closest_hit_plain": 1,
               "bvh_any_hit_plain": 1})])
def test_dispatch_picks_the_tier(knot, plain_calls, tier, want):
    """One closest-hit and one any-hit call under each tier: the wrappers
    the config names run, each through its plain version on the CPU, and
    no kernel launches."""
    _, _, scene, cfg = knot
    cfg = dataclasses.replace(_small(cfg, 8), big_tier=tier)
    ro, rd, alive, max_t = _rays(scene, cfg, 1)
    args = [torch.from_numpy(x) for x in (ro, rd)]
    ray_intersect(scene, cfg, *args, alive=torch.from_numpy(alive))
    does_intersect(scene, cfg, *args, torch.from_numpy(max_t))
    assert plain_calls == want
    assert not any(ck.launches.values())
    assert not any(bvh_kernels.launches.values())


def test_unknown_tier_raises(knot):
    _, _, scene, cfg = knot
    ro = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="big_tier"):
        ray_intersect(scene, dataclasses.replace(cfg, big_tier="march"),
                      ro, ro)
    # a small scene never reads the field
    small, scfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml",
                                device="cpu")
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    ray_intersect(small, dataclasses.replace(scfg, big_tier="march"), ro, rd)


def test_wrappers_refuse_other_devices(knot):
    _, _, scene, _ = knot
    ro = torch.zeros((4, 3), device="meta")
    far = ro[:, 0]
    wid0 = torch.zeros(4, dtype=torch.int32, device="meta")
    picks = torch.zeros(1, dtype=torch.int32, device="meta")
    for call in (lambda: ck.cluster_closest_hit(scene, ro, ro, far),
                 lambda: ck.cluster_any_hit(scene, ro, ro, far),
                 lambda: ck.cluster_front(scene, ro, ro, far),
                 lambda: ck.cluster_pick_closest(scene, ro, ro, far, wid0,
                                                 picks),
                 lambda: ck.cluster_pick_any(scene, ro, ro, far, picks)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_wrappers_refuse_a_box_table_beyond_shared_memory():
    """The kernels keep the (C, 6) box table in a block's shared memory:
    more clusters than fit there are refused, not read another way."""
    ro = torch.zeros((4, 3))
    fits = ck.BOX_TABLE_MAX // 24
    big = types.SimpleNamespace(n_clusters=fits + 1, cluster_size=256,
                                cl_chunk=torch.zeros((1, 2, 6)))
    with pytest.raises(ValueError, match="shared memory"):
        ck._operands(big, ro, ro, ro[:, 0])


def test_empty_batch(knot):
    _, _, scene, _ = knot
    ro = torch.zeros((0, 3))
    far = torch.zeros(0)
    assert ck.cluster_closest_hit(scene, ro, ro, far)[1].shape == (0,)
    assert ck.cluster_any_hit(scene, ro, ro, far).shape == (0,)
    t, wid = ck.qpick_closest(scene, ro, ro, far)
    assert t.shape == wid.shape == (0,)
    assert ck.qpick_any(scene, ro, ro, far).shape == (0,)


# ---------------------------- the slice as a whole ----------------------------

@pytest.mark.parametrize("tier,flags,w", [
    ("sweep", dict(shortlist=False), 24), ("qpick", dict(qpick=True), 28)])
def test_render_pass_matches_jax(tier, flags, w):
    """One PT pass on knot2k-test at w^2 and 3 bounces under each tier
    against the JAX pass with `use_cluster` under the same schedule, same
    key, under the goldens' bounds (mean within 1e-3 relative, every value
    within 5e-2). The two tiers render at different sizes, and the JAX
    caches are dropped around the call: its jitted pass reads the schedule
    flags when it is traced."""
    knot_assets()
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml",
                               device="cpu")
    kw = dict(w=w, h=w, focal=cfg.focal * w / 512, end_x=w, end_y=w,
              max_bounce=3)
    jax.clear_caches()
    try:
        with jax_schedule(**flags):
            ref = np.asarray(jpt.render_pass_pt(
                jscene, dataclasses.replace(jcfg, use_cluster=True, **kw),
                jax.random.PRNGKey(9), jnp.int32(1)))
    finally:
        jax.clear_caches()
    ck.reset_launches()
    img = pt.render_pass_pt(scene, dataclasses.replace(cfg, big_tier=tier,
                                                       **kw),
                            rng.PRNGKey(9), 1).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3)
    assert np.abs(img - ref).max() < 5e-2, np.abs(img - ref).max()
    assert img.mean() > 0.05
    assert not any(ck.launches.values())             # CPU: plain versions
    # and the port's own BVH tier renders the same pass
    bvh_img = pt.render_pass_pt(scene, dataclasses.replace(cfg, **kw),
                                rng.PRNGKey(9), 1).numpy()
    assert np.abs(img - bvh_img).max() < 5e-2


def test_cluster_modules_import_no_jax():
    code = ("import sys; import adapt_tpu_torch.ops.cluster_kernels, "
            "adapt_tpu_torch.ops.intersect, adapt_tpu_torch.scene.compile, "
            "adapt_tpu_torch.convert, adapt_tpu_torch.profile_pt; "
            "bad = [m for m in sys.modules if m in ('jax', 'adapt_tpu') "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# ------------------------------- on the card -------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card(knot):
    """Each of the five kernels against its plain version on the card:
    same steps in the same operation order, so every output is bit-equal;
    each wrapper counts its launch. Then both schedules against the BVH
    tier through `ray_intersect` / `does_intersect`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, scene, cfg = knot
    dev = scene.to("cuda")

    def same(got, want, what):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype, what
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                          err_msg=what)

    for seed in (21, 22):
        _arrs, tt = _batch(scene, cfg, seed, max_t_fill=0.0)
        ro, rd, far = (tt[k].cuda() for k in ("ro", "rd", "far0"))
        before = dict(ck.launches)
        same(ck.cluster_closest_hit(dev, ro, rd, far),
             ck.cluster_closest_hit_plain(dev, ro, rd, far), "closest")
        same([ck.cluster_any_hit(dev, ro, rd, far)],
             [ck.cluster_any_hit_plain(dev, ro, rd, far)], "any")
        same(ck.cluster_front(dev, ro, rd, far),
             ck.cluster_front_plain(dev, ro, rd, far), "front")
        pro, prd, pfar, wid0, pick = (
            x.cuda() for x in _pick_inputs(scene, cfg, seed))
        same(ck.cluster_pick_closest(dev, pro, prd, pfar, wid0, pick),
             ck.cluster_pick_closest_plain(dev, pro, prd, pfar, wid0, pick),
             "pick closest")
        same([ck.cluster_pick_any(dev, pro, prd, pfar, pick)],
             [ck.cluster_pick_any_plain(dev, pro, prd, pfar, pick)],
             "pick any")
        # `_pick_inputs` ran the front pass on the CPU: no launch there
        assert ck.launches == {k: n + 1 for k, n in before.items()}
        for tier in ("sweep", "qpick"):
            tcfg = dataclasses.replace(cfg, big_tier=tier)
            got = ray_intersect(dev, tcfg, ro, rd, alive=far > 0)
            ref = ray_intersect(dev, cfg, ro, rd, alive=far > 0)
            assert torch.equal(got.prim_id, ref.prim_id), tier
            assert torch.equal(got.t, ref.t), tier
            assert torch.equal(
                does_intersect(dev, tcfg, ro, rd, alive=far > 0),
                does_intersect(dev, cfg, ro, rd, alive=far > 0)), tier
