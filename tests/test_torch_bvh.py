"""The port's BVH tier against the JAX package's, on identical inputs.

* The native BVH tables equal the JAX package's bit for bit.
* The plain walk (ops/bvh.py, the twin of both BVH kernels) against JAX
  `adapt_tpu.ops.bvh.traverse`, and once against the TPU cluster kernels
  run in interpret mode: prim ids and occlusion exactly equal.
* Dispatch: big scenes go to the BVH wrappers, small ones to the brute
  ones; the BVH kernels against their twin on the card (skips here).

Floats: the port rounds every product and sum in the order the JAX code
writes them, while XLA on the CPU contracts a*b + c into fused
multiply-adds. So t, u, v get rtol 2e-6 plus `_fma_bounds`: 4 f32 ULPs of
every dot's terms, carried through t = (d - o.n) / (dir.n) and
u = (o + t dir).U - cu (tests/test_torch_intersect.py bounds the brute
tier the same way).

The scene knot2k-test.xml reads a generated mesh. This module generates
the procedural assets when it is imported, under a file lock, so that
they exist before any test of the suite runs, whatever order the test
workers take (every worker imports every test module before the first
test is scheduled); the generator writes only files that are absent.
`knot_assets` makes the knot scene whole before each load of it (the
port's tests call it first): see its docstring.
"""
import contextlib
import dataclasses
import fcntl
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu import native as jax_native
from adapt_tpu.ops.bvh import traverse as jax_traverse
from adapt_tpu.ops.intersect import does_intersect as jax_does_intersect
from adapt_tpu.ops.intersect import ray_intersect as jax_ray_intersect
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch.ops import _build, bvh, bvh_kernels, intersect_kernels
from adapt_tpu_torch.ops.intersect import ray_intersect, does_intersect
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.convert import scene_from_numpy, scene_leaves
from adapt_tpu_torch.scene.compile import load_scene, v4_packs

from conftest import SCENE_DIR

REPO = os.path.join(os.path.dirname(__file__), "..")
PROCEDURAL = os.path.join(REPO, "scenes", "meshes", "procedural")


@contextlib.contextmanager
def _asset_lock():
    """The lock every port test takes around the procedural meshes."""
    os.makedirs(PROCEDURAL, exist_ok=True)
    with open(os.path.join(PROCEDURAL, ".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield


def _generate_assets():
    with _asset_lock():
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "gen_procedural.py")],
                       check=True, stdout=subprocess.DEVNULL)


def knot_mesh(directory=PROCEDURAL):
    """Make `directory`/knot2k.obj exactly what scripts/gen_procedural.py
    writes for it (`torus_knot(100, 10)` through `write_obj`), and return
    its path. The expected file is written to a temporary name beside it;
    when the file on disk differs (absent, truncated, half-written), the
    temporary one is renamed over it with `os.replace`, so a reader sees
    the old inode or the whole new one, never a partial file. The script
    is loaded by path, as chip_smoke.py `knot_mesh` loads it: no JAX."""
    spec = importlib.util.spec_from_file_location(
        "gen_procedural", os.path.join(REPO, "scripts", "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    path = os.path.join(directory, "knot2k.obj")
    tmp = f"{path}.{os.getpid()}.tmp"
    with contextlib.redirect_stdout(io.StringIO()):
        gen.write_obj(tmp, *gen.torus_knot(100, 10))
    with open(tmp, "rb") as fh:
        want = fh.read()
    try:
        with open(path, "rb") as fh:
            same = fh.read() == want
    except FileNotFoundError:
        same = False
    if same:
        os.remove(tmp)
    else:
        os.replace(tmp, path)
    return path


def knot_assets():
    """Everything a load of knot2k-test.xml by both packages needs, made
    whole under the procedural meshes' lock; call it before each load.

    * knot2k.obj, through `knot_mesh`. tests/test_cluster.py runs the
      generator with no lock, and its `write_obj` writes in place.
    * The JAX package's native library (adapt_tpu/native, built by `make`
      in place at its first use in each process), loaded in this process.
      When a test process finds it half-built by another worker, the JAX
      package quietly takes its numpy median-split builder: another tree
      and other cluster tables than the port's native binned-SAH build,
      with the same hits. Once loaded it stays loaded for the process."""
    with _asset_lock():
        knot_mesh()
        if jax_native.get_lib() is None:
            raise RuntimeError("the JAX package's native BVH builder did "
                               "not build: its numpy fallback builds "
                               "another tree than the port's")


_generate_assets()
knot_assets()


def _small(cfg, w):
    return dataclasses.replace(
        cfg, w=w, h=w, focal=cfg.focal * w / 512, end_x=w, end_y=w,
        anti_alias=False, stratified_sampling=False)


@pytest.fixture(scope="module")
def knot():
    knot_assets()
    jscene, jcfg, _ = jax_load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml",
                               device="cpu")
    assert cfg.use_bvh and scene.sph_center.shape[0] == 1
    return jscene, _small(jcfg, 24), scene, _small(cfg, 24)


def _rays(scene, cfg, seed):
    """numpy rays: 24^2 primary rays, bounce rays from points along them
    with seeded random directions, and shadow rays from those points to
    the point light. Returns (ro, rd, alive, max_t) with 15% dead lanes;
    max_t is the light distance on the shadow third, else 0 (none)."""
    ro, rd = camera_rays(scene, cfg, None, 0)
    ro, rd = ro.numpy(), rd.numpy()
    n = ro.shape[0]
    g = np.random.default_rng(seed)
    p = ro + rd * g.uniform(8.5, 12.5, (n, 1)).astype(np.float32)
    d2 = g.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    to_l = scene.emit_pos[0].numpy() - p
    dist = np.linalg.norm(to_l, axis=-1)
    O = np.concatenate([ro, p, p]).astype(np.float32)
    D = np.concatenate([rd, d2, to_l / dist[:, None]]).astype(np.float32)
    max_t = np.concatenate([np.zeros(2 * n), dist]).astype(np.float32)
    alive = g.uniform(size=3 * n) > 0.15
    return O, D, alive, max_t


def _fma_bounds(scene, ro, rd, prim, t):
    """Per-lane (t, u, v) extra tolerance: 4 f32 ULPs of each dot's
    terms, propagated (0 on a miss, where t is far0 exactly)."""
    pack = scene.bvh_prim_pack.numpy().astype(np.float64)
    rows = np.zeros((pack.shape[0], 14))
    rows[pack[:, 13].astype(np.int64)] = pack           # by prim id
    r = rows[np.maximum(prim, 0)]
    o, d = ro.astype(np.float64), rd.astype(np.float64)
    t = np.where(prim >= 0, t, 0.0).astype(np.float64)
    ulp = 4 * np.finfo(np.float32).eps
    a = r[:, 0:3]

    def terms(x, y):
        return np.abs(x * y).sum(1)

    d_n = np.maximum(np.abs((d * a).sum(1)), 1e-30)
    e_t = ulp * (terms(o, a) + np.abs(r[:, 3]) + np.abs(t) * terms(d, a)) \
        / d_n
    sph = r[:, 12] > 0.5
    # sphere: t = proj -+ cut, cut = sqrt(r^2 - c2r), c2r = |s2c|^2 -
    # proj^2; near a grazing hit the root amplifies c2r's rounding by
    # 1 / (2 cut)
    s2c = a - o
    proj = (d * s2c).sum(1)
    cn2, r2 = terms(s2c, s2c), r[:, 3] ** 2
    cut = np.sqrt(np.maximum(r2 - (cn2 - proj ** 2), 0.0))
    e_sph = ulp * (terms(d, s2c) + cut) \
        + ulp * (cn2 + proj ** 2 + r2) / (2 * np.maximum(cut, 1e-12))
    e_t = np.where(prim >= 0, np.where(sph, e_sph, e_t), 0.0)
    hp = o + t[:, None] * d
    e_hp = ulp * (np.abs(o) + np.abs(t[:, None] * d)) \
        + e_t[:, None] * np.abs(d)

    def e_uv(c):
        e = ulp * (terms(hp, r[:, c:c + 3]) + np.abs(r[:, c + 3])) \
            + (np.abs(r[:, c:c + 3]) * e_hp).sum(1)
        return np.where(prim >= 0, e, 0.0)
    return e_t, e_uv(4), e_uv(8)


def _within(got, want, rtol, atol, extra, name):
    err = np.abs(got.astype(np.float64) - want)
    lim = rtol * np.abs(want) + atol + extra
    assert (err <= lim).all(), (name, err.max(), (err - lim).max())


def _walk_close(scene, ro, rd, got, want):
    t, prim, u, v = [np.asarray(x) for x in got]
    wt, wprim, wu, wv = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(prim, wprim)
    e_t, e_u, e_v = _fma_bounds(scene, ro, rd, prim, wt)
    _within(t, wt, 2e-6, 0.0, e_t, "t")
    _within(u, wu, 2e-5, 2e-6, e_u, "u")
    _within(v, wv, 2e-5, 2e-6, e_v, "v")


def test_tables_equal_jax(knot):
    jscene, _, scene, _ = knot
    for name in ("bvh_node_pack", "bvh_prim_pack"):
        got = getattr(scene, name).numpy()
        want = np.asarray(getattr(jscene, name))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert scene.bvh_prim_pack.shape[0] == scene.n_prims == 2011


def _decoded(scene):
    """(M,9) and (P,14) tables decoded from the scene's float4 packs."""
    nodes, prims = scene.bvh_node_v4, scene.bvh_prim_v4
    words = nodes.view(torch.int32)
    node_pack = torch.cat([nodes[:, 0:3], nodes[:, 4:7],
                           (words[:, 3:4] & 0xFFFFFF).float(),
                           (words[:, 3:4] >> 24).float(),
                           words[:, 7:8].float()], dim=1)
    return node_pack, prims[:, :14]


@pytest.mark.parametrize("scene_file", ["knot2k-test.xml", "cbox.xml"])
def test_v4_packs_round_trip(knot, scene_file):
    """The float4 packs hold the (M,9) and (P,14) tables exactly: base,
    cnt and skip come back from the int words, every float bit for bit
    (the placeholder tables of a small scene too)."""
    scene = knot[2] if scene_file == "knot2k-test.xml" else load_scene(
        SCENE_DIR + "/cbox/", scene_file, device="cpu")[0]
    node_pack, prim_pack = scene.bvh_node_pack, scene.bvh_prim_pack
    nodes, prims = scene.bvh_node_v4, scene.bvh_prim_v4
    assert nodes.shape == (node_pack.shape[0], 8) and nodes.is_contiguous()
    assert prims.shape == (prim_pack.shape[0], 16) and prims.is_contiguous()
    assert nodes.dtype == prims.dtype == torch.float32
    got_nodes, got_prims = _decoded(scene)
    for got, want in ((got_nodes, node_pack), (got_prims, prim_pack)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (prims[:, 14:] == 0).all()
    words = nodes.view(torch.int32)
    cnt = words[:, 3] >> 24
    assert (cnt <= bvh.LEAF_MAX).all()
    assert (cnt > 0).any() == (node_pack.shape[0] > 1)    # leaves, or none
    # v4_packs is the one function: the compiler's packs are its output
    n4, p4 = v4_packs(node_pack.numpy(), prim_pack.numpy())
    assert np.array_equal(n4.view(np.int32), words.numpy())
    assert np.array_equal(p4, prims.numpy())


def test_walk_over_decoded_v4_packs(knot):
    """`walk` over tables decoded from the float4 packs equals `walk` over
    the packs themselves, output for output."""
    _, _, scene, cfg = knot
    node_pack, prim_pack = _decoded(scene)
    decoded = dataclasses.replace(scene, bvh_node_pack=node_pack,
                                  bvh_prim_pack=prim_pack)
    ro, rd, alive, max_t = _rays(scene, cfg, 17)
    args = [torch.from_numpy(x) for x in (ro, rd, max_t, alive)]
    for any_hit in (False, True):
        want = bvh.traverse(scene, *args[:2], max_t=args[2], alive=args[3],
                            any_hit=any_hit, stats=True)
        got = bvh.traverse(decoded, *args[:2], max_t=args[2], alive=args[3],
                           any_hit=any_hit, stats=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert (want[1] >= 0).float().mean() > 0.3


def test_v4_packs_cross_from_jax(knot):
    """`scene_leaves` of a JAX scene and `scene_from_numpy` make the same
    float4 packs as `load_scene`."""
    jscene, jcfg, scene, _ = knot
    conv, _ = scene_from_numpy(scene_leaves(jscene), dataclasses.asdict(jcfg),
                               device="cpu")
    for name in ("bvh_node_v4", "bvh_prim_v4"):
        got, want = getattr(conv, name), getattr(scene, name)
        assert got.is_contiguous() and got.dtype == want.dtype, name
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name


def test_operands_refuse_bad_packs(knot):
    """The kernels' operand checks refuse a pack of the wrong shape or
    type, and one that does not start on a 16-byte boundary."""
    _, _, scene, _ = knot
    ro = torch.zeros((4, 3))
    args = (ro, ro, ro[:, 0])
    nodes = scene.bvh_node_v4
    BK = bvh_kernels
    assert BK._operands(scene, *args, BK.CLOSEST_TABLES)[4] is nodes
    shifted = torch.empty(nodes.numel() + 1)[1:].view(nodes.shape)
    shifted.copy_(nodes)
    assert shifted.data_ptr() % 16
    bad = {"misaligned": dict(bvh_node_v4=shifted),
           "wide": dict(bvh_prim_v4=scene.bvh_prim_pack),
           "narrow": dict(bvh_node_v4=scene.bvh_node_pack),
           "type": dict(bvh_node_v4=nodes.double())}
    for what, fields in bad.items():
        with pytest.raises(ValueError, match="16-byte|want float32"):
            BK._operands(dataclasses.replace(scene, **fields), *args,
                         BK.CLOSEST_TABLES)
    # the any-hit kernel's tables are the (M,9) and (P,14) packs
    BK._operands(dataclasses.replace(scene, **bad["misaligned"]), *args,
                 BK.ANY_TABLES)
    with pytest.raises(ValueError, match="want float32"):
        BK._operands(dataclasses.replace(scene, bvh_node_pack=nodes), *args,
                     BK.ANY_TABLES)


@pytest.mark.parametrize("seed", [3, 7])
def test_walk_matches_jax_traverse(knot, seed):
    jscene, _, scene, cfg = knot
    ro, rd, alive, max_t = _rays(scene, cfg, seed)
    mt = np.where(max_t > 0, max_t, 1e6).astype(np.float32)
    for kw in ({}, {"alive": alive}, {"alive": alive, "max_t": mt}):
        want = jax_traverse(jscene, jnp.asarray(ro), jnp.asarray(rd),
                            **{k: jnp.asarray(x) for k, x in kw.items()})
        got = bvh.traverse(scene, torch.from_numpy(ro), torch.from_numpy(rd),
                           **{k: torch.from_numpy(x) for k, x in kw.items()})
        _walk_close(scene, ro, rd, got, want)
        prim = got[1].numpy()
        assert (prim >= 0).mean() > 0.3             # real hits compared
        # on the knot, the sphere and the walls
        assert len(set(scene.prim_obj.numpy()[prim[prim >= 0]])) >= 5
    # dead lanes: t = -3e38 and no hit
    assert (got[0].numpy()[~alive] == np.float32(-3e38)).all()
    assert (got[1].numpy()[~alive] == -1).all()
    # any hit: shadow rays to the light, clipped at its distance
    want = jax_traverse(jscene, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(mt), any_hit=True,
                        alive=jnp.asarray(alive))[1] >= 0
    got = bvh.traverse(scene, torch.from_numpy(ro), torch.from_numpy(rd),
                       torch.from_numpy(mt), any_hit=True,
                       alive=torch.from_numpy(alive))[1] >= 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shadow = slice(2 * cfg.n_pixels, None)
    assert 0.02 < got.numpy()[shadow].mean() < 0.98


def test_walk_stats_count_the_work(knot):
    _, _, scene, cfg = knot
    ro, rd, alive, _ = _rays(scene, cfg, 5)
    args = [torch.from_numpy(x) for x in (ro, rd)]
    t, prim, u, v, visits, tests = bvh.traverse(
        scene, *args, alive=torch.from_numpy(alive), stats=True)
    assert (visits.numpy()[~alive] == 0).all()
    assert (visits.numpy()[alive] >= 1).all()
    assert (tests <= bvh.LEAF_MAX * visits).all()
    assert (tests.numpy()[prim.numpy() >= 0] >= 1).all()
    plain = bvh.traverse(scene, *args, alive=torch.from_numpy(alive))
    for a, b in zip(plain, (t, prim, u, v)):
        assert torch.equal(a, b)


def test_walk_matches_cluster_kernels(knot):
    """A few hundred rays through the TPU big-scene kernels
    (`_closest_sl_kernel` via cluster_closest_raw + _resolve_winner,
    `_any_sl_kernel` via cluster_any_hit) in interpret mode: the same
    prim ids and occlusion as the port's walk."""
    from adapt_tpu.ops import cluster_pallas as cp
    jscene, _, scene, cfg = knot
    ro, rd, alive, max_t = _rays(scene, cfg, 13)
    pick = np.random.default_rng(13).choice(ro.shape[0], 320, replace=False)
    ro, rd, alive, max_t = ro[pick], rd[pick], alive[pick], max_t[pick]
    far0 = intersect_kernels.far_bound(torch.from_numpy(ro),
                                       torch.from_numpy(max_t),
                                       torch.from_numpy(alive))
    old = cp._INTERPRET
    cp._INTERPRET = True
    try:
        jo, jd, jf = (jnp.asarray(ro), jnp.asarray(rd),
                      jnp.asarray(far0.numpy()))
        t, wid = cp.cluster_closest_raw(jscene, jo, jd, jf)
        gid = cp._resolve_winner(jscene, wid, t, jo, jd)[0]
        occ = cp.cluster_any_hit(jscene, jo, jd, jf)
    finally:
        cp._INTERPRET = old
    args = [torch.from_numpy(ro), torch.from_numpy(rd), far0]
    prim = bvh_kernels.bvh_closest_hit(scene, *args)[1]
    np.testing.assert_array_equal(prim.numpy(), np.asarray(gid))
    np.testing.assert_array_equal(
        bvh_kernels.bvh_any_hit(scene, *args).numpy(), np.asarray(occ))
    assert (prim.numpy() >= 0).mean() > 0.3


def _interaction_close(scene, ro, rd, got, want):
    np.testing.assert_array_equal(got.obj_id.numpy(), np.asarray(want.obj_id))
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(want.prim_id))
    prim = np.where(got.obj_id.numpy() >= 0, got.prim_id.numpy(), -1)
    wt, wuv = np.asarray(want.t), np.asarray(want.uv)
    e_t, e_u, e_v = _fma_bounds(scene, ro, rd, prim, wt)
    _within(got.t.numpy(), wt, 2e-6, 0.0, e_t, "t")
    sph = scene.prim_is_sphere.numpy()[np.maximum(prim, 0)] & (prim >= 0)
    tri = ~sph
    _within(got.uv.numpy()[tri, 0], wuv[tri, 0], 2e-5, 2e-6, e_u[tri], "u")
    _within(got.uv.numpy()[tri, 1], wuv[tri, 1], 2e-5, 2e-6, e_v[tri], "v")
    # sphere uv and normals are angles of the hit point: t's bound moves
    # them by at most t's error over the radius
    np.testing.assert_allclose(got.uv.numpy()[sph], wuv[sph], atol=1e-4)
    np.testing.assert_allclose(got.n_g.numpy(), np.asarray(want.n_g),
                               rtol=0, atol=1e-4)
    assert sph.any()


def test_ray_intersect_and_occlusion_match_jax(knot):
    jscene, jcfg, scene, cfg = knot
    ro, rd, alive, max_t = _rays(scene, cfg, 11)
    want = jax_ray_intersect(jscene, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                             alive=jnp.asarray(alive))
    got = ray_intersect(scene, cfg, torch.from_numpy(ro),
                        torch.from_numpy(rd), alive=torch.from_numpy(alive))
    _interaction_close(scene, ro, rd, got, want)
    mt = np.where(max_t > 0, max_t, 3.0).astype(np.float32)
    want = jax_does_intersect(jscene, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(mt), alive=jnp.asarray(alive))
    got = does_intersect(scene, cfg, torch.from_numpy(ro),
                         torch.from_numpy(rd), torch.from_numpy(mt),
                         alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[~alive].any()


@pytest.fixture
def twin_calls(monkeypatch):
    """Counts of calls into each plain twin through its wrapper."""
    calls = {}
    for mod, name in ((bvh_kernels, "bvh_closest_hit_plain"),
                      (bvh_kernels, "bvh_any_hit_plain"),
                      (intersect_kernels, "tri_closest_hit_plain"),
                      (intersect_kernels, "tri_any_hit_plain")):
        def counted(*a, _fn=getattr(mod, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("scene_file,tier", [("knot2k-test.xml", "bvh"),
                                             ("cbox.xml", "tri")])
def test_dispatch_picks_the_tier(twin_calls, scene_file, tier):
    knot_assets()
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", scene_file,
                               device="cpu")
    cfg = _small(cfg, 8)
    ro, rd, alive, max_t = _rays(scene, cfg, 1)
    args = [torch.from_numpy(x) for x in (ro, rd)]
    ray_intersect(scene, cfg, *args, alive=torch.from_numpy(alive))
    does_intersect(scene, cfg, *args, torch.from_numpy(max_t))
    assert twin_calls == {f"{tier}_closest_hit_plain": 1,
                          f"{tier}_any_hit_plain": 1}
    assert bvh_kernels.launches == {"bvh_closest_hit": 0, "bvh_any_hit": 0}


def test_wrappers_refuse_other_devices(knot):
    _, _, scene, _ = knot
    ro = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bvh_kernels.bvh_closest_hit(scene, ro, ro, ro[:, 0])
    with pytest.raises(ValueError, match="no kernel"):
        bvh_kernels.bvh_any_hit(scene, ro, ro, ro[:, 0])


def test_knot_mesh_repairs_a_truncated_file(knot, tmp_path):
    """A truncated knot2k.obj is replaced whole before the load: the scene
    loads the same prims and the same BVH as from the repository's copy,
    and a whole file is left as it is (same inode)."""
    _, _, scene, _ = knot
    scenes = tmp_path / "scenes"
    (scenes / "cbox").mkdir(parents=True)
    (scenes / "meshes" / "procedural").mkdir(parents=True)
    with open(os.path.join(SCENE_DIR, "cbox", "knot2k-test.xml"), "rb") as f:
        (scenes / "cbox" / "knot2k-test.xml").write_bytes(f.read())
    os.symlink(os.path.abspath(os.path.join(SCENE_DIR, "meshes", "cornell")),
               scenes / "meshes" / "cornell")
    with open(os.path.join(PROCEDURAL, "knot2k.obj"), "rb") as f:
        whole = f.read()
    mesh = scenes / "meshes" / "procedural" / "knot2k.obj"
    mesh.write_bytes(whole[:len(whole) // 2])
    assert knot_mesh(str(mesh.parent)) == str(mesh)
    assert mesh.read_bytes() == whole
    inode = os.stat(mesh).st_ino
    knot_mesh(str(mesh.parent))
    assert os.stat(mesh).st_ino == inode and mesh.read_bytes() == whole
    assert sorted(os.listdir(mesh.parent)) == ["knot2k.obj"]   # no temp
    got, _, _ = load_scene(str(scenes / "cbox") + "/", "knot2k-test.xml",
                           device="cpu")
    assert got.n_prims == scene.n_prims == 2011
    for name in ("bvh_node_pack", "bvh_prim_pack"):
        assert torch.equal(getattr(got, name), getattr(scene, name)), name


def test_builder_has_no_fallback(tmp_path, monkeypatch):
    """A builder that fails to compile raises; nothing else builds the
    tree in its place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(subprocess.CalledProcessError):
        _build.compiled("broken", src, lambda: "g++", ("-shared", "-fPIC"))


def test_load_scene_defaults_to_the_card():
    """With no device argument the tables go to the CUDA device; with no
    CUDA device the call raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        scene, _, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
        assert scene.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_scene(SCENE_DIR + "/cbox/", "cbox.xml")


@pytest.mark.cuda
def test_kernels_match_twin_on_card(knot):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, scene, cfg = knot
    dev = scene.to("cuda")
    for name in ("bvh_node_v4", "bvh_prim_v4"):
        assert getattr(dev, name).data_ptr() % 16 == 0, name
    before = dict(bvh_kernels.launches)
    seeds = (21, 22, 23)
    for seed in seeds:
        ro, rd, alive, max_t = _rays(scene, cfg, seed)
        far = intersect_kernels.far_bound(*[torch.from_numpy(x).cuda()
                                            for x in (ro, max_t, alive)])
        args = [torch.from_numpy(x).cuda() for x in (ro, rd)] + [far]
        got = bvh_kernels.bvh_closest_hit(dev, *args)
        want = bvh_kernels.bvh_closest_hit_plain(dev, *args)
        # same visit order and operation order: bit-equal
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
        np.testing.assert_array_equal(
            bvh_kernels.bvh_any_hit(dev, *args).cpu().numpy(),
            bvh_kernels.bvh_any_hit_plain(dev, *args).cpu().numpy())
    assert bvh_kernels.launches == {
        k: n + len(seeds) for k, n in before.items()}
    info = bvh_kernels.kernel_info(ro.shape[0])
    assert all(v[0] > 0 and v[2] > 0 for v in info.values()), info
