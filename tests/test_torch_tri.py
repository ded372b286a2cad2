"""The brute-force kernels' per-scene triangle tables, and the plain
versions of the closest hit (B1) and the media walk (B3) on their harder
inputs, against the JAX package.

* The tables (`scene/compile.py::tri_tables`) equal what the wrappers built
  on every call before (`tri_table`, `_is_null_obj`) bit for bit, from the
  port's compiler and from a JAX scene through convert.py, and survive
  `SceneData.to`; `replace_triangles` makes them anew.
* B1's plain version against the Pallas `tri_closest_hit` in interpret
  mode on a tie set (cbox with every row twice, rays aimed at inner points:
  each hit ties in t with its copy and the lower row must win) and with
  far0 = 2e7 > FAR (a ray with no valid row then "hits" row 0 at t = FAR
  with row 0's own u and v): ids exact, floats within
  tests/test_torch_intersect.py's `_fma_bounds`.
* B3's plain version against the Pallas `tri_track_hits` on the vpt cbox
  with its null rows layered: exact duplicates (the same t) and copies
  RAY_EPS behind, at and above the kernel's null-row cap, with
  tests/test_torch_track.py's tolerances.
* The wrappers read the scene's tables and build nothing, refuse tables
  of the wrong shape, type, device or layout, and the media walk's
  all-null case passes a flag, not a table.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu.ops import intersect_pallas
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch.convert import scene_from_numpy, scene_leaves
from adapt_tpu_torch.ops import intersect, intersect_kernels as K
from adapt_tpu_torch.ops.intersect import _is_null_obj, ray_track_hits
from adapt_tpu_torch.scene import compile as C

from conftest import SCENE_DIR
from test_torch_intersect import _close
from test_torch_track import _assert_track_close

TRI_FIELDS = ("tri_gid", "tri_obj", "tri_n", "tri_d", "tri_U", "tri_cu",
              "tri_V", "tri_cv")
NULL_CAP = K.NULL_CAP   # the media-walk kernel's null-row cap


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    old = intersect_pallas._INTERPRET
    intersect_pallas._INTERPRET = True
    yield
    intersect_pallas._INTERPRET = old


_SCENES = {}


def _scenes(folder):
    """(JAX scene, port scene) of scenes/<folder>/cbox.xml, loaded once."""
    if folder not in _SCENES:
        js, _, _ = jax_load_scene(f"{SCENE_DIR}/{folder}/", "cbox.xml")
        s, _, _ = C.load_scene(f"{SCENE_DIR}/{folder}/", "cbox.xml",
                               device="cpu")
        _SCENES[folder] = (js, s)
    return _SCENES[folder]


def _assert_tables(scene):
    geo, ng, obj = K.tri_table(scene)
    null = _is_null_obj(scene, scene.tri_obj)
    for name, got, want in (("tri_geo", scene.tri_geo, geo),
                            ("tri_ng", scene.tri_ng, ng),
                            ("tri_obj", scene.tri_obj, obj),
                            ("tri_null", scene.tri_null, null)):
        assert got.dtype == want.dtype and got.is_contiguous(), name
        assert torch.equal(got, want), name
    rows = torch.arange(scene.tri_obj.shape[0], dtype=torch.int32)
    assert torch.equal(scene.tri_solid_rows, rows[~null])
    assert torch.equal(scene.tri_null_rows, rows[null])


@pytest.mark.parametrize("folder", ["cbox", "vpt"])
def test_tri_tables_equal_the_per_call_build(folder):
    js, s = _scenes(folder)
    _assert_tables(s)
    assert s.tri_null_rows.shape[0] == (12 if folder == "vpt" else 0)
    # from the JAX scene's leaves through convert.py
    leaves = scene_leaves(js)
    conv, _ = scene_from_numpy(leaves, {"w": 8, "h": 8, "focal": 1.0},
                               device="cpu")
    _assert_tables(conv)
    for name in ("tri_geo", "tri_ng", "tri_null", "tri_solid_rows",
                 "tri_null_rows"):
        assert torch.equal(getattr(conv, name), getattr(s, name)), name
    # SceneData.to moves them with the rest
    moved = s.to("meta")
    for name in ("tri_geo", "tri_ng", "tri_null", "tri_solid_rows",
                 "tri_null_rows"):
        x = getattr(moved, name)
        assert x.device.type == "meta" and x.shape == getattr(s, name).shape
    _assert_tables(s.to("cpu"))


def _layered(js, s, rows, dup, eps):
    """The JAX and port scenes with copies of some rows appended: exact
    duplicates of the first `dup` of `rows`, then copies of the first
    `eps` moved RAY_EPS along their normal (plane offset d + RAY_EPS)."""
    fields = {}
    for name in TRI_FIELDS:
        x = np.asarray(getattr(js, name))
        moved = x[rows[:eps]] + np.float32(K.RAY_EPS) if name == "tri_d" \
            else x[rows[:eps]]
        fields[name] = np.ascontiguousarray(
            np.concatenate([x, x[rows[:dup]], moved]).astype(x.dtype))
    port = C.replace_triangles(
        s, **{k: torch.from_numpy(v) for k, v in fields.items()})
    jax = dataclasses.replace(js, **{k: jnp.asarray(v)
                                     for k, v in fields.items()})
    return jax, port


def _aimed_rays(scene, rows, n, seed):
    """numpy rays at inner points of the given triangle rows (barycentric
    u, v >= 0.1, u + v <= 0.9), from points 0.05-1 away on either side:
    an exact copy of a row then ties with it in t, and no ray's validity
    hangs on a rounding at an edge (where the JAX side's FMAs may decide
    otherwise; chip_smoke.py's `tie_rays` holds the kernels to the plain
    versions there, bit for bit)."""
    g = np.random.default_rng(seed)
    pick = scene.tri_gid.numpy()[g.choice(rows, n)]
    at = g.uniform(0.1, 0.8, (n, 2)).astype(np.float32)
    at = np.where(at.sum(1, keepdims=True) > 0.9, 0.9 - at[:, ::-1], at)
    p0, e1, e2 = (x.numpy()[pick] for x in (scene.pre2, scene.pre0,
                                            scene.pre1))
    target = p0 + at[:, :1] * e1 + at[:, 1:] * e2
    side = np.where(g.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    off = scene.prim_ng.numpy()[pick] * side \
        + 0.5 * g.normal(size=(n, 3)) / np.sqrt(3.0)
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    ro = (target + off * g.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd.astype(np.float32)


def test_replace_triangles_remakes_the_tables():
    js, s = _scenes("vpt")
    _, layered = _layered(js, s, s.tri_null_rows.numpy(), 12, 12)
    _assert_tables(layered)
    assert layered.tri_null_rows.shape[0] == 36 > NULL_CAP
    assert layered.tri_geo.shape[0] == 60


def _rand_rays(scene, n, seed):
    g = np.random.default_rng(seed)
    lo = scene.obj_aabb_min.numpy().min(0)
    hi = scene.obj_aabb_max.numpy().max(0)
    o = g.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                  (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("case", ["tie", "far0 2e7"])
def test_closest_twin_matches_pallas(case):
    js, s = _scenes("cbox")
    T = s.tri_geo.shape[0]
    if case == "tie":
        # every row twice: each hit ties with its copy, the lower row wins
        js, s = _layered(js, s, np.arange(T), T, 0)
        ro, rd = _aimed_rays(s, np.arange(T), 600, 13)
        far = np.full(ro.shape[0], 1e7, np.float32)
    else:
        ro, rd = _rand_rays(s, 600, 17)
        # rays from outside the box that miss it, and rays inside
        far = np.full(ro.shape[0], 2e7, np.float32)
        far[::9] = -3e38
    want = intersect_pallas.tri_closest_hit(
        js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far))
    got = K.tri_closest_hit(s, torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.from_numpy(far))
    _close(s, ro, rd, got, want)
    row, t = got[1].numpy(), got[0].numpy()
    if case == "tie":
        tt, _u, _v, valid = K._hit_tables(s.tri_geo, torch.from_numpy(ro),
                                          torch.from_numpy(rd))
        tm = torch.where(valid, tt, K.FAR)
        ties = ((tm == tm.amin(1, keepdim=True)) & valid).sum(1) >= 2
        assert ties.float().mean() > 0.9       # rows really tie in t
        assert ((row >= 0) & (row < T)).mean() > 0.9
    else:
        # no valid row: row 0 at t = FAR, with row 0's own u and v
        far_row = (row == 0) & (t == np.float32(1e7))
        assert far_row.sum() > 10 and (row[::9] == -1).all()


@pytest.mark.parametrize("case", ["far at t", "far 1 ulp above t",
                                  "far 1 ulp below t", "all dead",
                                  "all occluded"])
def test_any_twin_matches_pallas(case):
    """B2's plain version against the Pallas `tri_any_hit`: far0 at each
    ray's closest hit t and one ULP either side (only the rays whose t the
    two packages round alike: XLA's FMAs move t by an ULP on a few, and
    at far0 = t the answer hangs on that ULP; chip_smoke.py holds the
    kernel bit-equal to the plain version on every ray of such a set), every
    lane dead, and every lane occluded (rays aimed at inner points of a
    triangle, far0 beyond it)."""
    js, s = _scenes("cbox")
    T = s.tri_geo.shape[0]
    ro, rd = _aimed_rays(s, np.arange(T), 600, 23)
    far = np.full(ro.shape[0], 1e7, np.float32)
    if case.startswith("far"):
        jt, jrow = (np.asarray(x) for x in intersect_pallas.tri_closest_hit(
            js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far))[:2])
        t, row = (x.numpy() for x in K.tri_closest_hit(
            s, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(far))[:2])
        same = (row >= 0) & (row == jrow) & (t == jt)
        assert same.mean() > 0.8
        ro, rd, t = ro[same], rd[same], t[same]
        far = {"far at t": t,
               "far 1 ulp above t": np.nextafter(t, np.float32(3e38)),
               "far 1 ulp below t": np.nextafter(t, np.float32(0))}[case]
    elif case == "all dead":
        far[:] = -3e38
    else:
        far[:] = 2.0          # each ray's target lies at most 1 away
    want = np.asarray(intersect_pallas.tri_any_hit(
        js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far)))
    got = K.tri_any_hit(s, torch.from_numpy(ro), torch.from_numpy(rd),
                        torch.from_numpy(far)).numpy()
    np.testing.assert_array_equal(got, want)
    # nothing lies strictly before the closest hit; the closest row itself
    # lies before a far0 one ULP beyond it
    assert got.all() == (case in ("far 1 ulp above t", "all occluded"))
    assert not got.any() or case in ("far 1 ulp above t", "all occluded")


def test_any_hit_refuses_more_rows_than_it_stages():
    _, s = _scenes("cbox")
    assert K._staged(s, "tri_any_hit") == s.tri_geo.shape[0]
    big = dataclasses.replace(s, tri_geo=s.tri_geo.repeat(8, 1))
    with pytest.raises(ValueError, match="at most 256"):
        K._staged(big, "tri_any_hit")


@pytest.mark.parametrize("case", ["at-cap", "above-cap", "eps-layered"])
def test_track_twin_matches_pallas_on_layered_nulls(case):
    """The vpt cbox's 12 null rows with copies: at the cap (duplicates,
    then eps-layered copies up to NULL_CAP rows), above it (12 duplicates
    and 12 eps-layered copies) and eps-layered copies alone."""
    dup, eps, K_ = {"at-cap": (min(12, NULL_CAP - 12),
                               max(0, NULL_CAP - 24), 3),
                    "above-cap": (12, 12, 3), "eps-layered": (0, 12, 2)}[case]
    js0, s0 = _scenes("vpt")
    js, s = _layered(js0, s0, s0.tri_null_rows.numpy(), dup, eps)
    n_null = s.tri_null_rows.shape[0]
    assert n_null == 12 + dup + eps
    assert (n_null <= NULL_CAP) == (case == "at-cap")
    ro, rd = _aimed_rays(s, s.tri_null_rows.numpy(), 400, 19 + eps)
    far = np.random.default_rng(eps).uniform(0.5, 9.0, 400) \
        .astype(np.float32)
    far[::11] = 1e7
    far[::13] = -3e38
    want = intersect_pallas.tri_track_hits(
        js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far), K_,
        jnp.asarray(s.tri_null.numpy()))
    got = K.tri_track_hits(s, torch.from_numpy(ro), torch.from_numpy(rd),
                           torch.from_numpy(far), K_)
    _assert_track_close(got, want, s, ro, rd)
    # the layers are crossed: second interfaces, and some overflow
    assert (got[0].numpy()[1] < K.FAR).mean() > 0.05
    if eps:
        assert got[6].numpy().any()


def _args(n=4):
    return torch.zeros((n, 3)), torch.ones((n, 3)), torch.ones(n)


@pytest.mark.parametrize("field,bad,match", [
    ("tri_geo", lambda s: s.tri_geo[:, :11].contiguous(), "shape"),
    ("tri_geo", lambda s: s.tri_geo.double(), "float32"),
    ("tri_geo", lambda s: s.tri_geo.to("meta"), "meta"),
    ("tri_geo", lambda s: s.tri_geo.t().contiguous().t(), "contiguous"),
    ("tri_geo", lambda s: torch.cat([s.tri_geo.new_zeros(1), s.tri_geo
                                     .flatten()])[1:].view(-1, 12),
     "aligned"),
    ("tri_ng", lambda s: s.tri_ng[:-1], "shape"),
    ("tri_obj", lambda s: s.tri_obj.long(), "int32"),
], ids=["geo-shape", "geo-type", "geo-device", "geo-strided",
        "geo-misaligned", "ng-shape", "obj-type"])
def test_operands_refuse_bad_tables(field, bad, match):
    _, s = _scenes("vpt")
    with pytest.raises(ValueError, match=match):
        K._operands(dataclasses.replace(s, **{field: bad(s)}), *_args())


@pytest.mark.parametrize("field,bad,match", [
    ("tri_null_rows", lambda s: s.tri_null_rows[1:], "shape"),
    ("tri_solid_rows", lambda s: s.tri_solid_rows.long(), "int32"),
    ("tri_geo", lambda s: s.tri_geo.repeat(8, 1), "at most"),
], ids=["lists-shape", "lists-type", "too-many-rows"])
def test_track_operands_refuse_bad_lists(field, bad, match):
    _, s = _scenes("vpt")
    fields = {field: bad(s)}
    if field == "tri_geo":             # 288 rows: every table that long
        fields.update(tri_ng=s.tri_ng.repeat(8, 1),
                      tri_obj=s.tri_obj.repeat(8))
    with pytest.raises(ValueError, match=match):
        K._track_operands(dataclasses.replace(s, **fields), *_args(),
                          False)


def test_wrappers_build_nothing(monkeypatch):
    """The kernel path's operands are the scene's own tables, made before
    the call, and ray_track_hits hands all_null to the kernel's wrapper as
    a flag (the kernel takes every row in order) rather than a table."""
    _, s = _scenes("vpt")

    def no_build(*a):
        raise AssertionError("a table was built in the call")
    monkeypatch.setattr(K, "tri_table", no_build)
    ops = K._operands(s, *_args())
    assert ops[4] is s.tri_geo and ops[5] is s.tri_ng and ops[6] is s.tri_obj
    _, (solid_p, n_solid, null_p) = K._track_operands(s, *_args(), False)
    assert (solid_p, n_solid, null_p) == (
        s.tri_solid_rows.data_ptr(), 24, s.tri_null_rows.data_ptr())
    assert K._track_operands(s, *_args(), True)[1] == (None, 0, None)
    monkeypatch.undo()
    seen, track = [], K.tri_track_hits

    def spy(scene, ro, rd, far0, k, all_null=False):
        seen.append(all_null)
        return track(scene, ro, rd, far0, k, all_null)
    monkeypatch.setattr(intersect.kernels, "tri_track_hits", spy)
    monkeypatch.setattr(intersect, "_is_null_obj", no_build)
    cfg = C.RenderConfig(w=8, h=8, focal=1.0)
    ro, rd = (torch.from_numpy(x) for x in _rand_rays(s, 64, 3))
    for all_null in (False, True):
        ray_track_hits(s, cfg, ro, rd, torch.full((64,), 5.0), K=2,
                       all_null=all_null)
    assert seen == [False, True]


def test_tri_ab_imports_no_jax():
    """The brute-force kernels' module and ops/_build.py, which loads and
    launches them, import nothing of the JAX package."""
    import os
    import subprocess
    import sys
    code = ("import sys; import adapt_tpu_torch.ops._build, "
            "adapt_tpu_torch.ops.intersect_kernels; "
            "bad = [m for m in sys.modules if m in ('jax', 'adapt_tpu') "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code],
                   cwd=os.path.join(os.path.dirname(__file__), ".."),
                   check=True, timeout=120)
