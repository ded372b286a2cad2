"""The port's grid volumes against the JAX package, op by op and as whole
passes.

* I/O: `vol_file_to_numpy` reads what the JAX loader reads from 1-, 3-
  and 6-channel grids, with and without `force_mono`, and refuses what it
  refuses (a bad header, 2 channels, a short payload); `write_vol` writes
  the JAX writer's bytes; adapt_tpu_torch/scene/assets.py `vol_assets`
  writes the bytes scripts/gen_procedural.py `ensure_vol` writes, and it
  and chip_smoke's `orb_assets` load nothing of the JAX package;
  `load_volume` refuses a scene whose `.vol` file is missing.
* Tables: `GridVolumeRec` and `compile_volume` on cbox-volgrid.xml (a mono
  plume) and cbox-rgbvol.xml (the tornado made RGB by mono2rgb, rotated):
  grid, inv_T, majorant, pdf, sv_maj, sv_size and the AABB exactly equal.
* The march on rays aimed at each volume, at N = 1,024 (one round) and
  N = 8,192 with more than 1,024 lanes crossing (rounds of C = 1,024, at
  least two): `intersect_volume` and `_march_interval` exactly equal;
  `record_marches` records each tracking call's lanes, crossing lanes,
  rounds and steps; `_sv_step`'s majorants and
  hops exactly equal, its candidates within 4 ULP (XLA's CPU log1p rounds
  unlike torch's in ~10% of its values); both tracking functions differ
  from the JAX package's in at most LANES_DIFFER of the lanes (measured:
  0 and 2 of the plume's 1,024 and 8,192 lanes, 1 and 9 of the
  tornado's), a hit distance that differs by at most rtol 1e-5.
* The statistical oracles of tests/test_volume.py (Beer-Lambert, the RGB
  spectral oracle, the delta-tracking beta expectation and collision
  statistics, the rotated-volume oracle) on the port.
* Whole passes at tests/test_goldens.py `_small` settings, key 42: VPT on
  both scenes at 64^2, 4 bounces (4,096 lanes: the rounds run), BDPT on
  cbox-volgrid.xml at 32^2, 3 bounces, each against the JAX render under
  tests/test_torch_pt.py `_close` and against a golden written once from
  the JAX package (`volgrid_vpt_64`, `rgbvol_vpt_64`, `volgrid_bdpt_32`)
  under `_check`; each differs clearly from the render without the
  volume. Measured: 3.0e-6, 1.5e-5 and 7.3e-6 max abs from the JAX
  renders.

The scenes' `.vol` files are git-ignored; `volume_assets` writes them
(scene/assets.py `vol_assets`) under the lock tests/test_torch_bvh.py
makes the procedural assets under, and every load fails unless the
volume loaded (scene/assets.py `load_volume`): a missing file would otherwise render without
the volume with only a warning, as the JAX package's loader does.
"""
import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as xet

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu import native as jax_native
from adapt_tpu.ops import volume_ops as J
from adapt_tpu.renderer import bdpt as jbdpt, vpt as jvpt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu.scene.volume import GridVolumeRec as JGridVolumeRec
from adapt_tpu_torch import native, rng
from adapt_tpu_torch.convert import scene_leaves
from adapt_tpu_torch.ops import volume_ops as T
from adapt_tpu_torch.renderer import bdpt, vpt
from adapt_tpu_torch.scene import assets
from adapt_tpu_torch.scene.compile import load_scene
from adapt_tpu_torch.scene.volume import GridVolumeRec

from conftest import SCENE_DIR
from test_goldens import _check, _small
from test_torch_bvh import _asset_lock
from test_torch_pt import _close

REPO = os.path.join(os.path.dirname(__file__), "..")
CBOX = os.path.join(SCENE_DIR, "cbox")
SCENES = ("cbox-volgrid.xml", "cbox-rgbvol.xml")
# share of lanes whose tracking result may differ from the JAX package's
LANES_DIFFER = 5e-3


def volume_assets():
    """The two scenes' `.vol` files (assets.vol_assets), under the
    procedural assets' lock."""
    with _asset_lock():
        assets.vol_assets()


@pytest.fixture(scope="module")
def scenes():
    """{file: (JAX scene, JAX cfg, port scene, port cfg)} on the CPU."""
    volume_assets()
    out = {}
    for f in SCENES:
        jscene, jcfg, _ = jax_load_scene(CBOX, f)
        scene, cfg, _ = assets.load_volume(CBOX, f, "cpu")
        out[f] = (jscene, jcfg, scene, cfg)
    return out


# ------------------------------- .vol I/O -----------------------------------

@pytest.mark.parametrize("channels", [1, 3, 6, 2, "short"])
def test_vol_io_equals_jax(tmp_path, channels):
    """Each grid read as the JAX package reads it; 2 channels (a bad
    count) and a 3-channel file cut short of its payload refused by both
    readers."""
    short = channels == "short"
    c = 3 if short else channels
    g = np.random.default_rng(c).uniform(
        0, 4, (5, 6, 7, c)).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.vol"), str(tmp_path / "t.vol")
    jax_native.write_vol(jpath, g)
    native.write_vol(tpath, g)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        data = a.read()
        assert data == b.read()
    if short:
        for path in (jpath, tpath):
            with open(path, "wb") as f:
                f.write(data[:-4])
    if short or c == 2:
        with pytest.raises(ValueError):
            jax_native.vol_file_to_numpy(jpath)
        with pytest.raises(ValueError, match=".vol payload" if short
                           else r"bad .vol file .* \(error -5\)"):
            native.vol_file_to_numpy(tpath)
        return
    for mono in (False, True):
        got = native.vol_file_to_numpy(tpath, force_mono=mono)
        want = jax_native.vol_file_to_numpy(jpath, force_mono=mono)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    (tmp_path / "bad.vol").write_bytes(b"VOL\x02" + bytes(60))
    with pytest.raises(ValueError, match="bad .vol"):
        native.vol_file_to_numpy(str(tmp_path / "bad.vol"))


def test_vol_assets_bytes_equal_gen_procedural(tmp_path):
    """assets.vol_assets writes what scripts/gen_procedural.py
    `ensure_vol` writes (through the JAX package's writer), byte for
    byte. The script is run from a copy under tmp_path, where it writes
    its files."""
    os.makedirs(tmp_path / "scripts")
    shutil.copy(os.path.join(REPO, "scripts", "gen_procedural.py"),
                tmp_path / "scripts")
    spec = importlib.util.spec_from_file_location(
        "gen_copy", str(tmp_path / "scripts" / "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    path = list(sys.path)
    try:
        want = [gen.ensure_vol(name, kind=kind)
                for name, kind in assets.VOLUMES]
    finally:
        sys.path[:] = path
    got = assets.vol_assets(str(tmp_path / "port"))
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_chip_smoke_assets_import_no_jax(tmp_path):
    """scene/assets.py `vol_assets` and chip_smoke's `orb_assets` write
    their files without loading the JAX package (gen_procedural's
    `ensure_vol` would, through its writer), under the procedural assets'
    lock."""
    code = ("import fcntl, os, sys; import chip_smoke; "
            "from adapt_tpu_torch.scene.assets import vol_assets; "
            "d = os.path.join('scenes', 'meshes', 'procedural'); "
            "os.makedirs(d, exist_ok=True); "
            "fh = open(os.path.join(d, '.lock'), 'w'); "
            "fcntl.flock(fh, fcntl.LOCK_EX); "
            f"paths = vol_assets({str(tmp_path)!r}); "
            "chip_smoke.orb_assets(); "
            "assert all(os.path.getsize(p) > 0 for p in paths); "
            "bad = [m for m in sys.modules if m in ('jax', 'adapt_tpu') "
            "or m.startswith(('jax.', 'adapt_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_load_volume_refuses_missing_file(tmp_path):
    """A scene whose `.vol` file is missing loads with the volume disabled
    and a warning (as in the JAX package); `load_volume` raises."""
    with open(os.path.join(CBOX, "cbox-volgrid.xml")) as fh:
        text = fh.read()
    missing = str(tmp_path / "missing.vol")
    text = text.replace("./scenes/volume/janga-smoke-264-136-136.vol",
                        missing)
    text = text.replace('value="../meshes/', f'value="{CBOX}/../meshes/')
    (tmp_path / "scene.xml").write_text(text)
    with pytest.warns(UserWarning, match="volume file"):
        _, cfg, _ = load_scene(str(tmp_path), "scene.xml", device="cpu")
    assert cfg.volume_kind == 0
    with pytest.raises(RuntimeError, match="not found"):
        assets.load_volume(str(tmp_path), "scene.xml", "cpu")


def test_record_marches(scenes):
    """`record_marches` gets one record a tracking call while it is open
    (lanes, crossing lanes, the rounds, steps > 0), and none after."""
    _, _, scene, cfg = scenes["cbox-rgbvol.xml"]
    n = 8192
    o, d, far, thp, act = _rays(scene, n, n)
    args = (_t(o), _t(d), _t(thp), _t(far))
    *_, near, far_ = T._march_interval(scene.volume, _t(o), _t(d), _t(far))
    crossing = int(((near < far_) & (far_ > 0.0) & _t(act)).sum())
    with T.record_marches() as calls:
        T.eval_tr_ratio_tracking(scene.volume, cfg.volume_kind,
                                 rng.PRNGKey(5), *args, active=_t(act))
        T.sample_distance_delta_tracking(scene.volume, cfg.volume_kind,
                                         rng.PRNGKey(6), *args,
                                         active=_t(act))
    T.eval_tr_ratio_tracking(scene.volume, cfg.volume_kind, rng.PRNGKey(7),
                             *args, active=_t(act))
    assert len(calls) == 2 and T._marches is None
    for c in calls:
        assert (c["lanes"], c["crossing"]) == (n, crossing)
        assert c["rounds"] == -(-crossing // 1024) >= 2
        assert 0 < c["steps"] <= T.MAX_STEPS and c["s"] > 0


# -------------------------------- tables ------------------------------------

@pytest.mark.parametrize("file", SCENES)
def test_volume_tables_equal_jax(scenes, file):
    jscene, jcfg, scene, cfg = scenes[file]
    assert (cfg.volume_kind, cfg.volume_phase) \
        == (jcfg.volume_kind, jcfg.volume_phase)
    assert cfg.volume_kind == (1 if file == "cbox-volgrid.xml" else 2)
    elem = xet.parse(os.path.join(CBOX, file)).getroot().find("volume")
    rec, jrec = GridVolumeRec(elem, CBOX), JGridVolumeRec(elem, CBOX)
    for name in ("density_grid", "forward_t", "offset", "albedo", "par",
                 "phase_pdf", "inv_T"):
        assert np.array_equal(getattr(rec, name), getattr(jrec, name)), name
    assert np.array_equal(rec.majorant(), jrec.majorant())
    for a, b in zip(rec.world_aabb(), jrec.world_aabb()):
        assert np.array_equal(a, b)
    leaves, jleaves = scene_leaves(scene), scene_leaves(jscene)
    names = [n for n in leaves if n.startswith("volume.")]
    assert len(names) == 12
    for n in names:
        assert leaves[n].dtype == jleaves[n].dtype, n
        assert np.array_equal(leaves[n], jleaves[n]), n
    assert scene.volume.grid.shape == (3, 96, 96, 96)
    assert scene.volume.sv_size == 8
    assert scene.volume.sv_maj.shape == (3, 12, 12, 12)


# --------------------------------- march ------------------------------------

def _rays(scene, n, seed):
    """n rays through a neighbourhood of the volume's centre from points
    around it, seeded: (o, d, far, thp, active) as numpy arrays."""
    g = np.random.default_rng(seed)
    vol = scene.volume
    c = 0.5 * (vol.mini.numpy() + vol.maxi.numpy())
    o = (c + g.normal(size=(n, 3)) * 3).astype(np.float32)
    d = (c + g.normal(size=(n, 3)) * 0.3 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = g.uniform(2.0, 8.0, n).astype(np.float32)
    thp = g.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    return o, d, far, thp, g.uniform(size=n) > 0.1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("file", SCENES)
def test_march_matches_jax(scenes, file, n):
    jscene, jcfg, scene, cfg = scenes[file]
    jv, tv, kind = jscene.volume, scene.volume, cfg.volume_kind
    o, d, far, thp, act = _rays(scene, n, n)
    jin = [jnp.asarray(x) for x in (o, d)]
    tin = [_t(x) for x in (o, d)]

    # the world-AABB slab and the interval: exactly equal, also on the
    # rotated grid
    for a, b in zip(J.intersect_volume(jv, *jin, jnp.asarray(far)),
                    T.intersect_volume(tv, *tin, _t(far))):
        assert np.array_equal(np.asarray(a), b.numpy())
    jl = J._march_interval(jv, *jin, jnp.asarray(far))
    tl = T._march_interval(tv, *tin, _t(far))
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a), b.numpy())
    lo, ld, near, far_ = (b.numpy() for b in tl)
    crossing = (near < far_) & (far_ > 0.0) & act
    if n > T.COMPACT_MIN:          # the rounds run: C = 1,024, two or more
        assert crossing.sum() > 1024

    # one supervoxel step from the entry point of each lane
    g = np.random.default_rng(n + 1)
    ch = g.integers(0, 3, n)
    u = g.uniform(size=n).astype(np.float32)
    ja = J._sv_step(jv, *(jnp.asarray(x) for x in (lo, ld, ch, near, u, far_)))
    ta = T._sv_step(T._tables(tv), T._walk(_t(lo), _t(ld)), _t(ch),
                    _t(near), -torch.log1p(-_t(u)))
    ja = [np.asarray(x) for x in ja]
    assert np.array_equal(ja[0], ta[0].numpy())           # majorant
    assert np.array_equal(ja[2], ta[2].numpy())           # hop
    fin = np.isfinite(ja[1])
    assert np.array_equal(fin, np.isfinite(ta[1].numpy()))
    assert (np.abs(ja[1][fin] - ta[1].numpy()[fin])
            <= 4 * np.spacing(np.abs(ja[1][fin]))).all()

    # both tracking functions, key 5
    args_j = (*jin, jnp.asarray(thp), jnp.asarray(far))
    args_t = (*tin, _t(thp), _t(far))
    jt, jb = J.sample_distance_delta_tracking(
        jv, kind, jax.random.PRNGKey(5), *args_j, active=jnp.asarray(act))
    tt, tb = T.sample_distance_delta_tracking(
        tv, kind, rng.PRNGKey(5), *args_t, active=_t(act))
    jr = J.eval_tr_ratio_tracking(jv, kind, jax.random.PRNGKey(5), *args_j,
                                  active=jnp.asarray(act))
    tr = T.eval_tr_ratio_tracking(tv, kind, rng.PRNGKey(5), *args_t,
                                  active=_t(act))
    jt, jb, jr = np.asarray(jt), np.asarray(jb), np.asarray(jr)
    differ = (jt != tt.numpy()) | (jb != tb.numpy()).any(-1) \
        | (jr != tr.numpy()).any(-1)
    assert differ.mean() <= LANES_DIFFER, (int(differ.sum()), n)
    hits = (jt > 0) & (tt.numpy() > 0)
    assert 0.05 < hits.mean() and (jr < 1.0).any()        # the volume shows
    both = hits & differ
    np.testing.assert_allclose(tt.numpy()[both], jt[both], rtol=1e-5)


# ---------------------- statistical oracles (tests/test_volume.py) ----------

SIGMA = 0.25
RES = 16
SIGMA_RGB = np.float32([0.1, 0.3, 0.6])
L_EFF = RES - 0.25          # tests/test_volume.py: the jitter's chord


def _uniform_vol(sigma3, inv_T=None, trans=None, mini=None, maxi=None):
    grid = np.broadcast_to(np.asarray(sigma3, np.float32)[:, None, None,
                                                          None],
                           (3, RES, RES, RES)).astype(np.float32)
    maj = np.asarray(sigma3, np.float32) * np.float32(1.05)
    sv_size, sv = T._supervoxel_majorants(grid)
    f = torch.tensor
    return T.GridVolumeData(
        grid=_t(grid), albedo=torch.full((3,), 0.9),
        inv_T=torch.eye(3) if inv_T is None else f(inv_T),
        trans=torch.zeros(3) if trans is None else f(trans),
        mini=torch.zeros(3) - 0.01 if mini is None else f(mini),
        maxi=torch.full((3,), float(RES)) + 0.01 if maxi is None
        else f(maxi),
        majorant=f(maj), pdf=f(maj / maj.sum()),
        ph_par=torch.full((3,), 0.5), ph_pdf=f([1.0, 0.0, 0.0]),
        sv_maj=_t(sv), sv_size=sv_size)


def _chords(n):
    """Chords along +x through the volume's interior."""
    g = np.random.RandomState(0)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -1.0
    o[:, 1] = g.uniform(2, RES - 2, n)
    o[:, 2] = g.uniform(2, RES - 2, n)
    d = np.tile(np.float32([1, 0, 0]), (n, 1))
    return _t(o), _t(d), torch.ones((n, 3)), torch.full((n,), RES + 2.0)


def test_ratio_tracking_matches_beer_lambert():
    vol = _uniform_vol([SIGMA] * 3)
    o, d, thp, far = _chords(32768)
    ests = [float(T.eval_tr_ratio_tracking(vol, 1, rng.PRNGKey(s), o, d,
                                           thp, far).mean())
            for s in range(3)]
    expect = np.exp(-SIGMA * L_EFF)
    assert abs(np.mean(ests) - expect) / expect < 0.12, (ests, expect)


def test_ratio_tracking_rgb_spectral_oracle():
    n = 1 << 17
    o, d, thp, far = _chords(n)
    tr = T.eval_tr_ratio_tracking(_uniform_vol(SIGMA_RGB), 2, rng.PRNGKey(3),
                                  o, d, thp, far).numpy()
    expect = np.exp(-SIGMA_RGB * L_EFF)
    se = tr.std(axis=0) / np.sqrt(n)
    assert (np.abs(tr.mean(axis=0) - expect) < 4.0 * se + 1e-7).all()


def test_delta_tracking_rgb_beta_expectation():
    """E[beta_k] = sum_j p_j exp(-sigma_j L) + albedo (1 - exp(-sigma_k
    L)) (tests/test_volume.py: beta is 1 on every channel without a
    collision, the reference's parity quirk)."""
    o, d, thp, far = _chords(1 << 17)
    _, beta = T.sample_distance_delta_tracking(
        _uniform_vol(SIGMA_RGB), 2, rng.PRNGKey(9), o, d, thp, far)
    p = SIGMA_RGB / SIGMA_RGB.sum()
    no_hit = np.exp(-SIGMA_RGB * L_EFF)
    expect = (p * no_hit).sum() + 0.9 * (1.0 - no_hit)
    got = beta.numpy().mean(axis=0)
    assert (np.abs(got - expect) / expect < 0.12).all(), (got, expect)


def test_delta_tracking_collision_statistics():
    o, d, thp, far = _chords(32768)
    t, beta = T.sample_distance_delta_tracking(
        _uniform_vol([SIGMA] * 3), 1, rng.PRNGKey(1), o, d, thp, far)
    t = t.numpy()
    expect = np.exp(-SIGMA * L_EFF)
    assert abs(float((t < 0).mean()) - expect) < 0.01
    depth = t[t > 0] - 1.0
    L = float(RES - 1)
    e = np.exp(-SIGMA * L)
    assert abs(depth.mean() - (1 / SIGMA - L * e / (1 - e))) < 0.25
    assert np.allclose(beta.numpy()[t > 0], 0.9, atol=1e-5)


def test_rotated_volume_tracking_oracle():
    """A grid rotated by 30 degrees: rays inside its world AABB leave the
    local grid mid-interval (tests/test_volume.py: the stalled hop).
    Oracle: Campbell's theorem for the jittered lookup, integrated along
    each ray."""
    theta = np.deg2rad(30.0)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    trans = -(R @ np.full(3, RES / 2, np.float32))
    vol = _uniform_vol([SIGMA] * 3, inv_T=R.T, trans=trans,
                       mini=np.full(3, -RES, np.float32),
                       maxi=np.full(3, RES, np.float32))
    n = 32768
    g = np.random.RandomState(7)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -2.0 * RES
    o[:, 1] = g.uniform(-3, 3, n)
    o[:, 2] = g.uniform(-3, 3, n)
    d = np.tile(np.float32([1, 0, 0]), (n, 1))
    lo = (o - trans) @ R
    ld = d @ R
    ts = np.linspace(0.0, 4.0 * RES, 2048, dtype=np.float64)
    pos = lo[:, None, :] + ts[None, :, None] * ld[:, None, :]
    r = np.clip(np.minimum(1.0, RES + 0.5 - pos)
                - np.maximum(0.0, 0.5 - pos), 0.0, 1.0)
    expect_tr = np.exp(-np.trapezoid(SIGMA * r.prod(-1), ts, axis=1)).mean()
    args = (_t(o), _t(d), torch.ones((n, 3)), torch.full((n,), 4.0 * RES))
    tr = T.eval_tr_ratio_tracking(vol, 1, rng.PRNGKey(11), *args)
    got = float(tr.mean())
    assert abs(got - expect_tr) / expect_tr < 0.08, (got, expect_tr)
    t, _ = T.sample_distance_delta_tracking(vol, 1, rng.PRNGKey(12), *args)
    assert abs(float((t < 0).float().mean()) - expect_tr) < 0.02


# ------------------------------ whole passes --------------------------------

@pytest.mark.parametrize("file,kind,w,mb,golden", [
    ("cbox-volgrid.xml", "vpt", 64, 4, "volgrid_vpt_64.npy"),
    ("cbox-rgbvol.xml", "vpt", 64, 4, "rgbvol_vpt_64.npy"),
    ("cbox-volgrid.xml", "bdpt", 32, 3, "volgrid_bdpt_32.npy")])
def test_volume_pass_matches_jax_and_golden(scenes, file, kind, w, mb,
                                            golden):
    jscene, jcfg, scene, cfg = scenes[file]
    c, jc = _small(cfg, w, mb), _small(jcfg, w, mb)
    if kind == "vpt":
        def render(c_):
            return vpt.render_pass_vpt(scene, c_, rng.PRNGKey(42), 1)
        ref = jvpt.render_pass_vpt(jscene, jc, jax.random.PRNGKey(42),
                                   jnp.int32(1))
    else:
        def render(c_):
            return bdpt.render_pass_bdpt(scene, c_, rng.PRNGKey(42), 1)[0]
        ref = jbdpt.render_pass_bdpt(jscene, jc, jax.random.PRNGKey(42),
                                     jnp.int32(1))[0]
    img = render(c).numpy()
    _check(img, golden)
    _close(img, ref)
    bare = render(dataclasses.replace(c, volume_kind=0)).numpy()
    assert np.abs(img - bare).mean() > 1e-3
