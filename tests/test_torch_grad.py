"""Differentiable rendering in the port: autograd through the path tracer
and through the ratio-tracking march, held against `jax.grad` through the
JAX package (tests/test_grad.py, tests/test_grad_volume.py) on the same
scene, key and parameters.

* cbox at 24^2, 3 bounces, 2 spp, no Russian roulette, no jitter, key 42:
  the loss and its gradients with respect to an albedo scale and an
  emitter scale, and the (O,3) `mat_kd` gradient, against jax.grad of
  the same loss; the finite-difference checks and `g_emit == loss` of
  tests/test_grad.py on the port; its 40-step albedo recovery;
* the ratio-tracking transmittance under DIFF_STEPS = 64 on both sides,
  at 256 rays of tests/test_grad_volume.py's problem: the values, the
  gradient along its probe and the per-voxel gradient against the JAX
  package's, and the finite-difference check on the port; a short
  density recovery;
* the intersection wrappers (kernels B1-B3, B5a/b, B6a-e) return outputs
  with no autograd graph on the CPU, as the kernels' never carry one.

Every JAX reference is computed once per module. Each tolerance is stated
beside its measured worst (this file's run on the CPU).
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_grad_volume as TV
from adapt_tpu.ops import volume_ops as jax_volume_ops
from adapt_tpu.renderer.pt import render_batch_pt as jax_render_batch_pt
from adapt_tpu.scene.compile import load_scene as jax_load_scene
from adapt_tpu_torch import recover_volume as RV
from adapt_tpu_torch import rng
from adapt_tpu_torch.ops import bvh_kernels, cluster_kernels, \
    intersect_kernels
from adapt_tpu_torch.ops import volume_ops
from adapt_tpu_torch.ops.math3d import dot
from adapt_tpu_torch.renderer.base import camera_rays
from adapt_tpu_torch.renderer.pt import render_batch_pt
from adapt_tpu_torch.scene.compile import load_scene

from conftest import SCENE_DIR

KEY = 42


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these passes are many small operations, which
    more threads only slow when the suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _small(cfg):
    """tests/test_grad.py's settings: RR kills are discontinuous, and the
    camera's jitter is off."""
    return dataclasses.replace(
        cfg, w=24, h=24, focal=cfg.focal * 24 / 512, end_x=24, end_y=24,
        max_bounce=3, use_rr=False, anti_alias=False,
        stratified_sampling=False)


@pytest.fixture(scope="module")
def cbox():
    scene, cfg, _ = load_scene(os.path.join(SCENE_DIR, "cbox"), "cbox.xml",
                               device="cpu")
    return scene, _small(cfg)


@pytest.fixture(scope="module")
def jax_ref():
    """jax.grad through the JAX package on the same loss: (loss, g_kd,
    g_emit) of the scales and the (O,3) mat_kd gradient."""
    js, jc, _ = jax_load_scene(os.path.join(SCENE_DIR, "cbox"), "cbox.xml")
    jc = _small(jc)
    key = jax.random.PRNGKey(KEY)

    def loss(kd_scale, emit_scale):
        s = dataclasses.replace(
            js, mat_kd=js.mat_kd * kd_scale,
            emit_intensity=js.emit_intensity * emit_scale)
        return jnp.mean(jax_render_batch_pt(s, jc, key, jnp.int32(1), 2))

    def loss_kd(mat_kd):
        s = dataclasses.replace(js, mat_kd=mat_kd)
        return jnp.mean(jax_render_batch_pt(s, jc, key, jnp.int32(1), 2))

    val, (g_kd, g_emit) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1)))(1.0, 1.0)
    g_mat = np.asarray(jax.jit(jax.grad(loss_kd))(js.mat_kd))
    return float(val), float(g_kd), float(g_emit), g_mat


def _loss(scene, cfg, kd_scale, emit_scale):
    s = dataclasses.replace(scene, mat_kd=scene.mat_kd * kd_scale,
                            emit_intensity=scene.emit_intensity * emit_scale)
    return render_batch_pt(s, cfg, rng.PRNGKey(KEY), 1, 2).mean()


def _grads(scene, cfg, kd=1.0, emit=1.0):
    a = torch.tensor(kd, requires_grad=True)
    e = torch.tensor(emit, requires_grad=True)
    val = _loss(scene, cfg, a, e)
    val.backward()
    return float(val.detach()), float(a.grad), float(e.grad)


def _loss_kd(scene, cfg, mat_kd):
    s = dataclasses.replace(scene, mat_kd=mat_kd)
    return render_batch_pt(s, cfg, rng.PRNGKey(KEY), 1, 2).mean()


# ------------------------------- path tracer --------------------------------

def test_scalar_grads_equal_jax(cbox, jax_ref):
    """The loss and d loss / d (albedo scale, emitter scale); measured: the
    loss equal, the gradients 8.5e-8 and 1.3e-7 relative apart."""
    scene, cfg = cbox
    val, g_kd, g_emit = _grads(scene, cfg)
    j_val, j_kd, j_emit, _ = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-6)
    np.testing.assert_allclose(g_kd, j_kd, rtol=1e-6)
    np.testing.assert_allclose(g_emit, j_emit, rtol=1e-6)


def test_mat_kd_grad_equals_jax(cbox, jax_ref):
    """The (O,3) per-object albedo gradient; measured worst 1.5e-8
    absolute on entries up to 0.12."""
    scene, cfg = cbox
    kd = scene.mat_kd.clone().requires_grad_(True)
    _loss_kd(scene, cfg, kd).backward()
    g = kd.grad.numpy()
    assert g.shape == tuple(scene.mat_kd.shape)
    np.testing.assert_allclose(g, jax_ref[3], rtol=1e-6, atol=1e-7)


def test_grad_matches_finite_differences(cbox):
    """tests/test_grad.py's checks on the port: central differences at
    h = 1e-2 within 2%, and the emitter's linearity, g_emit == loss."""
    scene, cfg = cbox
    val, g_kd, g_emit = _grads(scene, cfg)
    h = 1e-3
    with torch.no_grad():
        fd_kd = (float(_loss(scene, cfg, 1 + h, 1.0))
                 - float(_loss(scene, cfg, 1 - h, 1.0))) / (2 * h)
        fd_emit = (float(_loss(scene, cfg, 1.0, 1 + h))
                   - float(_loss(scene, cfg, 1.0, 1 - h))) / (2 * h)
    assert g_kd > 0.0 and g_emit > 0.0
    np.testing.assert_allclose(g_kd, fd_kd, rtol=2e-2)
    np.testing.assert_allclose(g_emit, fd_emit, rtol=2e-2)
    np.testing.assert_allclose(g_emit, val, rtol=1e-5)


def test_grad_per_object_albedo(cbox):
    """The (O,3) gradient is finite and non-negative (radiance is monotone
    in albedo), and its largest entry matches its central difference
    (h = 5e-3) within 3%."""
    scene, cfg = cbox
    kd = scene.mat_kd.clone().requires_grad_(True)
    _loss_kd(scene, cfg, kd).backward()
    g = kd.grad.numpy()
    assert np.isfinite(g).all() and (g >= -1e-6).all()
    o, c = np.unravel_index(np.argmax(g), g.shape)
    h = 1e-3
    e = torch.zeros_like(scene.mat_kd)
    e[o, c] = h
    with torch.no_grad():
        fd = (float(_loss_kd(scene, cfg, scene.mat_kd + e))
              - float(_loss_kd(scene, cfg, scene.mat_kd - e))) / (2 * h)
    np.testing.assert_allclose(g[o, c], fd, rtol=3e-2)


def test_inverse_rendering_recovers_albedo(cbox):
    """tests/test_grad.py's recovery: 40 gradient steps of size 2 on an
    albedo scale find the 0.7 that made the target within 0.02."""
    scene, cfg = cbox
    with torch.no_grad():
        target = float(_loss(scene, cfg, 0.7, 1.0))
    s = 1.0
    for _ in range(40):
        a = torch.tensor(s, requires_grad=True)
        ((_loss(scene, cfg, a, 1.0) - target) ** 2).backward()
        s = s - 2.0 * float(a.grad)
    assert abs(s - 0.7) < 0.02, s


def test_compacted_trace_grad_equals_plain(cbox):
    """A length-compaction schedule leaves the gradient as it is: the
    compacted trace equals the plain one lane for lane, and so does its
    backward pass (measured equal). At 5 bounces 256 of the 576 lanes
    live after the fourth, so the split (4, 2) narrows the wavefront to
    288 lanes."""
    scene, cfg = cbox
    cfg = dataclasses.replace(cfg, max_bounce=5)
    grads = []
    for sched in ((), ((4, 2),)):
        kd = scene.mat_kd.clone().requires_grad_(True)
        s = dataclasses.replace(scene, mat_kd=kd)
        render_batch_pt(s, cfg, rng.PRNGKey(KEY), 1, 1,
                        schedule=sched).mean().backward()
        grads.append(kd.grad.numpy())
    assert grads[0].max() > 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6, atol=1e-9)


# ----------------------------- ratio tracking -------------------------------

@pytest.fixture(scope="module")
def tracking_jax():
    """tests/test_grad_volume.py's probe at 256 rays, key 7, DIFF_STEPS =
    64: (transmittance, d mean / d eps, d mean / d grid)."""
    saved = jax_volume_ops.DIFF_STEPS
    jax_volume_ops.DIFF_STEPS = 64
    try:
        ro, rd = TV._rays(256, seed=1)
        key = jax.random.PRNGKey(7)
        true = TV._true_grid()
        probe = jnp.asarray(_probe())

        def eps_loss(eps):
            g = jnp.clip(true + eps * probe * 0.02, 0.0, TV.BOUND)
            return jnp.mean(TV._tr(g, ro, rd, key))

        tr = np.asarray(TV._tr(true, ro, rd, key))
        g_eps = float(jax.grad(eps_loss)(0.0))
        g_grid = np.asarray(jax.grad(
            lambda g: jnp.mean(TV._tr(g, ro, rd, key)))(true))
    finally:
        jax_volume_ops.DIFF_STEPS = saved
    return tr, g_eps, g_grid


def _probe():
    return np.random.default_rng(3).uniform(-1, 1, (RV.R,) * 3) \
        .astype(np.float32)


def _eps_loss(eps, ro, rd):
    g = torch.clamp(RV.true_grid("cpu")
                    + eps * torch.from_numpy(_probe()) * 0.02, 0.0, RV.BOUND)
    return RV.transmittance(g, ro, rd, rng.PRNGKey(7)).mean()


def test_problem_equals_jax():
    """recover_volume's rays, blob and majorants are the JAX test's."""
    ro, rd = RV.rays(256, 1, "cpu")
    jro, jrd = TV._rays(256, seed=1)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jrd))
    np.testing.assert_array_equal(RV.true_grid("cpu").numpy(),
                                  np.asarray(TV._true_grid()))
    vol = RV.make_vol(RV.true_grid("cpu"))
    np.testing.assert_array_equal(vol.sv_maj.numpy(), TV._SV)
    assert vol.sv_size == TV._S_SV and volume_ops.DIFF_STEPS == 0


def test_diff_march_equals_jax(tracking_jax):
    """The DIFF_STEPS march's transmittance and its gradients against the
    JAX package's. Measured: every lane's transmittance equal, the probe
    gradient 7e-7 relative and the per-voxel gradient 0 apart. Bounds:
    at most 0.5% of lanes may differ (tests/test_torch_volume.py's
    allowance for XLA's CPU log1p), the gradients within 1e-5."""
    tr_j, g_eps_j, g_grid_j = tracking_jax
    ro, rd = RV.rays(256, 1, "cpu")
    with torch.no_grad():
        tr = RV.transmittance(RV.true_grid("cpu"), ro, rd,
                              rng.PRNGKey(7))
    assert (tr.numpy() != tr_j).mean() <= 5e-3
    np.testing.assert_allclose(tr.numpy(), tr_j, rtol=1e-6, atol=1e-6)
    eps = torch.tensor(0.0, requires_grad=True)
    _eps_loss(eps, ro, rd).backward()
    np.testing.assert_allclose(float(eps.grad), g_eps_j, rtol=1e-5)
    g = RV.true_grid("cpu").requires_grad_(True)
    RV.transmittance(g, ro, rd, rng.PRNGKey(7)).mean().backward()
    np.testing.assert_allclose(g.grad.numpy(), g_grid_j, rtol=1e-5,
                               atol=1e-7)
    assert volume_ops.DIFF_STEPS == 0        # restored after each march


def test_diff_march_matches_finite_differences():
    """tests/test_grad_volume.py's check on the port: central differences
    at h = 0.05 along the probe, rtol 5e-2, atol 1e-5."""
    ro, rd = RV.rays(256, 1, "cpu")
    eps = torch.tensor(0.0, requires_grad=True)
    _eps_loss(eps, ro, rd).backward()
    h = 1e-3
    with torch.no_grad():
        fd = (float(_eps_loss(h, ro, rd))
              - float(_eps_loss(-h, ro, rd))) / (2 * h)
    np.testing.assert_allclose(float(eps.grad), fd, rtol=5e-2, atol=1e-5)


def test_short_density_recovery():
    """30 Adam steps at lr 0.25 on 1,024 rays (tests/test_grad_volume.py
    takes 200 at lr 0.15 on 4,096: chip_smoke phase 21 runs that).
    Measured here: interior mean error 5.9e-3 (0.039 A) from 2.4e-2 at the
    start, correlation 0.9725; bounds 0.06 A, a third of the start's error
    and 0.95."""
    rec, true, init, curve = RV.recover(n_rays=1024, steps=30, lr=0.25,
                                    device="cpu")
    err, corr = RV.interior_error(rec, true)
    err0 = float(np.abs(init - true)[2:-2, 2:-2, 2:-2].mean())
    assert err < 0.06 * RV.A and corr > 0.95, (err, corr)
    assert err < err0 / 3 and curve[-1] < 0.1 * curve[0], (err0, curve)


def test_recover_volume_cli(tmp_path, monkeypatch, capsys):
    """`python -m adapt_tpu_torch.recover_volume --arch cpu` (its 300
    steps cut to 2 here): the loss curve and the error printed, the three
    mid slices written side by side with PIL."""
    real = RV.recover
    monkeypatch.setattr(RV, "recover", lambda n, steps, *a, **kw:
                        real(256, 2, *a, **kw))
    RV.main(["--out", str(tmp_path), "--arch", "cpu"])
    out = capsys.readouterr().out
    assert "loss curve:" in out and "interior mean abs err" in out
    from PIL import Image
    img = Image.open(tmp_path / "volume_recovery.png")
    assert img.size == (3 * RV.R * 16, RV.R * 16)


# ------------------------------ hits carry no graph -------------------------

def test_wrappers_outputs_carry_no_graph():
    """Every intersection wrapper's outputs carry no autograd graph on the
    CPU, where rays that need a gradient go in: hits are constants."""
    from test_torch_bvh import knot_assets
    knot_assets()
    outs = []
    for name in ("cbox.xml", "knot2k-test.xml"):
        scene, cfg, _ = load_scene(os.path.join(SCENE_DIR, "cbox"), name,
                                   device="cpu")
        cfg = dataclasses.replace(cfg, w=16, h=16,
                                  focal=cfg.focal * 16 / cfg.w, end_x=16,
                                  end_y=16)
        ro, rd = camera_rays(scene, cfg, rng.PRNGKey(0), 1)
        s = torch.tensor(1.0, requires_grad=True)
        ro, rd = ro * s, rd * s
        far0 = intersect_kernels.far_bound(ro)
        assert ro.requires_grad and rd.requires_grad
        if name == "cbox.xml":
            outs += intersect_kernels.tri_closest_hit(scene, ro, rd, far0)
            outs.append(intersect_kernels.tri_any_hit(scene, ro, rd, far0))
            outs += intersect_kernels.tri_track_hits(scene, ro, rd, far0, 2,
                                                     all_null=True)
            continue
        n = ro.shape[0]
        picks = torch.zeros(cluster_kernels._tiles(n), dtype=torch.int32)
        wid0 = torch.full((n,), -1, dtype=torch.int32)
        outs += bvh_kernels.bvh_closest_hit(scene, ro, rd, far0)
        outs.append(bvh_kernels.bvh_any_hit(scene, ro, rd, far0))
        outs += cluster_kernels.cluster_closest_hit(scene, ro, rd, far0)
        outs.append(cluster_kernels.cluster_any_hit(scene, ro, rd, far0))
        outs += cluster_kernels.cluster_front(scene, ro, rd, far0)
        outs += cluster_kernels.cluster_pick_closest(scene, ro, rd, far0,
                                                     wid0, picks)
        outs.append(cluster_kernels.cluster_pick_any(scene, ro, rd, far0,
                                                     picks))
    assert len(outs) == 31
    assert not any(o.requires_grad or o.grad_fn is not None for o in outs)


def test_hits_follow_the_ray():
    """The searches of ops/intersect.py return no graph: which prim a ray
    hits is a constant (the sphere roots and the record that are plain
    PyTorch there included; csphere/balls-multi.xml has spheres and
    triangles). Where the hit lies follows the ray: under autograd
    `ray_intersect` gives the no-grad query's values bit for bit, and the
    derivative of its distance, barycentrics and normals along a random
    move of the rays' origins and directions is the central difference
    of the query on triangle lanes (h = 1e-3, lanes whose prim stays;
    measured 1.2e-4 relative) and of the reference quadratic, normal and
    angles in float64 on sphere lanes (h = 1e-6: the float32 sphere test
    cancels too much to difference; measured 1.9e-4, the float32
    derivative's own cancellation). Bounds 1e-2 and 1e-3."""
    from adapt_tpu_torch.ops import intersect
    scene, cfg, _ = load_scene(os.path.join(SCENE_DIR, "csphere"),
                               "balls-multi.xml", device="cpu")
    cfg = dataclasses.replace(cfg, w=32, h=32,
                              focal=cfg.focal * 32 / min(cfg.w, cfg.h),
                              end_x=32, end_y=32)
    ro0, rd0 = camera_rays(scene, cfg, rng.PRNGKey(0), 1)
    g = np.random.default_rng(5)
    do = torch.from_numpy(g.standard_normal(ro0.shape).astype(np.float32))
    dd = torch.from_numpy(g.standard_normal(rd0.shape).astype(np.float32))
    s = torch.tensor(0.0, requires_grad=True)
    ro, rd = ro0 + s * do, rd0 + s * dd

    def query(h):
        with torch.no_grad():
            return intersect.ray_intersect(scene, cfg, ro0 + h * do,
                                           rd0 + h * dd)

    it, it0 = intersect.ray_intersect(scene, cfg, ro, rd), query(0.0)
    for f in ("obj_id", "prim_id", "t", "n_g", "n_s", "uv"):
        assert torch.equal(getattr(it, f), getattr(it0, f)), f
    assert not (it.obj_id.requires_grad or it.prim_id.requires_grad)
    assert it.t.requires_grad and it.uv.requires_grad
    for out in (intersect._closest_hit(scene, cfg, ro, rd, None, None),
                [intersect.does_intersect(scene, cfg, ro, rd)],
                intersect.ray_track_hits(scene, cfg, ro, rd, None),
                intersect.ray_k_hits(scene, cfg, ro, rd, None)):
        out = dataclasses.astuple(out) if dataclasses.is_dataclass(out) \
            else out
        assert not any(torch.is_tensor(o) and (o.requires_grad
                                               or o.grad_fn is not None)
                       for o in out)

    prim = it0.prim_id.long()
    sph = it0.is_hit & scene.prim_is_sphere[prim]
    h = 1e-3
    hp, hm = query(h), query(-h)
    tri = it0.is_hit & ~sph & (hp.prim_id == it0.prim_id) \
        & (hm.prim_id == it0.prim_id)
    # sphere lanes away from the u seam (atan2 at +-pi) and from grazing
    # (where the float32 derivative of the root cancels as its value does)
    n = it0.n_g
    sph &= ~((n[:, 0] < 0.0) & (torch.abs(n[:, 1]) < 0.05)) \
        & (torch.abs(dot(n, rd0)) > 0.3)
    assert int(tri.sum()) > 200 and int(sph.sum()) > 50
    w = torch.from_numpy(g.uniform(0.5, 1.5, (ro.shape[0], 9))
                         .astype(np.float32))

    def total(x, lanes):
        m = w * lanes[:, None]
        return (x.t * m[:, 0]).sum() + (x.uv * m[:, 1:3]).sum() \
            + (x.n_g * m[:, 3:6]).sum() + (x.n_s * m[:, 6:9]).sum()

    def sphere64(h):
        """The reference sphere hit in float64: total() of its fields."""
        o = (ro0.double() + h * do.double()).numpy()[sph.numpy()]
        d = (rd0.double() + h * dd.double()).numpy()[sph.numpy()]
        c = scene.pre0[prim[sph]].double().numpy()
        r = scene.pre1[prim[sph]][:, 0].double().numpy()
        s2c = c - o
        proj = (d * s2c).sum(1)
        t = proj - np.sqrt(r * r - ((s2c * s2c).sum(1) - proj * proj))
        p = o + t[:, None] * d - c
        nn = p / np.linalg.norm(p, axis=1, keepdims=True)
        u = (np.arctan2(nn[:, 1], nn[:, 0]) + np.pi) / (2 * np.pi)
        v = np.arccos(nn[:, 2]) / np.pi
        m = w[sph].double().numpy()
        return (t * m[:, 0]).sum() + (u * m[:, 1]).sum() \
            + (v * m[:, 2]).sum() + (nn * m[:, 3:6]).sum() \
            + (nn * m[:, 6:9]).sum()

    assert bool((it0.t[sph] <= dot(rd0, scene.pre0[prim] - ro0)[sph]).all())
    for lanes, fd, rtol in (
            (tri, (float(total(hp, tri)) - float(total(hm, tri))) / (2 * h),
             1e-2),
            (sph, (sphere64(1e-6) - sphere64(-1e-6)) / 2e-6, 1e-3)):
        s.grad = None
        total(it, lanes).backward(retain_graph=True)
        np.testing.assert_allclose(float(s.grad), fd, rtol=rtol)
