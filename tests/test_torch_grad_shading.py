"""Differentiable rendering in the port beyond albedo and emission: the
gradients with respect to the glossy and refracting materials' tables
(`mat_ks`, `mat_kg`) and to the media's coefficients, held against the JAX
package's derivatives of the same loss. Each of these parameters moves
rays (a direction sampled from a lobe or refracted through a coat, a
scatter distance drawn from the extinction), so each gradient also runs
through where the next hit lies: ops/intersect.py `_follow_ray`, and the
sequential media walk that renderer/vpt.py `track_ray` differentiates.

* PT on csphere/balls-multi.xml (Fresnel blend, modified Phong, Phong,
  mirror, a glass ball) and csphere/mix-balls.xml (Oren-Nayar, thin
  coat, Fresnel blend, BxDF mixtures) at 24^2, 3 bounces, 2 spp, no
  Russian roulette, no jitter, key 42: the loss and the (O,3) gradients
  of mean radiance with respect to `mat_ks` and `mat_kg`, finite, against
  `jax.grad` where the JAX package's gradient is finite and against its
  forward-mode derivative (`jax.jacfwd`) everywhere. jax.grad's `mat_kg`
  gradient has NaN entries on both scenes (a masked lane's infinite
  derivative reaches every row through the one-hot gathers: columns 0
  and 1 on balls-multi, column 2 on mix-balls); the port's square roots
  of values that can be 0 (`ops/math3d.py sqrt0`) and its emission-MIS
  mask of dead lanes (`renderer/pt.py`) keep its own finite, and forward
  mode, which never carries a masked branch's tangent, gives the values
  it is held to there.
* VPT on vpt/cbox.xml (homogeneous media) at the same settings: the
  derivative of mean radiance with respect to a density scale of every
  medium (u_a, u_s, u_e) and a scattering scale (u_s, and u_e with it),
  against jax.jacfwd (the JAX package's VPT cannot be reversed: its media
  walk is a lax.while_loop).

The JAX references take minutes to trace and compile on the CPU, so they
are written once, to tests/goldens/grad_shading_24.npz, by running this
file from the repository's root:
`PYTHONPATH=. python tests/test_torch_grad_shading.py`. Each tolerance
is stated beside its measured worst (this file's run on the CPU).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from adapt_tpu_torch import rng
from adapt_tpu_torch.renderer.pt import render_batch_pt
from adapt_tpu_torch.renderer.vpt import render_batch_vpt
from adapt_tpu_torch.scene.compile import load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")
GOLDEN = os.path.join(HERE, "goldens", "grad_shading_24.npz")
KEY = 42
SPP = 2
PT_SCENES = ("balls-multi.xml", "mix-balls.xml")


def small(cfg):
    """tests/test_grad.py's settings at 24^2 and 3 bounces, the field of
    view kept."""
    return dataclasses.replace(
        cfg, w=24, h=24, focal=cfg.focal * 24 / min(cfg.w, cfg.h),
        end_x=24, end_y=24, max_bounce=3, use_rr=False, anti_alias=False,
        stratified_sampling=False)


def scale_media(table, density, scatter):
    """A medium table with every coefficient times `density` and u_s times
    `scatter` (u_e = u_a + u_s follows); at (1, 1) the table itself, bit
    for bit. Works on the JAX package's table and on the port's."""
    u_s = table.u_s * scatter
    u_e = table.u_e + (scatter - 1.0) * table.u_s
    return dataclasses.replace(table, u_a=table.u_a * density,
                               u_s=u_s * density, u_e=u_e * density)


def _tag(name):
    return name.split(".")[0].replace("-", "_")


def material_grads(name, device="cpu"):
    """The port's loss and (O,3) d loss / d mat_ks, d mat_kg on a csphere
    scene (numpy)."""
    scene, cfg, _ = load_scene(os.path.join(SCENES, "csphere"), name,
                               device=device)
    ks = scene.mat_ks.clone().requires_grad_(True)
    kg = scene.mat_kg.clone().requires_grad_(True)
    s = dataclasses.replace(scene, mat_ks=ks, mat_kg=kg)
    loss = render_batch_pt(s, small(cfg), rng.PRNGKey(KEY), 1, SPP).mean()
    loss.backward()
    return (float(loss.detach()), ks.grad.cpu().numpy(),
            kg.grad.cpu().numpy())


def media_grads(device="cpu"):
    """The port's loss and d loss / d (density scale, scattering scale)
    through VPT on vpt/cbox.xml (numpy)."""
    scene, cfg, _ = load_scene(os.path.join(SCENES, "vpt"), "cbox.xml",
                               device=device)
    params = torch.ones(2, device=scene.device, requires_grad=True)
    s = dataclasses.replace(
        scene, medium=scale_media(scene.medium, params[0], params[1]),
        world_medium=scale_media(scene.world_medium, params[0], params[1]))
    loss = render_batch_vpt(s, small(cfg), rng.PRNGKey(KEY), 1, SPP).mean()
    loss.backward()
    return float(loss.detach()), params.grad.cpu().numpy()


def _excess(got, ref, rtol, atol=0.0):
    """The largest |got - ref| / (atol + rtol |ref|): 1 at the bound."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / (atol + rtol * np.abs(ref))))


def material_excess(golden, name, loss, g_ks, g_kg):
    """How far the port's loss and gradients are from the JAX package's,
    in units of the bounds (at most 1 passes): the loss within 5e-5, the
    gradients within 2e-3 relative plus 2e-4 of the largest absolute, of
    jax.grad where it is finite and of jax.jacfwd everywhere. Infinite
    where the port's gradient is not finite."""
    tag = _tag(name)
    worst = _excess(loss, golden[f"{tag}_loss"], 5e-5)
    for leaf, grad in (("ks", g_ks), ("kg", g_kg)):
        rev = golden[f"{tag}_grad_{leaf}"]
        fwd = golden[f"{tag}_jacfwd_{leaf}"]
        if grad.shape != rev.shape or not np.isfinite(grad).all():
            return float("inf")
        top = np.abs(fwd).max()
        ok = np.isfinite(rev)
        worst = max(worst, _excess(grad[ok], rev[ok], 2e-3, 2e-4 * top),
                    _excess(grad, fwd, 2e-3, 2e-4 * top))
    return worst


def media_excess(golden, loss, grad):
    """As material_excess for VPT's medium gradients: the loss and the
    gradient within 1e-5 relative of the JAX package's (jax.jacfwd)."""
    if not np.isfinite(grad).all() or not (np.abs(grad) > 1e-4).all():
        return float("inf")
    return max(_excess(loss, golden["vpt_loss"], 1e-5),
               _excess(grad, golden["vpt_jacfwd"], 1e-5))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("name", PT_SCENES)
def test_material_grads_equal_jax(golden, name):
    """d mean / d mat_ks and d mat_kg, (O,3) each (material_excess).
    Measured worst: the loss 5.9e-6 relative from the JAX package's on
    balls-multi (equal on mix-balls); the gradients 9.1e-4 relative on
    balls-multi's entries above 1e-3 of the largest and 5.1e-5 of the
    largest absolute, 1.9e-6 relative on mix-balls (balls-multi's passes
    differ by the rounding tests/test_torch_materials.py states: pow of
    large exponents, convert_to_raw near the normal): 0.23 of the bounds.
    Without the hit following the ray, mix-balls' coat-IOR entry is 8.7%
    off (a central difference agrees with the JAX package)."""
    loss, g_ks, g_kg = material_grads(name)
    worst = material_excess(golden, name, loss, g_ks, g_kg)
    assert worst <= 1.0, (worst, loss, g_ks, g_kg)


def test_media_grads_equal_jax(golden):
    """d mean / d (density scale, scattering scale) through VPT
    (media_excess). Measured: the loss 1.6e-7 relative from the JAX
    package's, the gradient 1.9e-7. With every hit held constant the
    density entry is 0.31% off; with only the closest hits following the
    ray (the media walk's interfaces constant), 0.13%."""
    loss, grad = media_grads()
    worst = media_excess(golden, loss, grad)
    assert worst <= 1.0, (worst, loss, grad)


# ------------------------- square roots at zero -----------------------------

def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _lanes(n=64):
    """Normals and directions with the lanes that put a square root's
    argument at exactly 0: directions along the normal and against it
    (lanes 0-15), perpendicular to it (16-23), and axis-aligned ones whose
    cosine is exactly 0 (24-31); uniforms at 0 (0-7 and the first of
    24-31) and at (1, 0) (8-15); the rest random."""
    g = np.random.default_rng(0)
    nrm = _unit(g.standard_normal((n, 3))).astype(np.float32)
    d = _unit(g.standard_normal((n, 3))).astype(np.float32)
    d[:8], d[8:16] = nrm[:8], -nrm[8:16]
    d[16:24] = _unit(np.cross(nrm[16:24], g.standard_normal((8, 3))))
    nrm[24:32], d[24:32] = (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)
    u = g.uniform(0, 1, (n, 8)).astype(np.float32)
    u[:8], u[8:16, 0], u[8:16, 1], u[24:32, 0] = 0.0, 1.0, 0.0, 0.0
    return (torch.from_numpy(nrm).requires_grad_(True),
            torch.from_numpy(d).requires_grad_(True), torch.from_numpy(u))


def _full(n, value, lanes=None, other=None):
    """(n,) leaf of `value`, `other` on `lanes`."""
    x = torch.full((n,), value)
    if lanes is not None:
        x[lanes] = other
    return x.requires_grad_(True)


def _mat_it(nrm):
    """A thin-coat material (mix-balls' row; coat IOR 0.5 on even lanes,
    1 on the axis-aligned ones) and an interaction with normal nrm."""
    from adapt_tpu_torch.ops import bxdf_ops
    from adapt_tpu_torch.ops.intersect import Interaction
    n = nrm.shape[0]
    kg = torch.tensor([[0.7346562, 0.3625565, 1.9]]).repeat(n, 1)
    kg[::2, 2], kg[24:32, 2] = 0.5, 1.0
    ior = torch.full((n,), 1.5)
    ior[::3], ior[24:32] = 0.6, 1.0
    mat = bxdf_ops.MatParams(
        kind=torch.full((n,), 7, dtype=torch.int32),
        is_bsdf=torch.zeros(n, dtype=torch.bool),
        is_delta=torch.zeros(n, dtype=torch.bool),
        kd=torch.full((n, 3), 0.5), ks=torch.full((n, 3), 0.8)
        .requires_grad_(True), kg=kg.requires_grad_(True),
        mean=torch.zeros(n, 3), ior=ior.requires_grad_(True),
        emit=torch.full((n,), -1, dtype=torch.int32))
    it = Interaction(obj_id=torch.zeros(n, dtype=torch.int32),
                     prim_id=torch.zeros(n, dtype=torch.int32),
                     t=torch.ones(n), n_g=nrm, n_s=nrm,
                     uv=torch.zeros(n, 2))
    return mat, it


def _site(name):
    """(outputs, leaves) of one function of the PT path whose square roots
    go through sqrt0, on _lanes()."""
    from adapt_tpu_torch.ops import bxdf_ops, geo_optics, math3d, sampling
    nrm, d, u = _lanes()
    n = d.shape[0]
    if name == "normalize":
        return [math3d.normalize(d * (torch.arange(n) >= 8)[:, None])], [d]
    if name == "convert_to_raw":
        return [math3d.convert_to_raw(d, nrm)], [d, nrm]
    if name == "spherical":
        c = _full(n, 0.5, slice(0, 16), 1.0)
        return [sampling._spherical(c, u[:, 1] * 6.0)], [c]
    if name == "fresnel_hemisphere":
        nu, nv = _full(n, 10.0), _full(n, 1000.0)
        return list(sampling.fresnel_hemisphere(u[:, 0], u[:, 1], nu,
                                                nv)), [nu, nv]
    if name == "fresnel_eval":
        # normal incidence (lanes 0-7); grazing at a unit ratio (8-15)
        c = _full(n, 0.3, slice(0, 8), 1.0)
        c.data[8:16] = 0.0
        n_in, n_tr = _full(n, 1.0), _full(n, 1.5, slice(32, n), 0.6)
        n_tr.data[8:16] = 1.0
        return [geo_optics.fresnel_eval(c, n_in, n_tr)], [c, n_in, n_tr]
    if name == "snell_refraction":
        ni, nr = _full(n, 1.5, slice(24, 32), 1.0), _full(n, 1.0)
        return list(geo_optics.snell_refraction(
            d, nrm, math3d.dot(d, nrm), ni, nr)), [d, nrm, ni, nr]
    if name == "ggx_sample_wh":
        ax, ay = _full(n, 0.3), _full(n, 0.2)
        return [bxdf_ops._ggx_sample_wh(d, ax, ay, u[:, 0], u[:, 1])], \
            [ax, ay, d]
    mat, it = _mat_it(nrm)
    if name == "eval_thin_coat":
        out = torch.roll(d.detach(), 5, 0).requires_grad_(True)
        return [bxdf_ops.eval_thin_coat(mat, it, d, out)], \
            [mat.kg, mat.ks, d, nrm, out]
    if name == "thin_coat_fresnel":
        return [bxdf_ops._thin_coat_fresnel(mat, it, d)], [mat.kg, d, nrm]
    if name == "sample_thin_coat":
        return list(bxdf_ops._sample_thin_coat(mat, it, d, u)[:3]), \
            [mat.kg, mat.ks, d, nrm]
    assert name == "refraction_terms"
    outs = bxdf_ops._refraction_terms(mat, it, d, torch.tensor(1.0))
    return [o for o in outs if o.dtype.is_floating_point], [mat.ior, d, nrm]


def _grads_finite(name):
    outs, leaves = _site(name)
    assert all(bool(torch.isfinite(o).all()) for o in outs), name
    w = torch.Generator().manual_seed(1)
    total = sum((o * torch.rand(o.shape, generator=w)).sum() for o in outs)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return all(g is None or bool(torch.isfinite(g).all()) for g in grads)


SITES = ("normalize", "convert_to_raw", "spherical", "fresnel_hemisphere",
         "fresnel_eval", "snell_refraction", "ggx_sample_wh",
         "eval_thin_coat", "thin_coat_fresnel", "sample_thin_coat",
         "refraction_terms")


@pytest.mark.parametrize("name", SITES)
def test_sqrt0_keeps_gradients_finite(name, monkeypatch):
    """Each function of the PT path with a square root of a value that
    can be exactly 0 (a direction along the normal, a uniform at 0 or 1,
    a cosine of exactly 0 at a unit IOR ratio): its gradients are finite,
    and with every sqrt0 of the port swapped for torch.sqrt (whose
    derivative at 0 is infinite) they are not, so the guard is what
    keeps them finite. (A negative argument clamped to 0 needs no guard
    in torch: clamp's backward drops the lane; jnp.maximum's does not.)"""
    from adapt_tpu_torch.ops import bxdf_ops, geo_optics, math3d, sampling
    assert _grads_finite(name)
    for mod in (math3d, sampling, geo_optics, bxdf_ops):
        monkeypatch.setattr(mod, "sqrt0", torch.sqrt)
    assert not _grads_finite(name)


def test_sqrt0_forward_is_sqrt():
    """sqrt0's values are torch.sqrt's bit for bit, NaN of a negative
    input included, with or without a gradient; its derivative at 0 is 0
    and elsewhere sqrt's."""
    from adapt_tpu_torch.ops.math3d import sqrt0
    x = torch.tensor([-1.0, 0.0, 1e-30, 0.25, 2.0, 1e30])
    ref = torch.sqrt(x)
    for xi in (x, x.clone().requires_grad_(True)):
        y = sqrt0(xi)
        assert torch.equal(torch.isnan(y), torch.isnan(ref))
        assert torch.equal(y[1:], ref[1:])
    xg = x[1:].clone().requires_grad_(True)
    sqrt0(xg).sum().backward()
    assert xg.grad[0] == 0.0
    np.testing.assert_allclose(xg.grad[1:].numpy(),
                               (0.5 / torch.sqrt(x[2:])).numpy(), rtol=1e-6)


# --------------------------- writing the golden -----------------------------

def write_golden(path=GOLDEN):
    """The JAX package's losses and derivatives this file holds the port
    to (run on the CPU backend; minutes, most of it tracing and
    compiling)."""
    sys.path.insert(0, HERE)
    import conftest   # noqa: F401  (the CPU backend, as the suite runs)
    import jax
    import jax.numpy as jnp
    from adapt_tpu.renderer.pt import render_batch_pt as jax_batch_pt
    from adapt_tpu.renderer.vpt import render_batch_vpt as jax_batch_vpt
    from adapt_tpu.scene.compile import load_scene as jax_load_scene

    key = jax.random.PRNGKey(KEY)
    out = {}
    for name in PT_SCENES:
        tag = _tag(name)
        js, jc, _ = jax_load_scene(os.path.join(SCENES, "csphere"), name)
        jc = small(jc)

        def loss(ks, kg):
            s = dataclasses.replace(js, mat_ks=ks, mat_kg=kg)
            return jnp.mean(jax_batch_pt(s, jc, key, jnp.int32(1), SPP))

        val, (g_ks, g_kg) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1)))(js.mat_ks, js.mat_kg)
        f_ks, f_kg = jax.jit(jax.jacfwd(loss, argnums=(0, 1)))(
            js.mat_ks, js.mat_kg)
        out.update({f"{tag}_loss": np.float32(val),
                    f"{tag}_grad_ks": np.asarray(g_ks),
                    f"{tag}_grad_kg": np.asarray(g_kg),
                    f"{tag}_jacfwd_ks": np.asarray(f_ks),
                    f"{tag}_jacfwd_kg": np.asarray(f_kg)})
        print(name, "done", flush=True)

    vs, vc, _ = jax_load_scene(os.path.join(SCENES, "vpt"), "cbox.xml")
    vc = small(vc)

    def vloss(p):
        s = dataclasses.replace(
            vs, medium=scale_media(vs.medium, p[0], p[1]),
            world_medium=scale_media(vs.world_medium, p[0], p[1]))
        return jnp.mean(jax_batch_vpt(s, vc, key, jnp.int32(1), SPP))

    ones = jnp.ones(2, jnp.float32)
    out["vpt_loss"] = np.float32(jax.jit(vloss)(ones))
    out["vpt_jacfwd"] = np.asarray(jax.jit(jax.jacfwd(vloss))(ones))
    np.savez(path, **out)
    print("wrote", path, {k: v.tolist() for k, v in out.items()
                          if v.size <= 2})


if __name__ == "__main__":
    os.chdir(os.path.join(HERE, ".."))
    write_golden()
