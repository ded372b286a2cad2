"""Vectorized 3D math for ray batches (port of adapt_tpu/ops/math3d.py).

Dot products and norms are written out as
((x0*y0 + x1*y1) + x2*y2), the order the JAX package's size-3 reductions
take op by op, so results round like it does (no FMA, no pairwise
reordering). Where a cancellation magnifies the last bit, `fma_dot`
takes the fused chain XLA's CPU backend makes of them instead.

Gradient safety (the JAX package's invariants, adapt_tpu/ops/math3d.py
and docs/differentiable.md "Masked-lane hygiene"): autograd, like
jax.grad, differentiates both branches of every torch.where, so one
infinite derivative in a masked lane times its zero cotangent is a NaN
that poisons the whole image gradient. Every square root of a value that
can be 0 goes through `sqrt0`, whose derivative there is 0; its forward
values are torch.sqrt's, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rot


def axis_vec(k: int, device) -> torch.Tensor:
    """Unit vector along axis k, made on the device by a fill (a
    torch.tensor([...], device=cuda) is a host copy that waits for the
    stream; the bounce loop must not)."""
    v = torch.zeros(3, device=device)
    v[k] = 1.0
    return v


def dot(a, b, keepdims=False):
    p = a * b
    s = (p[..., 0] + p[..., 1]) + p[..., 2]
    return s[..., None] if keepdims else s


def fma_dot(a, b):
    """dot() as XLA's CPU backend computes a size-3 contraction (an
    einsum, or a sum of products it fuses): the chain of fused
    multiply-adds fma(a2, b2, fma(a1, b1, a0 * b0)), each product-sum
    rounded once to f32. The products are exact in float64, so only the
    f64 rounding of each sum comes before the f32 one (a double rounding
    that differs from a fused one only at f32 ties). For a test whose
    cancellation turns one ULP into many, such as the sphere test."""
    a64, b64 = a.double(), b.double()
    s = (a[..., 0] * b[..., 0]).double()
    s = (a64[..., 1] * b64[..., 1] + s).float().double()
    return (a64[..., 2] * b64[..., 2] + s).float()


def sqrt0(x):
    """torch.sqrt(x) with derivative 0 where x <= 0 (sqrt's own is
    infinite at 0). The guard runs only when x needs a gradient; forward
    values are torch.sqrt's in both cases, NaN of a negative x included."""
    if not x.requires_grad:
        return torch.sqrt(x)
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)),
                       torch.sqrt(x.detach()))


def norm(v, keepdims=False):
    return sqrt0(dot(v, v, keepdims))


def normalize(v, eps=1e-12):
    return v / torch.clamp(norm(v, keepdims=True), min=eps)


def safe_normalize(v, eps=1e-12):
    """normalize() with the zero-vector branch of the JAX package (there
    for gradient safety; forward values equal normalize() for v != 0)."""
    n2 = dot(v, v, keepdims=True)
    n = torch.sqrt(torch.where(n2 == 0.0, 1.0, n2))
    return v / torch.clamp(n, min=eps)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rotate_between_apply(fixed, target, v):
    """Rodrigues rotation taking `fixed` to `target`, applied to v:
    v' = v cos + (axis x v) + k (k.v)(1-cos), with the +/-v fallback at
    (anti)parallel inputs (reference la/cam_transform.py:51-68)."""
    fixed = fixed.expand(target.shape)
    axis = cross(fixed, target)              # |axis| = sin(theta)
    cos_t = dot(fixed, target, keepdims=True)
    k = safe_normalize(axis)
    out = (v * cos_t + cross(axis, v)
           + k * dot(k, v, keepdims=True) * (1.0 - cos_t))
    parallel = torch.abs(cos_t) >= 1.0 - 1e-5
    return torch.where(parallel, torch.sign(cos_t) * v, out)


def delocalize_rotate(anchor, local_dir):
    """Local (y-up) frame -> global frame around `anchor`
    (reference la/cam_transform.py:89-93)."""
    return rotate_between_apply(axis_vec(1, anchor.device), anchor,
                                local_dir)


def rotation_between(fixed, target):
    """Batched Rodrigues rotation taking `fixed` to `target` (both unit);
    returns (..., 3, 3). The skew term uses the unnormalized cross product
    (|axis| = sin(theta)); near (anti)parallel inputs fall back to +/-
    identity (reference la/cam_transform.py:51-68)."""
    fixed = fixed.expand(target.shape)
    axis = cross(fixed, target)                        # |axis| = sin
    cos_t = dot(fixed, target)[..., None, None]
    axis_n = safe_normalize(axis)
    eye = torch.eye(3, dtype=target.dtype, device=target.device)
    outer = axis_n[..., :, None] * axis_n[..., None, :]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(ax)
    skew = torch.stack([
        torch.stack([zeros, -az, ay], dim=-1),
        torch.stack([az, zeros, -ax], dim=-1),
        torch.stack([-ay, ax, zeros], dim=-1),
    ], dim=-2)
    rot = cos_t * eye + (1.0 - cos_t) * outer + skew
    parallel = torch.abs(cos_t) >= 1.0 - 1e-5
    return torch.where(parallel, torch.sign(cos_t) * eye, rot)


def rotation_from_y(target):
    """rotation_between([0,1,0], target): the tangent-frame case."""
    return rotation_between(axis_vec(1, target.device), target)


def localize_rotate(anchor, global_dir):
    """Global frame -> local y-up frame of `anchor`
    (reference la/cam_transform.py:95-99)."""
    return rotate_between_apply(anchor,
                                axis_vec(1, anchor.device).expand(
                                    anchor.shape), global_dir)


def world_frame(local_anchor, global_anchor, local_dir):
    """Rotate `local_dir` by the rotation taking local_anchor to
    global_anchor (reference la/cam_transform.py:101-105)."""
    return rotate_between_apply(local_anchor, global_anchor, local_dir)


def convert_to_raw(d_in, normal):
    """Direction -> (cos_theta, sin_theta, cos_phi, sin_phi) in the
    normal's local frame (reference la/cam_transform.py:70-87); (..., 4)."""
    local_dir = localize_rotate(normal, d_in)
    cos_theta = local_dir[..., 1]
    sin_theta = sqrt0(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    safe = sin_theta > 1e-5
    inv_sin = torch.where(safe, 1.0 / torch.clamp(sin_theta, min=1e-12),
                          0.0)
    cos_phi = torch.where(safe, local_dir[..., 0] * inv_sin, 1.0)
    sin_phi = torch.where(safe, local_dir[..., 2] * inv_sin, 0.0)
    return torch.stack([cos_theta, sin_theta, cos_phi, sin_phi], dim=-1)


def np_rotation_between(fixed: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Host-side camera rotation with roll elimination
    (reference la/cam_transform.py:32-49); a copy of the JAX package's."""
    d = float(np.dot(fixed, target))
    if d > 1.0 - 1e-5:
        return np.eye(3, dtype=np.float32)
    if d < -1.0 + 1e-5:
        up = np.float64([0.0, 1.0, 0.0])
        axis = up - np.float64(fixed) * np.dot(fixed, up)
        if np.linalg.norm(axis) < 1e-6:      # fixed is (anti)parallel to up
            ex = np.float64([1.0, 0.0, 0.0])
            axis = ex - np.float64(fixed) * np.dot(fixed, ex)
        axis = axis / np.linalg.norm(axis) * np.pi
    else:
        axis = np.cross(fixed, target).astype(np.float64)
        axis /= np.linalg.norm(axis)
        axis *= np.arccos(d)
    euler = Rot.from_rotvec(axis).as_euler("zxy")
    euler[0] = 0.0  # eliminate roll
    return Rot.from_euler("zxy", euler).as_matrix().astype(np.float32)


def fov2focal(fov_deg: float, img_size: float) -> float:
    """Pinhole focal length in pixels (reference la/cam_transform.py:20-22)."""
    fov = fov_deg / 180.0 * np.pi
    return 0.5 * img_size / np.tan(0.5 * fov)
