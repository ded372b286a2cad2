"""Ray/triangle closest hit, any hit and media-walk hits: CUDA kernels and
their PyTorch twins.

`tri_closest_hit`, `tri_any_hit` and `tri_track_hits` are the port of the
Pallas TPU kernels adapt_tpu/ops/intersect_pallas.py `_tri_kernel` (via
`tri_closest_hit`), `_occ_kernel` (via `tri_any_hit`) and `_track_kernel`
(via `tri_track_hits`). On a CUDA tensor each wrapper launches its
hand-written kernel (csrc/tri_intersect.cu, built by ops/_build.py) or
raises; on a CPU tensor it runs the plain PyTorch twin beside it, which
computes the same (N, T) tables in ray chunks with the same operation
order. The wrappers read the scene's triangle tables, made once per scene
(`SceneData.tri_geo`, `tri_ng`, `tri_obj` and the media walk's row lists,
scene/compile.py `tri_tables`): a call checks its operands, allocates its
outputs and launches one kernel. The twins keep building their table with
`tri_table`. ops/_build.py launches the kernels and counts them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .math3d import axis_vec

RAY_EPS = 1e-4
FAR = 1e7
DEAD = -3e38           # far0 of a dead lane: no hit can lie before it
# separation of successive media-walk interfaces: half the walk's RAY_EPS,
# so surfaces eps-layered RAY_EPS apart are both accepted despite the
# rounding of a global-t subtraction (adapt_tpu/ops/intersect_pallas.py:29-38)
CHAIN_SEP = 0.5 * RAY_EPS
# elements per (rays, triangles) table of the twins; bounds their memory
TWIN_LANES = 1 << 22
# triangles the any-hit and media-walk kernels stage in shared memory at
# once (their TILE; the brute-force tier has at most 256, ops/intersect.py
# `_bvh_tier`)
STAGED_ROWS = 256
# null rows the media-walk kernel keeps in registers (its kNullCap); above
# it the walk re-sweeps
NULL_CAP = 16

def far_bound(ray_o, max_t=None, alive=None):
    """(N,) far bound every intersection kernel takes: hits count strictly
    before it. FAR without max_t, max_t - RAY_EPS where max_t > 0, DEAD
    where `alive` is False."""
    if max_t is None:
        far = torch.full((ray_o.shape[0],), FAR, device=ray_o.device)
    else:
        far = torch.where(max_t > 0.0, max_t - RAY_EPS, FAR)
    if alive is not None:
        far = torch.where(alive, far, DEAD)
    return far


def tri_table(scene):
    """(geo (T,12) f32: n d U cu V cv, n_g (T,3) f32, obj (T,) i32).

    n_g is the OBJ loader's geometric normal of each row (it differs from
    the plane normal n by ~1 ULP), as the Pallas kernel's table holds it."""
    geo = torch.cat([scene.tri_n, scene.tri_d[:, None], scene.tri_U,
                     scene.tri_cu[:, None], scene.tri_V,
                     scene.tri_cv[:, None]], dim=1).contiguous()
    ng = scene.prim_ng[scene.tri_gid].contiguous()
    return geo, ng, scene.tri_obj.to(torch.int32).contiguous()


# ----------------------------- plain twins -----------------------------

def _hit_tables(geo, ro, rd):
    """(n, T) t/u/v/valid of every (ray, triangle) pair; op order of
    intersect_pallas.py `_dot3` and `_tri_kernel`."""
    def d3(vec, c):
        return (vec[:, 0:1] * geo[:, c] + vec[:, 1:2] * geo[:, c + 1]) \
            + vec[:, 2:3] * geo[:, c + 2]

    o_n, d_n = d3(ro, 0), d3(rd, 0)
    o_u, d_u = d3(ro, 4), d3(rd, 4)
    o_v, d_v = d3(ro, 8), d3(rd, 8)
    flat = torch.abs(d_n) < 1e-12
    t = (geo[:, 3] - o_n) / torch.where(flat, 1e-12, d_n)
    u = o_u + t * d_u - geo[:, 7]
    v = o_v + t * d_v - geo[:, 11]
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) & ~flat
    return t, u, v, valid


def _chunks(n, T):
    """Ray ranges of at most TWIN_LANES (ray, triangle) pairs; one empty
    range when n == 0, so an empty batch gives empty outputs."""
    step = max(1, TWIN_LANES // max(T, 1))
    return [(s, min(n, s + step)) for s in range(0, max(n, 1), step)]


def tri_closest_hit_plain(scene, ray_o, ray_d, far0):
    """Twin of `tri_closest_hit` in plain PyTorch (any device)."""
    geo, ng, obj = tri_table(scene)
    T = geo.shape[0]
    outs = []
    for s, e in _chunks(ray_o.shape[0], T):
        t, u, v, valid = _hit_tables(geo, ray_o[s:e], ray_d[s:e])
        far = far0[s:e]
        tm = torch.where(valid, t, FAR)
        best_t = tm.amin(dim=1)
        rows = torch.arange(T, device=tm.device)
        best_i = torch.where(tm == best_t[:, None], rows, T).amin(dim=1)
        hit = best_t < far
        pick = best_i[:, None]
        outs.append((
            torch.where(hit, best_t, far),
            torch.where(hit, best_i, -1).to(torch.int32),
            torch.where(hit, u.gather(1, pick)[:, 0], 0.0),
            torch.where(hit, v.gather(1, pick)[:, 0], 0.0),
            torch.where(hit[:, None], ng[best_i], axis_vec(0, ng.device)),
            torch.where(hit, obj[best_i], -1).to(torch.int32)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def tri_any_hit_plain(scene, ray_o, ray_d, far0):
    """Twin of `tri_any_hit` in plain PyTorch (any device)."""
    geo, _, _ = tri_table(scene)
    occ = []
    for s, e in _chunks(ray_o.shape[0], geo.shape[0]):
        t, _u, _v, valid = _hit_tables(geo, ray_o[s:e], ray_d[s:e])
        occ.append((valid & (t < far0[s:e, None])).any(dim=1))
    return torch.cat(occ)


def _normal_dots(ng, rd):
    """(n, T) dot(n_g, d) of every (ray, triangle) pair, summed as
    (a0*b0 + a1*b1) + a2*b2."""
    return (rd[:, 0:1] * ng[:, 0] + rd[:, 1:2] * ng[:, 1]) \
        + rd[:, 2:3] * ng[:, 2]


def _pick(cand):
    """Per ray: the smallest candidate, ties to the lowest row. Returns
    (best_t, row, found); found is False where no candidate lies below
    FAR (then best_t = FAR)."""
    T = cand.shape[1]
    best_t = cand.amin(dim=1)
    rows = torch.arange(T, device=cand.device)
    best_i = torch.where(cand == best_t[:, None], rows, T).amin(dim=1)
    found = best_t < FAR
    return torch.where(found, best_t, FAR), best_i, found


def tri_track_hits_plain(scene, ray_o, ray_d, far0, K, null_flags):
    """Twin of `tri_track_hits` in plain PyTorch (any device)."""
    geo, ng, obj = tri_table(scene)
    T = geo.shape[0]
    null = null_flags.to(torch.bool)
    outs = []
    for s, e in _chunks(ray_o.shape[0], T):
        t, _u, _v, valid = _hit_tables(geo, ray_o[s:e], ray_d[s:e])
        dn = _normal_dots(ng, ray_d[s:e])
        far = far0[s:e]
        tm = torch.where(valid, t, FAR)

        def slot(best_t, best_i, hit):
            # + 0.0: the Pallas kernel's one-hot sum turns -0.0 into +0.0
            d = dn.gather(1, best_i[:, None])[:, 0] + 0.0
            return (torch.where(hit, best_t, FAR),
                    torch.where(hit, obj[best_i], -1).to(torch.int32),
                    torch.where(hit, d, 0.0))

        # closest blocker: any non-null row ends the walk
        t_blk, i_blk, found = _pick(torch.where(null, FAR, tm))
        tb, ob, db = slot(t_blk, i_blk, found & (t_blk < far))
        # K eps-chained null interfaces strictly before the blocker
        t_cut = torch.minimum(t_blk, far)
        tm_n = torch.where(null & (tm < t_cut[:, None]), tm, FAR)
        prev = torch.zeros_like(far)
        slots = []
        for _k in range(K):
            best_t, best_i, found = _pick(
                torch.where(tm_n > prev[:, None], tm_n, FAR))
            slots.append(slot(best_t, best_i, found & (best_t < far)))
            prev = best_t + CHAIN_SEP
        # a null candidate left beyond the chain: the caller re-walks it
        ov = ((tm_n > prev[:, None]) & (tm_n < FAR)).any(dim=1)
        outs.append(tuple(torch.stack(x) for x in zip(*slots))
                    + (tb, ob, db, ov))
    return tuple(torch.cat(parts, dim=1 if i < 3 else 0)
                 for i, parts in enumerate(zip(*outs)))


# ------------------------------- kernels -------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library(__name__, "tri_intersect", {
    "tri_closest_hit": ("tri_closest_hit", "tri_closest_kernel",
                        [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                         _P, _P]),
    "tri_any_hit": ("tri_any_hit", "tri_any_kernel",
                    [_P, _P, _P, _I, _P, _I, _P, _P]),
    "tri_track_hits": ("tri_track_hits", "tri_track_kernel",
                       [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                        _P, _P, _P, _P, _P, _P, _P])},
    queries={"tri_kernel_info": [_I, _P]})
# each wrapper's kernel, by the name the profiler gives it
kernel_names = _LIB.kernel_names


def kernel_info(n):
    """{kernel: (registers a thread, spilled bytes a thread, blocks of 256
    threads resident on one SM, SMs, 256, waves)} for n rays, and the
    media walk's null-row cap the build holds (NULL_CAP). Needs the
    card."""
    out, cap = {}, None
    for which, name in enumerate(kernel_names):
        vals = (ctypes.c_int * 6)()
        _LIB.query("tri_kernel_info", f"{name} info", which,
                   ctypes.addressof(vals))
        regs, spill, per_sm, sms, block, cap = vals
        out[name] = (regs, spill, per_sm, sms, block,
                     -(-n // (per_sm * sms * block)))
    return out, cap


def _checked(ray_o, *specs):
    """Raise unless each (name, tensor, shape, dtype) lies on ray_o's
    device with that type and shape; tables must be contiguous too (a copy
    would be a launch a call)."""
    for name, x, shape, dtype in specs:
        if x.device != ray_o.device or x.dtype != dtype \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} of shape {shape} on "
                             f"{ray_o.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if name.startswith("scene.") and not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous table")


def _operands(scene, ray_o, ray_d, far0):
    """Device, type and shape checks of everything the kernel reads;
    contiguous rays and the scene's own triangle tables (made once per
    scene, `scene/compile.py::tri_tables`): a call builds nothing."""
    n = ray_o.shape[0]
    T = scene.tri_geo.shape[0]
    _checked(ray_o,
             ("ray_o", ray_o, (n, 3), torch.float32),
             ("ray_d", ray_d, (n, 3), torch.float32),
             ("far0", far0, (n,), torch.float32),
             ("scene.tri_geo", scene.tri_geo, (T, 12), torch.float32),
             ("scene.tri_ng", scene.tri_ng, (T, 3), torch.float32),
             ("scene.tri_obj", scene.tri_obj, (T,), torch.int32))
    if scene.tri_geo.data_ptr() % 16:
        raise ValueError("scene.tri_geo: want 16-byte aligned rows (the "
                         "kernels read them as float4)")
    return (ray_o.contiguous(), ray_d.contiguous(), far0.contiguous(), n,
            scene.tri_geo, scene.tri_ng, scene.tri_obj)


def _staged(scene, fn):
    """The scene's triangle count; raises beyond STAGED_ROWS, which a
    kernel that stages the whole table cannot take."""
    T = scene.tri_geo.shape[0]
    if T > STAGED_ROWS:
        raise ValueError(f"{fn}: {T} triangles, the kernel keeps at most "
                         f"{STAGED_ROWS} in shared memory (the brute-force "
                         "tier's most)")
    return T


def _track_operands(scene, ray_o, ray_d, far0, all_null):
    """`_operands`, and the media walk's row lists: (pointer to the
    non-null rows or None, their count, pointer to the null rows or None);
    with all_null no non-null row and None for the null rows (every row
    in order). Raises beyond STAGED_ROWS triangles."""
    ops = _operands(scene, ray_o, ray_d, far0)
    T = _staged(scene, "tri_track_hits")
    solid, nulls = scene.tri_solid_rows, scene.tri_null_rows
    Ts = solid.shape[0]
    _checked(ray_o, ("scene.tri_solid_rows", solid, (Ts,), torch.int32),
             ("scene.tri_null_rows", nulls, (T - Ts,), torch.int32))
    if all_null:
        return ops, (None, 0, None)
    return ops, (solid.data_ptr(), Ts, nulls.data_ptr())


def twin(fn, *args):
    """A wrapper's plain version on CPU tensors. Hits are constants: the
    kernels' outputs never carry an autograd graph, so the twins run
    under no_grad and a gradient on the CPU equals the card's."""
    with torch.no_grad():
        return fn(*args)


def _is_cpu(ray_o):
    if ray_o.device.type == "cpu":
        return True
    if ray_o.device.type != "cuda":
        raise ValueError(f"no kernel for device {ray_o.device}")
    return False


def tri_closest_hit(scene, ray_o, ray_d, far0):
    """Closest triangle hit for a ray batch.

    Returns (t, tri_row, u, v, n_g, obj): t = far0, tri_row/obj = -1, u/v
    = 0 and n_g = (1,0,0) on a miss; tri_row indexes scene.tri_*."""
    if _is_cpu(ray_o):
        return twin(tri_closest_hit_plain, scene, ray_o, ray_d, far0)
    ro, rd, far, n, geo, ng, obj = _operands(scene, ray_o, ray_d, far0)
    t = torch.empty(n, device=ro.device)
    row = torch.empty(n, dtype=torch.int32, device=ro.device)
    u = torch.empty(n, device=ro.device)
    v = torch.empty(n, device=ro.device)
    ng_out = torch.empty((n, 3), device=ro.device)
    obj_out = torch.empty(n, dtype=torch.int32, device=ro.device)
    if n == 0:
        return t, row, u, v, ng_out, obj_out
    _LIB.launch("tri_closest_hit", ro.device, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                geo.data_ptr(), ng.data_ptr(), obj.data_ptr(), geo.shape[0],
                t.data_ptr(), row.data_ptr(), u.data_ptr(), v.data_ptr(),
                ng_out.data_ptr(), obj_out.data_ptr())
    return t, row, u, v, ng_out, obj_out


def tri_any_hit(scene, ray_o, ray_d, far0):
    """True where any triangle lies strictly before far0 (dead lanes,
    far0 <= RAY_EPS, never). The kernel takes at most STAGED_ROWS
    triangles."""
    if _is_cpu(ray_o):
        return twin(tri_any_hit_plain, scene, ray_o, ray_d, far0)
    ro, rd, far, n, geo, _, _ = _operands(scene, ray_o, ray_d, far0)
    _staged(scene, "tri_any_hit")
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    if n == 0:
        return occ
    _LIB.launch("tri_any_hit", ro.device, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                geo.data_ptr(), geo.shape[0], occ.data_ptr())
    return occ


def null_flags(scene, all_null=False):
    """(T,) bool null flag of each triangle row that `tri_track_hits`
    uses: the scene's own (`scene.tri_null`), or every row with
    all_null."""
    return torch.ones_like(scene.tri_null) if all_null else scene.tri_null


def tri_track_hits(scene, ray_o, ray_d, far0, K, all_null=False):
    """Everything a media walk needs along each ray, in one pass: the
    closest blocking (non-null) hit, the first K null interfaces in front
    of it, and whether more null interfaces lie there.

    The null rows are the scene's (`scene.tri_null`), or every row with
    all_null (then nothing blocks). Returns (t_null (K,N), obj_null (K,N),
    dn_null (K,N), t_blk (N,), obj_blk (N,), dn_blk (N,), overflow (N,)
    bool), as
    adapt_tpu/ops/intersect_pallas.py `tri_track_hits` does:
    * the blocker is the closest valid hit on a non-null row before far0;
      on a miss t_blk = FAR (not far0), obj_blk = -1, dn_blk = 0;
    * null slot k is the smallest null hit t with t > prev and t <
      min(t_blk, far0), ties to the lowest row; prev starts at 0 and
      becomes the slot's t + CHAIN_SEP after each slot, even an empty one
      (t = FAR); empty slots are FAR / -1 / 0 and valid slots a prefix;
    * dn = dot(n_g, d) of the row (the walk's enter/exit test);
    * overflow: a null hit beyond the K slots is still before the
      blocker. Dead lanes (far0 = -3e38) get no hits and no overflow.
    A hit needs t < FAR as well as t < far0 (the JAX kernel differs only
    where far0 > FAR)."""
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    if _is_cpu(ray_o):
        return twin(tri_track_hits_plain, scene, ray_o, ray_d, far0, K,
                    null_flags(scene, all_null))
    (ro, rd, far, n, geo, ng, obj), (solid_p, n_solid, null_p) = \
        _track_operands(scene, ray_o, ray_d, far0, all_null)
    T = geo.shape[0]
    t_k = torch.empty((K, n), device=ro.device)
    o_k = torch.empty((K, n), dtype=torch.int32, device=ro.device)
    d_k = torch.empty((K, n), device=ro.device)
    tb = torch.empty(n, device=ro.device)
    ob = torch.empty(n, dtype=torch.int32, device=ro.device)
    db = torch.empty(n, device=ro.device)
    ov = torch.empty(n, dtype=torch.bool, device=ro.device)
    if n == 0:
        return t_k, o_k, d_k, tb, ob, db, ov
    _LIB.launch("tri_track_hits", ro.device, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                geo.data_ptr(), ng.data_ptr(), obj.data_ptr(), solid_p,
                n_solid, null_p, T - n_solid, K, t_k.data_ptr(),
                o_k.data_ptr(), d_k.data_ptr(), tb.data_ptr(), ob.data_ptr(),
                db.data_ptr(), ov.data_ptr())
    return t_k, o_k, d_k, tb, ob, db, ov
