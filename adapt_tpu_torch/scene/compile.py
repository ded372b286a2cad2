"""Scene compiler: host object model -> flat SoA torch tensors.

Port of adapt_tpu/scene/compile.py. The XML parse (copied numpy host code)
produces host records; this module flattens the ones the PT slice reads
into `SceneData`, with the JAX package's field names and the same
precompute (triangles in plane + dual-basis form, so the ray/triangle test
is t = (d - o.n)/(dir.n), u = (o + t dir).U - cu, v = (o + t dir).V - cv).

Scenes of BVH_THRESHOLD prims or more also get the JAX package's BVH
tables (`bvh_node_pack`, `bvh_prim_pack`; native binned-SAH build,
native/), which the plain walk and the any-hit kernel read, the same
tables in aligned float4 rows (`bvh_node_v4`, `bvh_prim_v4`; `v4_packs`),
which the closest-hit kernel reads, and its cluster cut of that tree
(`cl_*`: disjoint subtrees of at most CLUSTER_MAX prims, prim-major
rows), which the cluster kernels sweep. Tables the port does not read
(texture atlases, grid volumes) are not built.
Scenes that need them are recognised from their configuration and raise
NotImplementedError at render (`check_supported`; grid volumes and BxDF
mixtures already here), naming the ROADMAP item that ports them: the port
never silently takes another path.

Scenes load onto the CUDA device unless the caller asks for another; with
no CUDA device that default raises (`resolve_device`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import BRDFTag, BSDFTag, EmitterTag, MediumTag, SPHERE
from ..native import bvh_build
from ..ops.math3d import np_rotation_between, fov2focal

# Below this many prims the JAX package builds no BVH and scans every
# triangle (adapt_tpu/scene/compile.py:455); ops/intersect.py picks the
# brute-force or the BVH kernels.
BVH_THRESHOLD = 64
# Prim slots of one cluster block (the JAX package's shipped CM) and prims
# under one chunk box inside it (adapt_tpu/scene/compile.py:320-351).
CLUSTER_MAX = 256
CLUSTER_CHUNK = 128


@dataclasses.dataclass
class MediumTable:
    """Per-object (or world) homogeneous medium parameters."""
    kind: torch.Tensor     # (...,) i32 MediumTag (-1 = transparent)
    ior: torch.Tensor      # (...,) f32
    u_a: torch.Tensor      # (...,3) absorption
    u_s: torch.Tensor      # (...,3) scattering
    u_e: torch.Tensor      # (...,3) extinction u_a + u_s
    ph_par: torch.Tensor   # (...,3) phase parameters (HG g per lobe)
    ph_pdf: torch.Tensor   # (...,3) multi-HG lobe weights


@dataclasses.dataclass
class TextureTable:
    """Per-object texture slots for one tag; mode -255 = no texture.

    The slice renders untextured scenes only; `present` (any object has
    this tag) is what ops/texture_ops.py checks, a host bool so the bounce
    loop never waits on the device for it."""
    mode: torch.Tensor     # (O,) i32
    present: bool


@dataclasses.dataclass
class SceneData:
    """Flat device-side scene tables (torch tensors, JAX field names)."""
    # --- triangles (T): plane + dual-basis intersector form ---
    tri_gid: torch.Tensor    # (T,) i32 global prim index
    tri_obj: torch.Tensor    # (T,) i32 owning object
    tri_n: torch.Tensor      # (T,3) unit plane normal
    tri_d: torch.Tensor      # (T,) plane offset dot(n, p0)
    tri_U: torch.Tensor      # (T,3) dual basis for barycentric u
    tri_V: torch.Tensor      # (T,3)
    tri_cu: torch.Tensor     # (T,) dot(U, p0)
    tri_cv: torch.Tensor     # (T,)
    # --- spheres (S) ---
    sph_gid: torch.Tensor    # (S,) i32
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    # --- global prims (P = T + S) ---
    prim_ng: torch.Tensor    # (P,3) geometric normals
    prim_vn: torch.Tensor    # (P,3,3) vertex normals (zeros when absent)
    pre0: torch.Tensor       # (P,3) e1 (tri) / center (sphere)
    pre1: torch.Tensor       # (P,3) e2 (tri) / radius row (sphere)
    pre2: torch.Tensor       # (P,3) p0 (tri) / zeros (sphere)
    prim_obj: torch.Tensor   # (P,) i32 owning object
    prim_is_sphere: torch.Tensor  # (P,) bool
    # --- BVH (skip-offset DFS order; 1-row inverted placeholders below
    # BVH_THRESHOLD prims) ---
    bvh_node_pack: torch.Tensor  # (M,9) f32: lo(3) hi(3) base cnt skip
    bvh_prim_pack: torch.Tensor  # (P,14) f32, leaf-contiguous order:
    # n|center(3) d|radius U(3) cu V(3) cv is_sphere gid
    bvh_node_v4: torch.Tensor    # (M,8) f32 rows of 32 B (`v4_packs`)
    bvh_prim_v4: torch.Tensor    # (P,16) f32 rows of 64 B (`v4_packs`)
    # --- cluster cut of the BVH (C clusters of CM slots, K = CM / 128
    # chunks each; one empty inverted cluster below BVH_THRESHOLD) ---
    cl_aabb: torch.Tensor    # (C,6) f32 lo|hi of each cluster's subtree
    cl_front: torch.Tensor   # (C,6) f32 cl_aabb inflated (front pass)
    cl_rows: torch.Tensor    # (C*CM,18) f32 prim-major: the 14 fields of
    # bvh_prim_pack (gid -1 = padding slot), then n_g(3) and obj
    cl_chunk: torch.Tensor   # (C,K,6) f32 lo|hi of each 128-prim chunk
    cl_count: torch.Tensor   # (C,) i32 live prims (leading slots) a cluster
    cl_slot: torch.Tensor    # (P,) i32 row of cl_rows that holds prim gid
    # --- objects (O) ---
    obj_start: torch.Tensor      # (O,) first global prim id
    obj_cnt: torch.Tensor        # (O,) prim count
    obj_is_sphere: torch.Tensor  # (O,) i32
    obj_emitter: torch.Tensor    # (O,) i32 emitter id or -1
    obj_aabb_min: torch.Tensor   # (O,3)
    obj_aabb_max: torch.Tensor   # (O,3)
    # --- materials (O) ---
    mat_type: torch.Tensor     # (O,) i32 BRDFTag / BSDFTag
    mat_is_bsdf: torch.Tensor  # (O,) bool
    mat_is_delta: torch.Tensor  # (O,) bool
    mat_kd: torch.Tensor       # (O,3)
    mat_ks: torch.Tensor
    mat_kg: torch.Tensor
    mat_mean: torch.Tensor     # (O,3)
    medium: MediumTable        # (O,) attached media
    # --- emitters (E) ---
    emit_kind: torch.Tensor      # (E,) i32 EmitterTag
    emit_intensity: torch.Tensor  # (E,3)
    emit_pos: torch.Tensor       # (E,3)
    emit_dir: torch.Tensor       # (E,3)
    emit_inv_area: torch.Tensor  # (E,)
    emit_r: torch.Tensor         # (E,)
    emit_bits: torch.Tensor      # (E,) i32 bool_bits
    emit_obj: torch.Tensor       # (E,) i32 attached object or -1
    emit_time: torch.Tensor      # (E,) emission time offset (BDPT)
    # --- world, camera, textures ---
    world_medium: MediumTable    # (1,)
    cam_r: torch.Tensor          # (3,3)
    cam_t: torch.Tensor          # (3,)
    tex: dict                    # {tag: TextureTable}

    @property
    def device(self) -> torch.device:
        return self.tri_n.device

    @property
    def n_prims(self) -> int:
        """Triangles plus spheres (a host int: read from shapes)."""
        return self.tri_gid.shape[0] + self.sph_gid.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.cl_aabb.shape[0]

    @property
    def cluster_size(self) -> int:
        """Slots of one cluster block, CM (a host int)."""
        return self.cl_rows.shape[0] // self.cl_aabb.shape[0]

    def to(self, device) -> "SceneData":
        """Copy of the scene with every table on `device`."""
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if dataclasses.is_dataclass(x):
                return dataclasses.replace(
                    x, **{f.name: move(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
            return x
        return move(self)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Hashable static render configuration; the JAX package's fields.

    use_pallas / use_cluster name the JAX package's TPU tier switches:
    the port's load_scene leaves them False (what the JAX package sets off
    the TPU) and nothing in the port reads them. big_tier is the port's
    own field: which kernels intersect a scene of the big tier
    (ops/intersect.py), "bvh" (the BVH walk, the default), "sweep" (the
    all-cluster sweep) or "qpick" (the queue-pick schedule)."""
    w: int
    h: int
    focal: float
    max_bounce: int = 8
    num_shadow_ray: int = 1
    use_rr: bool = True
    rr_threshold: float = 0.1
    rr_bounce_th: int = 4
    use_mis: bool = True
    anti_alias: bool = True
    stratified_sampling: bool = True
    brdf_two_sides: bool = False
    has_v_normal: bool = False
    start_x: int = 0
    end_x: int = 0
    start_y: int = 0
    end_y: int = 0
    brdf_types: tuple = ()
    bsdf_types: tuple = ()
    emitter_kinds: tuple = ()
    n_emitters: int = 0
    world_scattering: bool = False
    medium_kinds: tuple = ()
    has_null_bsdf: bool = False
    n_null_objs: int = 0
    volume_kind: int = 0
    volume_phase: int = 0
    use_bvh: bool = False
    use_pallas: bool = False
    use_cluster: bool = False
    has_normal_map: bool = False
    has_bump_map: bool = False
    smp_hemisphere: int = 32
    depth_samples: int = 64
    sample_extent: float = 0.1
    start_t: int = 1
    end_t: int = 100
    start_s: int = 0
    end_s: int = 100
    decomposition: str = "none"
    unwarp: bool = False
    t_bins: int = 0
    t_min: float = 0.0
    t_interval: float = 1.0
    sol: float = 1.0
    modulated: bool = False
    big_tier: str = "bvh"

    @property
    def transient(self) -> bool:
        """BDPT bins path time (reference bdpt.py:40-47, 95-108)."""
        return self.decomposition != "none" and self.t_bins > 0

    @property
    def n_pixels(self) -> int:
        return self.w * self.h


def check_supported(scene: SceneData, cfg: RenderConfig, renderer="pt"):
    """Raise NotImplementedError for what a renderer of the port cannot
    render yet; `renderer` is "pt", "vpt" or "bdpt".

    PT: lambertian BRDFs and point lights. Participating media are not on
    its list: the JAX package's PT reads only the world IOR and ignores
    them too (cbox itself declares a scattering world medium).
    VPT and BDPT: also null BSDFs (medium boundaries), area lights and HG,
    multi-HG and Rayleigh media."""
    def nope(what, item):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md queue A item {item})")

    if renderer not in ("pt", "vpt", "bdpt"):
        raise ValueError(f"unknown renderer {renderer!r}")
    vpt = renderer != "pt"                    # the media renderers
    bsdfs = set(cfg.bsdf_types) - ({BSDFTag.NULL} if vpt else set())
    if bsdfs or (cfg.has_null_bsdf and not vpt):
        nope(f"BSDFs {cfg.bsdf_types}", 9)
    if set(cfg.brdf_types) - {BRDFTag.LAMBERTIAN}:
        nope(f"BRDFs {cfg.brdf_types} other than lambertian", 9)
    lights = {EmitterTag.POINT} | ({EmitterTag.AREA} if vpt else set())
    if set(cfg.emitter_kinds) - lights:
        nope(f"emitter kinds {cfg.emitter_kinds} other than "
             f"{sorted(lights)}", 9)
    if vpt and set(cfg.medium_kinds) - {MediumTag.HG, MediumTag.MULTI_HG,
                                        MediumTag.RAYLEIGH}:
        nope(f"medium kinds {cfg.medium_kinds}", 11)
    if (cfg.has_normal_map or cfg.has_bump_map
            or any(t.present for t in scene.tex.values())):
        nope("textures", 9)
    if cfg.volume_kind:
        nope("grid volumes", 14)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must be present (the
    port's entry points default to the card and never fall back to the
    CPU: the CPU takes device="cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return device


def _cluster_cut(node_pack, rows18, prim_aabb):
    """Cut the skip-offset tree into disjoint subtree clusters (numpy copy
    of adapt_tpu/scene/compile.py `_cluster_cut`, CM fixed at CLUSTER_MAX).

    A cluster is a whole subtree of at most CM prims (or a leaf). Prims
    are leaf-contiguous in DFS order, so each cluster is a contiguous range
    of `rows18` (P,18; DFS order), padded to CM slots whose gid is -1.
    prim_aabb is (P,6) lo|hi in the same order; each 128-prim chunk of a
    cluster gets the box of its prims (an empty chunk an inverted one).

    Returns (cl_aabb (C,6), cl_rows (C*CM,18), cl_chunk (C,K,6)): the JAX
    tables' members, boxes and row values in prim-major layout."""
    M, P = node_pack.shape[0], rows18.shape[0]
    base = node_pack[:, 6].astype(np.int64)
    cnt = node_pack[:, 7].astype(np.int64)
    skip = node_pack[:, 8].astype(np.int64)
    cm, ck = CLUSTER_MAX, CLUSTER_CHUNK
    # first leaf prim at or after each node (leaf bases increase in DFS)
    big = np.int64(1) << 60
    nxt = np.minimum.accumulate(np.where(cnt > 0, base, big)[::-1])[::-1]
    nxt = np.append(np.where(nxt >= big, P, nxt), P)
    clusters = []
    i = 0
    while i < M:
        s = int(nxt[i])
        n = int(nxt[min(int(skip[i]), M)]) - s
        if n <= cm or cnt[i] > 0:
            clusters.append((s, n, node_pack[i, 0:6]))
            i = int(skip[i])
        else:
            i += 1
    C, K = len(clusters), cm // ck
    aabb = np.zeros((C, 6), np.float32)
    rows = np.zeros((C, cm, 18), np.float32)
    rows[:, :, 13] = -1.0                      # gid: mark padding
    chunk = np.zeros((C, K, 6), np.float32)
    chunk[:, :, 0:3] = np.float32(3e38)        # empty chunks never hit
    chunk[:, :, 3:6] = np.float32(-3e38)
    for k, (s, n, box) in enumerate(clusters):
        aabb[k] = box
        rows[k, :n] = rows18[s:s + n]
        for q in range(-(-n // ck)):
            sl = prim_aabb[s + q * ck:s + min(n, (q + 1) * ck)]
            chunk[k, q, 0:3] = sl[:, 0:3].min(0)
            chunk[k, q, 3:6] = sl[:, 3:6].max(0)
    return aabb, rows.reshape(C * cm, 18), chunk


def front_boxes(cl_aabb):
    """(C,6) f32 boxes of the front pass: each cluster box inflated by
    1e-6 of |lo| + |hi| + 1 a side (adapt_tpu/ops/cluster_pallas.py
    :1578-1581), so that its entry distance bounds every hit inside from
    below despite rounding. An inverted (placeholder) box stays as it is."""
    lo, hi = cl_aabb[:, 0:3], cl_aabb[:, 3:6]
    with np.errstate(over="ignore"):
        ext = np.abs(lo) + np.abs(hi) + np.float32(1.0)
        out = np.concatenate([lo - np.float32(1e-6) * ext,
                              hi + np.float32(1e-6) * ext], axis=1)
    real = (lo <= hi).all(axis=1, keepdims=True)
    return np.where(real, out, cl_aabb).astype(np.float32)


def prim_slots(cl_rows, C, P):
    """(cl_count (C,) i32: live prims of each cluster, which fill its
    leading slots; cl_slot (P,) i32: the row of cl_rows that holds each
    prim)."""
    gid = cl_rows[:, 13].astype(np.int64)
    live = np.nonzero(gid >= 0)[0]
    slot = np.full(P, -1, np.int32)
    slot[gid[live]] = live
    return (gid.reshape(C, -1) >= 0).sum(axis=1).astype(np.int32), slot


def _bvh_tables(prims, sph_ids, prim_n, prim_d, prim_U, prim_cu, prim_V,
                prim_cv, prim_is_sphere, n_g, prim_obj):
    """(bvh_node_pack (M,9), bvh_prim_pack (P,14), cl_aabb, cl_rows,
    cl_chunk) f32, as adapt_tpu/scene/compile.py:453-492 builds them."""
    P = prims.shape[0]
    prim_lo = prims.min(axis=1)
    prim_hi = prims.max(axis=1)
    if sph_ids.size:
        c = prims[sph_ids, 0]
        r = prims[sph_ids, 1, :1]
        prim_lo[sph_ids] = c - r
        prim_hi[sph_ids] = c + r
    node_f, node_i, prim_order = bvh_build(
        np.concatenate([prim_lo, prim_hi], axis=1).astype(np.float32))
    # int fields ride float32 rows: exact only below 2^24
    if P >= (1 << 24) or node_i.max() >= (1 << 24):
        raise ValueError(
            f"scene too large for the f32-packed BVH rows: P={P}, "
            f"max node field {int(node_i.max())} (>= 2^24)")
    node_pack = np.concatenate(
        [node_f.astype(np.float32), node_i.astype(np.float32)], axis=1)
    a = prim_n.copy()
    b = prim_d.copy()
    if sph_ids.size:
        a[sph_ids] = prims[sph_ids, 0]           # sphere center
        b[sph_ids] = prims[sph_ids, 1, 0]        # sphere radius
    prim_pack = np.concatenate(
        [a, b[:, None], prim_U, prim_cu[:, None], prim_V,
         prim_cv[:, None], prim_is_sphere[:, None].astype(np.float32),
         np.arange(P, dtype=np.float32)[:, None]], axis=1)
    rows18 = np.concatenate(
        [prim_pack, n_g.astype(np.float32),
         prim_obj[:, None].astype(np.float32)], axis=1)
    prim_ab = np.concatenate([prim_lo, prim_hi],
                             axis=1).astype(np.float32)[prim_order]
    return (node_pack, prim_pack[prim_order],
            *_cluster_cut(node_pack, rows18[prim_order], prim_ab))


def v4_packs(node_pack, prim_pack):
    """The BVH tables in aligned rows for float4 loads: (bvh_node_v4 (M,8),
    bvh_prim_v4 (P,16)) f32 from (bvh_node_pack (M,9), bvh_prim_pack
    (P,14)). A node row is lo(3), then base | cnt << 24 as int32 bits, then
    hi(3), then skip as int32 bits (cnt <= LEAF_MAX = 4 and ids below 2^24
    fit); a prim row is the 14 fields of bvh_prim_pack as they are, then
    two zeros. The float fields are copied bit for bit."""
    node_pack = np.asarray(node_pack, np.float32)
    prim_pack = np.asarray(prim_pack, np.float32)
    base, cnt, skip = (node_pack[:, k].astype(np.int64) for k in (6, 7, 8))
    if len(base) and (base.max() >= 1 << 24 or cnt.max() >= 1 << 7
                      or base.min() < 0 or cnt.min() < 0):
        raise ValueError("BVH node fields do not fit the packed int word")
    nodes = np.zeros((node_pack.shape[0], 8), np.float32)
    nodes[:, 0:3] = node_pack[:, 0:3]
    nodes[:, 4:7] = node_pack[:, 3:6]
    words = nodes.view(np.int32)
    words[:, 3] = base | (cnt << 24)
    words[:, 7] = skip
    prims = np.zeros((prim_pack.shape[0], 16), np.float32)
    prims[:, :14] = prim_pack
    return nodes, prims


def _placeholder_bvh():
    """The JAX package's tables below BVH_THRESHOLD: an inverted box with
    skip 1, so an accidental walk misses and ends; one inverted cluster of
    128 padding slots, so an accidental sweep misses too."""
    node = np.zeros((1, 9), np.float32)
    node[:, 0:3], node[:, 3:6] = 3e38, -3e38
    node[:, 8] = 1.0
    box = np.zeros((1, 6), np.float32)
    box[:, 0:3], box[:, 3:6] = 3e38, -3e38
    rows = np.zeros((CLUSTER_CHUNK, 18), np.float32)
    rows[:, 13] = -1.0
    return node, np.zeros((1, 14), np.float32), box, rows, box[:, None, :]


def _medium_table(mediums) -> MediumTable:
    """Stack host medium records (adapt_tpu/scene/compile.py:260-268)."""
    def f(attr):
        return _t(np.stack([np.asarray(getattr(m, attr), np.float32)
                            for m in mediums]))
    return MediumTable(
        kind=_t([m.type_id for m in mediums], np.int32),
        ior=_t([m.ior for m in mediums], np.float32),
        u_a=f("u_a"), u_s=f("u_s"), u_e=f("u_e"), ph_par=f("par"),
        ph_pdf=f("pdf"))


def _t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x) if dtype is None else np.asarray(x, dtype)))


def _stack3(vals):
    if not vals:
        return np.zeros((0, 3), np.float32)
    return np.stack(vals).astype(np.float32)


def compile_scene(emitters, array_info, objects, configs, device="cuda"):
    """Assemble (SceneData, RenderConfig) from parsed host structures,
    with the precompute of adapt_tpu/scene/compile.py:383-738."""
    from .bxdf import Mixture_np
    device = resolve_device(device)
    if configs.get("volume"):
        raise NotImplementedError(
            "grid volumes are not ported yet (ROADMAP.md queue A item 14)")
    prims = array_info["primitives"]            # (P,3,3)
    sphere_ids = array_info["indices"]
    P = prims.shape[0]

    prim_obj = np.zeros(P, np.int32)
    obj_start = np.zeros(len(objects), np.int32)
    obj_cnt = np.zeros(len(objects), np.int32)
    obj_is_sphere = np.zeros(len(objects), np.int32)
    acc = 0
    for i, obj in enumerate(objects):
        obj_start[i] = acc
        obj_cnt[i] = obj.tri_num
        obj_is_sphere[i] = int(obj.type == SPHERE)
        prim_obj[acc:acc + obj.tri_num] = i
        acc += obj.tri_num

    sph_ids = (np.unique(sphere_ids.astype(np.int64))
               if sphere_ids is not None and len(sphere_ids)
               else np.zeros(0, np.int64))
    tri_mask = np.ones(P, bool)
    tri_mask[sph_ids] = False
    tri_ids = np.nonzero(tri_mask)[0].astype(np.int64)

    # triangle plane + dual-basis precompute (same numpy ops and order as
    # the JAX package, so the tables are equal)
    tv = prims[tri_ids]
    p0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    m = np.cross(e1, e2)
    m2 = np.maximum((m * m).sum(-1, keepdims=True), 1e-20)
    n_unit = m / np.sqrt(m2)
    U = np.cross(e2, m) / m2
    V = np.cross(m, e1) / m2
    prim_n = np.zeros((P, 3), np.float32)
    prim_U = np.zeros((P, 3), np.float32)
    prim_V = np.zeros((P, 3), np.float32)
    prim_n[tri_ids] = n_unit
    prim_U[tri_ids] = U
    prim_V[tri_ids] = V
    prim_d = np.zeros(P, np.float32)
    prim_cu = np.zeros(P, np.float32)
    prim_cv = np.zeros(P, np.float32)
    prim_d[tri_ids] = (n_unit * p0).sum(-1)
    prim_cu[tri_ids] = (U * p0).sum(-1)
    prim_cv[tri_ids] = (V * p0).sum(-1)

    # reference-layout edge vectors (adapt_tpu/scene/compile.py:429-435)
    pre0 = prims[:, 1] - prims[:, 0]
    pre1 = prims[:, 2] - prims[:, 0]
    pre2 = prims[:, 0].copy()
    if sph_ids.size:
        pre0[sph_ids] = prims[sph_ids, 0]        # sphere center
        pre1[sph_ids] = prims[sph_ids, 1]        # radius row
        pre2[sph_ids] = 0.0
    prim_is_sphere = np.zeros(P, bool)
    prim_is_sphere[sph_ids] = True
    if P >= BVH_THRESHOLD:
        node_pack, prim_pack, cl_aabb, cl_rows, cl_chunk = _bvh_tables(
            prims, sph_ids, prim_n, prim_d, prim_U, prim_cu, prim_V, prim_cv,
            prim_is_sphere, array_info["n_g"], prim_obj)
    else:
        node_pack, prim_pack, cl_aabb, cl_rows, cl_chunk = _placeholder_bvh()
    cl_count, cl_slot = prim_slots(cl_rows, cl_aabb.shape[0], P)
    node_v4, prim_v4 = v4_packs(node_pack, prim_pack)

    cam_dir = configs["transform"][0]
    if cam_dir is None or np.ndim(cam_dir) != 1 or np.size(cam_dir) != 3:
        raise ValueError("the <sensor> transform must be a <lookat>")
    cam_orient = np.asarray(cam_dir).astype(np.float32)
    cam_orient /= np.linalg.norm(cam_orient)
    cam_t = configs["transform"][1].astype(np.float32)
    cam_r = np_rotation_between(np.float32([0, 0, 1]), cam_orient)

    film = configs["film"]
    w, h = film["width"], film["height"]
    crop_x, crop_y = film.get("crop_x", 0), film.get("crop_y", 0)
    crop_rx, crop_ry = film.get("crop_rx", 0), film.get("crop_ry", 0)
    if crop_rx > 0 and crop_ry > 0:
        sx, ex = crop_x - crop_rx, crop_x + crop_rx
        sy, ey = crop_y - crop_ry, crop_y + crop_ry
    else:
        sx, ex, sy, ey = 0, w, 0, h

    world = configs["world"]
    mats = [obj.bxdf for obj in objects]
    if any(isinstance(m, Mixture_np) for m in mats):
        raise NotImplementedError(
            "BxDF mixtures are not ported yet (ROADMAP.md queue A item 9)")

    cfg = RenderConfig(
        w=w, h=h, focal=fov2focal(configs["fov"], min(w, h)),
        max_bounce=configs.get("max_bounce", 8),
        num_shadow_ray=configs.get("num_shadow_ray", 1),
        use_rr=bool(configs.get("use_rr", True)),
        rr_threshold=float(configs.get("rr_threshold", 0.1)),
        rr_bounce_th=int(configs.get("rr_bounce_th", 4)),
        use_mis=bool(configs.get("use_mis", True)),
        anti_alias=bool(configs.get("anti_alias", True)),
        stratified_sampling=bool(configs.get("stratified_sampling", True)),
        brdf_two_sides=bool(configs.get("brdf_two_sides", False)),
        has_v_normal=bool(configs.get("has_vertex_normal", False)),
        start_x=sx, end_x=ex, start_y=sy, end_y=ey,
        brdf_types=tuple(sorted({m.type_id for m in mats
                                 if not m.is_bsdf})),
        bsdf_types=tuple(sorted({m.type_id for m in mats if m.is_bsdf})),
        emitter_kinds=tuple(sorted({e.kind for e in emitters})),
        n_emitters=len(emitters),
        world_scattering=world.medium.is_scattering,
        medium_kinds=tuple(sorted(
            {m.medium.type_id for m in mats if m.medium.type_id >= 0}
            | ({world.medium.type_id} if world.medium.is_scattering
               else set()))),
        has_null_bsdf=any(m.is_bsdf and m.type_id < 0 for m in mats),
        n_null_objs=sum(1 for m in mats if m.is_bsdf and m.type_id < 0),
        use_bvh=P >= BVH_THRESHOLD,
        has_normal_map=any(obj.texture_group.get("normal") is not None
                           for obj in objects),
        has_bump_map=any(obj.texture_group.get("bump") is not None
                         for obj in objects),
        smp_hemisphere=int(configs.get("smp_hemisphere", 32)),
        depth_samples=int(configs.get("depth_samples", 64)),
        sample_extent=float(configs.get("sample_extent", 0.1)),
        start_t=int(configs.get("start_t", 1)),
        end_t=int(configs.get("end_t", 100)),
        start_s=int(configs.get("start_s", 0)),
        end_s=int(configs.get("end_s", 100)),
        decomposition=str(configs.get("decomposition", "none")),
        t_bins=int(configs.get("sample_count", 0))
        if "decomposition" in configs else 0,
        t_min=float(configs.get("min_time", 0.0)),
        t_interval=float(configs.get("interval", 1.0)),
        sol=float(world.C),
    )

    def mat_rows(attr, dtype=np.float32):
        return _t(np.stack([np.asarray(getattr(m, attr)) for m in mats])
                  .astype(dtype))

    emit_obj = np.full(len(emitters), -1, np.int32)
    for i, obj in enumerate(objects):
        if obj.emitter_ref_id >= 0:
            emit_obj[obj.emitter_ref_id] = i
    aabbs = np.stack([obj.aabb for obj in objects])  # (O,2,3)
    tex = {}
    for tag in ("albedo", "normal", "bump", "roughness"):
        mode = np.array([-255 if r is None else r.mode for r in
                         (obj.texture_group.get(tag) for obj in objects)],
                        np.int32)
        tex[tag] = TextureTable(mode=_t(mode),
                                present=bool((mode > -255).any()))

    scene = SceneData(
        tri_gid=_t(tri_ids, np.int32),
        tri_obj=_t(prim_obj[tri_ids]),
        tri_n=_t(n_unit, np.float32),
        tri_d=_t(prim_d[tri_ids]),
        tri_U=_t(U, np.float32),
        tri_V=_t(V, np.float32),
        tri_cu=_t(prim_cu[tri_ids]),
        tri_cv=_t(prim_cv[tri_ids]),
        sph_gid=_t(sph_ids, np.int32),
        sph_center=_t(prims[sph_ids, 0].reshape(-1, 3), np.float32),
        sph_radius=_t(prims[sph_ids, 1, 0], np.float32),
        prim_ng=_t(array_info["n_g"], np.float32),
        prim_vn=_t(array_info["n_s"], np.float32),
        pre0=_t(pre0, np.float32),
        pre1=_t(pre1, np.float32),
        pre2=_t(pre2, np.float32),
        prim_obj=_t(prim_obj),
        prim_is_sphere=_t(prim_is_sphere),
        bvh_node_pack=_t(node_pack),
        bvh_prim_pack=_t(prim_pack),
        bvh_node_v4=_t(node_v4),
        bvh_prim_v4=_t(prim_v4),
        cl_aabb=_t(cl_aabb),
        cl_front=_t(front_boxes(cl_aabb)),
        cl_rows=_t(cl_rows),
        cl_chunk=_t(cl_chunk),
        cl_count=_t(cl_count),
        cl_slot=_t(cl_slot),
        obj_start=_t(obj_start),
        obj_cnt=_t(obj_cnt),
        obj_is_sphere=_t(obj_is_sphere),
        obj_emitter=_t([obj.emitter_ref_id for obj in objects], np.int32),
        obj_aabb_min=_t(aabbs[:, 0]),
        obj_aabb_max=_t(aabbs[:, 1]),
        mat_type=_t([m.type_id for m in mats], np.int32),
        mat_is_bsdf=_t([m.is_bsdf for m in mats], bool),
        mat_is_delta=_t([m.is_delta for m in mats], bool),
        mat_kd=mat_rows("k_d"),
        mat_ks=mat_rows("k_s"),
        mat_kg=mat_rows("k_g"),
        mat_mean=mat_rows("mean"),
        medium=_medium_table([m.medium for m in mats]),
        emit_kind=_t([e.kind for e in emitters], np.int32),
        emit_intensity=_t(_stack3([e.intensity for e in emitters])),
        emit_pos=_t(_stack3([e.pos for e in emitters])),
        emit_dir=_t(_stack3([e.dir for e in emitters])),
        emit_inv_area=_t([e.inv_area for e in emitters], np.float32),
        emit_r=_t([e.r for e in emitters], np.float32),
        emit_bits=_t([e.bool_bits for e in emitters], np.int32),
        emit_obj=_t(emit_obj),
        emit_time=_t([e.emit_time for e in emitters], np.float32),
        world_medium=_medium_table([world.medium]),
        cam_r=_t(cam_r, np.float32),
        cam_t=_t(cam_t, np.float32),
        tex=tex,
    )
    return scene.to(device), cfg


def load_scene(directory: str, file: str, device="cuda"):
    """Parse + compile a scene in one call; returns (scene, cfg, configs).

    The tables go to `device`, the CUDA device by default (raises when
    there is none); the CPU takes device="cpu"."""
    from ..parsers.xml_parser import scene_parsing
    device = resolve_device(device)
    emitters, array_info, objects, configs = scene_parsing(directory, file)
    scene, cfg = compile_scene(emitters, array_info, objects, configs,
                               device)
    return scene, cfg, configs
