"""Scene compiler: host object model -> flat SoA torch tensors.

Port of adapt_tpu/scene/compile.py. The XML parse (copied numpy host code)
produces host records; this module flattens the ones the renderers read
into `SceneData`, with the JAX package's field names and the same
precompute (triangles in plane + dual-basis form, so the ray/triangle test
is t = (d - o.n)/(dir.n), u = (o + t dir).U - cu, v = (o + t dir).V - cv).

Scenes of BVH_THRESHOLD prims or more also get the JAX package's BVH
tables (`bvh_node_pack`, `bvh_prim_pack`; native binned-SAH build,
native/), which the plain walk and the any-hit kernel read, the same
tables in aligned float4 rows (`bvh_node_v4`, `bvh_prim_v4`; `v4_packs`),
which the closest-hit kernel reads, and its cluster cut of that tree
(`cl_*`: disjoint subtrees of at most CLUSTER_MAX prims, prim-major
rows, and the same rows as aligned float4 rows, `cl_rows_v4`;
`cluster_v4`), which the cluster kernels sweep, with the tree of the BVH
nodes above that cut (`cl_tree`; `cluster_tree`), which the front pass
walks. Each texture tag gets its per-object table and its packed atlas
(`TextureTable`), the triangles their vertex uvs (`prim_uv`), and BxDF
mixtures their table (`MixtureTable`, ops/mixture_ops.py) with the
component materials appended after the objects' material rows, and a
scene's grid volume its tables (`GridVolumeData`, ops/volume_ops.py;
`dummy_volume()` when it has none). Every renderer takes every scene
the tables hold, as the JAX package's do; what the parser cannot read (a
Mie medium, an unknown BxDF or volume type) raises NotImplementedError
when the scene loads.

Scenes load onto the CUDA device unless the caller asks for another; with
no CUDA device that default raises (`resolve_device`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..constants import SPHERE
from ..native import bvh_build
from ..ops.math3d import np_rotation_between, fov2focal
from ..ops.mixture_ops import MixtureTable, N_COMPONENTS
from ..ops.volume_ops import compile_volume, dummy_volume
from .bxdf import MIXTURE_SLOTS, Mixture_np
from .volume import GridVolumeRec

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
    """Per-object texture slots for one tag (albedo, normal, bump,
    roughness); mode -255 = no texture (reference bxdf/texture.py:92-96).

    `present` (any object carries this tag) is what ops/texture_ops.py
    checks, a host bool so the bounce loop never waits on the device."""
    mode: torch.Tensor     # (O,) i32: 0 image, 1 checker, -255 none
    off_x: torch.Tensor    # (O,) i32 atlas offsets
    off_y: torch.Tensor
    w: torch.Tensor        # (O,) f32 native texture size
    h: torch.Tensor
    scale_u: torch.Tensor  # (O,) f32
    scale_v: torch.Tensor
    c1: torch.Tensor       # (O,3) checker colors
    c2: torch.Tensor
    atlas: torch.Tensor    # (S,S,3) f32 packed atlas ((1,1,3) if unused)
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
    # --- the brute-force kernels' triangle tables, made once per scene
    # (`tri_tables`; ops/intersect_kernels.py reads them) ---
    tri_geo: torch.Tensor    # (T,12) f32 rows n d U cu V cv
    tri_ng: torch.Tensor     # (T,3) f32 prim_ng of each row
    tri_null: torch.Tensor   # (T,) bool: the row's object is a null BSDF
    tri_solid_rows: torch.Tensor  # (T-Tn,) i32 the other rows, ascending
    tri_null_rows: torch.Tensor   # (Tn,) i32 the null rows, ascending
    # --- spheres (S) ---
    sph_gid: torch.Tensor    # (S,) i32
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    # --- global prims (P = T + S) ---
    prim_ng: torch.Tensor    # (P,3) geometric normals
    prim_vn: torch.Tensor    # (P,3,3) vertex normals (zeros when absent)
    prim_uv: torch.Tensor    # (P,3,2) vertex uvs (zeros when absent)
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
    cl_rows_v4: torch.Tensor  # (C*CM,16) f32 rows of 64 B (`cluster_v4`)
    cl_chunk: torch.Tensor   # (C,K,6) f32 lo|hi of each 128-prim chunk
    cl_count: torch.Tensor   # (C,) i32 live prims (leading slots) a cluster
    cl_slot: torch.Tensor    # (P,) i32 row of cl_rows that holds prim gid
    cl_tree: torch.Tensor    # (T,8) f32 rows of 32 B: the nodes above the
    # cut, one leaf a cluster (`cluster_tree`)
    # --- objects (O) ---
    obj_start: torch.Tensor      # (O,) first global prim id
    obj_cnt: torch.Tensor        # (O,) prim count
    obj_is_sphere: torch.Tensor  # (O,) i32
    obj_emitter: torch.Tensor    # (O,) i32 emitter id or -1
    obj_aabb_min: torch.Tensor   # (O,3)
    obj_aabb_max: torch.Tensor   # (O,3)
    # --- materials (O, or O + K with BxDF mixtures: the K component
    # records follow the objects' rows in the mat_* and medium tables and
    # in obj_emitter, so mixture_ops gathers them as any other row) ---
    mat_type: torch.Tensor     # (O,) i32 BRDFTag / BSDFTag
    mat_is_bsdf: torch.Tensor  # (O,) bool
    mat_is_delta: torch.Tensor  # (O,) bool
    mat_kd: torch.Tensor       # (O,3)
    mat_ks: torch.Tensor
    mat_kg: torch.Tensor
    mat_mean: torch.Tensor     # (O,3)
    medium: MediumTable        # (O,) attached media
    mixture: object            # MixtureTable, or None: no mixtures
    obj_mixture: torch.Tensor  # (O+K,) i32 mixture row or -1
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
    volume: object               # GridVolumeData (dummy_volume(): none)

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


# the leaves `tri_tables` reads
TRI_SOURCES = ("tri_n", "tri_d", "tri_U", "tri_cu", "tri_V", "tri_cv",
               "tri_gid", "tri_obj", "prim_ng", "mat_is_bsdf", "mat_type")


def tri_tables(tri_n, tri_d, tri_U, tri_cu, tri_V, tri_cv, tri_gid,
               tri_obj, prim_ng, mat_is_bsdf, mat_type) -> dict:
    """The brute-force kernels' per-scene tables from the triangle, normal
    and material leaves (CPU tensors): `tri_geo` (T,12) f32, each row n d
    U cu V cv, so three 16-byte loads; `tri_ng`, the OBJ loader's
    geometric normal of each row (it differs from the plane normal n by ~1
    ULP), as the Pallas kernels' table holds it; `tri_null`, the null-BSDF
    flag of each row's object (a medium boundary, bsdf.py:238-240); and
    the rows split by that flag, each list ascending, so a sweep over
    either keeps "ties to the lowest row"."""
    geo = torch.cat([tri_n, tri_d[:, None], tri_U, tri_cu[:, None], tri_V,
                     tri_cv[:, None]], dim=1).contiguous()
    idx = tri_obj.clamp(min=0)
    null = (tri_obj >= 0) & mat_is_bsdf[idx] & (mat_type[idx] < 0)
    rows = torch.arange(tri_obj.shape[0], dtype=torch.int32)
    return dict(tri_geo=geo, tri_ng=prim_ng[tri_gid].contiguous(),
                tri_null=null, tri_solid_rows=rows[~null].contiguous(),
                tri_null_rows=rows[null].contiguous())


def replace_triangles(scene: "SceneData", **fields) -> "SceneData":
    """Copy of the scene with the given leaves replaced (triangle rows,
    materials) and its triangle tables made anew from them."""
    scene = dataclasses.replace(scene, **fields)
    tabs = tri_tables(**{n: getattr(scene, n).cpu() for n in TRI_SOURCES})
    return dataclasses.replace(
        scene, **{k: v.to(scene.device) for k, v in tabs.items()})


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


def _cut_walk(node_pack, cm):
    """The nodes the cluster cut visits, in DFS order: (node, cluster,
    first prim, prims) each. A node whose subtree holds at most cm prims,
    or a leaf, is the next cluster and its subtree is skipped; the walk
    descends through the others. Prims are leaf-contiguous in DFS order,
    so a subtree is the prim range from its first leaf prim on."""
    M = node_pack.shape[0]
    base = node_pack[:, 6].astype(np.int64)
    cnt = node_pack[:, 7].astype(np.int64)
    skip = node_pack[:, 8].astype(np.int64)
    P = int(cnt.sum())
    # first leaf prim at or after each node (leaf bases increase in DFS)
    big = np.int64(1) << 60
    nxt = np.minimum.accumulate(np.where(cnt > 0, base, big)[::-1])[::-1]
    nxt = np.append(np.where(nxt >= big, P, nxt), P)
    out = []
    i = 0
    while i < M:
        s = int(nxt[i])
        n = int(nxt[min(int(skip[i]), M)]) - s
        leaf = bool(n <= cm or cnt[i] > 0)
        out.append((i, leaf, s, n))
        i = int(skip[i]) if leaf else i + 1
    return out


@obs.spanned("setup.scene.cluster", setup=True)
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
    cm, ck = CLUSTER_MAX, CLUSTER_CHUNK
    clusters = [(s, n, node_pack[i, 0:6])
                for i, leaf, s, n in _cut_walk(node_pack, cm) if leaf]
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


def cluster_tree(node_pack, cl_front, cm):
    """The BVH nodes above the cluster cut, one leaf a cluster: (T,8) f32
    rows for float4 loads, in DFS order. A row is lo(3), skip as int32
    bits, hi(3), its first cluster id as int32 bits.

    The cut (`_cut_walk`) takes whole subtrees in DFS order as the
    clusters, so the nodes it descends through form a tree whose DFS
    visits the clusters in index order. A row's skip is the row after its subtree (a leaf's, its own
    row + 1). A leaf holds its cluster's cl_front box bit for bit; an inner
    node, per axis, the min and the max over both corners of its clusters'
    cl_front boxes: the interval the slab test sees of a box whichever
    corner is the lower (an inverted placeholder box too), so an inner box
    holds each of its clusters' boxes as the slab test sees them."""
    node_pack = np.asarray(node_pack, np.float32)
    front = np.asarray(cl_front, np.float32)
    C = front.shape[0]
    walk = _cut_walk(node_pack, cm)
    node = np.array([i for i, _l, _s, _n in walk], np.int64)
    leaf = np.array([l for _i, l, _s, _n in walk], bool)
    skip = node_pack[:, 8].astype(np.int64)
    if int(leaf.sum()) != C:
        raise ValueError(f"the cut of the tree gives {int(leaf.sum())} "
                         f"clusters, the tables {C}")
    T = node.shape[0]
    rows = np.arange(T)
    tskip = np.where(leaf, rows + 1, np.searchsorted(node, skip[node]))
    first = np.cumsum(leaf) - leaf                  # leaves before the row
    end = np.append(first, C)[tskip]
    lo = np.minimum(front[:, 0:3], front[:, 3:6])
    hi = np.maximum(front[:, 0:3], front[:, 3:6])
    tree = np.zeros((T, 8), np.float32)
    for r in range(T):
        if leaf[r]:
            tree[r, 0:3], tree[r, 4:7] = front[first[r], 0:3], \
                front[first[r], 3:6]
        else:
            tree[r, 0:3] = lo[first[r]:end[r]].min(axis=0)
            tree[r, 4:7] = hi[first[r]:end[r]].max(axis=0)
    words = tree.view(np.int32)
    words[:, 3] = tskip
    words[:, 7] = first
    return tree


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


def cluster_v4(cl_rows):
    """The cluster rows in aligned rows for float4 loads: (C*CM,16) f32
    from cl_rows (C*CM,18), the 14 fields a prim test reads (n|center,
    d|radius, U, cu, V, cv, is_sphere, gid) bit for bit, then two zeros.
    n_g and obj, which only a winner reads, stay in cl_rows."""
    cl_rows = np.asarray(cl_rows, np.float32)
    rows = np.zeros((cl_rows.shape[0], 16), np.float32)
    rows[:, :14] = cl_rows[:, :14]
    return rows


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


def _texture_table(recs, atlas) -> TextureTable:
    """One tag's per-object texture table from the host records (None:
    the object has no texture of the tag) and the tag's packed atlas
    (adapt_tpu/scene/compile.py:271-297)."""
    n = len(recs)
    mode = np.full(n, -255, np.int32)
    off_x = np.zeros(n, np.int32)
    off_y = np.zeros(n, np.int32)
    w = np.zeros(n, np.float32)
    h = np.zeros(n, np.float32)
    su = np.ones(n, np.float32)
    sv = np.ones(n, np.float32)
    c1 = np.zeros((n, 3), np.float32)
    c2 = np.zeros((n, 3), np.float32)
    for i, rec in enumerate(recs):
        if rec is None:
            continue
        mode[i] = rec.mode
        off_x[i], off_y[i] = rec.off_x, rec.off_y
        w[i], h[i] = rec.w, rec.h
        su[i], sv[i] = rec.scale_u, rec.scale_v
        c1[i], c2[i] = rec.c1, rec.c2
    if atlas is None:
        atlas = np.zeros((1, 1, 3), np.float32)
    return TextureTable(mode=_t(mode), off_x=_t(off_x), off_y=_t(off_y),
                        w=_t(w), h=_t(h), scale_u=_t(su), scale_v=_t(sv),
                        c1=_t(c1), c2=_t(c2), atlas=_t(atlas, np.float32),
                        present=bool((mode > -255).any()))


def _mixtures(mats):
    """BxDF mixtures (reference bxdf/mixture.py; adapt_tpu/scene/
    compile.py:556-591): each mixture's component records are appended
    after the O per-object rows, so mixture_ops delegates with the
    ordinary row gather. Returns (the O + K material records, the
    MixtureTable or None, obj_mixture (O + K,) i32: an object row's
    mixture-table row or -1)."""
    mix_list, mix_index = [], {}
    for m in mats:
        if isinstance(m, Mixture_np) and id(m) not in mix_index:
            mix_index[id(m)] = len(mix_list)
            mix_list.append(m)
    pad_mats = list(mats)
    row_of = {id(m): i for i, m in enumerate(mats)
              if not isinstance(m, Mixture_np)}
    for mx in mix_list:
        for comp in mx.components.values():
            if id(comp) not in row_of:
                row_of[id(comp)] = len(pad_mats)
                pad_mats.append(comp)
    obj_mixture = np.full(len(pad_mats), -1, np.int32)
    for i, m in enumerate(mats):
        if isinstance(m, Mixture_np):
            obj_mixture[i] = mix_index[id(m)]
    if not mix_list:
        return pad_mats, None, obj_mixture
    comp_ids = np.full((len(mix_list), N_COMPONENTS), -1, np.int32)
    probs = np.zeros((len(mix_list), N_COMPONENTS), np.float32)
    for mi, mx in enumerate(mix_list):
        probs[mi] = mx.probs
        for slot, comp in mx.components.items():
            comp_ids[mi, MIXTURE_SLOTS.index(slot)] = row_of[id(comp)]
    return pad_mats, MixtureTable(comp_ids=_t(comp_ids),
                                  probs=_t(probs)), obj_mixture


def _t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x) if dtype is None else np.asarray(x, dtype)))


def _stack3(vals):
    if not vals:
        return np.zeros((0, 3), np.float32)
    return np.stack(vals).astype(np.float32)


@obs.spanned("setup.scene.compile", setup=True)
def compile_scene(emitters, array_info, objects, configs, device="cuda",
                  scene_dir="."):
    """Assemble (SceneData, RenderConfig) from parsed host structures,
    with the precompute of adapt_tpu/scene/compile.py:383-738. A grid
    volume's `.vol` file resolves against scene_dir (scene/volume.py);
    a missing one warns and leaves the scene without its volume, as in
    the JAX package."""
    device = resolve_device(device)
    vol_nodes = configs.get("volume") or []
    vol_rec = GridVolumeRec(vol_nodes[0] if vol_nodes else None, scene_dir)
    vol_data = compile_volume(vol_rec) if vol_rec.type_id else dummy_volume()
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
    cl_front = front_boxes(cl_aabb)
    cl_tree = cluster_tree(node_pack, cl_front,
                           cl_rows.shape[0] // cl_aabb.shape[0])

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
    pad_mats, mixture, obj_mixture = _mixtures(mats)
    # the dispatch tables cover the component kinds; the MIXTURE tag
    # itself never enters brdf_types (its lanes are overlaid)
    disp_mats = [m for m in pad_mats if not isinstance(m, Mixture_np)]

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
        brdf_types=tuple(sorted({m.type_id for m in disp_mats
                                 if not m.is_bsdf})),
        bsdf_types=tuple(sorted({m.type_id for m in disp_mats
                                 if m.is_bsdf})),
        emitter_kinds=tuple(sorted({e.kind for e in emitters})),
        n_emitters=len(emitters),
        world_scattering=world.medium.is_scattering,
        medium_kinds=tuple(sorted(
            {m.medium.type_id for m in pad_mats if m.medium.type_id >= 0}
            | ({world.medium.type_id} if world.medium.is_scattering
               else set()))),
        has_null_bsdf=any(m.is_bsdf and m.type_id < 0 for m in pad_mats),
        n_null_objs=sum(1 for m in pad_mats
                        if m.is_bsdf and m.type_id < 0),
        volume_kind=int(vol_rec.type_id),
        volume_phase=int(vol_rec.phase_type_id),
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
        return _t(np.stack([np.asarray(getattr(m, attr)) for m in pad_mats])
                  .astype(dtype))

    emit_obj = np.full(len(emitters), -1, np.int32)
    for i, obj in enumerate(objects):
        if obj.emitter_ref_id >= 0:
            emit_obj[obj.emitter_ref_id] = i
    aabbs = np.stack([obj.aabb for obj in objects])  # (O,2,3)
    packed = configs.get("packed_textures") or {}
    tex = {tag: _texture_table([obj.texture_group.get(tag)
                                for obj in objects], packed.get(tag))
           for tag in ("albedo", "normal", "bump", "roughness")}

    tri = dict(
        tri_gid=_t(tri_ids, np.int32),
        tri_obj=_t(prim_obj[tri_ids]),
        tri_n=_t(n_unit, np.float32),
        tri_d=_t(prim_d[tri_ids]),
        tri_U=_t(U, np.float32),
        tri_V=_t(V, np.float32),
        tri_cu=_t(prim_cu[tri_ids]),
        tri_cv=_t(prim_cv[tri_ids]),
        prim_ng=_t(array_info["n_g"], np.float32),
        mat_type=_t([m.type_id for m in pad_mats], np.int32),
        mat_is_bsdf=_t([m.is_bsdf for m in pad_mats], bool))
    scene = SceneData(
        **tri,
        **tri_tables(**{n: tri[n] for n in TRI_SOURCES}),
        sph_gid=_t(sph_ids, np.int32),
        sph_center=_t(prims[sph_ids, 0].reshape(-1, 3), np.float32),
        sph_radius=_t(prims[sph_ids, 1, 0], np.float32),
        prim_vn=_t(array_info["n_s"], np.float32),
        prim_uv=_t(array_info["uvs"], np.float32),
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
        cl_front=_t(cl_front),
        cl_rows=_t(cl_rows),
        cl_rows_v4=_t(cluster_v4(cl_rows)),
        cl_chunk=_t(cl_chunk),
        cl_count=_t(cl_count),
        cl_slot=_t(cl_slot),
        cl_tree=_t(cl_tree),
        obj_start=_t(obj_start),
        obj_cnt=_t(obj_cnt),
        obj_is_sphere=_t(obj_is_sphere),
        obj_emitter=_t([obj.emitter_ref_id for obj in objects]
                       + [-1] * (len(pad_mats) - len(mats)), np.int32),
        obj_aabb_min=_t(aabbs[:, 0]),
        obj_aabb_max=_t(aabbs[:, 1]),
        mat_is_delta=_t([m.is_delta for m in pad_mats], bool),
        mat_kd=mat_rows("k_d"),
        mat_ks=mat_rows("k_s"),
        mat_kg=mat_rows("k_g"),
        mat_mean=mat_rows("mean"),
        medium=_medium_table([m.medium for m in pad_mats]),
        mixture=mixture,
        obj_mixture=_t(obj_mixture),
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
        volume=vol_data,
    )
    return scene.to(device), cfg


def load_scene(directory: str, file: str, device="cuda"):
    """Parse + compile a scene in one call; returns (scene, cfg, configs).

    The tables go to `device`, the CUDA device by default (raises when
    there is none); the CPU takes device="cpu"."""
    from ..parsers.xml_parser import scene_parsing
    device = resolve_device(device)
    with obs.setup_span("setup.scene") as sp:
        emitters, array_info, objects, configs = scene_parsing(directory,
                                                               file)
        scene, cfg = compile_scene(emitters, array_info, objects, configs,
                                   device, scene_dir=directory)
        sp.set(prims=int(scene.n_prims))
    return scene, cfg, configs
