"""Scene reader of the benchmark's reference: the Mitsuba-like XML (v1.1)
of upstream AdaPT and its OBJ meshes, read into plain numpy arrays.

It reads what the reference renderer supports (lambertian and Fresnel-
blend BRDFs, the det-refraction BSDF, point and spot emitters, image
albedo textures, triangle meshes with translate and Euler rotations, a
pinhole camera that looks along +z) and raises on anything else, so a
configuration the reference cannot render is refused, never approximated.
Every derived table (triangle planes and dual bases, normals, the focal
length, the texture atlas) is worked out here again from the files:
nothing the program made is read. Texture file names resolve against the
working directory, as the renderer's do.
"""
from __future__ import annotations

import dataclasses
import math
import os
import xml.etree.ElementTree as ET

import numpy as np
from scipy.spatial.transform import Rotation

LAMBERTIAN, FRESNEL_BLEND, GLASS = 0, 1, 2
POINT, SPOT = 0, 1
ATLAS_SIZES = (720, 1024, 2048, 3072, 4096)


@dataclasses.dataclass
class Scene:
    w: int
    h: int
    focal: float
    settings: dict            # max_bounce, num_shadow_ray, use_rr, ...
    cam_t: np.ndarray         # (3,) f32
    cam_r: np.ndarray         # (3, 3) f32
    prims: np.ndarray         # (T, 3, 3) f32 triangle corners
    n_g: np.ndarray           # (T, 3) f32 winding normals
    vn: np.ndarray            # (T, 3, 3) f32 vertex normals, 0 if none
    has_vn: bool
    uv: np.ndarray            # (T, 3, 2) f32 vertex uvs, 0 if none
    obj: np.ndarray           # (T,) int32 object of each triangle
    kind: np.ndarray          # (O,) int32 LAMBERTIAN, FRESNEL_BLEND, GLASS
    kd: np.ndarray            # (O, 3) f32
    ks: np.ndarray            # (O, 3) f32
    kg: np.ndarray            # (O, 3) f32
    ior: np.ndarray           # (O,) f32 the object's medium's ior
    world_ior: float
    light_kind: np.ndarray    # (E,) int32 POINT, SPOT
    light_pos: np.ndarray     # (E, 3) f32
    light_int: np.ndarray     # (E, 3) f32
    light_dir: np.ndarray     # (E, 3) f32 (spot)
    light_cos: np.ndarray     # (E,) f32 cos(half-angle) (spot)
    tex: np.ndarray           # (O, 5) f32: has texture, w, h, off_x, off_y
    atlas: np.ndarray         # (S, S, 3) f32 the albedo images, packed


def _floats(text):
    for sep in (",", " "):
        if sep in text:
            return np.array([float(p.strip()) for p in text.split(sep)],
                            dtype=np.float32)
    return np.full(3, float(text.strip()), dtype=np.float32)


def _rgb(node):
    text = node.get("value")
    if text is None:
        return np.array([float(node.get(c, "0")) for c in "rgb"],
                        dtype=np.float32)
    if text.startswith("#"):
        return np.array([int(text[1 + 2 * i:3 + 2 * i], 16) / 255.0
                         for i in range(3)], dtype=np.float32)
    return _floats(text)


def _point(node):
    if node.get("value") is not None:
        return _floats(node.get("value"))
    return np.array([float(node.get(c, "0")) for c in "xyz"],
                    dtype=np.float32)


def _ior(medium):
    for f in [] if medium is None else medium.findall("float"):
        if f.get("name") == "ior":
            return float(f.get("value", "0"))
    return 1.0


def read_obj(path):
    """(corners (T,3,3) f32, winding normals (T,3) f32, vertex normals
    (T,3,3) f32 or None, vertex uvs (T,3,2) f32 or None); polygons
    fan-triangulated."""
    verts, norms, uvs = [], [], []
    fv, ft, fn = [], [], []

    def index(tok, count):
        i = int(tok)
        return i - 1 if i > 0 else count + i

    with open(path, errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    corners.append((
                        index(sub[0], len(verts)),
                        index(sub[1], len(uvs))
                        if len(sub) > 1 and sub[1] else -1,
                        index(sub[2], len(norms))
                        if len(sub) > 2 and sub[2] else -1))
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    fv.append([c[0] for c in tri])
                    ft.append([c[1] for c in tri])
                    fn.append([c[2] for c in tri])
    faces = np.asarray(verts, dtype=np.float32)[np.asarray(fv)]
    n = np.cross(faces[:, 1] - faces[:, 0], faces[:, 2] - faces[:, 1])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    fn, ft = np.asarray(fn), np.asarray(ft)
    vn = uv = None
    if norms and (fn >= 0).all():
        vn = np.asarray(norms, dtype=np.float32)[fn]
    if uvs and (ft >= 0).all():
        uv = np.asarray(uvs, dtype=np.float32)[ft]
    return faces, n.astype(np.float32), vn, uv


def _transform(node, faces, normals):
    """Rotation about the mesh's centroid, then translation (vertex
    normals stay as the file gives them)."""
    rot = trans = None
    for child in node:
        tag = child.tag.lower()
        if tag == "translate":
            trans = np.array([float(child.get(c, "0")) for c in "xyz"],
                             dtype=np.float32)
        elif tag == "rotate" and child.get("type", "euler") == "euler":
            rot = Rotation.from_euler(
                "zxy", [float(child.get(c, "0")) for c in "rpy"],
                degrees=True).as_matrix()
        else:
            raise NotImplementedError(f"shape transform <{child.tag}>")
    if rot is not None:
        center = faces.mean(axis=1).mean(axis=0)
        faces = (faces - center) @ rot + center
        normals = normals @ rot
    if trans is not None:
        faces = faces + trans
    return faces, normals


def _material(node):
    """(kind, kd, ks, kg, ior) of a <brdf> or <bsdf>."""
    kd = np.ones(3, np.float32)
    ks = np.zeros(3, np.float32)
    kg = np.ones(3, np.float32)
    for rgb in node.findall("rgb"):
        name = rgb.get("name")
        if name in ("reflectance", "albedo", "k_d"):
            kd = _rgb(rgb)
        elif name in ("specular", "ref_ior", "k_s"):
            ks = _rgb(rgb)
        elif name in ("glossiness", "shininess", "k_g"):
            kg = _rgb(rgb)
        elif name in ("roughness", "sigma"):
            raise NotImplementedError(f"<rgb name={name!r}>")
    kind = (node.tag, node.get("type"))
    if kind == ("brdf", "lambertian"):
        return LAMBERTIAN, kd, ks, kg, 1.0
    if kind == ("brdf", "fresnel-blend"):
        kg = kg.copy()
        kg[2] = np.sqrt((kg[0] + 1.0) * (kg[1] + 1.0)) / (8.0 * np.pi)
        return FRESNEL_BLEND, kd, ks, kg, 1.0
    if kind == ("bsdf", "det-refraction"):
        return GLASS, kd, ks, kg, _ior(node.find("medium"))
    raise NotImplementedError(f"<{node.tag} type={node.get('type')!r}>")


def _emitter(node):
    """(kind, position, intensity, direction, cos of the half-angle)."""
    inten = np.ones(3, np.float32)
    for rgb in node.findall("rgb"):
        if rgb.get("name") == "emission":
            inten = _rgb(rgb)
        elif rgb.get("name") == "scaler":
            inten = inten * _rgb(rgb)
    if node.get("type") == "point":
        return POINT, _point(node.find("point")), inten, \
            np.float32([0, 0, 1]), 0.0
    if node.get("type") != "spot":
        raise NotImplementedError(f"emitter {node.get('type')}")
    pos, d = np.zeros(3, np.float32), np.float32([0, 0, 1])
    for p in node.findall("point"):
        if p.get("name") in ("position", "pos"):
            pos = _point(p)
        elif p.get("name") in ("direction", "dir"):
            v = _point(p)
            d = (v / np.linalg.norm(v)).astype(np.float32)
    half = 15.0
    for f in node.findall("float"):
        if f.get("name") == "half-angle":
            half = max(1e-3, float(f.get("value", "0")))
    return SPOT, pos, inten, d, float(np.cos(half * (np.pi / 180.0)))


def _images(root):
    """{texture id: (S,S,3)-atlas offset and size} and the atlas of the
    albedo images: a first-fit shelf packing, tallest first, into the
    smallest of ATLAS_SIZES that holds them (the renderer's layout: its
    bilinear taps add the offset before they round)."""
    from PIL import Image
    recs = []
    for node in root.findall("texture"):
        if node.get("type") != "image" \
                or node.get("tag", "albedo") != "albedo":
            raise NotImplementedError("textures other than albedo images")
        img = Image.open(node.find("string").get("value")).convert("RGB")
        if max(img.size) > 2048:
            raise NotImplementedError("textures over 2048 pixels")
        for f in node.findall("float"):
            if f.get("name") in ("scale_u", "scale_v"):
                raise NotImplementedError("texture scales")
        recs.append((node.get("id"),
                     np.asarray(img, dtype=np.float32) / 255.0))
    if not recs:
        return {}, np.zeros((1, 1, 3), np.float32)
    order = sorted(range(len(recs)), key=lambda i: -recs[i][1].shape[0])
    for size in ATLAS_SIZES:
        x = y = shelf = 0
        placed = {}
        for i in order:
            h, w = recs[i][1].shape[:2]
            if x + w > size:
                y, x, shelf = y + shelf, 0, 0
            if w > size or y + h > size:
                break
            placed[i] = (x, y)
            x, shelf = x + w, max(shelf, h)
        else:
            atlas = np.zeros((size, size, 3), np.float32)
            out = {}
            for i, (x, y) in placed.items():
                img = recs[i][1]
                atlas[y:y + img.shape[0], x:x + img.shape[1]] = img
                out[recs[i][0]] = (img.shape[1], img.shape[0], x, y)
            return out, atlas
    raise NotImplementedError("textures too large for an atlas")


def load(xml_path: str, overrides: dict) -> Scene:
    """The scene at xml_path, its sensor's integers and booleans replaced
    by `overrides` (the configuration's own values)."""
    root = ET.parse(xml_path).getroot()
    directory = os.path.dirname(xml_path)
    sensor = root.find("sensor")
    scalars = {}
    for node in sensor:
        cast = {"integer": int, "float": float,
                "boolean": lambda s: s.lower() == "true"}.get(node.tag)
        if cast is not None:
            scalars[node.get("name")] = cast(node.get("value", "0"))
    scalars.update(overrides)
    film = {n.get("name"): int(n.get("value"))
            for n in sensor.find("film").findall("integer")}
    if film.get("crop_rx", 0) > 0 and film.get("crop_ry", 0) > 0:
        raise NotImplementedError("crop windows")
    w, h = film["width"], film["height"]
    look = sensor.find("transform").find("lookat")
    origin = _floats(look.get("origin"))
    direction = _floats(look.get("target")) - origin
    direction = direction / np.linalg.norm(direction)
    direction = direction.astype(np.float32)
    direction /= np.linalg.norm(direction)
    if float(np.dot(np.float32([0, 0, 1]), direction)) <= 1.0 - 1e-5:
        raise NotImplementedError("a camera that does not look along +z")
    if root.find("volume") is not None:
        raise NotImplementedError("<volume>")

    mats = {n.get("id"): _material(n)
            for n in root.findall("brdf") + root.findall("bsdf")}
    lights = [_emitter(n) for n in root.findall("emitter")]
    images, atlas = _images(root)

    prims, n_g, vns, uvs, obj, rows, tex = [], [], [], [], [], [], []
    for i, node in enumerate(root.findall("shape")):
        if node.get("type") != "obj":
            raise NotImplementedError(f"shape {node.get('type')}")
        faces, normals, vn, uv = read_obj(
            os.path.join(directory, node.find("string").get("value")))
        if node.find("transform") is not None:
            faces, normals = _transform(node.find("transform"), faces,
                                        normals)
        refs = {}
        for r in node.findall("ref"):
            if r.get("type") == "texture" and r.get("tag", "albedo") \
                    != "albedo":
                raise NotImplementedError("textures other than albedo")
            refs[r.get("type")] = r.get("id")
        if not set(refs) <= {"material", "texture"}:
            raise NotImplementedError(f"shape references {sorted(refs)}")
        rows.append(mats[refs["material"]])
        t = images.get(refs.get("texture"))
        tex.append((0.0, 0.0, 0.0, 0.0, 0.0) if t is None
                   else (1.0, *map(float, t)))
        n = faces.shape[0]
        prims.append(faces)
        n_g.append(normals)
        vns.append(np.zeros((n, 3, 3), np.float32) if vn is None else vn)
        uvs.append(np.zeros((n, 3, 2), np.float32) if uv is None else uv)
        obj.append(np.full(n, i, np.int32))
    world = root.find("world")
    settings = dict(max_bounce=scalars.get("max_bounce", 8),
                    num_shadow_ray=scalars.get("num_shadow_ray", 1),
                    use_rr=scalars.get("use_rr", True),
                    rr_threshold=0.1, rr_bounce_th=4,
                    anti_alias=scalars.get("anti_alias", True),
                    stratified=scalars.get("stratified_sampling", True))
    fov = scalars["fov"] / 180.0 * math.pi
    return Scene(
        w=w, h=h, focal=0.5 * min(w, h) / np.tan(0.5 * fov),
        settings=settings, cam_t=origin.astype(np.float32),
        cam_r=np.eye(3, dtype=np.float32),
        prims=np.concatenate(prims).astype(np.float32),
        n_g=np.concatenate(n_g).astype(np.float32),
        vn=np.concatenate(vns).astype(np.float32),
        has_vn=any(np.abs(v).sum() > 0 for v in vns),
        uv=np.concatenate(uvs).astype(np.float32),
        obj=np.concatenate(obj),
        kind=np.int32([m[0] for m in rows]),
        kd=np.stack([m[1] for m in rows]),
        ks=np.stack([m[2] for m in rows]),
        kg=np.stack([m[3] for m in rows]),
        ior=np.float32([m[4] for m in rows]),
        world_ior=_ior(None if world is None else world.find("medium")),
        light_kind=np.int32([x[0] for x in lights]),
        light_pos=np.stack([x[1] for x in lights]),
        light_int=np.stack([x[2] for x in lights]),
        light_dir=np.stack([x[3] for x in lights]),
        light_cos=np.float32([x[4] for x in lights]),
        tex=np.float32(tex), atlas=atlas)


def triangle_tables(prims):
    """(T,12) f32 rows n d U cu V cv: the unit plane normal and offset,
    and the dual basis of the two edges with its offsets (a hit's
    barycentrics are dot(U, p) - cu and dot(V, p) - cv)."""
    p0, e1, e2 = prims[:, 0], prims[:, 1] - prims[:, 0], \
        prims[:, 2] - prims[:, 0]
    m = np.cross(e1, e2)
    m2 = np.maximum((m * m).sum(-1, keepdims=True), 1e-20)
    n = m / np.sqrt(m2)
    U = np.cross(e2, m) / m2
    V = np.cross(m, e1) / m2
    return np.concatenate(
        [n, (n * p0).sum(-1)[:, None], U, (U * p0).sum(-1)[:, None],
         V, (V * p0).sum(-1)[:, None]], axis=1).astype(np.float32)
