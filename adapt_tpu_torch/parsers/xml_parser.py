"""Mitsuba-like XML v1.1 scene parser (host side).

Same scene-format surface as the reference (parsers/xml_parser.py:246-289):
<brdf>/<bsdf>, <texture>, <emitter>, <shape>, <sensor>, <world>, <volume>.
Returns (emitters, array_info, objects, configs) with the same contract so
downstream consumers (scene compiler, renderers, tests) can be validated
against the reference parser's outputs.
"""
from __future__ import annotations

import os
import numpy as np
import xml.etree.ElementTree as xet

from .. import obs
from ..constants import TRIANGLE_MESH, SPHERE
from ..scene.bxdf import parse_bxdf_node
from ..scene.emitters import parse_emitters
from ..scene.texture import parse_textures
from ..scene.world import WorldRec
from .general import get, transform_parse, parse_sphere_element
from .obj_loader import load_obj, apply_transform, calculate_surface_area
from .obj_desc import ObjDescriptor

SUPPORTED_VERSION = "1.1"
_SCALAR_TYPES = {"integer": int, "float": float, "string": str,
                 "boolean": lambda x: x.lower() == "true"}


def _zeros_like_prim(value, prim_num, last_dim=3):
    if value is None:
        return np.zeros((prim_num, 3, last_dim), dtype=np.float32)
    return value


def parse_wavefront(directory, shape_nodes, bxdf_dict, emitter_dict,
                    texture_dict):
    """Load all <shape> nodes into flat primitive arrays + ObjDescriptors.

    Reference: xml_parser.py:93-176. array_info keys: primitives (P,3,3),
    indices (sphere prim ids or None), n_g (P,3), n_s (P,3,3), uvs (P,3,2).
    """
    all_objs, all_prims, all_uvs, all_normals, all_vnorms = [], [], [], [], []
    sphere_prim_ids = []
    attached_area = {}
    has_vertex_normal = False
    cum_prims = 0

    for elem in shape_nodes:
        vns, uvs, trans_r, trans_t = None, None, None, None
        obj_type = TRIANGLE_MESH
        if elem.get("type") == "obj":
            rel = elem.find("string").get("value")
            meshes, normals, vns, uvs = load_obj(os.path.join(directory, rel))
            tr_elem = elem.find("transform")
            if tr_elem is not None:
                trans_r, trans_t, trans_s = transform_parse(tr_elem)
                meshes, normals = apply_transform(meshes, normals, trans_r,
                                                  trans_t, trans_s)
            if vns is not None:
                has_vertex_normal = True
        else:
            meshes, normals = parse_sphere_element(elem)
            obj_type = SPHERE

        bxdf_item = None
        emit_ref_id = -1
        texture_group = {"albedo": None, "normal": None, "bump": None,
                         "roughness": None}
        for ref in elem.findall("ref"):
            ref_type, ref_id = ref.get("type"), ref.get("id")
            if ref_type == "material":
                bxdf_item = bxdf_dict[ref_id]
            elif ref_type == "emitter":
                emit_ref_id = emitter_dict[ref_id]
                attached_area[emit_ref_id] = calculate_surface_area(meshes,
                                                                    obj_type)
            elif ref_type == "texture":
                tag = ref.get("tag") or "albedo"
                if tag not in texture_group:
                    tag = "albedo"
                if texture_dict is None or texture_dict.get(tag) is None \
                        or ref_id not in texture_dict[tag]:
                    raise KeyError(f"Texture '{ref_id}' has no '{tag}' entry")
                texture_group[tag] = texture_dict[tag][ref_id]
        if bxdf_item is None:
            raise ValueError("Every shape must reference a material")

        prim_num = meshes.shape[0]
        if obj_type == SPHERE:  # pad (1,2,3) -> (1,3,3)
            meshes = np.concatenate(
                [meshes, np.zeros((1, 1, 3), np.float32)], axis=-2)
            sphere_prim_ids.append(cum_prims)
        all_prims.append(meshes)
        all_normals.append(normals)
        all_vnorms.append(_zeros_like_prim(vns, prim_num))
        all_uvs.append(_zeros_like_prim(uvs, prim_num, last_dim=2))
        all_objs.append(ObjDescriptor(meshes, normals, bxdf_item, vns, uvs,
                                      texture_group, trans_r, trans_t,
                                      emit_ref_id, obj_type))
        cum_prims += prim_num

    array_info = {
        "primitives": np.concatenate(all_prims, axis=0).astype(np.float32),
        "indices": (np.array(sphere_prim_ids, np.int64)
                    if sphere_prim_ids else None),
        "n_g": np.concatenate(all_normals, axis=0).astype(np.float32),
        "n_s": np.concatenate(all_vnorms, axis=0).astype(np.float32),
        "uvs": np.concatenate(all_uvs, axis=0).astype(np.float32),
    }
    return array_info, all_objs, attached_area, has_vertex_normal


def parse_global_sensor(sensor_elem):
    """Flatten the <sensor> block into a config dict
    (reference xml_parser.py:225-244)."""
    config = {}
    for elem in sensor_elem:
        if elem.tag in _SCALAR_TYPES:
            config[elem.get("name")] = get(elem, "value", _SCALAR_TYPES[elem.tag])
    config["transform"] = transform_parse(sensor_elem.find("transform"))
    config["film"] = {}
    film = sensor_elem.find("film")
    if film is None:
        raise ValueError("<sensor> is missing its <film> element")
    for elem in film.findall("integer"):
        config["film"][elem.get("name")] = get(elem, "value", int)
    if "width" not in config["film"] or "height" not in config["film"]:
        raise ValueError("<film> must define integer width and height "
                         "(reference xml_parser.py:238 asserts the same)")
    return config


@obs.spanned("setup.scene.parse", setup=True)
def scene_parsing(directory: str, file: str):
    """Top-level scene parse; mirrors reference xml_parser.py:246-289."""
    tree = xet.parse(os.path.join(directory, file))
    root = tree.getroot()
    if root.attrib.get("version") != SUPPORTED_VERSION:
        raise ValueError(f"Unsupported scene version {root.attrib.get('version')}")

    bxdf_nodes = root.findall("bsdf") + root.findall("brdf")
    emitter_nodes = root.findall("emitter")
    shape_nodes = root.findall("shape")
    texture_nodes = root.findall("texture")
    sensor_node = root.find("sensor")
    world_node = root.find("world")
    volume_nodes = root.findall("volume")[:1]  # only first volume kept
    assert sensor_node is not None, "scene must contain a <sensor>"

    emitters, emitter_dict = parse_emitters(emitter_nodes)
    bxdf_dict = {}
    for node in bxdf_nodes:
        bxdf_dict[node.get("id")] = parse_bxdf_node(node)
    # bind mixture component references now that every BxDF is declared
    from ..scene.bxdf import Mixture_np
    for item in bxdf_dict.values():
        if isinstance(item, Mixture_np):
            item.resolve(bxdf_dict)
    teximgs, textures = parse_textures(texture_nodes)
    array_info, objects, area_lut, has_vn = parse_wavefront(
        directory, shape_nodes, bxdf_dict, emitter_dict, textures)

    configs = parse_global_sensor(sensor_node)
    configs["world"] = WorldRec(world_node)
    configs["packed_textures"] = teximgs
    configs["has_vertex_normal"] = has_vn
    configs["volume"] = volume_nodes

    # Attach emitters to their shapes (reference xml_parser.py:56-64)
    for i, emitter in enumerate(emitters):
        if i in area_lut:
            emitter.inv_area = 1.0 / area_lut[i]
            emitter.attached = True
        elif emitter.type == "area":
            raise ValueError("Area emitters must be attached to a shape")
    return emitters, array_info, objects, configs
