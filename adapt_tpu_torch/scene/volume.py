"""Host-side heterogeneous grid-volume record (port of
adapt_tpu/scene/volume.py; reference bxdf/volume.py:32-236).

Loads a mitsuba3 .vol density grid (the native C++ loader, native/),
applies density scaling / mono->RGB colorization, computes the affine
index-space transform + inverse, the channel majorants, and a conservative
world AABB from the 8 transformed corners.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as xet

import numpy as np

from ..constants import VolumeTag, MediumTag
from ..parsers.general import rgb_parse, get, transform_parse

VOLUME_TYPE_MAP = {"none": VolumeTag.NONE, "mono": VolumeTag.MONO,
                   "rgb": VolumeTag.RGB}
PHASE_TYPE_MAP = {"hg": MediumTag.HG, "multi-hg": MediumTag.MULTI_HG,
                  "rayleigh": MediumTag.RAYLEIGH}


class GridVolumeRec:
    """Parsed <volume> element + loaded density grid."""

    def __init__(self, elem: xet.Element | None, scene_dir: str = "."):
        self.type_id = VolumeTag.NONE
        self.albedo = np.ones(3, np.float32)
        self.par = np.zeros(3, np.float32)
        self.phase_pdf = np.array([1.0, 0.0, 0.0], np.float32)
        self.phase_type_id = MediumTag.HG
        self.density_grid = np.zeros((1, 1, 1, 3), np.float32)
        self.forward_t = np.eye(3, dtype=np.float32)
        self.offset = np.zeros(3, np.float32)
        if elem is None:
            return

        type_name = elem.get("type", "none")
        if type_name not in VOLUME_TYPE_MAP:
            raise NotImplementedError(f"Volume type '{type_name}' unsupported")
        self.type_id = VOLUME_TYPE_MAP[type_name]
        self.phase_type_id = PHASE_TYPE_MAP[elem.get("phase_type", "hg")]

        density_scaling = np.ones(3, np.float32)
        mono2rgb = False
        path = None
        for child in elem:
            name = child.get("name")
            if child.tag == "string" and name == "density_grid":
                path = child.get("path") or child.get("value")
            elif child.tag == "rgb":
                if name == "albedo":
                    self.albedo = rgb_parse(child)
                elif name == "density_scaling":
                    density_scaling = rgb_parse(child)
                elif name == "par":
                    self.par = rgb_parse(child)
            elif child.tag in ("bool", "boolean") and name == "mono2rgb":
                mono2rgb = get(child, "value", str).lower() == "true"

        if path is None:
            raise ValueError("<volume> missing density_grid path")
        for candidate in (os.path.join(scene_dir, path), path,
                          os.path.join(scene_dir, os.path.basename(path))):
            if os.path.exists(candidate):
                path = candidate
                break
        else:
            # missing asset: degrade to no-volume instead of refusing the
            # whole scene (the reference's .vol packs are not shipped here)
            import warnings
            warnings.warn(f"volume file '{path}' not found; grid volume "
                          f"disabled for this scene")
            self.type_id = VolumeTag.NONE
            return

        from ..native import vol_file_to_numpy
        grid = vol_file_to_numpy(path)            # (Z, Y, X, 3)
        self.zres, self.yres, self.xres = grid.shape[:3]

        if mono2rgb and self.type_id == VolumeTag.MONO:
            self.type_id = VolumeTag.RGB
            grid = self._colorize(grid)
        if self.type_id == VolumeTag.MONO:
            grid = grid * density_scaling[0]
        else:
            grid = grid * density_scaling
        self.density_grid = np.ascontiguousarray(grid, np.float32)

        trans = elem.find("transform")
        if trans is not None:
            rot, off, scale = transform_parse(trans)
            if rot is not None:
                self.forward_t = rot.astype(np.float32)
            if scale is not None:
                self.forward_t = self.forward_t @ np.diag(
                    np.broadcast_to(np.asarray(scale, np.float32), (3,)))
            if off is not None:
                self.offset = off.astype(np.float32)

    @staticmethod
    def _colorize(grid: np.ndarray) -> np.ndarray:
        """Mono -> RGB gradient colorization along z
        (reference volume.py:136-160 behavior: cyan->white->yellow ramp)."""
        zres = grid.shape[0]
        half = zres // 3
        grad_l = np.linspace(1, 0, half, dtype=np.float32) ** 0.65
        grad_r = np.linspace(0, 1, zres - half, dtype=np.float32) ** 0.6
        color = np.ones((zres, 3), np.float32)
        color[:half, 0] = 1 - grad_l
        color[half:, 2] = 1 - grad_r
        return grid * color[:, None, None, :]

    @property
    def inv_T(self) -> np.ndarray:
        return np.linalg.inv(self.forward_t).astype(np.float32)

    def majorant(self, guard: float = 0.2, scale: float = 1.05) -> np.ndarray:
        maj = self.density_grid.max(axis=(0, 1, 2))
        maj = np.maximum(maj, maj.mean() * guard) * scale
        if self.type_id == VolumeTag.MONO:
            maj[:] = maj.max()
        return maj.astype(np.float32)

    def world_aabb(self):
        """Conservative AABB of the transformed index-space box
        (reference volume.py:196-210)."""
        x, y, z = self.xres, self.yres, self.zres
        corners = np.array([[i, j, k] for k in (0, z) for j in (0, y)
                            for i in (0, x)], np.float32)
        world = corners @ self.forward_t.T + self.offset
        return world.min(0) - 0.01, world.max(0) + 0.01
