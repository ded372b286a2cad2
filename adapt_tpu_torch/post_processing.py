"""Firefly removal post-process CLI (port of post_processing.py; reference
post_processing.py:14-45).

Conservative 3x3 outlier clamp: pixels whose luminance exceeds a threshold
times the brightest neighbor are replaced by the neighborhood median.

    python -m adapt_tpu_torch.post_processing --input outputs/pbr.png \
        --thresh 1.5
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .utils.imaging import remove_fireflies, write_image


def read_image(path: str) -> np.ndarray:
    """(h, w, 3) float32: a .npy film as it is, any other image file as
    display-encoded RGB in [0, 1] (cv2 when it is installed, else PIL)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    try:
        import cv2
        return cv2.imread(path)[..., ::-1].astype(np.float32) / 255
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255


def main(argv=None):
    ap = argparse.ArgumentParser("adapt_tpu_torch firefly removal")
    ap.add_argument("--input", required=True, help="image (.png/.npy)")
    ap.add_argument("--output", default="",
                    help="output path (default: <input>-clean)")
    ap.add_argument("--thresh", type=float, default=1.5,
                    help="luminance ratio vs brightest neighbor")
    ap.add_argument("--passes", type=int, default=1)
    opts = ap.parse_args(argv)

    img = before = read_image(opts.input)
    for _ in range(max(opts.passes, 1)):
        img = remove_fireflies(img, opts.thresh)
    changed = int((np.abs(before - img).max(-1) > 1e-6).sum())

    root, ext = os.path.splitext(opts.input)
    out = opts.output or f"{root}-clean{ext}"
    # a .npy film stays linear; any other file is display-encoded already
    write_image(out, img, gamma=1.0)
    print(f"{changed} firefly pixels cleaned -> {out}")


if __name__ == "__main__":
    main()
