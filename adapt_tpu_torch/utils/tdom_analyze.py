"""Transient time-domain curve analysis (copy of
adapt_tpu/utils/tdom_analyze.py; reference utils/tdom_analyze.py).

Extracts per-frame intensity curves from an exported transient profile
(diagonal-window or whole-frame averaging), locates peaks and their FWHM,
and optionally plots the curve. Runnable as a CLI:

    python -m adapt_tpu_torch.utils.tdom_analyze --input_path outputs/x-transient
"""
from __future__ import annotations

import os

import numpy as np


def time_domain_curve(frames: np.ndarray, window_mode: str = "diag",
                      window_size: int = 5) -> np.ndarray:
    """Per-bin scalar intensity (reference tdom_analyze.py:89-118).

    frames: (T, h, w, 3). 'diag' averages a window sliding along the image
    diagonal (one window position per bin, wrapping); 'whole' averages the
    full frame."""
    T, h, w = frames.shape[:3]
    lum = frames.mean(-1)                       # (T, h, w)
    if window_mode == "whole":
        return lum.mean(axis=(1, 2))
    curve = np.empty(T, np.float64)
    half = window_size // 2
    for i in range(T):
        frac = i / max(T - 1, 1)
        cy = int(frac * (h - 1))
        cx = int(frac * (w - 1))
        y0, y1 = max(cy - half, 0), min(cy + half + 1, h)
        x0, x1 = max(cx - half, 0), min(cx + half + 1, w)
        curve[i] = lum[i, y0:y1, x0:x1].mean()
    return curve


def analyze_peaks(curve: np.ndarray, interval: float = 1.0,
                  start_time: float = 0.0, rel_height: float = 0.5):
    """Peak + FWHM analysis (reference tdom_analyze.py:28-81).

    Returns a list of dicts {time, height, fwhm}."""
    from scipy.signal import find_peaks, peak_widths
    if curve.max() <= 0:
        return []
    peaks, _props = find_peaks(curve, height=curve.max() * 0.1,
                               distance=max(len(curve) // 50, 1))
    if len(peaks) == 0:
        return []
    widths, _h, _l, _r = peak_widths(curve, peaks, rel_height=rel_height)
    return [{"time": start_time + p * interval,
             "height": float(curve[p]),
             "fwhm": float(wd * interval)}
            for p, wd in zip(peaks, widths)]


def analyze_frames(frames: np.ndarray, out_dir: str,
                   window_mode: str = "diag", window_size: int = 5,
                   interval: float = 1.0, start_time: float = 0.0,
                   viz: bool = False) -> dict:
    """Full analysis: curve extraction + peak report + optional plot."""
    curve = time_domain_curve(frames, window_mode, window_size)
    peaks = analyze_peaks(curve, interval, start_time)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "tdom_curve.npy"), curve)
    report = {"curve_file": os.path.join(out_dir, "tdom_curve.npy"),
              "num_bins": len(curve), "peaks": peaks}
    for k, p in enumerate(peaks):
        print(f"peak {k}: t = {p['time']:.4f}, height = {p['height']:.5f}, "
              f"FWHM = {p['fwhm']:.4f}")
    if viz:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        ts = start_time + np.arange(len(curve)) * interval
        plt.figure(figsize=(8, 4))
        plt.plot(ts, curve, lw=1.2)
        for p in peaks:
            plt.axvline(p["time"], color="r", ls="--", alpha=0.5)
        plt.xlabel("time")
        plt.ylabel("mean intensity")
        plt.grid(alpha=0.3)
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, "tdom_curve.png"), dpi=120)
        plt.close()
    return report


def main():
    from ..parsers.opts import get_tdom_options
    opts = get_tdom_options()
    frames_file = os.path.join(opts.input_path, "frames.npy")
    if os.path.exists(frames_file):
        frames = np.load(frames_file)
    else:  # load an image sequence
        import glob
        try:
            import cv2
            files = sorted(glob.glob(os.path.join(opts.input_path, "*.png")))
            frames = np.stack([cv2.imread(f)[..., ::-1] / 255.0
                               for f in files]).astype(np.float32)
        except ImportError:
            raise SystemExit("no frames.npy and cv2 unavailable")
    out = opts.save_path or opts.input_path
    sol = getattr(opts, "sol", 1.0) or 1.0
    analyze_frames(frames, out, opts.window_mode, opts.window_size,
                   opts.interval / sol, opts.start_time / sol,
                   viz=opts.viz)


if __name__ == "__main__":
    main()
