"""Density-grid recovery by gradient descent through ratio tracking (port
of scripts/recover_volume.py, on tests/test_grad_volume.py's problem).

    python -m adapt_tpu_torch.recover_volume --out outputs [--arch cpu]

300 Adam steps at lr 0.15 on 4,096 rays, key 11: scripts/recover_volume.py's
run.

A 12^3 Gaussian blob of peak density A is recovered from the
transmittance of rays fanned through it: `transmittance` is
`volume_ops.eval_tr_ratio_tracking` on a mono grid volume under the
differentiable march (`volume_ops.differentiable`, DIFF_STEPS = 64).
The majorant field is a constant BOUND = 1.3 A that covers every density
the optimizer can propose (grid = sigmoid(raw) * BOUND), so the
candidate points do not depend on the grid and the pathwise gradient is
unbiased. Estimate and target share each step's key (common random
numbers), which makes the loss deterministic. The optimizer is
torch.optim.Adam; the JAX package's script uses optax.adam.

Writes <out>/volume_recovery.png (the mid z-slices of the initial,
recovered and true grids, side by side, PIL) and prints the loss every
50 steps and the recovery's error. Runs on the card unless --arch cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from . import rng
from .constants import VolumeTag
from .ops import volume_ops

A = 0.15          # peak density: optical depth <= ~1.2 keeps the ratio
#                   tracker's Russian roulette (tr < 0.1) from firing
BOUND = A * 1.3   # the constant majorant
R = 12            # grid edge in voxels; world == index space == [0, R]^3
STEPS = 64        # DIFF_STEPS of the march


def make_vol(grid_1ch):
    """Mono GridVolumeData of an (R, R, R) density on its device, with the
    constant majorant field detached."""
    dev = grid_1ch.device
    S, sv = volume_ops._supervoxel_majorants(
        np.full((3, R, R, R), BOUND, np.float32))
    z3 = torch.zeros(3, device=dev)
    maj = torch.full((3,), BOUND, device=dev)
    return volume_ops.GridVolumeData(
        grid=grid_1ch[None].expand(3, R, R, R), albedo=torch.ones(3,
                                                                 device=dev),
        inv_T=torch.eye(3, device=dev), trans=z3, mini=z3,
        maxi=torch.full((3,), float(R), device=dev), majorant=maj,
        pdf=maj / maj.sum(), ph_par=z3,
        ph_pdf=torch.tensor([1.0, 0.0, 0.0], device=dev),
        sv_maj=torch.from_numpy(sv).to(dev), sv_size=int(S))


def true_grid(device="cuda"):
    """The blob: A exp(-r^2) with r in units of R / 3 from the centre."""
    ax = (np.arange(R) + 0.5 - R / 2) / (R / 3)
    r2 = (ax[:, None, None] ** 2 + ax[None, :, None] ** 2
          + ax[None, None, :] ** 2)
    return torch.from_numpy(A * np.exp(-r2).astype(np.float32)).to(device)


def rays(n, seed, device="cuda"):
    """n rays from the x = -2 plane to the x = R + 2 plane, their end points
    uniform over the grid's y-z extent."""
    g = np.random.default_rng(seed)
    o = np.stack([np.full(n, -2.0), g.uniform(0, R, n),
                  g.uniform(0, R, n)], -1).astype(np.float32)
    tgt = np.stack([np.full(n, R + 2.0), g.uniform(0, R, n),
                    g.uniform(0, R, n)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def transmittance(grid_1ch, ro, rd, key, steps=STEPS):
    """(n,) ratio-tracking transmittance of each ray, differentiable in
    grid_1ch."""
    vol = make_vol(grid_1ch)
    vol = dataclasses.replace(vol, sv_maj=vol.sv_maj.detach(),
                              majorant=vol.majorant.detach())
    n = ro.shape[0]
    with volume_ops.differentiable(steps):
        tr3 = volume_ops.eval_tr_ratio_tracking(
            vol, int(VolumeTag.MONO), key, ro, rd,
            torch.ones((n, 3), device=ro.device),
            torch.full((n,), 100.0, device=ro.device))
    return tr3[:, 0]


def recover(n_rays=4096, steps=200, lr=0.15, seed=11, device="cuda",
            log_every=0):
    """Adam on raw (grid = sigmoid(raw) * BOUND) from raw = -1, the loss
    the mean squared transmittance error under step i's key fold_in(key,
    i). Returns (recovered grid, true grid, initial grid, loss curve), the
    grids as numpy."""
    ro, rd = rays(n_rays, 2, device)        # tests/test_grad_volume.py's
    true = true_grid(device)
    key0 = rng.PRNGKey(seed)
    raw = torch.full((R, R, R), -1.0, device=device, requires_grad=True)
    init = (torch.sigmoid(raw) * BOUND).detach().cpu().numpy()
    opt = torch.optim.Adam([raw], lr=lr)
    curve = []
    for step in range(steps):
        key = rng.fold_in(key0, step)
        with torch.no_grad():
            tgt = transmittance(true, ro, rd, key)
        est = transmittance(torch.sigmoid(raw) * BOUND, ro, rd, key)
        loss = torch.mean((est - tgt) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        curve.append(loss.item())
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {curve[-1]:.3e}", flush=True)
    rec = (torch.sigmoid(raw) * BOUND).detach().cpu().numpy()
    return rec, true.cpu().numpy(), init, curve


def interior_error(rec, true):
    """(mean absolute error, correlation) away from the boundary voxels,
    which few rays sample (tests/test_grad_volume.py's judgement)."""
    sl = slice(2, R - 2)
    a, b = rec[sl, sl, sl], true[sl, sl, sl]
    return (float(np.abs(a - b).mean()),
            float(np.corrcoef(a.ravel(), b.ravel())[0, 1]))


def write_slices(path, grids):
    """The mid z-slices of `grids` side by side, each scaled by the largest
    value of the last, magnified 16 times, as a grey PNG."""
    from PIL import Image
    z = R // 2
    top = max(float(grids[-1].max()), 1e-12)
    row = np.concatenate([np.clip(g[z] / top, 0.0, 1.0) for g in grids], 1)
    img = Image.fromarray((row * 255).astype(np.uint8)).resize(
        (row.shape[1] * 16, row.shape[0] * 16), Image.NEAREST)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)


def main(argv=None):
    ap = argparse.ArgumentParser("adapt_tpu_torch density-grid recovery")
    ap.add_argument("--out", default="outputs",
                    help="directory of volume_recovery.png")
    ap.add_argument("--arch", default="cuda", choices=["cuda", "cpu"])
    opts = ap.parse_args(argv)
    if opts.arch == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--arch cuda: torch.cuda.is_available() is false "
                         "(--arch cpu runs on the CPU)")
    # scripts/recover_volume.py's run: 300 steps on 4,096 rays, key 11
    rec, true, init, curve = recover(4096, 300, 0.15, 11,
                                     device=opts.arch, log_every=50)
    err, corr = interior_error(rec, true)
    print("loss curve:", " ".join(f"{x:.3e}" for x in curve[::10]))
    print(f"interior mean abs err {err:.3e} (peak {true.max():.3f}), "
          f"correlation {corr:.6f}")
    out = os.path.join(opts.out, "volume_recovery.png")
    write_slices(out, [init, rec, true])
    print("wrote", out)


if __name__ == "__main__":
    main()
