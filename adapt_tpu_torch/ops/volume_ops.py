"""Heterogeneous grid-volume transport: delta and ratio tracking (port of
adapt_tpu/ops/volume_ops.py; reference bxdf/volume.py:263-463).

Spectral single-channel selection by throughput-weighted majorant pdf,
exponential free flights at the local (supervoxel) majorant with DDA hops
over supervoxel walls, stochastic nearest-neighbour density lookups,
delta-tracking collisions and ratio-tracking transmittance with Russian
roulette. The march is plain PyTorch, as it is plain jnp in the JAX
package.

The random stream is the JAX package's, bit for bit, and it depends on
how that package lays the lanes out (`_compact_rounds`): above
COMPACT_MIN lanes the lanes that cross the volume are moved to the front
in lane order and cut into rounds of C = ceil(ceil(N / 8) / 128) * 128
lanes, and step s of round r draws `uniform(fold_in(key, r * (MAX_STEPS +
1) + s), (C, VOL_HOPS + 4))`, one row a lane by its slot in the round; at
or below it there is one round of all N lanes, a lane's slot its index.
The port marches every crossing lane in one batch and draws each lane's
row from its own round's key (`_lane_uniforms`), so a lane's numbers
depend only on (round, step, slot) and the batch equals the JAX
package's sequential rounds. A call may take a list of keys, one for
each block of its lanes: each block then marches as a call of its own
would, all in one batch (BDPT's strategies that the JAX package
connects one at a time). Done lanes are no-ops: the port draws
STEP_BLOCK steps' uniforms at once, reads after each step whether any
lane lives, drops the done lanes once half of the batch is done, and
steps no lane past MAX_STEPS.

What the port leaves out, because it shapes the work for the TPU and not
the semantics: `_sv_lookup`'s one-hot matmul (a direct index of `sv_maj`
reads the same table values), `_gather_candidates`' J-major concatenation
(a plain gather), the sort-based compaction itself (an index of the
crossing lanes gives the same slots), and the environment knobs
ADAPT_VOL_HOPS, ADAPT_SV_CAP and ADAPT_VOL_UNROLL, whose shipped values
are the constants below.

The differentiable march (`DIFF_STEPS` > 0, adapt_tpu/ops/volume_ops.py
DIFF_STEPS): one round of all N lanes, each lane's slot its index (the
JAX package skips `_compact_rounds` there), and exactly DIFF_STEPS steps
with no host read of `done` and no lane dropped, so autograd sees one
fixed graph. The done mask already makes a finished lane's steps no-ops.
With the majorants held constant (the caller detaches `sv_maj` and
`majorant`), the candidate points do not depend on the density, and the
pathwise gradient of the ratio factors (1 - d / maj) through `grid` is an
unbiased estimate of the gradient of the expected transmittance.
`differentiable(steps)` sets it for a block.

`_to_local`'s (N,3) @ (3,3) product is written out as f32 sums of f32
products, which is how the JAX package's CPU backend rounds it (it
differed from a fused chain in ~38% of cbox-rgbvol's rotated rays). The
sample positions lo + t ld round as plain f32 sums here; that backend
fuses the x and y components into multiply-adds (measured on (n,3)
arrays), which moved no lane of tests/test_torch_volume.py's sets.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import obs, rng
from ..constants import VolumeTag

MAX_STEPS = 1024     # march cap: a lane still live here stops
VOL_HOPS = 4         # supervoxel hops a step before the density lookup
SV_AXIS_CAP = 16     # supervoxels along the longest axis, at most
COMPACT_DIV = 8      # round width: N / COMPACT_DIV, rounded up to 128
COMPACT_MIN = 2048   # at or below this many lanes, one round of N lanes
STEP_BLOCK = 8       # march steps between two tests of `done`
DIFF_STEPS = 0       # > 0: each march takes exactly this many steps
FLT_MIN = float(np.finfo(np.float32).tiny)   # the least normal float32

# the tracking calls while `record_marches()` is open, else None
_marches = None


@contextlib.contextmanager
def record_marches():
    """Record every tracking call while open. Yields a list that gets one
    dict a call: lanes (handed to it), crossing (those that march), blocks
    (the marches it runs side by side, one a key), rounds (the JAX
    package's, the most of any one block), steps (the march's) and s (its
    seconds, the device synchronized at both ends); steps and s stay 0
    where no lane crosses."""
    global _marches
    saved, _marches = _marches, []
    try:
        yield _marches
    finally:
        _marches = saved


@contextlib.contextmanager
def differentiable(steps=64):
    """Run the tracking marches as the differentiable march of `steps`
    steps (DIFF_STEPS) while open."""
    global DIFF_STEPS
    saved, DIFF_STEPS = DIFF_STEPS, int(steps)
    try:
        yield
    finally:
        DIFF_STEPS = saved


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class GridVolumeData:
    """Device-side grid volume (reference volume.py:239-261). The kind tag
    lives in RenderConfig (`volume_kind`, `volume_phase`)."""
    grid: torch.Tensor      # (3, Z, Y, X) channel-major density
    albedo: torch.Tensor    # (3,)
    inv_T: torch.Tensor     # (3,3) world -> index space
    trans: torch.Tensor     # (3,) translation
    mini: torch.Tensor      # (3,) world AABB
    maxi: torch.Tensor
    majorant: torch.Tensor  # (3,) global majorants (spectral pick pdf)
    pdf: torch.Tensor       # (3,) majorant / sum
    ph_par: torch.Tensor    # (3,) phase parameters
    ph_pdf: torch.Tensor    # (3,) multi-HG lobe weights
    # (3, SZ, SY, SX) local majorants: the maxima over each supervoxel's
    # block dilated by one voxel
    sv_maj: torch.Tensor
    sv_size: int = 1        # supervoxel edge in voxels (a host int)


def dummy_volume() -> GridVolumeData:
    """The placeholder of a scene without a grid volume."""
    z3 = torch.zeros(3)
    return GridVolumeData(
        grid=torch.zeros((3, 1, 1, 1)), albedo=torch.ones(3),
        inv_T=torch.eye(3), trans=z3, mini=z3, maxi=z3,
        majorant=torch.ones(3), pdf=torch.full((3,), 1 / 3), ph_par=z3,
        ph_pdf=torch.tensor([1.0, 0.0, 0.0]),
        sv_maj=torch.zeros((3, 1, 1, 1)), sv_size=1)


def _supervoxel_majorants(dens):
    """(3, Z, Y, X) density -> (sv_size, (3, SZ, SY, SX) local majorants).

    Each supervoxel's value is the max density over its block dilated by
    one voxel on every side: the stochastic lookup's jitter (pos + u -
    0.5) can read a neighbour voxel of the sample position, so the local
    majorant must cover it. Outside-grid padding is density 0."""
    _, Z, Y, X = dens.shape
    S = 8
    while max(Z, Y, X) > S * SV_AXIS_CAP:
        S *= 2

    d = np.asarray(dens)
    for ax in (1, 2, 3):            # separable radius-1 max filter
        p = np.concatenate([d.take([0], ax), d, d.take([-1], ax)], axis=ax)
        n = d.shape[ax]
        d = np.maximum(np.maximum(p.take(range(0, n), ax),
                                  p.take(range(1, n + 1), ax)),
                       p.take(range(2, n + 2), ax))
    pz, py, px = [(-n) % S for n in (Z, Y, X)]
    d = np.pad(d, ((0, 0), (0, pz), (0, py), (0, px)))
    sv = d.reshape(3, (Z + pz) // S, S, (Y + py) // S, S,
                   (X + px) // S, S).max(axis=(2, 4, 6))
    return S, sv.astype(np.float32)


def compile_volume(rec) -> GridVolumeData:
    """Host GridVolumeRec (scene/volume.py) -> CPU tensors."""
    mini, maxi = rec.world_aabb()
    maj = rec.majorant()
    # channel-major (3, Z, Y, X): a lookup reads only the picked channel
    grid_cm = np.ascontiguousarray(np.moveaxis(rec.density_grid, -1, 0))
    sv_size, sv_maj = _supervoxel_majorants(grid_cm)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return GridVolumeData(
        grid=t(grid_cm), albedo=t(rec.albedo), inv_T=t(rec.inv_T),
        trans=t(rec.offset), mini=t(mini), maxi=t(maxi), majorant=t(maj),
        pdf=t(maj / maj.sum()), ph_par=t(rec.par), ph_pdf=t(rec.phase_pdf),
        sv_maj=t(sv_maj), sv_size=int(sv_size))


def intersect_volume(vol, ray_o, ray_d, max_t):
    """Ray / world-AABB slab test -> (near, far) (reference
    volume.py:267-281)."""
    safe_d = torch.where(torch.abs(ray_d) < 1e-9, 1e-9, ray_d)
    t1 = (vol.mini[None, :] - ray_o) / safe_d
    t2 = (vol.maxi[None, :] - ray_o) / safe_d
    near = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=0.0) + 1e-5
    far = torch.minimum(max_t, torch.maximum(t1, t2).amin(dim=-1)) - 1e-5
    return near, far


def _mat3(v, m):
    """v @ m.T for (n,3) v, written out as ((v0 m0 + v1 m1) + v2 m2) with
    each product and sum rounded to f32: the JAX package's CPU rounding
    of this product (a matrix product could take TF32 or fused steps)."""
    return torch.stack([(v[:, 0] * m[k, 0] + v[:, 1] * m[k, 1])
                        + v[:, 2] * m[k, 2] for k in range(3)], dim=-1)


def _to_local(vol, ray_o, ray_d):
    """World rays in index space: (o - trans) inv_T^T and d inv_T^T."""
    return _mat3(ray_o - vol.trans[None, :], vol.inv_T), \
        _mat3(ray_d, vol.inv_T)


def _march_interval(vol, ray_o, ray_d, max_t):
    """March bounds in the ray parameter, from the local grid slab
    extended by half a voxel a side (the stochastic lookup reads up to
    half a voxel past the boundary). A ray inside a rotated grid's world
    AABB but outside the grid gets an empty interval instead of a march
    that stalls on its supervoxel walls. Returns (lo, ld, near, far);
    empty intervals have near >= far."""
    lo, ld = _to_local(vol, ray_o, ray_d)
    Z, Y, X = vol.grid.shape[1:]
    ext = torch.tensor([X, Y, Z], dtype=torch.float32,
                       device=ray_o.device) + 0.5
    par = torch.abs(ld) < 1e-9
    safe_d = torch.where(par, 1e-9, ld)
    t1 = (-0.5 - lo) / safe_d
    t2 = (ext[None, :] - lo) / safe_d
    lo_in = (lo > -0.5) & (lo < ext[None, :])
    inf = torch.tensor(float("inf"), device=ray_o.device)
    tmin = torch.where(par, torch.where(lo_in, -inf, inf),
                       torch.minimum(t1, t2))
    tmax = torch.where(par, torch.where(lo_in, inf, -inf),
                       torch.maximum(t1, t2))
    near = torch.clamp(tmin.amax(dim=-1), min=0.0) + 1e-5
    far = torch.minimum(max_t, tmax.amin(dim=-1)) - 1e-5
    return lo, ld, near, far


def _ftz(x):
    """Subnormal values read as 0, as the JAX package's CPU backend reads
    them (its one-hot majorant lookup returns 0 for a subnormal table
    value, and its comparisons take a subnormal density as 0); the
    tables keep them, as the JAX package's do."""
    return torch.where(torch.abs(x) < FLT_MIN, 0.0, x)


def _density_index(vol, pos, u3):
    """Stochastic nearest-neighbour cell of a density lookup (reference
    volume.py:307-314): ((n,3) clipped (x, y, z) index, (n,) in-bounds)."""
    idx = torch.floor(pos + (u3 - 0.5)).to(torch.int64)
    Z, Y, X = vol.grid.shape[1:]
    ok = ((idx >= 0).all(dim=-1) & (idx[:, 0] <= X - 1)
          & (idx[:, 1] <= Y - 1) & (idx[:, 2] <= Z - 1))
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=pos.device)
    return torch.minimum(torch.clamp(idx, min=0), hi), ok


def _pick_channel(vol, thp, u):
    """Throughput-weighted spectral channel pick (reference
    volume.py:352-375); returns (channel, pdf)."""
    pdfs = thp * vol.pdf[None, :]
    total = (pdfs[:, 0] + pdfs[:, 1]) + pdfs[:, 2]
    pdfs = pdfs / torch.clamp(total, min=1e-12)[:, None]
    cdf0 = pdfs[:, 0]
    cdf1 = cdf0 + pdfs[:, 1]
    ch = (u > cdf0).to(torch.int64) + (u > cdf1).to(torch.int64)
    return ch, pdfs.gather(1, ch[:, None])[:, 0]


def _tables(vol):
    """A tracking call's constants: the local majorants as the JAX
    package's CPU backend reads them (`_ftz`), the table's last cell and
    the supervoxel edge."""
    _, SZ, SY, SX = vol.sv_maj.shape
    return dict(vol=vol, sv=_ftz(vol.sv_maj), S=float(vol.sv_size),
                hi=torch.tensor([SX - 1, SY - 1, SZ - 1],
                                device=vol.sv_maj.device))


def _walk(lo, ld):
    """A lane's walk constants from its local ray: lo, ld, the axes it
    walks up (ld > 0), the axes it runs parallel to (|ld| < 1e-9), the
    divisor with those set to 1e-9, and the nudge past a wall: at least
    1e-3 voxel, so rounding cannot re-enter the same supervoxel and stall
    the walk."""
    flat = torch.abs(ld) < 1e-9
    return dict(lo=lo, ld=ld, up=ld > 0.0, flat=flat,
                safe_d=torch.where(flat, 1e-9, ld),
                nudge=1e-3 / torch.clamp(torch.abs(ld).amax(dim=-1),
                                         min=1e-12))


def _sv_step(tab, w, ch, t, e_flight):
    """One hierarchical-majorant step from parameter t; w: `_walk`'s
    constants, e_flight = -log1p(-u) the unit-rate flight.

    Returns (m_loc, t_cand, t_hop): the local majorant at t's supervoxel
    (the lookup clipped to the table: edge supervoxels are dilated to
    cover the jitter margin), the sampled collision candidate (inf where
    the local majorant is 0) and the parameter just past the supervoxel's
    exit, from the unclipped cell (in the margin outside the grid the
    clipped cell's wall lies behind the ray). The caller takes the
    candidate when t_cand <= min(t_hop, far), else hops: exact
    null-collision tracking with a piecewise-constant majorant."""
    S = tab["S"]
    pos = w["lo"] + t[:, None] * w["ld"]
    svi_raw = torch.floor(pos / S).to(torch.int64)
    svi = torch.minimum(torch.clamp(svi_raw, min=0), tab["hi"])
    m_loc = tab["sv"][ch, svi[:, 2], svi[:, 1], svi[:, 0]]
    b_lo = svi_raw.to(torch.float32) * S
    bound = torch.where(w["up"], b_lo + S, b_lo)
    t_ax = torch.where(w["flat"], float("inf"),
                       (bound - w["lo"]) / w["safe_d"])
    t_hop = torch.maximum(t_ax.amin(dim=-1), t) + w["nudge"]
    dt = torch.where(m_loc > 0.0, e_flight / torch.clamp(m_loc, min=1e-12),
                     float("inf"))
    return m_loc, t + dt, t_hop


def _one_hot_tr(kind, tr, pdf, ch):
    """Mono -> uniform Tr; RGB -> one-hot Tr / pdf (volume.py:391-401)."""
    if kind == VolumeTag.RGB:
        oh = torch.nn.functional.one_hot(ch, 3).to(torch.float32)
        return oh * (tr / torch.clamp(pdf, min=1e-12))[:, None]
    return tr[:, None].expand(tr.shape[0], 3)


def _lanes(crossing, blocks=1):
    """The lanes that march, their rounds and their slots (the JAX
    package's `_compact_rounds` layout), and each block's count of rounds.

    The lanes are `blocks` marches of N = len / blocks lanes side by side,
    each laid out as if it ran alone: a lane's slot is its place in a
    round of its own block, and its round is numbered among all blocks'
    rounds, block after block."""
    N = crossing.shape[0] // blocks
    lane = torch.nonzero(crossing).squeeze(1)
    blk = torch.div(lane, N, rounding_mode="floor")
    if N <= COMPACT_MIN or DIFF_STEPS > 0:
        return lane, blk, lane - blk * N, [1] * blocks
    C = -(-N // COMPACT_DIV)
    C = -(-C // 128) * 128
    per = torch.bincount(blk, minlength=blocks)
    rank = torch.arange(lane.shape[0], device=lane.device) \
        - (torch.cumsum(per, 0) - per)[blk]
    rounds = [max(1, -(-n // C))
              for n in obs.host_read(per, "vol.rounds").tolist()]
    first = torch.tensor(np.cumsum([0] + rounds[:-1]), dtype=torch.int64,
                         device=lane.device)
    return lane, first[blk] + rank // C, rank % C, rounds


def _lane_uniforms(keys, rounds, r, slot, step0, steps):
    """(n, steps, VOL_HOPS + 4) uniforms: row `slot` of round rr's
    `uniform(fold_in(key, rr * (MAX_STEPS + 1) + s), (C, VOL_HOPS + 4))`
    for s = step0 .. step0 + steps - 1, where `r` numbers the rounds of
    all blocks (`_lanes`) and block b draws from keys[b]."""
    D = VOL_HOPS + 4
    dev = slot.device
    table = torch.tensor(
        [[rng.fold_in(key, rr * (MAX_STEPS + 1) + step0 + s)
          for s in range(steps)]
         for key, n in zip(keys, rounds) for rr in range(n)],
        dtype=torch.int64, device=dev)                 # (rounds, steps, 2)
    k = table[r]                                       # (n, steps, 2)
    ctr = slot[:, None, None] * D + torch.arange(D, device=dev)
    b1, b2 = rng.threefry2x32(k[:, :, 0, None], k[:, :, 1, None], 0, ctr)
    return rng._bits_to_unit_float(b1 ^ b2)


@obs.spanned("vol.march", lambda keys, r, *_: {"lanes": r.shape[0]})
def _march(keys, r, slot, rounds, ins, state, step_fn):
    """Step every marching lane until all are done or MAX_STEPS steps ran.

    ins: per-lane march inputs (`_walk`'s, far, ch, ...); state: per-lane
    outputs and `t` / `done`; step_fn(ins, state, u) -> state advances
    one step. Each STEP_BLOCK steps draw their uniforms at once. After
    each step the host reads how many lanes live (issuing a step's ~300
    launches takes longer than the sync); once half of the batch is
    done, the done lanes leave it with their state. Returns the final
    state of every lane, in lane order. With DIFF_STEPS > 0: exactly
    DIFF_STEPS steps of every lane, no read and no drop."""
    rec = _marches[-1] if _marches is not None else None
    if rec is not None:
        _sync(r)
        t0 = time.perf_counter()
    if DIFF_STEPS > 0:
        for step in range(0, DIFF_STEPS, STEP_BLOCK):
            u = _lane_uniforms(keys, rounds, r, slot, step,
                               min(STEP_BLOCK, DIFF_STEPS - step))
            for b in range(u.shape[1]):
                state = step_fn(ins, state, u[:, b])
        if rec is not None:
            _sync(r)
            rec.update(steps=DIFF_STEPS, s=time.perf_counter() - t0)
        obs.annotate(steps=DIFF_STEPS)
        return state
    out = {k: v.clone() for k, v in state.items()}
    idx = torch.arange(r.shape[0], device=r.device)
    u = None
    for step in range(MAX_STEPS):
        b = step % STEP_BLOCK
        if b == 0:
            u = _lane_uniforms(keys, rounds, r, slot, step,
                               min(STEP_BLOCK, MAX_STEPS - step))
        state = step_fn(ins, state, u[:, b])
        live = ~state["done"]
        n_live = int(obs.host_read(live.sum(), "vol.n_live"))
        if 2 * n_live > idx.shape[0] and step + 1 < MAX_STEPS:
            continue
        for k, v in state.items():
            out[k][idx] = v
        if n_live == 0:
            break
        idx, r, slot, u = idx[live], r[live], slot[live], u[live]
        ins = {k: v[live] for k, v in ins.items()}
        state = {k: v[live] for k, v in state.items()}
    if rec is not None:
        _sync(r)
        rec.update(steps=step + 1, s=time.perf_counter() - t0)
    obs.annotate(steps=step + 1)
    return out


def _hop_chain(tab, ins, t, exited, u):
    """Up to VOL_HOPS supervoxel steps from t, freezing at the lane's
    next collision candidate, then the candidate's density: (t, exited,
    found, cand_t, cand_m, density)."""
    far, ch = ins["far"], ins["ch"]
    found = torch.zeros_like(exited)
    cand_t = t
    cand_m = torch.zeros_like(t)
    e_flight = -torch.log1p(-u[:, :VOL_HOPS])
    for j in range(VOL_HOPS):
        m_loc, t_cand, t_hop = _sv_step(tab, ins, ch, t, e_flight[:, j])
        is_cand = ~exited & ~found & (t_cand <= torch.minimum(t_hop, far))
        cand_t = torch.where(is_cand, t_cand, cand_t)
        cand_m = torch.where(is_cand, m_loc, cand_m)
        found = found | is_cand
        move = ~(found | exited)
        t = torch.where(move, t_hop, t)
        exited = exited | (move & (t >= far))
    # fresh jitter and acceptance draws, whichever hop froze the candidate
    vol = tab["vol"]
    pos = ins["lo"] + cand_t[:, None] * ins["ld"]
    ci, ok = _density_index(vol, pos, u[:, VOL_HOPS:VOL_HOPS + 3])
    val = torch.where(ok & found,
                      _ftz(vol.grid[ch, ci[:, 2], ci[:, 1], ci[:, 0]]), 0.0)
    return t, exited, found, cand_t, cand_m, val


def _delta_step(tab):
    def step(ins, st, u):
        t, exited, found, cand_t, cand_m, val = _hop_chain(
            tab, ins, st["t"], st["done"], u)
        collide = found & (u[:, VOL_HOPS + 3]
                           * torch.clamp(cand_m, min=1e-12) < val)
        return dict(
            hit_t=torch.where(collide, cand_t, st["hit_t"]),
            tr=torch.where(collide, st["tr"] * ins["alb"], st["tr"]),
            # null candidates march on from the candidate point
            t=torch.where(found, cand_t, t),
            done=st["done"] | collide | exited)
    return step


def _ratio_step(tab):
    def step(ins, st, u):
        t, exited, found, cand_t, cand_m, val = _hop_chain(
            tab, ins, st["t"], st["done"], u)
        # the ratio factor at the local rate; hops leave tr alone
        tr = torch.where(found, st["tr"] * torch.clamp(
            1.0 - val / torch.clamp(cand_m, min=1e-12), min=0.0), st["tr"])
        rr = found & (tr < 0.1)
        killed = rr & (u[:, VOL_HOPS + 3] >= tr)
        tr = torch.where(killed, 0.0, torch.where(rr, 1.0, tr))
        return dict(tr=tr, t=torch.where(found, cand_t, t),
                    done=st["done"] | exited | killed)
    return step


def _setup(vol, key, ray_o, ray_d, thp, max_t, active):
    """The march's shared prologue: interval, channel pick, crossing
    lanes and their inputs. key: one key, or a list of keys, one for each
    block of len(ray_o) / len(key) lanes, which then marches as its own
    call with that key would (`_lanes`)."""
    N = ray_o.shape[0]
    keys = key if isinstance(key, list) else [key]
    n = N // len(keys)
    lo, ld, near, far = _march_interval(vol, ray_o, ray_d, max_t)
    splits = [rng.split(k) for k in keys]
    keys = [k for k, _ in splits]
    u_ch = torch.cat([rng.uniform(k_ch, (n,), device=ray_o.device)
                      for _, k_ch in splits])
    ch, pdf = _pick_channel(vol, thp, u_ch)
    crossing = (near < far) & (far > 0.0)
    if active is not None:
        crossing = crossing & active
    lane, r, slot, rounds = _lanes(crossing, len(keys))
    if _marches is not None:
        _marches.append(dict(lanes=N, crossing=lane.shape[0],
                             rounds=max(rounds), blocks=len(keys), steps=0,
                             s=0.0))
    ins = dict(_walk(lo[lane], ld[lane]), far=far[lane], ch=ch[lane])
    return keys, ch, pdf, crossing, lane, r, slot, rounds, ins, near[lane]


def sample_distance_delta_tracking(vol, kind, key, ray_o, ray_d, thp,
                                   max_t, active=None):
    """Spectral delta-tracking distance sample (volume.py:346-402).

    Returns (t, beta): t the collision distance or -1 (no volume event);
    beta multiplies the throughput only where t > 0. Dead lanes (active
    False) do not march."""
    N = ray_o.shape[0]
    keys, ch, pdf, crossing, lane, r, slot, rounds, ins, near = _setup(
        vol, key, ray_o, ray_d, thp, max_t, active)
    hit_t = torch.full((N,), -1.0, device=ray_o.device)
    tr = torch.ones(N, device=ray_o.device)
    if lane.numel():
        ins["alb"] = vol.albedo[ins["ch"]]
        n = lane.shape[0]
        st = _march(keys, r, slot, rounds, ins, dict(
            t=near, tr=torch.ones(n, device=near.device),
            hit_t=torch.full((n,), -1.0, device=near.device),
            done=torch.zeros(n, dtype=torch.bool, device=near.device)),
            _delta_step(_tables(vol)))
        hit_t[lane] = st["hit_t"]
        tr[lane] = st["tr"]
    beta = _one_hot_tr(kind, tr, pdf, ch)
    beta = torch.where((hit_t > 0.0)[:, None], beta, 1.0)
    return hit_t, beta


def eval_tr_ratio_tracking(vol, kind, key, ray_o, ray_d, thp, max_t,
                           active=None):
    """Spectral ratio-tracking transmittance (volume.py:404-463). Dead
    lanes (active False) do not march and return Tr = 1. key: one key, or
    a list of keys for blocks of lanes that march as calls of their own
    (`_setup`)."""
    N = ray_o.shape[0]
    keys, ch, pdf, crossing, lane, r, slot, rounds, ins, near = _setup(
        vol, key, ray_o, ray_d, thp, max_t, active)
    tr = torch.ones(N, device=ray_o.device)
    if lane.numel():
        n = lane.shape[0]
        st = _march(keys, r, slot, rounds, ins, dict(
            t=near, tr=torch.ones(n, device=near.device),
            done=torch.zeros(n, dtype=torch.bool, device=near.device)),
            _ratio_step(_tables(vol)))
        tr[lane] = st["tr"]
    tr3 = _one_hot_tr(kind, tr, pdf, ch)
    return torch.where(crossing[:, None], tr3, 1.0)
