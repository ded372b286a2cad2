"""Wavefront length-compaction for the bounce loop (port of
adapt_tpu/renderer/compact.py).

The alive share of a wavefront decays fast with depth. At each (at, div)
split of a schedule the lanes still active are gathered, by index, into a
prefix of width N // div, carrying the whole loop state, and the remaining
iterations run on that prefix only. If more lanes are alive than the
prefix holds (the overflow branch), the loop stays at its current width
for the rest of the pass. Either way the lanes take the JAX package's
order (alive lanes first, each class by original lane id). Each lane's
color lands back at its original position (`pos`) at the end.

Exactness: the loop draws each lane's randomness keyed by (iteration,
original lane id) (rng.lane_uniform), so a lane's path does not depend on
where it sits in the wavefront, and a compacted pass equals the plain one
lane for lane. A grid volume's march is the exception
(ops/volume_ops.py): it draws by a lane's place in the wavefront and by
the wavefront's width, as the JAX package's does, so on a volume scene a
compacted pass equals the JAX package's compacted pass, not the plain
one.

Requirements on the state dict: 'active' (n,) bool, 'pos' (n,) i32
(original lane ids), 'color' (n,3); every other entry is a tensor with n
rows, a dataclass or dict of such, or None. Scalars live in the
iteration's closure, and the iteration derives n from the state.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import obs


def parse_schedule(s):
    """"8:4,14:16" -> ((8, 4), (14, 16)): at iteration `at`, gather alive
    lanes to a dense prefix and continue at width N/div."""
    out = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        at, div = part.split(":")
        out.append((int(at), int(div)))
    return tuple(out)


def derive_schedule(profile, iters, margin=0.7, max_div=64, max_splits=4):
    """Alive-fraction profile -> compaction schedule.

    profile[i] = alive fraction AFTER iteration i (host floats, from a
    probe pass). A split (at, div) is taken greedily when the expected
    occupancy of the narrowed prefix profile[at-1] * div <= margin, which
    keeps the overflow branch improbable, and div at least doubles the
    current narrowing. Splits are capped and must each at least halve the
    width."""
    out = []
    cur = 1
    for at in range(1, iters):
        if len(out) >= max_splits or iters - at < 2:
            break
        frac = float(profile[at - 1])
        div = cur
        while div * 2 <= max_div and frac * div * 2 <= margin:
            div *= 2
        if div >= 2 * cur:
            out.append((at, div))
            cur = div
    return tuple(out)


def take(x, idx):
    """Rows `idx` of every tensor in a state (tensors, dicts,
    dataclasses, None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[idx]
    if isinstance(x, dict):
        return {k: take(v, idx) for k, v in x.items()}
    return dataclasses.replace(
        x, **{f.name: take(getattr(x, f.name), idx)
              for f in dataclasses.fields(x)})


def run_compacted(iteration, state, iters, schedule):
    """Run `iters` iterations of `iteration(i, st) -> st` with the splits
    of `schedule`; returns the final color (N, 3) in the input's lane
    order (state['pos'] must be arange(N) on entry)."""
    N = state["active"].shape[0]
    out = torch.empty_like(state["color"])
    splits = list(schedule)
    start = 0
    while True:
        w = state["active"].shape[0]
        # a div larger than the wavefront (tiny shapes) skips the split
        # rather than narrowing to width zero
        splits = [(a, d) for (a, d) in splits
                  if start < a < iters and 0 < N // d < w]
        stop = splits[0][0] if splits else iters
        for i in range(start, stop):
            state = iteration(i, state)
        if not splits:
            break
        (at, div), splits = splits[0], splits[1:]
        start = at
        with obs.span("pt.compact", at=at, width_in=w) as sp:
            # the JAX package's order: alive lanes first, each class by
            # original lane id, also when the alive lanes overflow the
            # prefix (a grid volume's march draws by a lane's place in the
            # wavefront)
            skey = state["pos"].long() + torch.where(state["active"], 0, N)
            order = torch.argsort(skey)
            W2 = N // div
            overflow = int(obs.host_read(state["active"].sum(),
                                         "compact.alive")) > W2
            obs.count("compact.splits")
            sp.set(width_out=w if overflow else W2, overflow=int(overflow))
            if overflow:
                obs.count("compact.overflows")
                splits = []                # overflow: stay at this width
                state = take(state, order)
            else:
                # lanes left behind are finished: their colors are final
                out[state["pos"].long()] = state["color"]
                state = take(state, order[:W2])
    out[state["pos"].long()] = state["color"]
    return out
