"""Multi-device rendering over torch.distributed (port of
adapt_tpu/parallel/sharding.py).

One process a device: each rank loads the scene onto its own device and
issues its own launches (every pass of the port is bound by the host's
launch rate, so one process driving several cards would not render
faster). The ranks form an ('spp', 'px') mesh, rank = spp_i * px + px_i:

  * 'px'  - the pixel wavefront is cut into px shards, one a rank;
  * 'spp' - independent sample batches, averaged over the 'spp' group.

Each axis is a process group (`new_group`). Each shard draws from
fold_in(fold_in(key, spp_i), px_i), as the JAX package's shard_map does
(sharding.py:70-71, :138-139), so an image equals the JAX package's.
After a pass the 'px' shards are gathered, so every rank holds the whole
film and rank 0 can write it.

The backend is NCCL for CUDA devices and gloo for the CPU (`init_ranks`).
A CUDA run without NCCL raises; it never falls back to gloo. A caller may
still ask for gloo on CUDA tensors explicitly (two ranks sharing one
card, which NCCL refuses).
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .. import rng
from ..convert import key_from_numpy, key_to_numpy


def mesh_shape(n_devices: int, spp_parallel: int | None = None):
    """(spp, px) of an n_devices mesh; spp_parallel defaults to the
    largest power of two <= sqrt(n) that divides n (sharding.py:30-47)."""
    if spp_parallel is None:
        spp_parallel = 1 << (int(math.isqrt(n_devices)).bit_length() - 1)
        while n_devices % spp_parallel:
            spp_parallel //= 2
    if spp_parallel < 1 or n_devices % spp_parallel:
        raise ValueError(f"{n_devices=} not divisible by {spp_parallel=}")
    return spp_parallel, n_devices // spp_parallel


@dataclasses.dataclass
class Mesh:
    """This rank's place in the ('spp', 'px') mesh and its two groups
    (None where the axis has one rank: its collective is the identity).
    A rank renders on the device of the scene it is given."""
    shape: dict
    rank: int
    spp_i: int
    px_i: int
    spp_group: object
    px_group: object


def make_mesh(n_devices: int | None = None, spp_parallel: int | None = None):
    """The ('spp', 'px') mesh over ranks 0 .. n_devices - 1 (default: the
    whole world). Every rank of the world must call it (group creation is
    collective); ranks outside the mesh get None. Without an initialized
    process group the world is this one process."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices needs as many ranks; the "
                         f"world has {world}")
    S, P = mesh_shape(n, spp_parallel)
    spp_groups, px_groups = [], []
    if init and n > 1:
        # every rank creates every group, in one order
        for p in range(P):
            spp_groups.append(dist.new_group([s * P + p for s in range(S)])
                              if S > 1 else None)
        for s in range(S):
            px_groups.append(dist.new_group([s * P + p for p in range(P)])
                             if P > 1 else None)
    if rank >= n:
        return None
    spp_i, px_i = divmod(rank, P)
    return Mesh(shape={"spp": S, "px": P}, rank=rank, spp_i=spp_i,
                px_i=px_i, spp_group=spp_groups[px_i] if spp_groups else None,
                px_group=px_groups[spp_i] if px_groups else None)


def _psum(x, group):
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _pmean(x, mesh):
    return _psum(x, mesh.spp_group) / mesh.shape["spp"] \
        if mesh.spp_group is not None else x


def _gather_px(x, mesh):
    """The 'px' shards of every rank of this rank's 'px' group, in px
    order: (px * shard, ...)."""
    if mesh.px_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape["px"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.px_group)
    return torch.cat(parts)


def _shard_key(key, mesh):
    return rng.fold_in(rng.fold_in(key, mesh.spp_i), mesh.px_i)


def _with_crop(cfg, film):
    """Zero the pixels outside the crop window (sharding.py:92-104: the
    single-device passes trace only the window)."""
    from ..renderer.base import crop_pix_ids
    pix = crop_pix_ids(cfg, film.device)
    if pix is None:
        return film
    out = torch.zeros_like(film)
    out[pix] = film[pix]
    return out


def render_pass_multichip(scene, cfg, mesh, trace_fn):
    """A progressive pass over the mesh: step(scene, key, cnt) -> the whole
    (n_pixels, 3) film, averaged over the 'spp' axis (sharding.py:50-82).
    trace_fn(scene, cfg, key, ray_o, ray_d) -> (N, 3) is a single-device
    wavefront tracer (renderer/pt.py trace_pt, renderer/vpt.py
    trace_vpt)."""
    from ..renderer.base import camera_rays

    n_px = mesh.shape["px"]
    if cfg.n_pixels % n_px:
        raise ValueError(f"n_pixels={cfg.n_pixels} not divisible by "
                         f"px-axis size {n_px}")
    shard_n = cfg.n_pixels // n_px

    def step(scene, key, cnt):
        k_cam, k_trace = rng.split(_shard_key(key, mesh))
        pix = mesh.px_i * shard_n + torch.arange(
            shard_n, dtype=torch.int64, device=scene.device)
        ray_o, ray_d = camera_rays(scene, cfg, k_cam, cnt, pix_ids=pix)
        color = _pmean(trace_fn(scene, cfg, k_trace, ray_o, ray_d), mesh)
        return _with_crop(cfg, _gather_px(color, mesh))

    return step


def render_pass_bdpt_multichip(scene, cfg, mesh):
    """A BDPT pass over the mesh (sharding.py:107-164): pixel-sharded
    camera subpaths and as many light subpaths a shard; the t = 1 splat
    plane of every shard is summed over the 'px' axis and each shard
    keeps its own pixels of it; the 'spp' axis averages. With a crop
    window only its pixels are sharded, so the light subpath count equals
    the traced pixel count, as on one device."""
    from ..renderer.base import crop_pix_ids
    from ..renderer.bdpt import bdpt_pass_core

    n_px = mesh.shape["px"]
    pix_all = crop_pix_ids(cfg, scene.device)
    n_trace = cfg.n_pixels if pix_all is None else int(pix_all.shape[0])
    if n_trace % n_px:
        raise ValueError(f"traced pixel count {n_trace} (crop window) not "
                         f"divisible by px-axis size {n_px}")
    if cfg.transient:
        raise NotImplementedError("transient BDPT shards the 'spp' axis "
                                  "only (render_pass_bdpt_transient_"
                                  "multichip)")
    shard_n = n_trace // n_px

    def step(scene, key, cnt):
        k = _shard_key(key, mesh)
        base = mesh.px_i * shard_n
        pix = base + torch.arange(shard_n, dtype=torch.int64,
                                  device=scene.device)
        if pix_all is not None:
            pix = pix_all[pix]
        local, splat, _b, _c = bdpt_pass_core(scene, cfg, k, cnt,
                                              pix_ids=pix)
        splat = _psum(splat, mesh.px_group)
        color = _gather_px(_pmean(local + splat[pix], mesh), mesh)
        if pix_all is None:
            return color
        film = torch.zeros((cfg.n_pixels, 3), device=color.device)
        film[pix_all] = color
        return film

    return step


def render_pass_bdpt_transient_multichip(scene, cfg, mesh):
    """Transient BDPT over the 'spp' axis only (sharding.py:167-202): each
    rank runs the single-device (crop-local) pass with its own key; the
    color is averaged and the time-bin histograms summed over 'spp'."""
    from ..renderer.base import crop_pix_ids
    from ..renderer.bdpt import bdpt_pass_core

    if mesh.shape["px"] != 1:
        raise ValueError(
            "transient BDPT multichip scales over independent sample "
            "batches: build the mesh with make_mesh(n, spp_parallel=n)")
    pix = crop_pix_ids(cfg, scene.device)

    def step(scene, key, cnt):
        k = rng.fold_in(key, mesh.spp_i)
        if pix is None:
            local, splat, bins, cnts = bdpt_pass_core(scene, cfg, k, cnt)
            color = local + splat
        else:
            local, splat, bins, cnts = bdpt_pass_core(
                scene, cfg, k, cnt, pix_ids=pix, crop_local=True)
            color = splat.clone()
            color[pix] = color[pix] + local
        return (_pmean(color, mesh), _psum(bins, mesh.spp_group),
                _psum(cnts, mesh.spp_group))

    return step


class MultiChipRenderer:
    """Progressive renderer running one pass a step on every rank of the
    mesh (sharding.py:205-323). Each render() adds mesh.shape['spp']
    samples a pixel; every rank holds the whole film."""

    _CHECK_KEYS = ("w", "h", "focal", "max_bounce",
                   "start_x", "end_x", "start_y", "end_y")

    def __init__(self, scene, cfg, mesh, trace_fn=None, seed: int = 0,
                 bdpt: bool = False):
        self.scene = scene
        self.cfg = cfg
        self.mesh = mesh
        self.key = rng.PRNGKey(seed)
        self.color = torch.zeros((cfg.n_pixels, 3), device=scene.device)
        self.cnt = 0
        self._kind = "bdpt" if bdpt else \
            getattr(trace_fn, "__name__", "trace_pt")
        self.is_transient = bool(bdpt and cfg.transient)
        if self.is_transient:
            assert trace_fn is None, "bdpt builds its own pass"
            from ..renderer.base import crop_pix_ids
            self._pix_ids = crop_pix_ids(cfg, scene.device)
            n_traced = cfg.n_pixels if self._pix_ids is None \
                else int(self._pix_ids.shape[0])
            self.time_bins = torch.zeros((n_traced, cfg.t_bins, 3),
                                         device=scene.device)
            self.time_cnts = torch.zeros((n_traced, cfg.t_bins),
                                         dtype=torch.int32,
                                         device=scene.device)
            self._step = render_pass_bdpt_transient_multichip(scene, cfg,
                                                              mesh)
        elif bdpt:
            assert trace_fn is None, "bdpt builds its own pass"
            self._step = render_pass_bdpt_multichip(scene, cfg, mesh)
        else:
            if trace_fn is None:
                from ..renderer.pt import trace_pt
                trace_fn = trace_pt
            self._step = render_pass_multichip(scene, cfg, mesh, trace_fn)

    def render(self):
        self.cnt += self.mesh.shape["spp"]
        self.key, sub = rng.split(self.key)
        if self.is_transient:
            radiance, bins, cnts = self._step(self.scene, sub, self.cnt)
            self.time_bins = self.time_bins + bins
            self.time_cnts = self.time_cnts + cnts
        else:
            radiance = self._step(self.scene, sub, self.cnt)
        self.color = self.color + torch.nan_to_num(radiance, nan=0.0) \
            * self.mesh.shape["spp"]
        return self.color

    def copy_average(self, time_idx: int):
        from ..renderer.bdpt import transient_copy_average
        return transient_copy_average(self.cfg, self.time_bins,
                                      self.time_cnts, self._pix_ids,
                                      time_idx)

    def transient_frames(self):
        from ..renderer.bdpt import transient_frames_np
        return transient_frames_np(self.cfg, self.time_bins,
                                   self.time_cnts, self._pix_ids)

    def render_batch(self, n: int):
        """n steps (mesh.shape['spp'] samples each)."""
        for _ in range(n):
            out = self.render()
        return out

    # checkpoints: the schema and checks of renderer/base.py
    def get_check_point(self) -> dict:
        chk = {k: getattr(self.cfg, k) for k in self._CHECK_KEYS}
        chk.update({
            "renderer": f"MultiChip-{self._kind}",
            "accumulation": self.color.cpu().numpy(),
            "counter": self.cnt,
            "key": key_to_numpy(self.key),
        })
        if self.is_transient:
            from ..renderer.bdpt import transient_check_point
            chk.update(transient_check_point(self.cfg, self.time_bins,
                                             self.time_cnts))
        return chk

    def load_check_point(self, chk: dict):
        from ..renderer.bdpt import validate_transient_check_point
        want = f"MultiChip-{self._kind}"
        got = chk.get("renderer", want)
        if got != want:
            raise ValueError(f"checkpoint is from renderer '{got}', "
                             f"this run uses '{want}'")
        for k in self._CHECK_KEYS:
            if chk[k] != getattr(self.cfg, k):
                raise ValueError(
                    f"checkpoint config mismatch on '{k}': "
                    f"{chk[k]} != {getattr(self.cfg, k)}")
        # every check, the transient payload's too, before any change
        bins, cnts = validate_transient_check_point(
            self.cfg, chk,
            self.time_bins.shape if self.is_transient else None,
            self.time_cnts.shape if self.is_transient else None,
            self.is_transient, device=self.scene.device)
        self.color = torch.as_tensor(np.asarray(chk["accumulation"]),
                                     device=self.scene.device)
        self.cnt = int(chk["counter"])
        self.key = key_from_numpy(chk["key"])
        if self.is_transient:
            self.time_bins = bins
            self.time_cnts = cnts

    @property
    def pixels(self):
        return (self.color / max(self.cnt, 1)).reshape(
            self.cfg.w, self.cfg.h, 3)

    def image(self):
        return self.pixels.transpose(0, 1).flip(0).cpu().numpy()


# ------------------------------ starting ranks ------------------------------

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_ranks(rank: int, world: int, port, device="cuda", backend=None):
    """Join the process group at tcp://localhost:<port> (port None: the
    address torchrun put in the environment): NCCL for "cuda" (raises
    where this torch has no NCCL), gloo for "cpu", or the backend the
    caller names. Returns this rank's device."""
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA multi-device run needs NCCL, which this "
                           "torch build lacks")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"NCCL takes one rank a card: {world} ranks, "
                           f"{torch.cuda.device_count()} card(s)")
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    where = "env://" if port is None else f"tcp://localhost:{port}"
    dist.init_process_group(backend, init_method=where, world_size=world,
                            rank=rank)
    return dev


def _rank_main(rank, fn, world, port, device, backend, args):
    threads = os.environ.get("OMP_NUM_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    dev = init_ranks(rank, world, port, device, backend)
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device="cuda", backend=None,
              join=True):
    """Run fn(rank, world, device, *args) in `world` new processes joined
    in one process group (torch.multiprocessing.spawn), `device` the
    rank's own (init_ranks); returns when every rank has returned and
    raises if one failed. fn must be importable (a
    module-level function). join=False returns at once with the spawn
    context, whose join() the caller repeats until it returns True."""
    import torch.multiprocessing as mp
    return mp.spawn(_rank_main, args=(fn, world, free_port(), device,
                                      backend, args), nprocs=world,
                    join=join)


def under_torchrun() -> bool:
    """True inside a process torchrun started (its rank variables set)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))
