"""Rank bodies of tests/test_torch_parallel*.py: each runs in every gloo
CPU rank that `sharding.run_ranks` starts, renders its scenes over the
port's MultiChipRenderer and, on rank 0, saves the films to an .npz the
tests read. The scenes and settings are tests/test_parallel.py's.
`shard_film` rebuilds a mesh's film from single-process passes: the
reference of these tests, of tests/test_torch_cli.py's `--multichip` and
of chip_smoke.py's phase 22. This module imports no JAX: the ranks (and
chip_smoke.py) load only the port. Its one test holds the settings to
tests/test_parallel.py's.
"""
import dataclasses
import os

import numpy as np
import torch

from adapt_tpu_torch import rng
from adapt_tpu_torch.parallel import sharding
from adapt_tpu_torch.scene.compile import load_scene

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes")


def small(cfg, w, mb, **kw):
    """tests/test_parallel.py's reduction: w^2, mb bounces, no jitter, no
    Russian roulette."""
    return dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                               end_x=w, end_y=w, max_bounce=mb,
                               anti_alias=False, stratified_sampling=False,
                               use_rr=False, **kw)


def crop(cfg, start_y=2, end_y=14):
    """tests/test_parallel.py's 16^2 crop window x 4..12, y start..end."""
    return dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                               start_x=4, end_x=12, start_y=start_y,
                               end_y=end_y, max_bounce=2, anti_alias=False,
                               stratified_sampling=False, use_rr=False)


def load(directory, name, device="cpu"):
    return load_scene(os.path.join(SCENES, directory), name, device=device)


def shard_film(scene, cfg, key, n_spp, n_px, trace=None, cnt=None):
    """The film one render of an n_spp x n_px mesh adds (the mean over
    'spp', NaN zeroed, times n_spp), rebuilt from the single-process
    passes of every shard with sharding.py's shard keys
    fold_in(fold_in(key, spp_i), px_i). trace: a wavefront tracer
    (trace_pt, trace_vpt), or None for BDPT, whose t = 1 splat planes are
    summed over 'px' (no crop window). cnt: the pass's sample count
    (default n_spp: a renderer's first render). On the scene's device."""
    from adapt_tpu_torch.renderer.base import camera_rays
    from adapt_tpu_torch.renderer.bdpt import bdpt_pass_core
    cnt = n_spp if cnt is None else cnt
    shard_n = cfg.n_pixels // n_px
    groups = []
    for spp_i in range(n_spp):
        cols, splat = [], None
        for px_i in range(n_px):
            k = rng.fold_in(rng.fold_in(key, spp_i), px_i)
            pix = px_i * shard_n + torch.arange(shard_n, device=scene.device)
            if trace is None:
                loc, spl, _b, _c = bdpt_pass_core(scene, cfg, k, cnt,
                                                  pix_ids=pix)
                cols.append((loc, pix))
                splat = spl if splat is None else splat + spl
                continue
            k_cam, k_tr = rng.split(k)
            ro, rd = camera_rays(scene, cfg, k_cam, cnt, pix_ids=pix)
            cols.append(trace(scene, cfg, k_tr, ro, rd))
        if trace is None:
            cols = [loc + splat[pix] for loc, pix in cols]
        groups.append(torch.cat(cols))
    mean = groups[0] if n_spp == 1 else sum(groups[1:], groups[0]) / n_spp
    return torch.nan_to_num(mean, nan=0.0) * n_spp


def _save(rank, out, res):
    if rank == 0:
        np.savez(out, **{k: (v.numpy() if torch.is_tensor(v) else v)
                         for k, v in res.items()})


def pt_vpt_body(rank, world, device, out):
    """8 ranks: PT on an 8-way 'px' mesh, VPT on 2 x 4 (two renders), the
    PT crop on a 4-way 'px' mesh, and a checkpoint round trip on a 2 x 2
    mesh."""
    from adapt_tpu_torch.renderer.vpt import trace_vpt
    res = {}
    scene, cfg, _ = load("cbox", "cbox.xml", device)
    r = sharding.MultiChipRenderer(scene, small(cfg, 32, 2),
                                   sharding.make_mesh(8, spp_parallel=1),
                                   seed=3)
    res["pt"] = r.render().clone()
    vs, vcfg, _ = load("vpt", "cbox.xml", device)
    r = sharding.MultiChipRenderer(vs, small(vcfg, 16, 2),
                                   sharding.make_mesh(8, spp_parallel=2),
                                   trace_fn=trace_vpt, seed=1)
    r.render()
    res["vpt"] = r.render().clone()
    res["vpt_cnt"] = r.cnt
    mesh = sharding.make_mesh(4, spp_parallel=1)
    if mesh is not None:
        r = sharding.MultiChipRenderer(scene, crop(cfg), mesh, seed=3)
        res["crop_pt"] = r.render().clone()
    mesh = sharding.make_mesh(4, spp_parallel=2)
    if mesh is not None:
        c = small(cfg, 16, 2)
        r = sharding.MultiChipRenderer(scene, c, mesh, seed=9)
        r.render()
        chk = r.get_check_point()
        r.render()
        res["ck_straight"] = r.color.clone()
        r2 = sharding.MultiChipRenderer(scene, c, mesh, seed=0)
        r2.load_check_point(chk)
        r2.render()
        res["ck_resumed"] = r2.color.clone()
        res["ck_cnt"] = np.array([r.cnt, r2.cnt])
        try:
            sharding.MultiChipRenderer(scene, c, mesh, bdpt=True) \
                .load_check_point(chk)
            res["ck_refused"] = False
        except ValueError:
            res["ck_refused"] = True
    _save(rank, out, res)


def bdpt_body(rank, world, device, out):
    """4 ranks: BDPT on a 4-way 'px' mesh, the BDPT crop, transient BDPT
    on a 4-way 'spp' mesh (and its refusal of a 'px' mesh)."""
    res = {}
    bs, bcfg, _ = load("csphere", "single-ball.xml", device)
    bcfg = small(bcfg, 16, 3, world_scattering=False, medium_kinds=(),
                 has_null_bsdf=False)
    px4 = sharding.make_mesh(4, spp_parallel=1)
    r = sharding.MultiChipRenderer(bs, bcfg, px4, seed=5, bdpt=True)
    res["bdpt"] = r.render().clone()
    scene, cfg, _ = load("cbox", "cbox.xml", device)
    r = sharding.MultiChipRenderer(scene, crop(cfg), px4, seed=5, bdpt=True)
    res["crop_bdpt"] = r.render().clone()
    ts, tcfg, _ = load("trans", "cbox-point.xml", device)
    tcfg = dataclasses.replace(crop(tcfg, 4, 12), max_bounce=3)
    r = sharding.MultiChipRenderer(ts, tcfg,
                                   sharding.make_mesh(4, spp_parallel=4),
                                   seed=11, bdpt=True)
    r.render()
    res.update(tr_color=r.color / r.cnt, tr_bins=r.time_bins,
               tr_cnts=r.time_cnts, tr_cnt=r.cnt)
    try:
        sharding.MultiChipRenderer(ts, tcfg, px4, bdpt=True)
        res["tr_px_refused"] = False
    except ValueError:
        res["tr_px_refused"] = True
    _save(rank, out, res)


def test_rank_settings():
    """small() and crop() are tests/test_parallel.py's reductions: the
    field of view kept, no jitter, no Russian roulette, the crop window
    x 4..12 by y start..end of 16^2."""
    _, cfg, _ = load("cbox", "cbox.xml")
    c = small(cfg, 32, 2)
    assert (c.w, c.h, c.end_x, c.end_y, c.max_bounce) == (32, 32, 32, 32, 2)
    assert c.focal == cfg.focal * 32 / 512
    assert not (c.anti_alias or c.stratified_sampling or c.use_rr)
    k = crop(cfg)
    assert (k.w, k.start_x, k.end_x, k.start_y, k.end_y) == (16, 4, 12, 2,
                                                              14)
    assert k.max_bounce == 2 and not k.use_rr
