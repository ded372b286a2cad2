#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adapt_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs nvcc and g++ (the kernels build from csrc/, the BVH builder from
native/, all into build/adapt_tpu_torch/, started together) and one CUDA
device. Each phase prints one line; any failure ends the run with a
non-zero exit and no result line.

1. device: the card's name and power limit, the build times, knot290k's
   procedural mesh (scripts/gen_procedural.py `ensure`) and the knot290k
   scene's set-up time (parse, BVH build, upload);
2. kernels: each hand-written CUDA kernel against its plain PyTorch twin
   at 512^2 shapes (262,144 rays a batch): the brute-force pair on cbox
   (the closest hit also on a tie set, an all-dead set, far0 = 2e7 and
   sets four fifths dead, bit-equal; the any hit also on shadow rays four
   fifths dead, all dead, with far at each ray's closest hit t and one ULP
   either side, on rays that are all occluded and on the direct
   preview's shadow rays, bit-equal, with each set's device time, bound
   and plane / u / v tests a ray (`any_work`); the any hit also on every
   shadow-ray call of one PT pass of csphere/balls-multi.xml at 512^2
   (`recorded_rays`: 12 bounces x 4 shadow rays), bit-equal, with their
   occluded share and the first call's device time and bound; one call of
   each brute-force wrapper launches one kernel, and a 64^2 pass at 3
   bounces of balls-multi (PT) and of vpt/balls (VPT) launches under the
   profiler the kernels its wrappers count, one closest hit a bounce and
   one any hit or media walk a shadow ray),
   the BVH pair on knot290k (primary rays; bounce rays from the primary
   hits in seeded random directions with 15% dead lanes; shadow rays to
   the point light). Hit ids and occlusion exactly equal, t within rtol
   2e-6, u/v within rtol 2e-5 atol 2e-6 (same operation order: 0
   expected; the BVH closest hit bit-equal); times by CUDA events, median
   of 5 single calls, device times (a CUDA graph of 10 calls, no host
   time) and each kernel's bound; 2b also holds the BVH any hit on the
   queue-pick cleanup's own residual set of the shadow rays and on the
   adversarial set (`adversarial_rays`), with device times on shadow,
   bounce and residual rays, and gives both BVH kernels' registers,
   spills, blocks resident per SM and waves;
   2c: the media-walk kernel on the vpt cbox (NEE shadow rays from the
   primary hits to area-light samples at K = 2; bounce rays with 15% dead
   lanes at K = 2 and, every triangle an interface, at K = 7; and the
   scene with its null rows copied, exact duplicates and copies RAY_EPS
   behind, at and above the kernel's null-row cap, with rays aimed at the
   null triangles): every output exactly equal to the twin's, with each
   set's branch, the null-hit, overflow and blocker shares and the device
   time; 2d: the film-splat kernel on four
   512^2 streams of
   1,572,864 updates (the t=1 stream of one BDPT cbox pass at 6 bounces, a
   uniform one with 10% dropped, one whose first 1024-pixel tile holds
   70,000 updates, and the uniform one with 20,000 of its updates moved
   to one pixel), bit-equal to its plain version, with index_add_'s time
   beside it, single calls and device times; 2e: the five cluster kernels
   on knot290k (the all-cluster
   sweep's closest hit and any hit, the queue-pick schedule's front pass
   and its two pick passes on the picks the schedule itself derives):
   every output bit-equal to the plain version's, also the sweep kernels
   on a tie set (`tie_rays`: rays at shared vertices and edges, where
   neighbouring prims tie in t), the pick passes also on the tie set and
   the adversarial set (each with its own front pass, sort and picks) and
   on a forced set (every tile picks the cluster of most live rows, its
   rays aimed at that cluster's vertices and edges, N - 37 rays: every
   staged copy and a partial last tile), the front pass also on the tie
   set and the adversarial set, with the walk's box tests a ray (its
   plain twin `cluster_front_culled`, bit-equal too) beside the flat
   loop's, the sweep kernels also against the BVH kernels on the same
   rays (under 1e-4 of lanes may differ: the two prim
   tests round u and v in another order, so a ray grazing an edge may take
   the neighbour), with times (single calls and CUDA-graph device times)
   and bounds, the five kernels' registers, spills, residency and waves,
   and the sweeps' divergence factor
   (`cluster_kernels.warp_divergence`); 2f (checked first of the
   phase-2 kernels, before any CUDA graph, and timed after 2d): the two
   threefry kernels of csrc/rng.cu against their int64 twins
   (`rng.lane_uniform_plain`, `rng.uniform_plain`) on the card at the
   main path's draws, PT cbox's
   (262,144, 11) and the bunny's (640,000, 15) over permuted lane ids and
   the camera's (262,144, 2): bit-equal, one kernel a call by the
   profiler and by ops/_build.py's `launches`, times (single calls and
   CUDA-graph device times) of kernel and twin and the bound (bytes, or
   the integer ALU pipe's operations at INT_OPS); the JSON line's
   `launches` of the two kernels count the draws of the main paths of
   phases 4 and 14;
3. golden: render_pass_pt on the card at the settings of
   tests/test_goldens.py against tests/goldens/cbox_pt_48.npy; 3b: the
   same for render_pass_vpt against tests/goldens/vptcbox_48.npy; 3c: for
   render_pass_bdpt against tests/goldens/cbox_bdpt_48.npy; 3d: for
   render_pass_direct against tests/goldens/cbox_direct_48.npy (one
   closest hit, one any hit); 3e: for depth_prepass and render_pass_ssao
   against tests/goldens/cbox_ao_48.npy; 3f: render_pass_pt on
   csphere/balls-multi.xml and mix-balls.xml and render_pass_vpt on
   vpt/balls.xml at 48^2, 6 bounces, against csphere_multi_pt_48.npy,
   csphere_mix_pt_48.npy and vptballs_48.npy; 3g: render_pass_bdpt on
   the reduced bunny (bunny.xml with its four generated meshes swapped
   for the 495-face cornell/bunny.obj: its textures, glass, Fresnel blend,
   spot lights and HG world on the BVH tier) and render_pass_pt on cbox
   with a two-tone texture on its floor, 48^2, 3 bounces, against
   bunny_bdpt_48.npy and cbox_tex_pt_48.npy;
4. cbox main path: Renderer on cbox 512^2 at 8 bounces (bench.py's
   setting), render_batch of a few spp with the launch counts read around
   it (the threefry kernels: one lane_uniform a bounce and one uniform
   for the camera, each spp; the shading kernels: a shade_sample a
   bounce, a shade_eval and a shade_pdf a shadow ray, each spp); the
   image must be finite with mean > 0.05 and match the same render
   with the twins in place of the kernels under the goldens' bounds
   (the twins: every kernel's plain version, the shading arms' too);
5. knot290k main path: Renderer on knot290k.xml at its own settings (512^2,
   12 bounces, auto-compaction): the derived schedule, one warm-up spp,
   then render_batch of a few spp with 12 launches of each BVH kernel per
   spp and none of the brute-force ones; the image equal to the same
   render with no compaction, and at 64^2 (3 bounces) the render with
   the twins in place matches under the goldens' bounds;
6. vpt cbox main path: VolumeRenderer on scenes/vpt/cbox.xml at its own
   settings (512^2, 16 bounces, 24 iterations, schedule ((7, 2), (13, 8))):
   one warm-up spp, then render_batch of a few spp with one media-walk
   launch per iteration and shadow ray; the image equal to the same render
   with no compaction, and at 64^2 the render with the twins in place
   matches under the goldens' bounds;
7. BDPT main path: BDPT on cbox 512^2 at 6 bounces (the JAX package's
   bench row, scripts/bench_all.py:74-78): one warm-up spp, then
   render_batch of a few spp with the launch counts the code gives (12
   closest hits, 3 media walks and 1 film splat per spp); the image
   finite, and at 64^2 the render with the twins in place matches under
   the goldens' bounds;
8. transient BDPT: one render_pass_bdpt on scenes/trans/cbox-point.xml at
   its own settings (512^2, 12 bounces, 400 time bins): bins and counts of
   the right shape, finite, some counts; the any-hit and film-splat kernels
   launched, the media walk not;
9. cluster tier main paths: Renderer on knot290k.xml at its own settings
   (512^2, 12 bounces, auto-compaction) with `big_tier="sweep"` and with
   `big_tier="qpick"`: one warm-up spp, then render_batch of a few spp
   with the launch counts the code gives (sweep: 12 sweep closest hits and
   12 sweep any hits per spp and no BVH kernel; queue-pick: 24 front
   passes, 24 + 24 pick passes and 12 + 12 BVH cleanup walks per spp); each
   image against phase 5's BVH-tier image of the same seed: the mean under
   the goldens' bound, every pixel within 5e-2 but for at most 1e-4 of
   them, whose path took another prim at a grazed edge (`_check_tier`);
   ms/spp of each tier beside the BVH tier's;
10. direct preview and SSAO: DirectRenderer and SSAORenderer on cbox at
   512^2: the SSAO depth prepass (64 closest hits) timed with its
   renderer's set-up, one warm-up pass, then render_batch of a few passes
   with one closest hit (and, for the direct preview, one any hit) a
   pass; each image finite and under the goldens' bounds against the same
   render with the twins in place;
11. csphere PT: Renderer on csphere/balls-multi.xml at its own settings
   (512^2, 12 bounces, 4 shadow rays a bounce, RR and MIS; Blinn-Phong,
   lambertian, specular, modified-Phong and Fresnel-blend BRDFs, a
   det-refraction ball, a sphere area light): one warm-up spp, then
   render_batch of a few spp with 12 closest hits and 48 any hits per
   spp; the image finite (no NaN pixel) and, at 64^2, equal to the same
   render with the twins in place;
12. vpt balls: VolumeRenderer on vpt/balls.xml at its own settings (512^2,
   24 bounces, 4 shadow rays, a spot light, an HG world medium): one
   warm-up spp, then render_batch of a few spp with 24 closest hits and 96
   media walks per spp; the image finite and, at 64^2, equal to the same
   render with the twins in place;
13. bunny BDPT: BDPT on cbox/bunny.xml at its own settings (800^2, 10
   bounces, 65,290 triangles on the BVH tier, three spot lights, an HG
   world medium, three JPEG textures written by scripts/gen_procedural.py
   if missing): one warm-up spp, then render_batch of a few spp with 20
   BVH closest hits per spp from the walks, one more for each step of
   the media walk `_track_loop` (counted apart), one film splat and no
   brute-force kernel, the same counts by the profiler over one spp; the
   peak device memory; the BVH closest hit on the walks' own rays of one
   pass (the eye walk's primary rays, the light walk's first bounce),
   bit-equal to its twin, with device time and bound; the image finite,
   at 64^2 (3 bounces) under the goldens' bounds against the same render
   with the twins in place, and at 64^2 different from the render
   without textures on the textured floor;
14. bunny PT: Renderer on bunny.xml at its own settings (2 shadow rays,
   auto-compaction): 10 BVH closest hits and 20 BVH any hits per spp (by
   the wrappers and the profiler), 10 lane_uniform and 1 uniform threefry
   launches per spp, 10 shade_sample, 20 shade_eval and 20 shade_pdf
   launches per spp, peak memory, the BVH any hit on the
   first shadow rays of one pass, bit-equal to its twin, with device time
   and bound; the image finite, at 64^2 (3 bounces) equal to the twins'
   render, and different from the untextured one on the floor;
3h (after 3g): the grid-volume goldens on cuda: render_pass_vpt on
   cbox-volgrid.xml and cbox-rgbvol.xml at 64^2, 4 bounces, and
   render_pass_bdpt on cbox-volgrid.xml at 32^2, 3 bounces, against
   volgrid_vpt_64.npy, rgbvol_vpt_64.npy and volgrid_bdpt_32.npy (the
   `.vol` grids written where missing by adapt_tpu_torch/scene/assets.py
   `vol_assets`);
15. VPT cbox-rgbvol: VolumeRenderer on cbox-rgbvol.xml at its own
   settings (512^2, 32 bounces, 1 shadow ray, the tornado grid made RGB
   and rotated; the JAX package's bench row, scripts/bench_all.py:80-84):
   one warm-up spp, then render_batch of a few spp with one closest hit
   an iteration and one media walk a shadow ray, and every tracking call
   of the grid volume recorded (ops/volume_ops.py `record_marches`: march
   steps an spp, the share of lanes that cross the grid, the rounds, the
   march's share of the pass's wall time); one more spp under the
   profiler (device busy and idle share, kernels an spp, `device_work`);
   the peak memory; B1 on the first two closest-hit calls of a full-size
   pass (primary rays, the first bounce) and B3 on its first media walk
   (shadow rays), each bit-equal to its twin, with device time and bound;
   the image finite and, at 64^2, equal to the twins' render;
16. VPT cbox-volgrid: the same on cbox-volgrid.xml (640^2, 12 bounces, 2
   shadow rays, the mono plume grid);
17. BDPT cbox-volgrid: BDPT on cbox-volgrid.xml at 640^2 and the scene's
   12 bounces, one spp without a warm-up: the groups in the JAX package's
   scan form with their strategy counts (the 66 gen strategies, 7 chunks
   of 10: renderer/bdpt.py `scan_form`), 24 closest hits, a media walk
   (and a ratio tracking, a key a strategy in the scan form) for each
   chunk of the t1, s1 and gen groups, one film splat; the same numbers;
   at 64^2 (3 bounces) against the twins' render under the goldens'
   bounds, and again with every group in the scan form (FLAT_MAX_CHUNKS
   0: the closest hit, media walk and film splat under it);
18. PT ite-orb: Renderer on ite-orb.xml at its own settings (681x629, 24
   bounces, 480,004 triangles on the BVH tier; its meshes and two JPEG
   textures written by scripts/gen_procedural.py where missing,
   `orb_assets`): one warm-up spp (and the auto-compaction probe), then
   render_batch of a few spp with 24 BVH closest hits and 24 BVH any hits
   an spp; the same numbers; B5a on the primary rays and B5b on the
   first shadow rays of a full-size pass, each bit-equal to its twin,
   with device time and bound; at 64^2 (3 bounces) equal to the twins'
   render;
19. the CLI: `python -m adapt_tpu_torch.render` from the repository's
   root in three processes (PT on cbox for 4 passes; `-l` for 2 more,
   the checkpoint's count 6; VPT on cbox-volgrid.xml for 2 passes), each
   exiting 0 on cuda with its image and checkpoint written.
20. differentiable PT: autograd through `render_batch_pt` on cbox at
   512², 8 bounces, 2 spp, no Russian roulette or jitter, key 42
   (tests/test_grad.py's settings at the flagship's width): d mean
   radiance / d (albedo scale, emitter scale) within 2% of central
   differences (h 1e-2), g_emit == loss within 1e-5, the (O,3) mat_kd
   gradient finite, >= -1e-6, its largest entry within 3% of its central
   difference; B1 and B2 16 launches each in the forward, and the three
   shading kernels 16 each (inputs that need a gradient take them; the
   backward is the plain arms'), the profiler's
   counts of a forward and backward equal the wrappers'; forward and
   backward ms and peak memory; at 64^2 (3 bounces) the same gradients
   with the twins in place, within 1e-6 relative (1e-7 absolute for the
   table); 40 gradient steps recover an albedo scale of 0.7 within 0.02;
21. density-grid recovery (adapt_tpu_torch/recover_volume.py: 12^3,
   4,096 rays, DIFF_STEPS 64, 200 Adam steps at lr 0.15, key 11; the
   bounds of tests/test_grad_volume.py: interior mean error below 0.05 A,
   correlation above 0.99) and its finite-difference check at 256 rays;
22. multi-device: MultiChipRenderer (parallel/sharding.py) over NCCL with
   every visible card, one rank a card (`multi_rank`: PT cbox 512², VPT
   cbox-volgrid.xml, BDPT cbox at 6 bounces, one render each), each film
   equal to the single-process passes of its shards with the same keys;
   then two gloo ranks sharing the one card (CUDA tensors; NCCL refuses
   two ranks on one card) on a 1 x 2 'px' mesh (PT, BDPT: the splat sum
   and the gather) and a 2 x 1 'spp' mesh (VPT: the mean), equal the
   same way; then `python -m adapt_tpu_torch.render --multichip -1` on
   cbox PT, exiting 0 with its image;
23. the apps: `python -m adapt_tpu_torch.scene_viz` one-shot (direct,
   512²) with its <lookat> line, `--serve` answering one key and one
   frame, `python -m adapt_tpu_torch.post_processing` on phase 19's
   film;
24. PT on null BSDFs: Renderer on scenes/vpt/cbox.xml (a null-BSDF box of
   HG medium, which PT crosses as a delta of weight 1) at its own
   settings (512^2, 16 bounces, 1 shadow ray; the brute-force tier): one
   warm-up spp, then render_batch of 2 spp with 16 closest hits and 16
   any hits an spp; the image finite and not black, and at 64^2 equal to
   the twins' render; then `python -m adapt_tpu_torch.render --type pt`
   on trans/foam.xml (12 null-BSDF triangles under a collimated light,
   which gives nothing under PT with MIS) for one pass, its image
   written;
25. the shading kernels (csrc/shade.cu; `shade_phase`, which also runs
   alone: `python3 -c "import chip_smoke; chip_smoke.shade_phase()"`):
   the first `surface_sample`, `surface_eval` and `surface_pdf` call of
   one PT pass, recorded at their entry points, on cbox 512^2 (262,144
   lanes) and on bunny.xml 800^2 (640,000 lanes: textured k_d, glass, the
   Fresnel blend, 2 shadow rays): each call again through its entry
   point (one kernel launch) bit-equal to the plain version
   (`surface_*_plain`) on the same arguments, with the max abs
   difference; single-call ms of both, device ms (a CUDA graph of 10
   calls over copies of the arguments that together pass twice the L2,
   so that each call reads from HBM) and the byte bound at HBM_BPS of
   what each lane's arm reads and writes (`shade_bytes`). The JSON line's
   `launches` of the three kernels count the main paths' calls of phases
   4 and 14.
Each phase's line ends with its wall time in seconds.
Every phase that loads a textured scene fails unless each texture it
names loaded (`load_textured`), and every phase that loads a grid volume
unless the volume loaded (scene/assets.py `load_volume`): the loaders
only warn about a
missing file and render without it.

Then one JSON line of per-kernel numbers, the card line again, and the
result line {"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPP = 4            # cbox main-path samples per pixel (after one warm-up spp)
KNOT_SPP = 3       # knot290k main-path samples per pixel (after one warm-up)
VPT_SPP = 3        # vpt cbox main-path samples per pixel (after one warm-up)
BDPT_SPP = 3       # BDPT cbox main-path samples per pixel (after one warm-up)
PREVIEW_SPP = 5    # direct preview and SSAO passes (after one warm-up pass)
MULTI_SPP = 4      # csphere balls-multi PT samples per pixel (after a warm-up)
VBALLS_SPP = 2     # vpt balls samples per pixel (after one warm-up spp)
BUNNY_SPP = 2      # bunny BDPT samples per pixel (after one warm-up spp)
BUNNY_PT_SPP = 2   # bunny PT samples per pixel (after one warm-up spp)
RGBVOL_SPP = 2     # VPT cbox-rgbvol samples per pixel (after a warm-up spp)
VOLGRID_SPP = 2    # VPT cbox-volgrid samples per pixel (after a warm-up spp)
VOLGRID_BDPT_SPP = 1       # BDPT cbox-volgrid samples per pixel
VOLGRID_BDPT_BOUNCES = 12  # BDPT cbox-volgrid bounces (the scene's own)
ORB_SPP = 1        # PT ite-orb samples per pixel (after a warm-up spp)
NULL_SPP = 2       # PT vpt cbox (null BSDFs) samples per pixel (after one)
PROF_BOUNCES = 3   # bounces of phase 2a's profiled balls-multi and vpt passes
TWIN_BOUNCES = 3   # bounces of the 64^2 twin renders of the BVH-tier scenes
REPS = 5           # kernel timing repetitions (median)
# updates of phase 2d's one-pixel stream: 20 of the splat kernel's staged
# chunks (its plain version loops once per update of the longest segment)
HOT_UPDATES = 20000
TIE_RAYS = 65536   # rays of phase 2e's tie set (`tie_rays`)
# largest share of lanes on which a cluster sweep kernel may take another
# prim than the BVH kernel (the two round u and v in another order)
LANES_DIFFER = 1e-4
# largest share of pixels of a cluster-tier image that may lie 5e-2 or more
# from the BVH tier's (a path that took the neighbour prim at a grazed
# edge); 1.53e-5 and 3.81e-6 were measured on knot290k at 4 spp
PIXELS_DIFFER = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 operations/s outside
# the tensor cores; a kernel's bound is the larger of its two times
HBM_BPS = 3.35e12
F32_OPS = 67e12
# integer ALU-pipe operations/s: 64 a clock on each of 132 SMs at 1.98 GHz
INT_OPS = 16.7e12
# ALU-pipe operations of one threefry2x32 hash (csrc/rng.cu): its 20
# rotates (funnel shifts) and 20 xors, which only that pipe runs; the adds
# may issue on the FMA pipe (IMAD) and are not counted. And of turning a
# hash's two words into a float: xor, shift, or (the subtract is a float)
HASH_OPS = 40
FLOAT_OPS = 3
# operations of one (ray, triangle) test of csrc/tri_intersect.cu: six
# 3-term dots (5 each), the flat test, t, u, v and the five compares; of
# them the plane half (two dots, d - o.n, the flat test, the divide and the
# two compares of t) that B1 and B3 run on every row before u, and u
# before v (15 each: two dots, three operations, two compares)
TRI_PAIR_OPS = 47
TRI_PLANE_OPS = 17


def _split_ops(planes, us, vs):
    """Operations of the split test (csrc/tri_intersect.cu `row_hit`),
    the work a ray needs: the plane half
    (TRI_PLANE_OPS), u and v the rest in two equal parts."""
    return planes * TRI_PLANE_OPS + (us + vs) * (TRI_PAIR_OPS
                                                 - TRI_PLANE_OPS) / 2


KERNELS = {
    "tri_closest_hit": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                        "adapt_tpu/ops/intersect_pallas.py:58"),
    "tri_any_hit": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                    "adapt_tpu/ops/intersect_pallas.py:109"),
    "bvh_closest_hit": ("adapt_tpu_torch/csrc/bvh_intersect.cu",
                        "adapt_tpu/ops/cluster_pallas.py:647"),
    "bvh_any_hit": ("adapt_tpu_torch/csrc/bvh_intersect.cu",
                    "adapt_tpu/ops/cluster_pallas.py:766"),
    "tri_track_hits": ("adapt_tpu_torch/csrc/tri_intersect.cu",
                       "adapt_tpu/ops/intersect_pallas.py:131"),
    "splat_sorted_accumulate": ("adapt_tpu_torch/csrc/splat.cu",
                                "adapt_tpu/ops/splat_pallas.py:52"),
    "cluster_closest_hit": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                            "adapt_tpu/ops/cluster_pallas.py:513"),
    "cluster_any_hit": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                        "adapt_tpu/ops/cluster_pallas.py:600"),
    "cluster_front": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                      "adapt_tpu/ops/cluster_pallas.py:1515"),
    "cluster_pick_closest": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                             "adapt_tpu/ops/cluster_pallas.py:1385"),
    "cluster_pick_any": ("adapt_tpu_torch/csrc/cluster_intersect.cu",
                         "adapt_tpu/ops/cluster_pallas.py:1691"),
}


def _require(ok, what):
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def _shown(launches):
    """The kernels a run launched, for a phase's line."""
    return {k: n for k, n in launches.items() if n}


def _check(img, ref):
    """tests/test_goldens.py `_check`: mean within 1e-3 relative, every
    value within 5e-2. Returns (max abs diff, mean, reference mean)."""
    _require(img.shape == ref.shape, f"shape {img.shape} vs {ref.shape}")
    _require(abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3),
             f"mean {img.mean()} vs {ref.mean()}")
    err = float(abs(img - ref).max())
    _require(err < 5e-2, f"max abs diff {err}")
    return err, float(img.mean()), float(ref.mean())


def _check_tier(img, ref):
    """A cluster-tier image against the BVH tier's from the same seed: the
    mean within 1e-3 relative, as the goldens' `_check` holds it. The two
    tiers round u and v in another order, so a ray that grazes an edge may
    take another prim and its pixel another path: up to PIXELS_DIFFER of
    the pixels may lie beyond the goldens' 5e-2, every other pixel within
    it. Returns (largest difference of the pixels within 5e-2, share of
    pixels beyond it, largest difference)."""
    _require(img.shape == ref.shape, f"shape {img.shape} vs {ref.shape}")
    _require(abs(img.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3),
             f"mean {img.mean()} vs {ref.mean()}")
    diff = abs(img - ref).max(axis=-1)
    beyond = float((diff >= 5e-2).mean())
    _require(beyond <= PIXELS_DIFFER,
             f"{beyond} of the pixels differ by 5e-2 or more")
    return float(diff[diff < 5e-2].max()), beyond, float(diff.max())


def _time_ms(torch, fn, reps=REPS):
    """Median over reps of one call, by CUDA events, after a warm-up
    (none when reps == 1)."""
    if reps > 1:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(torch, fn, calls=10):
    """Device ms of one call: the median over 5 replays of a CUDA graph of
    `calls` calls (after two calls on a side stream), by CUDA events. The
    host's time to issue a call, which `_time_ms` includes, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _bound(nbytes, ops, peak=F32_OPS):
    """(least ms the card could take, what sets it); peak: the operations
    a second (INT_OPS for integer work)."""
    b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _ray_bytes(K, far):
    """Bytes of rays a brute-force kernel must read: origin, direction and
    far (28) of a walking lane (far > RAY_EPS), far alone (4) of a dead
    one, whose output depends on nothing else."""
    walking = int((far > K.RAY_EPS).sum())
    return walking * 28 + (far.shape[0] - walking) * 4


def _close(torch, got, want, far, name):
    """Kernel outputs (t, id, u, v, ...) against the twin's; returns the
    max abs difference of the floats."""
    t, ids, u, v = got[:4]
    wt, wids, wu, wv = want[:4]
    _require(torch.equal(ids, wids), f"{name}: hit ids differ from the twin")
    torch.testing.assert_close(t, wt, rtol=2e-6, atol=0.0)
    torch.testing.assert_close(u, wu, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(v, wv, rtol=2e-5, atol=2e-6)
    _require(bool((t[far < 0] == -3e38).all()),
             f"{name}: a dead lane did not come back with t = -3e38")
    _require(float((ids >= 0).float().mean()) > 0.2, f"{name}: few hits")
    return max(float((a - b).abs().max()) for a, b in
               ((t, wt), (u, wu), (v, wv)))


def tie_rays(torch, scene, n, seed, prims=None):
    """(ro, rd, dist): n rays at the vertices and edge midpoints of random
    triangles of the scene (of `prims`, triangle ids, when given), each
    from a point 0.05-1 away on either side, with the distance to its
    target. Neighbours that share the vertex or edge meet the ray at the
    same point, so their t tie exactly where they are coplanar (the two
    triangles of a wall) or round alike."""
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    tri = (torch.nonzero(~scene.prim_is_sphere).squeeze(1) if prims is None
           else prims)
    pick = tri[torch.randint(0, tri.numel(), (n,), generator=g, device=dev)]
    at = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.0],
                       [0.0, 0.5], [0.5, 0.5]], device=dev)[
        torch.randint(0, 6, (n,), generator=g, device=dev)]
    return _rays_at(torch, scene, pick, at, g)


def _rays_at(torch, scene, pick, at, g):
    """(ro, rd, dist): a ray at barycentric point `at` of each triangle
    `pick`, from a point 0.05-1 away on a random side, with the distance
    to its target."""
    n, dev = pick.shape[0], scene.device
    target = scene.pre2[pick] + at[:, :1] * scene.pre0[pick] \
        + at[:, 1:] * scene.pre1[pick]
    side = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0,
                       1.0)[:, None]
    jitter = torch.randn((n, 3), generator=g, device=dev)
    off = scene.prim_ng[pick] * side \
        + 0.5 * jitter / jitter.norm(dim=-1, keepdim=True)
    off = off / off.norm(dim=-1, keepdim=True)
    ro = target + off * (0.05 + 0.95 * torch.rand((n, 1), generator=g,
                                                  device=dev))
    to = target - ro
    dist = to.norm(dim=-1)
    return ro.contiguous(), (to / dist[:, None]).contiguous(), dist


def adversarial_rays(torch, scene, n, seed):
    """(ro, rd, far): n rays that probe the slab test's corners, in equal
    parts: origins inside cluster boxes (random points, and box centres)
    in random directions; axis-parallel directions (one to three zero
    components, so inv = +-1e9) from random points of the scene's box;
    origins on a cluster box's face with the direction in that face's
    plane (the face's slab difference is exactly 0). Far: 10% dead
    (-3e38), 10% in [0, RAY_EPS], 10% short (under 0.5), the rest 1e7; and
    one lane in 64 with a NaN in its origin or its direction."""
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    box = scene.cl_aabb[torch.randint(0, scene.n_clusters, (n,), generator=g,
                                      device=dev)]
    lo, hi = box[:, 0:3], box[:, 3:6]
    inside = lo + rand(n, 3) * (hi - lo)
    inside[: n // 8] = 0.5 * (lo + hi)[: n // 8]
    rd = torch.randn((n, 3), generator=g, device=dev)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    part = torch.arange(n, device=dev) % 3
    # axis-parallel: keep one axis, or two, or all three of a random
    # direction's components, the others exactly 0
    s_lo, s_hi = scene.cl_aabb[:, 0:3].amin(0), scene.cl_aabb[:, 3:6].amax(0)
    ro_ax = s_lo + rand(n, 3) * (s_hi - s_lo)
    keep = rand(n, 3) < 0.4
    keep[torch.arange(n, device=dev), torch.randint(
        0, 3, (n,), generator=g, device=dev)] = True
    d_ax = torch.where(keep, rd, 0.0)
    d_ax = d_ax / d_ax.norm(dim=-1, keepdim=True)
    # on a face: one coordinate set to the box's lo or hi, that component
    # of the direction 0
    axis = torch.randint(0, 3, (n,), generator=g, device=dev)
    on = torch.nn.functional.one_hot(axis, 3).bool()
    face = torch.where(rand(n, 1) < 0.5, lo, hi)
    ro_f = torch.where(on, face, inside)
    d_f = torch.where(on, 0.0, rd)
    d_f = d_f / d_f.norm(dim=-1, keepdim=True)
    ro = torch.where((part == 0)[:, None], inside,
                     torch.where((part == 1)[:, None], ro_ax, ro_f))
    rd = torch.where((part == 0)[:, None], rd,
                     torch.where((part == 1)[:, None], d_ax, d_f))
    u = rand(n)
    far = torch.where(u < 0.1, -3e38, torch.where(
        u < 0.2, 1e-4 * rand(n), torch.where(u < 0.3, 0.5 * rand(n), 1e7)))
    nan = torch.arange(n, device=dev) % 64 == 63
    which = torch.where(rand(n) < 0.5, 0, 1)
    ro = torch.where((nan & (which == 0))[:, None]
                     & (torch.arange(3, device=dev) == 1), float("nan"), ro)
    rd = torch.where((nan & (which == 1))[:, None]
                     & (torch.arange(3, device=dev) == 2), float("nan"), rd)
    return ro.contiguous(), rd.contiguous(), far.contiguous()


def cbox_rays(torch, scene, cfg, g):
    """Phase 2a's ray sets on cbox, {name: (ro, rd, far)}: "primary", the
    camera rays (far FAR); "bounce", from points 0.1-12 along them in
    seeded random directions, 15% dead lanes; "shadow", from the primary
    hits to the point light (the bounce set's dead lanes dead)."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import intersect_kernels as K
    from adapt_tpu_torch.renderer.base import camera_rays
    dev = scene.device
    ro, rd = camera_rays(scene, cfg, rng.split(rng.PRNGKey(0))[1], 1)
    ro = ro.contiguous()
    N = ro.shape[0]
    t_j = 0.1 + 11.9 * torch.rand((N, 1), generator=g, device=dev)
    bo = ro + rd * t_j
    bd = torch.randn((N, 3), generator=g, device=dev)
    bd = bd / bd.norm(dim=-1, keepdim=True)
    alive = torch.rand(N, generator=g, device=dev) > 0.15
    far_b = torch.where(alive, K.FAR, K.DEAD)
    far_p = torch.full((N,), K.FAR, device=dev)
    hit_t = K.tri_closest_hit_plain(scene, ro, rd, far_p)[0]
    so = ro + torch.where(hit_t < K.FAR, hit_t, 0.0)[:, None] * rd
    to_l = scene.emit_pos[0] - so
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None]
    far_s = torch.where(alive, dist - K.RAY_EPS, K.DEAD)
    return {"primary": (ro, rd, far_p), "bounce": (bo, bd, far_b),
            "shadow": (so, sd, far_s)}


def direct_rays(torch, scene, cfg):
    """The direct preview's shadow rays on this scene at cfg's size, (ro,
    rd, far): from each primary hit (a miss's point FAR out) to emitter 0,
    far its distance less RAY_EPS, as renderer/direct.py
    `render_pass_direct` makes them for its first pass of seed 0; the
    primary hits by the plain closest hit (no kernel launches)."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import intersect_kernels as K
    from adapt_tpu_torch.renderer.base import camera_rays
    from adapt_tpu_torch.renderer.direct import shadow_rays
    ro, rd = camera_rays(scene, cfg, rng.split(rng.PRNGKey(0))[1], 1)
    far_p = torch.full((ro.shape[0],), K.FAR, device=scene.device)
    t = K.tri_closest_hit_plain(scene, ro, rd, far_p)[0]
    hit_p, ld, dist = shadow_rays(scene, ro, rd, t)
    return hit_p.contiguous(), ld.contiguous(), K.far_bound(hit_p, dist)


def occluded_rays(torch, scene, n, seed):
    """(ro, rd, far): n rays at inner points of random triangles
    (barycentric coordinates 0.1-0.8 each, their sum at most 0.9), each
    from a point 0.05-1 away on either side (`_rays_at`), far 2: every
    ray is occluded, by its target if by nothing nearer."""
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    tri = torch.nonzero(~scene.prim_is_sphere).squeeze(1)
    pick = tri[torch.randint(0, tri.numel(), (n,), generator=g, device=dev)]
    at = 0.1 + 0.7 * torch.rand((n, 2), generator=g, device=dev)
    at = torch.where(at.sum(1, keepdim=True) > 0.9, 0.9 - at.flip(1), at)
    ro, rd, _dist = _rays_at(torch, scene, pick, at, g)
    return ro, rd, torch.full((n,), 2.0, device=dev)


def edge_sets(torch, K, scene, ro, rd, far):
    """{name: far} of the bound-edge sets: far at each ray's closest hit
    t (FAR bound) and one ULP either side; a ray without a hit keeps its
    far. Also the mask of the rays with a hit: none of them is occluded
    at t or below it (nothing lies strictly before the closest hit), all
    of them one ULP above."""
    t, row = K.tri_closest_hit_plain(scene, ro, rd,
                                     torch.full_like(far, K.FAR))[:2]
    hit = row >= 0
    return {"at t": torch.where(hit, t, far),
            "1 ulp above": torch.where(
                hit, torch.nextafter(t, torch.full_like(t, 3e38)), far),
            "1 ulp below": torch.where(
                hit, torch.nextafter(t, torch.zeros_like(t)), far)}, hit


def vpt_rays(torch, scene, cfg, g):
    """Phase 2c's ray sets on the vpt cbox, {name: (ro, rd, far)} from the
    primary hits: "shadow", NEE rays to area-light samples; "bounce",
    seeded random directions, 15% dead lanes."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import emitter_ops, intersect_kernels as K
    from adapt_tpu_torch.renderer.base import camera_rays
    dev = scene.device
    vro, vrd = camera_rays(scene, cfg, rng.split(rng.PRNGKey(2))[1], 1)
    vro = vro.contiguous()
    N = vro.shape[0]
    far_p = torch.full((N,), K.FAR, device=dev)
    v_t = K.tri_closest_hit_plain(scene, vro, vrd, far_p)[0]
    v_hit = v_t < K.FAR
    v_p = vro + torch.where(v_hit, v_t, 0.0)[:, None] * vrd
    e_pos = emitter_ops.sample_hit(
        scene, cfg, torch.zeros(N, dtype=torch.int32, device=dev), v_p,
        torch.rand((N, 3), generator=g, device=dev))[0]
    v_to = e_pos - v_p
    v_dist = v_to.norm(dim=-1)
    v_sd = v_to / v_dist[:, None]
    v_far_s = K.far_bound(v_p, v_dist, v_hit)
    v_bd = torch.randn((N, 3), generator=g, device=dev)
    v_bd = v_bd / v_bd.norm(dim=-1, keepdim=True)
    v_far_b = torch.where(
        v_hit & (torch.rand(N, generator=g, device=dev) > 0.15), K.FAR,
        K.DEAD)
    return {"shadow": (v_p, v_sd, v_far_s), "bounce": (v_p, v_bd, v_far_b)}


def _plane_tables(torch, K, scene, ro, rd):
    """(t, u, valid, ahead) of every (ray, triangle) pair from the plain
    version's tables: ahead where the row's plane is not flat and t >
    RAY_EPS (the plane half of the test passes)."""
    geo = scene.tri_geo
    t, u, _v, valid = K._hit_tables(geo, ro, rd)
    d_n = (rd[:, 0:1] * geo[:, 0] + rd[:, 1:2] * geo[:, 1]) \
        + rd[:, 2:3] * geo[:, 2]
    return t, u, valid, (t > K.RAY_EPS) & (d_n.abs() >= 1e-12)


def _halves(walk, ahead, bound, t, u):
    """(plane tests, u tests, v tests) of csrc/tri_intersect.cu's split
    test: a walking lane tests every row's plane; it computes u where the
    plane gives RAY_EPS < t < bound, and v where u lies in [0, 1]."""
    uh = walk[:, None] & ahead & (t < bound)
    return (int(walk.sum()) * t.shape[1], uh,
            int((uh & (u >= 0.0) & (u <= 1.0)).sum()))


def closest_work(torch, K, scene, ro, rd, far):
    """The work these rays need of a closest hit that splits the test:
    (plane tests, u tests, v tests, share of (warp, row) steps in which no
    lane of a warp of 32 consecutive rays needs the u half, the skips a
    warp vote could take). A lane walks where far > RAY_EPS; its bound is
    its running best, strict in row order, from min(FAR, far)."""
    t, u, valid, ahead = _plane_tables(torch, K, scene, ro, rd)
    tm = torch.where(valid, t, K.FAR)
    run = torch.cummin(tm, dim=1).values.clamp(max=K.FAR)
    before = torch.cat([torch.full_like(run[:, :1], K.FAR), run[:, :-1]], 1)
    planes, uh, vs = _halves(far > K.RAY_EPS, ahead,
                             torch.minimum(before, far[:, None]), t, u)
    n = ro.shape[0] // 32 * 32
    idle = 1.0 - float(uh[:n].view(n // 32, 32, -1).any(dim=1).float()
                       .mean())
    return planes, int(uh.sum()), vs, idle


def track_work(torch, K, scene, ro, rd, far, all_null=False):
    """The media-walk kernel's split tests on these rays below its null-row
    cap: (plane tests, u tests, v tests). A walking lane's (far > RAY_EPS)
    bound is, on a non-null row, its running blocker from min(FAR, far),
    on a null row the cut min(blocker, far)."""
    t, u, valid, ahead = _plane_tables(torch, K, scene, ro, rd)
    null = K.null_flags(scene, all_null)
    tm = torch.where(valid & ~null, t, K.FAR)
    run = torch.cummin(tm, dim=1).values.clamp(max=K.FAR)
    before = torch.cat([torch.full_like(run[:, :1], K.FAR), run[:, :-1]], 1)
    cut = torch.minimum(run[:, -1], far)[:, None]
    bound = torch.where(null, cut, torch.minimum(before, far[:, None]))
    planes, uh, vs = _halves(far > K.RAY_EPS, ahead, bound, t, u)
    return planes, int(uh.sum()), vs


def any_work(torch, K, scene, ro, rd, far):
    """The work these shadow rays need of an any hit that splits the test
    (csrc/tri_intersect.cu `row_occludes`): (plane tests, u tests, v
    tests). A walking lane (far > RAY_EPS) tests rows in order up to its
    first occluder; it computes u where the plane gives RAY_EPS < t < far,
    and v where u lies in [0, 1] as well."""
    t, u, valid, ahead = _plane_tables(torch, K, scene, ro, rd)
    T = t.shape[1]
    walk = far > K.RAY_EPS
    occ = valid & (t < far[:, None])
    first = torch.where(occ, torch.arange(T, device=t.device), T).amin(1)
    tested = walk[:, None] & (torch.arange(T, device=t.device)[None, :]
                              <= first[:, None])
    uh = tested & ahead & (t < far[:, None])
    return (int(tested.sum()), int(uh.sum()),
            int((uh & (u >= 0.0) & (u <= 1.0)).sum()))


def null_layers(torch, C, scene, dup, eps):
    """The scene with copies of its null rows appended: exact duplicates
    (the same t) of the first `dup` of them, then copies of the first
    `eps` moved RAY_EPS along their normal (an eps-layered interface), the
    triangle tables made anew."""
    from adapt_tpu_torch.ops.intersect_kernels import RAY_EPS
    rows = scene.tri_null_rows.long()
    fields = {}
    for name in ("tri_gid", "tri_obj", "tri_n", "tri_d", "tri_U", "tri_cu",
                 "tri_V", "tri_cv"):
        x = getattr(scene, name)
        shifted = x[rows[:eps]] + RAY_EPS if name == "tri_d" \
            else x[rows[:eps]]
        fields[name] = torch.cat([x, x[rows[:dup]], shifted]).contiguous()
    return C.replace_triangles(scene, **fields)


def recorded_rays(module, wrapper, run, first=None):
    """[(ro, rd, far, *the wrapper's further arguments)] of the calls of module.wrapper (its first `first`
    calls, or all) while run() runs, recorded around the wrapper (which
    runs the kernel: the counts are reset before each main path)."""
    calls, launch = [], getattr(module, wrapper)

    def record(s, o, d, far, *rest):
        if first is None or len(calls) < first:
            calls.append((o.clone(), d.clone(), far.clone(), *rest))
        return launch(s, o, d, far, *rest)
    setattr(module, wrapper, record)
    try:
        run()
    finally:
        setattr(module, wrapper, launch)
    return calls


def _small(cfg, w, **kw):
    """cfg at w x w pixels, the field of view kept."""
    return dataclasses.replace(cfg, w=w, h=w, focal=cfg.focal * w / 512,
                               end_x=w, end_y=w, **kw)


def kernels_in(torch, fn, warm=False):
    """The names of the CUDA kernels one call of fn launches, by
    torch.profiler: after a warm-up call, or, for an fn already `warm`
    (a full-size pass of ~65,000 launches), at once and tracing the card
    alone (fewer events to read)."""
    if not warm:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA] \
        + ([] if warm else [torch.profiler.ProfilerActivity.CPU])
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def device_work(torch, fn):
    """(device busy ms, kernels, the 3 kernels of most device time as
    [(name, ms, calls)]) of one call of fn, by torch.profiler tracing the
    card alone (profile_pt's accounting: the sum of the kernels'
    durations)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            ms, n = by.get(e.name, (0.0, 0))
            by[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:3]
    return (sum(ms for ms, _ in by.values()), sum(n for _, n in by.values()),
            [(name[:60], ms, n) for name, (ms, n) in top])


def _gen_procedural():
    """scripts/gen_procedural.py, loaded by path (it imports numpy only;
    its `ensure_all` also writes grid volumes through the JAX package,
    which this script never calls)."""
    spec = importlib.util.spec_from_file_location(
        "gen_procedural", os.path.join(ROOT, "scripts", "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def knot_mesh():
    """Write knot290k.xml's one procedural mesh if it is missing, with
    scripts/gen_procedural.py `ensure`."""
    with contextlib.redirect_stdout(io.StringIO()):
        _gen_procedural().ensure("knot290k.obj", 1450, 100)


# bunny.xml's generated stand-in meshes (scripts/gen_procedural.py
# `ensure_all`: path, n_u, n_v, torus-knot shape) and its textures
BUNNY_MESHES = (
    ("cornell/bunny_body.obj", 300, 24, dict(R=0.3, r=0.12, tube=0.06)),
    ("cornell/bunny_head.obj", 120, 12, dict(R=0.15, r=0.06, tube=0.035)),
    ("cornell/bunny_full1.obj", 400, 30, dict(R=0.35, r=0.12, tube=0.06)),
    ("cornell/bunny_full2.obj", 400, 30, dict(R=0.35, r=0.12, tube=0.06)))
BUNNY_TEXTURES = ("textures/crystal.jpg", "textures/lava.jpeg",
                  "textures/mat.jpeg")


def bunny_assets(meshes=True):
    """Write bunny.xml's JPEG textures (scripts/gen_procedural.py
    `ensure_texture`) and, with meshes, its four meshes (`ensure_at`),
    each only if it is missing."""
    gen = _gen_procedural()
    with contextlib.redirect_stdout(io.StringIO()):
        for rel, n_u, n_v, kw in BUNNY_MESHES if meshes else ():
            gen.ensure_at(rel, n_u, n_v, **kw)
        for rel in BUNNY_TEXTURES:
            gen.ensure_texture(rel)


ORB_TEXTURES = ("kitchen_textures/wood.jpg", "textures/crystal.jpg")


def orb_assets():
    """Write ite-orb.xml's meshes (six 80,000-triangle knots, a floor and
    an emitter: scripts/gen_procedural.py `ensure_orbs`) and its two JPEG
    textures (`ensure_texture`), each only if it is missing."""
    gen = _gen_procedural()
    with contextlib.redirect_stdout(io.StringIO()):
        gen.ensure_orbs()
        for rel in ORB_TEXTURES:
            gen.ensure_texture(rel)


def _scene_copy(directory, file, out_dir, edit):
    """Write directory/file to out_dir/scene.xml with every mesh and
    texture path made absolute (meshes resolve against the scene's
    directory, textures against the working directory, here the
    repository's root) after `edit(root)` changed the tree; returns
    (out_dir, "scene.xml")."""
    import xml.etree.ElementTree as xet
    tree = xet.parse(os.path.join(directory, file))
    root = tree.getroot()
    edit(root)
    for shape in root.findall("shape"):
        fn = shape.find("string")
        if fn is not None and not os.path.isabs(fn.get("value")):
            fn.set("value", os.path.normpath(
                os.path.join(directory, fn.get("value"))))
    for tex in root.findall("texture"):
        fn = tex.find("string")
        if fn is not None and not os.path.isabs(fn.get("value")):
            fn.set("value", os.path.normpath(
                os.path.join(ROOT, fn.get("value"))))
    os.makedirs(out_dir, exist_ok=True)
    tree.write(os.path.join(out_dir, "scene.xml"))
    return out_dir, "scene.xml"


def add_texture(root, tex_id, path, tag="albedo"):
    import xml.etree.ElementTree as xet
    te = xet.SubElement(root, "texture", {"id": tex_id, "type": "image",
                                          "tag": tag})
    xet.SubElement(te, "string", {"name": "filename", "value": path})


def ref_texture(shape, tex_id, tag=None):
    import xml.etree.ElementTree as xet
    xet.SubElement(shape, "ref", {"type": "texture", "id": tex_id,
                                  **({"tag": tag} if tag else {})})


def floor_shape(root):
    """The <shape> that reads cbox_floor.obj."""
    return next(s for s in root.findall("shape")
                if "cbox_floor" in s.find("string").get("value"))


def twotone_cbox(out_dir, suite="cbox", file="cbox.xml"):
    """A cbox scene (cbox/cbox.xml unless told another) with the two-tone
    64^2 image of tests/test_texture.py (red left, blue right) on its
    floor, written to out_dir (tests/goldens/cbox_tex_pt_48.npy renders
    it); returns (out_dir, "scene.xml")."""
    import numpy as np
    from PIL import Image
    tex = np.zeros((64, 64, 3), np.float32)
    tex[:, :32] = [1.0, 0.1, 0.1]
    tex[:, 32:] = [0.1, 0.1, 1.0]
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "twotone.png")
    Image.fromarray((tex * 255).astype(np.uint8)).save(png)

    def edit(root):
        add_texture(root, "twotone", png)
        ref_texture(floor_shape(root), "twotone")
    return _scene_copy(os.path.join(ROOT, "scenes", suite), file, out_dir,
                       edit)


def reduced_bunny(out_dir):
    """bunny.xml with its four generated meshes swapped for the tracked
    495-face cornell/bunny.obj (as tests/test_bvh.py does), written to
    out_dir (tests/goldens/bunny_bdpt_48.npy renders it); returns
    (out_dir, "scene.xml")."""
    def edit(root):
        for shape in root.findall("shape"):
            fn = shape.find("string")
            if "bunny_" in fn.get("value"):
                fn.set("value", "../meshes/cornell/bunny.obj")
    return _scene_copy(os.path.join(ROOT, "scenes", "cbox"), "bunny.xml",
                       out_dir, edit)


def floor_difference(torch, render, scene, untextured, cfg, rows):
    """Mean over the pixels whose primary ray hits one of the object rows
    `rows` (a textured floor) of the largest channel difference between
    render(scene, cfg) and render(untextured, cfg), two (n_pixels, 3)
    images in pixel order; fails unless the floor takes some 64 pixels
    and the difference is clearly nonzero."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops.intersect import ray_intersect
    from adapt_tpu_torch.renderer.base import camera_rays
    c = dataclasses.replace(cfg, anti_alias=False)
    hit = ray_intersect(scene, c, *camera_rays(scene, c, rng.PRNGKey(0),
                                               1)).obj_id
    floor = torch.isin(hit, torch.tensor(rows, dtype=hit.dtype,
                                         device=hit.device))
    _require(int(floor.sum()) > 64, f"{int(floor.sum())} floor pixels")
    diff = (render(scene, cfg) - render(untextured, cfg)).abs().amax(dim=-1)
    out = float(diff[floor].mean())
    _require(out > 1e-3, f"textured and untextured renders differ by "
             f"{out} on the floor")
    return out


def load_textured(directory, file, device="cuda"):
    """Load a scene that names textures, and fail unless every texture
    record it names loaded as an image (mode MODE_IMAGE, w, h > 0) and the
    albedo table is present: the loader of either package only warns
    about a missing file and renders without the texture. Texture paths
    in the XML are relative to the working directory (the repository's
    root). Returns (scene, cfg, {texture id: the object rows that carry
    it})."""
    from adapt_tpu_torch.parsers.xml_parser import scene_parsing
    from adapt_tpu_torch.scene import compile as C
    from adapt_tpu_torch.scene.texture import MODE_IMAGE
    parsed = scene_parsing(directory, file)
    rows = {}
    for i, obj in enumerate(parsed[2]):
        for rec in obj.texture_group.values():
            if rec is None:
                continue
            _require(rec.mode == MODE_IMAGE and rec.w > 0 and rec.h > 0,
                     f"{file}: texture {rec.id!r} did not load (mode "
                     f"{rec.mode}, {rec.w}x{rec.h})")
            rows.setdefault(rec.id, []).append(i)
    _require(rows, f"{file} names no texture")
    scene, cfg = C.compile_scene(*parsed, device=device)
    _require(scene.tex["albedo"].present,
             f"{file}: no albedo texture in the compiled scene")
    return scene, cfg, rows


def shade_calls(bxdf_ops, run):
    """{"sample" | "eval" | "pdf": (args, kwargs)} of the first call of
    each of bxdf_ops's surface_sample, surface_eval and surface_pdf while
    run() runs, recorded at those entry points."""
    calls, saved = {}, {}
    for name in ("sample", "eval", "pdf"):
        fn = saved[name] = getattr(bxdf_ops, "surface_" + name)

        def record(*a, _fn=fn, _name=name, **kw):
            calls.setdefault(_name, (a, kw))
            return _fn(*a, **kw)
        setattr(bxdf_ops, "surface_" + name, record)
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(bxdf_ops, "surface_" + name, fn)
    return calls


# the material rows each arm of csrc/shade.cu reads in each call (dc: k_d,
# or the albedo texel where the lane has one), by (is BSDF, tag)
SHADE_READS = {
    (False, 0): ("dc ks kg", "dc ks kg", ""),              # blinn-phong
    (False, 1): ("dc", "dc", ""),                          # lambertian
    (False, 2): ("", "dc", ""),                            # specular
    (False, 3): ("dc ks kg", "dc ks kg", "kg"),            # GGX
    (False, 4): ("dc ks kg", "dc ks kg mean", "dc ks mean"),  # mod. Phong
    (False, 5): ("dc ks kg", "dc ks kg", "kg"),            # Fresnel blend
    (False, 6): ("dc kg", "dc kg", ""),                    # Oren-Nayar
    (False, 7): ("dc ks kg", "dc ks kg", "kg"),            # thin coat
    (True, -1): ("", "", ""),                              # NULL
    (True, 0): ("dc ior", "dc ior", "ior"),                # det-refraction
    (True, 1): ("dc ior", "dc ior", "ior"),                # lambertian
}
SHADE_ROW = {"ks": 12, "kg": 12, "mean": 12, "ior": 4}


def shade_bytes(torch, name, mat, it):
    """Bytes a shading kernel call reads and writes, each once, counting
    for each lane only what its arm reads: kind and BSDF flag (5), the
    arriving ray (12), the call's own operand and outputs (eval: the
    scattered direction 12 and the throughput 12; sample: the 6 uniforms
    24, direction 12, throughput 12, pdf 4 and flag 1; pdf: the direction
    12 and the pdf 4), the shading normal (12, but for NULL lanes), the
    geometric normal (12, BRDF lanes in eval and sample: the hemisphere
    gate and the leak guard), and the arm's material rows (SHADE_READS:
    the albedo texel 12 where the scene is textured, then k_d 12 where the
    lane has no texel)."""
    col = ("eval", "sample", "pdf").index(name)
    own = {"eval": 24, "sample": 53, "pdf": 16}[name]
    kind, bsdf = mat.kind.long(), mat.is_bsdf
    per = torch.full(kind.shape, 5 + 12 + own, dtype=torch.int64,
                     device=kind.device)
    no_tex = torch.ones_like(bsdf) if it.tex is None else it.tex[:, 0] < 0
    for (is_bsdf, tag), reads in SHADE_READS.items():
        lane = (bsdf == is_bsdf) & (kind == tag)
        b = 12 * (tag != -1 or not is_bsdf)
        b += 12 * (not is_bsdf and name != "pdf")
        b += sum(SHADE_ROW[f] for f in reads[col].split() if f != "dc")
        add = torch.where(lane, b, 0)
        if "dc" in reads[col].split():
            add = add + torch.where(lane, 12 * no_tex.long()
                                    + 12 * (it.tex is not None), 0)
        per += add
    return int(per.sum())


def _copies(torch, x):
    """x with every tensor in it copied (dataclasses field by field)."""
    if torch.is_tensor(x):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _copies(torch, getattr(x, f.name))
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))
            or dataclasses.is_dataclass(getattr(x, f.name))})
    if isinstance(x, tuple):
        return tuple(_copies(torch, y) for y in x)
    return x


def _tensor_bytes(torch, x):
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return sum(_tensor_bytes(torch, getattr(x, f.name))
                   for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return sum(_tensor_bytes(torch, y) for y in x)
    return 0


L2_BYTES = 50 * 2 ** 20      # an H100's L2


def shade_phase(card=None):
    """Phase 25 (module docstring); returns {kernel name: (max abs
    difference, kernel ms, device ms, plain ms, bound)} of the bunny's
    calls, the difference over both scenes."""
    import torch
    sys.path.insert(0, ROOT)
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import _build, bxdf_ops, shade_kernels as SK
    from adapt_tpu_torch.renderer import pt
    from adapt_tpu_torch.scene import compile as C
    t_start = time.perf_counter()
    card = card or subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bunny_assets()
    cbox_dir = os.path.join(ROOT, "scenes", "cbox")
    scenes = [("cbox", *C.load_scene(cbox_dir, "cbox.xml", device="cuda")[:2])]
    bscene, bcfg, _rows = load_textured(cbox_dir, "bunny.xml")
    scenes.append(("bunny", bscene, bcfg))
    rows, out, errs = [], {}, {}
    for tag, scene, cfg in scenes:
        calls = shade_calls(bxdf_ops, lambda: pt.render_pass_pt(
            scene, cfg, rng.PRNGKey(5), 1))
        torch.cuda.synchronize()
        for name in ("sample", "eval", "pdf"):
            _require(name in calls, f"phase 25 {tag}: no surface_{name} "
                     "call in a pass")
            a, kw = calls[name]
            kernel = getattr(bxdf_ops, "surface_" + name)     # routed
            plain = getattr(bxdf_ops, "surface_" + name + "_plain")
            wrapper = "surface_" + name
            launched = _build.launches["shade_kernels"]
            before = launched[wrapper]
            got = kernel(*a, **kw)
            _require(launched[wrapper] == before + 1,
                     f"phase 25 {tag} surface_{name}: one launch a call")
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*a, **kw)
            want = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for g, w in zip(got, want, strict=True):
                _require(g.dtype == w.dtype and g.shape == w.shape,
                         f"phase 25 {tag} surface_{name}: shapes")
                if g.dtype == torch.bool:
                    err = max(err, float((g != w).sum()))
                    same = torch.equal(g, w)
                else:
                    both = torch.isnan(g) & torch.isnan(w)
                    err = max(err, float(torch.where(
                        both, 0.0, (g - w).abs()).max()))
                    same = torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                _require(same, f"phase 25 {tag} surface_{name}: the kernel "
                         f"is not bit-equal to the plain version (max abs "
                         f"difference {err})")
            kname = SK.kernel_names[wrapper]
            errs[kname] = max(errs.get(kname, 0.0), err)
            mat, it = a[1], a[2]
            n = mat.kind.shape[0]
            bound = _bound(shade_bytes(torch, name, mat, it), 0)
            k_ms = _time_ms(torch, lambda: kernel(*a, **kw))
            p_ms = _time_ms(torch, lambda: plain(*a, **kw))
            # copies that together pass twice the L2: a call's operands
            # were evicted by the calls between
            k = 1 + -(-2 * L2_BYTES // _tensor_bytes(torch, a))
            sets = [(a, kw)] + [_copies(torch, (a, kw)) for _ in range(k - 1)]
            turn = iter(range(10 ** 9))

            def rotating():
                a_, kw_ = sets[next(turn) % len(sets)]
                return kernel(*a_, **kw_)
            d_ms = _graph_ms(torch, rotating, calls=2 * k)
            del sets
            rows.append((tag, name, n, k_ms, d_ms, p_ms, bound, k))
            if tag == "bunny":
                out[kname] = (k_ms, d_ms, p_ms, bound)
    print("phase 25 shading kernels vs plain, the first calls of a PT "
          "pass, bit-equal: " + "; ".join(
              f"{tag} {name} ({n} lanes): kernel {k:.4f} ms, plain "
              f"{p:.4f} ms, device {d:.4f} ms over {c} copies, bound "
              f"{b[0]:.4f} ms ({b[1]}, {100 * b[0] / d:.1f}%)"
              for tag, name, n, k, d, p, b, c in rows)
          + " max abs difference " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" [{card}] ({time.perf_counter() - t_start:.1f} s)",
          flush=True)
    return {k: (errs[k], *v) for k, v in out.items()}


MULTI_CASES = ("pt", "vpt", "bdpt")   # phase 22's renders, in order


def multi_rank(rank, world, dev, out):
    """Phase 22's rank: one render of PT cbox (512^2, 8 bounces), VPT
    cbox-volgrid.xml (its own settings) and BDPT cbox (6 bounces) over
    MultiChipRenderer on this rank's card, seed 3. One rank: make_mesh()
    over the whole world. Two ranks (sharing the card): PT and BDPT on a
    1 x 2 'px' mesh, VPT on a 2 x 1 'spp' mesh. First one all_reduce
    and one all_gather over the world on the card (with one rank the
    mesh needs no collective; this one runs the backend). Each rank
    writes its films, seconds, launch counts and backend to
    out/rank<rank>.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    # _build counts the launches of the kernel modules imported: these
    # are the ones whose counts the ranks write
    from adapt_tpu_torch.ops import (  # noqa: F401
        _build, bvh_kernels, intersect_kernels, splat)
    from adapt_tpu_torch.parallel import sharding as SH
    from adapt_tpu_torch.renderer.vpt import trace_vpt
    from adapt_tpu_torch.scene import compile as C
    from adapt_tpu_torch.scene.assets import load_volume
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    parts = [torch.empty(1, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((1,), float(rank), device=dev))
    _require(bool((x == world * (world + 1) / 2).all())
             and [float(p_) for p_ in parts] == list(map(float,
                                                         range(world))),
             f"rank {rank}: {dist.get_backend()} all_reduce {x.tolist()}, "
             f"all_gather {[float(p_) for p_ in parts]}")
    cbox = os.path.join(ROOT, "scenes", "cbox")
    scene, cfg0, _ = C.load_scene(cbox, "cbox.xml", device=dev)
    vs, vcfg, _ = load_volume(cbox, "cbox-volgrid.xml", device=dev)
    cases = {"pt": (scene, dataclasses.replace(cfg0, max_bounce=8), {}, 1),
             "vpt": (vs, vcfg, {"trace_fn": trace_vpt}, world),
             "bdpt": (scene, dataclasses.replace(cfg0, max_bounce=6),
                      {"bdpt": True}, 1)}
    res = {}
    for name in MULTI_CASES:
        sc, cfg, kw, spp_par = cases[name]
        mesh = SH.make_mesh(world, spp_parallel=spp_par)
        r = SH.MultiChipRenderer(sc, cfg, mesh, seed=3, **kw)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = r.render()
        torch.cuda.synchronize()
        res[name] = film.cpu().numpy()
        res[name + "_s"] = time.perf_counter() - t0
        for k, n in _launches("intersect_kernels", "bvh_kernels",
                              "splat").items():
            res[f"{name}:{k}"] = n
        res[name + "_mesh"] = np.array([mesh.shape["spp"], mesh.shape["px"]])
    res["backend"] = dist.get_backend()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _launches(*modules):
    """The launch counts of the kernel modules named, in one dict (a copy
    of ops/_build.py's `launches`)."""
    from adapt_tpu_torch.ops import _build
    out = {}
    for m in modules:
        out.update(_build.launches[m])
    return out


def residual_rays(scene, ro, rd, far):
    """Queue-pick's cleanup set of an any-hit batch (ops/cluster_kernels.py
    `qpick_any`): the sorted rays, far kept on the residual lanes and -3e38
    on the others."""
    import torch
    from adapt_tpu_torch.ops import cluster_kernels as CK
    from adapt_tpu_torch.ops.intersect_kernels import DEAD
    C = scene.n_clusters
    _perm, qro, qrd, qfar, cid, nxt = CK._front_sort(scene, ro, rd, far)
    picks, covered = CK.tile_picks(cid, C, CK.QP_P)
    occ = torch.zeros_like(covered)
    for p in range(CK.QP_P):
        occ |= CK.cluster_pick_any(scene, qro, qrd, qfar, picks[p])
    res = (cid < C) & ~occ & (~covered | (nxt < CK.BIG))
    return qro, qrd, torch.where(res, qfar, DEAD)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import numpy as np
    from adapt_tpu_torch import native, rng
    from adapt_tpu_torch.ops import _build, bvh, bvh_kernels as BK
    from adapt_tpu_torch.ops import cluster_kernels as CK
    from adapt_tpu_torch.ops import intersect_kernels as K
    from adapt_tpu_torch.ops import shade_kernels as SK
    from adapt_tpu_torch.ops import splat as S
    from adapt_tpu_torch.ops import volume_ops as V
    from adapt_tpu_torch.ops.intersect import DEAD
    from adapt_tpu_torch.parsers.xml_parser import scene_parsing
    from adapt_tpu_torch.renderer import bdpt as B, direct, pt, ssao, vpt
    from adapt_tpu_torch.renderer.base import camera_rays
    from adapt_tpu_torch.scene import compile as C
    from adapt_tpu_torch.scene.assets import load_volume, vol_assets
    said = [time.perf_counter()]

    def say(line):
        """A phase's line, with the seconds since the previous one."""
        now = time.perf_counter()
        print(f"{line} ({now - said[0]:.1f} s)", flush=True)
        said[0] = now

    reset = _build.reset_launches

    def counts():
        return _launches("intersect_kernels", "bvh_kernels", "splat",
                         "cluster_kernels")

    def shade_want(c, spp):
        """The shading kernels' launches in spp PT samples: a sample a
        bounce, an eval and (with MIS) a pdf a shadow ray."""
        per = spp * c.max_bounce
        return {"surface_sample": per,
                "surface_eval": per * c.num_shadow_ray,
                "surface_pdf": per * c.num_shadow_ray * int(c.use_mis)}

    none = {k: 0 for k in KERNELS}
    # each wrapper's kernel, by the name the profiler gives it
    profiled = {**K.kernel_names, **BK.kernel_names, **S.kernel_names}

    def profiled_launches(fn, what, warm=False, tries=3):
        """(launches of each kernel in one call of fn by torch.profiler
        (`kernels_in`), calls profiled). They must equal the wrappers'
        counts of that call. The profiler may miss a kernel's record (on
        an H100 it once saw 9 of a full-size bunny PT pass's 10 BVH
        closest hits, among ~21,500 kernels): a call it saw short of the
        wrappers' counts is profiled again, up to `tries` calls; it may
        never see a launch the wrappers did not count."""
        for call in range(1, tries + 1):
            reset()
            names = kernels_in(torch, fn, warm)
            wrapped = {k: n // (1 if warm else 2)   # and a warm-up call
                       for k, n in _shown(counts()).items()}
            seen = _shown({k: sum(kname in n for n in names)
                           for k, kname in profiled.items()})
            _require(all(n <= wrapped.get(k, 0) for k, n in seen.items())
                     and (seen == wrapped or call < tries),
                     f"{what}: the profiler saw {seen} launches, the "
                     f"wrappers counted {wrapped} (call {call})")
            if seen == wrapped:
                return seen, call

    # ---- 1. device, builds, assets, set-up ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        for f in [ex.submit(fn) for fn in (
                *(lib.entries for lib in _build.libraries.values()),
                native._lib)]:
            f.result()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    knot_mesh()
    gen_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cbox_dir = os.path.join(ROOT, "scenes", "cbox")
    t0 = time.perf_counter()
    parsed = scene_parsing(cbox_dir, "knot290k.xml")
    parse_s = time.perf_counter() - t0
    bvh_s = []
    build_bvh = C.bvh_build

    def timed_build(aabbs):
        t = time.perf_counter()
        out = build_bvh(aabbs)
        bvh_s.append(time.perf_counter() - t)
        return out
    C.bvh_build = timed_build
    t0 = time.perf_counter()
    kscene, kcfg = C.compile_scene(*parsed, device="cpu")
    compile_s = time.perf_counter() - t0
    C.bvh_build = build_bvh
    t0 = time.perf_counter()
    kscene = kscene.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    _require(kscene.n_prims == 290010 and kcfg.max_bounce == 12
             and (kcfg.w, kcfg.h) == (512, 512), "knot290k settings")
    say(f"phase 1 device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | builds started together, all done in "
        f"{build_s:.2f} s {_build.build_seconds} | knot mesh {gen_s:.2f} s | "
        f"knot290k set-up: parse {parse_s:.2f} s, compile {compile_s:.2f} "
        f"s of which BVH build {bvh_s[0]:.2f} s "
        f"({kscene.bvh_node_pack.shape[0]} nodes), upload {upload_s:.3f} "
        f"s")

    # ---- 2f. threefry kernels against their twins, at the main path's
    # draws: checked and counted first of the phase-2 kernels (the
    # profiler's count of a call's kernels comes before any CUDA graph: it
    # misses kernels after one), timed on graphs after phase 2d ----
    rkey = rng.fold_in(rng.PRNGKey(7), 3)
    rg = torch.Generator(device=dev).manual_seed(5)
    draws = []
    for tag, n, D in (("cbox", 262144, 11), ("bunny", 640000, 15)):
        # compacted lanes: original ids in no order
        p = torch.randperm(n, generator=rg, device=dev).to(torch.int32)
        draws.append((f"{tag} lane_uniform ({n}, {D})", "lane_uniform",
                      lambda p=p, D=D: rng.lane_uniform(rkey, p, D),
                      lambda p=p, D=D: rng.lane_uniform_plain(rkey, p, D),
                      n * (D + 1), n * D, 4 * n * (D + 1)))
    draws.append(("camera uniform (262144, 2)", "uniform",
                  lambda: rng.uniform(rkey, (262144, 2), device=dev),
                  lambda: rng.uniform_plain(rkey, (262144, 2), device=dev),
                  2 * 262144, 2 * 262144, 4 * 2 * 262144))
    rng_seen, rng_err = [], {}
    for tag, wrapper, fn, plain, *_work in draws:
        before = _build.launches["rng"][wrapper]
        got, want = fn(), plain()
        _require(_build.launches["rng"][wrapper] == before + 1,
                 f"{tag}: the wrapper did not count one launch")
        err = (got - want).abs().max().item()
        _require(got.dtype == torch.float32 and torch.equal(got, want),
                 f"{tag}: the kernel is not bit-equal to the twin (max abs "
                 f"diff {err})")
        rng_err[wrapper] = max(rng_err.get(wrapper, 0.0), err)
        for call in range(1, 4):
            names = kernels_in(torch, fn)
            if len(names) == 1 and names[0].removeprefix("void ") \
                    .startswith(rng.kernel_names[wrapper]):
                break
            _require(len(names) == 0 and call < 3,
                     f"{tag}: one call launched {names}")
        rng_seen.append(len(names))

    # ---- 2a. brute-force kernels against their twins, cbox 512^2 ----
    scene, cfg0, _ = C.load_scene(cbox_dir, "cbox.xml")
    cfg = dataclasses.replace(cfg0, max_bounce=8)        # bench.py:35
    g = torch.Generator(device=dev).manual_seed(0)
    rays = cbox_rays(torch, scene, cfg, g)
    (ro, rd, far_p), (bo, bd, far_b), (so, sd, far_s) = (
        rays["primary"], rays["bounce"], rays["shadow"])
    N = ro.shape[0]
    tro, trd, _tdist = tie_rays(torch, scene, N, 3)
    # B1 bit-equal also where rays tie at shared vertices and edges, where
    # every lane is dead, and with far0 = 2e7 > FAR (a ray with no valid
    # row then "hits" the first row whose t is FAR, with that row's u, v)
    # and with four fifths of the lanes dead, where the kernel splits a
    # ray's rows over several threads
    sparse = torch.rand(N, generator=torch.Generator(device=dev)
                        .manual_seed(4), device=dev) < 0.8
    far_sparse = torch.where(sparse, DEAD, K.FAR)
    b1_sets = {"primary": (ro, rd, far_p), "bounce": (bo, bd, far_b),
               "tie": (tro, trd, torch.full_like(far_p, K.FAR)),
               "all dead": (bo, bd, torch.full_like(far_b, DEAD)),
               "far0 2e7": (bo, bd, torch.where(far_b > 0, 2e7, DEAD)),
               "tie 80% dead": (tro, trd, far_sparse),
               "far0 2e7 80% dead": (bo, bd, torch.where(sparse, DEAD,
                                                         2e7))}
    errs = {k: 0.0 for k in KERNELS}
    b1_work, b1_seen = {}, {}
    for tag, (o, d, far) in b1_sets.items():
        got = K.tri_closest_hit(scene, o, d, far)
        want = K.tri_closest_hit_plain(scene, o, d, far)
        _require(all(a.dtype == b.dtype and torch.equal(a, b)
                     for a, b in zip(got, want)),
                 f"tri_closest_hit ({tag} rays): not bit-equal to the twin")
        if tag in ("primary", "bounce"):
            errs["tri_closest_hit"] = max(errs["tri_closest_hit"], _close(
                torch, got, want, far, "tri_closest_hit"))
        b1_work[tag] = closest_work(torch, K, scene, o, d, far)
        b1_seen[tag] = (float((got[1] >= 0).float().mean()),
                        int(((got[1] >= 0) & (got[0] == K.FAR)).sum()))
    tie_t, _u, tie_valid, _ahead = _plane_tables(torch, K, scene, tro, trd)
    tm = torch.where(tie_valid, tie_t, K.FAR)
    tie_n = int(((tm == tm.amin(1, keepdim=True)) & tie_valid).sum(1)
                .ge(2).sum())
    _require(tie_n > 0, "no tie-set ray ties in t")
    _require(b1_seen["all dead"][0] == 0.0, "an all-dead lane hit")
    _require(b1_seen["far0 2e7"][1] > 0, "no far0 2e7 ray took the FAR row")
    # B2 bit-equal on the shadow and bounce rays and on harder sets: four
    # fifths dead (2-8 threads a ray), all dead, far at the closest hit's
    # t and one ULP either side, every ray occluded (whole warps leave
    # early), the direct preview's shadow rays
    edges, edge_hit = edge_sets(torch, K, scene, so, sd, far_s)
    b2_sets = {"shadow": (so, sd, far_s), "bounce": (bo, bd, far_b),
               "shadow 80% dead": (so, sd, torch.where(sparse, DEAD,
                                                       far_s)),
               "all dead": (so, sd, torch.full_like(far_s, DEAD)),
               **{f"edge {k}": (so, sd, f) for k, f in edges.items()},
               "all occluded": occluded_rays(torch, scene, N, 6),
               "direct": direct_rays(torch, scene, cfg0)}
    b2_seen = {}
    for tag, (o, d, far) in b2_sets.items():
        occ = K.tri_any_hit(scene, o, d, far)
        _require(torch.equal(occ, K.tri_any_hit_plain(scene, o, d, far)),
                 f"tri_any_hit ({tag} rays): occlusion differs from the "
                 "twin")
        _require(not bool(occ[far <= K.RAY_EPS].any()),
                 f"tri_any_hit ({tag} rays): a dead lane is occluded")
        b2_seen[tag] = float(occ.float().mean())
    _require(b2_seen["shadow"] > 0, "no shadow ray was occluded")
    _require(b2_seen["all occluded"] == 1.0, "an aimed ray was not occluded")
    for k in edges:
        occ = K.tri_any_hit(scene, so, sd, b2_sets[f"edge {k}"][2])[edge_hit]
        _require(bool(occ.all()) if k == "1 ulp above"
                 else not bool(occ.any()),
                 f"tri_any_hit (edge {k}): wrong side of the closest hit")
    # one call, one kernel: the wrappers read the scene's tables (before
    # any CUDA graph is captured: the profiler misses kernels after one)
    vscene, vcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "vpt"),
                                   "cbox.xml")
    one_call = {
        "tri_closest_hit": kernels_in(
            torch, lambda: K.tri_closest_hit(scene, bo, bd, far_b)),
        "tri_any_hit": kernels_in(
            torch, lambda: K.tri_any_hit(scene, so, sd, far_s)),
        "tri_track_hits": kernels_in(
            torch, lambda: K.tri_track_hits(vscene, bo, bd, far_b, 2))}
    for k, names in one_call.items():
        _require(len(names) == 1 and k.split("_")[1] in names[0],
                 f"{k}: one call launched {names}")
    # the slice's PT and VPT paths: a 64^2 pass of each at 3 bounces
    # launches, by the profiler (before any CUDA graph), the kernels its
    # wrappers count (kernels_in runs the pass twice; reading the events of
    # a full-depth pass, ~350,000 of them, took ~20 s a pass)
    mscene, mcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "csphere"),
                                   "balls-multi.xml")
    vbscene, vbcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "vpt"),
                                     "balls.xml")
    _require((mcfg.max_bounce, mcfg.num_shadow_ray, mscene.tri_n.shape[0],
              mscene.sph_center.shape[0]) == (12, 4, 12, 6)
             and (vbcfg.max_bounce, vbcfg.num_shadow_ray) == (24, 4),
             "balls-multi / vpt balls settings")
    path_prof = {}
    for tag, fn in (
            ("balls-multi PT", lambda: pt.render_pass_pt(
                mscene, _small(mcfg, 64, max_bounce=PROF_BOUNCES),
                rng.PRNGKey(0), 1)),
            ("vpt balls VPT", lambda: vpt.render_pass_vpt(
                vbscene, _small(vbcfg, 64, max_bounce=PROF_BOUNCES),
                rng.PRNGKey(0), 1))):
        path_prof[tag], _ = profiled_launches(fn, tag)
    # one closest hit a bounce, one any hit (PT) or media walk (VPT) a
    # shadow ray
    _require(path_prof["balls-multi PT"] == {"tri_closest_hit": 3,
                                             "tri_any_hit": 12}
             and path_prof["vpt balls VPT"] == {"tri_closest_hit": 3,
                                                "tri_track_hits": 12},
             f"launches a pass {path_prof}")
    # B2 bit-equal on every shadow-ray call of a 512^2 balls-multi PT pass
    m_calls = recorded_rays(K, "tri_any_hit", lambda: pt.render_pass_pt(
        mscene, mcfg, rng.PRNGKey(0), 1))
    _require(len(m_calls) == mcfg.max_bounce * mcfg.num_shadow_ray,
             f"{len(m_calls)} any-hit calls in a balls-multi pass")
    m_occ = m_walk = 0
    for i, (o, d, far) in enumerate(m_calls):
        occ = K.tri_any_hit(mscene, o, d, far)
        _require(torch.equal(occ, K.tri_any_hit_plain(mscene, o, d, far)),
                 f"tri_any_hit (balls-multi call {i}): occlusion differs "
                 "from the twin")
        m_occ += int(occ.sum())
        m_walk += int((far > K.RAY_EPS).sum())
    times = {
        "tri_closest_hit": (
            _time_ms(torch, lambda: K.tri_closest_hit(scene, bo, bd, far_b)),
            _time_ms(torch, lambda: K.tri_closest_hit_plain(scene, bo, bd,
                                                            far_b))),
        "tri_any_hit": (
            _time_ms(torch, lambda: K.tri_any_hit(scene, so, sd, far_s)),
            _time_ms(torch, lambda: K.tri_any_hit_plain(scene, so, sd,
                                                        far_s)))}
    # bounds: rays and far read once (a dead lane's output needs its far
    # alone), the tables read once, outputs written once; the closest
    # hit's operations are the plane half of every live pair
    # and the u/v half where the row can win (`closest_work`), the any
    # hit's each ray's rows up to its first occluder (what these rays need)
    T = scene.tri_n.shape[0]

    def b2_bound(o, d, far):
        return _bound(_ray_bytes(K, far) + T * 48 + far.shape[0],
                      _split_ops(*any_work(torch, K, scene, o, d, far)))

    bounds = {
        "tri_closest_hit": _bound(_ray_bytes(K, far_b) + T * 64 + N * 32,
                                  _split_ops(*b1_work["bounce"][:3])),
        "tri_any_hit": b2_bound(so, sd, far_s)}
    device = {
        "tri_closest_hit": _graph_ms(
            torch, lambda: K.tri_closest_hit(scene, bo, bd, far_b)),
        "tri_any_hit": _graph_ms(
            torch, lambda: K.tri_any_hit(scene, so, sd, far_s))}
    b1_primary_dev = _graph_ms(
        torch, lambda: K.tri_closest_hit(scene, ro, rd, far_p))
    tinfo, null_cap = K.kernel_info(N)
    _require(null_cap == K.NULL_CAP, f"the media walk's null-row cap is "
             f"{null_cap} in the build, {K.NULL_CAP} in its wrapper")
    b1_sparse_dev = _graph_ms(
        torch, lambda: K.tri_closest_hit(scene, bo, bd, far_sparse))
    # B2 on each set: device ms (kernel only), bound, plane / u / v tests
    # a walking ray
    b2_rows = {}
    for tag, (o, d, far) in b2_sets.items():
        walking = max(int((far > K.RAY_EPS).sum()), 1)
        b2_rows[tag] = (
            _graph_ms(torch, lambda o=o, d=d, far=far:
                      K.tri_any_hit(scene, o, d, far)),
            b2_bound(o, d, far),
            [x / walking for x in any_work(torch, K, scene, o, d, far)])
    mo, md, mfar = m_calls[0]               # bounce 0, shadow ray 0
    m_walking = max(int((mfar > K.RAY_EPS).sum()), 1)
    m_row = (_graph_ms(torch, lambda: K.tri_any_hit(mscene, mo, md, mfar)),
             _bound(_ray_bytes(K, mfar) + mscene.tri_n.shape[0] * 48
                    + mfar.shape[0],
                    _split_ops(*any_work(torch, K, mscene, mo, md, mfar))),
             [x / m_walking for x in any_work(torch, K, mscene, mo, md,
                                               mfar)])
    say("phase 2a brute-force kernels vs twins, cbox, %d rays: " % N
        + "; ".join(f"{k} exact ids, max abs err {errs[k]:.3g}, kernel "
                    f"{t:.4f} ms (device, kernel only {device[k]:.4f}), "
                    f"twin {p:.4f} ms, bound {bounds[k][0]:.4f} ms "
                    f"({bounds[k][1]})"
                    for k, (t, p) in times.items())
        + f" | B1 device on primary rays {b1_primary_dev:.4f} ms, on bounce"
        f" rays four fifths dead {b1_sparse_dev:.4f} ms | B1 "
        "bit-equal on every set (hit share, FAR-row hits; plane, u and v "
        "tests a ray, share of (warp, row) steps with no lane on the u "
        "half): " + ", ".join(
            f"{tag} {h:.4f}, {fr}; {p / N:.2f}, {u / N:.2f}, {v / N:.2f}, "
            f"{idle:.4f}" for tag, ((h, fr), (p, u, v, idle)) in
            ((t_, (b1_seen[t_], b1_work[t_])) for t_ in b1_sets))
        + f"; {tie_n} tie-set rays tie in t | B2 bit-equal on every set "
        "(occluded share; device ms, kernel only; bound ms; plane, u and v "
        "tests a walking ray): " + ", ".join(
            f"{tag} {b2_seen[tag]:.4f}; {dv:.4f}; {bd_[0]:.4f} "
            f"({bd_[1]}); {w[0]:.2f}, {w[1]:.2f}, {w[2]:.2f}"
            for tag, (dv, bd_, w) in b2_rows.items())
        + f" | B2 bit-equal on the {len(m_calls)} shadow-ray calls of a "
        f"{mcfg.w}x{mcfg.h} balls-multi PT pass: occluded share of the "
        f"walking rays {m_occ / max(m_walk, 1):.4f}; first call "
        f"{m_walking / N:.4f} walking, device {m_row[0]:.4f} ms, bound "
        f"{m_row[1][0]:.4f} ({m_row[1][1]}), {m_row[2][0]:.2f}, "
        f"{m_row[2][1]:.2f}, {m_row[2][2]:.2f} plane, u, v tests a walking"
        " ray | one call launches "
        + ", ".join(f"{k} {names[0].split('(')[0]}"
                    for k, names in one_call.items())
        + " | a 64^2 pass at 3 bounces launches (profiler = wrapper "
        "counts) "
        + "; ".join(f"{tag} {_shown(c)}" for tag, c in path_prof.items())
        + " | " + "; ".join(
            f"{k}: {r} registers, {sp} B spilled, {b} blocks of {bs} "
            f"resident per SM x {sms} SMs, {w} waves"
            for k, (r, sp, b, sms, bs, w) in tinfo.items()
            if k != "tri_track_hits") + f" [{card}]")

    # ---- 2b. BVH kernels against their twin, knot290k 512^2 ----
    kro, krd = camera_rays(kscene, kcfg, rng.split(rng.PRNGKey(1))[1], 1)
    kro = kro.contiguous()
    kfar_p = torch.full((N,), K.FAR, device=dev)
    pt_t, p_prim = BK.bvh_closest_hit(kscene, kro, krd, kfar_p)[:2]
    kalive = (p_prim >= 0) & (torch.rand(N, generator=g, device=dev) > 0.15)
    kbo = kro + torch.where(kalive, pt_t, 0.0)[:, None] * krd
    kbd = torch.randn((N, 3), generator=g, device=dev)
    kbd = kbd / kbd.norm(dim=-1, keepdim=True)
    kfar_b = torch.where(kalive, K.FAR, DEAD)
    kto_l = kscene.emit_pos[0] - kbo
    kdist = kto_l.norm(dim=-1)
    ksd = kto_l / kdist[:, None]
    kfar_s = torch.where(kalive, kdist - K.RAY_EPS, DEAD)
    work = {}
    for o, d, far, tag in ((kro, krd, kfar_p, "primary"),
                           (kbo, kbd, kfar_b, "bounce")):
        got = BK.bvh_closest_hit(kscene, o, d, far)
        want = bvh.walk(kscene, o, d, far, stats=True)
        errs["bvh_closest_hit"] = max(errs["bvh_closest_hit"], _close(
            torch, got, want, far, f"bvh_closest_hit ({tag} rays)"))
        _require(all(torch.equal(a, b) for a, b in zip(got, want[:4])),
                 f"bvh_closest_hit ({tag} rays): not bit-equal to the twin")
        work[("bvh_closest_hit", tag)] = (int(want[4].sum()),
                                          int(want[5].sum()))
    # the any hit also on queue-pick's cleanup of these shadow rays (the
    # residual lanes of the schedule's own picks, the others dead)
    NC = kscene.n_clusters
    aro, ard, afar = adversarial_rays(torch, kscene, N, 11)
    any_sets = {"shadow": (kbo, ksd, kfar_s), "bounce": (kbo, kbd, kfar_b),
                "qpick residual": residual_rays(kscene, kbo, ksd, kfar_s),
                "adversarial": (aro, ard, afar)}
    for tag, (o, d, far) in any_sets.items():
        occ = BK.bvh_any_hit(kscene, o, d, far)
        want = bvh.walk(kscene, o, d, far, any_hit=True, stats=True)
        _require(torch.equal(occ, want[1] >= 0),
                 f"bvh_any_hit ({tag} rays): occlusion differs from the twin")
        _require(not bool(occ[~(far > K.RAY_EPS)].any()),
                 "a dead lane is occluded")
        work[("bvh_any_hit", tag)] = (int(want[4].sum()), int(want[5].sum()))
    live_share = {tag: float((far > K.RAY_EPS).float().mean())
                  for tag, (_o, _d, far) in any_sets.items()}
    _require(0 < int(BK.bvh_any_hit(kscene, kbo, ksd, kfar_s).sum())
             < int(kalive.sum()), "shadow rays all or none occluded")
    ktimes = {
        "bvh_closest_hit": (
            _time_ms(torch, lambda: BK.bvh_closest_hit(kscene, kbo, kbd,
                                                       kfar_b)),
            _time_ms(torch, lambda: BK.bvh_closest_hit_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "bvh_any_hit": (
            _time_ms(torch, lambda: BK.bvh_any_hit(kscene, kbo, ksd,
                                                   kfar_s)),
            _time_ms(torch, lambda: BK.bvh_any_hit_plain(
                kscene, kbo, ksd, kfar_s), reps=1))}
    times.update(ktimes)
    # bounds: rays, far and both tables read once, outputs written once;
    # operations: the node visits and prim tests these rays need (twin)
    tables = 4 * (kscene.bvh_node_pack.numel() + kscene.bvh_prim_pack.numel())
    for k, tag, out_bytes in (("bvh_closest_hit", "bounce", 16),
                              ("bvh_any_hit", "shadow", 1)):
        visits, tests = work[(k, tag)]
        bounds[k] = _bound(N * 28 + tables + N * out_bytes,
                           visits * bvh.NODE_OPS + tests * bvh.PRIM_OPS)
    # what the compiler and the card give each kernel: the closest hit
    # runs one wave of persistent warps (its "waves" are the rays a
    # resident thread takes), the any hit one thread a ray
    kinfo = BK.kernel_info(N)
    kdevice = {
        "bvh_closest_hit": {"bounce": (kbo, kbd, kfar_b),
                            "primary": (kro, krd, kfar_p)},
        "bvh_any_hit": {tag: any_sets[tag] for tag in (
            "shadow", "bounce", "qpick residual")}}
    fns = {"bvh_closest_hit": BK.bvh_closest_hit,
           "bvh_any_hit": BK.bvh_any_hit}
    for k, rays in kdevice.items():
        for tag, (o, d, far) in rays.items():
            rays[tag] = _graph_ms(torch, lambda: fns[k](kscene, o, d, far))
    device.update({k: v[next(iter(v))] for k, v in kdevice.items()})
    say("phase 2b BVH kernels vs twin, knot290k, %d rays: " % N
        + "; ".join(f"{k} exact ids, max abs err {errs[k]:.3g}, kernel "
                    f"{t:.4f} ms (device " + ", ".join(
                        f"{tag} rays {ms:.4f}"
                        for tag, ms in kdevice[k].items())
                    + f"), twin {p:.4f} ms (one call), bound "
                    f"{bounds[k][0]:.4f} ms ({bounds[k][1]})"
                    for k, (t, p) in ktimes.items())
        + " | node visits / prim tests per ray: " + ", ".join(
            f"{k} {tag} {v / N:.2f} / {s / N:.2f}"
            for (k, tag), (v, s) in work.items())
        + " | live lanes of the any hit's sets: " + ", ".join(
            f"{tag} {sh:.4f}" for tag, sh in live_share.items())
        + " | " + "; ".join(
            f"{k}: {r} registers, {sp} B spilled, {b} blocks of {bs} "
            f"resident per SM x {sms} SMs, "
            + (f"one wave, {w:.2f} rays per resident thread"
               if k == "bvh_closest_hit" else f"{w} waves")
            for k, (r, sp, b, sms, bs, w) in kinfo.items())
        + f" [{card}]")

    # ---- 2e. cluster kernels against their plain versions, knot290k ----
    CM = kscene.cluster_size
    _require(kscene.cl_rows.shape == (NC * CM, 18) and CM == 256
             and int(kscene.cl_count.sum()) == kscene.n_prims,
             "knot290k cluster tables")

    def same(got, want, name):
        """Every output of the kernel equal to the plain version's, bit
        for bit; returns the largest absolute difference of the floats."""
        err = 0.0
        for a, b in zip(got, want):
            _require(a.dtype == b.dtype and torch.equal(a, b),
                     f"{name}: an output differs from the plain version")
            if a.is_floating_point():
                err = max(err, float((a - b).abs().max()))
        return err

    cwork, vs_bvh, visits = {}, {}, {}
    for o, d, far, tag in ((kro, krd, kfar_p, "primary"),
                           (kbo, kbd, kfar_b, "bounce")):
        name = "cluster_closest_hit"
        got = CK.cluster_closest_hit(kscene, o, d, far)
        visits[(name, tag)] = []
        *want, boxes, prims, whole = CK.cluster_closest_hit_plain(
            kscene, o, d, far, stats=True, visits=visits[(name, tag)])
        errs[name] = max(errs[name], same(got, want, f"{name} ({tag} rays)"))
        _require(bool((got[0][far < 0] == -3e38).all()),
                 f"{name}: a dead lane did not come back with t = -3e38")
        _require(float((got[1] >= 0).float().mean()) > 0.2,
                 f"{name} ({tag} rays): few hits")
        cwork[(name, tag)] = (boxes, prims, whole)
        b_t, b_prim = BK.bvh_closest_hit(kscene, o, d, far)[:2]
        differ = got[1] != b_prim
        vs_bvh[(name, tag)] = float(differ.float().mean())
        torch.testing.assert_close(got[0][~differ], b_t[~differ], rtol=2e-6,
                                   atol=0.0)
    for o, d, far, tag in ((kbo, ksd, kfar_s, "shadow"),
                           (kbo, kbd, kfar_b, "bounce")):
        name = "cluster_any_hit"
        occ = CK.cluster_any_hit(kscene, o, d, far)
        visits[(name, tag)] = []
        want, boxes, prims, whole = CK.cluster_any_hit_plain(
            kscene, o, d, far, stats=True, visits=visits[(name, tag)])
        same([occ], [want], f"{name} ({tag} rays)")
        _require(not bool(occ[far < 0].any()), "a dead lane is occluded")
        cwork[(name, tag)] = (boxes, prims, whole)
        vs_bvh[(name, tag)] = float(
            (occ != BK.bvh_any_hit(kscene, o, d, far)).float().mean())
    _require(max(vs_bvh.values()) < LANES_DIFFER,
             f"sweep kernels differ from the BVH kernels: {vs_bvh}")
    # the tie set: rays at shared vertices and edges, the closest hit from
    # far = FAR, the any hit up to the target (its prims' t lie at far
    # within rounding); then the winners whose cluster holds another live
    # row at exactly their t (the lowest slot must win)
    tro, trd, tdist = tie_rays(torch, kscene, TIE_RAYS, 7)
    tfar = torch.full_like(tdist, K.FAR)
    got = CK.cluster_closest_hit(kscene, tro, trd, tfar)
    errs["cluster_closest_hit"] = max(errs["cluster_closest_hit"], same(
        got, CK.cluster_closest_hit_plain(kscene, tro, trd, tfar),
        "cluster_closest_hit (tie rays)"))
    occ = CK.cluster_any_hit(kscene, tro, trd, tdist)
    same([occ], [CK.cluster_any_hit_plain(kscene, tro, trd, tdist)],
         "cluster_any_hit (tie rays)")
    hit = torch.nonzero(got[1] >= 0).squeeze(1)
    rows_of = kscene.cl_rows.view(NC, CM, 18)
    n_ties = 0
    for s, e in CK._pieces(hit.numel(), CM * 4):
        h = hit[s:e]
        cl = kscene.cl_slot[got[1][h].long()].long() // CM
        tt = CK._prim_tables(rows_of[cl], tro[h, None], trd[h, None], True)
        n_ties += int(((tt[:, 0] == got[0][h, None]).sum(dim=1) >= 2).sum())
    _require(n_ties > 0, "the tie set holds no tie")
    tie_line = (f"tie set ({TIE_RAYS} rays at shared vertices and edges): "
                f"bit-equal, hit share {hit.numel() / TIE_RAYS:.4f}, "
                f"{n_ties} winners tie with another row of their cluster, "
                f"occluded before the target {float(occ.float().mean()):.4f}")
    # the front pass: the kernel and the plain walk over cl_tree
    # (`cluster_front_culled`) against the flat plain version, and the box
    # tests a ray each makes
    front_sets = {"primary": (kro, krd, kfar_p), "bounce": (kbo, kbd, kfar_b),
                  "shadow": (kbo, ksd, kfar_s), "tie": (tro, trd, tfar),
                  "adversarial": (aro, ard, afar)}
    front_tests = {}
    for tag, (o, d, far) in front_sets.items():
        got = CK.cluster_front(kscene, o, d, far)
        want = CK.cluster_front_plain(kscene, o, d, far)
        errs["cluster_front"] = max(errs["cluster_front"], same(
            got, want, f"cluster_front ({tag} rays)"))
        *walked, tests = CK.cluster_front_culled(kscene, o, d, far)
        same(walked, want, f"cluster_front_culled ({tag} rays)")
        _require(bool((got[0][far < 0] == NC).all()),
                 "cluster_front: a dead lane enters a cluster")
        front_tests[tag] = (int(tests.sum()), int(tests.max()),
                            float((got[0] < NC).float().mean()),
                            float((got[1] < CK.BIG).float().mean()))
    # the pick passes on the picks the schedule derives: bounce rays for
    # the closest hit, shadow rays for the any hit, both in sorted order
    _perm, pro, prd, pfar, pcid, pnxt = CK._front_sort(kscene, kbo, kbd,
                                                       kfar_b)
    ppicks, pcovered = CK.tile_picks(pcid, NC, CK.QP_P)
    p_t, p_wid = pfar, torch.full_like(pcid, -1)
    pick_in = []
    for p in range(CK.QP_P):
        name = "cluster_pick_closest"
        got = CK.cluster_pick_closest(kscene, pro, prd, p_t, p_wid, ppicks[p])
        *want, tests, whole = CK.cluster_pick_closest_plain(
            kscene, pro, prd, p_t, p_wid, ppicks[p], stats=True)
        errs[name] = max(errs[name], same(got, want, f"{name} (pass {p})"))
        pick_in.append((p_t, p_wid, ppicks[p], tests, whole))
        p_t, p_wid = got
    pick_hits = float((p_wid >= 0).float().mean())
    _require(pick_hits > 0, "cluster_pick_closest: no hit")
    entering = pcid < NC
    resid = entering & (~pcovered | (pnxt < p_t))
    pick_shares = (float(entering.float().mean()),
                   float((pcovered & entering).float().mean()),
                   float(resid.float().mean()))
    _perm, aro, ard, afar, acid, _nxt = CK._front_sort(kscene, kbo, ksd,
                                                       kfar_s)
    apicks, _cov = CK.tile_picks(acid, NC, CK.QP_P)
    any_in = []
    a_occ = torch.zeros_like(afar, dtype=torch.bool)
    for p in range(CK.QP_P):
        name = "cluster_pick_any"
        occ = CK.cluster_pick_any(kscene, aro, ard, afar, apicks[p])
        want, tests, whole = CK.cluster_pick_any_plain(
            kscene, aro, ard, afar, apicks[p], stats=True)
        same([occ], [want], f"{name} (pass {p})")
        any_in.append((apicks[p], tests, whole))
        a_occ |= occ
    _require(bool(a_occ.any()) and not bool(a_occ[afar < 0].any()),
             "cluster_pick_any: no lane or a dead lane occluded")
    # the pick passes on harder sets: the tie set and the adversarial set
    # (dead, NaN and short lanes inside active tiles), each with its own
    # front pass, sort and picks, both passes; and a forced set, where every
    # tile picks the cluster of most live rows and its N - 37 rays (a
    # partial last tile) aim at that cluster's vertices and edges, so hits
    # come from every staged copy
    big = int(torch.argmax(kscene.cl_count))
    big_rows = kscene.cl_rows[big * CM: big * CM + int(kscene.cl_count[big])]
    big_tri = big_rows[:, 13].long()
    fro, frd, fdist = tie_rays(torch, kscene, N - 37, 13,
                               big_tri[~kscene.prim_is_sphere[big_tri]])
    forced = torch.full((CK._tiles(N - 37),), big, dtype=torch.int32,
                        device=dev)
    pick_sets = {"tie": ((tro, trd, tfar), (tro, trd, tdist), None),
                 "adversarial": (any_sets["adversarial"],
                                 any_sets["adversarial"], None),
                 "forced": ((fro, frd, torch.full_like(fdist, K.FAR)),
                            (fro, frd, fdist), [forced])}

    def sorted_picks(o, d, far, fixed):
        """The rays in the schedule's order with its picks (the rays as
        they are and `fixed` when given)."""
        if fixed is not None:
            return o, d, far, fixed
        _perm, o, d, far, cid, _nxt = CK._front_sort(kscene, o, d, far)
        return o, d, far, CK.tile_picks(cid, NC, CK.QP_P)[0]

    def active_share(picks_):
        return float((torch.cat(picks_) >= 0).float().mean())

    pick_lines = []
    for tag, (closest_in, any_in_, fixed) in pick_sets.items():
        o, d, far, picks_ = sorted_picks(*closest_in, fixed)
        t_, wid_ = far, torch.full(far.shape, -1, dtype=torch.int32,
                                   device=dev)
        for p, pk in enumerate(picks_):
            got = CK.cluster_pick_closest(kscene, o, d, t_, wid_, pk)
            errs["cluster_pick_closest"] = max(
                errs["cluster_pick_closest"],
                same(got, CK.cluster_pick_closest_plain(kscene, o, d, t_,
                                                        wid_, pk),
                     f"cluster_pick_closest ({tag} rays, pass {p})"))
            t_, wid_ = got
        line = (f"{tag} closest {active_share(picks_):.4f} of tiles "
                f"active, hit {float((wid_ >= 0).float().mean()):.4f}")
        o, d, far, picks_ = sorted_picks(*any_in_, fixed)
        occ_ = torch.zeros(far.shape, dtype=torch.bool, device=dev)
        for p, pk in enumerate(picks_):
            got = CK.cluster_pick_any(kscene, o, d, far, pk)
            same([got], [CK.cluster_pick_any_plain(kscene, o, d, far, pk)],
                 f"cluster_pick_any ({tag} rays, pass {p})")
            occ_ |= got
        _require(not bool(occ_[~(far > K.RAY_EPS)].any()),
                 f"cluster_pick_any ({tag} rays): a dead lane occluded")
        pick_lines.append(f"{line}, any {active_share(picks_):.4f} active, "
                          f"occluded {float(occ_.float().mean()):.4f}")
    t0_, w0_, pk0, pick_tests, pick_whole = pick_in[0]
    apk0, any_tests, any_whole = any_in[0]
    ctimes = {
        "cluster_closest_hit": (
            _time_ms(torch, lambda: CK.cluster_closest_hit(kscene, kbo, kbd,
                                                           kfar_b)),
            _time_ms(torch, lambda: CK.cluster_closest_hit_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "cluster_any_hit": (
            _time_ms(torch, lambda: CK.cluster_any_hit(kscene, kbo, ksd,
                                                       kfar_s)),
            _time_ms(torch, lambda: CK.cluster_any_hit_plain(
                kscene, kbo, ksd, kfar_s), reps=1)),
        "cluster_front": (
            _time_ms(torch, lambda: CK.cluster_front(kscene, kbo, kbd,
                                                     kfar_b)),
            _time_ms(torch, lambda: CK.cluster_front_plain(
                kscene, kbo, kbd, kfar_b), reps=1)),
        "cluster_pick_closest": (
            _time_ms(torch, lambda: CK.cluster_pick_closest(
                kscene, pro, prd, t0_, w0_, pk0)),
            _time_ms(torch, lambda: CK.cluster_pick_closest_plain(
                kscene, pro, prd, t0_, w0_, pk0), reps=1)),
        "cluster_pick_any": (
            _time_ms(torch, lambda: CK.cluster_pick_any(kscene, aro, ard,
                                                        afar, apk0)),
            _time_ms(torch, lambda: CK.cluster_pick_any_plain(
                kscene, aro, ard, afar, apk0), reps=1))}
    times.update(ctimes)
    cdevice = {
        "cluster_closest_hit": _graph_ms(
            torch, lambda: CK.cluster_closest_hit(kscene, kbo, kbd, kfar_b)),
        "cluster_any_hit": _graph_ms(
            torch, lambda: CK.cluster_any_hit(kscene, kbo, ksd, kfar_s)),
        "cluster_front": _graph_ms(
            torch, lambda: CK.cluster_front(kscene, kbo, kbd, kfar_b)),
        "cluster_front primary": _graph_ms(
            torch, lambda: CK.cluster_front(kscene, kro, krd, kfar_p)),
        "cluster_pick_closest": _graph_ms(
            torch, lambda: CK.cluster_pick_closest(kscene, pro, prd, t0_,
                                                   w0_, pk0)),
        "cluster_pick_any": _graph_ms(
            torch, lambda: CK.cluster_pick_any(kscene, aro, ard, afar,
                                               apk0))}
    device.update({k: cdevice[k] for k in ctimes})
    cinfo = CK.kernel_info(N, NC, CM)
    # divergence factor: 32 x the warp's row iterations over its lanes'
    # row tests, one thread a ray and warp-cooperative (`warp_divergence`)
    diverge = {}
    for key, v in visits.items():
        tests, thread_iters, warp_iters = CK.warp_divergence(v)
        diverge[key] = (32 * thread_iters / max(tests, 1),
                        32 * warp_iters / max(tests, 1))
    # bounds. Bytes: what a kernel must read once and write once. A sweep:
    # rays and far of every lane, the cluster boxes and counts, the boxes
    # of the live chunks and the live rows (64 B each in `cl_rows_v4`;
    # padding slots are never read), the closest hit also n_g and obj of
    # its winners (16 B a lane), its outputs. A pick pass: the picks, the
    # counts and live rows (64 B each in `cl_rows_v4`) of its distinct
    # picked clusters, the rays (24 B) of the lanes in tiles that have a
    # pick (the others are never loaded),
    # and per lane far, wid0, t and wid (closest) or the flag (any, whose
    # far is read in tiles with a pick only). Operations: the box tests and
    # (ray, row) tests these rays need as the plain versions count them, a
    # row test that stops at its plane distance charged PLANE_OPS, a whole
    # one PRIM_OPS.
    def row_ops(tests, whole):
        return tests * CK.PLANE_OPS + whole * (CK.PRIM_OPS - CK.PLANE_OPS)

    live_chunks = int(((kscene.cl_count + 127) // 128).sum())
    sweep_tables = (NC * (24 + 4) + live_chunks * 24
                    + int(kscene.cl_count.sum()) * 64)
    for k, tag, out_bytes in (("cluster_closest_hit", "bounce", 36 + 16),
                              ("cluster_any_hit", "shadow", 1)):
        boxes, prims, whole = cwork[(k, tag)]
        bounds[k] = _bound(N * 28 + sweep_tables + N * out_bytes,
                           boxes * CK.BOX_OPS + row_ops(prims, whole))
    # the front pass: the rows of cl_tree its walk tests on these rays
    # (`cluster_front_culled`), beside the flat count (every box for every
    # lane that can enter one)
    NT = kscene.cl_tree.shape[0]
    bounds["cluster_front"] = _bound(N * 28 + NT * 32 + N * 8,
                                     front_tests["bounce"][0] * CK.BOX_OPS)
    flat_bound = _bound(N * 28 + NC * 24 + N * 8,
                        int((kfar_b > K.RAY_EPS).sum()) * NC * CK.BOX_OPS)
    pick_bytes = {}
    for k, pk, tests, whole, lane_b, active_b in (
            ("cluster_pick_closest", pk0, pick_tests, pick_whole, 16, 24),
            ("cluster_pick_any", apk0, any_tests, any_whole, 1, 28)):
        tiles = torch.nonzero(pk >= 0).squeeze(1)
        active = int(torch.clamp(N - tiles * CK.TILE, max=CK.TILE).sum())
        picked = torch.unique(pk[pk >= 0]).long()
        rows_b = 64 * int(kscene.cl_count[picked].sum())
        pick_bytes[k] = (picked.numel(), rows_b, active)
        bounds[k] = _bound(pk.numel() * 4 + picked.numel() * 4 + rows_b
                           + active * active_b + N * lane_b,
                           row_ops(tests, whole))
    say("phase 2e cluster kernels vs plain, knot290k (%d clusters of %d "
        "slots), %d rays: every output bit-equal; " % (NC, CM, N)
        + "; ".join(f"{k} max abs err {errs[k]:.3g}, kernel {t:.4f} ms "
                    f"(device {cdevice[k]:.4f}), plain {p:.4f} ms (one "
                    f"call), bound {bounds[k][0]:.4f} ms ({bounds[k][1]})"
                    for k, (t, p) in ctimes.items())
        + f" | front pass ({NT} rows of cl_tree), box tests a ray, flat "
        f"{NC} / culled walk (most one ray; entering share, second "
        "share): " + ", ".join(
            f"{tag} {b / N:.2f} ({mx}; {e:.4f}, {sc:.4f})"
            for tag, (b, mx, e, sc) in front_tests.items())
        + f", walk bit-equal; device on primary rays "
        f"{cdevice['cluster_front primary']:.4f} ms; bound of the flat "
        f"loop {flat_bound[0]:.4f} ms ({flat_bound[1]})"
        + " | " + tie_line + " | " + "; ".join(
            f"{k}: {r} registers, {sp} B spilled, {b} blocks of {bs} "
            f"resident per SM x {sms} SMs, {w} waves"
            for k, (r, sp, b, sms, bs, w) in cinfo.items())
        + " | divergence factor (one thread a ray / warp-cooperative): "
        + ", ".join(f"{k} {tag} {a:.2f} / {b:.2f}"
                    for (k, tag), (a, b) in diverge.items())
        + " | box tests / row tests per ray: " + ", ".join(
            f"{k} {tag} {b / N:.1f} / {r / N:.1f}"
            for (k, tag), (b, r, _w) in cwork.items())
        + " | whole row tests per ray: " + ", ".join(
            f"{k} {tag} {w / N:.2f}"
            for (k, tag), (_b, _r, w) in cwork.items())
        + f"; pick pass 0: closest {pick_tests / N:.1f} ({pick_whole / N:.2f}"
        f" whole), any {any_tests / N:.1f} ({any_whole / N:.2f} whole) row "
        "tests per ray; " + ", ".join(
            f"{k} reads {c} clusters' {b} B of live rows and the rays of "
            f"{a} lanes" for k, (c, b, a) in pick_bytes.items())
        + " | bounce rays entering a "
        f"cluster {pick_shares[0]:.4f}, covered by {CK.QP_P} picks "
        f"{pick_shares[1]:.4f}, hit in a pick pass {pick_hits:.4f}, left to "
        f"the cleanup {pick_shares[2]:.4f} | pick passes on harder sets, "
        f"bit-equal, closest / any (forced: cluster {big}, "
        f"{int(kscene.cl_count[big])} live rows, {N - 37} rays): "
        + "; ".join(pick_lines) + " | "
        "share of lanes differing from the BVH kernels: " + ", ".join(
            f"{k} {tag} {v:.3g}" for (k, tag), v in vs_bvh.items())
        + f" | BVH kernels on the same rays: closest "
        f"{times['bvh_closest_hit'][0]:.4f} ms, any "
        f"{times['bvh_any_hit'][0]:.4f} ms [{card}]")

    # ---- 2c. media-walk kernel against its twin, vpt cbox 512^2 ----
    _require(vcfg.max_bounce == 16 and (vcfg.w, vcfg.h) == (512, 512)
             and vcfg.n_null_objs == 1, "vpt cbox settings")
    vrays = vpt_rays(torch, vscene, vcfg, g)
    (v_p, v_sd, v_far_s), (_vp, v_bd, v_far_b) = (vrays["shadow"],
                                                  vrays["bounce"])
    # the null rows' own layers: 12 null rows and 12 exact duplicates (the
    # same t) and 8 (at the cap) or 12 (above it) copies RAY_EPS behind,
    # with rays aimed at the null triangles' vertices and edges
    VN = vscene.tri_null_rows.shape[0]
    dup = min(VN, null_cap - VN)
    at_cap = null_layers(torch, C, vscene, dup, null_cap - VN - dup)
    above = null_layers(torch, C, vscene, VN, VN)
    _require(at_cap.tri_null_rows.shape[0] == null_cap
             and above.tri_null_rows.shape[0] > null_cap,
             "null layers at and above the cap")
    nro, nrd, _nd = tie_rays(torch, vscene, N, 5,
                             prims=vscene.tri_gid[vscene.tri_null_rows])
    n_far = torch.full_like(v_far_b, K.FAR)
    track_sets = (("shadow", vscene, v_p, v_sd, v_far_s, 2, False),
                  ("bounce", vscene, v_p, v_bd, v_far_b, 2, False),
                  ("bounce all-null", vscene, v_p, v_bd, v_far_b, 7, True),
                  ("layers at cap, aimed", at_cap, nro, nrd, n_far, 3, False),
                  ("layers at cap, bounce", at_cap, v_p, v_bd, v_far_b, 2,
                   False),
                  ("layers above cap, aimed", above, nro, nrd, n_far, 3,
                   False),
                  ("layers above cap, bounce", above, v_p, v_bd, v_far_b, 2,
                   False))
    shares = []
    for tag, sc, o, d, far, k, all_null in track_sets:
        got = K.tri_track_hits(sc, o, d, far, k, all_null)
        want = K.tri_track_hits_plain(sc, o, d, far, k,
                                      K.null_flags(sc, all_null))
        for name, a, b in zip(("t_null", "obj_null", "dn_null", "t_blk",
                               "obj_blk", "dn_blk", "overflow"), got, want):
            _require(a.dtype == b.dtype and torch.equal(a, b),
                     f"tri_track_hits ({tag}): {name} differs from the twin")
        for i in (0, 2, 3, 5):                 # the float outputs
            errs["tri_track_hits"] = max(
                errs["tri_track_hits"], float((got[i] - want[i]).abs().max()))
        live = far > K.RAY_EPS
        _require(not bool((got[0][:, ~live] < K.FAR).any()
                          | got[6][~live].any()),
                 f"tri_track_hits ({tag}): a dead lane has hits")
        nl = max(int(live.sum()), 1)
        n_null = int(K.null_flags(sc, all_null).sum())
        shares.append((tag, k, n_null,
                       "registers" if n_null <= null_cap else "re-sweep",
                       float(((got[0][0] < K.FAR) & live).sum()) / nl,
                       float(((got[0][1] < K.FAR) & live).sum()) / nl,
                       float((got[6] & live).sum()) / nl,
                       float(((got[3] < K.FAR) & live).sum()) / nl))
    _require(all(sh[4] > 0 for sh in shares), "no null interface was hit")
    _require(shares[1][7] > 0, "no bounce ray was blocked")
    _require({sh[3] for sh in shares} == {"registers", "re-sweep"},
             "both branches of the null pass ran")
    times["tri_track_hits"] = (
        _time_ms(torch, lambda: K.tri_track_hits(vscene, v_p, v_sd, v_far_s,
                                                 2)),
        _time_ms(torch, lambda: K.tri_track_hits_plain(
            vscene, v_p, v_sd, v_far_s, 2, vscene.tri_null)))
    # bound: rays and far read once (a dead lane needs its far alone), the
    # table (12 + 3 floats, obj and a row id per row) read once, 3 K + 4 outputs written once; operations:
    # the plane half of every (walking ray, triangle) pair and the u/v half
    # where the row can block or lies before the cut (`track_work`)
    VT = vscene.tri_n.shape[0]
    b3_work = track_work(torch, K, vscene, v_p, v_sd, v_far_s)
    bounds["tri_track_hits"] = _bound(
        _ray_bytes(K, v_far_s) + VT * 68 + N * (2 * 12 + 13),
        _split_ops(*b3_work))
    walking = max(1, int((v_far_s > K.RAY_EPS).sum()))
    tt, tp = times["tri_track_hits"]
    device["tri_track_hits"] = _graph_ms(
        torch, lambda: K.tri_track_hits(vscene, v_p, v_sd, v_far_s, 2))
    r, sp, b, sms, bs, w = tinfo["tri_track_hits"]
    say(f"phase 2c media-walk kernel vs twin, vpt cbox, {N} rays, "
        f"{VT} triangles ({VN} null), null-row cap {null_cap}: every "
        f"output equal, max abs err {errs['tri_track_hits']:.3g}; "
        + "; ".join(f"{tag} K={k} ({nn} null rows, {br}): null-hit share "
                    f"{a:.4f}, second {a2:.4f}, overflow share {o:.5f}, "
                    f"blocked share {bl:.4f}"
                    for tag, k, nn, br, a, a2, o, bl in shares)
        + f" (shares of live lanes) | shadow K=2: kernel {tt:.4f} ms "
        f"(device, kernel only {device['tri_track_hits']:.4f}), twin "
        f"{tp:.4f} ms, bound {bounds['tri_track_hits'][0]:.4f} ms "
        f"({bounds['tri_track_hits'][1]}); plane, u and v tests a walking"
        " ray " + ", ".join(f"{x / walking:.2f}" for x in b3_work)
        + f" | {r} registers, {sp} B "
        f"spilled, {b} blocks of {bs} resident per SM x {sms} SMs, {w} "
        f"waves [{card}]")

    # ---- 2d. film-splat kernel against its plain version, 512^2 ----
    bcfg = dataclasses.replace(cfg0, max_bounce=6)  # scripts/bench_all.py:74-78
    P = bcfg.n_pixels
    t1_stream = []

    def capture(film, idx, rgb):
        t1_stream.append((film, idx, rgb))
        return S.splat_sorted_accumulate(film, idx, rgb)
    B.splat_sorted_accumulate = capture
    try:
        B.render_pass_bdpt(scene, bcfg, rng.PRNGKey(3), 1)
    finally:
        B.splat_sorted_accumulate = S.splat_sorted_accumulate
    _require(len(t1_stream) == 1, "one film splat a BDPT pass")
    film1, idx1, rgb1 = t1_stream[0]
    M = idx1.shape[0]
    _require(M == len(B._strategy_groups(bcfg, 6)["t1"]) * P,
             f"t=1 stream of {M} updates")

    def splat_stream(hot):
        """M sorted updates with random rgb over a random film: 10% dropped
        (id P) and the rest uniform, or `hot` of them in pixels [0, 1024)."""
        ids = torch.randint(0, P, (M,), generator=g, device=dev,
                            dtype=torch.int32)
        if hot:
            ids[:hot] = torch.randint(0, 1024, (hot,), generator=g,
                                      device=dev, dtype=torch.int32)
        else:
            ids = torch.where(torch.rand(M, generator=g, device=dev) < 0.1,
                              P, ids)
        return (torch.rand((P, 3), generator=g, device=dev),
                torch.sort(ids).values.contiguous(),
                torch.rand((M, 3), generator=g, device=dev))

    def hot_stream(n_hot):
        """The uniform stream with its first n_hot updates moved to one
        pixel: a segment longer than the kernel stages at a time."""
        film, idx, rgb = splat_stream(0)
        idx[:n_hot] = 4321
        return film, torch.sort(idx).values.contiguous(), rgb
    streams = (("bdpt t=1", (film1, idx1, rgb1)),
               ("uniform", splat_stream(0)),
               ("skewed", splat_stream(70000)),
               ("one pixel 20000", hot_stream(HOT_UPDATES)))
    _require(int((streams[2][1][1] < 1024).sum()) >= 65536,
             "the skewed stream's first tile holds 65,536 updates")
    splat_rows = []
    for tag, (film, idx, rgb) in streams:
        got = S.splat_sorted_accumulate(film, idx, rgb)
        want = S.splat_sorted_accumulate_plain(film, idx, rgb)
        _require(torch.equal(got, want),
                 f"splat_sorted_accumulate ({tag}): differs from the plain "
                 "version")
        errs["splat_sorted_accumulate"] = max(
            errs["splat_sorted_accumulate"], float((got - want).abs().max()))
        kept = idx < P
        ik, rk = idx[kept], rgb[kept]
        lib = torch.index_add(film, 0, ik, rk)
        # a pixel's f32 sum of n terms (its film value and its updates),
        # in any order, lies within n 2^-24 sum|x| of the exact sum;
        # index_add_ adds by atomics in no set order, so it and the kernel
        # may differ by twice that (tighter than 1e-5 on a pixel of a few
        # updates, ~1e-3 of the sum on the pixel of 20,000)
        n_terms = torch.bincount(ik, minlength=P)[:, None] + 1
        mag = torch.index_add(film.abs(), 0, ik, rk.abs())
        _require(bool(((lib - got).abs()
                       <= 2.02 * n_terms * 2.0 ** -24 * mag).all()),
                 f"index_add ({tag}) differs from the kernel beyond the "
                 "f32 summation bound")
        nk = int(kept.sum())
        mx = int(torch.bincount(idx[kept], minlength=P).max()) if nk else 0
        # bound: each kept update's id and rgb read once, the film read and
        # the output written once; 3 adds an update
        splat_rows.append((
            tag, nk,
            _time_ms(torch, lambda: S.splat_sorted_accumulate(film, idx,
                                                              rgb)),
            _time_ms(torch, lambda: S.splat_sorted_accumulate_plain(
                film, idx, rgb), reps=REPS if mx < 1000 else 1),
            _bound(nk * 16 + P * 24, 3 * nk),
            _time_ms(torch, lambda: torch.index_add(film, 0, ik, rk)), mx,
            _graph_ms(torch, lambda: S.splat_sorted_accumulate(film, idx,
                                                               rgb)),
            _graph_ms(torch, lambda: torch.index_add(film, 0, ik, rk))))
    # the JSON line takes the uniform stream: the main path's shapes with
    # every pixel at work (the main path's own t=1 stream keeps nothing on
    # cbox, see phase 7)
    _tag, _nk, sk, sp, sb, sl, _mx, kb, _lb = splat_rows[1]
    times["splat_sorted_accumulate"] = (sk, sp, sl)
    device["splat_sorted_accumulate"] = kb
    bounds["splat_sorted_accumulate"] = sb
    say(f"phase 2d film-splat kernel vs plain, {P} pixels, {M} updates: "
        "bit-equal on every stream; " + "; ".join(
            f"{tag}: {nk} kept (most in one pixel {mx}), kernel {k:.4f} ms,"
            f" plain {p:.4f} ms{' (one call)' if mx >= 1000 else ''}, "
            f"bound {b[0]:.4f} ms ({b[1]}), index_add_ {lb:.4f} ms; "
            f"device: kernel {kb:.4f}, index_add_ {ib:.4f} ms"
            for tag, nk, k, p, b, lb, mx, kb, ib in splat_rows)
        + f" [{card}]")

    # ---- 2f, timed: the threefry draws on CUDA graphs ----
    rng_rows = [
        (tag, nk, _time_ms(torch, fn), _time_ms(torch, plain),
         _graph_ms(torch, fn), _graph_ms(torch, plain),
         _bound(nbytes, hashes * HASH_OPS + words * FLOAT_OPS, INT_OPS))
        for (tag, _w, fn, plain, hashes, words, nbytes), nk
        in zip(draws, rng_seen)]
    # the JSON line takes each wrapper's first draw (cbox's, the camera's)
    rng_json = {}
    for (_tag, wrapper, *_rest), (_t, _n, k, p, kd, _pd, b) in zip(
            draws, rng_rows):
        rng_json.setdefault(wrapper, (k, p, kd, b))
    say("phase 2f threefry kernels vs twin: bit-equal on every draw; "
        + "; ".join(
            f"{tag}: {nk} kernel a call, kernel {k:.4f} ms, plain "
            f"{p:.4f} ms; device: kernel {kd:.4f}, plain {pd:.4f} ms; "
            f"bound {b[0]:.4f} ms ({b[1]})"
            for tag, nk, k, p, kd, pd, b in rng_rows) + f" [{card}]")

    # ---- 3. golden on the card ----
    golden = dict(anti_alias=False, stratified_sampling=False,
                  use_rr=False)             # tests/test_goldens.py:25-29
    small = _small(cfg0, 48, max_bounce=3, **golden)
    reset()
    img = pt.render_pass_pt(scene, small, rng.PRNGKey(42), 1)
    golden_launches = counts()
    _require(golden_launches["tri_closest_hit"] > 0
             and golden_launches["tri_any_hit"] > 0,
             f"a kernel did not launch: {golden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_pt_48.npy")))
    say(f"phase 3 golden cbox_pt_48 on cuda: max abs diff {err:.3g}, mean "
        f"{mean:.6f} vs {ref_mean:.6f}, launches {_shown(golden_launches)}")

    # ---- 3b. vpt golden on the card ----
    vsmall = _small(vcfg, 48, max_bounce=3, **golden)
    reset()
    img = vpt.render_pass_vpt(vscene, vsmall, rng.PRNGKey(42), 1)
    vgolden_launches = counts()
    _require(vgolden_launches["tri_track_hits"] > 0
             and vgolden_launches["tri_closest_hit"] > 0,
             f"a kernel did not launch: {vgolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "vptcbox_48.npy")))
    say(f"phase 3b golden vptcbox_48 on cuda: max abs diff {err:.3g}, mean "
        f"{mean:.6f} vs {ref_mean:.6f}, launches {_shown(vgolden_launches)}")

    # ---- 3c. BDPT golden on the card ----
    reset()
    img, _, _ = B.render_pass_bdpt(scene, small, rng.PRNGKey(42), 1)
    bgolden_launches = counts()
    _require(bgolden_launches["tri_closest_hit"] > 0
             and bgolden_launches["tri_track_hits"] > 0
             and bgolden_launches["splat_sorted_accumulate"] > 0,
             f"a kernel did not launch: {bgolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_bdpt_48.npy")))
    say(f"phase 3c golden cbox_bdpt_48 on cuda: max abs diff {err:.3g}, "
        f"mean {mean:.6f} vs {ref_mean:.6f}, launches "
        f"{_shown(bgolden_launches)}")

    # ---- 3d. direct preview golden on the card ----
    reset()
    img, _, _ = direct.render_pass_direct(scene, small, rng.PRNGKey(42), 1)
    dgolden_launches = counts()
    _require(dgolden_launches == {**none, "tri_closest_hit": 1,
                                  "tri_any_hit": 1},
             f"direct launch counts {dgolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_direct_48.npy")))
    say(f"phase 3d golden cbox_direct_48 on cuda: max abs diff {err:.3g}, "
        f"mean {mean:.6f} vs {ref_mean:.6f}, launches "
        f"{_shown(dgolden_launches)}")

    # ---- 3e. SSAO golden on the card ----
    reset()
    dmap = ssao.depth_prepass(scene, small, rng.PRNGKey(42))
    img = ssao.render_pass_ssao(scene, small, rng.PRNGKey(42), 1, dmap)
    agolden_launches = counts()
    _require(agolden_launches == {**none, "tri_closest_hit":
                                  small.depth_samples + 1},
             f"SSAO launch counts {agolden_launches}")
    err, mean, ref_mean = _check(
        img.cpu().numpy(),
        np.load(os.path.join(ROOT, "tests", "goldens", "cbox_ao_48.npy")))
    say(f"phase 3e golden cbox_ao_48 on cuda: max abs diff {err:.3g}, "
        f"mean {mean:.6f} vs {ref_mean:.6f}, launches "
        f"{_shown(agolden_launches)}")

    # ---- 3f. the csphere and vpt balls goldens on the card ----
    f_rows = []
    for gname, scn, c, render, want_k in (
            ("csphere_multi_pt_48", mscene, mcfg, pt.render_pass_pt,
             ("tri_closest_hit", "tri_any_hit")),
            ("csphere_mix_pt_48", None, None, pt.render_pass_pt,
             ("tri_closest_hit", "tri_any_hit")),
            ("vptballs_48", vbscene, vbcfg, vpt.render_pass_vpt,
             ("tri_closest_hit", "tri_track_hits"))):
        if scn is None:
            scn, c, _ = C.load_scene(os.path.join(ROOT, "scenes", "csphere"),
                                     "mix-balls.xml")
        reset()
        img = render(scn, _small(c, 48, max_bounce=6, **golden),
                     rng.PRNGKey(42), 1)
        fl = counts()
        _require(all(fl[k] > 0 for k in want_k),
                 f"{gname}: a kernel did not launch: {fl}")
        f_rows.append((gname, *_check(
            img.cpu().numpy(),
            np.load(os.path.join(ROOT, "tests", "goldens",
                                 gname + ".npy"))), fl))
    say("phase 3f goldens on cuda, 48^2, 6 bounces: " + "; ".join(
      f"{gname}: max abs diff {err:.3g}, mean {mean:.6f} vs "
      f"{ref_mean:.6f}, launches {_shown(fl)}"
      for gname, err, mean, ref_mean, fl in f_rows) + f" [{card}]")

    # ---- 3g. the textured goldens on the card ----
    bunny_assets()
    g_dir = os.path.join(ROOT, "build", "chip_smoke")
    g_rows = []
    for gname, where, render, want_k in (
            ("bunny_bdpt_48", reduced_bunny(os.path.join(g_dir, "rbunny")),
             lambda s, c: B.render_pass_bdpt(s, c, rng.PRNGKey(42), 1)[0],
             ("bvh_closest_hit", "splat_sorted_accumulate")),
            ("cbox_tex_pt_48", twotone_cbox(os.path.join(g_dir, "tex_cbox")),
             lambda s, c: pt.render_pass_pt(s, c, rng.PRNGKey(42), 1),
             ("tri_closest_hit", "tri_any_hit"))):
        scn, c, tex_rows = load_textured(*where)
        reset()
        img = render(scn, _small(c, 48, max_bounce=3, **golden))
        gl = counts()
        _require(all(gl[k] > 0 for k in want_k),
                 f"{gname}: a kernel did not launch: {gl}")
        g_rows.append((gname, *_check(
            img.cpu().numpy(),
            np.load(os.path.join(ROOT, "tests", "goldens",
                                 gname + ".npy"))), gl, sorted(tex_rows)))
    import PIL                        # the loaders read images with it
    say(f"phase 3g textured goldens on cuda, 48^2, 3 bounces (images "
        f"read with PIL {PIL.__version__}): " + "; ".join(
      f"{gname}: textures {tex} loaded, max abs diff {err:.3g}, mean "
      f"{mean:.6f} vs {ref_mean:.6f}, launches {_shown(gl)}"
      for gname, err, mean, ref_mean, gl, tex in g_rows) + f" [{card}]")

    # ---- 3h. the grid-volume goldens on the card ----
    vol_paths = vol_assets()
    vg_scene, vg_cfg, _ = load_volume(cbox_dir, "cbox-volgrid.xml")
    rg_scene, rg_cfg, _ = load_volume(cbox_dir, "cbox-rgbvol.xml")
    h_rows = []
    for gname, scn, c, w, mb, render, want_k in (
            ("volgrid_vpt_64", vg_scene, vg_cfg, 64, 4, vpt.render_pass_vpt,
             ("tri_closest_hit", "tri_track_hits")),
            ("rgbvol_vpt_64", rg_scene, rg_cfg, 64, 4, vpt.render_pass_vpt,
             ("tri_closest_hit", "tri_track_hits")),
            ("volgrid_bdpt_32", vg_scene, vg_cfg, 32, 3,
             lambda *a: B.render_pass_bdpt(*a)[0],
             ("tri_closest_hit", "tri_track_hits",
              "splat_sorted_accumulate"))):
        reset()
        img = render(scn, _small(c, w, max_bounce=mb, **golden),
                     rng.PRNGKey(42), 1)
        hl = counts()
        _require(all(hl[k] > 0 for k in want_k),
                 f"{gname}: a kernel did not launch: {hl}")
        h_rows.append((gname, *_check(
            img.cpu().numpy(),
            np.load(os.path.join(ROOT, "tests", "goldens",
                                 gname + ".npy"))), hl))
    say(f"phase 3h grid-volume goldens on cuda (volume kinds "
        f"{vg_cfg.volume_kind}, {rg_cfg.volume_kind}; "
        f"{', '.join(os.path.basename(p) for p in vol_paths)}): "
        + "; ".join(
            f"{gname}: max abs diff {err:.3g}, mean {mean:.6f} vs "
            f"{ref_mean:.6f}, launches {_shown(hl)}"
            for gname, err, mean, ref_mean, hl in h_rows) + f" [{card}]")

    @contextlib.contextmanager
    def twins():
        """The path's wrappers swapped for their plain twins."""
        saved = (K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits,
                 BK.bvh_closest_hit, BK.bvh_any_hit,
                 B.splat_sorted_accumulate, rng.lane_uniform, rng.uniform,
                 SK.route)
        K.tri_closest_hit = K.tri_closest_hit_plain
        K.tri_any_hit = K.tri_any_hit_plain
        K.tri_track_hits = lambda s, o, d, f, k, all_null=False: \
            K.tri_track_hits_plain(s, o, d, f, k, K.null_flags(s, all_null))
        BK.bvh_closest_hit = BK.bvh_closest_hit_plain
        BK.bvh_any_hit = BK.bvh_any_hit_plain
        B.splat_sorted_accumulate = S.splat_sorted_accumulate_plain
        rng.lane_uniform = rng.lane_uniform_plain
        rng.uniform = rng.uniform_plain
        SK.route = lambda *a, **kw: False     # surface_*: the plain arms
        try:
            yield
        finally:
            (K.tri_closest_hit, K.tri_any_hit, K.tri_track_hits,
             BK.bvh_closest_hit, BK.bvh_any_hit,
             B.splat_sorted_accumulate, rng.lane_uniform,
             rng.uniform, SK.route) = saved

    def timed_batch(r, spp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_batch(spp)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def rays_per_spp(c):
        return c.n_pixels * (1 + c.max_bounce * c.num_shadow_ray
                             + (c.max_bounce - 1))    # bench.py:61-63

    # ---- 4. cbox main path at full size ----
    r = pt.Renderer(scene, cfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, SPP)
    launches, rlaunches = counts(), _launches("rng")
    slaunches = _launches("shade_kernels")
    image = r.image()
    _require(image.shape == (cfg.h, cfg.w, 3), f"image shape {image.shape}")
    _require(bool(np.isfinite(image).all()) and image.mean() > 0.05,
             f"image not finite or too dark (mean {image.mean()})")
    want = {**none, "tri_closest_hit": SPP * cfg.max_bounce,
            "tri_any_hit": SPP * cfg.max_bounce * cfg.num_shadow_ray}
    _require(launches == want, f"cbox launch counts {launches}, want {want}")
    # a threefry draw a bounce and the camera's, each spp
    rwant = {"lane_uniform": SPP * cfg.max_bounce, "uniform": SPP}
    _require(rlaunches == rwant,
             f"cbox threefry launch counts {rlaunches}, want {rwant}")
    swant = shade_want(cfg, SPP)
    _require(slaunches == swant,
             f"cbox shading launch counts {slaunches}, want {swant}")
    r_twin = pt.Renderer(scene, cfg, seed=0)
    with twins():
        r_twin.render_batch(1)
        dt_twin = timed_batch(r_twin, SPP)
    twin_err, _, _ = _check(image, r_twin.image())
    rays = rays_per_spp(cfg)
    say(f"phase 4 main path cbox {cfg.w}x{cfg.h} mb {cfg.max_bounce}, "
        f"{SPP} spp: {1e3 * dt / SPP:.2f} ms/spp, "
        f"{rays * SPP / dt / 1e6:.3f} Mrays/s [{card}]; twins in place: "
        f"{1e3 * dt_twin / SPP:.2f} ms/spp, "
        f"{rays * SPP / dt_twin / 1e6:.3f} Mrays/s [{card}]; image mean "
        f"{image.mean():.6f}, max abs diff to twins {twin_err:.3g}; "
        f"launches {_shown(launches)}, threefry {rlaunches}, shading "
        f"{slaunches}")

    # ---- 5. knot290k main path at full size, auto-compaction ----
    r = pt.Renderer(kscene, kcfg, seed=0)
    _require(r._auto, "knot290k is under the auto-compaction gate")
    t0 = time.perf_counter()
    r.render_batch(1)                 # the alive probe + one warm-up spp
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sched = r._sched
    reset()
    dt = dt_knot = timed_batch(r, KNOT_SPP)
    klaunches = counts()
    kimage = r.image()
    _require(kimage.shape == (kcfg.h, kcfg.w, 3), f"shape {kimage.shape}")
    _require(bool(np.isfinite(kimage).all()) and kimage.mean() > 0,
             f"image not finite or black (mean {kimage.mean()})")
    want = {**none, "bvh_closest_hit": KNOT_SPP * kcfg.max_bounce,
            "bvh_any_hit": KNOT_SPP * kcfg.max_bounce * kcfg.num_shadow_ray}
    _require(klaunches == want,
             f"knot290k launch counts {klaunches}, want {want}")
    plain = pt.Renderer(kscene, kcfg, seed=0)
    plain._sched = ()                 # the same render without compaction
    plain.render_batch(1)
    dt_plain = timed_batch(plain, KNOT_SPP)
    _require(torch.equal(plain.color, r.color),
             "the compacted render differs from the uncompacted one")
    # 3 bounces: the twin walks a 64^2 wavefront as long as a 512^2 one
    small = _small(kcfg, 64, max_bounce=TWIN_BOUNCES)
    rk = pt.Renderer(kscene, small, seed=1)
    rk.render_batch(1)
    rt = pt.Renderer(kscene, small, seed=1)
    rt._sched = rk._sched        # its probe's schedule, as in twin_equal
    with twins():
        rt.render_batch(1)
    ktwin_err, _, _ = _check(rk.image(), rt.image())
    rays = rays_per_spp(kcfg)
    say(f"phase 5 main path knot290k {kcfg.w}x{kcfg.h} mb "
        f"{kcfg.max_bounce}, schedule {sched}, {KNOT_SPP} spp: "
        f"{dt / KNOT_SPP:.4f} s/spp, {rays * KNOT_SPP / dt / 1e6:.3f} "
        f"Mrays/s [{card}]; uncompacted: {dt_plain / KNOT_SPP:.4f} s/spp, "
        f"{rays * KNOT_SPP / dt_plain / 1e6:.3f} Mrays/s, image equal; "
        f"probe + warm-up spp {warm_s:.2f} s; image mean "
        f"{kimage.mean():.6f}; 64^2 max abs diff to twins at "
        f"{TWIN_BOUNCES} bounces {ktwin_err:.3g}; "
        f"launches {_shown(klaunches)}")

    # ---- 6. vpt cbox main path at full size ----
    iters = vcfg.max_bounce + vpt.NULL_BUDGET
    r = vpt.VolumeRenderer(vscene, vcfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, VPT_SPP)
    vlaunches = counts()
    vimage = r.image()
    _require(vimage.shape == (vcfg.h, vcfg.w, 3), f"shape {vimage.shape}")
    _require(bool(np.isfinite(vimage).all()) and vimage.mean() > 0,
             f"image not finite or black (mean {vimage.mean()})")
    _require(vlaunches["tri_track_hits"]
             == VPT_SPP * iters * vcfg.num_shadow_ray
             and vlaunches["tri_closest_hit"] >= VPT_SPP * iters
             and vlaunches["tri_any_hit"] == 0
             and vlaunches["bvh_closest_hit"] == vlaunches["bvh_any_hit"] == 0
             and vlaunches["splat_sorted_accumulate"] == 0,
             f"vpt launch counts {vlaunches}")
    plain = vpt.VolumeRenderer(vscene, vcfg, seed=0, schedule=())
    plain.render_batch(1)
    dt_plain = timed_batch(plain, VPT_SPP)
    _require(torch.equal(plain.color, r.color),
             "the compacted vpt render differs from the uncompacted one")
    small = _small(vcfg, 64)
    rv = vpt.VolumeRenderer(vscene, small, seed=1)
    rv.render_batch(1)
    rt = vpt.VolumeRenderer(vscene, small, seed=1)
    with twins():
        rt.render_batch(1)
    vtwin_err, _, _ = _check(rv.image(), rt.image())
    say(f"phase 6 main path vpt cbox {vcfg.w}x{vcfg.h} mb "
        f"{vcfg.max_bounce}, {iters} iterations, schedule {r.schedule}, "
        f"{VPT_SPP} spp: {1e3 * dt / VPT_SPP:.2f} ms/spp [{card}]; "
        f"uncompacted: {1e3 * dt_plain / VPT_SPP:.2f} ms/spp, image equal; "
        f"image mean {vimage.mean():.6f}; 64^2 max abs diff to twins "
        f"{vtwin_err:.3g}; launches {_shown(vlaunches)}")

    # ---- 7. BDPT main path at full size ----
    groups = B._strategy_groups(bcfg, bcfg.max_bounce)
    Q = max(1, B.FLAT_LANES // P)
    chunks = {case: -(-len(rows) // Q) for case, rows in groups.items()}
    r = B.BDPT(scene, bcfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt = timed_batch(r, BDPT_SPP)
    blaunches = counts()
    bimage = r.image()
    _require(bimage.shape == (bcfg.h, bcfg.w, 3), f"shape {bimage.shape}")
    _require(bool(np.isfinite(bimage).all()) and bimage.mean() > 0,
             f"image not finite or black (mean {bimage.mean()})")
    # two walks of max_bounce closest hits; one media walk for each chunk
    # of the t1, s1 and gen groups (no null surface, so no overflow
    # fallback); one film splat a pass
    want = {**none, "tri_closest_hit": BDPT_SPP * 2 * bcfg.max_bounce,
            "tri_track_hits": BDPT_SPP * (chunks["t1"] + chunks["s1"]
                                          + chunks["gen"]),
            "splat_sorted_accumulate": BDPT_SPP}
    _require(blaunches == want,
             f"BDPT launch counts {blaunches}, want {want}")
    small = _small(bcfg, 64)
    rb = B.BDPT(scene, small, seed=1)
    rb.render_batch(1)
    rt = B.BDPT(scene, small, seed=1)
    with twins():
        rt.render_batch(1)
    btwin_err, _, _ = _check(rb.image(), rt.image())
    say(f"phase 7 main path BDPT cbox {bcfg.w}x{bcfg.h} mb "
        f"{bcfg.max_bounce}, {sum(map(len, groups.values()))} strategies "
        f"in chunks {chunks}, {BDPT_SPP} spp: {1e3 * dt / BDPT_SPP:.2f} "
        f"ms/spp [{card}]; image mean {bimage.mean():.6f}; 64^2 max abs "
        f"diff to twins {btwin_err:.3g}; launches {_shown(blaunches)}")

    # ---- 8. transient BDPT at full size ----
    tscene, tcfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "trans"),
                                   "cbox-point.xml")
    _require(tcfg.transient and tcfg.t_bins == 400 and tcfg.max_bounce == 12
             and (tcfg.w, tcfg.h) == (512, 512), "trans cbox-point settings")
    torch.cuda.reset_peak_memory_stats()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tcolor, tbins, tcnts = B.render_pass_bdpt(tscene, tcfg, rng.PRNGKey(5), 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tlaunches = counts()
    _require(tuple(tbins.shape) == (P, 400, 3)
             and tuple(tcnts.shape) == (P, 400), "transient shapes")
    _require(bool(torch.isfinite(tbins).all() & torch.isfinite(tcolor).all()),
             "transient bins or image not finite")
    n_cnt = int(tcnts.sum())
    _require(n_cnt > 0 and bool((tcnts >= 0).all()), "no transient counts")
    _require(tlaunches["tri_any_hit"] > 0
             and tlaunches["splat_sorted_accumulate"] == 1
             and tlaunches["tri_track_hits"] == 0,
             f"transient launch counts {tlaunches}")
    say(f"phase 8 transient BDPT trans/cbox-point {tcfg.w}x{tcfg.h} mb "
        f"{tcfg.max_bounce}, {tcfg.t_bins} bins: {1e3 * dt:.2f} ms per pass "
        f"[{card}]; {n_cnt} samples binned, {int((tcnts > 0).sum())} bins "
        f"filled; image mean {float(tcolor.mean()):.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{_shown(tlaunches)}")

    # ---- 9. knot290k main path under the two cluster-tier schedules ----
    per = kcfg.max_bounce
    shadows = kcfg.max_bounce * kcfg.num_shadow_ray
    tier_want = {
        "sweep": {**none, "cluster_closest_hit": KNOT_SPP * per,
                  "cluster_any_hit": KNOT_SPP * shadows},
        "qpick": {**none, "cluster_front": KNOT_SPP * (per + shadows),
                  "cluster_pick_closest": KNOT_SPP * per * CK.QP_P,
                  "cluster_pick_any": KNOT_SPP * shadows * CK.QP_P,
                  "bvh_closest_hit": KNOT_SPP * per,
                  "bvh_any_hit": KNOT_SPP * shadows}}
    tier_launches, tier_rows = {}, []
    for tier, want in tier_want.items():
        r = pt.Renderer(kscene, dataclasses.replace(kcfg, big_tier=tier),
                        seed=0)
        _require(r._auto, "knot290k is under the auto-compaction gate")
        r.render_batch(1)             # the alive probe + one warm-up spp
        reset()
        dt_tier = timed_batch(r, KNOT_SPP)
        tier_launches[tier] = counts()
        _require(tier_launches[tier] == want,
                 f"{tier} launch counts {tier_launches[tier]}, want {want}")
        timage = r.image()
        _require(bool(np.isfinite(timage).all()),
                 f"{tier}: image not finite")
        tier_rows.append((tier, dt_tier, r._sched,
                          *_check_tier(timage, kimage)))
    say(f"phase 9 main path knot290k {kcfg.w}x{kcfg.h} mb "
        f"{kcfg.max_bounce}, {KNOT_SPP} spp, cluster tier: " + "; ".join(
            f"{tier}: {1e3 * d / KNOT_SPP:.2f} ms/spp, "
            f"{rays_per_spp(kcfg) * KNOT_SPP / d / 1e6:.3f} Mrays/s, "
            f"schedule {sc}, against the BVH tier's image {sh:.3g} of the "
            f"pixels differ by 5e-2 or more (most {mx:.3g}), the others by "
            f"at most {e:.3g}, launches "
            f"{_shown(tier_launches[tier])}"
            for tier, d, sc, e, sh, mx in tier_rows)
        + f"; BVH tier (phase 5): {1e3 * dt_knot / KNOT_SPP:.2f} ms/spp "
        f"[{card}]")

    # ---- 10. direct preview and SSAO at full size ----
    preview_rows, preview_launches = [], dict(none)
    for name, cls in (("direct", direct.DirectRenderer),
                      ("SSAO", ssao.SSAORenderer)):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cls(scene, cfg0, seed=0)          # SSAO: the depth prepass
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        made = counts()
        r.render_batch(1)                     # warm-up pass, not timed
        reset()
        dt = timed_batch(r, PREVIEW_SPP)
        plaunches = counts()
        want = {**none, "tri_closest_hit": PREVIEW_SPP,
                "tri_any_hit": PREVIEW_SPP if name == "direct" else 0}
        _require(plaunches == want,
                 f"{name} launch counts {plaunches}, want {want}")
        _require(made == {**none, "tri_closest_hit": 0 if name == "direct"
                          else cfg0.depth_samples},
                 f"{name} set-up launch counts {made}")
        for k, n in plaunches.items():
            preview_launches[k] += n
        pimage = r.image()
        _require(pimage.shape == (cfg0.h, cfg0.w, 3)
                 and bool(np.isfinite(pimage).all()) and pimage.mean() > 0.05,
                 f"{name}: image not finite or too dark")
        with twins():
            rt = cls(scene, cfg0, seed=0)
            rt.render_batch(1 + PREVIEW_SPP)
        perr, _, _ = _check(pimage, rt.image())
        preview_rows.append((name, dt, made_s, pimage.mean(), perr,
                             bool(torch.equal(r.color, rt.color)),
                             plaunches))
    say(f"phase 10 direct preview and SSAO cbox {cfg0.w}x{cfg0.h}, "
        f"{PREVIEW_SPP} passes: " + "; ".join(
            f"{name} {1e3 * d / PREVIEW_SPP:.2f} ms per pass"
            + (f" (depth prepass, {cfg0.depth_samples} samples: "
               f"{1e3 * m:.2f} ms)" if name == "SSAO" else "")
            + f", image mean {mean_:.6f}, max abs diff to twins "
            f"{e:.3g} (equal: {eq}), launches per pass "
            + ", ".join(f"{k} {n // PREVIEW_SPP}"
                        for k, n in _shown(pl).items())
            for name, d, m, mean_, e, eq, pl in preview_rows)
        + f" [{card}]")

    def twin_equal(make, c, small=None):
        """A 64^2 render of one spp (seed 1) with the kernels and with the
        twins in place: (max abs diff, equal). small: the 64^2
        configuration, when `_small`'s 512-pixel field of view is not c's."""
        small = small or _small(c, 64)
        a = make(small)
        a.render_batch(1)
        b = make(small)
        if getattr(a, "_auto", False):
            # the probe's schedule (the twins' probe would render the
            # same pass again with the plain walks); it leaves the image
            # as it is
            b._sched = a._sched
        with twins():
            b.render_batch(1)
        err, _, _ = _check(a.image(), b.image())
        _require(bool(torch.equal(a.color, b.color)),
                 "a 64^2 render differs from the twins' render")
        return err

    # ---- 11. csphere PT main path at full size ----
    r = pt.Renderer(mscene, mcfg, seed=0)
    _require(not r._auto, "balls-multi is under the auto-compaction gate")
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt_m = timed_batch(r, MULTI_SPP)
    mlaunches = counts()
    mimage = r.image()
    _require(mimage.shape == (mcfg.h, mcfg.w, 3), f"shape {mimage.shape}")
    m_nan = float(np.isnan(mimage).any(axis=-1).mean())
    _require(m_nan == 0.0 and bool(np.isfinite(mimage).all())
             and mimage.mean() > 0.01,
             f"balls-multi: NaN share {m_nan}, mean {mimage.mean()}")
    want = {**none, "tri_closest_hit": MULTI_SPP * mcfg.max_bounce,
            "tri_any_hit": MULTI_SPP * mcfg.max_bounce * mcfg.num_shadow_ray}
    _require(mlaunches == want and all(
        n * mcfg.max_bounce == PROF_BOUNCES * mlaunches[k] // MULTI_SPP
        for k, n in path_prof["balls-multi PT"].items()),
             f"balls-multi launch counts {mlaunches}, want {want}")
    m_twin = twin_equal(lambda c: pt.Renderer(mscene, c, seed=1), mcfg)
    say(f"phase 11 main path csphere balls-multi PT {mcfg.w}x{mcfg.h} mb "
        f"{mcfg.max_bounce}, {mcfg.num_shadow_ray} shadow rays, "
        f"{MULTI_SPP} spp: {1e3 * dt_m / MULTI_SPP:.2f} ms/spp; launches "
        "per spp " + ", ".join(f"{k} {n // MULTI_SPP}"
                               for k, n in _shown(mlaunches).items())
        + " (profiler, a 64^2 pass at 3 bounces: "
        f"{_shown(path_prof['balls-multi PT'])})"
        f"; image mean {mimage.mean():.6f}, NaN pixel share {m_nan}; 64^2 "
        f"render equal to the twins' (max abs diff {m_twin:.3g}) [{card}]")

    # ---- 12. vpt balls main path at full size ----
    r = vpt.VolumeRenderer(vbscene, vbcfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt_vb = timed_batch(r, VBALLS_SPP)
    vblaunches = counts()
    vbimage = r.image()
    _require(vbimage.shape == (vbcfg.h, vbcfg.w, 3),
             f"shape {vbimage.shape}")
    vb_nan = float(np.isnan(vbimage).any(axis=-1).mean())
    _require(vb_nan == 0.0 and bool(np.isfinite(vbimage).all())
             and vbimage.mean() > 0.01,
             f"vpt balls: NaN share {vb_nan}, mean {vbimage.mean()}")
    want = {**none, "tri_closest_hit": VBALLS_SPP * vbcfg.max_bounce,
            "tri_track_hits": VBALLS_SPP * vbcfg.max_bounce
            * vbcfg.num_shadow_ray}
    _require(vblaunches == want and all(
        n * vbcfg.max_bounce == PROF_BOUNCES * vblaunches[k] // VBALLS_SPP
        for k, n in path_prof["vpt balls VPT"].items()),
             f"vpt balls launch counts {vblaunches}, want {want}")
    vb_twin = twin_equal(lambda c: vpt.VolumeRenderer(vbscene, c, seed=1),
                         vbcfg)
    say(f"phase 12 main path vpt balls {vbcfg.w}x{vbcfg.h} mb "
        f"{vbcfg.max_bounce}, {vbcfg.num_shadow_ray} shadow rays, schedule "
        f"{r.schedule}, {VBALLS_SPP} spp: "
        f"{1e3 * dt_vb / VBALLS_SPP:.2f} ms/spp; launches per spp "
        + ", ".join(f"{k} {n // VBALLS_SPP}"
                    for k, n in _shown(vblaunches).items())
        + " (profiler, a 64^2 pass at 3 bounces: "
        f"{_shown(path_prof['vpt balls VPT'])})"
        f"; image mean {vbimage.mean():.6f}, NaN pixel share {vb_nan}; "
        f"64^2 render equal to the twins' (max abs diff {vb_twin:.3g}) "
        f"[{card}]")

    # ---- 13. BDPT on bunny.xml at its own settings ----
    t0 = time.perf_counter()
    bunny_assets()
    buscene, bucfg, bu_tex = load_textured(cbox_dir, "bunny.xml")
    torch.cuda.synchronize()
    bu_load_s = time.perf_counter() - t0
    _require(buscene.n_prims == 65290 and bucfg.use_bvh
             and (bucfg.w, bucfg.h, bucfg.max_bounce,
                  bucfg.num_shadow_ray) == (800, 800, 10, 2)
             and bucfg.n_emitters == 3 and bucfg.world_scattering
             and sorted(bu_tex) == ["crystal", "lava", "mat"],
             f"bunny.xml settings ({buscene.n_prims} prims, {bucfg})")
    bgroups = B._strategy_groups(bucfg, bucfg.max_bounce)
    bQ = max(1, B.FLAT_LANES // bucfg.n_pixels)
    bchunks = {case: -(-len(rows) // bQ) for case, rows in bgroups.items()}
    # the closest hits _track_loop launches, counted apart from the walks'
    track_loop, track_b5a = vpt._track_loop, [0]

    def counted_track(*a, **kw):
        before = _build.launches["bvh_kernels"]["bvh_closest_hit"]
        try:
            return track_loop(*a, **kw)
        finally:
            track_b5a[0] += (_build.launches["bvh_kernels"]
                             ["bvh_closest_hit"] - before)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30   # earlier phases' own
    r = B.BDPT(buscene, bucfg, seed=0)
    r.render_batch(1)                         # warm-up sample, not timed
    vpt._track_loop = counted_track
    try:
        reset()
        dt_bu = timed_batch(r, BUNNY_SPP)
        bulaunches = counts()
    finally:
        vpt._track_loop = track_loop
    bu_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    buimage = r.image()
    _require(buimage.shape == (bucfg.h, bucfg.w, 3), f"shape {buimage.shape}")
    bu_nan = float(np.isnan(buimage).any(axis=-1).mean())
    _require(bu_nan == 0.0 and bool(np.isfinite(buimage).all())
             and buimage.mean() > 0.01,
             f"bunny BDPT: NaN share {bu_nan}, mean {buimage.mean()}")
    # two walks of max_bounce closest hits; one _track_loop step (one
    # closest hit) for each chunk of the t1, s1 and gen groups in which
    # some connection needs its transmittance: every surface blocks and a
    # miss ends at the target, so no lane takes a second step; one film
    # splat a pass; no brute-force kernel (65,290 triangles)
    bu_walks = BUNNY_SPP * 2 * bucfg.max_bounce
    want = {**none, "bvh_closest_hit": bu_walks + track_b5a[0],
            "splat_sorted_accumulate": BUNNY_SPP}
    _require(bulaunches == want and 0 < track_b5a[0] <= BUNNY_SPP * (
        bchunks["t1"] + bchunks["s1"] + bchunks["gen"]),
             f"bunny BDPT launch counts {bulaunches} ({track_b5a[0]} in "
             f"_track_loop), want {want}")
    # the same counts by the profiler, over one more spp
    bu_seen, bu_calls = profiled_launches(lambda: r.render_batch(1),
                                          "bunny BDPT", warm=True)
    _require(set(bu_seen) == {"bvh_closest_hit", "splat_sorted_accumulate"},
             f"bunny BDPT: the profiler saw {bu_seen} launches a pass")
    # B5a on the bunny's own walk rays: the eye walk's first closest hit
    # (primary rays) and the light walk's second (its first bounce),
    # bit-equal to the twin, with device time and bound
    mb_ = bucfg.max_bounce
    b5a_sets = recorded_rays(BK, "bvh_closest_hit", lambda: B.render_pass_bdpt(
        buscene, bucfg, rng.PRNGKey(5), 1), first=2 * mb_)
    bu_sets = {"eye primary": b5a_sets[0], "light bounce": b5a_sets[mb_ + 1]}
    del b5a_sets
    bu_tables = 4 * (buscene.bvh_node_pack.numel()
                     + buscene.bvh_prim_pack.numel())
    bu_rows = []
    for tag, (o, d, far) in bu_sets.items():
        got = BK.bvh_closest_hit(buscene, o, d, far)
        want_ = bvh.walk(buscene, o, d, far, stats=True)
        _require(all(torch.equal(a, b) for a, b in zip(got, want_[:4])),
                 f"bvh_closest_hit (bunny {tag} rays): not bit-equal to the "
                 "twin")
        n_ = o.shape[0]
        live = int((far > K.RAY_EPS).sum())
        visits, tests = int(want_[4].sum()), int(want_[5].sum())
        bu_rows.append((tag, n_, live, visits / max(live, 1),
                        tests / max(live, 1),
                        _graph_ms(torch, lambda: BK.bvh_closest_hit(
                            buscene, o, d, far)),
                        _bound(n_ * 28 + bu_tables + n_ * 16,
                               visits * bvh.NODE_OPS
                               + tests * bvh.PRIM_OPS)))
    del bu_sets
    # 64^2: the render with the twins in place; and without the textures,
    # which must differ on the textured floor
    # 64^2 with bunny.xml's own field of view (`_small` scales a 512^2
    # one); the twins at 3 bounces (their walk costs as much at 64^2 as at
    # 800^2: a step a node level, whatever the lanes)
    bsmall = dataclasses.replace(bucfg, w=64, h=64, end_x=64, end_y=64,
                                 focal=bucfg.focal * 64 / bucfg.w)
    btwin = dataclasses.replace(bsmall, max_bounce=TWIN_BOUNCES)
    ra = B.BDPT(buscene, btwin, seed=1)
    ra.render_batch(1)
    rb = B.BDPT(buscene, btwin, seed=1)
    with twins():
        rb.render_batch(1)
    bu_twin, _, _ = _check(ra.image(), rb.image())
    bu_eq = bool(torch.equal(ra.color, rb.color))
    untextured = dataclasses.replace(buscene, tex={
        k: dataclasses.replace(t, present=False)
        for k, t in buscene.tex.items()})
    bu_floor = floor_difference(
        torch, lambda scn, c: B.render_pass_bdpt(scn, c, rng.PRNGKey(3),
                                                 1)[0],
        buscene, untextured, bsmall, bu_tex["mat"])
    say(f"phase 13 main path bunny BDPT {bucfg.w}x{bucfg.h} mb "
        f"{bucfg.max_bounce}, {buscene.n_prims} triangles (BVH tier), "
        f"textures {sorted(bu_tex)} loaded (set-up {bu_load_s:.2f} s), "
        f"{sum(map(len, bgroups.values()))} strategies in chunks "
        f"{bchunks}, {BUNNY_SPP} spp: {1e3 * dt_bu / BUNNY_SPP:.2f} ms/spp "
        f"[{card}]; peak memory {bu_peak - held:.3f} GiB over the "
        f"{held:.3f} GiB earlier phases hold; launches per spp "
        + ", ".join(f"{k} {n // BUNNY_SPP}"
                    for k, n in _shown(bulaunches).items())
        + f" ({bu_walks // BUNNY_SPP} in the walks, "
        f"{track_b5a[0] / BUNNY_SPP:g} in _track_loop; profiler, one "
        f"spp: {bu_seen}, spp profiled {bu_calls}); B5a on the walk "
        "rays, bit-equal: " + "; ".join(
            f"{tag} {n_} rays ({live} live): device {ms:.4f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}), {v:.2f} node visits / {t:.2f} "
            f"prim tests a live ray"
            for tag, n_, live, v, t, ms, bd in bu_rows)
        + f"; image mean {buimage.mean():.6f}, NaN pixel share {bu_nan}; "
        f"64^2 max abs diff to twins at {TWIN_BOUNCES} bounces "
        f"{bu_twin:.3g} (equal: {bu_eq}); "
        f"64^2 textured vs untextured on the floor: mean abs diff "
        f"{bu_floor:.4f}")
    del r, ra, rb

    # ---- 14. PT on bunny.xml at its own settings ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    r = pt.Renderer(buscene, bucfg, seed=0)
    _require(r._auto, "bunny.xml is over the auto-compaction gate")
    r.render_batch(1)                         # warm-up sample (and probe)
    reset()
    dt_bp = timed_batch(r, BUNNY_PT_SPP)
    bplaunches, bprlaunches = counts(), _launches("rng")
    bpslaunches = _launches("shade_kernels")
    bp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bpimage = r.image()
    _require(bpimage.shape == (bucfg.h, bucfg.w, 3), f"shape {bpimage.shape}")
    bp_nan = float(np.isnan(bpimage).any(axis=-1).mean())
    _require(bp_nan == 0.0 and bool(np.isfinite(bpimage).all())
             and bpimage.mean() > 0.01,
             f"bunny PT: NaN share {bp_nan}, mean {bpimage.mean()}")
    want = {**none, "bvh_closest_hit": BUNNY_PT_SPP * bucfg.max_bounce,
            "bvh_any_hit": BUNNY_PT_SPP * bucfg.max_bounce
            * bucfg.num_shadow_ray}
    _require(bplaunches == want, f"bunny PT launch counts {bplaunches}, "
             f"want {want}")
    rwant = {"lane_uniform": BUNNY_PT_SPP * bucfg.max_bounce,
             "uniform": BUNNY_PT_SPP}
    _require(bprlaunches == rwant,
             f"bunny PT threefry launch counts {bprlaunches}, want {rwant}")
    swant = shade_want(bucfg, BUNNY_PT_SPP)
    _require(bpslaunches == swant,
             f"bunny PT shading launch counts {bpslaunches}, want {swant}")
    bp_seen, bp_calls = profiled_launches(lambda: r.render_batch(1),
                                          "bunny PT", warm=True)
    _require(bp_seen == {k: n // BUNNY_PT_SPP
                         for k, n in _shown(bplaunches).items()},
             f"bunny PT: the profiler saw {bp_seen} launches a pass")
    # B5b on the bunny's own shadow rays: the first any-hit call of one
    # full-size pass, bit-equal to the twin, with device time and bound
    (so, sd, sfar), = recorded_rays(
        BK, "bvh_any_hit", lambda: pt.render_pass_pt(
            buscene, bucfg, rng.PRNGKey(5), 1), first=1)
    occ = BK.bvh_any_hit(buscene, so, sd, sfar)
    want_ = bvh.walk(buscene, so, sd, sfar, any_hit=True, stats=True)
    _require(torch.equal(occ, want_[1] >= 0)
             and not bool(occ[~(sfar > K.RAY_EPS)].any()),
             "bvh_any_hit (bunny shadow rays): occlusion differs from the "
             "twin")
    n_, live = so.shape[0], int((sfar > K.RAY_EPS).sum())
    visits, tests = int(want_[4].sum()), int(want_[5].sum())
    bp_b5b = (n_, live, int(occ.sum()) / max(live, 1), visits / max(live, 1),
              tests / max(live, 1),
              _graph_ms(torch, lambda: BK.bvh_any_hit(buscene, so, sd, sfar)),
              _bound(n_ * 28 + bu_tables + n_,
                     visits * bvh.NODE_OPS + tests * bvh.PRIM_OPS))
    del so, sd, sfar, occ, want_
    bp_twin = twin_equal(lambda c: pt.Renderer(buscene, c, seed=1), bucfg,
                         btwin)
    bp_floor = floor_difference(
        torch, lambda scn, c: pt.render_pass_pt(scn, c, rng.PRNGKey(3), 1),
        buscene, untextured, bsmall, bu_tex["mat"])
    say(f"phase 14 main path bunny PT {bucfg.w}x{bucfg.h} mb "
        f"{bucfg.max_bounce}, {bucfg.num_shadow_ray} shadow rays, schedule "
        f"{r._sched}, {BUNNY_PT_SPP} spp: "
        f"{1e3 * dt_bp / BUNNY_PT_SPP:.2f} ms/spp [{card}]; peak memory "
        f"{bp_peak - held:.3f} GiB over the {held:.3f} GiB earlier phases "
        "hold; launches per spp "
        + ", ".join(f"{k} {n // BUNNY_PT_SPP}"
                    for k, n in _shown(bplaunches).items())
        + f", threefry {bprlaunches} and shading {bpslaunches} in all"
        + f" (profiler, one spp: {bp_seen}, spp profiled {bp_calls}); B5b "
        f"on the first shadow rays of a pass, bit-equal: {bp_b5b[0]} rays "
        f"({bp_b5b[1]} live, "
        f"{bp_b5b[2]:.4f} of them occluded): device {bp_b5b[5]:.4f} ms, "
        f"bound {bp_b5b[6][0]:.4f} ms ({bp_b5b[6][1]}), {bp_b5b[3]:.2f} "
        f"node visits / {bp_b5b[4]:.2f} prim tests a live ray; image mean "
        f"{bpimage.mean():.6f}, NaN pixel share {bp_nan}; 64^2 render at "
        f"{TWIN_BOUNCES} bounces equal to the twins' (max abs diff "
        f"{bp_twin:.3g}); 64^2 textured "
        f"vs untextured on the floor: mean abs diff {bp_floor:.4f}")
    del r

    # ---- 15-18. grid volumes and ite-orb at the scenes' own settings ----
    def path_run(make, spp, warm=True):
        """A renderer from make(), a warm-up spp when warm, then spp
        samples timed with the kernels counted and every tracking call of
        the grid volume recorded (`record_marches`), then one more spp
        under the profiler (`device_work`). The image must be finite with
        no NaN pixel. Returns a dict: the renderer, s/spp, launches, peak
        GiB over what earlier phases hold and that, the tracking calls,
        device busy ms and kernels of the profiled spp, the image."""
        r = make()
        if warm:
            r.render_batch(1)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        reset()
        with V.record_marches() as calls:
            dt = timed_batch(r, spp)
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
        busy, nk, _top = device_work(torch, lambda: r.render_batch(1))
        img = r.image()
        nan = float(np.isnan(img).any(axis=-1).mean())
        _require(img.shape == (r.cfg.h, r.cfg.w, 3) and nan == 0.0
                 and bool(np.isfinite(img).all()) and img.mean() > 0.01,
                 f"image shape {img.shape}, NaN share {nan}, mean "
                 f"{img.mean()}")
        return dict(r=r, s=dt / spp, launches=launches, peak=peak,
                    held=held, calls=calls, busy=busy, nk=nk, img=img)

    def perf_text(res, spp):
        return (f"{1e3 * res['s']:.2f} ms/spp [{card}]; one more spp "
                f"profiled: device busy {res['busy']:.2f} ms, idle share "
                f"{1 - res['busy'] / (1e3 * res['s']):.3f}, {res['nk']} "
                f"kernels; peak memory {res['peak']:.3f} GiB over the "
                f"{res['held']:.3f} GiB earlier phases hold; launches per "
                "spp " + ", ".join(f"{k} {n / spp:g}" for k, n in
                                   _shown(res["launches"]).items())
                + f"; image mean {res['img'].mean():.6f}, no NaN pixel")

    def march_text(res, spp):
        calls = res["calls"]
        lanes = sum(c["lanes"] for c in calls)
        cross = sum(c["crossing"] for c in calls)
        _require(cross > 0, "no lane crossed the grid volume")
        _require(all(c["steps"] > 0 and c["s"] > 0 for c in calls
                     if c["crossing"]),
                 "a tracking call with crossing lanes recorded no march")
        march_s = sum(c["s"] for c in calls)
        return (f"march: {len(calls) / spp:g} tracking calls and "
                f"{sum(c['steps'] for c in calls) / spp:g} steps an spp, "
                f"{cross / lanes:.4f} of their {lanes / spp:.0f} lanes an "
                f"spp cross the grid, up to "
                f"{max(c['rounds'] for c in calls)} rounds "
                f"({sum(c['rounds'] > 1 for c in calls) / spp:g} calls an "
                f"spp in two or more), {march_s / (res['s'] * spp):.3f} of "
                "the pass's wall time")

    def tri_on_path(scn, run):
        """B1 on the first two closest-hit calls of run(), a full-size
        pass (primary rays, the first bounce), and B3 on its first media
        walk (shadow rays), each bit-equal to its twin: [(what, rays,
        walking, device ms, bound)]."""
        b1 = []
        b3 = recorded_rays(K, "tri_track_hits", lambda: b1.extend(
            recorded_rays(K, "tri_closest_hit", run, first=2)), first=1)
        _require(len(b1) == 2 and len(b3) == 1,
                 f"{len(b1)} closest hits, {len(b3)} media walks recorded")
        T, rows = scn.tri_n.shape[0], []
        for tag, (o, d, far) in zip(("B1 primary", "B1 bounce"), b1):
            got = K.tri_closest_hit(scn, o, d, far)
            want = K.tri_closest_hit_plain(scn, o, d, far)
            _require(all(a.dtype == b.dtype and torch.equal(a, b)
                         for a, b in zip(got, want)),
                     f"tri_closest_hit ({tag} rays): not bit-equal to the "
                     "twin")
            n_ = o.shape[0]
            rows.append((tag, n_, int((far > K.RAY_EPS).sum()), _graph_ms(
                torch, lambda: K.tri_closest_hit(scn, o, d, far)), _bound(
                _ray_bytes(K, far) + T * 64 + n_ * 32, _split_ops(
                    *closest_work(torch, K, scn, o, d, far)[:3]))))
        (o, d, far, k, all_null), = b3
        got = K.tri_track_hits(scn, o, d, far, k, all_null)
        want = K.tri_track_hits_plain(scn, o, d, far, k,
                                      K.null_flags(scn, all_null))
        _require(all(a.dtype == b.dtype and torch.equal(a, b)
                     for a, b in zip(got, want)),
                 "tri_track_hits (shadow rays): differs from the twin")
        n_ = o.shape[0]
        rows.append(("B3 shadow", n_, int((far > K.RAY_EPS).sum()),
                     _graph_ms(torch, lambda: K.tri_track_hits(
                         scn, o, d, far, k, all_null)),
                     _bound(_ray_bytes(K, far) + T * 68 + n_ * (12 * k + 13),
                            _split_ops(*track_work(torch, K, scn, o, d, far,
                                                   all_null)))))
        return rows

    def kernel_text(rows):
        return "; ".join(f"{tag} {n_} rays ({w} walking): device {ms:.4f} "
                         f"ms, bound {bd[0]:.4f} ms ({bd[1]})"
                         for tag, n_, w, ms, bd in rows)

    vol_launches = dict(none)
    for tag, file, scn, c, spp, settings in (
            ("15", "cbox-rgbvol.xml", rg_scene, rg_cfg, RGBVOL_SPP,
             (512, 512, 32, 1, 2)),
            ("16", "cbox-volgrid.xml", vg_scene, vg_cfg, VOLGRID_SPP,
             (640, 640, 12, 2, 1))):
        _require((c.w, c.h, c.max_bounce, c.num_shadow_ray, c.volume_kind)
                 == settings and not c.has_null_bsdf and scn.n_prims == 16,
                 f"phase {tag} scene settings {c}")
        res = path_run(lambda: vpt.VolumeRenderer(scn, c, seed=0), spp)
        # one closest hit an iteration (the first before the loop), one
        # media walk a shadow ray (no null surface: no overflow walk)
        want = {**none, "tri_closest_hit": spp * c.max_bounce,
                "tri_track_hits": spp * c.max_bounce * c.num_shadow_ray}
        _require(res["launches"] == want,
                 f"phase {tag} launch counts {res['launches']}, want {want}")
        for k, n in res["launches"].items():
            vol_launches[k] += n
        v_rows = tri_on_path(scn, lambda: vpt.render_pass_vpt(
            scn, c, rng.PRNGKey(5), 1))
        v_twin = twin_equal(lambda c_: vpt.VolumeRenderer(scn, c_, seed=1),
                            c)
        say(f"phase {tag} main path VPT {file} "
            f"{c.w}x{c.h} mb {c.max_bounce}, {c.num_shadow_ray} shadow "
            f"ray(s), volume kind {c.volume_kind}, schedule "
            f"{res['r'].schedule}, {spp} spp: " + perf_text(res, spp)
            + "; " + march_text(res, spp) + "; on the first calls of a "
            "pass, bit-equal to the twins: " + kernel_text(v_rows)
            + f"; 64^2 render equal to the twins' (max abs diff "
            f"{v_twin:.3g})")
        del res

    # ---- 17. BDPT on cbox-volgrid.xml ----
    vb_cfg = dataclasses.replace(vg_cfg, max_bounce=VOLGRID_BDPT_BOUNCES)
    vgroups = B._strategy_groups(vb_cfg, vb_cfg.max_bounce)
    vQ = max(1, B.FLAT_LANES // vb_cfg.n_pixels)
    vchunks = {case: -(-len(rows) // vQ) for case, rows in vgroups.items()}
    # the groups the JAX package scans (more than FLAT_MAX_CHUNKS chunks):
    # each strategy's own ratio-tracking key and march, sums in turn
    vscan = {case: len(rows) for case, rows in vgroups.items()
             if B.scan_form(len(rows), vb_cfg.n_pixels)}
    _require(vscan.get("gen") == 66 and vchunks["gen"] == 7,
             f"phase 17 scan-form groups {vscan}, chunks {vchunks}")
    res = path_run(lambda: B.BDPT(vg_scene, vb_cfg, seed=0),
                   VOLGRID_BDPT_SPP, warm=False)
    # two walks of max_bounce closest hits; one media walk (and one ratio
    # tracking) for each chunk of the t1, s1 and gen groups; one splat
    want = {**none,
            "tri_closest_hit": VOLGRID_BDPT_SPP * 2 * vb_cfg.max_bounce,
            "tri_track_hits": VOLGRID_BDPT_SPP * (
                vchunks["t1"] + vchunks["s1"] + vchunks["gen"]),
            "splat_sorted_accumulate": VOLGRID_BDPT_SPP}
    _require(res["launches"] == want,
             f"phase 17 launch counts {res['launches']}, want {want}")
    for k, n in res["launches"].items():
        vol_launches[k] += n
    tw_cfg = _small(vb_cfg, 64, max_bounce=TWIN_BOUNCES)
    ra = B.BDPT(vg_scene, tw_cfg, seed=1)
    ra.render_batch(1)
    rb = B.BDPT(vg_scene, tw_cfg, seed=1)
    with twins():
        rb.render_batch(1)
    vb_twin, _, _ = _check(ra.image(), rb.image())
    vb_equal = bool(torch.equal(ra.color, rb.color))
    # every group in the scan form at 64^2: B1, B3 and B4 under it against
    # their plain versions
    saved_chunks, B.FLAT_MAX_CHUNKS = B.FLAT_MAX_CHUNKS, 0
    try:
        ra = B.BDPT(vg_scene, tw_cfg, seed=1)
        reset()
        ra.render_batch(1)
        scan_launches = counts()
        rb = B.BDPT(vg_scene, tw_cfg, seed=1)
        with twins():
            rb.render_batch(1)
    finally:
        B.FLAT_MAX_CHUNKS = saved_chunks
    _require(all(scan_launches[k] > 0 for k in (
        "tri_closest_hit", "tri_track_hits", "splat_sorted_accumulate")),
             f"phase 17 scan-form twins launches {scan_launches}")
    vs_twin, _, _ = _check(ra.image(), rb.image())
    say(f"phase 17 main path BDPT cbox-volgrid.xml {vb_cfg.w}x{vb_cfg.h} "
        f"mb {vb_cfg.max_bounce} (the scene's: {vg_cfg.max_bounce}), "
        f"{sum(map(len, vgroups.values()))} strategies in chunks {vchunks}, "
        f"in the scan form (strategies) {vscan}, "
        f"{VOLGRID_BDPT_SPP} spp, no warm-up: "
        + perf_text(res, VOLGRID_BDPT_SPP) + "; "
        + march_text(res, VOLGRID_BDPT_SPP) + f"; 64^2 at {TWIN_BOUNCES} "
        f"bounces: max abs diff to twins {vb_twin:.3g} (equal: {vb_equal}), "
        f"every group in the scan form (FLAT_MAX_CHUNKS 0, launches "
        f"{_shown(scan_launches)}): {vs_twin:.3g} (equal: "
        f"{bool(torch.equal(ra.color, rb.color))})")
    del res, ra, rb

    # ---- 18. PT on ite-orb.xml at its own settings ----
    t0 = time.perf_counter()
    orb_assets()
    oscene, ocfg, otex = load_textured(cbox_dir, "ite-orb.xml")
    torch.cuda.synchronize()
    orb_load_s = time.perf_counter() - t0
    _require(oscene.n_prims == 480004 and ocfg.use_bvh
             and (ocfg.w, ocfg.h, ocfg.max_bounce, ocfg.num_shadow_ray)
             == (681, 629, 24, 1) and sorted(otex) == ["back-door",
                                                        "crystal"],
             f"ite-orb.xml settings ({oscene.n_prims} prims, {ocfg})")
    res = path_run(lambda: pt.Renderer(oscene, ocfg, seed=0), ORB_SPP)
    _require(res["r"]._auto, "ite-orb is over the auto-compaction gate")
    want = {**none, "bvh_closest_hit": ORB_SPP * ocfg.max_bounce,
            "bvh_any_hit": ORB_SPP * ocfg.max_bounce * ocfg.num_shadow_ray}
    _require(res["launches"] == want,
             f"ite-orb launch counts {res['launches']}, want {want}")
    orb_launches = res["launches"]
    # B5a and B5b on ite-orb's own rays: the first closest-hit call
    # (primary rays) and the first shadow-ray call of a full-size pass,
    # bit-equal to the plain walks, with device time and bound
    o_any = []
    o_closest = recorded_rays(BK, "bvh_closest_hit", lambda: o_any.extend(
        recorded_rays(BK, "bvh_any_hit", lambda: pt.render_pass_pt(
            oscene, ocfg, rng.PRNGKey(5), 1), first=1)), first=1)
    o_tables = 4 * (oscene.bvh_node_pack.numel()
                    + oscene.bvh_prim_pack.numel())
    (o, d, far), = o_closest
    got = BK.bvh_closest_hit(oscene, o, d, far)
    want_ = bvh.walk(oscene, o, d, far, stats=True)
    _require(all(torch.equal(a, b) for a, b in zip(got, want_[:4])),
             "bvh_closest_hit (ite-orb primary rays): not bit-equal to the "
             "twin")
    n_, live = o.shape[0], int((far > K.RAY_EPS).sum())
    visits, tests = int(want_[4].sum()), int(want_[5].sum())
    o_b5a = (n_, live, visits / max(live, 1), tests / max(live, 1),
             _graph_ms(torch, lambda: BK.bvh_closest_hit(oscene, o, d, far)),
             _bound(n_ * 28 + o_tables + n_ * 16,
                    visits * bvh.NODE_OPS + tests * bvh.PRIM_OPS))
    del o_closest, o, d, far, got, want_
    (so, sd, sfar), = o_any
    occ = BK.bvh_any_hit(oscene, so, sd, sfar)
    want_ = bvh.walk(oscene, so, sd, sfar, any_hit=True, stats=True)
    _require(torch.equal(occ, want_[1] >= 0)
             and not bool(occ[~(sfar > K.RAY_EPS)].any()),
             "bvh_any_hit (ite-orb shadow rays): occlusion differs from the "
             "twin")
    n_, live = so.shape[0], int((sfar > K.RAY_EPS).sum())
    visits, tests = int(want_[4].sum()), int(want_[5].sum())
    o_b5b = (n_, live, int(occ.sum()) / max(live, 1), visits / max(live, 1),
             tests / max(live, 1),
             _graph_ms(torch, lambda: BK.bvh_any_hit(oscene, so, sd, sfar)),
             _bound(n_ * 28 + o_tables + n_,
                    visits * bvh.NODE_OPS + tests * bvh.PRIM_OPS))
    del o_any, so, sd, sfar, occ, want_
    # 64^2 with ite-orb's own field of view, the twins at 3 bounces
    o_twin = twin_equal(
        lambda c: pt.Renderer(oscene, c, seed=1), ocfg,
        dataclasses.replace(ocfg, w=64, h=64, end_x=64, end_y=64,
                            focal=ocfg.focal * 64 / ocfg.w,
                            max_bounce=TWIN_BOUNCES))
    say(f"phase 18 main path PT ite-orb.xml {ocfg.w}x{ocfg.h} mb "
        f"{ocfg.max_bounce}, {oscene.n_prims} triangles (BVH tier), "
        f"textures {sorted(otex)} loaded (set-up {orb_load_s:.2f} s), "
        f"schedule {res['r']._sched}, {ORB_SPP} spp: "
        + perf_text(res, ORB_SPP) + f"; B5a on the primary rays of a pass, "
        f"bit-equal: {o_b5a[0]} rays ({o_b5a[1]} live): device "
        f"{o_b5a[4]:.4f} ms, bound {o_b5a[5][0]:.4f} ms ({o_b5a[5][1]}), "
        f"{o_b5a[2]:.2f} node visits / {o_b5a[3]:.2f} prim tests a live "
        f"ray; B5b on its first shadow rays, bit-equal: {o_b5b[0]} rays "
        f"({o_b5b[1]} live, {o_b5b[2]:.4f} of them occluded): device "
        f"{o_b5b[5]:.4f} ms, bound {o_b5b[6][0]:.4f} ms ({o_b5b[6][1]}), "
        f"{o_b5b[3]:.2f} node visits / {o_b5b[4]:.2f} prim tests a live "
        f"ray; 64^2 render at {TWIN_BOUNCES} bounces equal to the twins' "
        f"(max abs diff {o_twin:.3g})")
    del res, oscene

    # ---- 19. the CLI on the card, in subprocesses ----
    def cli(*args):
        """`python -m adapt_tpu_torch.render` from the repository's root
        (scene paths resolve against it): (stdout, seconds)."""
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "adapt_tpu_torch.render",
             "--output_path", cli_out, "--no_watermark", *args],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        _require(p.returncode == 0 and "device=cuda (" in p.stdout
                 and "volume file" not in p.stderr,
                 f"the CLI {args}: exit {p.returncode}, stdout "
                 f"{p.stdout[-1500:]}, stderr {p.stderr[-1500:]}")
        # "done: N spp in Ts (...) on DEVICE": N counts a resumed
        # checkpoint's passes; T is this process's render with its set-up
        done = [ln.split() for ln in p.stdout.splitlines()
                if ln.startswith("done:")][-1]
        passes = int(args[args.index("--iter_num") + 1])
        sec = float(done[4].rstrip("s"))
        return (f"{done[1]} spp counted, {passes} passes in {sec:.2f} s "
                f"({1e3 * sec / passes:.1f} ms/spp with the set-up) on "
                f"{' '.join(done[8:])}", time.perf_counter() - t0)

    def ckpt(name):
        import pickle
        with open(os.path.join(ROOT, "checkpoint", name), "rb") as fh:
            return pickle.load(fh)["counter"]
    cli_out = os.path.join(ROOT, "build", "chip_smoke", "cli")
    for name in ("smoke_pt-cbox-pt-512x512.pkl",
                 "smoke_vpt-cbox-vpt-640x640.pkl"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(ROOT, "checkpoint", name))
    pt_args = ("--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
               "--img_name", "smoke_pt")
    c1 = cli(*pt_args, "--iter_num", "4")
    _require(os.path.exists(os.path.join(cli_out, "smoke_pt.png"))
             and ckpt("smoke_pt-cbox-pt-512x512.pkl") == 4,
             "the CLI's PT image or checkpoint")
    c2 = cli(*pt_args, "--iter_num", "2", "-l")
    _require(ckpt("smoke_pt-cbox-pt-512x512.pkl") == 6,
             "the CLI's resumed PT checkpoint")
    c3 = cli("--scene", "cbox", "--name", "cbox-volgrid.xml", "--type",
             "vpt", "--iter_num", "2", "--img_name", "smoke_vpt")
    _require(os.path.exists(os.path.join(cli_out, "smoke_vpt.png"))
             and ckpt("smoke_vpt-cbox-vpt-640x640.pkl") == 2,
             "the CLI's VPT image or checkpoint")
    say("phase 19 the CLI on the card (python -m adapt_tpu_torch.render, "
        "each in a process of its own): " + "; ".join(
            f"{what}: {line} (process {sec:.1f} s)" for what, (line, sec) in
            (("PT cbox 512^2 4 passes", c1), ("-l: 2 more, counter 6", c2),
             ("VPT cbox-volgrid 640^2 2 passes", c3))) + f" [{card}]")

    # ---- 20. differentiable PT at the flagship's width ----
    gcfg = dataclasses.replace(cfg, use_rr=False, anti_alias=False,
                               stratified_sampling=False)
    gkey = rng.PRNGKey(42)

    def gloss(sc, c, kd=1.0, emit=1.0):
        """tests/test_grad.py's loss: the mean radiance of 2 spp."""
        s_ = dataclasses.replace(sc, mat_kd=sc.mat_kd * kd,
                                 emit_intensity=sc.emit_intensity * emit)
        return pt.render_batch_pt(s_, c, gkey, 1, 2).mean()

    def ggrads(sc, c):
        """(loss, d/d albedo scale, d/d emitter scale, (O,3) d/d mat_kd)."""
        a = torch.tensor(1.0, device=dev, requires_grad=True)
        e = torch.tensor(1.0, device=dev, requires_grad=True)
        kd = sc.mat_kd.clone().requires_grad_(True)
        val = gloss(dataclasses.replace(sc, mat_kd=kd), c, a, e)
        val.backward()
        return (val.item(), a.grad.item(), e.grad.item(),
                (kd.grad * 1.0).cpu().numpy())

    ggrads(scene, gcfg)                       # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    a = torch.tensor(1.0, device=dev, requires_grad=True)
    e = torch.tensor(1.0, device=dev, requires_grad=True)
    kd = scene.mat_kd.clone().requires_grad_(True)
    val = gloss(dataclasses.replace(scene, mat_kd=kd), gcfg, a, e)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    val.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    glaunches, gslaunches = counts(), _launches("shade_kernels")
    gpeak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
    g_val, g_kd, g_emit = val.item(), a.grad.item(), e.grad.item()
    g_mat = kd.grad.cpu().numpy()
    del val, a, e, kd
    want = {**none, "tri_closest_hit": 2 * gcfg.max_bounce,
            "tri_any_hit": 2 * gcfg.max_bounce * gcfg.num_shadow_ray}
    _require(glaunches == want, f"phase 20 launches {glaunches}, want {want}")
    # the forward shades through the kernels (the backward is the plain
    # arms' vector-Jacobian product, ops/shade_kernels.py `_Replay`)
    swant = shade_want(gcfg, 2)
    _require(gslaunches == swant,
             f"phase 20 shading launches {gslaunches}, want {swant}")
    gseen, gcalls = profiled_launches(lambda: ggrads(scene, gcfg),
                                      "phase 20 forward and backward",
                                      warm=True)
    # the backward alone on the card: device busy, kernels, the largest
    a = torch.tensor(1.0, device=dev, requires_grad=True)
    e = torch.tensor(1.0, device=dev, requires_grad=True)
    kd = scene.mat_kd.clone().requires_grad_(True)
    val = gloss(dataclasses.replace(scene, mat_kd=kd), gcfg, a, e)
    bw_busy, bw_n, bw_top = device_work(torch, val.backward)
    del val, a, e, kd
    h = 1e-2
    with torch.no_grad():
        fd_kd = (gloss(scene, gcfg, 1 + h).item()
                 - gloss(scene, gcfg, 1 - h).item()) / (2 * h)
        fd_emit = (gloss(scene, gcfg, 1.0, 1 + h).item()
                   - gloss(scene, gcfg, 1.0, 1 - h).item()) / (2 * h)
    _require(g_kd > 0 and g_emit > 0 and abs(g_kd - fd_kd) <= 2e-2 * fd_kd
             and abs(g_emit - fd_emit) <= 2e-2 * fd_emit,
             f"phase 20 gradients {g_kd}, {g_emit} vs central differences "
             f"{fd_kd}, {fd_emit}")
    _require(abs(g_emit - g_val) <= 1e-5 * g_val,
             f"phase 20 g_emit {g_emit} vs loss {g_val}")
    o, ch = np.unravel_index(np.argmax(g_mat), g_mat.shape)
    he = torch.zeros_like(scene.mat_kd)
    he[o, ch] = 5e-3
    with torch.no_grad():
        fd_mat = (gloss(dataclasses.replace(scene, mat_kd=scene.mat_kd + he),
                        gcfg).item()
                  - gloss(dataclasses.replace(scene,
                                              mat_kd=scene.mat_kd - he),
                          gcfg).item()) / 1e-2
    _require(bool(np.isfinite(g_mat).all()) and g_mat.min() >= -1e-6
             and abs(g_mat[o, ch] - fd_mat) <= 3e-2 * abs(fd_mat),
             f"phase 20 mat_kd gradient min {g_mat.min()}, entry "
             f"{g_mat[o, ch]} vs central difference {fd_mat}")
    # the same gradients with the plain twins in place of B1 and B2
    g64 = _small(gcfg, 64, max_bounce=3)
    gk = ggrads(scene, g64)
    with twins():
        gt = ggrads(scene, g64)
    twin_rel = max(abs(x - y) / max(abs(y), 1e-12)
                   for x, y in zip(gk[:3], gt[:3]))
    twin_mat = float(np.abs(gk[3] - gt[3]).max())
    _require(twin_rel <= 1e-6 and twin_mat <= 1e-7,
             f"phase 20 64^2 gradients with the kernels {gk[:3]} vs the "
             f"twins {gt[:3]}, (O,3) max abs diff {twin_mat}")
    # parameters that move rays, so their gradients run through where the
    # next hit lies (B1's hit re-evaluated on its prim, B3's media walk
    # differentiated through B1): mat_ks and mat_kg on two csphere scenes,
    # the media's coefficients through VPT, held to the JAX package's
    # derivatives that tests/test_torch_grad_shading.py wrote, at that
    # file's bounds (the excess is 1 at a bound)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_grad_shading as TS      # imports no JAX
    ts_golden = dict(np.load(TS.GOLDEN))
    reset()
    t3 = time.perf_counter()
    mv_excess = {n: TS.material_excess(ts_golden, n,
                                       *TS.material_grads(n, dev))
                 for n in TS.PT_SCENES}
    mv_excess["vpt cbox"] = TS.media_excess(ts_golden, *TS.media_grads(dev))
    mv_s = time.perf_counter() - t3
    mv_launches = counts()
    _require(all(v <= 1.0 for v in mv_excess.values())
             and mv_launches["tri_closest_hit"] > 0
             and mv_launches["tri_track_hits"] > 0,
             f"phase 20 ray-moving gradients vs the JAX package's: excess "
             f"{mv_excess}, launches {mv_launches}")
    # recovery of an albedo scale of 0.7 by gradient descent; the step
    # 0.5 / g^2 (g the slope at scale 1) keeps it from overshooting at
    # this depth
    with torch.no_grad():
        target = gloss(scene, gcfg, 0.7).item()
    step, sc_ = 0.5 / g_kd ** 2, 1.0
    t3 = time.perf_counter()
    for _ in range(40):
        a = torch.tensor(sc_, device=dev, requires_grad=True)
        ((gloss(scene, gcfg, a) - target) ** 2).backward()
        sc_ -= step * a.grad.item()
    rec_s = time.perf_counter() - t3
    _require(abs(sc_ - 0.7) < 0.02, f"phase 20 recovered scale {sc_}")
    say(f"phase 20 differentiable PT cbox {gcfg.w}x{gcfg.h} mb "
        f"{gcfg.max_bounce}, 2 spp, no RR, key 42: loss {g_val:.6f}, "
        f"d/d albedo scale {g_kd:.6f} (central difference {fd_kd:.6f}), "
        f"d/d emitter scale {g_emit:.6f} (central difference "
        f"{fd_emit:.6f}; == loss within {abs(g_emit - g_val) / g_val:.2g}), "
        f"(O,3) mat_kd largest entry {g_mat[o, ch]:.6f} vs {fd_mat:.6f}, "
        f"min {g_mat.min():.3g}; forward {1e3 * (t1 - t0):.1f} ms, "
        f"backward {1e3 * (t2 - t1):.1f} ms, peak {gpeak:.2f} GiB over "
        f"{held:.2f} GiB held [{card}]; the backward's device busy "
        f"{bw_busy:.1f} ms in {bw_n} kernels, most {bw_top}; launches "
        f"{_shown(glaunches)}, the "
        f"profiler's {gseen} ({gcalls} call); 64^2 mb 3 kernels vs twins: "
        f"scalars {twin_rel:.3g} relative, (O,3) {twin_mat:.3g}; 40-step "
        f"recovery of 0.7: {sc_:.5f} in {rec_s:.1f} s; ray-moving "
        f"gradients at 24^2 mb 3 (mat_ks, mat_kg of balls-multi and "
        f"mix-balls, vpt cbox media) vs the JAX package's, in units of "
        f"the bounds: "
        f"{ {n: float(f'{v:.3g}') for n, v in mv_excess.items()} } in "
        f"{mv_s:.1f} s, launches {_shown(mv_launches)}")

    # ---- 21. density-grid recovery through ratio tracking ----
    from adapt_tpu_torch import recover_volume as RV
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, true, init, curve = RV.recover(4096, 200, 0.15, seed=11,
                                        device=dev)
    torch.cuda.synchronize()
    rv_s = time.perf_counter() - t0
    rv_err, rv_corr = RV.interior_error(rec, true)
    _require(rv_err < 0.05 * RV.A and rv_corr > 0.99,
             f"phase 21 recovery: interior error {rv_err}, correlation "
             f"{rv_corr}")
    fro, frd = RV.rays(256, 1, dev)
    probe = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (RV.R,) * 3).astype(np.float32)).to(dev)

    def eps_loss(eps):
        g_ = torch.clamp(RV.true_grid(dev) + eps * probe * 0.02, 0.0,
                         RV.BOUND)
        return RV.transmittance(g_, fro, frd, rng.PRNGKey(7)).mean()
    eps = torch.tensor(0.0, device=dev, requires_grad=True)
    eps_loss(eps).backward()
    with torch.no_grad():
        rv_fd = (eps_loss(0.05).item() - eps_loss(-0.05).item()) / 0.1
    _require(abs(eps.grad.item() - rv_fd) <= 1e-5 + 5e-2 * abs(rv_fd),
             f"phase 21 gradient {eps.grad.item()} vs central difference "
             f"{rv_fd}")
    say(f"phase 21 density-grid recovery ({RV.R}^3, 4096 rays, DIFF_STEPS "
        f"{RV.STEPS}, 200 Adam steps at lr 0.15, key 11): interior mean "
        f"error {rv_err:.3g} ({rv_err / RV.A:.3g} A), correlation "
        f"{rv_corr:.6f}, loss {curve[0]:.3g} -> {curve[-1]:.3g} in "
        f"{rv_s:.1f} s ({1e3 * rv_s / 200:.1f} ms a step) [{card}]; 256 "
        f"rays: gradient {eps.grad.item():.6g} vs central difference "
        f"{rv_fd:.6g}")

    # ---- 22. multi-device rendering ----
    from adapt_tpu_torch.parallel import sharding as SH
    from adapt_tpu_torch.renderer.vpt import trace_vpt
    multi_out = os.path.join(ROOT, "build", "chip_smoke", "multi")

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_ranks import shard_film    # imports no JAX

    def shard_films(world):
        """Phase 22's films by the single-process passes of every shard,
        with multi_rank's meshes and the shard keys (seed 3, one
        render)."""
        _, sub = rng.split(rng.PRNGKey(3))
        return {name: shard_film(sc, c, sub, n_spp, world // n_spp,
                                 trace).cpu().numpy()
                for name, sc, c, n_spp, trace in (
                    ("pt", scene, cfg, 1, pt.trace_pt),
                    ("vpt", vg_scene, vg_cfg, world, trace_vpt),
                    ("bdpt", scene, bcfg, 1, None))}

    def multi(world, backend):
        """Phase 22's ranks; returns ({case: film}, {case: launches summed
        over ranks}, {case: rank 0's seconds})."""
        import shutil
        shutil.rmtree(multi_out, ignore_errors=True)
        os.makedirs(multi_out)
        SH.run_ranks(multi_rank, world, multi_out, device="cuda",
                     backend=backend)
        ranks = [np.load(os.path.join(multi_out, f"rank{r}.npz"))
                 for r in range(world)]
        films = {n: ranks[0][n] for n in MULTI_CASES}
        for rk in ranks[1:]:
            for n in MULTI_CASES:
                _require(np.array_equal(rk[n], films[n]),
                         f"phase 22 {backend}: rank films differ ({n})")
        lsum = {n: {k: sum(int(rk[f"{n}:{k}"]) for rk in ranks)
                    for k in KERNELS if f"{n}:{k}" in ranks[0]}
                for n in MULTI_CASES}
        return films, lsum, {n: float(ranks[0][n + "_s"])
                             for n in MULTI_CASES}, str(ranks[0]["backend"])

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    m_films, m_launches, m_s, m_backend = multi(n_cards, None)   # NCCL
    _require(m_backend == "nccl", f"phase 22: backend {m_backend}")
    nccl_s = time.perf_counter() - t0
    ref = shard_films(n_cards)
    m_err = {n: float(np.abs(m_films[n] - ref[n]).max()) for n in ref}
    _require(all(v == 0.0 for v in m_err.values()),
             f"phase 22 NCCL films vs the single-process shards: {m_err}")
    t0 = time.perf_counter()
    g_films, g_launches, g_s, _ = multi(2, "gloo")   # two ranks, one card
    gloo_s = time.perf_counter() - t0
    ref2 = shard_films(2)
    g_err = {n: float(np.abs(g_films[n] - ref2[n]).max()) for n in ref2}
    _require(all(v == 0.0 for v in g_err.values()),
             f"phase 22 gloo films vs the single-process shards: {g_err}")
    mlaunch_sum = {k: sum(d.get(k, 0) for d in (*m_launches.values(),
                                                *g_launches.values()))
                   for k in KERNELS}
    _require(all(mlaunch_sum[k] > 0 for k in (
        "tri_closest_hit", "tri_any_hit", "tri_track_hits",
        "splat_sorted_accumulate")), f"phase 22 launches {mlaunch_sum}")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "adapt_tpu_torch.render", "--output_path",
         cli_out, "--no_watermark", "--scene", "cbox", "--name", "cbox.xml",
         "--type", "pt", "--multichip", "-1", "--iter_num", "2",
         "--img_name", "smoke_multi"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    mcli_s = time.perf_counter() - t0
    _require(p.returncode == 0 and "multichip mesh" in p.stdout
             and os.path.exists(os.path.join(cli_out, "smoke_multi.png")),
             f"the CLI --multichip -1: exit {p.returncode}, stdout "
             f"{p.stdout[-1500:]}, stderr {p.stderr[-1500:]}")
    mesh_line = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("multichip mesh")][0]
    def ms(secs):
        return ", ".join(f"{n} {1e3 * secs[n]:.1f} ms" for n in MULTI_CASES)
    say(f"phase 22 multi-device: {m_backend} over {n_cards} card(s) (an "
        f"all_reduce and an all_gather over the world checked), one render "
        f"each (a rank's first, cold) of PT cbox 512^2 mb 8, VPT "
        f"cbox-volgrid {vg_cfg.w}^2 and BDPT cbox mb 6: {ms(m_s)}, "
        f"max abs diff to the single-process shards {m_err}, launches "
        f"{ {n: _shown(v) for n, v in m_launches.items()} } "
        f"({nccl_s:.1f} s with the ranks' start); two gloo ranks on the "
        f"one card (CUDA tensors; PT and BDPT 1 x 2 'px', VPT 2 x 1 "
        f"'spp'): {ms(g_s)}, "
        f"max abs diff {g_err}, launches "
        f"{ {n: _shown(v) for n, v in g_launches.items()} } "
        f"({gloo_s:.1f} s) [{card}]; python -m adapt_tpu_torch.render "
        f"--multichip -1: '{mesh_line}', image written ({mcli_s:.1f} s)")

    # ---- 23. the apps on the card ----
    import urllib.request
    viz_out = os.path.join(ROOT, "build", "chip_smoke", "viz")

    def app(args, timeout=300):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=ROOT),
                           capture_output=True, text=True, timeout=timeout)
        _require(p.returncode == 0, f"{args}: exit {p.returncode}, stdout "
                 f"{p.stdout[-1500:]}, stderr {p.stderr[-1500:]}")
        return p.stdout, time.perf_counter() - t0
    viz_out_png = os.path.join(viz_out, "direct.png")
    v_out, v_s = app(["adapt_tpu_torch.scene_viz", "--scene", "cbox",
                      "--name", "cbox.xml", "--mode", "direct", "--out",
                      viz_out_png])
    _require("<lookat" in v_out and os.path.exists(viz_out_png),
             f"scene_viz one-shot: {v_out[-800:]}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "adapt_tpu_torch.scene_viz", "--scene",
         "cbox", "--name", "cbox.xml", "--serve", "0"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        for ln in proc.stdout:
            lines.append(ln)
            if "flythrough: http" in ln:
                port = int(ln.rsplit(":", 1)[1].strip().rstrip("/"))
                break
        _require(port is not None, f"scene_viz --serve: {''.join(lines)}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/key?k=w",
                                    timeout=120) as rsp:
            key_json = json.loads(rsp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png",
                                    timeout=120) as rsp:
            png = rsp.read()
        _require("<lookat" in key_json["lookat"] and png[:4] == b"\x89PNG",
                 f"scene_viz --serve: {key_json}, {png[:8]}")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    s_s = time.perf_counter() - t0
    film_png = os.path.join(cli_out, "smoke_pt.png")
    pp_out, pp_s = app(["adapt_tpu_torch.post_processing", "--input",
                        film_png, "--output",
                        os.path.join(viz_out, "smoke_pt-clean.png")])
    _require("firefly pixels cleaned" in pp_out, f"post_processing: {pp_out}")
    say(f"phase 23 the apps on the card: scene_viz one-shot (direct, "
        f"512^2) {v_s:.1f} s; scene_viz --serve, one key and frame "
        f"{s_s:.1f} s ({key_json['lookat']}); post_processing on phase 19's "
        f"film {pp_s:.1f} s ({pp_out.strip()}) [{card}]")

    # ---- 24. PT on null BSDFs: vpt/cbox.xml, foam.xml by the CLI ----
    nscene, ncfg, _ = C.load_scene(os.path.join(ROOT, "scenes", "vpt"),
                                   "cbox.xml")
    _require(ncfg.has_null_bsdf and not ncfg.use_bvh
             and (ncfg.w, ncfg.h, ncfg.max_bounce, ncfg.num_shadow_ray)
             == (512, 512, 16, 1), f"vpt cbox.xml settings ({ncfg})")
    r = pt.Renderer(nscene, ncfg, seed=0)
    _require(not r._auto, "vpt cbox is under the auto-compaction gate")
    r.render_batch(1)                         # warm-up sample, not timed
    reset()
    dt_n = timed_batch(r, NULL_SPP)
    nlaunches = counts()
    nimage = r.image()
    n_nan = float(np.isnan(nimage).any(axis=-1).mean())
    _require(nimage.shape == (ncfg.h, ncfg.w, 3) and n_nan == 0.0
             and bool(np.isfinite(nimage).all()) and nimage.mean() > 0.01,
             f"PT vpt cbox: shape {nimage.shape}, NaN share {n_nan}, mean "
             f"{nimage.mean()}")
    # one closest hit a bounce, one any hit a shadow ray a bounce
    want = {**none, "tri_closest_hit": NULL_SPP * ncfg.max_bounce,
            "tri_any_hit": NULL_SPP * ncfg.max_bounce * ncfg.num_shadow_ray}
    _require(nlaunches == want,
             f"PT vpt cbox launch counts {nlaunches}, want {want}")
    n_twin = twin_equal(lambda c: pt.Renderer(nscene, c, seed=1), ncfg)
    foam, foam_s = cli("--scene", "trans", "--name", "foam.xml", "--type",
                       "pt", "--iter_num", "1", "--img_name", "smoke_foam")
    _require(os.path.exists(os.path.join(cli_out, "smoke_foam.png")),
             "the CLI's PT image of foam.xml")
    say(f"phase 24 PT on null BSDFs: vpt/cbox.xml {ncfg.w}x{ncfg.h} mb "
        f"{ncfg.max_bounce} ({nscene.n_prims} prims, {ncfg.n_null_objs} "
        f"null-BSDF objects), {NULL_SPP} spp: "
        f"{1e3 * dt_n / NULL_SPP:.2f} ms/spp; launches per spp "
        + ", ".join(f"{k} {n // NULL_SPP}"
                    for k, n in _shown(nlaunches).items())
        + f"; image mean {nimage.mean():.6f}, no NaN pixel; 64^2 render "
        f"equal to the twins' (max abs diff {n_twin:.3g}); the CLI on "
        f"trans/foam.xml: {foam} (process {foam_s:.1f} s) [{card}]")

    shade_json = shade_phase(card)
    said[0] = time.perf_counter()

    path_launches = {**{k: launches[k] + preview_launches[k] + mlaunches[k]
                        + vblaunches[k] + vol_launches[k] + glaunches[k]
                        + mlaunch_sum[k] + nlaunches[k]
                        for k in ("tri_closest_hit", "tri_any_hit")},
                     **{k: klaunches[k] + bulaunches[k] + bplaunches[k]
                        + orb_launches[k]
                        for k in ("bvh_closest_hit", "bvh_any_hit")},
                     "tri_track_hits": vlaunches["tri_track_hits"]
                     + vblaunches["tri_track_hits"]
                     + vol_launches["tri_track_hits"]
                     + mlaunch_sum["tri_track_hits"],
                     "splat_sorted_accumulate":
                         blaunches["splat_sorted_accumulate"]
                         + bulaunches["splat_sorted_accumulate"]
                         + vol_launches["splat_sorted_accumulate"]
                         + mlaunch_sum["splat_sorted_accumulate"],
                     **{k: tier_launches["sweep"][k] for k in (
                         "cluster_closest_hit", "cluster_any_hit")},
                     **{k: tier_launches["qpick"][k] for k in (
                         "cluster_front", "cluster_pick_closest",
                         "cluster_pick_any")}}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "device_ms": device[k],
         "plain_ms": times[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": times[k][2] if len(times[k]) > 2 else None}
        for k, (src, rep) in KERNELS.items()] + [
        {"name": rng.kernel_names[w], "route": "cuda",
         "source": "adapt_tpu_torch/csrc/rng.cu",
         "replaces": "none (jax.random, lowered by XLA)",
         "launches": rlaunches[w] + bprlaunches[w],
         "max_abs_err": rng_err[w], "ms": k,
         "device_ms": kd, "plain_ms": p, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": None}
        for w, (k, p, kd, b) in rng_json.items()] + [
        {"name": name, "route": "cuda",
         "source": "adapt_tpu_torch/csrc/shade.cu",
         "replaces": "none (bxdf_ops.py's arms, fused by XLA)",
         "launches": slaunches[w] + bpslaunches[w], "max_abs_err": err,
         "ms": k, "device_ms": kd, "plain_ms": p, "bound_ms": b[0],
         "bound_by": b[1], "library_ms": None}
        for w, name in SK.kernel_names.items()
        for err, k, kd, p, b in [shade_json[name]]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
