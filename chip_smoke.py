#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. device: the card's name and power limit, then the kernel build from
     zig_weekend_raytracer_tpu_torch/csrc/ (seconds, registers, spills of
     every instantiation, the phase profile's included); the default and
     cond walks' instantiations must have the recorded registers and spill
     (DEFAULT_RESOURCES);
 1b. the FP32 peak (tools/fp32_peak.py, kernel K5): chain_kernel against
     its plain version on the card for the five ops at every (blocks per
     SM, chains, unroll) of the sweep, on the sweep's own grid with 256
     steps (rtol 1e-6; the int chain's bits exactly), the fma chain's SASS
     (FFMA, not FMUL + FADD) and the int chain's (IMAD and LOP3), then the
     sweep with its iters-scaling check (4x / 1x time ratio in [3, 5]) and
     the physics bound (no rate past 105%); the measured add, select and
     int rates, in lane-operations per second, price every later bound's
     fp, cmp and int operations (utils/roofline.py);
  2. kernel against plain: render_fused on CUDA tensors at cornell 32x32,
     8 spp, depth 10, through the kernel and through its plain PyTorch
     version; work counts equal on >= 99% of lanes, radiance within
     rtol 1e-4 / atol 1e-5 on >= 99% of lanes, means within 1e-4 relative;
  3. the main path: Renderer(samples_per_pixel=1024, max_ray_bounce_depth=10)
     .render_device(load_scene("cornell_box", device="cuda"), 400, 400), one
     warmup render (records the cost map) and three timed renders; the
     framebuffer passes the region gate of
     tests/golden/bench_cornell_regions.json, the kernel launched during the
     phase and the plain version did not run;
  4. kernel against plain at the main path's lanes: the plain version at
     the sorted plan's 160,000 lanes with the largest spp <= 1024 expected
     to finish in about 5 s, beside the kernel at the same spp (its work
     counts give the bound); both on a spread slice of 4,096 of those
     lanes, each rendering one 32-sample window of the 1024, the windows
     together covering every sample index (every Sobol sample bit); and
     both on a spread slice of 256 lanes, each draining all 1024 samples
     of its pixel as the main path's lanes do (every respawn of the sample
     range), at depth 1 (the plain version's time grows with its loop
     passes: 226 s at depth 10 on an H100); all outputs held to the
     tolerances of phase 2, both times printed;
  5. closest_hit_kernel against its plain version (ops/trace.py, the cond
     walk) on the card, 160,000 rays each: (a) cornell camera rays at
     400x400 (brute spheres and quads), (b) balls first-hit probe rays at
     400x400 (sphere tree at the port's span), (c) the same rays on balls
     compiled with leaf span 2, (d) random rays in a seeded random scene of
     100 spheres and 600 quads with use_bvh (a multi-node quad tree seeded
     with the sphere result); (kind, idx) and t bitwise equal on every ray;
     the kernel alone (launches enqueued behind a device sleep, CUDA events
     around them), its wrapper and the plain version timed;
  6. render_fused with the tree walk and depth of field against its plain
     version: balls 32x32, 8 spp, depth 10, at the default leaf span and
     at span 2, with phase 2's tolerances; both times printed;
  7. the balls main path: Renderer(samples_per_pixel=128,
     max_ray_bounce_depth=10).render_device(load_scene("balls",
     device="cuda"), 400, 400), one warmup render (coherent_keys_kernel
     and a device sort build the coherent plan) and three timed renders;
     over those four renders the coherent driver ran, closest_hit.cu's
     coherent_keys_kernel and fused_render_kernel each launched (the
     closest-hit kernel's launches counted apart), and neither plain
     version ran;
     Mpaths/s printed beside the card; then the kernel against its plain
     version on a spread slice of 4,096 lanes of the coherent plan, each
     rendering one 8-sample window of the 128 (every sample index); then
     coherent_keys_kernel at the render's seed and sampler on all 160,000
     pixels against the eager first-hit probe (torch camera rays, then
     closest_hit_kernel) and the plain probe (the cond walk): lane words
     bitwise, first-hit keys differing on at most 0.1% of pixels (the
     count printed), the eager probe bitwise the plain one; the kernel
     alone, its wrapper and the plain probe timed, its bound from the
     plain probe's counts and each pixel's camera ray
     (utils/roofline.py:keys_bound_ms);
  8. the balls region gates on the card, both through utils/goldengate.py:
     200x200, 32 spp, depth 10 against tests/golden/scene_regions.json,
     and 64x64, 32 spp, depth 10 against tests/golden/balls.npz;
  9. bounce_kernel's one-bounce mode against its plain version
     (render/integrator.py:bounce): rtw_final camera rays at 400x400
     (160,000 lanes) through three chained bounces, and one bounce each on
     shrek_quads and earth; alive equal on >= 99.9% of lanes, the state
     within rtol 1e-5 / atol 1e-6 where alive agrees (origin and direction
     where the path goes on) on >= 99.9%; the counts that differ and both
     times printed;
 10. bounce_kernel's regenerating mode against its plain version
     (bounce_regen_reference): earth and shrek_quads at 32x32, 8 spp, depth
     10, rtw_final at 32x32, 4 spp, depth 8, with phase 2's tolerances (its
     1% lane allowance covers earth's texel boundaries); every lane drained;
 11. the rtw_final main path: Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=8).render_device(load_scene("rtw_final"), 400,
     400), one warmup render and three timed; over the four renders the
     coherent plan was built, coherent_keys_kernel and bounce_kernel launched,
     fused_render_kernel did not and no plain version ran; the driver
     loop's passes per band, Mpaths/s beside the card, bounce_kernel's time
     at the coherent plan, the kernel against its plain version on a spread
     slice of 4,096 plan lanes in 8-sample windows of the 64 (every sample
     index), the peak device memory, and the device memory that one launch
     at the plan allocates (launch_mib); then coherent_keys_kernel against
     the probes as in phase 7, on rtw_final's pixels;
 12. the region gates of earth, shrek_quads and rtw_final on the card:
     200x200 against tests/golden/scene_regions.json (rtw_final at 32 spp,
     depth 8; the others at their recorded spp and depth 10), and 64x64,
     32 spp, depth 10 against tests/golden/{earth,shrek_quads,rtw_final}.npz
     (rtw_final on 4x4 regions, its 8x8-region verdict printed: see
     phase 12's comment);
 13. the render kernel with a texture LUT against its plain version, with
     phase 2's tolerances: rtw_final 32x32, 4 spp, depth 8 at a native
     budget and at 32768 texels, shrek_quads and earth at 8192 (depth 10),
     and a small scene whose lamp is image-textured, with a LUT (render
     kernel) and without (bounce kernel, regenerating mode); then the bounce
     kernel's one-bounce mode with a LUT on rtw_final's 160,000 camera rays
     with phase 9's tolerances;
 14. the LUT main path: Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=8).render_device(load_scene("rtw_final",
     texture_lut=<native>), 400, 400), one warmup render and three timed;
     over the four renders the render kernel launched 4 times, the bounce
     kernel and every plain version never, coherent_keys_kernel built
     the coherent plan; Mpaths/s, the render kernel's time at the plan's
     lanes, peak device memory, a launch's device memory as phase 11's;
     the framebuffer against phase 11's atlas
     render (same texels, same drain) within rtol 1e-5 / atol 1e-6 on >=
     99.9% of pixels; the render kernel with the LUT and the bounce kernel
     with the atlas timed on the same lanes in 10 alternating pairs; the
     kernel against its plain version on a spread slice of 2,048 plan
     lanes in 8-sample windows; the rtw_final region gates of phase 12 on the LUT scene; the
     same render at a 32768-texel budget, its Mpaths/s and mean
     |diff| to the native render printed (lossy by design, not gated);
 15. emissive (the CLI's default scene): the render kernel against its
     plain version at 32x32, 8 spp, depth 10; Renderer(samples_per_pixel=
     256, max_ray_bounce_depth=10).render_device at 400x400 through the
     render kernel only (sorted plan), Mpaths/s; its region gates at 200x200
     (scene_regions.json) and 64x64 (tests/golden/emissive.npz); the render
     kernel's time at the sorted plan and its bound;
 16. the CLI (python -m zig_weekend_raytracer_tpu_torch.cli) as six
     subprocesses started together: emissive 96x96, 16 spp, depth 10 and
     rtw_final with --texture_lut=32768 at 64x64, 4 spp, depth 10, each
     exiting 0 with the three stage log lines and the stats line, its PPM
     byte-equal to write_ppm of the same render made in this process;
     --scene=bogus exiting 1 with the usage text; --profile=device on cornell printing a
     device table that names fused_render_kernel; at cornell 64x64, 16
     spp, depth 10, --scene_file=<the port's cornell_box.json> --adaptive=1
     --russian_roulette=3 --clamp_indirect=10, its PPM byte-equal to the
     in-process adaptive render of the built-in cornell_box, and
     --checkpoint resuming a checkpoint of 8 of the 16 spp written in this
     process, its PPM byte-equal to the uninterrupted progressive render;
 17. the tree walks (kernel K4: ZWRT_TRAV=cond|queue|rowqueue|spec, and
     the unified tree of ZWRT_UNI_TREE=1) against their plain versions,
     with the tolerances of phases 2 and 9, all on scenes at leaf span 2:
     for each walk the render kernel on balls, 32x32, 2 spp, depth 5 (not
     under uni: balls has no quads), the bounce kernel's regenerating mode
     on rtw_final 32x32, 2 spp, depth 4 and its one-bounce mode on
     rtw_final's 160,000 camera rays, all of them live and with every other
     lane dead (the warp's lanes diverge at the trace), and under cond and
     uni the render kernel with a native-budget LUT on rtw_final; each
     walk's plain version against the cond walk's on the same inputs; the
     unified tree at the port's span (the bounce kernel's regenerating
     mode and the render kernel with the LUT); the uni kernels at both
     spans against the plain cond walk of the unified tree
     (ops/trace.py:uni_cond_walk), whose work counts price the uni walk's
     bounds, as the cond walk's price the other walks' (walk_bound_counts);
     the rowqueue walk at the port's span, where a block stages only part
     of the quad tree's nodes, through the bounce kernel's regenerating
     mode and the render kernel with the LUT, and the cond walk's bounce
     kernel there (its counts price rowqueue's bound); every rowqueue
     kernel bitwise its plain version; the default queue walk at the port's
     span, the main paths' trees: the render kernel on balls and with the
     LUT on rtw_final against their plain versions, and the cond walk's
     plain counts there (they price phase 18's port-span bounds of the
     queue walk); every queue kernel bitwise its plain version, the plain
     queue walk's outputs bitwise the plain cond walk's, and its hits on
     balls' and rtw_final's 64x64 camera rays bitwise the cond walk's, its
     slab tests and leaf visits between the cond walk's and those of the
     whole walk with the seed t (plain_queue_hits); and a launch of
     rowqueue, spec and uni with a queue one entry short of the tree's
     leaves, of the queue walk with a capacity other than the kernel's, and
     of the queue walk without its packed nodes, each refused
     (short_queue_refused);
 18. the walks on the slice's path at full width and a cut spp, on phase
     17's scenes at leaf span 2, each with its counts set to 0 just before
     and read just after: rtw_final 400x400@16 d8 under the default walk
     and each of cond, rowqueue and spec (bounce kernel), with the LUT under
     the default walk (render kernel), and compiled with the unified tree
     through the bounce kernel and through the render kernel with the LUT;
     balls 400x400@32 d10 under the default walk and each of cond, rowqueue
     and spec (render kernel); one warmup and three timed renders each,
     Mpaths/s, the walk's instantiation launched and nothing else of the
     kind, no plain version, the kernel's time at the plan's lanes, its
     blocks per SM and shared memory a block there, each framebuffer within
     rtol 1e-5 / atol 1e-6 of the default walk's render of the same scene
     on >= 99.9% of pixels, and rtw_final's region gates of phase 12 on the
     unified-tree render; then rtw_final at the port's span under the
     default walk, rowqueue (bounce kernel) and uni (both kernels), and
     balls at the port's span under the default walk; the default walk's
     kernel time and bound (from the cond walk's counts) at the span-2
     plans; rowqueue's kernels (K1 balls and K2 rtw_final at span 2, K2 at
     the port's span) and uni's at the port's span against the default
     walk's kernel at the same plan, with phase 2's tolerances, rowqueue's
     bitwise (walks_against_default); and the render kernel's tree-less
     instantiation (kWalkNoTree) as the default and the cond walk launch
     it at cornell's and emissive's main-path plans: one instantiation,
     its registers and blocks per SM, no launch past MAX_BLOCKS_PER_SM, 8
     (the launchers raise its shared memory to hold it there);
 19. the respawn under every sampler: the render kernel on the
     all-materials scene (a moving sphere, an isotropic medium) and the
     bounce kernel's regenerating mode on it with an image quad, at 32x32,
     8 spp, depth 10, under the independent, stratified and Sobol samplers,
     and the render kernel on a 9-light scene, each against its plain
     version with phase 2's tolerances;
 20. the phase profile of the kernels the renders launch (the work-queue
     K1 and the regenerating K2 instrumented, kFlagProf): at the north
     star (cornell 400x400@1024 d10) and the benchmark's ref_10k50 (cornell
     400x400@10000 d50) over a first render's lanes, balls 400x400@128 d10
     and rtw_final 400x400@64 d8 (K2, and K1 with the LUT) over their
     coherent plans, and emissive 400x400@256 d10: each phase's cycle
     share (respawn, trace, shade, and the rest: pulls and the loop head),
     the warp-time share and the mean converged lanes per warp entering
     each, over the threads of the work-queue kernel's grid; the profiled
     kernel's radiance bitwise that of the kernel the render launches on the
     same lanes (render_fused, bounce_regen: the same grid and items);
 21. tools/span_sweep.py: leaf spans 1, 2, 4 and 8 under the cond and
     queue walks on balls 400x400@128 d10 and rtw_final 400x400@64 d8,
     Mpaths/s, kernel time and peak device memory, every render against the
     JAX-span cond render (differing pixels counted); rtw_final with the
     LUT at the winning setting; cond against queue at the port's span in
     5 alternating pairs on both scenes; the uni walk on rtw_final at each
     span, and uni against queue at the port's span in 5 pairs;
 22. the closest-hit kernel's ray sets and the AOV pass: on the first-hit
     probe's 160,000 rays of balls and rtw_final and the AOV pass's 692,224
     rays (400x400@4 in 32x32 tiles, padded) of cornell, balls and
     rtw_final, the kernel (the bounded leaf queue) bitwise against the
     plain cond walk; its bounds; the bytes a launch allocates (its
     outputs, never a queue per ray); the kernel alone and its wrapper
     timed; the AOV pass (render/aov.py) at
     400x400@4 on cornell, balls and rtw_final, its counts set to 0 just
     before and read just after (one kernel launch a pass, no plain
     version), wall time, the device time of the kernel and of the rest
     (the eager shading tail) from torch.profiler, peak device memory; the
     pass at 64x64@4 bitwise against the plain path on the card; the
     denoiser on the card against the CPU at 64x64 (rtol 1e-5 / atol 1e-6
     on >= 99.9% of values) and its time at 400x400; the CLI's entry point
     (cli.main, in this process) with --aov --denoise=3 --stats on balls;
 23. the estimator instantiations (Russian roulette from bounce 3, the
     indirect clamp at 10, each alone and both) against their plain
     versions with phase 2's tolerances: the render kernel on cornell 32x32
     8 spp d10, balls 32x32 8 spp d10 (tree, lens) and rtw_final 32x32 4
     spp d8 with a native LUT; the bounce kernel's one-bounce mode with both
     on cornell's 160,000 camera rays through bounces 0-3 with phase 9's;
     the bounce kernel's regenerating mode on rtw_final (atlas) 32x32 with
     both options bitwise the render without, the estimator never launched
     (the gate); the Sobol tables past spp: the render kernel at cornell
     32x32, spp 64, in 8-sample windows reaching sample 8,192;
 24. the drivers at the main path's configuration, cornell 400x400@1024
     d10, Sobol, seed 0, each path with its counts set to 0 just before and
     read just after (the render kernel launched, no plain version), one
     render that builds the plan and three timed, Mpaths/s beside the card,
     each framebuffer through the region gate of phase 3: (a) the balanced
     driver (balance_min_spp=1), within rtol 1e-5 / atol 1e-6 of phase 3's
     sorted render on >= 99.9% of pixels; (b) render_adaptive with the
     default pilot, its sample counts summing to 400 x 400 x 1024, and balls
     400x400@128 d10 adaptive gated on scene_regions.json; (c)
     ProgressiveRenderer in 256-sample batches, interrupted after two and
     resumed from its checkpoint, bitwise the uninterrupted progressive
     render and within (a)'s tolerance of phase 3's; (d)
     render_supersampled(k=2); (e) russian_roulette=3 (the estimator
     instantiation launched), its bounces against rr = 0's; then the render
     kernel's estimator and default instantiations at the rr3 plan in 3
     alternating pairs;
 25. the sharded paths (parallel/), each with its counts set to 0 just
     before and read just after (the render or bounce kernel launched, no
     plain version), Mpaths/s beside phase 3's: (a) render_sharded at
     cornell 400x400@1024 d10 on make_mesh() (one card: bitwise phase 3's
     framebuffer, both modes, first render and last) and on (cuda:0,)*4
     (both modes within rtol 1e-5 / atol 1e-6 of phase 3's on >= 99.9% of
     pixels), each region-gated; (b) render_sharded at cornell 32x32@8 d10
     on (cuda:0,)*4 through the render kernel against the same call with
     its plain version in the kernel's place on the card (bitwise), and on
     (cpu,)*4 through the plain version, both modes, with phase 2's
     tolerances per pixel, the pixels outside them the same as those of the
     unsharded render on the card against the CPU; (c) balls 400x400@128 d10 rows on (cuda:0,)*4
     (the tree walk) and rtw_final 400x400@64 d8 samples on (cuda:0,)*2 (the
     bounce kernel), each within (a)'s tolerance of phases 7 and 11, and the
     same shards at scene_regions.json's 200x200 configuration through its
     region gate (phases 8 and 12's 200x200 gate);
     (d) render_adaptive_sharded at cornell 400x400@1024, pilot 128, both
     modes on (cuda:0,)*4: gated, 163,840,000 samples, and in samples mode
     the sample map equal to render_adaptive's; (e) a progressive 4 x 256
     render on (cuda:0,)*2 interrupted after two batches and resumed:
     bitwise the uninterrupted one; (f) the CLI's --shard=samples at
     cornell 200x200@64 d10, its PPM byte-equal to the in-process render;
 26. the fixed-depth path (render/renderer.py:_render_band over
     render/integrator.py:trace_paths: the closest-hit kernel at every
     bounce, eager PyTorch shading), the path of scenes with nested
     checkers: (a) a scene built here (96 spheres and a large one in a
     sphere tree, a ground textured with a checker of checkers, a checker
     of a seeded image, a quad lamp) through Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=10).render_device at 400x400, one warmup and
     three timed renders, counts set to 0 just before and read just after:
     the closest-hit kernel launched once per bounce, the plain trace and
     every other kernel and plain version never; Mpaths/s, and from
     torch.profiler over the render's first chunk the kernel's device time
     per launch and the device idle share;
     (b) (a)'s first chunk once more with the kernel's wrapper wrapped:
     each launch's live lanes, and the rays of bounce 0 and of a later,
     masked bounce at (a)'s 2,249,728 lanes, on which the kernel is
     bitwise the plain trace (ops/trace.py, the cond walk); at 64x64@8 d10
     the render bitwise the render with the plain trace in the kernel's
     place on the card, and within rtol 1e-5 / atol 1e-6 of the CPU's
     render on >= 99.9% of pixels; the plain trace's work counts per
     traced ray and the chunk's live lanes give the kernel's bound; (c)
     the six goldens (tests/golden/<scene>.npz, 64x64@32 d10) through the
     path, each through its region gate
     (rtw_final on 4x4 regions), the share of pixels within rtol 1e-5 of
     the golden printed; (d) cornell 400x400@64 d10 through the path and
     through the render kernel's sorted plan, Mpaths/s (not gated); (e)
     phase 3's framebuffer written as .bmp and .jpg and read back by
     io/native.py: the BMP equal to its pixels, the JPEG at >= 30 dB PSNR;
     (f) python -m zig_weekend_raytracer_tpu_torch.tools.golden_check in a
     subprocess (overlapping (c) and (e)), every scene passing;
 27. the user tools of zig_weekend_raytracer_tpu_torch/tools/ in this
     process through their entry points, each with its counts set to 0
     just before and read just after (its kernels launched, no plain
     version): (a) scenebench balls 400 400 128 10 and rtw_final 400 400 64
     8, each framebuffer bitwise phase 7's and 11's, then cornell 400x400@1024
     d10 with --rr=3, --clamp=10, --adaptive, --shard=samples (one card:
     bitwise phase 3's), --supersample=2 and --denoise=3; nan=False, the
     Mpaths/s beside phases 3, 7 and 11; (b) shard_overhead at its defaults
     (exit 0); (c) lut_quality on shrek_quads at its defaults and on
     rtw_final at 32768 texels (LUT active, every figure finite; rtw_final's
     delta beside phase 14's); (d) quality_prodres at its defaults, one
     scene a call (four rows, finite MSE ratios); (e) imgdiff on phase 3's
     framebuffer as PPM against itself (mse 0) and as .jpg against the PPM,
     in process and as the command line, and a missing path (exit 1);
 28. the north-star harness, python -m zig_weekend_raytracer_tpu_torch.tools.bench,
     in a subprocess of its own session: once at the north star and once
     at balls 400 400 32 10; each must exit 0 with a last line whose
     correctness starts with "pass", on this card, having launched K1 and
     K5 (and K3c, the coherent plan's keys, on balls); the north star's
     value must be within 10% of
     phase 3's Mpaths/s and its kernel_ms and bound_ms within 5% of phase
     4's kernel time and bound; each line is logged and kept in the record
     (``harness``).

The record has one entry per kernel and mode: the render kernel on brute
scenes (cornell, emissive, and phase 25's cornell paths), on tree scenes
(balls, and phase 25's balls rows) and with the texture LUT (rtw_final), the
bounce kernel's one-bounce mode with the atlas and with the LUT (parity
checks only: no main path runs it, so its launches are 0) and its
regenerating mode (rtw_final, and phase 25's rtw_final samples), and the
closest-hit kernel (its launches on the AOV passes and phase 26's
fixed-depth path; the ray sets and AOV passes of phase 22, and
phase 26's render against the plain trace), coherent_keys_kernel (its
launches on the tree paths of phases 7, 11 and 14 and of the tools; phase
7's and 11's checks against the probes, its time and bound on balls;
``max_abs_err`` null: its outputs are integers); then one
per walk other than the default of the render kernel (cond, rowqueue and
spec on balls at span 2, uni with the LUT on rtw_final) and of the bounce
kernel's regenerating mode (rtw_final; rowqueue's at the port's span
too), each priced from the cond walk's counts on the same tree (the tree,
LUT and regenerating entries carry the default walk's span-2 path, time
and bound as ``queue_walk_span2``, and its path at the port's span; the
brute entry its tree-less instantiation's ``occupancy``), the estimator
instantiations of
the render kernel (its launches on phase 24's russian_roulette=3 path, its
time at that path's plan, every driver of phase 24 beside it) and of the
bounce kernel (parity only: the atlas gate keeps it off every path), and
the FP32-peak chain kernel.
Phase 27's tools add their launches to the entries of the kernels and modes
they ran (``launches_by_path`` names each tool run).
Phase 20's phase profiles are not kernels of any path: their launches are
counted apart (``profile_launches``).  Each entry carries its registers
and spill from the build, its times, its launches on its path and its
roofline bound: lane-operations by class (utils/roofline.py's per-unit
counts times the work that the plain version counted on a parity run of
the same scene, scaled to the kernel's own bounce count) at phase 1b's
measured rates (``peak_source``), and bytes (inputs once, outputs once)
over the H100's HBM3 rate.  No single PyTorch call computes path radiance, a bounce,
a closest hit or an operation chain, so ``library_ms`` is null.

The line before the last is the kernels' JSON record, the line before it
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.  Without CUDA, or without the package next to this script, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W = H = 400
SPP = 1024
DEPTH = 10
GOLDEN = os.path.join(REPO, "tests", "golden", "bench_cornell_regions.json")
SCENE_REGIONS = os.path.join(REPO, "tests", "golden", "scene_regions.json")
KERNEL_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fused_render.cu"
KERNEL_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531"
KERNEL_LUT_REPLACES = ("zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531 "
                       "(_fused_render_kernel), :189 (_texlut_fetch)")
HIT_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/closest_hit.cu"
HIT_REPLACES = (
    "zig_weekend_raytracer_tpu/ops/pallas_trace.py:300 (_sphere_kernel), "
    ":371 (_quad_kernel), :432 (_tree_kernel)"
)
# no TPU kernel: the JAX package's coherent plan probes on the host's
# side of the launch (eager camera rays, _tree_kernel) and sorts there
KEYS_REPLACES = ("zig_weekend_raytracer_tpu/render/renderer.py:289 (_first_hit_probe) and "
                 ":631-644 (its keys and np.lexsort)")
BOUNCE_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/bounce.cu"
BOUNCE_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:842 (_bounce_kernel)"
EST_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fused_render_estimator.cu"
EST_BOUNCE_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/bounce_estimator.cu"
CORNELL_FILE = os.path.join(REPO, "zig_weekend_raytracer_tpu_torch", "models", "cornell_box.json")
PLAIN_BUDGET_S = 5.0
# phase 4's slice of the main path's lanes: one window of this many samples
# per lane, the windows together covering every sample index
MAIN_WINDOW = 32
SLICE_LANES = 4096
# the tree scenes' plan slices: each lane renders one window of this many
# samples, the windows together covering every sample index (the plain
# version's time grows with its loop passes)
PLAN_WINDOW = 8
# phase 4's full drain: each lane of the slice renders all 1024 samples of
# its pixel as the main path's lanes do, so every respawn of the main
# path's sample range; the plain version's time grows with its loop passes
# (about 4.5 passes per sample at depth 10: 226 s on an H100), so the slice
# runs at one bounce per sample
FULL_DRAIN_LANES, FULL_DRAIN_DEPTH = 256, 1
# phase 17's parity renders: 32x32 at this spp, balls at WALK_DEPTH and
# rtw_final at WALK_RTW_DEPTH (the plain versions' time grows with depth)
WALK_SPP = 2
WALK_DEPTH, WALK_RTW_DEPTH = 5, 4
BALLS_SPP = 128
RTW_SPP, RTW_DEPTH = 64, 8
# rtw_final's 32x32 parity renders (phases 10 and 13): its plain walk at the
# port's span takes about 2 s per sample there
RTW_SMALL_SPP = 4
HIT_RTOL, HIT_ATOL, HIT_AGREE = 1e-5, 1e-6, 0.999
# a closest-hit time: this many launches behind a device sleep of this many
# cycles (about 10 ms), over which the host enqueues them
HIT_LAUNCHES, SLEEP_CYCLES = 20, 20_000_000
# the coherent plan's keys (phases 7 and 11): the share of pixels whose
# first-hit key may differ between coherent_keys_kernel's camera ray and
# the eager ops' (FMA contraction at silhouettes)
KEYS_DIFFER = 1e-3
# phase 22: the AOV pass's spp (the CLI's), its slice against the plain
# path, and the denoiser on the card against the CPU (CUDA's expf and powf
# round otherwise than the CPU's by an ulp or two: at most 3.965e-06
# relative on an H100)
AOV_SPP, AOV_SLICE = 4, 64
DENOISE_RTOL, DENOISE_ATOL, DENOISE_AGREE = 1e-5, 1e-6, 0.999
LIBRARY_NOTE = "none: no single PyTorch call computes path radiance, a bounce or a closest hit"
# texel budgets of the texture LUT: native holds rtw_final's images
# unpadded (7,151,808 + 87,600 texels), the others box-downsample them
LUT_NATIVE, LUT_32K, LUT_8K = 1 << 23, 32768, 8192
EMISSIVE_SPP = 256
# phase 20's second cornell plan: the benchmark's converged reference
# (benchmark/traffic/ref_10k50.json)
REF_SPP, REF_DEPTH = 10000, 50
LUT_PAIRS = 10
# phase 18's renders: every walk at full width, at a cut spp
WALK18_BALLS_SPP, WALK18_RTW_SPP = 32, 16
STAGES = ("scene initialized", "scene rendered", "scene written to file")
PEAK_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fp32_peak.cu"
PEAK_REPLACES = "tools/vpu_peak.py:59 (_chain_kernel; pallas_call :123 in build :119)"
WALK_REPLACES = {
    "cond": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:597 (_tree_pass)",
    "queue": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:466 (_tree_pass_queue, per_row=False)",
    "rowqueue": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:466 (_tree_pass_queue, per_row=True)",
    "spec": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:640 (_tree_pass_spec)",
    "uni": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:713 (_uni_tree_pass)",
}
NEW_WALKS = ("queue", "rowqueue", "spec", "uni")
# the package's default walk (ops/trace.py:DEFAULT_WALK) and the others,
# each of which phase 18 renders and the record lists
DEFAULT_WALK = "queue"
OTHER_WALKS = ("cond", "rowqueue", "spec", "uni")
# a chain kernel's plain version against it: the plain fma is float64
# arithmetic rounded once to float32, which can differ from fmaf by one ulp
CHAIN_RTOL = 1e-6
# iters x unroll of each parity run: the sweep's own instantiations and
# grids, with iters cut so that the plain version stays short
CHAIN_STEPS = 256
# estimator options of phases 23 and 24: Russian roulette's first bounce
# and the indirect clamp
RR_START, CLAMP = 3, 10.0
EST_OPTS = (("rr3", {"rr_start": RR_START}), ("clamp10", {"clamp": CLAMP}),
            ("rr3+clamp10", {"rr_start": RR_START, "clamp": CLAMP}))
# phase 23's Sobol check: lanes of 32x32 at spp 64 in 8-sample windows that
# reach sample 4,096 (two bytes of sample index where spp needs one)
SOBOL_SPP, SOBOL_WINDOW = 64, 8
# phase 24: a driver's render must equal the sorted driver's (phase 3) on
# this share of pixels within rtol 1e-5 / atol 1e-6; the progressive batch
PIXEL_RTOL, PIXEL_ATOL, PIXEL_AGREE = 1e-5, 1e-6, 0.999
PROG_BATCH = 256
# phase 25: the adaptive pilot (pick_pilot of 1024), the plain-version
# parity renders' size, the CLI render's size
ADAPTIVE_PILOT = 128
SHARD_PARITY_W, SHARD_PARITY_SPP = 32, 8
CLI_SHARD_W, CLI_SHARD_SPP = 200, 64
# phase 26: the nested-checker scene's main path and its parity render,
# the goldens' size through the fixed-depth path, and a JPEG's PSNR floor
NESTED_SPP, NESTED_PARITY_W, NESTED_PARITY_SPP = 64, 64, 8
# the later bounce of the main path's first chunk whose rays phase 26 keeps
NESTED_HELD_BOUNCE = 3
FIXED_COST_SPP = 64
JPEG_MIN_PSNR = 30.0
# registers and spill bytes of the default walk's instantiations, of the
# tree-less ones that every walk but uni launches on a scene without trees,
# and of the cond walk's, as this build gives them (the factored Sobol
# respawn and the device light and image tables), and of the closest-hit
# kernel and its coherent-plan keys.  The render kernel's and the bounce
# kernel's regenerating ones, fed from the work queue, are held by
# __launch_bounds__ to 8 blocks per SM without trees and 7 on a tree walk
# (render_kernels.cuh:pull_min_blocks)
DEFAULT_RESOURCES = {
    "fused_render_kernel<false, queue>": (72, 0), "fused_render_kernel<true, queue>": (72, 0),
    "bounce_kernel<false, queue>": (68, 0), "bounce_kernel<true, queue>": (72, 0),
    "fused_render_kernel<false, no tree>": (62, 0), "fused_render_kernel<true, no tree>": (62, 0),
    "bounce_kernel<false, no tree>": (48, 0), "bounce_kernel<true, no tree>": (62, 0),
    "fused_render_kernel<false, cond>": (72, 0), "fused_render_kernel<true, cond>": (72, 0),
    "bounce_kernel<false, cond>": (64, 0), "bounce_kernel<true, cond>": (72, 0),
    "closest_hit_kernel": (56, 0), "coherent_keys_kernel": (56, 0),
}
# phase 28: the harness's runs (its arguments), each one's time limit, and
# how far the north star's figures may stray from phases 3 and 4's
HARNESS_RUNS = ((), ("balls", "400", "400", "32", "10"))
HARNESS_TIMEOUT_S = 300
HARNESS_VALUE_AGREE, HARNESS_KERNEL_AGREE = 0.10, 0.05
# the measured rates (lane-operations per second) of the roofline's classes
# (fp: the add chain, cmp: select, int: the int chain), which every bound
# divides by once phase 1b has run
OPS_RATE = {"rate": None}


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()


def phase(name: str) -> None:
    """Mark the start of a phase with the script's elapsed time."""
    log(f"==== phase {name} at {time.perf_counter() - START:.1f} s")


def cuda_time_ms(fn, repeats: int = 1):
    """Best device time of ``fn`` over ``repeats`` runs, by CUDA events,
    and the last run's result (the harness's, tools/bench.py)."""
    from zig_weekend_raytracer_tpu_torch.tools.bench import cuda_time_ms as best_ms

    return best_ms(fn, repeats)


def compare(tag: str, out_k, out_p) -> dict:
    """The kernel's (radiance, work) against the plain version's: work
    counts equal and radiance within rtol 1e-4 / atol 1e-5 on >= 99% of
    lanes, means within 1e-4 relative.  Returns the counts that differ."""
    import numpy as np

    (rad_k, work_k), (rad_p, work_p) = out_k, out_p
    rk = rad_k.to_array().cpu().numpy()
    rp = rad_p.to_array().cpu().numpy()
    wk = work_k.cpu().numpy()
    wp = work_p.cpu().numpy()
    n = rk.shape[0]
    work_diff = int((wk != wp).sum())
    close = np.isclose(rk, rp, rtol=1e-4, atol=1e-5).all(axis=1)
    rad_diff = int((~close).sum())
    mean_rel = abs(float(rk.mean()) - float(rp.mean())) / max(abs(float(rp.mean())), 1e-12)
    max_abs = float(np.abs(rk - rp).max())
    log(
        f"parity {tag}: {n} lanes, work counts differ on {work_diff}, "
        f"radiance outside rtol 1e-4/atol 1e-5 on {rad_diff}, "
        f"mean rel diff {mean_rel:.3e}, max |diff| {max_abs:.3e}"
    )
    if not np.isfinite(rk).all():
        raise AssertionError(f"parity {tag}: kernel radiance is not finite")
    if work_diff > 0.01 * n or rad_diff > 0.01 * n or mean_rel > 1e-4:
        raise AssertionError(f"parity {tag}: kernel disagrees with its plain version")
    return {"check": tag, "lanes": n, "work_diff": work_diff, "rad_diff": rad_diff,
            "mean_rel": mean_rel, "max_abs_err": max_abs}


@contextlib.contextmanager
def env(name, value):
    """``name`` set to ``value`` (None: unset) for the block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def leaf_span(span):
    """ZWRT_LEAF_GROUPS=span while a scene compiles (None: the default)."""
    return env("ZWRT_LEAF_GROUPS", None if span is None else str(span))


def trav(walk):
    """ZWRT_TRAV for ``walk`` while the kernels launch; None (the package's
    default walk) and the unified tree (a property of the scene) leave it
    unset."""
    return env("ZWRT_TRAV", walk if walk in ("cond", "queue", "rowqueue", "spec") else None)


def render_parity(zt, fused, integrator, torch, scene, tag, depth=10, plains=None,
                  spp=8, sampler=None, window=None, **opts) -> dict:
    """Kernel vs plain version on the card at 32x32, ``spp`` spp, depth 10
    (or ``depth``), with the scene's own depth of field, under ``sampler``
    (Sobol when None) and the estimator options ``opts`` (rr_start,
    clamp); both timed by CUDA events.  With ``window`` lane i renders only
    the samples [i * window, (i + 1) * window), which may pass spp.
    ``plains``, a list, collects the plain version's output and its work
    counts."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    w = h = 32
    ys, xs = torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij"
    )
    i32 = torch.int32
    px = xs.reshape(-1).to(i32).contiguous()
    py = ys.reshape(-1).to(i32).contiguous()
    s0 = torch.zeros_like(px)
    s1 = torch.full_like(px, spp)
    if window:
        s0 = (torch.arange(w * h, dtype=i32, device="cuda") * window).contiguous()
        s1 = (s0 + window).contiguous()
    kw = dict(
        camera_consts=camera_consts(scene.camera, w, h),
        sampler=sampler or zt.sampling.SamplerKind.SOBOL, width=w, height=h, spp=spp,
        stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field,
        want_work=True, **opts,
    )
    t_min = zt.dtypes.T_MIN
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, s1, 0, t_min, **kw), 3
    )
    with workcount.counting() if plains is not None else contextlib.nullcontext({}) as counts:
        ms_p, out_p = cuda_time_ms(
            lambda: plain_k1(fused, integrator, scene.compiled, px, py, s0, s1, 0, t_min, **kw)
        )
    check = compare(tag, out_k, out_p)
    log(f"parity {tag}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
    if plains is not None:
        plains.append((out_p, dict(counts)))
    return {**check, "ms": ms_k, "plain_ms": ms_p}


def camera_rays(zt, torch, scene, w, h, spp):
    """Every pixel's sample-0 camera ray, as the first-hit probe makes it."""
    from zig_weekend_raytracer_tpu_torch.render.camera import (
        camera_consts, camera_params_from_consts, generate_rays,
    )

    ys, xs = torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij"
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    return generate_rays(
        camera_params_from_consts(camera_consts(scene.camera, w, h)),
        scene.camera.has_depth_of_field, zt.sampling.SamplerKind.SOBOL, 0,
        py * w + px, px, py, torch.zeros_like(px), spp, w, h,
    )


def random_scene_rays(zt, torch, n):
    """A seeded random scene of 100 spheres and 600 quads with use_bvh
    (a sphere tree and a multi-node quad tree at the default spans) and n
    random rays with times."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.math.v3 import V3

    rng = np.random.default_rng(0)
    b = zt.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for _ in range(100):
        b.add(b.sphere(rng.uniform(-10, 10, 3), rng.uniform(0.2, 1.5), mat))
    for _ in range(600):
        b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), mat))
    b.use_bvh(True, min_prims=2)
    cs = b.compile(device="cuda").compiled
    cuda = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device="cuda")
    org = rng.uniform(-15, 15, (n, 3))
    d = rng.normal(size=(n, 3))
    rays = (V3(*(cuda(org[:, i]) for i in range(3))), V3(*(cuda(d[:, i]) for i in range(3))),
            cuda(rng.uniform(0, 1, n)))
    return cs, rays


def compare_hits(tag: str, hit_k, hit_p) -> dict:
    """(kind, idx) and t bitwise equal on every ray (a miss: kind -1, t
    inf), as every check of the closest-hit kernel has been."""
    import numpy as np

    tk, kk, ik = (x.cpu().numpy() for x in hit_k)
    tp, kp, ip = (x.cpu().numpy() for x in hit_p)
    n = kk.size
    agree = (kk == kp) & (ik == ip)
    hit = agree & (kp >= 0)
    t_bad = int((tk.view(np.int32) != tp.view(np.int32)).sum())
    max_abs = float(np.abs(tk[hit] - tp[hit]).max()) if hit.any() else 0.0
    differ = int(n - agree.sum())
    log(
        f"closest hit {tag}: {n} rays, {int((kp >= 0).sum())} hits, (kind, idx) differ on "
        f"{differ}, t not bitwise equal on {t_bad}, max |t diff| {max_abs:.3e}"
    )
    if differ or t_bad:
        raise AssertionError(f"closest hit {tag}: kernel disagrees with its plain version")
    return {"check": tag, "rays": n, "kind_idx_diff": differ, "t_bad": t_bad,
            "max_abs_err": max_abs}


def hit_launcher(ch, cs, rays, t_min, t_max=float("inf"), active=None):
    """A launch of the closest-hit kernel with no wrapper around it: the
    wrapper's checked arguments (ops/closest_hit.py:launch_args) handed to
    the library's launcher on each call, which counts nothing.  Returns
    ``run``; ``run()`` returns the Hit."""
    from zig_weekend_raytracer_tpu_torch.ops import _build

    args, hit, keep = ch.launch_args(cs, *rays, t_min, t_max, active)
    fn = _build.load_library().zwrt_closest_hit

    def run():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"zwrt_closest_hit launch failed: cudaError {err}")
        return hit

    run.keep = keep
    return run


def keys_launcher(ch, cs, seed, rows, kw):
    """A launch of coherent_keys_kernel over rows [0, rows) with no wrapper
    around it (ops/closest_hit.py:keys_launch_args' checked arguments),
    as ``hit_launcher``'s; ``run()`` returns the keys' high words."""
    from zig_weekend_raytracer_tpu_torch.ops import _build
    from zig_weekend_raytracer_tpu_torch.render.renderer import PROBE_T_MIN

    args, keys, keep = ch.keys_launch_args(cs, seed, 0, rows, PROBE_T_MIN, **kw)
    fn = _build.load_library().zwrt_coherent_keys

    def run():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"zwrt_coherent_keys launch failed: cudaError {err}")
        return keys

    run.keep = keep
    return run


def keys_check(zt, ch, ttrace, torch, scene, renderer, tag, card) -> dict:
    """coherent_keys_kernel at a main path's image (one band of W x H, the
    renderer's seed and sampler) against its plain version: the keys that
    render/renderer.py:coherent_plan_keys makes on the card against those
    of the eager first-hit probe (camera rays by torch ops, then
    closest_hit_kernel) and of the plain probe (the same rays through
    ops/trace.py's cond walk, whose work counts give the bound); the lane
    words bitwise, the first-hit keys differing on at most KEYS_DIFFER of
    the pixels (the kernel's camera ray against the eager ops' rounding)
    and the eager probe's keys bitwise the plain probe's; the kernel alone,
    its wrapper and the plain probe timed."""
    from zig_weekend_raytracer_tpu_torch.render import renderer as rmod
    from zig_weekend_raytracer_tpu_torch.render.camera import (
        camera_consts, camera_params_from_consts, generate_rays)
    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    cs, n = scene.compiled, W * H
    has_dof = scene.camera.has_depth_of_field
    cam = camera_consts(scene.camera, W, H)
    kw = dict(width=W, height=H, spp=renderer.samples_per_pixel, sampler=renderer.sampler,
              has_dof=has_dof)
    tile, seed = rmod.pick_tile(W, H), renderer.seed
    keys = rmod.coherent_plan_keys(scene, seed, 0, H, tile, cam_consts=cam, **kw)
    pix = torch.arange(n, device="cuda")
    px, py = pix % W, pix // W
    kind, idx = rmod._first_hit_probe(scene, seed, px, py, cam_consts=cam, **kw)
    eager = torch.where(kind < 0, -1, (kind.long() << 24) + idx)

    def plain():
        rays = generate_rays(camera_params_from_consts(cam), has_dof, renderer.sampler, seed,
                             py * W + px, px, py, torch.zeros_like(px), kw["spp"], W, H)
        hit = ttrace.closest_hit(cs, *rays, rmod.PROBE_T_MIN, walk="cond")
        return torch.where(hit.kind < 0, -1, (hit.kind.long() << 24) + hit.idx)

    with workcount.counting() as counts:
        plain_ms, plain_key = cuda_time_ms(plain)
    lane = rmod.tile_order_lane_index(W, H, tile).reshape(-1)
    lane_bad = int(((keys & 0xFFFFFFFF).cpu().numpy() != lane).sum())
    differ = int(((keys >> 32) - 1 != eager).sum())
    eager_bad = int((eager != plain_key).sum())
    kkw = {**kw, "camera_consts": cam}
    ms = kernel_alone_ms(torch, keys_launcher(ch, cs, seed, H, kkw))
    ms_w = wrapper_ms(torch, lambda: ch.coherent_keys(cs, seed, 0, H, rmod.PROBE_T_MIN, **kkw))
    bound, by = roofline.keys_bound_ms(counts, cs, n, renderer.sampler, has_dof, W, H,
                                       OPS_RATE["rate"])
    log(f"coherent keys {tag}: {n} pixels ({renderer.sampler.name}, depth of field "
        f"{has_dof}), lane words differ on {lane_bad}, first-hit keys differ from the eager "
        f"probe's on {differ}, the eager probe's from the plain probe's on {eager_bad}; "
        f"kernel alone {ms:.4f} ms, wrapper {ms_w:.4f} ms, plain probe {plain_ms:.1f} ms, "
        f"bound {bound:.4f} ms ({by}; {card})")
    if lane_bad or eager_bad or differ > KEYS_DIFFER * n:
        raise AssertionError(f"coherent keys {tag}: the kernel's keys disagree with the probe")
    return {"check": f"coherent keys {tag}", "pixels": n, "sampler": renderer.sampler.name,
            "has_dof": has_dof, "lane_bad": lane_bad, "hit_key_diff": differ,
            "eager_vs_plain_diff": eager_bad, "max_abs_err": 0.0, "ms": ms,
            "wrapper_ms": ms_w, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "peak_source": roofline.peak_source(OPS_RATE["rate"])}


def kernel_alone_ms(torch, run, launches=None) -> float:
    """Device time of one launch of ``run`` (hit_launcher's, no wrapper
    around it): ``launches`` launches enqueued behind a device sleep
    so that the host's enqueue does not pace them, timed by CUDA events
    around all of them."""
    launches = launches or HIT_LAUNCHES
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(launches):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def wrapper_ms(torch, call, launches=None) -> float:
    """Time of one call of a kernel's wrapper, host work included: CUDA
    events around ``launches`` calls issued back to back."""
    launches = launches or HIT_LAUNCHES
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def phase_closest_hit(zt, ch, ttrace, torch) -> list:
    """closest_hit_kernel vs its plain version on the card, four cases."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    t_probe = float(np.float32(1e-4))
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    balls = zt.models.load_scene("balls", device="cuda")
    with leaf_span(2):
        balls2 = zt.models.load_scene("balls", device="cuda")
    probe = camera_rays(zt, torch, balls, W, H, BALLS_SPP)
    rand_cs, rand_rays = random_scene_rays(zt, torch, W * H)
    cases = [
        ("a cornell camera rays 400x400", cornell.compiled,
         camera_rays(zt, torch, cornell, W, H, SPP), t_probe),
        ("b balls probe rays 400x400, default span", balls.compiled, probe, t_probe),
        ("c balls probe rays 400x400, span 2", balls2.compiled, probe, t_probe),
        ("d random scene 100 spheres + 600 quads, random rays", rand_cs, rand_rays,
         zt.dtypes.T_MIN),
    ]
    out = []
    for tag, cs, rays, t_min in cases:
        sph = "tree" if cs.has_sph_tree else "brute"
        quad = "tree" if cs.has_quad_tree else ("brute" if cs.n_quads else "none")
        nodes = (cs.sph_tree_box.shape[0], cs.quad_tree_box.shape[0])
        hit_k = ch.closest_hit(cs, *rays, t_min)
        ms_k = kernel_alone_ms(torch, hit_launcher(ch, cs, rays, t_min))
        ms_w = wrapper_ms(torch, lambda: ch.closest_hit(cs, *rays, t_min))
        with workcount.counting() as counts:
            ms_p, hit_p = cuda_time_ms(lambda: ttrace.closest_hit(cs, *rays, t_min, walk="cond"))
        check = compare_hits(tag, hit_k, hit_p)
        bound, by = roofline.hit_bound_ms(counts, cs, rays[2].numel(), OPS_RATE["rate"])
        log(f"closest hit {tag}: spheres {sph}, quads {quad}, tree nodes {nodes}; "
            f"kernel alone {ms_k:.4f} ms, wrapper {ms_w:.4f} ms, plain {ms_p:.1f} ms, bound "
            f"{bound:.4f} ms ({by})")
        out.append({**check, "spheres": sph, "quads": quad, "ms": ms_k, "wrapper_ms": ms_w,
                    "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
                    "peak_source": roofline.peak_source(OPS_RATE["rate"])})
    return out


def reset_counts(fused, integrator, ch, ttrace, tb) -> None:
    integrator.render_fused_reference.calls = 0
    ch.closest_hit.launches = 0
    ch.coherent_keys.launches = 0
    ttrace.closest_hit.calls = 0
    integrator.bounce.calls = 0
    integrator.bounce_regen_reference.calls = 0
    integrator.trace_paths_regen.passes = 0
    integrator.trace_paths_regen.bands = 0
    for host in (fused.render_fused, tb.bounce, tb.bounce_regen):
        host.launches = dict.fromkeys(host.launches, 0)
        host.estimator_launches = 0


def launched(host) -> int:
    """The launches of a render or bounce kernel wrapper, over every walk."""
    return sum(host.launches.values())


def plain_calls(integrator, ttrace) -> int:
    return (integrator.render_fused_reference.calls + integrator.bounce_regen_reference.calls
            + integrator.bounce.calls + ttrace.closest_hit.calls)


def timed_renders(renderer, scene, torch, w, h):
    """One warmup render and three timed renders (the harness's,
    tools/bench.py:timed_renders); (warmup s, times, fb)."""
    from zig_weekend_raytracer_tpu_torch.tools.bench import timed_renders as harness_renders

    return harness_renders(renderer, scene, w, h, torch.cuda.synchronize)


def plan_parity(zt, fused, integrator, scene, plan, spp, card, tag, depth=DEPTH,
                lanes=SLICE_LANES, window=None):
    """Kernel vs plain version at a spread slice of ``lanes`` lanes of a
    lane plan, at the full spp and ``depth``; both timed.  With ``window``
    each lane renders only one ``window``-sample window of the spp samples,
    lane i the (i mod spp / window)-th, so that the slice covers every
    sample index (every Sobol sample bit) in a window's drain passes.
    Returns the check and the plain version's work counts
    (utils/workcount.py)."""
    import torch

    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    step = max(1, plan[0].shape[0] // lanes)
    px, py, s0, _ = (a[::step][:lanes].contiguous() for a in plan)
    kw = dict(
        camera_consts=camera_consts(scene.camera, W, H),
        sampler=zt.sampling.SamplerKind.SOBOL, width=W, height=H, spp=spp,
        stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field,
        want_work=True,
    )
    lim = s0 + spp
    if window:
        lane = torch.arange(s0.shape[0], dtype=s0.dtype, device=s0.device)
        s0 = (s0 + lane % (spp // window) * window).contiguous()
        lim = s0 + window
        tag = f"{tag} lanes, {spp} spp in {window}-sample windows"
    else:
        tag = f"{tag} lanes, {spp} spp"
    t_min = zt.dtypes.T_MIN
    with workcount.counting() as counts:
        ms_p, out_p = cuda_time_ms(
            lambda: plain_k1(fused, integrator, scene.compiled, px, py, s0, lim, 0, t_min, **kw)
        )
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
    )
    log(f"plain version at {px.shape[0]} {tag}: {ms_p:.1f} ms; kernel {ms_k:.3f} ms ({card})")
    check = compare(f"{px.shape[0]} {tag} d{depth}", out_k, out_p)
    return {**check, "ms": ms_k, "plain_ms": ms_p}, dict(counts)


def render_bound(zt, scene, counts, kernel_work, lane_bytes, has_dof, spp, walk=None) -> dict:
    """The roofline bound of a render-kernel run at ``spp`` spp, whose
    lanes did ``kernel_work`` bounces in all, from the plain version's
    ``counts`` on a slice scaled by that bounce count, the Sobol respawn in
    its factored form; ``lane_bytes`` is what the lanes read and write,
    beside the tables the trace reads under ``walk``
    (utils/roofline.py:render_bound, logged).  Each operation class at
    phase 1b's rate."""
    from zig_weekend_raytracer_tpu_torch.utils import roofline

    out = roofline.render_bound(scene.compiled, counts, kernel_work, lane_bytes, has_dof, spp,
                                walk, OPS_RATE["rate"])
    log(f"bound: {float(kernel_work):.0f} bounces, operations "
        f"{ {k: f'{v:.4g}' for k, v in out['bound_ops'].items()} }, {out['bound_bytes']:.4g} "
        f"bytes -> {out['bound_ms']:.3f} ms ({out['bound_by']}, {out['peak_source']} rates)")
    return out


def compare_bounce(tag, out_k, out_p) -> dict:
    """One bounce's state, kernel against plain version: alive equal on >=
    99.9% of lanes; where it agrees, throughput and radiance (and, where the
    path goes on, origin and direction) within rtol 1e-5 / atol 1e-6 on >=
    99.9% of lanes."""
    import numpy as np
    import torch

    arr = lambda *vs: torch.stack([c for v in vs for c in v]).cpu().numpy()
    ak, ap = out_k[4].cpu().numpy(), out_p[4].cpu().numpy()
    n = ak.size
    agree = ak == ap
    live = agree & ap
    pos_k, pos_p = arr(*out_k[:2]), arr(*out_p[:2])
    val_k, val_p = arr(*out_k[2:4]), arr(*out_p[2:4])
    pos_bad = live & ~np.isclose(pos_k, pos_p, rtol=HIT_RTOL, atol=HIT_ATOL).all(0)
    val_bad = agree & ~np.isclose(val_k, val_p, rtol=HIT_RTOL, atol=HIT_ATOL).all(0)
    bad = int((pos_bad | val_bad).sum())
    max_abs = max(float(np.abs(pos_k - pos_p)[:, live].max(initial=0.0)),
                  float(np.abs(val_k - val_p)[:, agree].max(initial=0.0)))
    differ = int(n - agree.sum())
    log(f"bounce {tag}: {n} lanes, {int(ap.sum())} go on, alive differs on {differ}, "
        f"state outside rtol {HIT_RTOL}/atol {HIT_ATOL} on {bad}, max |diff| {max_abs:.3e}")
    if not (np.isfinite(val_k).all() and np.isfinite(pos_k[:, ak]).all()):
        raise AssertionError(f"bounce {tag}: kernel state is not finite")
    if differ > (1.0 - HIT_AGREE) * n or bad > (1.0 - HIT_AGREE) * n:
        raise AssertionError(f"bounce {tag}: kernel disagrees with its plain version")
    return {"check": tag, "lanes": n, "alive_diff": differ, "state_bad": bad,
            "max_abs_err": max_abs}


def one_bounce_parity(zt, tb, integrator, torch, scene, name, depths, plains=None,
                      alive0=None, **opts) -> list:
    """bounce_kernel's one-bounce mode vs integrator.bounce on 400x400
    camera rays through the chained ``depths`` (each bounce starts both
    from the plain version's state), every lane live at first or those of
    the mask ``alive0``.  The first bounce also carries its roofline bound,
    from the plain version's work counts: lanes read and write 13 float and
    2 int state rows.  ``plains``, a list, collects the plain version's
    outputs; ``opts`` are the estimator options of both."""
    from zig_weekend_raytracer_tpu_torch.math.v3 import V3
    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    t_min = zt.dtypes.T_MIN
    cs = scene.compiled
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"), torch.arange(W, device="cuda"),
                            indexing="ij")
    rid = (ys * W + xs).reshape(-1)
    o, d, tm = camera_rays(zt, torch, scene, W, H, RTW_SPP)
    n = rid.shape[0]
    state = (o, d, V3.full((n,), 1.0, 1.0, 1.0, "cuda"), V3.zeros((n,), "cuda"),
             torch.ones((n,), dtype=torch.bool, device="cuda") if alive0 is None else alive0)
    out = []
    for depth in depths:
        o, d, thr, rad, alive = state
        dep = torch.full((n,), depth, dtype=torch.int64, device="cuda")
        ms_k, out_k = cuda_time_ms(
            lambda: tb.bounce(cs, 0, t_min, depth, o, d, tm, rid, thr, rad, alive, **opts), 3)
        with workcount.counting() as counts:
            ms_p, out_p = cuda_time_ms(
                lambda: integrator.bounce(cs, 0, t_min, dep, o, d, tm, rid, thr, rad, alive,
                                          **opts))
        check = compare_bounce(f"{name} 400x400 camera rays, depth {depth}", out_k, out_p)
        bound, by = roofline.bound_ms(roofline.render_ops(dict(counts), cs, False),
                                      n * 15 * 4 * 2 + roofline.render_table_bytes(cs),
                                      OPS_RATE["rate"])
        log(f"bounce {name} depth {depth}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms, "
            f"bound {bound:.4f} ms ({by})")
        out.append({**check, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
                    "peak_source": roofline.peak_source(OPS_RATE["rate"])})
        if plains is not None:
            plains.append(out_p)
        state = out_p
    return out


def phase_one_bounce(zt, tb, integrator, torch, scenes) -> list:
    """bounce_kernel's one-bounce mode vs integrator.bounce: rtw_final
    through three chained bounces, shrek_quads and earth one bounce each."""
    out = []
    for name, depths in (("rtw_final", (0, 1, 2)), ("shrek_quads", (0,)), ("earth", (0,))):
        out += one_bounce_parity(zt, tb, integrator, torch, scenes[name], name, depths)
    return out


def kernel_resources(build_log: str) -> dict:
    """{kernel instantiation: {"registers", "spill_bytes"}} from ptxas -v:
    fused_render_kernel<IMAGES, walk> (without and with the image fetch;
    every instantiation fed from the work queue, under the names they had
    before it) and bounce_kernel<REGEN, walk> (one-bounce and regenerating
    modes, the latter fed from the work queue too) for each tree walk and
    "no tree" (kWalkNoTree), each with its flags but kFlagPull
    (<..., estimator>, <..., prof>),
    closest_hit_kernel, coherent_keys_kernel, and chain_kernel<op, chains,
    unroll>."""
    import re

    from zig_weekend_raytracer_tpu_torch.ops.trace import WALKS
    from zig_weekend_raytracer_tpu_torch.tools.fp32_peak import OPS

    flag_names = {1: "prof", 2: "estimator"}
    pull = 4   # zwrt_device.cuh:kFlagPull, which every K1 instantiation takes
    walk_names = WALKS + ("no tree",)   # zwrt_device.cuh:Walk

    def name_of(mangled):
        m = re.search(r"(fused_render_kernel|bounce_kernel)ILb([01])ELi(\d)ELi(\d+)E", mangled)
        if m:
            flags = int(m.group(4)) & ~pull
            return (f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}, "
                    f"{walk_names[int(m.group(3))]}"
                    + (f", {flag_names[flags]}>" if flags else ">"))
        m = re.search(r"chain_kernelILi(\d)ELi(\d+)ELi(\d+)E", mangled)
        if m:
            return f"chain_kernel<{OPS[int(m.group(1))]}, {m.group(2)}, {m.group(3)}>"
        for name in ("closest_hit_kernel", "coherent_keys_kernel"):
            if re.search(rf"\d{name}E", mangled):
                return name
        return None

    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = name_of(m.group(1))
            if cur:
                out[cur] = {"registers": None, "spill_bytes": None}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_counts(lib_path: str) -> dict:
    """{chain_kernel<op, chains, unroll>: {opcode: count}} of the FP32
    opcodes in each chain kernel's SASS (cuobjdump -sass): the fma chain
    must be FFMA, not an FMUL and an FADD (the build has -fmad=false)."""
    import re
    import shutil

    from zig_weekend_raytracer_tpu_torch.tools.fp32_peak import OPS

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.Popen([tool, "-sass", lib_path], stdout=subprocess.PIPE, text=True)
    out, cur = {}, None
    for line in proc.stdout:
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"chain_kernelILi(\d)ELi(\d+)ELi(\d+)E", m.group(1))
            cur = f"chain_kernel<{OPS[int(k.group(1))]}, {k.group(2)}, {k.group(3)}>" if k else None
            if cur:
                out[cur] = {}
            continue
        if cur:
            for m in re.finditer(r"\b(FFMA|FADD|FMUL|FSETP|FSEL|FMNMX|IMAD|LOP3)\b", line):
                out[cur][m.group(1)] = out[cur].get(m.group(1), 0) + 1
    if proc.wait() != 0:
        raise AssertionError(f"cuobjdump -sass failed ({proc.returncode})")
    return out


def phase_fp32_peak(torch, built, card) -> dict:
    """Phase 1b: chain_kernel against its plain version on the card for the
    four ops at every (blocks per SM, chains, unroll) of the sweep, on the
    sweep's own grid with CHAIN_STEPS steps, its SASS, then the sweep with
    the scaling check (its launches counted); sets OPS_RATE to the measured
    add rate."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.tools import fp32_peak as fp
    from zig_weekend_raytracer_tpu_torch.utils import roofline

    c = fp.multipliers("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parity = []
    for blocks, chains, unroll in fp.SWEEP:
        n = sms * blocks * fp.THREADS
        iters = CHAIN_STEPS // unroll
        for op in fp.OPS:
            ms_k, out_k = cuda_time_ms(lambda: fp.chain(op, c, n, iters, chains, unroll), 3)
            ms_p, out_p = cuda_time_ms(lambda: fp.chain_reference(op, c, n, iters, chains, unroll))
            if op == "int":  # the bits of a u32 sum: equal exactly
                k, p = (o.view(torch.int32).cpu().numpy().astype(np.int64) for o in (out_k, out_p))
                err = float(np.abs(k - p).max())
                bad = int((k != p).sum())
            else:
                k, p = out_k.cpu().numpy(), out_p.cpu().numpy()
                err = float(np.abs(k - p).max())
                bad = int((~np.isclose(k, p, rtol=CHAIN_RTOL, atol=0.0)).sum())
            tag = f"chain {op}, {blocks} blocks/SM, {chains} chains, unroll {unroll}"
            log(f"{tag}: {n} threads, {iters} iters: outside rtol {CHAIN_RTOL} on {bad}, "
                f"max |diff| {err:.3e}; kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
            if bad or not np.isfinite(k).all():
                raise AssertionError(f"{tag}: chain_kernel disagrees with its plain version")
            parity.append({"check": tag, "op": op, "shape": [blocks, chains, unroll],
                           "threads": n, "iters": iters, "max_abs_err": err, "ms": ms_k,
                           "plain_ms": ms_p})
    sass = sass_counts(built["path"])
    for name, ops in sorted(sass.items()):
        log(f"  sass {name}: {ops}")
    fma = sass.get("chain_kernel<fma, 8, 64>", {})
    if fma.get("FFMA", 0) < 8 * 64 or fma.get("FMUL", 0) + fma.get("FADD", 0) >= 8 * 64:
        raise AssertionError(f"the fma chain is not FFMA in the SASS: {fma}")
    ints = sass.get("chain_kernel<int, 8, 64>", {})
    if ints.get("IMAD", 0) < 8 * 64 or ints.get("LOP3", 0) < 8 * 64:
        raise AssertionError(f"the int chain is not IMAD and LOP3 in the SASS: {ints}")
    fp.chain.launches = 0
    res = fp.run(fp.ITERS_QUICK)
    launches = fp.chain.launches
    for r in res["sweep"]:
        log(f"  sweep {r['op']} blocks/SM {r['blocks_per_sm']} chains {r['chains']} unroll "
            f"{r['unroll']}: {r['time_s'] * 1e3:.3f} ms, {r['gops']:.1f} Gops/s, "
            f"{r['gflops']:.1f} GFLOP/s")
    sc = res["iters_scaling"]
    log(f"fp32 peak (best of 3, {card}): Gops/s {res['gops']}, GFLOP/s {res['gflops']}; "
        f"physics bound {res['physics_bound']}; 4x/1x iters time ratio "
        f"{sc['time_ratio_4x']:.3f}; {launches} launches")
    if not res["ok"]:
        raise AssertionError(f"fp32 peak: over the physics bound {res['over_physics']} or "
                             f"not linear in iters ({sc['time_ratio_4x']:.3f})")
    OPS_RATE["rate"] = res["rates"]
    log(f"roofline rates (lane-operations/s): {res['rates']}")
    best = next(r for r in res["sweep"] if r["op"] == "add"
                and [r["blocks_per_sm"], r["chains"], r["unroll"]] == res["best_shape"]["add"])
    # the headline add run: its lane-operations over the data sheet's rate,
    # 128 multipliers in and one float per thread out
    ops = best["threads"] * best["chains"] * best["iters"] * best["unroll"]
    bound, by = roofline.bound_ms(ops, 128 * 4 + best["threads"] * 4)
    add_parity = next(p for p in parity
                      if p["op"] == "add" and p["shape"] == res["best_shape"]["add"])
    return {"parity": parity, "ms": best["time_s"] * 1e3, "plain_ms": add_parity["plain_ms"],
            "kernel_ms_at_plain_shape": add_parity["ms"], "bound_ms": bound, "bound_by": by,
            "instantiation": f"chain_kernel<add, {best['chains']}, {best['unroll']}>",
            "peak_source": roofline.peak_source(None), "launches": launches,
            "gops": res["gops"], "gflops": res["gflops"], "best_shape": res["best_shape"],
            "physics_bound": res["physics_bound"], "time_ratio_4x": sc["time_ratio_4x"],
            "sass": sass}


def emitter_scene(zt, budget):
    """tests/test_texlut.py's image-lamp scene: a quad lamp textured with a
    4x4 checker image over a gray floor, with a LUT of ``budget`` texels
    (0: none)."""
    import numpy as np

    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = (200, 40, 40)
    img[1::2, 1::2] = (40, 200, 40)
    b = zt.scene.SceneBuilder()
    m_lamp = b.diffuse_light(b.image_texture(img))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), m_gray))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), m_lamp))
    b.set_background((0.0, 0.0, 0.0))
    b.set_camera(zt.scene.Camera(look_from=(0, 2, 8), look_at=(0, 1, 0)))
    return b.compile(name="image_lamp", device="cuda", texture_lut=budget)


def start_cli(args, module="zig_weekend_raytracer_tpu_torch.cli"):
    """The port's CLI (or another of its ``module``s) as a subprocess from
    the repository root, started and not waited for; its output goes to
    temporary files (a full pipe would stall it while another is waited
    for)."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args],
        cwd=REPO, env=env, stdout=files[0], stderr=files[1], text=True,
    )
    proc.files = files
    return proc


def finish_cli(proc, t0, timeout=300):
    """Wait for a started CLI (killed past ``timeout`` s): its completed
    process and the seconds since ``t0``."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    wall = time.perf_counter() - t0
    texts = []
    for f in proc.files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return subprocess.CompletedProcess(proc.args, proc.returncode, *texts), wall


def cli_render_args(tmp, scene_name, w, spp, depth, lut=0) -> list:
    """The flags of one CLI render with --stats into <tmp>/<scene>.ppm."""
    args = [f"--image_width={w}", f"--image_height={w}", f"--samples_per_pixel={spp}",
            f"--ray_bounce_max_depth={depth}", f"--scene={scene_name}",
            f"--image_out_path={os.path.join(tmp, f'{scene_name}.ppm')}", "--stats=true"]
    return args + ([f"--texture_lut={lut}"] if lut else [])


def cli_render_check(zt, tmp, done, scene_name, w, spp, depth, lut=0) -> dict:
    """One CLI render (``done``: finish_cli's result): exit 0, the three
    stage lines and the stats line, and the PPM byte-equal to write_ppm of
    the same render made in this process (a fresh Renderer: the same lanes,
    and the RNG is content-addressed)."""
    import re

    from zig_weekend_raytracer_tpu_torch.io.ppm import write_ppm

    proc, wall = done
    out = os.path.join(tmp, f"{scene_name}.ppm")
    tag = f"cli {scene_name} {w}x{w} spp{spp} d{depth}" + (f" lut {lut}" if lut else "")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    for stage in STAGES:
        if not re.search(r"^\[\d+\.\d+ ms\]\t" + re.escape(stage) + "$", proc.stderr, re.M):
            raise AssertionError(f"{tag}: no stage line {stage!r}\n{proc.stderr[-2000:]}")
    stats = [ln for ln in proc.stdout.splitlines() if ln.startswith("stats: ")]
    if len(stats) != 1 or "Mpaths/s" not in stats[0]:
        raise AssertionError(f"{tag}: no stats line\n{proc.stdout[-2000:]}")
    scene = zt.models.load_scene(scene_name, device="cuda", texture_lut=lut)
    fb = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth).render_device(
        scene, w, w)
    ref = os.path.join(tmp, f"{scene_name}.ref.ppm")
    write_ppm(ref, fb.cpu().numpy())
    with open(out, "rb") as f_cli, open(ref, "rb") as f_ref:
        same = f_cli.read() == f_ref.read()
    log(f"{tag}: exit 0 in {wall:.1f} s, {stats[0]!r}; PPM byte-equal to the in-process "
        f"render: {same}")
    if not same:
        raise AssertionError(f"{tag}: the CLI's PPM differs from the in-process render's")
    return {"check": tag, "wall_s": wall, "stats": stats[0]}


def cli_slice_args(tmp) -> tuple:
    """The flags of phase 16's two renders of the estimator and driver
    flags (cornell 64x64, 16 spp, depth 10): the adaptive render with
    Russian roulette and the clamp, of the scene file of cornell; and the
    progressive render that resumes ``<tmp>/ck.npz``."""
    base = ["--image_width=64", "--image_height=64", "--samples_per_pixel=16",
            "--ray_bounce_max_depth=10"]
    adaptive = base + [f"--scene_file={CORNELL_FILE}", "--adaptive=1",
                       f"--russian_roulette={RR_START}", f"--clamp_indirect={CLAMP}",
                       f"--image_out_path={os.path.join(tmp, 'adaptive.ppm')}"]
    resume = base + ["--scene=cornell_box", f"--checkpoint={os.path.join(tmp, 'ck.npz')}",
                     "--checkpoint_batch_spp=4",
                     f"--image_out_path={os.path.join(tmp, 'resume.ppm')}"]
    return adaptive, resume


def cli_slice_checks(zt, tmp, done_adaptive, done_resume, want_adaptive, want_resume) -> list:
    """Both renders of cli_slice_args exit 0 and write the PPM of the same
    render made in this process; the progressive one logs its resume."""
    from zig_weekend_raytracer_tpu_torch.io.ppm import write_ppm

    out = []
    for (proc, wall), name, want, tag in (
            (done_adaptive, "adaptive", want_adaptive,
             "cli --scene_file=cornell_box.json --adaptive=1 --russian_roulette=3 "
             "--clamp_indirect=10 64x64 spp16 d10"),
            (done_resume, "resume", want_resume,
             "cli --checkpoint resumed at 8 of 16 spp, cornell 64x64 d10")):
        if proc.returncode != 0:
            raise AssertionError(f"{tag}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, f"{name}.ref.ppm")
        write_ppm(ref, want)
        with open(os.path.join(tmp, f"{name}.ppm"), "rb") as a, open(ref, "rb") as b:
            same = a.read() == b.read()
        resumed = "resuming render from checkpoint: 8/16" in proc.stderr
        log(f"{tag}: exit 0 in {wall:.1f} s; PPM byte-equal to the in-process render: {same}"
            + (f"; resumed: {resumed}" if name == "resume" else ""))
        if not same or (name == "resume" and not resumed):
            raise AssertionError(f"{tag}: the CLI's render is not the in-process one")
        out.append({"check": tag, "wall_s": wall, "byte_equal": same})
    return out


def phase_cli(zt, torch) -> list:
    """Phase 16: the CLI as six subprocesses, started together (each
    spends most of its time starting up) and then checked in turn."""
    import tempfile

    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer

    renders = (("emissive", 96, 16, 10, 0), ("rtw_final", 64, 4, 10, LUT_32K))
    checks = []
    with tempfile.TemporaryDirectory() as tmp:
        # the checkpoint that the progressive CLI render resumes: 8 of 16 spp
        cornell = zt.models.load_scene("cornell_box", device="cuda")
        r16 = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=10)

        class Stop(Exception):
            pass

        def stop_at_8(done, _):
            if done == 8:
                raise Stop

        try:
            ProgressiveRenderer(r16, os.path.join(tmp, "ck.npz")).render(
                cornell, 64, 64, batch_spp=4, on_batch=stop_at_8)
        except Stop:
            pass
        adaptive_args, resume_args = cli_slice_args(tmp)
        t0 = time.perf_counter()
        procs = [start_cli(cli_render_args(tmp, *r)) for r in renders]
        procs.append(start_cli(["--image_width=8", "--image_height=8", "--scene=bogus"]))
        procs.append(start_cli(["--image_width=64", "--image_height=64", "--samples_per_pixel=8",
                                "--ray_bounce_max_depth=10", "--scene=cornell_box",
                                "--profile=device",
                                f"--image_out_path={os.path.join(tmp, 'c.ppm')}"]))
        procs += [start_cli(adaptive_args), start_cli(resume_args)]
        # what those two must write, rendered here while they start
        r_est = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=10,
                                   russian_roulette=RR_START, clamp_indirect=CLAMP)
        want_adaptive = r_est.render_adaptive(cornell, 64, 64).cpu().numpy()
        want_resume = ProgressiveRenderer(r16, os.path.join(tmp, "whole.npz")).render(
            cornell, 64, 64, batch_spp=4)
        try:
            done = [finish_cli(p, t0) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, d in zip(renders, done):
            checks.append(cli_render_check(zt, tmp, d, *r))
        proc = done[2][0]
        if proc.returncode != 1 or "Usage: --key=value" not in proc.stderr:
            raise AssertionError(f"cli --scene=bogus: exit {proc.returncode}, no usage text\n"
                                 f"{proc.stderr[-2000:]}")
        log(f"cli --scene=bogus: exit 1, usage on stderr, {proc.stderr.strip().splitlines()[-1]!r}")
        checks.append({"check": "cli --scene=bogus", "exit": 1})
        proc = done[3][0]
        rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("fused_render_kernel ")]
        if proc.returncode != 0 or not rows:
            raise AssertionError(f"cli --profile=device: exit {proc.returncode}, no "
                                 f"fused_render_kernel row\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-2000:]}")
        log("cli --profile=device on cornell 64x64: " + " | ".join(
            ln for ln in proc.stdout.splitlines() if ln.strip() and not ln.startswith("stats")))
        checks.append({"check": "cli --profile=device", "row": rows[0]})
        checks += cli_slice_checks(zt, tmp, done[4], done[5], want_adaptive, want_resume)
    return checks


def regen_parity(zt, tb, integrator, torch, scene, w, spp, depth, tag, lanes=None,
                 plains=None, sampler=None, window=None):
    """bounce_kernel's regenerating mode vs bounce_regen_reference from
    fresh lanes (every pixel of a w x w image, or ``lanes`` = (px, py) of
    a plan) under ``sampler`` (Sobol when None), checked with phase 2's
    tolerances; every lane must end drained.  With ``window`` each lane
    renders one ``window``-sample window of the spp, as plan_parity's.  Returns the check (with both times), the plain version's work
    counts and the kernel's total bounces; ``plains``, a list, collects the
    plain version's final state."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    if lanes is None:
        ys, xs = torch.meshgrid(torch.arange(w, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")
        lanes = (xs.reshape(-1).to(torch.int32).contiguous(),
                 ys.reshape(-1).to(torch.int32).contiguous())
    px, py = lanes
    s0 = torch.zeros_like(px)
    s1 = torch.full_like(px, spp)
    if window:
        lane = torch.arange(px.shape[0], dtype=px.dtype, device=px.device)
        s0 = (lane % (spp // window) * window).contiguous()
        s1 = (s0 + window).contiguous()
    kw = dict(camera_consts=camera_consts(scene.camera, w, w),
              sampler=sampler or zt.sampling.SamplerKind.SOBOL, width=w, height=w, spp=spp,
              stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field)
    st0 = integrator.initial_regen_state(s0, 1)
    t_min = zt.dtypes.T_MIN
    ms_k, st_k = cuda_time_ms(
        lambda: tb.bounce_regen(scene.compiled, st0, px, py, s1, 0, t_min, **kw), 3)
    with workcount.counting() as counts:
        ms_p, st_p = cuda_time_ms(
            lambda: integrator.bounce_regen_reference(scene.compiled, st0, px, py, s1, 0, t_min, **kw))
    if bool(st_k.alive.any()) or bool((st_k.sample + 1 < s1).any()):
        raise AssertionError(f"regen {tag}: the kernel left lanes undrained")
    check = compare(tag, (st_k.radiance, st_k.work), (st_p.radiance, st_p.work))
    log(f"regen {tag}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
    if plains is not None:
        plains.append(st_p)
    return {**check, "ms": ms_k, "plain_ms": ms_p}, dict(counts), int(st_k.work.sum())


def region_gates(zt, np, scene, name, grid64=8) -> list:
    """The scene's region gates through utils/goldengate.py: 200x200
    against tests/golden/scene_regions.json and 64x64 against
    tests/golden/<name>.npz, each at the spp and depth recorded there; the
    64x64 gate on ``grid64`` x ``grid64`` regions."""
    from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer, region_means

    with open(SCENE_REGIONS) as f:
        reg = json.load(f)["scenes"][name]
    fb200 = zt.render.Renderer(
        samples_per_pixel=reg["spp"], max_ray_bounce_depth=reg["depth"]
    ).render_device(scene, reg["width"], reg["height"])
    out = [gate(f"{name} 200x200 spp{reg['spp']} d{reg['depth']}", fb200, reg["mean"],
                reg["region_means"])]
    golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
    fb64 = zt.render.Renderer(
        samples_per_pixel=int(golden["spp"]), max_ray_bounce_depth=int(golden["depth"]),
        seed=int(golden["seed"]),
    ).render_device(scene, int(golden["width"]), int(golden["height"]))
    tag = f"{name} 64x64 spp{int(golden['spp'])} d{int(golden['depth'])}"
    if grid64 != 8:
        fine = check_framebuffer(fb64.cpu().numpy(), float(golden["fb"].mean()),
                                 region_means(golden["fb"], 8))
        log(f"region gate {tag} on 8x8 regions (not gated): {fine}")
        tag += f", {grid64}x{grid64} regions"
    out.append(gate(tag, fb64, golden["fb"].mean(), region_means(golden["fb"], grid64)))
    return out


def gate(tag, fb, ref_mean, ref_regions) -> str:
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer

    fb = fb.cpu().numpy()
    if not np.isfinite(fb).all():
        raise AssertionError(f"{tag}: framebuffer is not finite")
    verdict = check_framebuffer(fb, float(ref_mean), np.asarray(ref_regions))
    log(f"region gate {tag}: {verdict} (mean {fb.mean():.5f} vs {float(ref_mean):.5f})")
    if not verdict.startswith("pass"):
        raise AssertionError(f"region gate {tag} failed: {verdict}")
    return verdict


def feature_scene(zt, image=False):
    """tests/test_torch_fused_render.py's all-materials scene (checker
    texture, fuzzy metal, an isotropic medium in a moving sphere, glass, a
    quad light), with one image-textured quad added when ``image``."""
    import numpy as np

    b = zt.scene.SceneBuilder()
    chk = b.checkerboard(0.3, b.solid_color((0.2, 0.3, 0.1)), b.solid_color((0.9, 0.9, 0.9)))
    b.add(b.quad((-5, -1, -5), (10, 0, 0), (0, 0, 10), b.lambertian(chk)))
    b.add(b.sphere((0.1, 0.5, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.3)))
    b.add(b.moving_sphere((2.1, 0.5, 0), (2.1, 1.0, 0), 0.7,
                          b.isotropic(b.solid_color((0.5, 0.5, 0.9)))))
    b.add(b.sphere((-2.1, 0.5, 0.3), 0.8, b.dielectric(1.5)))
    light = b.add(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                         b.diffuse_light(b.solid_color((8, 8, 8)))))
    if image:
        img = np.random.default_rng(6).integers(0, 256, (24, 40, 3), dtype=np.uint8)
        b.add(b.quad((-3, -1, -2), (6, 0, 0), (0, 3, 0), b.lambertian(b.image_texture(img))))
    b.set_lights([light])
    b.set_background((0.3, 0.4, 0.6))
    b.set_camera(zt.scene.Camera(look_from=(0.3, 2, 8), look_at=(0, 0.5, 0)))
    return b.compile(name="features" + ("_image" if image else ""), device="cuda")


def nine_light_scene(zt):
    """tests/test_torch_device_tables.py's floor under 9 lights (5 quads,
    4 spheres), past the 8 lights the kernels once took."""
    b = zt.scene.SceneBuilder()
    gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), gray))
    lights = []
    for k in range(9):
        lamp = b.diffuse_light(b.solid_color((1.0 + k, 2.0, 3.0)))
        x = -4.0 + k
        if k % 2 == 0:
            lights.append(b.add(b.quad((x, 3.0, -0.5), (0.8, 0, 0), (0, 0, 0.8), lamp)))
        else:
            lights.append(b.add(b.sphere((x, 2.5, 0.5), 0.3, lamp)))
    b.set_lights(lights)
    b.set_background((0.0, 0.0, 0.0))
    b.set_camera(zt.scene.Camera(look_from=(0, 4, 9), look_at=(0, 1, 0)))
    return b.compile(name="nine_lights", device="cuda")


def phase_samplers(zt, fused, tb, integrator, torch) -> list:
    """Phase 19: the respawn that all three samplers share, held on the
    card: the render kernel on the all-materials scene and the bounce
    kernel's regenerating mode on it with an image quad, under the
    independent, stratified and Sobol samplers (32x32, 8 spp, depth 10),
    then the render kernel on the 9-light scene; phase 2's tolerances."""
    kinds = zt.sampling.SamplerKind
    feat, feat_img = feature_scene(zt), feature_scene(zt, image=True)
    if not (feat.compiled.has_moving and feat.compiled.needs_gauss
            and feat_img.compiled.has_image_textures):
        raise AssertionError("the all-materials scenes lack a feature")
    out = []
    for kind in (kinds.INDEPENDENT, kinds.STRATIFIED, kinds.SOBOL):
        out.append(render_parity(zt, fused, integrator, torch, feat,
                                 f"all materials, {kind.value} 32x32 spp8 d{DEPTH}",
                                 sampler=kind))
        out.append(regen_parity(zt, tb, integrator, torch, feat_img, 32, 8, DEPTH,
                                f"all materials + image quad, {kind.value} 32x32 spp8 d{DEPTH}",
                                sampler=kind)[0])
    out.append(render_parity(zt, fused, integrator, torch, nine_light_scene(zt),
                             f"9 lights 32x32 spp8 d{DEPTH}"))
    return out


def plan_of(renderer, cs):
    """The lane plan a renderer cached for a scene (after the renders that
    build it: one for a coherent plan, two for a cost-sorted one)."""
    return next(e["plan"] for e in renderer._plan_cache[cs].values() if "plan" in e)


def prof_summary(prof) -> dict:
    """Cycle shares and mean converged lanes per warp at each phase's entry
    from a (PROF_COLS, N) profile."""
    from zig_weekend_raytracer_tpu_torch.ops.fused_render import PROF_PHASES

    c = prof.sum(1).tolist()
    k = len(PROF_PHASES)
    total = max(c[3 * k], 1)
    shares = {ph: c[i] / total for i, ph in enumerate(PROF_PHASES)}
    shares["other"] = 1.0 - sum(shares.values())
    active = {ph: c[2 * k + i] / max(c[k + i], 1) for i, ph in enumerate(PROF_PHASES)}
    entries = {ph: c[k + i] for i, ph in enumerate(PROF_PHASES)}
    # a phase's lanes run it together, so its warp time is its lane cycles
    # over the lanes that entered; a warp's time is a lane's whole drain
    warp = {ph: shares[ph] / max(active[ph], 1e-9) * 32 for ph in PROF_PHASES}
    return {"cycle_share": shares, "warp_time_share": warp, "active_lanes": active,
            "entries": entries}


def phase_profile(zt, fused, tb, integrator, torch, configs, card) -> dict:
    """Phase 20, the phase profile of K1 and K2 at each configuration (name,
    scene, spp, depth) over the lanes its renders take (Renderer.
    render_lanes: a brute scene's first render, whose plain layout every
    request with a new seed takes, and a tree scene's coherent plan): the
    profiled kernel's cycle share of respawn, trace and shade, the
    warp-time share and the mean converged lanes per warp entering each
    phase, over the threads of K1's or K2's work-queue kernel; its
    radiance bit for bit that of the kernel the render launches
    (render_fused, bounce_regen, over the same grid and items)."""
    from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_fused_render
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    t_min = zt.dtypes.T_MIN
    out = {}
    for name, scene, spp, depth in configs:
        cs = scene.compiled
        renderer = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
        with env("ZWRT_NO_SORT", "1"):
            if cs.has_sph_tree or cs.has_quad_tree:
                renderer.render_device(scene, W, H)
            *plan, stride = renderer.render_lanes(scene, W, H)
        kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
                  width=W, height=H, spp=spp, stride=stride, max_depth=depth,
                  has_dof=scene.camera.has_depth_of_field)
        seed = renderer.seed
        if supports_fused_render(cs):
            kernel = "K1"
            (rad_p, _), prof = fused.render_fused_profile(cs, *plan, seed, t_min, **kw)
            rad = fused.render_fused(cs, *plan, seed, t_min, **kw)
        else:
            kernel = "K2"
            args = (cs, integrator.initial_regen_state(plan[2], stride), plan[0], plan[1],
                    plan[3], seed, t_min)
            st, prof = tb.bounce_regen_profile(*args, **kw)
            rad_p, rad = st.radiance, tb.bounce_regen(*args, **kw).radiance
        if not torch.equal(rad_p.to_array(), rad.to_array()):
            raise AssertionError(f"{name}: the profiled kernel's radiance differs from the "
                                 "render's kernel's")
        summ = prof_summary(prof)
        walk = ttrace_walk(zt, cs, None)
        log(f"profile {name} ({kernel}, {walk} walk, {plan[0].shape[0]} lanes, "
            f"{prof.shape[1]} threads; {card}): cycle share "
            f"{ {k: round(v, 4) for k, v in summ['cycle_share'].items()} }, warp-time share "
            f"{ {k: round(v, 4) for k, v in summ['warp_time_share'].items()} }, mean active "
            f"lanes per warp entering { {k: round(v, 2) for k, v in summ['active_lanes'].items()} }, "
            f"entries {summ['entries']}; radiance bitwise the render's kernel's")
        out[name] = {"kernel": kernel, "walk": walk, "lanes": plan[0].shape[0],
                     "threads": prof.shape[1], **summ}
    return out


def ttrace_walk(zt, cs, walk):
    from zig_weekend_raytracer_tpu_torch.ops.trace import walk_of

    with trav(walk):
        return walk_of(cs)


def phase_sweep(zt, card) -> dict:
    """Phase 21: tools/span_sweep.py on the card: leaf spans 1, 2, 4, 8
    under the cond and queue walks on balls 400x400@128 d10 (render
    kernel) and rtw_final 400x400@64 d8 (bounce kernel), and under the uni
    walk (the unified tree) on rtw_final, each render against the JAX-span
    cond render of this run (differing pixels counted and printed);
    rtw_final with the LUT (render kernel) at the winning setting; then
    cond against queue at the port's span in 5 alternating pairs on both
    scenes, which decide the default walk, and uni against queue on
    rtw_final at the port's span."""
    from zig_weekend_raytracer_tpu_torch.geometry.bvh import pick_leaf_span
    from zig_weekend_raytracer_tpu_torch.tools import span_sweep

    res = span_sweep.sweep(log)
    best = {name: max(r["cells"].items(), key=lambda kv: kv[1]["mpaths_per_s"])[0]
            for name, r in res.items()}
    span, walk = best["rtw_final"].split(",")
    lut = span_sweep.lut_cell(int(span), walk, res["rtw_final"]["ref_fb"], log)
    pairs = {name: span_sweep.pairs(name, (("cond", None, "cond"), ("queue", None, "queue")),
                                    log=log) for name in span_sweep.SCENES}
    pairs["rtw_final uni"] = span_sweep.uni_pairs(log)
    for r in res.values():
        r.pop("ref_fb")
    log(f"sweep ({card}): best cell per scene {best}; the port's spans: balls "
        f"{pick_leaf_span(485)}, rtw_final {pick_leaf_span(1005)} / {pick_leaf_span(2401)}")
    return {"sweep": res, "best": best, "lut": lut, "walk_pairs": pairs}


def walk_scenes(zt, rtw, rtw_lut, balls) -> dict:
    """The scenes of phases 17 and 18, at leaf span 2 (the plain walks'
    time grows with the tree's nodes): balls, rtw_final with the atlas,
    and rtw_final compiled with ZWRT_UNI_TREE=1 with the atlas and with a
    native-budget texture LUT; and at the port's span (""), rtw_final with
    the unified tree, with the atlas and with the LUT, beside the main
    paths' per-kind ``rtw``, ``rtw_lut`` and ``balls``."""
    out = {"rtw_port": rtw, "rtw_lut_port": rtw_lut, "balls_port": balls}
    for span, suffix in ((2, ""), (None, "_port")):
        with leaf_span(span), env("ZWRT_UNI_TREE", "1"):
            out["rtw_uni" + suffix] = zt.models.load_scene("rtw_final", device="cuda")
            out["rtw_uni_lut" + suffix] = zt.models.load_scene("rtw_final", device="cuda",
                                                               texture_lut=LUT_NATIVE)
    with leaf_span(2):
        out["balls2"] = zt.models.load_scene("balls", device="cuda")
        out["rtw"] = zt.models.load_scene("rtw_final", device="cuda")
        out["rtw_lut"] = zt.models.load_scene("rtw_final", device="cuda",
                                              texture_lut=LUT_NATIVE)
    for key in ("rtw_uni", "rtw_uni_port"):
        cu = out[key].compiled
        log(f"unified tree of rtw_final: {cu.uni_tree_box.shape[0]} nodes at leaf span "
            f"{cu.uni_leaf_span} (per-kind trees {cu.sph_tree_box.shape[0]} + "
            f"{cu.quad_tree_box.shape[0]} nodes)")
        if not (cu.has_uni_tree and out[key.replace("uni", "uni_lut")].compiled.has_uni_tree):
            raise AssertionError("rtw_final compiled without its unified tree under "
                                 "ZWRT_UNI_TREE=1")
    if out["rtw_uni_port"].compiled.uni_leaf_span == 2:
        raise AssertionError("the port's span of rtw_final's unified tree is phase 17's span 2")
    return out


def phase_walk_parity(zt, fused, tb, integrator, torch, sc) -> dict:
    """Phase 17: each walk's instantiations against their plain versions on
    the card (K1 on balls at span 2, K2's regenerating mode and its
    one-bounce mode with every lane live and with every other lane dead on
    rtw_final, K1 with the LUT on rtw_final under uni), and each walk's
    plain version against the default walk's plain version on the same
    inputs.  Returns {walk: {case: (check, plain work counts or None)}} and
    the plain-vs-plain checks under "plain"."""

    def cases(walk):
        """{case: (check, plain output, plain work counts or None)}."""
        rtw = sc["rtw_uni" if walk == "uni" else "rtw"]
        out = {}
        if walk != "uni":  # balls has no quads, so no unified tree
            plains = []
            check = render_parity(zt, fused, integrator, torch, sc["balls2"],
                                  f"{walk} walk: balls span 2 32x32 spp{WALK_SPP} d{WALK_DEPTH}",
                                  depth=WALK_DEPTH, plains=plains, spp=WALK_SPP)
            out["K1 balls"] = (check, *plains[0])
        plains = []
        check, counts, _ = regen_parity(zt, tb, integrator, torch, rtw, 32, WALK_SPP, WALK_RTW_DEPTH,
                                        f"{walk} walk: rtw_final 32x32 spp{WALK_SPP} "
                                        f"d{WALK_RTW_DEPTH}", plains=plains)
        out["K2 regen"] = (check, plains[0], counts)
        if walk in ("uni", "cond"):
            plains = []
            check = render_parity(zt, fused, integrator, torch,
                                  sc["rtw_uni_lut" if walk == "uni" else "rtw_lut"],
                                  f"{walk} walk: rtw_final LUT 32x32 spp{WALK_SPP} d{WALK_RTW_DEPTH}",
                                  WALK_RTW_DEPTH, plains=plains, spp=WALK_SPP)
            out["K1 LUT"] = (check, *plains[0])
        plains = []
        check = one_bounce_parity(zt, tb, integrator, torch, rtw, f"{walk} walk: rtw_final",
                                  (0,), plains)[0]
        out["K2 one bounce"] = (check, plains[0], None)
        # every other lane dead: the live lanes of a warp reach the trace
        # from a divergent branch (the rowqueue walk's group is half a warp)
        plains = []
        odd = torch.arange(W * H, device="cuda") % 2 == 1
        check = one_bounce_parity(zt, tb, integrator, torch, rtw,
                                  f"{walk} walk: rtw_final, every other lane dead", (0,), plains,
                                  alive0=odd)[0]
        out["K2 one bounce, half dead"] = (check, plains[0], None)
        return out

    result, default = {"plain": []}, None
    # the unified tree at the port's span: its K2 and K1 LUT parity, whose
    # plain work counts give phase 18's port-span bounds, and the default
    # walk's K2 on the per-kind trees there, whose counts phase 18 prints
    # beside uni's
    port = {}
    plains = []
    port["K2 regen"] = regen_parity(
        zt, tb, integrator, torch, sc["rtw_uni_port"], 32, WALK_SPP, WALK_RTW_DEPTH,
        f"uni walk, port's span: rtw_final 32x32 spp{WALK_SPP} d{WALK_RTW_DEPTH}")[:2]
    check = render_parity(zt, fused, integrator, torch, sc["rtw_uni_lut_port"],
                          f"uni walk, port's span: rtw_final LUT 32x32 spp{WALK_SPP} "
                          f"d{WALK_RTW_DEPTH}", WALK_RTW_DEPTH, plains=plains, spp=WALK_SPP)
    port["K1 LUT"] = (check, plains[0][1])
    with trav(DEFAULT_WALK):
        port["K2 regen, default walk"] = regen_parity(
            zt, tb, integrator, torch, sc["rtw_port"], 32, WALK_SPP, WALK_RTW_DEPTH,
            f"{DEFAULT_WALK} walk, port's span: rtw_final 32x32 spp{WALK_SPP} "
            f"d{WALK_RTW_DEPTH}")[:2]
    result["uni port span"] = port
    # the rowqueue walk at the port's span, where a block stages only a
    # preorder prefix of the quad tree in shared memory (the wrapper's
    # budget, ops/fused_render.py:rowqueue_staged_nodes): its K2 and K1 LUT
    # against their plain versions, and the cond walk's K2 there, whose
    # plain work counts price the rowqueue walk's bound at that span
    for key in ("rtw", "rtw_port"):
        cs = sc[key].compiled
        staged = fused.rowqueue_staged_nodes(cs)
        trees = {k: getattr(cs, f"{k}_tree_box").shape[0] for k in staged}
        log(f"rowqueue walk on rtw_final at leaf span {cs.sph_leaf_span}: a block stages "
            f"{staged} of the trees' {trees} nodes in shared memory ("
            + ("in part" if staged != trees else "whole") + ")")
    rq = {}
    with trav("rowqueue"):
        rq["K2 regen"] = regen_parity(
            zt, tb, integrator, torch, sc["rtw_port"], 32, WALK_SPP, WALK_RTW_DEPTH,
            f"rowqueue walk, port's span: rtw_final 32x32 spp{WALK_SPP} d{WALK_RTW_DEPTH}")[:2]
        plains = []
        check = render_parity(zt, fused, integrator, torch, sc["rtw_lut_port"],
                              f"rowqueue walk, port's span: rtw_final LUT 32x32 spp{WALK_SPP} "
                              f"d{WALK_RTW_DEPTH}", WALK_RTW_DEPTH, plains=plains, spp=WALK_SPP)
        rq["K1 LUT"] = (check, plains[0][1])
    with trav("cond"):
        rq["K2 regen, cond walk"] = regen_parity(
            zt, tb, integrator, torch, sc["rtw_port"], 32, WALK_SPP, WALK_RTW_DEPTH,
            f"cond walk, port's span: rtw_final 32x32 spp{WALK_SPP} d{WALK_RTW_DEPTH}")[:2]
    result["rowqueue port span"] = rq
    # the queue walk at the port's span, the main paths' trees: its K1 on
    # balls and K1 with the LUT on rtw_final against their plain versions,
    # and the cond walk's plain counts there, which price phase 18's
    # port-span bounds of the queue walk (its K2 there is the unified-tree
    # block's default-walk case, the cond walk's K2 the rowqueue block's)
    qp = {"K2 regen": port["K2 regen, default walk"],
          "K2 regen, cond walk": rq["K2 regen, cond walk"]}
    for walk, suffix in ((DEFAULT_WALK, ""), ("cond", ", cond walk")):
        with trav(walk):
            for case, key, depth in (("K1 balls", "balls_port", WALK_DEPTH),
                                     ("K1 LUT", "rtw_lut_port", WALK_RTW_DEPTH)):
                plains = []
                check = render_parity(
                    zt, fused, integrator, torch, sc[key],
                    f"{walk} walk, port's span: {sc[key].name}{' LUT' if case == 'K1 LUT' else ''} "
                    f"32x32 spp{WALK_SPP} d{depth}", depth, plains=plains, spp=WALK_SPP)
                qp[case + suffix] = (check, plains[0][1])
    result["queue port span"] = qp
    result["queue hits"] = plain_queue_hits(zt, torch, sc)
    # the unified tree walked as its first design (ops/trace.py:
    # uni_cond_walk, one cond walk that culls with the running t): its
    # plain work counts price the uni walk's bounds (walk_bound_counts), and
    # the kernel is held to it as well, since the hits are the same
    from zig_weekend_raytracer_tpu_torch.ops.trace import uni_cond_walk

    culled = {}
    with uni_cond_walk():
        for key, suffix, where in (("uni", "", ""), ("uni port span", "_port", ", port's span")):
            plains = []
            regen = regen_parity(
                zt, tb, integrator, torch, sc["rtw_uni" + suffix], 32, WALK_SPP, WALK_RTW_DEPTH,
                f"uni walk vs its plain first design{where}: rtw_final 32x32 spp{WALK_SPP} "
                f"d{WALK_RTW_DEPTH}")[:2]
            check = render_parity(zt, fused, integrator, torch, sc["rtw_uni_lut" + suffix],
                                  f"uni walk vs its plain first design{where}: rtw_final LUT "
                                  f"32x32 spp{WALK_SPP} d{WALK_RTW_DEPTH}", WALK_RTW_DEPTH,
                                  plains=plains, spp=WALK_SPP)
            culled[key] = {"K2 regen": regen, "K1 LUT": (check, plains[0][1])}
    result["uni cond"] = culled
    result["short queue"] = short_queue_refused(zt, fused, torch, sc)
    for walk in ("cond",) + NEW_WALKS:
        with trav(walk):
            got = cases(walk)
        result[walk] = {name: (check, counts) for name, (check, _, counts) in got.items()}
        if default is None:
            default = got
            continue
        for name, (_, mine, _) in got.items():
            ref = default[name][1]
            tag = f"plain {walk} walk vs plain cond walk: {name}"
            if name.startswith("K2 one bounce"):
                result["plain"].append(compare_bounce(tag, mine, ref))
            elif name == "K2 regen":
                result["plain"].append(compare(tag, (mine.radiance, mine.work),
                                               (ref.radiance, ref.work)))
            else:
                result["plain"].append(compare(tag, mine, ref))
    bitwise([c for c, _ in result["rowqueue"].values()]
            + [result["rowqueue port span"][k][0] for k in ("K2 regen", "K1 LUT")],
            "the rowqueue walk's kernels against their plain versions")
    bitwise([c for c, _ in result[DEFAULT_WALK].values()]
            + [result["queue port span"][k][0] for k in ("K1 balls", "K1 LUT", "K2 regen")],
            f"the {DEFAULT_WALK} walk's kernels against their plain versions")
    bitwise([c for c in result["plain"] if c["check"].startswith(f"plain {DEFAULT_WALK} walk")],
            f"the plain {DEFAULT_WALK} walk's outputs against the plain cond walk's")
    return result


def plain_queue_hits(zt, torch, sc) -> list:
    """The plain queue walk's hits (t, kind, idx) bitwise the plain cond
    walk's on the card, on the 64x64 camera rays of balls and rtw_final at
    the port's span, and the work each walk counts: the queue walk's slab
    tests and leaf visits at least the cond walk's and at most those of the
    whole walk with the seed t (the plain queue walk at a capacity that
    holds every leaf, ops/fused_render.py:queue_capacity, never sweeps
    before its walk's end)."""
    from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
    from zig_weekend_raytracer_tpu_torch.ops.fused_render import queue_capacity
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    out = []
    for key in ("balls_port", "rtw_port"):
        scene = sc[key]
        rays = camera_rays(zt, torch, scene, 64, 64, 1)
        got = {}
        cap = {"cond": ttrace.QUEUE_CAP, DEFAULT_WALK: ttrace.QUEUE_CAP,
               "seed t": queue_capacity(scene.compiled, "spec")}
        for form in ("cond", DEFAULT_WALK, "seed t"):
            with workcount.counting() as c:
                hit = ttrace.closest_hit(scene.compiled, *rays, zt.dtypes.T_MIN,
                                         walk="cond" if form == "cond" else DEFAULT_WALK,
                                         queue_cap=cap[form])
            got[form] = (hit, {k: c[k] for k in ("slab_test", "leaf_visit")})
        check = compare_hits(f"plain {DEFAULT_WALK} walk vs plain cond walk, {scene.name} "
                             "64x64 camera rays", got[DEFAULT_WALK][0], got["cond"][0])
        counts = {form: c for form, (_, c) in got.items()}
        log(f"{scene.name} 64x64 camera rays, work of the plain walks (slab tests, leaf "
            "visits): " + "; ".join(f"{f} {c['slab_test']}, {c['leaf_visit']}"
                                   for f, c in counts.items()))
        for k in ("slab_test", "leaf_visit"):
            if not counts["cond"][k] <= counts[DEFAULT_WALK][k] <= counts["seed t"][k]:
                raise AssertionError(f"{scene.name}: the {DEFAULT_WALK} walk's {k} is not "
                                     "between the cond walk's and the seed-t walk's")
        out.append({**check, "counts": counts})
    return out


def bitwise(checks, what) -> None:
    """Raises unless each check of compare or compare_bounce found its
    kernel's output bitwise the plain version's."""
    for c in checks:
        if c["max_abs_err"] != 0.0 or c.get("work_diff", 0) or c.get("alive_diff", 0):
            raise AssertionError(f"{what}: {c['check']} is not bitwise")
    log(f"{what}: bitwise in {len(checks)} cases")


def short_queue_refused(zt, fused, torch, sc) -> list:
    """A render-kernel launch of each walk with a device or per-warp queue
    (rowqueue and spec on balls at span 2, uni on rtw_final with the LUT)
    whose queue capacity is one below the leaves its tree may hold ((n +
    1) / 2 of n nodes), a launch of the queue walk whose capacity is not
    the kernel's kQueueCap, and one without its packed node tables, are
    each refused with cudaErrorInvalidValue (1), before they run, and count
    no launch (zwrt_device.cuh:set_walk)."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    out = []
    lane = torch.arange(64, dtype=torch.int32, device="cuda")
    px, py = (lane % 8).contiguous(), (lane // 8).contiguous()
    zero = torch.zeros_like(lane)
    real_walk_args, real_node_args = fused.walk_args, fused.node_args
    for walk, name, what in (
            ("rowqueue", "balls2", "short"), ("spec", "balls2", "short"),
            ("uni", "rtw_uni_lut", "short"), ("queue", "balls2", "short"),
            ("queue", "balls2", "no nodes")):
        cs = sc[name].compiled
        nodes = cs.uni_tree_box.shape[0] if walk == "uni" else cs.sph_tree_box.shape[0]
        short = fused.QUEUE_CAP - 1 if walk == "queue" else (nodes + 1) // 2 - 1

        def shortened(scene, n, smem_before=0):
            walk_, code, cap, queue = real_walk_args(scene, n, smem_before)
            return walk_, code, short, queue

        launches = dict(fused.render_fused.launches)
        if what == "short":
            fused.walk_args = shortened
        else:
            fused.node_args = lambda scene, walk: (None, ())
        label = (f"the {walk} walk: "
                 + (f"a queue of {short} entries for {nodes} nodes" if what == "short"
                    else "a launch without its packed nodes"))
        try:
            with trav(walk):
                kw = dict(camera_consts=camera_consts(sc[name].camera, 8, 8),
                          sampler=zt.sampling.SamplerKind.SOBOL, width=8, height=8, spp=1,
                          stride=1, max_depth=2, has_dof=sc[name].camera.has_depth_of_field)
                fused.render_fused(cs, px, py, zero, zero + 1, 0, zt.dtypes.T_MIN, **kw)
            torch.cuda.synchronize()
            raise AssertionError(f"{label} was launched")
        except RuntimeError as e:
            if "cudaError 1" not in str(e):
                raise
        finally:
            fused.walk_args, fused.node_args = real_walk_args, real_node_args
        if fused.render_fused.launches != launches:
            raise AssertionError(f"{label}: the refused launch was counted")
        log(f"{label}: refused (cudaErrorInvalidValue)")
        out.append({"walk": walk, "nodes": nodes, "q_cap": short,
                    "packed_nodes": what != "no nodes", "refused": True})
    return out


def walk_bound_counts(wpar, walk, pcase, ccase) -> dict:
    """Phase 17's plain work counts that price the bound of a walk on case
    ``ccase`` of ``pcase``: the cond walk's on the same tree (the per-kind
    trees for queue, rowqueue and spec, at the port's span for "rowqueue
    port span" and "queue port span"; the unified tree's first-design form
    for uni), not the walk's own, which culls with a stale t and so tests
    more boxes (and, but for rowqueue, sweeps more leaves) than the closest
    hit needs."""
    if walk == "uni":
        return wpar["uni cond"][pcase][ccase][1]
    if pcase in ("rowqueue port span", "queue port span"):
        return wpar[pcase][f"{ccase}, cond walk"][1]
    return wpar["cond"][ccase][1]


def plan_occupancy(zt, fused, integrator, tb, scene, renderer):
    """(blocks per SM, dynamic shared memory bytes a block) of the
    instantiation that the scene's kernel takes at ``renderer``'s plan
    (render_lanes: the render kernel where it takes the scene, else the
    bounce kernel's regenerating mode) under the walk the environment
    names; launches nothing."""
    from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_fused_render
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    cs = scene.compiled
    plan = renderer.render_lanes(scene, W, H)[:4]
    kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
              width=W, height=H, spp=renderer.samples_per_pixel, stride=1,
              max_depth=renderer.max_ray_bounce_depth, has_dof=scene.camera.has_depth_of_field)
    t_min = zt.dtypes.T_MIN
    if supports_fused_render(cs):
        return fused.render_fused_occupancy(cs, *plan, 0, t_min, **kw)
    return tb.bounce_regen_occupancy(cs, integrator.initial_regen_state(plan[2], 1), plan[0],
                                     plan[1], plan[3], 0, t_min, **kw)


def launch_mib(torch, scene, renderer, tag) -> float:
    """MiB of device memory that one launch of the scene's kernel at
    ``renderer``'s coherent plan (Renderer.kernel_call) allocates above what
    was allocated before it, outputs included."""
    call = renderer.kernel_call(scene, W, H)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"{tag}: a launch at the plan allocates {mib:.1f} MiB of device memory")
    return mib


def walk_render(zt, fused, integrator, ch, ttrace, tb, torch, scene, spp, depth, walk, card,
                ref_fb=None):
    """Phase 18, one path: ``scene`` at 400x400 under ``walk`` (one warmup
    render, three timed), with the counts set to 0 just before and read just
    after; the walk's instantiation of K1 (scenes it takes) or K2 must have
    launched and nothing else of the kind, no plain version; then the
    kernel's time at the coherent plan's lanes (its work), the
    instantiation's blocks per SM and shared memory a block there, and the
    framebuffer against ``ref_fb`` within rtol 1e-5 / atol 1e-6 on >= 99.9%
    of pixels.  Returns (record, framebuffer, renderer)."""
    from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_fused_render

    cs = scene.compiled
    k1 = supports_fused_render(cs)
    renderer = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
    tag = f"{scene.name} {W}x{H}@{spp} d{depth}, {walk} walk"
    with trav(walk):
        reset_counts(fused, integrator, ch, ttrace, tb)
        warm_s, times, fb = timed_renders(renderer, scene, torch, W, H)
        host = fused.render_fused if k1 else tb.bounce_regen
        other = ((launched(tb.bounce_regen) + launched(tb.bounce)) if k1
                 else launched(fused.render_fused))
        by_walk = dict(host.launches)
        launches = sum(by_walk.values())
        n_plain = plain_calls(integrator, ttrace)
        log(f"{tag}: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s; "
            f"{'render' if k1 else 'bounce'} kernel launches by walk {by_walk}, other render "
            f"kernel {other}, plain-version calls {n_plain}")
        if by_walk[walk] < 1 or by_walk[walk] != launches or other or n_plain:
            raise AssertionError(f"{tag}: did not run the {walk} instantiation alone")
        if tuple(fb.shape) != (H, W, 3) or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"{tag}: bad framebuffer")
        plans = renderer._plan_cache[cs]
        lanes = int(plans[next(k for k in plans if k[0] == "coh")]["plan"][0].shape[0])
        ms, (_, work) = cuda_time_ms(renderer.kernel_call(scene, W, H), 3)
        blocks, smem = plan_occupancy(zt, fused, integrator, tb, scene, renderer)
    best = min(times)
    mpaths = W * H * spp / best / 1e6
    out = {"render_s_best": best, "mpaths_per_s": mpaths, "launches": launches, "ms": ms,
           "work": int(work.sum().item()), "lanes": lanes, "spp": spp,
           "blocks_per_sm": blocks, "smem_bytes": smem}
    msg = (f"{tag}: best {best:.4f} s = {mpaths:.2f} Mpaths/s; kernel at the plan {ms:.3f} ms, "
           f"{blocks} blocks per SM, {smem} bytes of shared memory a block")
    if ref_fb is not None:
        close = torch.isclose(fb, ref_fb, rtol=1e-5, atol=1e-6).all(-1).float().mean().item()
        out.update(default_agree=close, default_max_abs_diff=(fb - ref_fb).abs().max().item())
        msg += (f"; against the default walk's render {close:.4%} of pixels within rtol "
                f"1e-5/atol 1e-6, max |diff| {out['default_max_abs_diff']:.3e}")
        if close < 0.999:
            raise AssertionError(f"{tag}: disagrees with the default walk's render")
    log(f"{msg} ({card})")
    return out, fb, renderer


def walk_lane_bytes(kernel, lut, lanes) -> int:
    """What a phase 18 path's lanes read and write: K1 its lane table (16
    bytes) and its radiance (12) or, with the LUT, radiance and work (16);
    K2's regenerating mode its state in (84) and out (72)."""
    if kernel == "K1":
        return lanes * (16 + (16 if lut else 12))
    return lanes * (84 + 72)


# phase 18's walks that run beside the default walk at the same coherent
# plan: (kernel, path key, scene of walk_scenes, the default walk's scene
# at the same span and its path's renderer key)
AGAINST_DEFAULT = (
    ("K1", "rowqueue", "balls2", "balls2", ("K1", DEFAULT_WALK)),
    ("K2", "rowqueue", "rtw", "rtw", ("K2", DEFAULT_WALK)),
    ("K2", "rowqueue port", "rtw_port", "rtw_port", ("K2", "queue port")),
    ("K1", "uni port", "rtw_uni_lut_port", "rtw_lut_port", ("K1", "queue port")),
    ("K2", "uni port", "rtw_uni_port", "rtw_port", ("K2", "queue port")),
)


def walks_against_default(torch, sc, renderers) -> list:
    """Phase 18: the rowqueue walk's kernels (span 2; K2 at the port's span
    too) and the uni walk's at the port's span against the default walk's
    kernel at the same coherent plan, on the per-kind scene of the same
    span, with phase 2's tolerances, rowqueue's bitwise."""
    checks = []
    for kernel, key, name, dname, dkey in AGAINST_DEFAULT:
        walk = key.split()[0]
        with trav(walk):
            got = renderers[(kernel, key)].kernel_call(sc[name], W, H)()
        with trav(DEFAULT_WALK):
            want = renderers[dkey].kernel_call(sc[dname], W, H)()
        check = compare(f"{kernel} {key} walk, {sc[name].name}: against the {DEFAULT_WALK} "
                        "walk's kernel at the plan", got, want)
        checks.append(check)
        if walk == "rowqueue":
            bitwise([check], f"{kernel} {key} walk at the plan")
    return checks


def treeless_occupancy(zt, fused, cases, resources) -> dict:
    """Phase 18's tree-less scenes: the render kernel's instantiation at
    the sorted plans of cornell's and emissive's main paths (phases 3 and
    15) as the default and the cond walk launch it (both kWalkNoTree:
    render_kernels.cuh:dispatch_flags_walk), its registers, spills, blocks
    per SM and shared memory a block; no launch past MAX_BLOCKS_PER_SM."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    out = {}
    res = resources["fused_render_kernel<false, no tree>"]
    for name, scene, renderer, spp in cases:
        cs = scene.compiled
        plan = plan_of(renderer, cs)
        kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
                  width=W, height=H, spp=spp, stride=1, max_depth=DEPTH,
                  has_dof=scene.camera.has_depth_of_field)
        occ = {}
        for walk in (DEFAULT_WALK, "cond"):
            with trav(walk):
                blocks, smem = fused.render_fused_occupancy(cs, *plan, 0, zt.dtypes.T_MIN, **kw)
            occ[walk] = {"blocks_per_sm": blocks, "smem_bytes": smem, **res}
        tag = f"K1 {name} (no tree)"
        log(f"{tag}: registers/spill bytes {res['registers']}/{res['spill_bytes']}; blocks per "
            "SM and shared memory a block " + "; ".join(
                f"{k} walk {v['blocks_per_sm']}, {v['smem_bytes']} bytes" for k, v in occ.items()))
        if occ[DEFAULT_WALK] != occ["cond"]:
            raise AssertionError(f"{tag}: the walks launch different instantiations: {occ}")
        if occ["cond"]["blocks_per_sm"] > fused.MAX_BLOCKS_PER_SM:
            raise AssertionError(f"{tag}: more than {fused.MAX_BLOCKS_PER_SM} blocks a SM")
        out[name] = occ
    return out


def hit_ray_sets(zt, torch, scenes) -> list:
    """Phase 22's ray sets: the first-hit probe's 160,000 rays of balls and
    rtw_final (sample 0 at their main paths' spp, t_min 1e-4) and the AOV
    pass's 640,000 rays of cornell, balls and rtw_final at 400x400, 4 spp
    (render/aov.py:band_rays, t_min T_MIN)."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.render import aov
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_params

    t_probe = float(np.float32(1e-4))
    sets = [(f"{name} probe 400x400", scenes[name],
             camera_rays(zt, torch, scenes[name], W, H, spp), t_probe)
            for name, spp in (("balls", BALLS_SPP), ("rtw_final", RTW_SPP))]
    for name in ("cornell_box", "balls", "rtw_final"):
        sc = scenes[name]
        rays = aov.band_rays(sc, camera_params(sc.camera, W, H), 0, 0, width=W, height=H,
                             band_rows=H, spp=AOV_SPP, sampler=zt.sampling.SamplerKind.SOBOL,
                             has_dof=sc.camera.has_depth_of_field)
        sets.append((f"{name} AOV {W}x{H}@{AOV_SPP}", sc, rays, zt.dtypes.T_MIN))
    return sets


def aov_pass(zt, torch, ch, ttrace, scene, card) -> dict:
    """The AOV pass at 400x400@4 on the card (render/aov.py:render_aovs),
    its counts set to 0 just before and read just after: one warmup and
    three timed passes, each one launch of the closest-hit kernel and no
    plain version; wall time, the device time split between the kernel and
    the rest (the eager shading tail) from a torch.profiler capture, and
    the peak device memory the passes allocated above what was allocated
    before them."""
    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs
    from zig_weekend_raytracer_tpu_torch.utils import profiler

    run = lambda: render_aovs(scene, W, H, spp=AOV_SPP)
    ch.closest_hit.launches = 0
    ttrace.closest_hit.calls = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain = ch.closest_hit.launches, ttrace.closest_hit.calls
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    if launches != 4 or plain != 0:
        raise AssertionError(f"AOV pass {scene.name}: {launches} closest-hit launches and {plain} "
                             f"plain calls over 4 passes, not 4 and 0")
    for k, v in out.items():
        if v.shape[:2] != (H, W) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"AOV pass {scene.name}: bad {k} buffer")
    if not 0.0 < float(out["coverage"].mean()) <= 1.0:
        raise AssertionError(f"AOV pass {scene.name}: nothing hit")
    _, agg, _ = profiler.run_with_device_trace(run)
    k3_ms = agg.get("closest_hit_kernel", (0, 0.0))[1]
    device_ms = sum(v[1] for v in agg.values())
    kernels = sum(v[0] for v in agg.values())
    log(f"AOV pass {scene.name} {W}x{H}@{AOV_SPP}: best {min(times) * 1e3:.3f} ms wall "
        f"({[round(t * 1e3, 3) for t in times]}); device {device_ms:.4f} ms in {kernels} kernels, "
        f"closest_hit_kernel {k3_ms:.4f} ms ({k3_ms / max(device_ms, 1e-12):.1%}), the rest "
        f"{device_ms - k3_ms:.4f} ms; peak device memory above the pass's start "
        f"{peak_mib:.1f} MiB; coverage "
        f"{float(out['coverage'].mean()):.4f} ({card})")
    return {"wall_ms": [t * 1e3 for t in times], "wall_best_ms": min(times) * 1e3,
            "device_ms": device_ms, "device_kernels": kernels, "k3_device_ms": k3_ms,
            "tail_device_ms": device_ms - k3_ms, "peak_mib": peak_mib, "launches": launches,
            "coverage": float(out["coverage"].mean())}


def aov_plain_slice(zt, torch, ttrace, scene) -> dict:
    """The AOV pass on the card at 64x64@4 against the port's plain path on
    the same device (the trace through ops/trace.py's cond walk): every
    buffer bitwise."""
    from zig_weekend_raytracer_tpu_torch.render import aov

    got = aov.render_aovs(scene, AOV_SLICE, AOV_SLICE, spp=AOV_SPP)
    kernel_trace = aov.closest_hit
    aov.closest_hit = lambda cs, *a: ttrace.closest_hit(cs, *a, walk="cond")
    try:
        want = aov.render_aovs(scene, AOV_SLICE, AOV_SLICE, spp=AOV_SPP)
    finally:
        aov.closest_hit = kernel_trace
    diff = {k: float((got[k] - want[k]).abs().max()) for k in got}
    same = all(torch.equal(got[k], want[k]) for k in got)
    log(f"AOV pass {scene.name} {AOV_SLICE}x{AOV_SLICE}@{AOV_SPP}, kernel vs plain path on the "
        f"card: bitwise {same}, max |diff| {diff}")
    if not same:
        raise AssertionError(f"AOV pass {scene.name}: the kernel's pass differs from the plain path")
    return {"check": f"AOV {scene.name} {AOV_SLICE}x{AOV_SLICE}@{AOV_SPP} vs plain path",
            "max_abs_err": max(diff.values())}


def denoise_check(zt, torch, scene, card) -> dict:
    """The denoiser on the card against the CPU on the same beauty render
    (64x64@8 d10) and AOVs, 3 iterations, sigma_l auto: within
    DENOISE_RTOL / DENOISE_ATOL on >= DENOISE_AGREE of the values."""
    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs
    from zig_weekend_raytracer_tpu_torch.render.denoise import denoise

    w = AOV_SLICE
    fb = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=DEPTH).render_device(
        scene, w, w)
    aovs = render_aovs(scene, w, w, spp=AOV_SPP)
    got = denoise(fb, aovs).cpu()
    want = denoise(fb.cpu(), {k: v.cpu() for k, v in aovs.items()})
    close = torch.isclose(got, want, rtol=DENOISE_RTOL, atol=DENOISE_ATOL).float().mean().item()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-6)).max())
    moved = float((got - fb.cpu()).abs().max())
    log(f"denoise {scene.name} {w}x{w}, card vs CPU: {close:.4%} within rtol {DENOISE_RTOL}/atol "
        f"{DENOISE_ATOL}, max |diff| {err:.3e}, max rel {rel:.3e}; max change from the "
        f"render {moved:.3e} ({card})")
    if close < DENOISE_AGREE or not bool(torch.isfinite(got).all()) or moved == 0.0:
        raise AssertionError(f"denoise {scene.name}: the card disagrees with the CPU")
    return {"check": f"denoise {scene.name} {w}x{w} card vs cpu", "agree": close,
            "max_abs_err": err, "max_rel_err": rel}


def cli_aov_check(tmp) -> dict:
    """The CLI's entry point in this process, cli.main with --aov
    --denoise=3 --stats on balls: exit 0, the AOV and denoise stage lines,
    the stats line's AOV split, the image and three PNGs."""
    import io
    import logging

    from zig_weekend_raytracer_tpu_torch import cli

    out = os.path.join(tmp, "aov.ppm")
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger = logging.getLogger("zwrt")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    stdout = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["--image_width=96", "--image_height=96", "--samples_per_pixel=16",
                           "--ray_bounce_max_depth=10", "--scene=balls", "--aov=true",
                           "--denoise=3", "--stats=true", f"--image_out_path={out}"])
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    wall = time.perf_counter() - t0
    stages = [ln.split("\t")[-1] for ln in lines]
    stats = [ln for ln in stdout.getvalue().splitlines() if ln.startswith("stats: ")]
    pngs = [f"{out}.{k}.png" for k in ("albedo", "normal", "depth")]
    ok = (rc == 0 and "aovs rendered (4 spp)" in stages and "denoised" in stages
          and len(stats) == 1 and "aov pass 36,864 paths" in stats[0] and os.path.exists(out)
          and all(os.path.exists(p) for p in pngs))
    if ok:
        for p in pngs:
            with open(p, "rb") as f:
                ok = ok and f.read(8) == b"\x89PNG\r\n\x1a\n"
    log(f"cli.main balls 96x96 spp16 --aov --denoise=3 --stats: exit {rc} in {wall:.1f} s, "
        f"stages {stages}, {stats[0] if stats else 'no stats line'!r}")
    if not ok:
        raise AssertionError(f"cli --aov --denoise: exit {rc}\n{stdout.getvalue()[-2000:]}")
    return {"check": "cli.main balls 96x96 --aov --denoise=3 --stats", "wall_s": wall,
            "stats": stats[0]}


def phase_hit_sets(zt, ch, ttrace, torch, card, scenes, fb_cornell) -> dict:
    """Phase 22: the closest-hit kernel on the probe and AOV ray sets
    (bitwise against the plain cond walk, bounds, the kernel alone and its
    wrapper, the memory a launch allocates), the AOV pass on three scenes,
    the pass against the plain path, the denoiser on the card against the
    CPU and at 400x400, and the CLI with --aov --denoise."""
    import tempfile

    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs
    from zig_weekend_raytracer_tpu_torch.render.denoise import denoise
    from zig_weekend_raytracer_tpu_torch.sampling.sobol import sobol_sample_bytes
    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    rate = OPS_RATE["rate"]
    sets, checks = [], []
    for tag, sc, rays, t_min in hit_ray_sets(zt, torch, scenes):
        cs = sc.compiled
        n = rays[2].numel()
        with workcount.counting() as counts:
            plain_ms, ref = cuda_time_ms(lambda: ttrace.closest_hit(cs, *rays, t_min, walk="cond"))
        checks.append(compare_hits(tag, hit_launcher(ch, cs, rays, t_min)(), ref))
        bound, by = roofline.hit_bound_ms(counts, cs, n, rate)
        # the memory one launch allocates: its three outputs, never a
        # per-ray queue of tree leaves
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ch.closest_hit(cs, *rays, t_min)
        torch.cuda.synchronize()
        launch_bytes = torch.cuda.max_memory_allocated() - base
        if launch_bytes > 16 * n:
            raise AssertionError(f"{tag}: a launch allocated {launch_bytes} bytes")
        ms = kernel_alone_ms(torch, hit_launcher(ch, cs, rays, t_min))
        ms_w = wrapper_ms(torch, lambda: ch.closest_hit(cs, *rays, t_min))
        hits = int((ref.kind >= 0).sum())
        entry = {"set": tag, "rays": n, "hits": hits, "bound_ms": bound, "bound_by": by,
                 "plain_ms": plain_ms, "launch_bytes": launch_bytes, "ms": ms,
                 "wrapper_ms": ms_w}
        if "AOV" in tag:
            entry["aov_bound_ms"], entry["aov_bound_by"] = roofline.aov_bound_ms(
                counts, cs, n, hits, int((ref.kind == 0).sum()), W * H,
                sc.camera.has_depth_of_field,
                sobol_sample_bytes(AOV_SPP), rate)
            log(f"AOV pass {tag}: bound {entry['aov_bound_ms']:.4f} ms ({entry['aov_bound_by']}; "
                f"camera rays, closest hits, the per-hit tail, the buffers)")
        log(f"closest hit {tag}: kernel alone {ms:.4f} ms, wrapper {ms_w:.4f} ms; bound "
            f"{bound:.4f} ms ({by}); plain {plain_ms:.1f} ms; a launch allocates {launch_bytes} "
            f"bytes ({card})")
        sets.append(entry)
    passes = {}
    for name, sc in scenes.items():
        passes[name] = aov_pass(zt, torch, ch, ttrace, sc, card)
        checks.append(aov_plain_slice(zt, torch, ttrace, sc))
    denoise_checks = [denoise_check(zt, torch, scenes[n], card) for n in ("cornell_box", "balls")]
    aovs = render_aovs(scenes["cornell_box"], W, H, spp=AOV_SPP)
    dn_ms, dn = cuda_time_ms(lambda: denoise(fb_cornell, aovs), 3)
    if not bool(torch.isfinite(dn).all()):
        raise AssertionError("denoise cornell 400x400: not finite")
    log(f"denoise cornell {W}x{H}, 3 iterations on the card: {dn_ms:.3f} ms ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_aov_check(tmp)
    return {"sets": sets, "checks": checks, "aov_pass": passes, "denoise": denoise_checks,
            "denoise_400_ms": dn_ms, "cli": cli}


def phase_estimator(zt, fused, tb, integrator, torch, scenes, card) -> dict:
    """Phase 23: the estimator instantiations of the render and bounce
    kernels against their plain versions, with phase 2's (render) and
    phase 9's (one bounce) tolerances; the atlas gate; the Sobol tables
    past spp.  Returns {"checks", "plain" (cornell rr3's plain output and
    counts), "one_bounce" (the one-bounce checks)}."""
    cornell, balls, rtw, rtw_lut = (scenes[k] for k in ("cornell", "balls", "rtw", "rtw_lut"))
    checks, plains = [], []
    before = fused.render_fused.estimator_launches
    for name, scene, spp, depth in (("cornell", cornell, 8, DEPTH), ("balls", balls, 8, DEPTH),
                                    ("rtw_final LUT", rtw_lut, RTW_SMALL_SPP, RTW_DEPTH)):
        for tag, opts in EST_OPTS:
            keep = plains if (name, tag) == ("cornell", "rr3") else None
            checks.append(render_parity(zt, fused, integrator, torch, scene,
                                        f"{name} 32x32 spp{spp} d{depth} {tag}", depth=depth,
                                        spp=spp, plains=keep, **opts))
    launched_est = fused.render_fused.estimator_launches - before
    log(f"estimator: render kernel's estimator instantiation launched {launched_est} times")
    if launched_est < 3 * len(EST_OPTS):
        raise AssertionError("the render kernel's estimator instantiation did not launch")
    # the bounce kernel's one-bounce mode with both options on cornell rays
    before = tb.bounce.estimator_launches
    one = one_bounce_parity(zt, tb, integrator, torch, cornell, "cornell rr3+clamp10",
                            (0, 1, 2, 3), rr_start=RR_START, clamp=CLAMP)
    if tb.bounce.estimator_launches - before < 4:
        raise AssertionError("the bounce kernel's estimator instantiation did not launch")
    checks += one
    # the atlas gate: the regenerating mode on rtw_final without a LUT
    # ignores both options, bitwise
    ys, xs = torch.meshgrid(torch.arange(32, device="cuda"), torch.arange(32, device="cuda"),
                            indexing="ij")
    px = xs.reshape(-1).to(torch.int32).contiguous()
    py = ys.reshape(-1).to(torch.int32).contiguous()
    lim = torch.full_like(px, RTW_SMALL_SPP)
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    kw = dict(camera_consts=camera_consts(rtw.camera, 32, 32),
              sampler=zt.sampling.SamplerKind.SOBOL, width=32, height=32,
              spp=RTW_SMALL_SPP, stride=1, max_depth=RTW_DEPTH, has_dof=False)
    st0 = integrator.initial_regen_state(torch.zeros_like(px), 1)
    before = tb.bounce_regen.estimator_launches
    st_off = tb.bounce_regen(rtw.compiled, st0, px, py, lim, 0, zt.dtypes.T_MIN, **kw)
    st_on = tb.bounce_regen(rtw.compiled, st0, px, py, lim, 0, zt.dtypes.T_MIN,
                            rr_start=RR_START, clamp=CLAMP, **kw)
    same = (torch.equal(st_off.radiance.to_array(), st_on.radiance.to_array())
            and torch.equal(st_off.work, st_on.work))
    log(f"estimator gate: rtw_final (atlas) regenerating 32x32 spp{RTW_SMALL_SPP} "
        f"d{RTW_DEPTH} with rr3+clamp10 bitwise the render without: {same}; estimator "
        f"launches {tb.bounce_regen.estimator_launches - before}")
    if not same or tb.bounce_regen.estimator_launches != before:
        raise AssertionError("the bounce kernel applied an estimator option on an atlas scene")
    checks.append({"check": "rtw_final atlas gate", "bitwise": True, "max_abs_err": 0.0})
    # the Sobol tables past spp: lanes whose windows reach sample 4,096
    sob = render_parity(zt, fused, integrator, torch, cornell,
                        f"cornell 32x32 spp{SOBOL_SPP} d{DEPTH}, {SOBOL_WINDOW}-sample windows "
                        f"to sample {32 * 32 * SOBOL_WINDOW}", spp=SOBOL_SPP,
                        window=SOBOL_WINDOW)
    checks.append(sob)
    return {"checks": checks, "plain": plains[0], "one_bounce": one}


def driver_check(tag, fb, fb_ref, ref, ref_name="the sorted driver's render") -> dict:
    """A driver's framebuffer: finite, (H, W, 3), the region gate of ``ref``
    (None: not gated), and against ``fb_ref`` (the sorted driver's render
    unless named; None: not compared) within PIXEL_RTOL / PIXEL_ATOL on >=
    PIXEL_AGREE of the pixels."""
    import numpy as np

    if tuple(fb.shape) != (H, W, 3) or not bool(fb.isfinite().all()):
        raise AssertionError(f"{tag}: framebuffer shape {tuple(fb.shape)} or not finite")
    out = {"check": tag}
    if ref is not None:
        out["region_gate"] = gate(tag, fb, ref["mean"], ref["region_means"])
    if fb_ref is not None:
        a, b = fb.cpu().numpy(), fb_ref.cpu().numpy()
        close = np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1).mean()
        out["agree"] = float(close)
        out["max_abs_err"] = float(np.abs(a - b).max())
        log(f"{tag}: {close:.6f} of pixels within rtol {PIXEL_RTOL}/atol {PIXEL_ATOL} of "
            f"{ref_name}, max |diff| {out['max_abs_err']:.3e}")
        if close < PIXEL_AGREE:
            raise AssertionError(f"{tag}: differs from {ref_name}")
    return out


def path_counts(fused, integrator, ch, ttrace, tb, tag, hit=False, est=False) -> dict:
    """The counts of the path just run: the render kernel launched (its
    estimator instantiation with ``est``, the closest-hit kernel with
    ``hit``), no plain version ran."""
    k1, k1_est = launched(fused.render_fused), fused.render_fused.estimator_launches
    k3, n_plain = ch.closest_hit.launches, plain_calls(integrator, ttrace)
    log(f"{tag}: render kernel launches {k1} (estimator {k1_est}), closest-hit {k3}, "
        f"plain-version calls {n_plain}")
    if k1 < 1 or n_plain or (hit and k3 < 1) or (est and k1_est < 1):
        raise AssertionError(f"{tag}: the path did not run through its kernels alone")
    return {"k1": k1, "k1_estimator": k1_est, "k3": k3}


def phase_drivers(zt, fused, tb, integrator, ch, ttrace, torch, scenes, fb_sorted, card) -> dict:
    """Phase 24: the drivers at the main path's configuration, cornell
    400x400@1024 d10 (Sobol, seed 0), each path with its counts set to 0
    just before and read just after; Mpaths/s beside the card."""
    import tempfile

    import numpy as np

    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer
    from zig_weekend_raytracer_tpu_torch.render.renderer import _render_band_regen
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    cornell, balls = scenes["cornell"], scenes["balls"]
    with open(GOLDEN) as f:
        ref = json.load(f)
    out = {}
    mk = lambda **kw: zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, **kw)

    def timed(tag, renderer, scene, draw=None, paths=W * H * SPP, **count_kw):
        reset_counts(fused, integrator, ch, ttrace, tb)
        draw = draw or (lambda: renderer.render_device(scene, W, H))
        times, fb = [], None
        for _ in range(4):  # the first builds the driver's plan
            t0 = time.perf_counter()
            fb = draw()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = path_counts(fused, integrator, ch, ttrace, tb, tag, **count_kw)
        best = min(times[1:])
        mp = paths / best / 1e6
        log(f"{tag}: first {times[0]:.4f} s, then {[round(t, 4) for t in times[1:]]} s, best "
            f"{best:.4f} s = {mp:.2f} Mpaths/s ({card})")
        return fb, {"render_s": times, "best_s": best, "mpaths_per_s": mp, **counts}

    # (a) the balanced driver
    fb, rec = timed("balanced driver cornell 400x400@1024 d10", mk(balance_min_spp=1), cornell)
    out["balanced"] = {**rec, **driver_check("balanced driver", fb, fb_sorted, ref)}

    # (b) adaptive, the default pilot; balls 400x400@128 d10 adaptive
    r = mk()
    fb, rec = timed("adaptive cornell 400x400@1024 d10", r, cornell,
                    draw=lambda: r.render_adaptive(cornell, W, H))
    fb, stats = r.render_adaptive(cornell, W, H, return_stats=True)
    total = int(stats["n_samples"].sum())
    log(f"adaptive: pilot {stats['pilot']}, samples {total} (budget {W * H * SPP}), per pixel "
        f"{int(stats['n_samples'].min())}..{int(stats['n_samples'].max())}")
    if total != W * H * SPP:
        raise AssertionError(f"adaptive: {total} samples, not the budget {W * H * SPP}")
    out["adaptive"] = {**rec, "samples": total, "pilot": stats["pilot"],
                       **driver_check("adaptive", fb, None, ref)}
    rb = zt.render.Renderer(samples_per_pixel=BALLS_SPP, max_ray_bounce_depth=DEPTH)
    fb_b, rec = timed("adaptive balls 400x400@128 d10", rb, balls,
                      draw=lambda: rb.render_adaptive(balls, W, H), paths=W * H * BALLS_SPP,
                      hit=False)
    with open(SCENE_REGIONS) as f:
        breg = json.load(f)["scenes"]["balls"]
    out["adaptive_balls"] = {**rec, "region_gate": gate("adaptive balls 400x400@128 d10", fb_b,
                                                        breg["mean"], breg["region_means"])}

    # (c) progressive in 256-sample batches, interrupted after two and resumed
    class Stop(Exception):
        pass

    def stop_after_two(done, _):
        if done == 2 * PROG_BATCH:
            raise Stop

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(fused, integrator, ch, ttrace, tb)
        t0 = time.perf_counter()
        whole = ProgressiveRenderer(mk(), os.path.join(tmp, "whole.npz")).render(
            cornell, W, H, batch_spp=PROG_BATCH)
        whole_s = time.perf_counter() - t0
        ck = os.path.join(tmp, "ck.npz")
        try:
            ProgressiveRenderer(mk(), ck).render(cornell, W, H, batch_spp=PROG_BATCH,
                                                 on_batch=stop_after_two)
            raise AssertionError("progressive: the interrupt did not happen")
        except Stop:
            pass
        done_at_stop = int(np.load(ck)["samples_done"])
        resumed = ProgressiveRenderer(mk(), ck).render(cornell, W, H, batch_spp=PROG_BATCH)
        counts = path_counts(fused, integrator, ch, ttrace, tb, "progressive")
    bitwise = bool(np.array_equal(whole, resumed))
    log(f"progressive: checkpoint at {done_at_stop} spp, resumed render bitwise the "
        f"uninterrupted one: {bitwise}; uninterrupted {whole_s:.4f} s = "
        f"{W * H * SPP / whole_s / 1e6:.2f} Mpaths/s ({card})")
    if done_at_stop != 2 * PROG_BATCH or not bitwise:
        raise AssertionError("progressive: the resumed render is not the uninterrupted one")
    out["progressive"] = {"resume_bitwise": bitwise, "checkpoint_spp": done_at_stop,
                          "render_s": whole_s, "mpaths_per_s": W * H * SPP / whole_s / 1e6,
                          **counts, **driver_check("progressive", torch.as_tensor(whole),
                                                   fb_sorted, ref)}

    # (d) supersampled, k = 2
    r = mk()
    fb, rec = timed("supersampled k=2 cornell 400x400@1024 d10", r, cornell,
                    draw=lambda: r.render_supersampled(cornell, W, H, k=2))
    out["supersampled"] = {**rec, **driver_check("supersampled k=2", fb, None, ref)}

    # (e) Russian roulette from bounce 3, and its work against rr = 0
    r = mk(russian_roulette=RR_START)
    fb, rec = timed("russian_roulette=3 cornell 400x400@1024 d10", r, cornell, est=True)
    cam_c = camera_consts(cornell.camera, W, H)
    work = {}
    for rr in (0, RR_START):
        _, w_lanes = _render_band_regen(
            cornell, 0, 0, 0, width=W, height=H, band_rows=H, s_par=1, spp=SPP,
            sample_limit=SPP, max_depth=DEPTH, sampler=zt.sampling.SamplerKind.SOBOL,
            has_dof=False, cam_consts=cam_c, want_work=True, rr=rr)
        work[rr] = int(w_lanes.sum())
    ratio = work[RR_START] / work[0]
    log(f"russian_roulette=3: bounces {work[RR_START]} against {work[0]} without, ratio "
        f"{ratio:.4f}")
    out["russian_roulette"] = {**rec, "work": work[RR_START], "work_rr0": work[0],
                               "work_ratio": ratio, **driver_check("russian_roulette=3", fb,
                                                                   None, ref)}
    out["rr_renderer"] = r
    return out


def sharded_parity(tag, fb_k, fb_p) -> dict:
    """A sharded render through the kernels against the same call through
    the plain versions, per pixel with phase 2's tolerances: radiance within
    rtol 1e-4 / atol 1e-5 on >= 99% of pixels, means within 1e-4
    relative."""
    import numpy as np

    a, b = fb_k.cpu().numpy(), fb_p.cpu().numpy()
    n = a.shape[0] * a.shape[1]
    bad = int((~np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)).sum())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-12)
    max_abs = float(np.abs(a - b).max())
    log(f"parity {tag}: {n} pixels, radiance outside rtol 1e-4/atol 1e-5 on {bad}, mean rel "
        f"diff {mean_rel:.3e}, max |diff| {max_abs:.3e}")
    if not np.isfinite(a).all() or bad > 0.01 * n or mean_rel > 1e-4:
        raise AssertionError(f"parity {tag}: the kernels disagree with their plain versions")
    return {"check": tag, "pixels": n, "rad_diff": bad, "mean_rel": mean_rel,
            "max_abs_err": max_abs}


def plain_k1(fused, integrator, scene, px, py, s0, s1, seed, t_min, want_work=False, **kw):
    """The render kernel's plain version on the card over the work queue
    that ``render_fused`` would launch on these lanes: its items at
    ``launch_chunk``'s chunk, each lane's sums added in the kernel's chunk
    order (``render_fused_items_reference``), so that the comparison stays
    exact wherever the kernel follows its plain version exactly."""
    chunk = fused.launch_chunk(scene, px, py, s0, s1, seed, t_min, **kw)
    return integrator.render_fused_items_reference(scene, px, py, s0, s1, seed, t_min,
                                                   chunk=chunk, want_work=want_work, **kw)


def plain_in_place(integrator):
    """A stand-in for the render kernel's wrapper that runs its plain
    version on the tensors it is given (on the card) over the kernel's
    items (``plain_k1``), counting no launch."""
    from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused

    def plain(scene, px, py, s0, s1, seed, t_min, **kw):
        return plain_k1(fused, integrator, scene, px, py, s0, s1, seed, t_min, **kw)
    return plain


def cpu_outliers(fb_a, fb_b, rtol: float = 1e-4, atol: float = 1e-5) -> list:
    """(x, y, max |diff|) of the pixels of two framebuffers outside rtol /
    atol (by default phase 2's 1e-4 / 1e-5), in image order."""
    import numpy as np

    a, b = fb_a.cpu().numpy(), fb_b.cpu().numpy()
    ys, xs = np.nonzero(~np.isclose(a, b, rtol=rtol, atol=atol).all(-1))
    return [(int(x), int(y), float(np.abs(a[y, x] - b[y, x]).max())) for y, x in zip(ys, xs)]


def phase_sharded(zt, fused, tb, integrator, ch, ttrace, torch, scenes, fbs, mpaths_main,
                  card) -> dict:
    """Phase 25: the sharded paths (parallel/), each with its counts set to 0
    just before and read just after (the render or bounce kernel launched,
    no plain version): (a) cornell 400x400@1024 d10 on make_mesh() and on
    (cuda:0,)*4, both modes, one plan-building render and three timed; (b)
    render_sharded through the render kernel against its plain version in
    the kernel's place on the card (bitwise) and on (cpu,)*4, beside the
    unsharded render card against CPU; (c) balls rows on (cuda:0,)*4,
    rtw_final samples on (cuda:0,)*2; (d) render_adaptive_sharded, both
    modes; (e) a sharded progressive render resumed; (f) the CLI's
    --shard=samples."""
    import dataclasses
    import tempfile

    import numpy as np

    from zig_weekend_raytracer_tpu_torch import parallel
    from zig_weekend_raytracer_tpu_torch.io.ppm import write_ppm
    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer
    from zig_weekend_raytracer_tpu_torch.scene import compiled_on

    t_phase = time.perf_counter()
    cornell, balls, rtw = scenes["cornell"], scenes["balls"], scenes["rtw"]
    fb_main, fb_balls, fb_rtw = fbs
    with open(GOLDEN) as f:
        ref = json.load(f)
    with open(SCENE_REGIONS) as f:
        regions = json.load(f)["scenes"]
    cards = parallel.make_mesh()
    rep = lambda n: (torch.device("cuda", 0),) * n
    modes = ("samples", "rows")
    out = {"mesh": [str(d) for d in cards], "launches": {"K1 brute": {}, "K1 tree": {},
                                                         "K2 regen": {}}}

    def counted(tag, kernel, fn, record=True):
        """fn() with the counts set to 0 before and read after: the kernel
        launched, no plain version ran; its launches recorded under
        ``kernel`` unless the run is a comparison's."""
        reset_counts(fused, integrator, ch, ttrace, tb)
        res = fn()
        torch.cuda.synchronize()
        host = tb.bounce_regen if kernel == "K2 regen" else fused.render_fused
        n_k, n_plain = launched(host), plain_calls(integrator, ttrace)
        log(f"{tag}: {kernel} launches {n_k}, plain-version calls {n_plain}")
        if n_k < 1 or n_plain:
            raise AssertionError(f"{tag}: the path did not run through its kernels alone")
        if record:
            out["launches"][kernel][tag] = n_k
        return res

    def timed(tag, fn, paths, kernel="K1 brute"):
        """One plan-building run and three timed; (first result, last
        result, record)."""
        def runs():
            times, res = [], []
            for _ in range(4):
                t0 = time.perf_counter()
                res.append(fn())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return times, res
        times, res = counted(tag, kernel, runs)
        best = min(times[1:])
        mp = paths / best / 1e6
        log(f"{tag}: first {times[0]:.4f} s, then {[round(t, 4) for t in times[1:]]} s, best "
            f"{best:.4f} s = {mp:.2f} Mpaths/s (phase 3, unsharded: {mpaths_main:.2f}; {card})")
        return res[0], res[-1], {"render_s": times, "best_s": best, "mpaths_per_s": mp,
                                 "launches": out["launches"][kernel][tag]}

    # (a) cornell at the main path's configuration: the card(s), then four
    # shards on card 0
    for label, mesh in (("make_mesh()", cards), ("(cuda:0,)*4", rep(4))):
        for shard in modes:
            tag = f"sharded {shard} {label} cornell {W}x{H}@{SPP} d{DEPTH}"
            first, fb, rec = timed(tag, lambda: parallel.render_sharded(
                cornell, W, H, SPP, DEPTH, mesh=mesh, shard=shard), W * H * SPP)
            if len(mesh) == 1:
                same = bool(torch.equal(first, fb_main) and torch.equal(fb, fb_main))
                log(f"{tag}: first and last render bitwise phase 3's framebuffer: {same}")
                if not same:
                    raise AssertionError(f"{tag}: a one-device mesh is not the unsharded render")
                rec["bitwise_phase3"] = same
            out[tag] = {**rec, **driver_check(tag, fb, fb_main, ref, "phase 3's render")}

    # (c) balls rows through the tree walk, rtw_final samples through the
    # bounce kernel: each against its unsharded main path (phases 7, 11),
    # and region-gated at scene_regions.json's own configuration (200x200,
    # the gate of phases 8 and 12: its reference holds too few samples per
    # region to gate a 400x400 render of other sample positions)
    for name, scene, spp, depth, shard, n, fb_ref, kernel in (
            ("balls", balls, BALLS_SPP, DEPTH, "rows", 4, fb_balls, "K1 tree"),
            ("rtw_final", rtw, RTW_SPP, RTW_DEPTH, "samples", 2, fb_rtw, "K2 regen")):
        tag = f"sharded {shard} (cuda:0,)*{n} {name} {W}x{H}@{spp} d{depth}"
        _, fb, rec = timed(tag, lambda: parallel.render_sharded(
            scene, W, H, spp, depth, mesh=rep(n), shard=shard), W * H * spp, kernel)
        reg = regions[name]
        tag_200 = (f"sharded {shard} (cuda:0,)*{n} {name} {reg['width']}x{reg['height']}"
                   f"@{reg['spp']} d{reg['depth']}")
        fb_200 = counted(tag_200, kernel, lambda: parallel.render_sharded(
            scene, reg["width"], reg["height"], reg["spp"], reg["depth"], mesh=rep(n),
            shard=shard))
        out[tag] = {**rec, **driver_check(tag, fb, fb_ref, None, f"the unsharded {name} render"),
                    "region_gate_200": gate(tag_200, fb_200, reg["mean"], reg["region_means"])}

    # (d) adaptive, pilot 128: the sample map of samples mode is the
    # single-device plan's
    single = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    want_counts = single.render_adaptive(cornell, W, H, pilot_spp=ADAPTIVE_PILOT,
                                         return_stats=True)[1]["n_samples"]
    for shard in modes:
        tag = f"sharded adaptive {shard} (cuda:0,)*4 cornell {W}x{H}@{SPP} d{DEPTH}"
        _, (fb, stats), rec = timed(tag, lambda: parallel.render_adaptive_sharded(
            cornell, W, H, SPP, DEPTH, mesh=rep(4), shard=shard, pilot_spp=ADAPTIVE_PILOT,
            return_stats=True), W * H * SPP)
        total = int(stats["n_samples"].sum())
        equal = bool(np.array_equal(stats["n_samples"], want_counts))
        log(f"{tag}: pilot {stats['pilot']}, samples {total} (budget {W * H * SPP}); sample map "
            f"equal to the single-device render_adaptive's: {equal}")
        if total != W * H * SPP or stats["pilot"] != ADAPTIVE_PILOT:
            raise AssertionError(f"{tag}: {total} samples, not the budget")
        if shard == "samples" and not equal:
            raise AssertionError(f"{tag}: the sample map is not the single-device plan's")
        out[tag] = {**rec, "samples": total, "map_equals_single": equal,
                    **driver_check(tag, fb, None, ref)}

    # (e) progressive in 256-sample batches on two shards, interrupted after
    # two and resumed
    class Stop(Exception):
        pass

    def stop_after_two(done, _):
        if done == 2 * PROG_BATCH:
            raise Stop

    mk = lambda: zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    tag = f"sharded progressive samples (cuda:0,)*2 cornell {W}x{H}@{SPP} d{DEPTH}"
    with tempfile.TemporaryDirectory() as tmp:
        def progressive():
            t0 = time.perf_counter()
            whole = ProgressiveRenderer(mk(), os.path.join(tmp, "whole.npz"), shard="samples",
                                        mesh=rep(2)).render(cornell, W, H, batch_spp=PROG_BATCH)
            whole_s = time.perf_counter() - t0
            ck = os.path.join(tmp, "ck.npz")
            try:
                ProgressiveRenderer(mk(), ck, shard="samples", mesh=rep(2)).render(
                    cornell, W, H, batch_spp=PROG_BATCH, on_batch=stop_after_two)
                raise AssertionError(f"{tag}: the interrupt did not happen")
            except Stop:
                pass
            at_stop = int(np.load(ck)["samples_done"])
            resumed = ProgressiveRenderer(mk(), ck, shard="samples", mesh=rep(2)).render(
                cornell, W, H, batch_spp=PROG_BATCH)
            return whole, whole_s, at_stop, resumed
        whole, whole_s, at_stop, resumed = counted(tag, "K1 brute", progressive)
    bitwise = bool(np.array_equal(whole, resumed))
    log(f"{tag}: checkpoint at {at_stop} spp, resumed render bitwise the uninterrupted one: "
        f"{bitwise}; uninterrupted {whole_s:.4f} s = {W * H * SPP / whole_s / 1e6:.2f} "
        f"Mpaths/s ({card})")
    if at_stop != 2 * PROG_BATCH or not bitwise:
        raise AssertionError(f"{tag}: the resumed render is not the uninterrupted one")
    out[tag] = {"resume_bitwise": bitwise, "checkpoint_spp": at_stop, "render_s": whole_s,
                "mpaths_per_s": W * H * SPP / whole_s / 1e6,
                **driver_check(tag, torch.as_tensor(whole), fb_main, ref, "phase 3's render")}

    # (f) the CLI's --shard=samples, started here; (b) runs meanwhile on the
    # CPU, then the CLI's PPM against the in-process render
    with tempfile.TemporaryDirectory() as tmp:
        cli_out = os.path.join(tmp, "shard.ppm")
        t0 = time.perf_counter()
        proc = start_cli([f"--image_width={CLI_SHARD_W}", f"--image_height={CLI_SHARD_W}",
                          f"--samples_per_pixel={CLI_SHARD_SPP}",
                          f"--ray_bounce_max_depth={DEPTH}", "--scene=cornell_box",
                          "--shard=samples", f"--image_out_path={cli_out}", "--stats=true"])
        try:
            # (b) the kernels on per-shard windows against their plain
            # versions: the same call with the plain version in the
            # kernel's place on the card (bitwise, as phase 2), and on four
            # CPU entries (phase 2's tolerances), beside the witness of the
            # CPU's share: the unsharded render, card against CPU
            pw = SHARD_PARITY_W
            single = zt.render.Renderer(samples_per_pixel=SHARD_PARITY_SPP,
                                        max_ray_bounce_depth=DEPTH)
            fb_single_k = counted("unsharded cornell (parity witness)", "K1 brute",
                                  lambda: single.render_device(cornell, pw, pw), record=False)
            cornell_cpu = dataclasses.replace(
                cornell, compiled=compiled_on(cornell.compiled, torch.device("cpu")))
            fb_single_p = single.render_device(cornell_cpu, pw, pw)
            witness = cpu_outliers(fb_single_k, fb_single_p)
            log(f"witness: the unsharded cornell {pw}x{pw}@{SHARD_PARITY_SPP} d{DEPTH}, card "
                f"against CPU, outside rtol 1e-4/atol 1e-5 at (x, y, max |diff|) "
                f"{witness}")
            out["parity"], out["parity_cpu"] = [], []
            for shard in modes:
                tag = (f"render_sharded {shard} (cuda:0,)*4 cornell {pw}x{pw} "
                       f"spp{SHARD_PARITY_SPP} d{DEPTH}")
                call = lambda mesh: parallel.render_sharded(
                    cornell, pw, pw, SHARD_PARITY_SPP, DEPTH, mesh=mesh, shard=shard)
                fb_k = counted(tag + " (kernels)", "K1 brute", lambda: call(rep(4)), record=False)
                kernel = fused.render_fused
                reset_counts(fused, integrator, ch, ttrace, tb)
                fused.render_fused = plain_in_place(integrator)
                try:
                    fb_pc = call(rep(4))
                finally:
                    fused.render_fused = kernel
                torch.cuda.synchronize()
                if integrator.render_fused_reference.calls < 1 or launched(kernel):
                    raise AssertionError(f"{tag}: the plain version did not run on the card")
                check = sharded_parity(tag + " vs the plain version on the card", fb_k, fb_pc)
                bitwise = bool(torch.equal(fb_k, fb_pc))
                log(f"parity {tag} vs the plain version on the card: bitwise {bitwise}")
                if not bitwise:
                    raise AssertionError(f"{tag}: the kernel is not its plain version on the card")
                out["parity"].append({**check, "bitwise": bitwise})
                reset_counts(fused, integrator, ch, ttrace, tb)
                fb_p = call((torch.device("cpu"),) * 4)
                if plain_calls(integrator, ttrace) < 1 or launched(fused.render_fused):
                    raise AssertionError(f"{tag}: the CPU mesh did not run the plain versions")
                check_cpu = sharded_parity(tag + " vs (cpu,)*4", fb_k, fb_p)
                outliers = cpu_outliers(fb_k, fb_p)
                same = [xy[:2] for xy in outliers] == [xy[:2] for xy in witness]
                log(f"parity {tag} vs (cpu,)*4: outside at {outliers}; the witness's pixels: "
                    f"{same}")
                if not same:
                    raise AssertionError(f"{tag}: the card and the CPU differ on other pixels "
                                         "than the unsharded render's")
                out["parity_cpu"].append({**check_cpu, "outliers": outliers,
                                          "witness_outliers": witness})
            done, wall = finish_cli(proc, t0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tag = (f"cli --shard=samples cornell {CLI_SHARD_W}x{CLI_SHARD_W} spp{CLI_SHARD_SPP} "
               f"d{DEPTH} on {len(cards)} card(s)")
        if done.returncode != 0:
            raise AssertionError(f"{tag}: exit {done.returncode}\n{done.stderr[-2000:]}")
        want = counted(tag + " (in process)", "K1 brute", lambda: parallel.render_sharded(
            cornell, CLI_SHARD_W, CLI_SHARD_W, CLI_SHARD_SPP, DEPTH, mesh=cards,
            shard="samples"))
        ref_ppm = os.path.join(tmp, "want.ppm")
        write_ppm(ref_ppm, want.cpu().numpy())
        with open(cli_out, "rb") as a, open(ref_ppm, "rb") as b:
            same = a.read() == b.read()
        stats = [ln for ln in done.stdout.splitlines() if ln.startswith("stats: ")]
        log(f"{tag}: exit 0 in {wall:.1f} s, {stats!r}; PPM byte-equal to the in-process "
            f"render: {same}")
        if not same:
            raise AssertionError(f"{tag}: the CLI's PPM differs from the in-process render's")
        out["cli"] = {"check": tag, "wall_s": wall, "byte_equal": same, "stats": stats}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 25: {out['seconds']:.1f} s")
    return out


def nested_scene(zt, device):
    """Phase 26's scene, built with the port's SceneBuilder: 96 spheres (a
    sphere tree for the closest-hit kernel) on a ground quad textured with
    a checker of checkers, one large sphere textured with a checker of a
    seeded image (the general walk's atlas fetch), glass and metal
    spheres, a quad lamp in the light list.  The ground lies at y = -0.2,
    off both checkers' lattice planes (y = k / 2 and y = k / 0.32): on a
    plane a hit's parity would hang on the sign of a rounding residual,
    which the card's and the CPU's transcendentals round apart."""
    import numpy as np

    rng = np.random.default_rng(26)
    b = zt.scene.SceneBuilder()
    inner = b.checkerboard(2.0, b.solid_color((0.8, 0.25, 0.1)), b.solid_color((0.9, 0.9, 0.85)))
    ground = b.checkerboard(0.32, inner, b.solid_color((0.1, 0.3, 0.6)))
    b.add(b.quad((-12, -0.2, -12), (24, 0, 0), (0, 0, 24), b.lambertian(ground)))
    image = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    pictured = b.checkerboard(3.0, b.image_texture(image), b.solid_color((0.7, 0.7, 0.2)))
    b.add(b.sphere((0.0, 1.0, 0.0), 1.2, b.lambertian(pictured)))
    mats = [b.lambertian(b.solid_color(tuple(rng.uniform(0.1, 0.9, 3)))) for _ in range(6)]
    mats += [b.metal((0.8, 0.8, 0.9), 0.05), b.dielectric(1.5)]
    for i in range(96):
        x, z = rng.uniform(-6.0, 6.0, 2)
        if x * x + z * z < 2.5:
            x += 3.0
        b.add(b.sphere((float(x), 0.05, float(z)), 0.25, mats[i % len(mats)]))
    lamp = b.add(b.quad((-1.5, 5.0, -1.5), (3, 0, 0), (0, 0, 3),
                        b.diffuse_light(b.solid_color((7.0, 7.0, 7.0)))))
    b.set_lights([lamp])
    b.set_background((0.15, 0.2, 0.3))
    b.set_camera(zt.scene.Camera(look_from=(0.0, 3.0, 9.0), look_at=(0.0, 0.5, 0.0),
                                 vfov_degrees=40.0))
    b.use_bvh(True)
    return b.compile("nested_checkers", device=device)


def fixed_counts(fused, integrator, ch, ttrace, tb) -> dict:
    """The counts of the fixed-depth path: the closest-hit kernel's
    launches, the plain trace's calls, the path's bounces and every other
    kernel's launches and plain version's calls."""
    return {"k3": ch.closest_hit.launches, "plain_trace": ttrace.closest_hit.calls,
            "bounces": integrator.trace_paths.bounces,
            "k1": launched(fused.render_fused), "k2": launched(tb.bounce) + launched(tb.bounce_regen),
            "plain_kernels": (integrator.render_fused_reference.calls
                              + integrator.bounce_regen_reference.calls)}


def phase_fixed_depth(zt, fused, tb, integrator, ch, ttrace, torch, cornell, fb_main, card) -> dict:
    """Phase 26, the fixed-depth path (render/renderer.py:_render_band over
    render/integrator.py:trace_paths, the closest-hit kernel at every
    bounce): (a) the nested-checker scene at 400x400@64 d10 through
    Renderer.render_device, counts set to 0 just before and read just
    after (the kernel launched, the plain trace and every other kernel
    never), Mpaths/s, and over the render's first chunk the kernel's
    device time per launch and the device idle share (1 - device ms /
    best wall ms, torch.profiler); (b) (a)'s first chunk once more with
    the kernel's wrapper wrapped, which counts each launch's live lanes
    and keeps the rays of bounce 0 and of bounce NESTED_HELD_BOUNCE
    (masked), on which the kernel is then held bitwise to the plain trace
    (ops/trace.py, the cond walk) on the same card tensors; at 64x64@8 d10
    the render bitwise the render with the plain trace in the kernel's
    place on the card, and the card's render against the CPU's within
    rtol 1e-5 / atol 1e-6 on >= 99.9% of pixels, the pixels outside
    printed as (x, y, max |diff|); the plain trace's work
    counts per traced ray and the chunk's live lanes give the kernel's
    bound; (c) the six goldens (tests/golden/<scene>.npz, 64x64@32 d10)
    through the path and utils/goldengate.py, rtw_final on 4x4 regions;
    (d) cornell 400x400@64 d10 through the path and through the render
    kernel's sorted plan, Mpaths/s (not gated); (e) phase 3's framebuffer
    written as .bmp and .jpg and read back by io/native.py; (f)
    tools/golden_check.py in a subprocess, every scene passing."""
    import tempfile

    import numpy as np

    from zig_weekend_raytracer_tpu_torch.io import native
    from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_bounce_kernel
    from zig_weekend_raytracer_tpu_torch.render.renderer import _render_band
    from zig_weekend_raytracer_tpu_torch.utils import profiler, roofline, workcount

    out = {}
    scene = nested_scene(zt, "cuda")
    cs = scene.compiled
    if not (cs.has_nested_checker and cs.has_image_textures and cs.has_sph_tree):
        raise AssertionError("phase 26's scene lost its nested checker, image or sphere tree")
    if supports_bounce_kernel(cs):
        raise AssertionError("a nested-checker scene would take the render kernels")
    renderer = zt.render.Renderer(samples_per_pixel=NESTED_SPP, max_ray_bounce_depth=DEPTH)
    spp_chunk, band_rows = renderer.chunk_geometry(scene, W, H, NESTED_SPP)

    # (a) the path at full width
    reset_counts(fused, integrator, ch, ttrace, tb)
    integrator.trace_paths.bounces = 0
    warm_s, times, fb = timed_renders(renderer, scene, torch, W, H)
    counts = fixed_counts(fused, integrator, ch, ttrace, tb)
    if counts["k3"] < 1 or counts["k3"] != counts["bounces"]:
        raise AssertionError(f"fixed-depth path: {counts}: the kernel did not take every bounce")
    if counts["plain_trace"] or counts["k1"] or counts["k2"] or counts["plain_kernels"]:
        raise AssertionError(f"fixed-depth path ran something but the closest-hit kernel: {counts}")
    fbn = fb.cpu().numpy()
    if fbn.shape != (H, W, 3) or not np.isfinite(fbn).all() or not fbn.mean() > 0:
        raise AssertionError("fixed-depth path: bad framebuffer")
    best = min(times)
    mpaths = W * H * NESTED_SPP / best / 1e6
    # the device split and idle share of the render's first chunk (a trace
    # of the whole render's 44,000 kernels takes the profiler 20 s): its
    # best untraced wall time of three, then one traced run
    chunk = lambda: _render_band(scene, 0, 0, 0, width=W, height=H, band_rows=band_rows,
                                 spp_chunk=spp_chunk, spp=NESTED_SPP, max_depth=DEPTH,
                                 sampler=renderer.sampler,
                                 has_dof=scene.camera.has_depth_of_field)
    chunk_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        chunk_walls.append(time.perf_counter() - t0)
    _, agg, _ = profiler.run_with_device_trace(chunk)
    k3_n, k3_ms = agg.get("closest_hit_kernel", (0, 0.0))
    device_ms = sum(v[1] for v in agg.values())
    idle = 1.0 - device_ms / (min(chunk_walls) * 1e3)
    per_launch = k3_ms / max(k3_n, 1)
    launches_per_render = counts["k3"] // 4
    log(f"fixed-depth nested {W}x{H}@{NESTED_SPP} d{DEPTH}: warmup {warm_s:.3f} s, renders "
        f"{[round(t, 4) for t in times]} s, best {best:.4f} s = {mpaths:.2f} Mpaths/s; "
        f"{spp_chunk} spp x {band_rows} rows a chunk; closest-hit launches {counts['k3']} over 4 "
        f"renders ({launches_per_render} a render), plain trace 0; its first chunk: best wall "
        f"{min(chunk_walls) * 1e3:.3f} ms, device {device_ms:.3f} ms in "
        f"{sum(v[0] for v in agg.values())} kernels, closest_hit_kernel {k3_ms:.3f} ms in {k3_n} "
        f"launches ({per_launch:.4f} ms a launch, {k3_ms / max(device_ms, 1e-12):.1%} of device "
        f"time), idle share {idle:.1%} ({card})")
    out["main"] = {"render_s": times, "render_s_best": best, "warmup_s": warm_s,
                   "mpaths_per_s": mpaths, "launches": counts["k3"],
                   "launches_per_render": launches_per_render, "spp_chunk": spp_chunk,
                   "band_rows": band_rows, "chunk_wall_ms": [t * 1e3 for t in chunk_walls],
                   "chunk_device_ms": device_ms, "chunk_kernels": sum(v[0] for v in agg.values()),
                   "k3_device_ms": k3_ms, "k3_chunk_launches": k3_n,
                   "k3_ms_per_launch": per_launch, "idle_share": idle,
                   "top_kernels": sorted(agg.items(), key=lambda kv: -kv[1][1])[:8]}

    # (b) the kernel against the plain trace at the main path's shape: the
    # first chunk again, its launches counted by live lanes and the rays of
    # two bounces kept; then the 64x64 render against the plain trace's and
    # the CPU's
    t_part = time.perf_counter()
    kernel_trace = ch.closest_hit
    sizes, lives, held = [], [], {}

    def keeping(cs_, o, d, tm, t_min, t_max=float("inf"), active=None):
        b = len(lives)
        sizes.append(o.x.numel())
        lives.append(sizes[-1] if active is None else int(active.sum()))
        if b in (0, NESTED_HELD_BOUNCE):
            held[b] = (type(o)(*(x.clone() for x in o)), type(d)(*(x.clone() for x in d)),
                       tm.clone(), t_min, t_max, None if active is None else active.clone())
        return kernel_trace(cs_, o, d, tm, t_min, t_max, active=active)

    # the kernel's wrapper counts its launches on the module's name, here
    # this function: these launches are the check's and count nothing
    keeping.launches = 0
    ch.closest_hit = keeping
    try:
        chunk()
    finally:
        ch.closest_hit = kernel_trace
    if NESTED_HELD_BOUNCE not in held or not 0 < lives[NESTED_HELD_BOUNCE] < sizes[0]:
        raise AssertionError(f"fixed-depth path: the first chunk's live lanes {lives} give no "
                             f"masked bounce {NESTED_HELD_BOUNCE}")
    checks = []
    for b, (o, d, tm, t_min, t_max, active) in sorted(held.items()):
        rays = (o, d, tm)
        hit_k = kernel_trace(cs, *rays, t_min, t_max, active=active)
        ms_k = kernel_alone_ms(torch, hit_launcher(ch, cs, rays, t_min, t_max=t_max,
                                                   active=active))
        ms_p, hit_p = cuda_time_ms(lambda: ttrace.closest_hit(cs, *rays, t_min, t_max,
                                                              active=active, walk="cond"))
        tag = (f"fixed-depth nested {W}x{H}, chunk 0 ({spp_chunk} spp) bounce {b}: "
               f"{lives[b]} of {sizes[b]} lanes live")
        check = compare_hits(tag, hit_k, hit_p)
        log(f"closest hit {tag}: kernel alone {ms_k:.4f} ms, plain {ms_p:.1f} ms")
        checks.append({**check, "bounce": b, "live": lives[b], "ms": ms_k, "plain_ms": ms_p})
    del held
    t_small = time.perf_counter()
    small = zt.render.Renderer(samples_per_pixel=NESTED_PARITY_SPP, max_ray_bounce_depth=DEPTH)
    wp = NESTED_PARITY_W
    ms_k, fb_k = cuda_time_ms(lambda: small.render_device(scene, wp, wp))
    ch.closest_hit = (lambda cs_, o, d, tm, t_min, t_max=float("inf"), active=None:
                      ttrace.closest_hit(cs_, o, d, tm, t_min, t_max, active=active, walk="cond"))
    try:
        with workcount.counting() as work:
            ms_p, fb_p = cuda_time_ms(lambda: small.render_device(scene, wp, wp))
    finally:
        ch.closest_hit = kernel_trace
    same = bool(torch.equal(fb_k, fb_p))
    diff = float((fb_k - fb_p).abs().max())
    t_cpu = time.perf_counter()
    fb_cpu = small.render_device(nested_scene(zt, "cpu"), wp, wp).numpy()
    log(f"fixed-depth path: (b) the chunk's bounces on the card {t_small - t_part:.1f} s, the "
        f"64x64 renders {t_cpu - t_small:.1f} s, the CPU render {time.perf_counter() - t_cpu:.1f} s")
    fk = fb_k.cpu().numpy()
    agree = float(np.isclose(fk, fb_cpu, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1).mean())
    outliers = cpu_outliers(fb_k, torch.from_numpy(fb_cpu), rtol=PIXEL_RTOL, atol=PIXEL_ATOL)
    log(f"fixed-depth nested {wp}x{wp}@{NESTED_PARITY_SPP} d{DEPTH}: the kernel's render bitwise "
        f"the plain trace's: {same} (max |diff| {diff:.3e}; {ms_k:.1f} ms vs {ms_p:.1f} ms); "
        f"card vs CPU: {agree:.4%} of pixels within rtol 1e-5 / atol 1e-6, max |diff| "
        f"{float(np.abs(fk - fb_cpu).max()):.3e}")
    log(f"fixed-depth nested {wp}x{wp}@{NESTED_PARITY_SPP} d{DEPTH}, card vs CPU: "
        f"{len(outliers)} pixels outside rtol 1e-5 / atol 1e-6 at (x, y, max |diff|) "
        f"{outliers} ({card})")
    if not same:
        raise AssertionError("fixed-depth path: the kernel's render differs from the plain trace's")
    if agree < PIXEL_AGREE:
        raise AssertionError(f"fixed-depth path: card vs CPU agree on {agree:.4%} of pixels")
    out["parity"] = checks + [{
        "check": f"fixed-depth nested {wp}x{wp}@{NESTED_PARITY_SPP} d{DEPTH}, kernel vs plain "
                 "trace on the card (bitwise)",
        "max_abs_err": diff, "ms": ms_k, "plain_ms": ms_p, "cpu_agree": agree,
        "cpu_outliers": outliers}]
    # the bound of one launch of (a), averaged over its first chunk's
    # launches: the plain walk's counts per traced ray of the 64x64 render
    # times the chunk's live lanes a launch; bytes by live and dead lanes
    lanes, live = sum(sizes) / len(sizes), sum(lives) / len(lives)
    per = {k: v * live / work["trace"] for k, v in work.items()}
    bound, by = roofline.hit_bound_ms(per, cs, lanes, OPS_RATE["rate"], live=live)
    out["bound_ms"], out["bound_by"] = bound, by
    out["lanes"], out["live_lanes"] = sizes, lives
    log(f"closest_hit_kernel on the fixed-depth path: {per_launch:.4f} ms a launch against a "
        f"bound of {bound:.4f} ms ({by}; {lanes:.0f} lanes a launch, {live:.0f} live on "
        f"average over the first chunk's {len(lives)} launches: {lives})")

    # (f) starts now and overlaps (c) and (e)
    t_golden = time.perf_counter()
    golden_proc = start_cli([], module="zig_weekend_raytracer_tpu_torch.tools.golden_check")
    try:
        # (c) the goldens through the path that made them
        gates = {}
        for name in ("cornell_box", "balls", "emissive", "earth", "shrek_quads", "rtw_final"):
            golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
            sc = zt.models.load_scene(name, device="cuda")
            r = zt.render.Renderer(samples_per_pixel=int(golden["spp"]),
                                   max_ray_bounce_depth=int(golden["depth"]),
                                   seed=int(golden["seed"]))
            fb_g = r._render_fixed_depth(sc, int(golden["width"]), int(golden["height"]))
            grid = 4 if name == "rtw_final" else 8
            ref = golden["fb"]
            close = float(np.isclose(fb_g.cpu().numpy(), ref, rtol=PIXEL_RTOL,
                                     atol=PIXEL_ATOL).all(-1).mean())
            from zig_weekend_raytracer_tpu_torch.utils.goldengate import region_means

            verdict = gate(f"fixed-depth {name} {ref.shape[1]}x{ref.shape[0]} "
                           f"spp{int(golden['spp'])} d{int(golden['depth'])}, {grid}x{grid} "
                           "regions", fb_g, ref.mean(), region_means(ref, grid))
            log(f"fixed-depth {name}: {close:.2%} of pixels within rtol 1e-5 / atol 1e-6 of "
                "the golden")
            gates[name] = {"verdict": verdict, "pixels_close": close}
        out["goldens"] = gates
        log(f"fixed-depth path: (c) {time.perf_counter() - t_golden:.1f} s")

        # (d) the cost of the general path on cornell
        costs = {}
        general = zt.render.Renderer(samples_per_pixel=FIXED_COST_SPP, max_ray_bounce_depth=DEPTH)
        for tag, run in (("fixed-depth", lambda: general._render_fixed_depth(cornell, W, H)),
                         ("render kernel, sorted plan",
                          lambda: general.render_device(cornell, W, H))):
            run()
            torch.cuda.synchronize()
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            costs[tag] = {"render_s": ts, "mpaths_per_s": W * H * FIXED_COST_SPP / min(ts) / 1e6}
        log(f"cornell {W}x{H}@{FIXED_COST_SPP} d{DEPTH}: fixed-depth path "
            f"{costs['fixed-depth']['mpaths_per_s']:.2f} Mpaths/s, render kernel (sorted plan) "
            f"{costs['render kernel, sorted plan']['mpaths_per_s']:.2f} Mpaths/s ({card})")
        out["cornell_cost"] = costs
        log(f"fixed-depth path: (c) and (d) {time.perf_counter() - t_golden:.1f} s")

        # (e) the writers, read back by the port's own decoder
        want = zt.io.encode_pixels(fb_main.cpu().numpy())
        with tempfile.TemporaryDirectory() as tmp:
            paths = {ext: os.path.join(tmp, f"phase3.{ext}") for ext in ("bmp", "jpg")}
            for path in paths.values():
                zt.io.write_image(path, fb_main.cpu().numpy())
            got = {ext: native.decode_image(open(path, "rb").read())
                   for ext, path in paths.items()}
        bmp_equal = bool(np.array_equal(got["bmp"], want))
        mse = float(np.mean((got["jpg"].astype(np.float64) - want.astype(np.float64)) ** 2))
        psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        log(f"writers: phase 3's {W}x{H} framebuffer as .bmp read back equal: {bmp_equal}; as "
            f".jpg read back at {psnr:.2f} dB PSNR")
        if not bmp_equal or psnr < JPEG_MIN_PSNR:
            raise AssertionError(f"writers: bmp equal {bmp_equal}, jpeg {psnr:.2f} dB")
        out["writers"] = {"bmp_equal": bmp_equal, "jpeg_psnr_db": psnr}
    finally:
        done, golden_s = finish_cli(golden_proc, t_golden)
    lines = done.stdout.strip().splitlines()
    for line in lines:
        log(f"golden_check: {line}")
    if done.returncode != 0 or len(lines) != 6 or not all(": pass" in x for x in lines):
        raise AssertionError(f"tools/golden_check.py exited {done.returncode}: {done.stderr[-2000:]}")
    log(f"fixed-depth path: (f) golden_check took {golden_s:.1f} s from its start")
    out["golden_check"] = {"rc": done.returncode, "lines": lines, "wall_s": golden_s}
    return out


def phase_tools(zt, fused, tb, integrator, ch, ttrace, torch, fbs, figures, card) -> dict:
    """Phase 27: the user tools of ``zig_weekend_raytracer_tpu_torch/tools/``
    on the card, in this process through their entry points, each with its
    counts set to 0 just before and read just after (the kernels it must
    launch launched, no plain version ran): (a) scenebench: balls 400x400@128
    d10 and rtw_final 400x400@64 d8 (their framebuffers bitwise phases 7 and
    11's render_device), then cornell 400x400@1024 d10 with --rr=3,
    --clamp=10, --adaptive, --shard=samples (one card: bitwise phase 3's),
    --supersample=2 and --denoise=3, every line nan=False, Mpaths/s beside
    phases 3, 7 and 11; (b) shard_overhead at its defaults, exit 0; (c)
    lut_quality on shrek_quads at its defaults and on rtw_final at 32768
    texels, the LUT active, every figure finite; (d) quality_prodres at its
    defaults, one scene a call, four rows with finite MSE ratios; (e)
    imgdiff: phase 3's framebuffer as PPM against itself (mse 0) and as
    .jpg (written as phase 26(e) writes it) against the PPM, in process
    and as the command line; a missing path exits 1."""
    import io
    import tempfile

    import numpy as np

    from zig_weekend_raytracer_tpu_torch.tools import (
        imgdiff, lut_quality, quality_prodres, scenebench, shard_overhead)

    t_phase = time.perf_counter()
    fb_main, fb_balls, fb_rtw = fbs
    out = {"runs": {}, "launches": {k: {} for k in (
        "K1 brute", "K1 tree", "K1 LUT", "K1 estimator", "K2 regen", "K3", "K3 keys")}}

    def run(tag, fn, need, joins):
        """fn() with the counts set to 0 before and read after, its stdout
        and stderr kept; ``need`` the counts that must be positive,
        ``joins`` {record key: count key} of the launches it adds."""
        reset_counts(fused, integrator, ch, ttrace, tb)
        so, se = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"k1": launched(fused.render_fused),
                  "k1_estimator": fused.render_fused.estimator_launches,
                  "k2": launched(tb.bounce_regen), "k2_one_bounce": launched(tb.bounce),
                  "k3": ch.closest_hit.launches, "keys": ch.coherent_keys.launches,
                  "plain": plain_calls(integrator, ttrace)}
        for line in (so.getvalue() + se.getvalue()).splitlines():
            log(f"  {tag}: {line}")
        log(f"{tag}: {wall:.1f} s; counts {counts}")
        if counts["plain"] or counts["k2_one_bounce"] or any(counts[k] < 1 for k in need):
            raise AssertionError(f"{tag}: the tool did not run through its kernels alone "
                                 f"(needs {need}): {counts}")
        for key, c in joins.items():
            out["launches"][key][tag] = counts[c]
        out["runs"][tag] = {"wall_s": wall, "counts": counts, "stdout": so.getvalue(),
                            "stderr": se.getvalue()}
        return res, so.getvalue()

    # (a) scenebench
    bench = {}
    cases = (
        ("balls", ["balls", "400", "400", "128", "10"], ("k1", "keys"),
         {"K1 tree": "k1", "K3": "k3", "K3 keys": "keys"}, fb_balls, figures["balls"]),
        ("rtw_final", ["rtw_final", "400", "400", "64", "8"], ("k2", "keys"),
         {"K2 regen": "k2", "K3": "k3", "K3 keys": "keys"}, fb_rtw, figures["rtw_final"]),
        ("--rr=3", ["cornell_box", "400", "400", "1024", "10", "--rr=3"], ("k1_estimator",),
         {"K1 estimator": "k1_estimator"}, None, figures["cornell"]),
        ("--clamp=10", ["cornell_box", "400", "400", "1024", "10", "--clamp=10"],
         ("k1_estimator",), {"K1 estimator": "k1_estimator"}, None, figures["cornell"]),
        ("--adaptive", ["cornell_box", "400", "400", "1024", "10", "--adaptive"], ("k1",),
         {"K1 brute": "k1"}, None, figures["cornell"]),
        ("--shard=samples", ["cornell_box", "400", "400", "1024", "10", "--shard=samples"],
         ("k1",), {"K1 brute": "k1"},
         fb_main if torch.cuda.device_count() == 1 else None, figures["cornell"]),
        ("--supersample=2", ["cornell_box", "400", "400", "1024", "10", "--supersample=2"],
         ("k1",), {"K1 brute": "k1"}, None, figures["cornell"]),
        ("--denoise=3", ["cornell_box", "400", "400", "1024", "10", "--denoise=3"],
         ("k1", "k3"), {"K1 brute": "k1", "K3": "k3"}, None, figures["cornell"]),
    )
    for tag, argv, need, joins, want, beside in cases:
        res, text = run(f"scenebench {tag}", lambda: scenebench.bench(argv), need, joins)
        lines = text.splitlines()
        head = lines[0]
        mp = float(head.split(" Mpaths/s)")[0].rsplit("(", 1)[1])
        if "nan=False" not in head or not bool(torch.isfinite(res["fb"]).all()):
            raise AssertionError(f"scenebench {tag}: {head}")
        bitwise = None if want is None else bool(torch.equal(res["fb"], want))
        log(f"scenebench {tag}: {mp:.1f} Mpaths/s beside the main path's {beside:.2f} "
            f"(phases 3, 7, 11); bitwise the same configuration's render_device: {bitwise} "
            f"({card})")
        if bitwise is False:
            raise AssertionError(f"scenebench {tag}: not the render_device framebuffer")
        if tag == "--denoise=3" and (len(lines) != 2 or res["denoised"] is None
                                     or not bool(torch.isfinite(res["denoised"]).all())):
            raise AssertionError(f"scenebench {tag}: no denoise line or a bad image")
        bench[tag] = {"lines": lines, "mpaths_per_s": mp, "phase_mpaths_per_s": beside,
                      "bitwise_render_device": bitwise}
    out["scenebench"] = bench

    # (b) shard_overhead at its defaults
    rc, text = run("shard_overhead", lambda: shard_overhead.main([]), ("k1",),
                   {"K1 brute": "k1"})
    line = json.loads(text.splitlines()[-1])
    log(f"shard_overhead: exit {rc}; overhead samples {line['overhead_samples']}, rows "
        f"{line['overhead_rows']} ({card})")
    if rc != 0 or not (line["agree_samples"] and line["agree_rows"]):
        raise AssertionError(f"shard_overhead: exit {rc}, {line}")
    out["shard_overhead"] = line

    # (c) lut_quality
    luts = {}
    for tag, argv in (("shrek_quads", ["shrek_quads"]), ("rtw_final 32768", ["rtw_final", "32768"])):
        rc, text = run(f"lut_quality {tag}", lambda: lut_quality.main(argv), ("k1", "k2"),
                       {"K1 LUT": "k1", "K2 regen": "k2", "K3 keys": "keys"})
        summary = json.loads(text.splitlines()[-1])
        figs = [v for r in summary["rows"] for k, v in r.items()
                if k not in ("budget", "lut_active")]
        if rc != 0 or not all(r["lut_active"] for r in summary["rows"]) or not all(
                v is not None and np.isfinite(v) for v in figs):
            raise AssertionError(f"lut_quality {tag}: exit {rc}, {summary}")
        luts[tag] = summary
    rtw_row = luts["rtw_final 32768"]["rows"][0]
    log(f"lut_quality rtw_final 32768 texels (400x400@64 d10): mse {rtw_row['mse_vs_exact']}, "
        f"max |diff| {rtw_row['max_abs']} against the exact (atlas) render; beside phase 14's "
        f"mean |diff| {figures['lut_32k_mean_abs_diff']:.4e} against the native-budget render "
        f"(400x400@64 d8; not compared: other references and depths; {card})")
    out["lut_quality"] = luts

    # (d) quality_prodres at its defaults, one scene a call
    rows = []
    for scene_name, need, joins in (
            ("cornell_box", ("k1", "k3"), {"K1 brute": "k1", "K3": "k3"}),
            ("balls", ("k1", "k3", "keys"), {"K1 tree": "k1", "K3": "k3", "K3 keys": "keys"})):
        rc, text = run(f"quality_prodres {scene_name}",
                       lambda: quality_prodres.main([scene_name]), need, joins)
        if rc != 0:
            raise AssertionError(f"quality_prodres {scene_name}: exit {rc}")
        rows += [json.loads(x) for x in text.splitlines()[:-1]]
    if len(rows) != 4 or not all(np.isfinite(v) for r in rows for v in r["mse_ratio"].values()):
        raise AssertionError(f"quality_prodres: {rows}")
    for r in rows:
        log(f"quality_prodres {r['scene']} {r['size']}x{r['size']}@{r['spp']} (ref "
            f"{r['ref_spp']}, {r['seeds']} seeds): mse uniform {r['mse_uniform']}, ratios "
            f"{r['mse_ratio']}, wall {r['wall_s']} s ({card})")
    out["quality_prodres"] = rows

    # (e) imgdiff on phase 3's framebuffer; no kernel
    with tempfile.TemporaryDirectory() as tmp:
        ppm, jpg = os.path.join(tmp, "phase3.ppm"), os.path.join(tmp, "phase3.jpg")
        host = fb_main.cpu().numpy()
        zt.io.write_image(ppm, host)
        zt.io.write_image(jpg, host)
        missing = os.path.join(tmp, "missing.png")
        t0 = time.perf_counter()
        cli = {k: start_cli(a, module="zig_weekend_raytracer_tpu_torch.tools.imgdiff")
               for k, a in (("jpg", [jpg, ppm]), ("missing", [missing, ppm]))}
        so = io.StringIO()
        with contextlib.redirect_stdout(so):
            rc_same = imgdiff.main([ppm, ppm])
            rc_jpg = imgdiff.main([jpg, ppm])
        same, vs_jpg = so.getvalue().splitlines()
        done = {k: finish_cli(p, t0)[0] for k, p in cli.items()}
    log(f"imgdiff: {same} (exit {rc_same}); {vs_jpg} (exit {rc_jpg}); command line: "
        f"{done['jpg'].stdout.strip()} (exit {done['jpg'].returncode}); a missing path: exit "
        f"{done['missing'].returncode}, {done['missing'].stderr.strip()!r}")
    if (rc_same, rc_jpg, done["jpg"].returncode) != (0, 0, 0) or "mse=0.000e+00" not in same \
            or done["jpg"].stdout.split(": ", 1)[1].strip() != vs_jpg.split(": ", 1)[1] \
            or done["missing"].returncode == 0:
        raise AssertionError("imgdiff: wrong exit codes or statistics")
    out["imgdiff"] = {"same": same, "jpg": vs_jpg, "cli_jpg": done["jpg"].stdout.strip(),
                      "missing_rc": done["missing"].returncode}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 27: {out['seconds']:.1f} s")
    return out


def run_harness(args, timeout=HARNESS_TIMEOUT_S):
    """python -m zig_weekend_raytracer_tpu_torch.tools.bench ``args`` from
    the repository root in a session of its own, killed with its children
    past ``timeout`` s: (exit code, stdout, stderr, wall s)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "zig_weekend_raytracer_tpu_torch.tools.bench", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err, time.perf_counter() - t0


def phase_harness(card, mpaths, kernel_ms, bound) -> dict:
    """Phase 28: the harness at each of HARNESS_RUNS; its north-star line
    against phase 3's Mpaths/s and phase 4's kernel time and bound."""
    out = {}
    for args in HARNESS_RUNS:
        tag = " ".join(args) or "north star"
        rc, stdout, stderr, wall = run_harness(args)
        for line in stderr.strip().splitlines()[-10:]:
            log(f"  harness {tag} stderr: {line}")
        lines = stdout.strip().splitlines()
        log(f"harness {tag}: exit {rc} in {wall:.1f} s: {lines[-1] if lines else '(no line)'}")
        if rc != 0 or not lines:
            raise AssertionError(f"harness {tag}: exit {rc}, {len(lines)} lines")
        rec = json.loads(lines[-1])
        need = ("K1", "K5", "K3c") if args else ("K1", "K5")
        if (not str(rec["correctness"]).startswith("pass") or rec["device"] != card
                or any(rec["launches"][k] < 1 for k in need)
                or not all(rec[k] > 0 for k in ("value", "kernel_ms", "bound_ms",
                                                "iters_per_path", "warmup_s"))):
            raise AssertionError(f"harness {tag}: not a passing run on {card}: {rec}")
        out[tag] = {**rec, "exit": rc, "wall_s": wall}
    ns = out["north star"]
    log(f"harness north star {ns['value']:.2f} Mpaths/s beside phase 3's {mpaths:.2f}; kernel "
        f"{ns['kernel_ms']:.3f} ms beside phase 4's {kernel_ms:.3f}; bound {ns['bound_ms']:.3f} "
        f"ms ({ns['peak_source']}) beside phase 4's {bound:.3f}; host {ns['host_ms']:.3f} ms; "
        f"warmup {ns['warmup_s']:.3f} s ({card})")
    for what, got, want, tol in (("value", ns["value"], mpaths, HARNESS_VALUE_AGREE),
                                 ("kernel_ms", ns["kernel_ms"], kernel_ms, HARNESS_KERNEL_AGREE),
                                 ("bound_ms", ns["bound_ms"], bound, HARNESS_KERNEL_AGREE)):
        if abs(got - want) > tol * want:
            raise AssertionError(f"harness north star {what} {got} is not within {tol:.0%} of "
                                 f"{want}")
    return out


def est_kernel_times(zt, fused, torch, renderer, scene, card) -> dict:
    """The render kernel at the sorted plan of ``renderer`` (cornell
    400x400@1024 d10): the estimator instantiation (rr3) and the default
    one on the same lanes, in 3 alternating pairs; the estimator's work."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    key = (W, H, 0, SPP, DEPTH, renderer.sampler, renderer.seed)
    px, py, s0, s1 = renderer._plan_cache[scene.compiled][key]["plan"]
    kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
              width=W, height=H, spp=SPP, stride=1, max_depth=DEPTH, has_dof=False,
              want_work=True)
    run = lambda **o: fused.render_fused(scene.compiled, px, py, s0, s1, 0, zt.dtypes.T_MIN,
                                         **kw, **o)
    est, dflt, work = [], [], None
    for _ in range(3):
        ms, (_, work) = cuda_time_ms(lambda: run(rr_start=RR_START), 1)
        est.append(ms)
        dflt.append(cuda_time_ms(lambda: run(), 1)[0])
    log(f"render kernel at the rr3 plan ({px.shape[0]} lanes): estimator instantiation "
        f"{[round(t, 3) for t in est]} ms, default {[round(t, 3) for t in dflt]} ms ({card})")
    return {"ms": min(est), "default_ms": min(dflt), "pairs_ms": list(zip(est, dflt)),
            "work": int(work.sum()), "lanes": int(px.shape[0])}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        import zig_weekend_raytracer_tpu_torch as zt
        from zig_weekend_raytracer_tpu_torch.ops import _build
        from zig_weekend_raytracer_tpu_torch.ops import bounce as tb
        from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
        from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
        from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
        from zig_weekend_raytracer_tpu_torch.render import integrator
        from zig_weekend_raytracer_tpu_torch.tools.bench import card_name
        from zig_weekend_raytracer_tpu_torch.utils import workcount
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "zig_weekend_raytracer_tpu" in sys.modules:
        print("chip_smoke: JAX was imported", file=sys.stderr)
        return 1

    # ---- 1. device and build ----
    phase("1")
    card = card_name()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    built = _build.build()
    log(f"kernel build: {built['seconds']:.1f} s (cached={built['cached']})")
    for line in built["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")
    resources = kernel_resources(built["log"])
    for name, res in resources.items():
        log(f"  {name}: {res['registers']} registers, {res['spill_bytes']} bytes spill stores")
    n_chain = 5 * 2 * 4  # ops x chain counts x unrolls
    # per kernel: 2 modes x 6 walks (5 and the tree-less kWalkNoTree) and
    # the estimator instantiations (2 modes x 6 walks), and the phase
    # profile on the work-queue kernels: K1 in both modes and K2's
    # regenerating mode, each for cond, queue and kWalkNoTree
    n_render = 2 * (2 * 6 + 2 * 6) + 2 * 3 + 3
    # closest_hit_kernel and coherent_keys_kernel
    if len(resources) != n_render + 2 + n_chain or any(
            r["registers"] is None for r in resources.values()):
        raise AssertionError(f"ptxas did not report every kernel: {sorted(resources)}")
    for name, (regs, spill) in DEFAULT_RESOURCES.items():
        got = (resources[name]["registers"], resources[name]["spill_bytes"])
        if got != (regs, spill):
            raise AssertionError(f"{name}: {got} registers and spill bytes, not the recorded "
                                 f"{(regs, spill)}")
    _build.load_library()

    # ---- 1b. the FP32 peak: every later bound divides by its add rate ----
    phase("1b")
    peak = phase_fp32_peak(torch, built, card)

    # ---- 2. kernel against plain ----
    phase("2")
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    checks = [render_parity(zt, fused, integrator, torch, cornell, "cornell 32x32 spp8 d10")]

    # ---- 3. the main path ----
    phase("3")
    renderer = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    warm_s, times, fb = timed_renders(renderer, cornell, torch, W, H)
    launches = launched(fused.render_fused)
    n_plain = plain_calls(integrator, ttrace)
    log(f"main path: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s")
    log(f"main path: kernel launches {launches}, plain-version calls {n_plain}")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if n_plain != 0:
        raise AssertionError("the main path ran the plain version")
    if tuple(fb.shape) != (H, W, 3):
        raise AssertionError(f"bad framebuffer: shape {tuple(fb.shape)}")
    with open(GOLDEN) as f:
        ref = json.load(f)
    verdict = gate("cornell 400x400", fb, ref["mean"], ref["region_means"])
    best = min(times)
    mpaths = W * H * SPP / best / 1e6
    log(
        f"main path best {best:.4f} s = {mpaths:.2f} Mpaths/s "
        f"(cornell {W}x{H}@{SPP} spp d{DEPTH}; {card})"
    )

    # ---- 4. kernel against plain at the main path's lanes ----
    phase("4")
    key = (W, H, 0, SPP, DEPTH, renderer.sampler, renderer.seed)
    px, py, s0, s1 = renderer._plan_cache[cornell.compiled][key]["plan"]
    n = px.shape[0]
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    kw = dict(
        camera_consts=camera_consts(cornell.camera, W, H), sampler=renderer.sampler,
        width=W, height=H, spp=SPP, stride=1, max_depth=DEPTH, has_dof=False,
    )
    t_min = zt.dtypes.T_MIN
    kernel_ms, (_, main_work) = cuda_time_ms(
        lambda: fused.render_fused(cornell.compiled, px, py, s0, s1, 0, t_min,
                                   want_work=True, **kw), 3
    )
    log(f"kernel at main-path lanes ({n} lanes, {SPP} spp): {kernel_ms:.3f} ms")

    def plain(lanes, spp, want_work=False):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: plain_k1(fused, integrator, cornell.compiled, *lanes[:3], lim, 0, t_min,
                             want_work=want_work, **kw)
        )

    def kernel(lanes, spp, repeats):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: fused.render_fused(
                cornell.compiled, *lanes[:3], lim, 0, t_min, want_work=True, **kw
            ), repeats,
        )

    plan = (px, py, s0, s1)
    probe_spp = 8
    probe_ms, _ = plain(plan, probe_spp)
    plain_spp = probe_spp
    while plain_spp * 2 <= SPP and probe_ms * (plain_spp * 2) / probe_spp <= PLAIN_BUDGET_S * 1e3:
        plain_spp *= 2
    with workcount.counting() as k1_counts:
        plain_ms, out_p = plain(plan, plain_spp, want_work=True)
    kernel_ms_same, out_k = kernel(plan, plain_spp, 3)
    log(
        f"plain version at main-path lanes, {plain_spp} spp: {plain_ms:.1f} ms; "
        f"kernel at {plain_spp} spp: {kernel_ms_same:.3f} ms; "
        f"ratio {plain_ms / kernel_ms_same:.1f}x ({card})"
    )
    checks.append(compare(f"main-path lanes {plain_spp} spp d{DEPTH}", out_k, out_p))
    # every sample bit of the main path: a slice spread over the cost-sorted
    # plan, its lanes in 32-sample windows that together cover the full spp
    # (the Sobol scale comes from W and H)
    checks.append(plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path",
                              window=MAIN_WINDOW)[0])
    # each lane's accumulation over the full 1024 samples, on a smaller
    # slice at a cut depth
    checks.append(plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path",
                              depth=FULL_DRAIN_DEPTH, lanes=FULL_DRAIN_LANES)[0])
    # the timed run's lanes read (px, py, s0, s1) and write radiance and
    # work; its bound from the work of every lane at plain_spp
    k1_bound = render_bound(zt, cornell, dict(k1_counts), main_work.sum().item(), n * (16 + 16),
                            False, SPP)

    # ---- 5. closest-hit kernel against plain ----
    phase("5")
    hit_checks = phase_closest_hit(zt, ch, ttrace, torch)

    # ---- 6. render kernel with the tree walk and depth of field ----
    phase("6")
    balls = zt.models.load_scene("balls", device="cuda")
    with leaf_span(2):
        balls2 = zt.models.load_scene("balls", device="cuda")
    tree_checks = [
        render_parity(zt, fused, integrator, torch, balls, "balls 32x32 spp8 d10, default span"),
        render_parity(zt, fused, integrator, torch, balls2, "balls 32x32 spp8 d10, span 2"),
    ]

    # ---- 7. the balls main path ----
    phase("7")
    b_renderer = zt.render.Renderer(samples_per_pixel=BALLS_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    b_warm_s, b_times, b_fb = timed_renders(b_renderer, balls, torch, W, H)
    b_launches = launched(fused.render_fused)
    b_hit_launches = ch.closest_hit.launches
    b_keys = ch.coherent_keys.launches
    b_plain = plain_calls(integrator, ttrace)
    plans = b_renderer._plan_cache[balls.compiled]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"balls main path: warmup {b_warm_s:.3f} s, renders {[round(t, 4) for t in b_times]} s")
    log(f"balls main path: render kernel launches {b_launches}, coherent-keys kernel "
        f"launches {b_keys}, closest-hit kernel launches {b_hit_launches}, plain-version "
        f"calls {b_plain}, coherent plans {len(coherent)}")
    if b_launches < 1 or b_keys < 1:
        raise AssertionError("the balls main path did not launch both kernels")
    if b_plain != 0:
        raise AssertionError("the balls main path ran a plain version")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the balls main path did not take the coherent driver")
    if tuple(b_fb.shape) != (H, W, 3) or not bool(torch.isfinite(b_fb).all()):
        raise AssertionError("bad balls framebuffer")
    b_best = min(b_times)
    b_mpaths = W * H * BALLS_SPP / b_best / 1e6
    log(f"balls main path best {b_best:.4f} s = {b_mpaths:.2f} Mpaths/s "
        f"(balls {W}x{H}@{BALLS_SPP} spp d{DEPTH}; {card})")
    b_plan = plans[coherent[0]]["plan"]
    b_kw = dict(
        camera_consts=camera_consts(balls.camera, W, H), sampler=b_renderer.sampler,
        width=W, height=H, spp=BALLS_SPP, stride=1, max_depth=DEPTH, has_dof=True,
    )
    b_kernel_ms, (_, b_work) = cuda_time_ms(
        lambda: fused.render_fused(balls.compiled, *b_plan, 0, t_min, want_work=True, **b_kw), 3
    )
    log(f"kernel at the coherent plan ({b_plan[0].shape[0]} lanes, {BALLS_SPP} spp): "
        f"{b_kernel_ms:.3f} ms ({card})")
    b_slice, b_counts = plan_parity(zt, fused, integrator, balls, b_plan, BALLS_SPP, card,
                                    "coherent-plan", window=PLAN_WINDOW)
    tree_checks.append(b_slice)
    k1_tree_bound = render_bound(zt, balls, b_counts, b_work.sum().item(),
                                 b_plan[0].shape[0] * (16 + 12), True, BALLS_SPP)
    b_keys_check = keys_check(zt, ch, ttrace, torch, balls, b_renderer, "balls 400x400", card)

    # ---- 8. the balls region gates ----
    phase("8")
    balls_gates = region_gates(zt, np, balls, "balls")

    # ---- 9. bounce kernel, one-bounce mode, against plain ----
    phase("9")
    images = {name: zt.models.load_scene(name, device="cuda")
              for name in ("rtw_final", "shrek_quads", "earth")}
    rtw = images["rtw_final"]
    k2_one = phase_one_bounce(zt, tb, integrator, torch, images)
    k2_checks = []

    # ---- 10. bounce kernel, regenerating mode, against plain ----
    phase("10")
    for name, depth, spp in (("earth", 10, 8), ("shrek_quads", 10, 8),
                             ("rtw_final", RTW_DEPTH, RTW_SMALL_SPP)):
        tag = f"{name} 32x32 spp{spp} d{depth}"
        k2_checks.append(regen_parity(zt, tb, integrator, torch, images[name], 32, spp, depth,
                                      tag)[0])

    # ---- 11. the rtw_final main path ----
    phase("11")
    r_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    r_warm_s, r_times, r_fb = timed_renders(r_renderer, rtw, torch, W, H)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    r_k2 = launched(tb.bounce_regen) + launched(tb.bounce)
    r_hit = ch.closest_hit.launches
    r_keys = ch.coherent_keys.launches
    r_k1 = launched(fused.render_fused)
    r_plain = plain_calls(integrator, ttrace)
    passes, bands = integrator.trace_paths_regen.passes, integrator.trace_paths_regen.bands
    plans = r_renderer._plan_cache[rtw.compiled]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"rtw_final main path: warmup {r_warm_s:.3f} s, renders {[round(t, 4) for t in r_times]} s")
    log(f"rtw_final main path: bounce kernel launches {r_k2}, coherent-keys kernel launches "
        f"{r_keys}, closest-hit kernel launches {r_hit}, render kernel launches {r_k1}, "
        f"plain-version calls {r_plain}, coherent plans {len(coherent)}; driver loop "
        f"{passes} passes over {bands} bands ({passes / max(bands, 1):.2f} per band)")
    if r_k2 < 1 or r_keys < 1:
        raise AssertionError("the rtw_final main path did not launch both kernels")
    if r_k1 != 0 or r_plain != 0:
        raise AssertionError("the rtw_final main path ran the render kernel or a plain version")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the rtw_final main path did not take the coherent driver")
    if tuple(r_fb.shape) != (H, W, 3) or not bool(torch.isfinite(r_fb).all()):
        raise AssertionError("bad rtw_final framebuffer")
    r_best = min(r_times)
    r_mpaths = W * H * RTW_SPP / r_best / 1e6
    log(f"rtw_final main path best {r_best:.4f} s = {r_mpaths:.2f} Mpaths/s "
        f"(rtw_final {W}x{H}@{RTW_SPP} spp d{RTW_DEPTH}; {card}); peak device memory "
        f"{peak_mb:.1f} MiB")
    r_plan = plans[coherent[0]]["plan"]
    r_kw = dict(
        camera_consts=camera_consts(rtw.camera, W, H), sampler=r_renderer.sampler, width=W,
        height=H, spp=RTW_SPP, stride=1, max_depth=RTW_DEPTH, has_dof=False,
    )
    st0 = integrator.initial_regen_state(r_plan[2], 1)
    k2_ms, k2_state = cuda_time_ms(
        lambda: tb.bounce_regen(rtw.compiled, st0, r_plan[0], r_plan[1], r_plan[3], 0, t_min,
                                **r_kw), 3)
    log(f"bounce kernel at the coherent plan ({r_plan[0].shape[0]} lanes, {RTW_SPP} spp): "
        f"{k2_ms:.3f} ms ({card})")
    r_launch_mib = launch_mib(torch, rtw, r_renderer, "rtw_final main path's bounce kernel")
    step = max(1, r_plan[0].shape[0] // SLICE_LANES)
    slice_lanes = tuple(a[::step][:SLICE_LANES].contiguous() for a in r_plan[:2])
    k2_slice, k2_counts, _ = regen_parity(
        zt, tb, integrator, torch, rtw, W, RTW_SPP, RTW_DEPTH,
        f"{SLICE_LANES} coherent-plan lanes, {RTW_SPP} spp in {PLAN_WINDOW}-sample windows "
        f"d{RTW_DEPTH}", lanes=slice_lanes, window=PLAN_WINDOW)
    k2_checks.append(k2_slice)
    # lanes read 13 float and 5 int state rows and (px, py, limit), and
    # write the 18 state rows
    k2_bound = render_bound(zt, rtw, k2_counts, k2_state.work.sum().item(),
                            r_plan[0].shape[0] * (84 + 72), False, RTW_SPP)
    r_keys_check = keys_check(zt, ch, ttrace, torch, rtw, r_renderer, "rtw_final 400x400",
                              card)

    # ---- 12. the image scenes' region gates ----
    phase("12")
    # rtw_final's 64x64 golden holds 2,048 samples per 8x8-pixel region,
    # too few for its dark regions, whose light comes from rare paths: those
    # decorrelate from the golden's (XLA's contracted multiply-adds; the
    # port equals the JAX integrator run unfused, lane for lane), so its
    # gate takes 4x4 regions of 8,192 samples
    image_gates = {name: region_gates(zt, np, images[name], name,
                                      grid64=4 if name == "rtw_final" else 8)
                   for name in ("earth", "shrek_quads", "rtw_final")}

    # ---- 13. the render kernel with a texture LUT against plain ----
    phase("13")
    luts = {f"{name} {budget}": zt.models.load_scene(name, device="cuda", texture_lut=budget)
            for name, budget in (("rtw_final", LUT_NATIVE), ("rtw_final", LUT_32K),
                                 ("shrek_quads", LUT_8K), ("earth", LUT_8K))}
    rtw_lut = luts[f"rtw_final {LUT_NATIVE}"]
    lc = rtw_lut.compiled
    log(f"texture LUT rtw_final at {LUT_NATIVE}: dims {lc.tex_lut_dims}, "
        f"{lc.tex_lut_tab.numel() * 4 / 1e6:.1f} MB; atlas {tuple(lc.atlas_packed.shape)}, "
        f"{lc.atlas_packed.numel() * 4 / 1e6:.1f} MB")
    lut_checks = []
    for tag, scene in luts.items():
        rtw_lut_scene = tag.startswith("rtw_final")
        depth, spp = (RTW_DEPTH, RTW_SMALL_SPP) if rtw_lut_scene else (DEPTH, 8)
        lut_checks.append(render_parity(zt, fused, integrator, torch, scene,
                                        f"{tag} 32x32 spp{spp} d{depth}", depth, spp=spp))
    lut_checks.append(render_parity(zt, fused, integrator, torch, emitter_scene(zt, LUT_NATIVE),
                                    f"image lamp, LUT {LUT_NATIVE} 32x32 spp8 d{DEPTH}"))
    k2_checks.append(regen_parity(zt, tb, integrator, torch, emitter_scene(zt, 0), 32, 8, DEPTH,
                                  f"image lamp, atlas 32x32 spp8 d{DEPTH}")[0])
    k2_lut = one_bounce_parity(zt, tb, integrator, torch, rtw_lut, f"rtw_final LUT {LUT_NATIVE}",
                               (0,))

    # ---- 14. the LUT main path ----
    phase("14")
    l_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    l_warm_s, l_times, l_fb = timed_renders(l_renderer, rtw_lut, torch, W, H)
    l_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    l_k1 = launched(fused.render_fused)
    l_k2 = launched(tb.bounce_regen) + launched(tb.bounce)
    l_hit = ch.closest_hit.launches
    l_keys = ch.coherent_keys.launches
    l_plain = plain_calls(integrator, ttrace)
    plans = l_renderer._plan_cache[lc]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"rtw_final LUT main path: warmup {l_warm_s:.3f} s, renders "
        f"{[round(t, 4) for t in l_times]} s")
    log(f"rtw_final LUT main path: render kernel launches {l_k1}, bounce kernel launches "
        f"{l_k2}, coherent-keys kernel launches {l_keys}, closest-hit kernel launches "
        f"{l_hit}, plain-version calls {l_plain}, coherent plans {len(coherent)}")
    if l_k1 != 4 or l_k2 != 0 or l_plain != 0 or l_keys < 1:
        raise AssertionError("the LUT main path did not run the render kernel alone "
                             "(4 launches, no bounce kernel, no plain version)")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the LUT main path did not take the coherent driver")
    if tuple(l_fb.shape) != (H, W, 3) or not bool(torch.isfinite(l_fb).all()):
        raise AssertionError("bad rtw_final LUT framebuffer")
    l_best = min(l_times)
    l_mpaths = W * H * RTW_SPP / l_best / 1e6
    l_close = torch.isclose(l_fb, r_fb, rtol=1e-5, atol=1e-6).all(-1).float().mean().item()
    l_vs_atlas = (l_fb - r_fb).abs().max().item()
    log(f"rtw_final LUT main path best {l_best:.4f} s = {l_mpaths:.2f} Mpaths/s (atlas, bounce "
        f"kernel: {r_mpaths:.2f}; {card}); peak device memory {l_peak_mb:.1f} MiB; against "
        f"the atlas render: {l_close:.4%} of pixels within rtol 1e-5/atol 1e-6, "
        f"max |diff| {l_vs_atlas:.3e}")
    if l_close < 0.999:
        raise AssertionError("the LUT render disagrees with the atlas render")
    l_plan = plans[coherent[0]]["plan"]
    l_kernel_ms, (_, l_work) = cuda_time_ms(
        lambda: fused.render_fused(lc, *l_plan, 0, t_min, want_work=True, **r_kw), 3)
    log(f"render kernel with the LUT at the coherent plan ({l_plan[0].shape[0]} lanes, "
        f"{RTW_SPP} spp): {l_kernel_ms:.3f} ms; bounce kernel with the atlas: {k2_ms:.3f} ms "
        f"({card})")
    l_launch_mib = launch_mib(torch, rtw_lut, l_renderer,
                              "rtw_final LUT main path's render kernel")
    # Does the LUT, which fits the 50 MB L2, make the image path cheaper
    # than the atlas, which does not?  One best-of-3 pair is within the
    # run-to-run spread, so time both kernels on the same lanes in
    # alternating pairs.
    time_k1 = lambda: cuda_time_ms(
        lambda: fused.render_fused(lc, *l_plan, 0, t_min, **r_kw))[0]
    time_k2 = lambda: cuda_time_ms(
        lambda: tb.bounce_regen(rtw.compiled, st0, r_plan[0], r_plan[1], r_plan[3], 0, t_min,
                                **r_kw))[0]
    lut_same_lanes = all(torch.equal(a, b) for a, b in zip(l_plan, r_plan))
    lut_pairs = []
    for i in range(LUT_PAIRS):
        if i % 2:
            t2 = time_k2()
            lut_pairs.append((time_k1(), t2))
        else:
            lut_pairs.append((time_k1(), time_k2()))
    lut_wins = sum(t1 < t2 for t1, t2 in lut_pairs)
    lut_med = [sorted(ts)[LUT_PAIRS // 2] for ts in zip(*lut_pairs)]
    log(f"render kernel with the LUT vs bounce kernel with the atlas, same lanes, {LUT_PAIRS} "
        f"alternating pairs (same lanes: {lut_same_lanes}): LUT faster in {lut_wins}; medians {lut_med[0]:.3f} vs "
        f"{lut_med[1]:.3f} ms; pairs {[(round(a, 3), round(b, 3)) for a, b in lut_pairs]} "
        f"({card})")
    # half phase 11's slice: the LUT render equals the atlas render already
    l_slice, l_counts = plan_parity(zt, fused, integrator, rtw_lut, l_plan, RTW_SPP, card,
                                    "LUT coherent-plan", depth=RTW_DEPTH,
                                    lanes=SLICE_LANES // 2, window=PLAN_WINDOW)
    lut_checks.append(l_slice)
    k1_lut_bound = render_bound(zt, rtw_lut, l_counts, l_work.sum().item(),
                                l_plan[0].shape[0] * (16 + 16), False, RTW_SPP)
    lut_gates = region_gates(zt, np, rtw_lut, "rtw_final", grid64=4)
    s_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    _, s_times, s_fb = timed_renders(s_renderer, luts[f"rtw_final {LUT_32K}"], torch, W, H)
    s_mpaths = W * H * RTW_SPP / min(s_times) / 1e6
    s_diff = (s_fb - l_fb).abs().mean().item()
    log(f"rtw_final LUT {LUT_32K} texels: best {min(s_times):.4f} s = {s_mpaths:.2f} Mpaths/s; "
        f"mean |diff| to the native-budget render {s_diff:.4e} (not gated; {card})")

    # ---- 15. emissive ----
    phase("15")
    emissive = zt.models.load_scene("emissive", device="cuda")
    e_plains = []
    checks.append(render_parity(zt, fused, integrator, torch, emissive, "emissive 32x32 spp8 d10",
                                plains=e_plains))
    e_renderer = zt.render.Renderer(samples_per_pixel=EMISSIVE_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    e_warm_s, e_times, e_fb = timed_renders(e_renderer, emissive, torch, W, H)
    e_k1 = launched(fused.render_fused)
    e_other = (launched(tb.bounce) + launched(tb.bounce_regen) + ch.closest_hit.launches
               + ch.coherent_keys.launches)
    e_plain = plain_calls(integrator, ttrace)
    log(f"emissive main path: warmup {e_warm_s:.3f} s, renders {[round(t, 4) for t in e_times]} "
        f"s; render kernel launches {e_k1}, other kernels {e_other}, plain-version calls "
        f"{e_plain}")
    if e_k1 < 1 or e_other or e_plain:
        raise AssertionError("the emissive main path did not run the render kernel alone")
    if tuple(e_fb.shape) != (H, W, 3) or not bool(torch.isfinite(e_fb).all()):
        raise AssertionError("bad emissive framebuffer")
    e_best = min(e_times)
    e_mpaths = W * H * EMISSIVE_SPP / e_best / 1e6
    log(f"emissive main path best {e_best:.4f} s = {e_mpaths:.2f} Mpaths/s "
        f"(emissive {W}x{H}@{EMISSIVE_SPP} spp d{DEPTH}; {card})")
    emissive_gates = region_gates(zt, np, emissive, "emissive")
    e_plan = plan_of(e_renderer, emissive.compiled)
    e_kw = dict(camera_consts=camera_consts(emissive.camera, W, H), sampler=e_renderer.sampler,
                width=W, height=H, spp=EMISSIVE_SPP, stride=1, max_depth=DEPTH, has_dof=False)
    e_kernel_ms, (_, e_work) = cuda_time_ms(
        lambda: fused.render_fused(emissive.compiled, *e_plan, 0, t_min, want_work=True, **e_kw), 3)
    log(f"render kernel at emissive's sorted plan ({e_plan[0].shape[0]} lanes, {EMISSIVE_SPP} "
        f"spp): {e_kernel_ms:.3f} ms ({card})")
    # its bound from the 32x32 parity run's plain work counts, scaled
    e_bound = render_bound(zt, emissive, e_plains[0][1], e_work.sum().item(),
                           e_plan[0].shape[0] * (16 + 16), False, EMISSIVE_SPP)

    # ---- 16. the CLI ----
    phase("16")
    cli_checks = phase_cli(zt, torch)

    # ---- 17. the tree walks against their plain versions ----
    phase("17")
    wsc = walk_scenes(zt, rtw, rtw_lut, balls)
    wpar = phase_walk_parity(zt, fused, tb, integrator, torch, wsc)

    # ---- 18. the walks on the slice's path at full width, cut spp ----
    phase("18")
    wr = lambda scene, spp, depth, walk, ref=None: walk_render(
        zt, fused, integrator, ch, ttrace, tb, torch, scene, spp, depth, walk, card, ref)
    paths, renderers = {}, {}
    b_default, b2_fb, renderers[("K1", DEFAULT_WALK)] = wr(wsc["balls2"], WALK18_BALLS_SPP,
                                                            DEPTH, DEFAULT_WALK)
    r18_default, r18_fb, renderers[("K2", DEFAULT_WALK)] = wr(wsc["rtw"], WALK18_RTW_SPP,
                                                               RTW_DEPTH, DEFAULT_WALK)
    # the default walk's bounds at these plans, from the cond walk's plain
    # counts on the same trees (its own counts give the diagnostic beside)
    for rec, kernel, case, scene, spp in (
            (b_default, "K1", "K1 balls", wsc["balls2"], WALK18_BALLS_SPP),
            (r18_default, "K2", "K2 regen", wsc["rtw"], WALK18_RTW_SPP)):
        at = lambda counts: render_bound(
            zt, scene, counts, rec["work"], walk_lane_bytes(kernel, False, rec["lanes"]),
            scene.camera.has_depth_of_field, spp, walk=DEFAULT_WALK)
        rec.update(at(walk_bound_counts(wpar, DEFAULT_WALK, DEFAULT_WALK, case)))
        rec["own_work_bound_ms"] = at(wpar[DEFAULT_WALK][case][1])["bound_ms"]
        log(f"{kernel} {DEFAULT_WALK} walk, {scene.name} span 2 ({card}): kernel at the plan "
            f"{rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, the cond "
            f"walk's counts): {rec['bound_ms'] / rec['ms']:.1%}; diagnostic only, its own "
            f"counts would give {rec['own_work_bound_ms']:.3f} ms")
    l18_default, l18_fb, _ = wr(wsc["rtw_lut"], WALK18_RTW_SPP, RTW_DEPTH, DEFAULT_WALK)
    for walk in OTHER_WALKS[:-1]:
        paths[("K1", walk)], _, renderers[("K1", walk)] = wr(
            wsc["balls2"], WALK18_BALLS_SPP, DEPTH, walk, b2_fb)
        paths[("K2", walk)], _, renderers[("K2", walk)] = wr(
            wsc["rtw"], WALK18_RTW_SPP, RTW_DEPTH, walk, r18_fb)
    paths[("K2", "uni")], uni_fb, renderers[("K2", "uni")] = wr(
        wsc["rtw_uni"], WALK18_RTW_SPP, RTW_DEPTH, "uni", r18_fb)
    paths[("K1", "uni")], _, renderers[("K1", "uni")] = wr(
        wsc["rtw_uni_lut"], WALK18_RTW_SPP, RTW_DEPTH, "uni", l18_fb)
    uni_gates = region_gates(zt, np, wsc["rtw_uni"], "rtw_final", grid64=4)
    # the port's span: the default walk's renders and the unified tree's
    port_default, port_fb, renderers[("K2", "queue port")] = wr(
        wsc["rtw_port"], WALK18_RTW_SPP, RTW_DEPTH, DEFAULT_WALK)
    paths[("K2", "rowqueue port")], _, renderers[("K2", "rowqueue port")] = wr(
        wsc["rtw_port"], WALK18_RTW_SPP, RTW_DEPTH, "rowqueue", port_fb)
    port_lut_default, port_lut_fb, renderers[("K1", "queue port")] = wr(
        wsc["rtw_lut_port"], WALK18_RTW_SPP, RTW_DEPTH, DEFAULT_WALK)
    balls_port_default, _, _ = wr(
        wsc["balls_port"], WALK18_BALLS_SPP, DEPTH, DEFAULT_WALK)
    paths[("K2", "uni port")], _, renderers[("K2", "uni port")] = wr(
        wsc["rtw_uni_port"], WALK18_RTW_SPP, RTW_DEPTH, "uni", port_fb)
    paths[("K1", "uni port")], _, renderers[("K1", "uni port")] = wr(
        wsc["rtw_uni_lut_port"], WALK18_RTW_SPP, RTW_DEPTH, "uni", port_lut_fb)
    log("walks at full width, span 2, balls at " + str(WALK18_BALLS_SPP) + " spp, rtw_final at "
        + str(WALK18_RTW_SPP) + " spp (Mpaths/s; " + card + "): " + ", ".join(
            f"{k} {w} {v['mpaths_per_s']:.2f}" for (k, w), v in paths.items())
        + f"; default walk: balls {b_default['mpaths_per_s']:.2f}, rtw_final (K2) "
        f"{r18_default['mpaths_per_s']:.2f}, rtw_final LUT (K1) {l18_default['mpaths_per_s']:.2f}"
        f"; at the port's span rtw_final (K2) {port_default['mpaths_per_s']:.2f}, LUT (K1) "
        f"{port_lut_default['mpaths_per_s']:.2f}, balls {balls_port_default['mpaths_per_s']:.2f}")
    against_default = walks_against_default(torch, wsc, renderers)
    treeless = treeless_occupancy(zt, fused, (
        ("cornell", cornell, renderer, SPP), ("emissive", emissive, e_renderer, EMISSIVE_SPP)),
        resources)

    # ---- 19. the three samplers and nine lights ----
    phase("19")
    sampler_checks = phase_samplers(zt, fused, tb, integrator, torch)

    # ---- 20. the phase profile of the kernels the renders launch ----
    phase("20")
    fused.render_fused_profile.launches = dict.fromkeys(fused.render_fused_profile.launches, 0)
    tb.bounce_regen_profile.launches = dict.fromkeys(tb.bounce_regen_profile.launches, 0)
    profiles = phase_profile(zt, fused, tb, integrator, torch, (
        ("cornell north star", cornell, SPP, DEPTH),
        ("cornell ref_10k50", cornell, REF_SPP, REF_DEPTH),
        ("balls canonical", balls, BALLS_SPP, DEPTH),
        ("rtw_final K2", rtw, RTW_SPP, RTW_DEPTH),
        ("rtw_final LUT K1", rtw_lut, RTW_SPP, RTW_DEPTH),
        ("emissive", emissive, EMISSIVE_SPP, DEPTH),
    ), card)
    profile_launches = {"render_fused_profile": dict(fused.render_fused_profile.launches),
                        "bounce_regen_profile": dict(tb.bounce_regen_profile.launches)}
    log(f"phase profiles launched (apart from every path): {profile_launches}")

    # ---- 21. leaf span x walk sweep ----
    phase("21")
    sweep = phase_sweep(zt, card)

    # ---- 22. the closest-hit kernel's ray sets and the AOV pass ----
    phase("22")
    reset_counts(fused, integrator, ch, ttrace, tb)
    hits22 = phase_hit_sets(zt, ch, ttrace, torch, card,
                              {"cornell_box": cornell, "balls": balls, "rtw_final": rtw}, fb)
    aov_launches = {f"aov {k}": v["launches"] for k, v in hits22["aov_pass"].items()}

    # ---- 23. the estimator instantiations against their plain versions ----
    phase("23")
    reset_counts(fused, integrator, ch, ttrace, tb)
    scenes23 = {"cornell": cornell, "balls": balls, "rtw": rtw, "rtw_lut": rtw_lut}
    est = phase_estimator(zt, fused, tb, integrator, torch, scenes23, card)

    # ---- 24. the drivers at the main path's configuration ----
    phase("24")
    drivers = phase_drivers(zt, fused, tb, integrator, ch, ttrace, torch, scenes23, fb, card)
    rr_renderer = drivers.pop("rr_renderer")
    est_times = est_kernel_times(zt, fused, torch, rr_renderer, cornell, card)
    est_plain, est_counts = est["plain"]
    est_bound = render_bound(zt, cornell, est_counts, est_times["work"],
                             est_times["lanes"] * (16 + 16), False, SPP)
    est_render = [c for c in est["checks"] if c["check"].endswith(("rr3", "clamp10"))]
    est_cornell = next(c for c in est_render if c["check"].startswith("cornell 32x32 spp8 d10 rr3"))
    est_one = est["one_bounce"]
    est_launches = drivers["russian_roulette"]["k1_estimator"]

    # ---- 25. the sharded paths ----
    phase("25")
    sharded = phase_sharded(zt, fused, tb, integrator, ch, ttrace, torch,
                            {"cornell": cornell, "balls": balls, "rtw": rtw}, (fb, b_fb, r_fb),
                            mpaths, card)
    checks += sharded["parity"]
    sh_launches = sharded["launches"]

    # ---- 26. the fixed-depth path ----
    phase("26")
    fixed = phase_fixed_depth(zt, fused, tb, integrator, ch, ttrace, torch, cornell, fb, card)

    # ---- 27. the user tools ----
    phase("27")
    tools = phase_tools(zt, fused, tb, integrator, ch, ttrace, torch, (fb, b_fb, r_fb),
                        {"cornell": mpaths, "balls": b_mpaths, "rtw_final": r_mpaths,
                         "lut_32k_mean_abs_diff": s_diff}, card)
    tl = tools["launches"]

    # ---- 28. the north-star harness ----
    phase("28")
    harness = phase_harness(card, mpaths, kernel_ms, k1_bound["bound_ms"])

    b_hit = hit_checks[1]
    k2_first = k2_one[0]
    k2_lut_first = k2_lut[0]
    bound_of = lambda c: {k: c[k] for k in ("bound_ms", "bound_by", "peak_source")}

    def entry(name, source, replaces, res, launches, by_path, parity, ms, plain_ms, bound,
              tolerance, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in parity),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            **{k: v for k, v in bound.items() if k not in ("bound_ms", "bound_by")},
            "library_ms": None, "library_note": LIBRARY_NOTE,
            "registers": resources[res]["registers"],
            "spill_bytes": resources[res]["spill_bytes"],
            "parity": parity, "tolerance": tolerance, "card": card, **extra,
        }

    render_tol = "rtol 1e-4, atol 1e-5 on >= 99% of lanes; mean 1e-4 rel"
    bounce_tol = "alive equal and state rtol 1e-5, atol 1e-6 on >= 99.9% of lanes"

    def walk_entry(kernel, walk):
        """The record of one walk's instantiation on its phase 18 path; its
        bound from phase 17's plain work counts of the cond walk on the same
        tree (32x32; walk_bound_counts) scaled to the kernel's bounces at
        the plan, the walk's own counts' bound beside it."""
        path = paths[(kernel, walk)]
        checks = wpar[walk]
        if kernel == "K1":
            case = "K1 LUT" if walk == "uni" else "K1 balls"
            scene = wsc["rtw_uni_lut"] if walk == "uni" else wsc["balls2"]
            name = f"fused_render_kernel ({walk} walk" + (", texture LUT)" if walk == "uni" else ")")
            res = f"fused_render_kernel<{'true' if walk == 'uni' else 'false'}, {walk}>"
            parity = [checks[case][0]]
            src, by_path = KERNEL_SOURCE, {scene.name + (" uni LUT" if walk == "uni" else
                                                         " span 2"): path["launches"]}
        else:
            case = "K2 regen"
            scene = wsc["rtw_uni"] if walk == "uni" else wsc["rtw"]
            name = f"bounce_kernel ({walk} walk, regenerating)"
            res = f"bounce_kernel<true, {walk}>"
            parity = [checks[c][0] for c in ("K2 regen", "K2 one bounce",
                                             "K2 one bounce, half dead")]
            src, by_path = BOUNCE_SOURCE, {"rtw_final" + (" uni" if walk == "uni" else ""):
                                           path["launches"]}
        lane_bytes = walk_lane_bytes(kernel, walk == "uni", path["lanes"])
        bound_at = lambda counts: render_bound(zt, scene, counts, path["work"], lane_bytes,
                                               scene.camera.has_depth_of_field, path["spp"],
                                               walk=walk)
        bound = bound_at(walk_bound_counts(wpar, walk, walk, case))
        launches = path["launches"]
        extra = {"own_work_bound_ms": bound["bound_ms"] if walk == "cond"
                 else bound_at(checks[case][1])["bound_ms"]}
        against = [c for c, (k, key, *_) in zip(against_default, AGAINST_DEFAULT)
                   if k == kernel and key.split()[0] == walk]

        def port_span(pcase, pscene):
            """The walk's path at the port's span, priced as phase 17's
            counts there say (walk_bound_counts)."""
            port = paths[(kernel, f"{walk} port")]
            pbound = render_bound(zt, pscene, walk_bound_counts(wpar, walk, pcase, case),
                                  port["work"], walk_lane_bytes(kernel, walk == "uni",
                                                                port["lanes"]),
                                  pscene.camera.has_depth_of_field, port["spp"], walk=walk)
            return {**{k: port[k] for k in ("ms", "mpaths_per_s", "render_s_best",
                                             "blocks_per_sm", "smem_bytes")}, **pbound}

        if walk == "rowqueue":
            rq = wpar["rowqueue port span"]
            parity = parity + [rq["K2 regen" if kernel == "K2" else "K1 LUT"][0]]
            if kernel == "K2":
                port = paths[(kernel, "rowqueue port")]
                by_path["rtw_final, port's span"] = port["launches"]
                launches += port["launches"]
                extra["port_span"] = port_span("rowqueue port span", wsc["rtw_port"])
        if walk == "uni":
            port = paths[(kernel, "uni port")]
            by_path[f"{scene.name} uni, port's span"] = port["launches"]
            launches += port["launches"]
            extra["port_span"] = port_span(
                "uni port span", wsc["rtw_uni_lut_port" if kernel == "K1" else "rtw_uni_port"])
            parity = parity + [wpar["uni port span"][case][0]] + [
                wpar["uni cond"][k][case][0] for k in ("uni", "uni port span")]
        return entry(name, src, WALK_REPLACES[walk], res, launches, by_path, parity,
                     path["ms"], parity[0]["plain_ms"], bound, render_tol,
                     plain_lanes=32 * 32, render_s_best=path["render_s_best"],
                     mpaths_per_s=path["mpaths_per_s"],
                     default_agree=path.get("default_agree"), against_default=against,
                     blocks_per_sm=path["blocks_per_sm"], smem_bytes=path["smem_bytes"],
                     plain_vs_cond_plain=[c for c in wpar["plain"]
                                         if c["check"].startswith(f"plain {walk} walk")],
                     **extra,
                     **({"region_gates": uni_gates} if (kernel, walk) == ("K2", "uni") else {}))

    record = {"kernels": [
        entry("fused_render_kernel (brute)", KERNEL_SOURCE, KERNEL_REPLACES,
              "fused_render_kernel<false, no tree>",
              launches + e_k1 + sum(sh_launches["K1 brute"].values())
              + sum(tl["K1 brute"].values()),
              {"cornell": launches, "emissive": e_k1, **sh_launches["K1 brute"],
               **tl["K1 brute"]}, checks,
              kernel_ms, plain_ms, k1_bound,
              render_tol, plain_spp=plain_spp, kernel_ms_at_plain_spp=kernel_ms_same,
              render_s_best=best, mpaths_per_s=mpaths, region_gate=verdict,
              emissive_render_s_best=e_best, emissive_mpaths_per_s=e_mpaths,
              emissive_region_gates=emissive_gates, emissive_ms=e_kernel_ms,
              emissive_bound_ms=e_bound["bound_ms"], emissive_bound_by=e_bound["bound_by"],
              occupancy=treeless),
        entry("fused_render_kernel (tree)", KERNEL_SOURCE, KERNEL_REPLACES,
              f"fused_render_kernel<false, {DEFAULT_WALK}>",
              b_launches + sum(sh_launches["K1 tree"].values()) + sum(tl["K1 tree"].values()),
              {"balls": b_launches, **sh_launches["K1 tree"], **tl["K1 tree"]}, tree_checks,
              b_kernel_ms, b_slice["plain_ms"], k1_tree_bound, render_tol,
              plain_lanes=SLICE_LANES, kernel_ms_at_plain_lanes=b_slice["ms"],
              queue_walk_span2=b_default, queue_walk_balls_port_span=balls_port_default,
              balls_render_s_best=b_best, balls_mpaths_per_s=b_mpaths,
              balls_region_gates=balls_gates),
        entry("fused_render_kernel (texture LUT)", KERNEL_SOURCE, KERNEL_LUT_REPLACES,
              f"fused_render_kernel<true, {DEFAULT_WALK}>", l_k1 + sum(tl["K1 LUT"].values()),
              {"rtw_final LUT": l_k1, **tl["K1 LUT"]}, lut_checks,
              l_kernel_ms, l_slice["plain_ms"], k1_lut_bound, render_tol,
              plain_lanes=SLICE_LANES // 2, kernel_ms_at_plain_lanes=l_slice["ms"],
              rtw_final_render_s_best=l_best, rtw_final_mpaths_per_s=l_mpaths,
              rtw_final_peak_mib=l_peak_mb, rtw_final_launch_mib=l_launch_mib,
              atlas_render_agree=l_close,
              atlas_render_max_abs_diff=l_vs_atlas, region_gates=lut_gates,
              lut_32k_mpaths_per_s=s_mpaths, lut_32k_mean_abs_diff=s_diff,
              lut_vs_atlas_pairs_ms=lut_pairs, lut_vs_atlas_same_lanes=lut_same_lanes,
              queue_walk_span2=l18_default, queue_walk_port_span=port_lut_default),
        entry("bounce_kernel (one bounce)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              f"bounce_kernel<false, {DEFAULT_WALK}>",
              0, {}, k2_one, k2_first["ms"], k2_first["plain_ms"], bound_of(k2_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode; times and bound "
                   "are rtw_final's first bounce at 160,000 lanes"),
        entry("bounce_kernel (one bounce, texture LUT)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              f"bounce_kernel<false, {DEFAULT_WALK}>", 0, {}, k2_lut, k2_lut_first["ms"],
              k2_lut_first["plain_ms"], bound_of(k2_lut_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode"),
        entry("bounce_kernel (regenerating)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              f"bounce_kernel<true, {DEFAULT_WALK}>",
              r_k2 + sum(sh_launches["K2 regen"].values()) + sum(tl["K2 regen"].values()),
              {"rtw_final": r_k2, **sh_launches["K2 regen"], **tl["K2 regen"]}, k2_checks, k2_ms,
              k2_slice["plain_ms"], k2_bound, render_tol, plain_lanes=SLICE_LANES,
              kernel_ms_at_plain_lanes=k2_slice["ms"], queue_walk_span2=r18_default,
              queue_walk_port_span=port_default,
              driver_passes_per_band=passes / max(bands, 1), rtw_final_render_s_best=r_best,
              rtw_final_mpaths_per_s=r_mpaths, rtw_final_peak_mib=peak_mb,
              rtw_final_launch_mib=r_launch_mib,
              region_gates=image_gates),
        entry("closest_hit_kernel", HIT_SOURCE, HIT_REPLACES, "closest_hit_kernel",
              b_hit_launches + r_hit + l_hit + sum(aov_launches.values())
              + fixed["main"]["launches"] + sum(tl["K3"].values()),
              {"balls": b_hit_launches, "rtw_final": r_hit, "rtw_final LUT": l_hit,
               **aov_launches, "fixed-depth nested 400x400@64": fixed["main"]["launches"],
               **tl["K3"]},
              hit_checks + hits22["checks"] + fixed["parity"],
              b_hit["ms"], b_hit["plain_ms"], bound_of(b_hit),
              "(kind, idx) and t bitwise equal on every ray; the AOV buffers bitwise",
              wrapper_ms=b_hit["wrapper_ms"], ray_sets=hits22["sets"],
              aov_pass=hits22["aov_pass"], denoise=hits22["denoise"],
              denoise_400_ms=hits22["denoise_400_ms"], cli_aov=hits22["cli"],
              fixed_depth={k: v for k, v in fixed.items() if k != "parity"},
              note="ms: the kernel alone on the balls probe's 160,000 rays (phase 5); every "
                   "ray set's kernel alone and wrapper in ray_sets"),
        {**entry("coherent_keys_kernel", HIT_SOURCE, KEYS_REPLACES, "coherent_keys_kernel",
                 b_keys + r_keys + l_keys + sum(tl["K3 keys"].values()),
                 {"balls": b_keys, "rtw_final": r_keys, "rtw_final LUT": l_keys,
                  **tl["K3 keys"]},
                 [b_keys_check, r_keys_check], b_keys_check["ms"], b_keys_check["plain_ms"],
                 bound_of(b_keys_check),
                 f"lane words bitwise; first-hit keys differ on <= {KEYS_DIFFER:.1%} of pixels",
                 wrapper_ms=b_keys_check["wrapper_ms"],
                 note="ms: the kernel alone on balls' 160,000 pixels (phase 7); plain_ms: the "
                      "plain probe (torch camera rays, the cond walk) on the same pixels"),
         "max_abs_err": None},
        entry("fused_render_kernel (estimator: Russian roulette, indirect clamp)",
              EST_SOURCE, KERNEL_REPLACES, "fused_render_kernel<false, no tree, estimator>",
              est_launches + sum(tl["K1 estimator"].values()),
              {"cornell russian_roulette=3": est_launches, **tl["K1 estimator"]}, est_render,
              est_times["ms"], est_cornell["plain_ms"], est_bound, render_tol,
              plain_lanes=32 * 32, default_kernel_ms_same_lanes=est_times["default_ms"],
              pairs_ms=est_times["pairs_ms"], sobol_past_spp=est["checks"][-1],
              atlas_gate=est["checks"][-2], drivers=drivers,
              note="ms: the estimator instantiation (rr3) at the rr3 render's sorted plan, "
                   "cornell 400x400@1024 d10; plain_ms: cornell rr3 at 32x32, 8 spp"),
        entry("bounce_kernel (one bounce, estimator)", EST_BOUNCE_SOURCE, BOUNCE_REPLACES,
              "bounce_kernel<false, no tree, estimator>", 0, {}, est_one,
              est_one[0]["ms"], est_one[0]["plain_ms"], bound_of(est_one[0]), bounce_tol,
              note="parity only: no main path runs the bounce kernel with the estimator "
                   "options (atlas scenes gate them off); cornell camera rays, rr3+clamp10"),
        *(walk_entry(kernel, walk) for kernel in ("K1", "K2") for walk in OTHER_WALKS),
        {"name": "chain_kernel (fp32 peak)", "route": "cuda", "source": PEAK_SOURCE,
         "replaces": PEAK_REPLACES, "launches": peak["launches"],
         "launches_by_path": {"fp32 peak sweep": peak["launches"]},
         "max_abs_err": max(c["max_abs_err"] for c in peak["parity"]), "ms": peak["ms"],
         "plain_ms": peak["plain_ms"], "bound_ms": peak["bound_ms"],
         "bound_by": peak["bound_by"], "peak_source": peak["peak_source"], "library_ms": None,
         "library_note": "none: no single PyTorch call runs a register-resident operation chain",
         "registers": resources[peak["instantiation"]]["registers"],
         "spill_bytes": resources[peak["instantiation"]]["spill_bytes"],
         "parity": peak["parity"], "tolerance": f"rtol {CHAIN_RTOL}", "card": card,
         "note": f"ms: {peak['instantiation']} at the best add shape of the sweep; "
                 f"plain_ms at that shape with {CHAIN_STEPS} steps (iters x unroll), "
                 f"where the kernel took {peak['kernel_ms_at_plain_shape']:.4f} ms",
         **{k: peak[k] for k in ("gops", "gflops", "best_shape", "physics_bound",
                                 "time_ratio_4x", "sass")}},
    ], "cli": cli_checks, "sharded": sharded, "tools": tools, "ops_rates": OPS_RATE["rate"],
        "samplers": sampler_checks, "profiles": profiles, "profile_launches": profile_launches,
        "sweep": sweep, "resources": resources, "harness": harness}
    log(f"script: {time.perf_counter() - START:.1f} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
