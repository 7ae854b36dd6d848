"""The bounce kernel of image-texture scenes (counterpart of
``ops/pallas_bounce.py``: ``bounce_pallas``, ``bounce_pallas_regen``,
``supports_bounce_kernel`` and ``supports_fused_render``, over
``_bounce_kernel``).

``bounce`` runs one bounce of a wavefront and ``bounce_regen`` drains each
lane's sample window from a ``RegenState``.  For CUDA tensors both launch
``bounce_kernel`` (``csrc/bounce.cu`` over ``csrc/zwrt_device.cuh``), which
reads the texel at the hit, from the texture LUT when the scene has one
and from the atlas otherwise; for CPU tensors they run its plain PyTorch
versions, ``render/integrator.py:bounce`` and ``bounce_regen_reference``.
Any other device raises.  ``bounce.launches`` and ``bounce_regen.launches``
count kernel launches per tree walk ({walk: launches}; the walk is read at
each launch, as ``ops/fused_render.py:walk_args`` says), and their
``estimator_launches`` those that took the estimator instantiation.

Both modes take Russian roulette and the indirect clamp (``rr_start``,
``clamp``) through the kernel's estimator instantiation, after the gate of
``render/integrator.py:estimator_options``: on an atlas scene (image
textures, no LUT) both are off, as in the JAX kernel.  A regenerating
launch's Sobol tables cover its sample indices below the largest
``sample_limit``.

While ``utils/profiler.py`` records, ``bounce_regen`` counts each
regenerating launch (``k2.launches``) and, on the lanes' work counts over
the launch (the final state's ``work`` less the state it was given),
``k2.lane_work`` and ``k2.warp_work`` (``ops/fused_render.py:lane_sums``);
on the card it asks the launch for its blocks' stamps (the launcher's
``out_blocks``, as K1's) and counts ``k2.block_ns`` and ``k2.slot_ns``
(``block_sums``, over the block slots of the instantiation's blocks per
SM, which ``bounce_regen_occupancy`` reports).  Its read of the window
ends (``launch_sample_end``), where the host waits for the card, is the
span ``render.regen.launch.wait``, read on either device so that the span
lies where the card's launch reads it.  Nothing waits for the card until
the profiler's ``snapshot`` reads the counters, and recording changes no
output.

``bounce_regen_variant`` launches the regenerating mode's measurement
variants (the phase profile, the earlier Sobol bit-loop respawn, the first
designs of the queue, rowqueue, spec and uni walks), counted apart in
``bounce_regen_variant.launches``; no path of the renderer runs them.
``bounce_regen_occupancy`` launches nothing: it reports the blocks per SM
and the shared memory of the instantiation a launch would take.

Image-textured emitters take the kernel with or without a LUT, since the
texel is read at the hit, before emission (the JAX kernel needs the LUT
for them).  Nested checkers take neither this kernel nor the whole-render
kernel, as in the JAX package: their colours do not fit one shade record,
so the renderer takes the fixed-depth wavefront
(``render/integrator.py:trace_paths``) for them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..dtypes import real
from ..math.v3 import V3
from ..render import integrator
from ..render.integrator import RegenState
from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..scene import CompiledScene
from ..utils import profiler
from . import _build
from .fused_render import (
    BLOCK_STAMP_COLS, FIRST_DESIGN_WALKS, FLAG_FIRST_WALK, FLAG_LOOP_SOBOL, FLAG_PROF, PROF_COLS,
    THREADS, VARIANT_WALKS, block_sums, check_flags, check_lane_tensor, estimator_flags,
    image_args, lane_sums, launch_params, launch_sample_end, launch_tables, node_args,
    sobol_smem_bytes, sobol_table, trace_args, walk_args,
)
from .trace import WALKS


def supports_bounce_kernel(scene: CompiledScene) -> bool:
    """True unless the scene has nested checkers, which do not fit one
    shade record (pallas_bounce.py:1626-1635).  Image emitters read their
    texel at the hit, LUT or not, where JAX's gate lifts only with a LUT."""
    return not scene.has_nested_checker


def supports_fused_render(scene: CompiledScene) -> bool:
    """The whole-render kernel reads images only from a texture LUT: scenes
    without images, or with a LUT (pallas_bounce.py:1638-1644), and without
    nested checkers; other image scenes take the bounce kernel's
    regenerating mode."""
    return supports_bounce_kernel(scene) and (
        not scene.has_image_textures or bool(scene.tex_lut_dims))


def _launch(scene, params, fstate, istate, lanes, regen, depth, flags=0, occupancy=None,
            out_blocks=None):
    """One launch of the bounce kernel; returns the tree walk it took, the
    phase profile (None without FLAG_PROF) and, with ``out_blocks``, the
    card's block slots for the instantiation (its blocks per SM times the
    SMs; else None).  ``params`` is (ints, floats, (sampler, width, height,
    sample_end)); with ``occupancy`` (a host int32 array of 2) nothing is
    launched, and the launcher writes the instantiation's blocks per SM and
    shared memory there.  ``out_blocks``, a zeroed int64 tensor of (blocks,
    ``BLOCK_STAMP_COLS``) on the card, takes each block's stamps."""
    device = fstate.device
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, lanes on {device}")
    if not supports_bounce_kernel(scene):
        raise NotImplementedError(
            "bounce_kernel does not take nested checkers: the renderer sends them "
            "to the fixed-depth wavefront (render/integrator.py:trace_paths)"
        )
    n = fstate.shape[1]
    if out_blocks is not None:
        check_lane_tensor("out_blocks", out_blocks.view(-1), device,
                          -(-n // THREADS) * BLOCK_STAMP_COLS, torch.int64)
    lib = _build.load_library()
    ints, floats, (sampler, width, height, sample_end) = params
    tables, _keep = launch_tables(scene, sampler, width, height, sample_end)
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    dims, texels = image_args(scene)
    shade_rows = scene.shade_rows.contiguous()
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    px, py, limit = (None, None, None) if lanes is None else (t.data_ptr() for t in lanes)
    smem = sobol_smem_bytes(sampler, sample_end) if regen and not flags & FLAG_LOOP_SOBOL else 0
    walk, code, cap, queue = walk_args(scene, n, smem, first=bool(flags & FLAG_FIRST_WALK))
    check_flags(walk, flags)
    nodes, _nodes = node_args(scene, walk)
    prof = (torch.empty((PROF_COLS, n), dtype=torch.int64, device=device)
            if flags & FLAG_PROF else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    host = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    def call(occ):
        err = lib.zwrt_bounce(
            host(ints), host(floats), host(tables), host(trace_ints), host(trace_ptrs),
            host(nodes), dims.shape[0], dims.data_ptr(), texels.data_ptr(),
            shade_rows.data_ptr(), sobol.data_ptr(), fstate.data_ptr(), istate.data_ptr(), px,
            py, limit, ptr(prof), ptr(out_blocks), int(regen), int(depth), code, flags, cap,
            ptr(queue), 0 if queue is None else queue.numel(), n, host(occ),
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"bounce_kernel ({walk} walk, flags {flags}) launch failed: "
                               f"cudaError {err}")

    slots = None
    if out_blocks is not None:
        # the launch's block slots: the same call asked for its occupancy
        occ = np.zeros(2, np.int32)
        call(occ)
        slots = int(occ[0]) * torch.cuda.get_device_properties(device).multi_processor_count
    call(occupancy)
    return walk, prof, slots


def _pack(origin, direction, throughput, radiance, time, ints, device, n):
    """(13, N) float32 and (k, N) int32 state tensors, fresh copies that
    the kernel updates in place."""
    floats = (*origin, *direction, *throughput, *radiance, time)
    for i, t in enumerate(floats):
        check_lane_tensor(f"float state row {i}", t, device, n, real)
    fstate = torch.stack(floats).contiguous()
    istate = torch.stack([t.to(torch.int32) for t in ints]).contiguous()
    return fstate, istate


def _u32_bits(ray_id):
    """u32 ray ids (int64) as int32 bit patterns and back."""
    return torch.where(ray_id >= 2**31, ray_id - 2**32, ray_id)


def bounce(
    scene: CompiledScene, seed, t_min: float, depth: int,
    origin: V3, direction: V3, time, ray_id, throughput: V3, radiance: V3,
    alive, rr_start: int = 0, clamp: float = 0.0,
):
    """One bounce of every lane at bounce index ``depth``: trace, shade,
    texture and scatter (one-bounce mode, the counterpart of
    ``bounce_pallas`` with its atlas multiply, or with its in-kernel LUT
    fetch when the scene has a texture LUT), with Russian roulette from
    bounce ``rr_start`` and the indirect ``clamp`` (0: off).  ``ray_id`` is
    (N,) int64 holding u32 values, ``alive`` (N,) bool.  Returns (origin',
    direction', throughput', radiance', alive')."""
    device = origin.x.device
    n = origin.shape[0]
    if device.type == "cpu":
        d = torch.full((n,), int(depth), dtype=torch.int64, device=device)
        return integrator.bounce(
            scene, seed, t_min, d, origin, direction, time, ray_id,
            throughput, radiance, alive, rr_start, clamp,
        )
    if device.type != "cuda":
        raise ValueError(f"bounce runs on cuda or cpu tensors, not {device}")
    check_lane_tensor("ray_id", ray_id, device, n, torch.int64)
    check_lane_tensor("alive", alive, device, n, torch.bool)
    fstate, istate = _pack(
        origin, direction, throughput, radiance, time,
        (_u32_bits(ray_id), alive), device, n,
    )
    flags, rr_start, clamp = estimator_flags(scene, rr_start, clamp)
    ints, floats = launch_params(
        scene, seed, t_min, ((0.0,) * 3,) * 6, SamplerKind.SOBOL, 1, 1, 1,
        1, 1, False, 1, rr_start, clamp,
    )
    walk, _, _ = _launch(scene, (ints, floats, (SamplerKind.SOBOL, 1, 1, 1)), fstate, istate,
                         None, False, depth, flags)
    bounce.launches[walk] += 1
    bounce.estimator_launches += bool(flags)
    f = fstate
    return (
        V3(f[0], f[1], f[2]), V3(f[3], f[4], f[5]), V3(f[6], f[7], f[8]),
        V3(f[9], f[10], f[11]), istate[1] != 0,
    )


bounce.launches = dict.fromkeys(WALKS, 0)
bounce.estimator_launches = 0


def bounce_regen(
    scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
    t_min: float, *, camera_consts, sampler: SamplerKind, width: int,
    height: int, spp: int, stride: int, max_depth: int, has_dof: bool,
    rr_start: int = 0, clamp: float = 0.0,
) -> RegenState:
    """The regenerating mode (counterpart of ``bounce_pallas_regen`` with
    its atlas fold): from ``state``, each lane renders its pixel's samples
    ``state.sample + stride``, ... below ``sample_limit``, respawning the
    next one in-kernel as a path ends, and the final state is returned
    (every lane dead, its window used up).  ``px``, ``py`` and
    ``sample_limit`` are (N,) int32; ``rr_start`` and ``clamp`` as
    ``bounce`` takes them."""
    kw = dict(
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof, rr_start=rr_start, clamp=clamp,
    )
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bounce_regen runs on cuda or cpu tensors, not {px.device}")
    record = profiler.recording()
    with profiler.named_zone("render.regen.launch.wait"):
        sample_end = launch_sample_end(sample_limit)
    if px.device.type == "cpu":
        out = integrator.bounce_regen_reference(
            scene, state, px, py, sample_limit, seed, t_min, **kw
        )
    else:
        stamps = None
        if record and px.shape[0]:
            stamps = torch.zeros((-(-px.shape[0] // THREADS), BLOCK_STAMP_COLS),
                                 dtype=torch.int64, device=px.device)
        flags, kw["rr_start"], kw["clamp"] = estimator_flags(scene, rr_start, clamp)
        out, _, walk, slots = _regen(scene, state, px, py, sample_limit, sample_end, seed, t_min,
                                     flags, out_blocks=stamps, **kw)
        bounce_regen.launches[walk] += 1
        bounce_regen.estimator_launches += bool(flags)
        if stamps is not None:
            block_ns, slot_ns = block_sums(stamps, slots)
            profiler.count("k2.block_ns", block_ns)
            profiler.count("k2.slot_ns", slot_ns)
    if record:
        profiler.count("k2.launches")
        if px.shape[0]:
            lane_work, warp_work = lane_sums(out.work - state.work)
            profiler.count("k2.lane_work", lane_work)
            profiler.count("k2.warp_work", warp_work)
    return out


bounce_regen.launches = dict.fromkeys(WALKS, 0)
bounce_regen.estimator_launches = 0


def bounce_regen_variant(scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
                         t_min: float, *, profile: bool = False, loop_sobol: bool = False,
                         first_walk: bool = False, **kw):
    """``bounce_regen`` through a measurement variant, as
    ``ops/fused_render.py:render_fused_variant`` takes them (``profile`` and
    ``loop_sobol`` for the walks of ``VARIANT_WALKS``, ``first_walk`` for
    those of ``FIRST_DESIGN_WALKS``): returns (final state, profile or
    None).  CPU tensors take the plain
    version and return no profile.  ``bounce_regen_variant.launches``
    counts launches per walk."""
    if px.device.type == "cpu":
        return integrator.bounce_regen_reference(
            scene, state, px, py, sample_limit, seed, t_min, **kw), None
    flags = ((FLAG_PROF if profile else 0) | (FLAG_LOOP_SOBOL if loop_sobol else 0)
             | (FLAG_FIRST_WALK if first_walk else 0))
    if not flags:
        raise ValueError("bounce_regen_variant needs profile, loop_sobol or first_walk; "
                         "bounce_regen launches the default kernel")
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    out, prof, walk, _ = _regen(scene, state, px, py, sample_limit,
                                launch_sample_end(sample_limit), seed, t_min, flags | est, **kw)
    bounce_regen_variant.launches[walk] += 1
    return out, prof


bounce_regen_variant.launches = dict.fromkeys(VARIANT_WALKS + FIRST_DESIGN_WALKS, 0)


def bounce_regen_occupancy(scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
                           t_min: float, *, first_walk: bool = False, **kw):
    """(blocks per SM, dynamic shared memory bytes a block) of the
    regenerating instantiation that ``bounce_regen`` on these CUDA lanes
    would launch, or with ``first_walk`` the walk's first-design variant
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the launcher has
    raised the shared memory of an instantiation that more than
    ``MAX_BLOCKS_PER_SM`` blocks would fit); launches nothing and counts
    nothing."""
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    occ = np.zeros(2, np.int32)
    _regen(scene, state, px, py, sample_limit, launch_sample_end(sample_limit), seed, t_min,
           (FLAG_FIRST_WALK if first_walk else 0) | est, occupancy=occ, **kw)
    return int(occ[0]), int(occ[1])


def _regen(scene, state, px, py, sample_limit, sample_end, seed, t_min, flags, *,
           camera_consts, sampler, width, height, spp, stride, max_depth, has_dof, rr_start=0,
           clamp=0.0, occupancy=None, out_blocks=None):
    """One regenerating launch over the sample indices below ``sample_end``
    (``launch_sample_end`` of ``sample_limit``): (final state, profile or
    None, walk, block slots or None); ``occupancy`` and ``out_blocks`` as
    ``_launch`` takes them."""
    device = px.device
    n = px.shape[0]
    if device.type != "cuda":
        raise ValueError(f"bounce_regen runs on cuda or cpu tensors, not {device}")
    for name, t in (("px", px), ("py", py), ("sample_limit", sample_limit),
                    ("sample", state.sample), ("bounce", state.bounce),
                    ("work", state.work)):
        check_lane_tensor(name, t, device, n)
    check_lane_tensor("ray_id", state.ray_id, device, n, torch.int64)
    check_lane_tensor("alive", state.alive, device, n, torch.bool)
    fstate, istate = _pack(
        state.origin, state.direction, state.throughput, state.radiance,
        state.time,
        (_u32_bits(state.ray_id), state.alive, state.sample, state.bounce, state.work),
        device, n,
    )
    ints, floats = launch_params(
        scene, seed, t_min, camera_consts, sampler, width, height, spp,
        stride, max_depth, has_dof, sample_end, rr_start, clamp,
    )
    walk, prof, slots = _launch(scene, (ints, floats, (sampler, width, height, sample_end)),
                                fstate, istate, (px, py, sample_limit), True, 0, flags,
                                occupancy, out_blocks)
    f, s = fstate, istate
    out = RegenState(
        origin=V3(f[0], f[1], f[2]), direction=V3(f[3], f[4], f[5]),
        time=f[12], ray_id=s[0].to(torch.int64) & 0xFFFFFFFF,
        throughput=V3(f[6], f[7], f[8]), radiance=V3(f[9], f[10], f[11]),
        alive=s[1] != 0, sample=s[2], bounce=s[3], work=s[4],
    )
    return out, prof, walk, slots
