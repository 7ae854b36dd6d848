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

The regenerating mode is persistent and fed from a work queue, as the
render kernel is (``ops/fused_render.py``): its grid is the blocks the
card holds at once, and its threads take (lane, sample chunk) items, each
lane's window from ``state.sample + stride`` below ``sample_limit`` cut
into chunks of ``item_chunk`` samples.  A lane's chunk 0 resumes the
state the lane was given (a live path, its radiance and its work), its
last item leaves the lane's final state, and each lane's radiance and work
add its items' in chunk order, as ``render/integrator.py:
bounce_regen_items_reference`` does at ``launch_chunk``'s chunk, so that a
seed renders the same image on every run.  Its one read of the card is
``launch_windows`` (the largest window end and the longest window), the
span ``render.regen.launch.wait``, read on either device so that the span
lies where the card's launch reads it.

While ``utils/profiler.py`` records, ``bounce_regen`` counts each
regenerating launch (``k2.launches``); on the card, as ``render_fused``
counts K1's, ``k2.lane_work`` and ``k2.warp_work`` over each thread's
passes (``ops/fused_render.py:lane_sums`` over the threads of the grid,
whose warps are the physical ones), ``k2.block_ns`` and ``k2.slot_ns``
(``block_sums`` over the blocks' stamps and the card's block slots for
the instantiation, its blocks per SM, which ``bounce_regen_occupancy``
reports, times the SMs) and on the host ``k2.items`` and ``k2.pulls``
(``queue_counts``); on the CPU ``k2.lane_work`` and ``k2.warp_work`` over
the plain version's lanes (the final state's ``work`` less the state it
was given).  Nothing waits for the card until the profiler's ``snapshot``
reads the counters, and recording changes no output.

``bounce_regen_profile`` launches the regenerating mode's phase profile
(``FLAG_PROF``) on the same work-queue kernel, grid and items, counted
apart in ``bounce_regen_profile.launches``; no path of the renderer runs
it.  ``bounce_regen_occupancy`` launches nothing: it reports the blocks
per SM and the shared memory of the instantiation a launch would take.

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
    FLAG_PROF, PROF_COLS, PROFILE_WALKS, THREADS, QueueRun, block_sums, check_flags,
    check_lane_tensor, estimator_flags, image_args, item_chunk, lane_sums, launch_lanes,
    launch_params, launch_tables, launch_windows, node_args, queue_buffers, queue_counts,
    queue_plan, sm_count, sobol_smem_bytes, sobol_table, trace_args, walk_args,
)
from .trace import WALKS, walk_of


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


def _launch(scene, params, fstate, istate, regen, depth, flags=0, *, grid=None, given=None,
            lanes=None, queue=(1, 1, None, None, None, None), prof=None, stamps=None,
            occupancy=None):
    """One launch of the bounce kernel; returns the tree walk it took.
    ``params`` is (ints, floats, (sampler, width, height, sample_end)).  The
    one-bounce mode (``regen`` False, bounce index ``depth``) updates
    ``fstate`` and ``istate`` in place.  The regenerating mode writes there
    the final state of the lanes whose given state ``given`` (fin, iin)
    holds, over ``lanes`` (px, py, s0, sample_limit), fed from the work queue
    of ``grid`` blocks and ``queue`` (chunk, chunks, next, part_rad,
    part_work, thread_work: ``csrc/render_kernels.cuh:QueueLaunch``); its
    profile (FLAG_PROF) goes to ``prof`` and, when set, each block's stamps
    to ``stamps`` ((grid, ``BLOCK_STAMP_COLS``) int64, zeroed).  With
    ``occupancy`` (a host int32 array of 2) nothing is launched, and the
    launcher writes the instantiation's blocks per SM and shared memory
    there."""
    device = fstate.device
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, lanes on {device}")
    if not supports_bounce_kernel(scene):
        raise NotImplementedError(
            "bounce_kernel does not take nested checkers: the renderer sends them "
            "to the fixed-depth wavefront (render/integrator.py:trace_paths)"
        )
    n = fstate.shape[1]
    lib = _build.load_library()
    ints, floats, (sampler, width, height, sample_end) = params
    tables, _keep = launch_tables(scene, sampler, width, height, sample_end)
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    dims, texels = image_args(scene)
    shade_rows = scene.shade_rows.contiguous()
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    smem = sobol_smem_bytes(sampler, sample_end) if regen else 0
    blocks = grid if regen else -(-n // THREADS)
    walk, code, cap, leaf_queue = walk_args(scene, blocks * THREADS, smem)
    check_flags(walk, flags)
    nodes, _nodes = node_args(scene, walk)
    ptr = lambda t: None if t is None else t.data_ptr()
    host = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    fin, iin = given or (None, None)
    px, py, s0, limit = lanes or (None,) * 4
    chunk, chunks, nxt, part_rad, part_work, thread_work = queue
    err = lib.zwrt_bounce(
        host(ints), host(floats), host(tables), host(trace_ints), host(trace_ptrs),
        host(nodes), dims.shape[0], dims.data_ptr(), texels.data_ptr(),
        shade_rows.data_ptr(), sobol.data_ptr(), fstate.data_ptr(), istate.data_ptr(),
        ptr(fin), ptr(iin), ptr(px), ptr(py), ptr(s0), ptr(limit), ptr(prof), ptr(stamps),
        int(regen), int(depth), code, flags, cap, ptr(leaf_queue),
        0 if leaf_queue is None else leaf_queue.numel(), n, blocks, chunk, chunks, ptr(nxt),
        ptr(part_rad), ptr(part_work), ptr(thread_work), host(occupancy),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bounce_kernel ({walk} walk, flags {flags}) launch failed: "
                           f"cudaError {err}")
    return walk


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
    walk = _launch(scene, (ints, floats, (SamplerKind.SOBOL, 1, 1, 1)), fstate, istate, False,
                   depth, flags)
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
    (every lane dead, its window used up, its path fields those of its last
    sample).  ``px``, ``py`` and ``sample_limit`` are (N,) int32;
    ``rr_start`` and ``clamp`` as ``bounce`` takes them."""
    kw = dict(
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof, rr_start=rr_start, clamp=clamp,
    )
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bounce_regen runs on cuda or cpu tensors, not {px.device}")
    record = profiler.recording()
    with profiler.named_zone("render.regen.launch.wait"):
        windows = _windows(state, sample_limit, stride)
    if px.device.type == "cpu":
        out = integrator.bounce_regen_reference(
            scene, state, px, py, sample_limit, seed, t_min, **kw
        )
        if record and px.shape[0]:
            lane_work, warp_work = lane_sums(out.work - state.work)
            profiler.count("k2.lane_work", lane_work)
            profiler.count("k2.warp_work", warp_work)
    else:
        flags, kw["rr_start"], kw["clamp"] = estimator_flags(scene, rr_start, clamp)
        out, _, walk, q = _regen(scene, state, px, py, sample_limit, windows, seed, t_min, flags,
                                 record=record, **kw)
        bounce_regen.launches[walk] += 1
        bounce_regen.estimator_launches += bool(flags)
        if record and q is not None:
            block_ns, slot_ns = block_sums(q.stamps, q.slots)
            profiler.count("k2.block_ns", block_ns)
            profiler.count("k2.slot_ns", slot_ns)
            lane_work, warp_work = lane_sums(q.thread_work)
            profiler.count("k2.lane_work", lane_work)
            profiler.count("k2.warp_work", warp_work)
            items, pulls = queue_counts(q.chunks, px.shape[0], q.grid * THREADS)
            profiler.count("k2.items", items)
            profiler.count("k2.pulls", pulls)
    if record:
        profiler.count("k2.launches")
    return out


bounce_regen.launches = dict.fromkeys(WALKS, 0)
bounce_regen.estimator_launches = 0


def _windows(state: RegenState, sample_limit, stride: int):
    """(s0, sample end, longest window) of a regenerating launch: each
    lane's first sample, one stride past the sample it was given, and
    ``launch_windows`` of its windows [s0, sample_limit), in one read of
    the card."""
    s0 = (state.sample + stride).contiguous()
    return (s0, *launch_windows(s0, sample_limit, stride))


def bounce_regen_profile(scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
                         t_min: float, **kw):
    """``bounce_regen`` through the regenerating mode's phase profile, for
    the walks of ``PROFILE_WALKS``: the same work-queue kernel, grid and
    items, so the same final state bit for bit.  Returns (final state,
    profile), the profile (PROF_COLS, grid * THREADS) int64, one column a
    thread of the launch's grid summed over all of its items, as
    ``ops/fused_render.py:render_fused_profile`` describes its columns.
    CPU tensors take the plain version and return no profile.
    ``bounce_regen_profile.launches`` counts launches per walk."""
    if px.device.type == "cpu":
        return integrator.bounce_regen_reference(
            scene, state, px, py, sample_limit, seed, t_min, **kw), None
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    out, prof, walk, _ = _regen(scene, state, px, py, sample_limit,
                                _windows(state, sample_limit, kw["stride"]), seed, t_min,
                                FLAG_PROF | est, **kw)
    bounce_regen_profile.launches[walk] += 1
    return out, prof


bounce_regen_profile.launches = dict.fromkeys(PROFILE_WALKS, 0)


def bounce_regen_occupancy(scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
                           t_min: float, **kw):
    """(blocks per SM, dynamic shared memory bytes a block) of the
    regenerating instantiation that ``bounce_regen`` on these CUDA lanes
    would launch (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the
    launcher has raised the shared memory of an instantiation that more
    than ``MAX_BLOCKS_PER_SM`` blocks would fit); launches nothing and
    counts nothing."""
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    occ = np.zeros(2, np.int32)
    _regen(scene, state, px, py, sample_limit, _windows(state, sample_limit, kw["stride"]), seed,
           t_min, est, occupancy=occ, **kw)
    return int(occ[0]), int(occ[1])


def launch_chunk(scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
                 t_min: float, **kw) -> int:
    """The samples an item takes (``item_chunk``) in the work queue that
    ``bounce_regen`` would launch over these CUDA lanes: what
    ``integrator.bounce_regen_items_reference`` needs to sum as the kernel
    does."""
    blocks, _ = bounce_regen_occupancy(scene, state, px, py, sample_limit, seed, t_min, **kw)
    _, _, longest = _windows(state, sample_limit, kw["stride"])
    return item_chunk(launch_lanes(kw["width"], kw["height"], kw["stride"]), longest,
                      blocks * sm_count(px.device) * THREADS)


def _regen(scene, state, px, py, sample_limit, windows, seed, t_min, flags, *,
           camera_consts, sampler, width, height, spp, stride, max_depth, has_dof, rr_start=0,
           clamp=0.0, occupancy=None, record=False):
    """One regenerating launch over ``windows`` (``_windows``: each lane's
    first sample, the sample end and the longest window), fed from the
    work queue: the grid is the blocks the card holds at once of the
    instantiation without the profile (asked once per scene and
    instantiation; the profile's is held to the same blocks a SM and runs
    the same grid and items), or fewer where the items are fewer, and
    ``item_chunk`` sizes the items (``ops/fused_render.py:queue_plan``).
    Returns (final state, profile or None, walk, QueueRun or None: none
    without lanes); with ``record`` the launch stamps its blocks and counts
    each thread's passes.  With ``occupancy`` nothing is launched (as
    ``_launch`` takes it) and None is returned."""
    device = px.device
    if device.type != "cuda":
        raise ValueError(f"bounce_regen runs on cuda or cpu tensors, not {device}")
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("sample_limit", sample_limit),
                    ("sample", state.sample), ("bounce", state.bounce),
                    ("work", state.work)):
        check_lane_tensor(name, t, device, n)
    check_lane_tensor("ray_id", state.ray_id, device, n, torch.int64)
    check_lane_tensor("alive", state.alive, device, n, torch.bool)
    s0, sample_end, longest = windows
    fin, iin = _pack(
        state.origin, state.direction, state.throughput, state.radiance,
        state.time,
        (_u32_bits(state.ray_id), state.alive, state.sample, state.bounce, state.work),
        device, n,
    )
    ints, floats = launch_params(
        scene, seed, t_min, camera_consts, sampler, width, height, spp,
        stride, max_depth, has_dof, sample_end, rr_start, clamp,
    )
    params = (ints, floats, (sampler, width, height, sample_end))
    lanes = (px, py, s0, sample_limit)
    lane_blocks = max(1, -(-n // THREADS))
    ask = lambda occ, flags: _launch(scene, params, fin, iin, True, 0, flags, grid=lane_blocks,
                                     given=(fin, iin), lanes=lanes, occupancy=occ)
    if occupancy is not None:
        ask(occupancy, flags)
        return None
    fout, iout = torch.empty_like(fin), torch.empty_like(iin)
    q = prof = None
    if n == 0:
        walk = walk_of(scene)
    else:
        smem = sobol_smem_bytes(sampler, sample_end)
        key = ("bounce", device, walk_of(scene), flags & ~FLAG_PROF, smem)
        grid, slots, chunk, chunks = queue_plan(
            scene, device, key, lambda occ: ask(occ, flags & ~FLAG_PROF), n, width, height,
            stride, longest)
        nxt, part_rad, part_work, stamps, thread_work = queue_buffers(
            grid, chunks, n, device, True, record)
        prof = (torch.empty((PROF_COLS, grid * THREADS), dtype=torch.int64, device=device)
                if flags & FLAG_PROF else None)
        walk = _launch(scene, params, fout, iout, True, 0, flags, grid=grid, given=(fin, iin),
                       lanes=lanes, queue=(chunk, chunks, nxt, part_rad, part_work, thread_work),
                       prof=prof, stamps=stamps)
        q = QueueRun(grid, slots, chunk, chunks, stamps, thread_work)
    f, s = fout, iout
    out = RegenState(
        origin=V3(f[0], f[1], f[2]), direction=V3(f[3], f[4], f[5]),
        time=f[12], ray_id=s[0].to(torch.int64) & 0xFFFFFFFF,
        throughput=V3(f[6], f[7], f[8]), radiance=V3(f[9], f[10], f[11]),
        alive=s[1] != 0, sample=s[2], bounce=s[3], work=s[4],
    )
    return out, prof, walk, q
