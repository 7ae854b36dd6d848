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
each launch, as ``ops/fused_render.py:walk_args`` says).

Image-textured emitters take the kernel with or without a LUT, since the
texel is read at the hit, before emission (the JAX kernel needs the LUT
for them).  Nested checkers take no kernel in the JAX package; the port's
scene compile refuses them.
"""

from __future__ import annotations

import ctypes

import torch

from ..dtypes import real
from ..math.v3 import V3
from ..render import integrator
from ..render.integrator import RegenState
from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..scene import CompiledScene
from . import _build
from .fused_render import (
    check_lane_tensor, image_args, launch_params, sobol_table, trace_args, walk_args,
)
from .trace import WALKS


def supports_bounce_kernel(scene: CompiledScene) -> bool:
    """True for every scene the port compiles.  Image emitters read their
    texel at the hit, LUT or not, where JAX's gate lifts only with a LUT
    (pallas_bounce.py:1626-1635); nested checkers, which would not fit one
    shade record, are refused by the scene compile."""
    return True


def supports_fused_render(scene: CompiledScene) -> bool:
    """The whole-render kernel reads images only from a texture LUT: scenes
    without images, or with a LUT (pallas_bounce.py:1638-1644); other image
    scenes take the bounce kernel's regenerating mode."""
    return not scene.has_image_textures or bool(scene.tex_lut_dims)


def _launch(scene, params, fstate, istate, lanes, regen, depth) -> str:
    """One launch of the bounce kernel; returns the tree walk it took."""
    device = fstate.device
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, lanes on {device}")
    n = fstate.shape[1]
    lib = _build.load_library()
    ints, floats, width, height = params
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    image_ints, texels = image_args(scene)
    shade_rows = scene.shade_rows.contiguous()
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    px, py, limit = (None, None, None) if lanes is None else (t.data_ptr() for t in lanes)
    walk, code, cap, queue = walk_args(scene, n)
    err = lib.zwrt_bounce(
        ints.ctypes.data_as(ctypes.c_void_p),
        floats.ctypes.data_as(ctypes.c_void_p),
        trace_ints.ctypes.data_as(ctypes.c_void_p),
        trace_ptrs.ctypes.data_as(ctypes.c_void_p),
        image_ints.ctypes.data_as(ctypes.c_void_p),
        texels.data_ptr(), shade_rows.data_ptr(), sobol.data_ptr(),
        fstate.data_ptr(), istate.data_ptr(), px, py, limit,
        int(regen), int(depth), code, cap, None if queue is None else queue.data_ptr(),
        0 if queue is None else queue.numel(), n,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bounce_kernel ({walk} walk) launch failed: cudaError {err}")
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
    alive,
):
    """One bounce of every lane at bounce index ``depth``: trace, shade,
    texture and scatter (one-bounce mode, the counterpart of
    ``bounce_pallas`` with its atlas multiply, or with its in-kernel LUT
    fetch when the scene has a texture LUT).  ``ray_id`` is (N,) int64
    holding u32 values, ``alive`` (N,) bool.  Returns (origin', direction',
    throughput', radiance', alive')."""
    device = origin.x.device
    n = origin.shape[0]
    if device.type == "cpu":
        d = torch.full((n,), int(depth), dtype=torch.int64, device=device)
        return integrator.bounce(
            scene, seed, t_min, d, origin, direction, time, ray_id,
            throughput, radiance, alive,
        )
    if device.type != "cuda":
        raise ValueError(f"bounce runs on cuda or cpu tensors, not {device}")
    check_lane_tensor("ray_id", ray_id, device, n, torch.int64)
    check_lane_tensor("alive", alive, device, n, torch.bool)
    fstate, istate = _pack(
        origin, direction, throughput, radiance, time,
        (_u32_bits(ray_id), alive), device, n,
    )
    ints, floats = launch_params(
        scene, seed, t_min, ((0.0,) * 3,) * 6, SamplerKind.SOBOL, 1, 1, 1,
        1, 1, False,
    )
    walk = _launch(scene, (ints, floats, 1, 1), fstate, istate, None, False, depth)
    bounce.launches[walk] += 1
    f = fstate
    return (
        V3(f[0], f[1], f[2]), V3(f[3], f[4], f[5]), V3(f[6], f[7], f[8]),
        V3(f[9], f[10], f[11]), istate[1] != 0,
    )


bounce.launches = dict.fromkeys(WALKS, 0)


def bounce_regen(
    scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
    t_min: float, *, camera_consts, sampler: SamplerKind, width: int,
    height: int, spp: int, stride: int, max_depth: int, has_dof: bool,
) -> RegenState:
    """The regenerating mode (counterpart of ``bounce_pallas_regen`` with
    its atlas fold): from ``state``, each lane renders its pixel's samples
    ``state.sample + stride``, ... below ``sample_limit``, respawning the
    next one in-kernel as a path ends, and the final state is returned
    (every lane dead, its window used up).  ``px``, ``py`` and
    ``sample_limit`` are (N,) int32."""
    kw = dict(
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof,
    )
    device = px.device
    n = px.shape[0]
    if device.type == "cpu":
        return integrator.bounce_regen_reference(
            scene, state, px, py, sample_limit, seed, t_min, **kw
        )
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
        stride, max_depth, has_dof,
    )
    walk = _launch(scene, (ints, floats, width, height), fstate, istate,
                   (px, py, sample_limit), True, 0)
    bounce_regen.launches[walk] += 1
    f, s = fstate, istate
    return RegenState(
        origin=V3(f[0], f[1], f[2]), direction=V3(f[3], f[4], f[5]),
        time=f[12], ray_id=s[0].to(torch.int64) & 0xFFFFFFFF,
        throughput=V3(f[6], f[7], f[8]), radiance=V3(f[9], f[10], f[11]),
        alive=s[1] != 0, sample=s[2], bounce=s[3], work=s[4],
    )


bounce_regen.launches = dict.fromkeys(WALKS, 0)
