"""The closest-hit kernel (counterpart of ``ops/pallas_trace.py``:
``closest_hit_pallas`` and its three kernels).

``closest_hit`` returns each ray's (t, kind, idx) as ``ops/trace.py``'s
``closest_hit`` does.  For CUDA tensors it launches ``closest_hit_kernel``
(``csrc/closest_hit.cu`` over the trace in ``csrc/zwrt_device.cuh``); for
CPU tensors it runs that plain PyTorch version with the per-thread walk
(``walk="cond"``), whose result the kernel's walk equals.  Any other device
raises.  ``closest_hit.launches`` counts kernel launches.  Like the TPU's
``_tree_kernel`` it walks the per-kind trees, whatever ``ZWRT_TRAV`` or the
unified tree ask of the render and bounce kernels.

``coherent_keys`` launches ``coherent_keys_kernel`` (the same source): each
pixel's sample-0 camera ray made in the kernel as the render kernel makes
it, its closest hit, and the first-hit part of the renderer's coherent-plan
sort key, for CUDA scenes only (``render/renderer.py:coherent_plan_keys``
adds the lane index, and on the CPU runs the plain version);
``coherent_keys.launches`` counts its launches.

``launch_args`` packs a launch's checked arguments and launches nothing;
``closest_hit`` launches through it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..dtypes import BIG, INF, real
from ..math.v3 import V3
from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..scene import CompiledScene
from . import _build
from . import trace as _trace
from .fused_render import launch_params, launch_tables, sobol_table, trace_args


def launch_args(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min: float,
    t_max: float = INF, active=None,
):
    """The checked arguments of one launch of ``zwrt_closest_hit`` on CUDA
    rays: ``(args, hit, keep)``, ``hit`` the ``Hit`` the launch writes and
    ``keep`` the tensors and host arrays that ``args`` point into."""
    device = origin.x.device
    if device.type != "cuda":
        raise ValueError(f"closest_hit_kernel runs on cuda tensors, not {device}")
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, rays on {device}")
    if torch.is_tensor(t_min):
        raise ValueError("closest_hit_kernel takes one t_min for all rays")
    n = origin.shape[0]
    parts = (*origin, *direction, time)
    for t in parts:
        if t.device != device or t.dtype != real or t.shape != (n,):
            raise ValueError(
                f"rays must be ({n},) float32 on {device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if active is not None and (active.device != device or active.shape != (n,)):
        raise ValueError(f"active must be ({n},) on {device}")
    ints, ptrs, tables = trace_args(scene)
    rays = tuple(t.contiguous() for t in parts)
    ray_ptrs = np.array([t.data_ptr() for t in rays], np.uint64)
    mask = None if active is None else active.to(torch.bool).contiguous()
    hit = _trace.Hit(
        torch.empty((n,), dtype=real, device=device),
        torch.empty((n,), dtype=torch.int32, device=device),
        torch.empty((n,), dtype=torch.int32, device=device),
    )
    args = (
        ints.ctypes.data_as(ctypes.c_void_p), ptrs.ctypes.data_as(ctypes.c_void_p),
        ray_ptrs.ctypes.data_as(ctypes.c_void_p),
        None if mask is None else mask.data_ptr(), float(t_min), min(float(t_max), BIG),
        *(x.data_ptr() for x in hit), n, torch.cuda.current_stream(device).cuda_stream,
    )
    keep = (ints, ptrs, tables, rays, mask, ray_ptrs)
    return args, hit, keep


def _launch(name: str, args) -> None:
    err = getattr(_build.load_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def closest_hit(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min: float,
    t_max: float = INF, active=None,
) -> _trace.Hit:
    """Closest hit of each ray below ``t_max`` (see ``ops/trace.py``).
    ``origin``, ``direction`` and ``time`` are (N,) float32; ``t_min`` is a
    float; ``active`` an optional (N,) bool mask whose False rays report no
    hit."""
    device = origin.x.device
    if device.type == "cpu":
        return _trace.closest_hit(
            scene, origin, direction, time, t_min, t_max, active=active, walk="cond"
        )
    if device.type != "cuda":
        raise ValueError(f"closest_hit runs on cuda or cpu tensors, not {device}")
    args, hit, _keep = launch_args(scene, origin, direction, time, t_min, t_max, active)
    _launch("zwrt_closest_hit", args)
    closest_hit.launches += 1
    return hit


closest_hit.launches = 0


def keys_launch_args(
    scene: CompiledScene, seed: int, band_y0: int, rows: int, t_min: float, *,
    camera_consts, sampler: SamplerKind, width: int, height: int, spp: int, has_dof: bool,
):
    """The checked arguments of one ``zwrt_coherent_keys`` launch over
    rows [band_y0, band_y0 + rows) of a ``width`` x ``height`` image:
    ``(args, keys, keep)``, ``keys`` the (rows * width,) int64 tensor the
    launch writes and ``keep`` what ``args`` point into."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"coherent_keys_kernel runs on cuda scenes, not {device}")
    n = rows * width
    ints, floats = launch_params(scene, seed, t_min, camera_consts, sampler, width, height,
                                 spp, 1, 1, has_dof, sample_end=1)
    tables, keep_tables = launch_tables(scene, sampler, width, height, 1)
    trace_ints, trace_ptrs, trace_tables = trace_args(scene)
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    keys = torch.empty((n,), dtype=torch.int64, device=device)
    host = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    args = (host(ints), host(floats), host(tables), host(trace_ints), host(trace_ptrs),
            sobol.data_ptr(), band_y0, keys.data_ptr(), n,
            torch.cuda.current_stream(device).cuda_stream)
    keep = (ints, floats, tables, keep_tables, trace_ints, trace_ptrs, trace_tables, sobol)
    return args, keys, keep


def coherent_keys(
    scene: CompiledScene, seed: int, band_y0: int, rows: int, t_min: float, *,
    camera_consts, sampler: SamplerKind, width: int, height: int, spp: int, has_dof: bool,
) -> torch.Tensor:
    """(rows * width,) int64 on the scene's CUDA device, in row order: the
    first-hit part (hit_key + 1) << 32 of the coherent-plan key of each
    pixel of rows [band_y0, band_y0 + rows), hit_key = (kind << 24) + idx
    of the closest hit above ``t_min`` of its sample-0 camera ray (-1 on a
    miss); the low word is left 0 for the pixel's lane index.  One launch;
    nothing waits for the card."""
    args, keys, _keep = keys_launch_args(
        scene, seed, band_y0, rows, t_min, camera_consts=camera_consts, sampler=sampler,
        width=width, height=height, spp=spp, has_dof=has_dof)
    _launch("zwrt_coherent_keys", args)
    coherent_keys.launches += 1
    return keys


coherent_keys.launches = 0

