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

``closest_hit_flat`` launches the kernel's first design on the same rays,
for measurement only (one thread per ray and the per-thread walk, rays
stacked into a (7, n) copy); its launches are counted apart in
``closest_hit_flat.launches``.  ``launch_args`` packs a launch's checked
arguments and launches nothing; both wrappers launch through it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..dtypes import BIG, INF, real
from ..math.v3 import V3
from ..scene import CompiledScene
from . import _build
from . import trace as _trace
from .fused_render import trace_args


def launch_args(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min: float,
    t_max: float = INF, active=None, flat: bool = False,
):
    """The checked arguments of one launch on CUDA rays, of
    ``zwrt_closest_hit`` or (``flat``) of ``zwrt_closest_hit_flat``:
    ``(args, hit, keep)``, ``hit`` the ``Hit`` the launch writes and
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
    if flat:
        rays = torch.stack(parts).contiguous()
        ray_arg = rays.data_ptr()
        mask = None if active is None else active.to(torch.int32).contiguous()
    else:
        rays = tuple(t.contiguous() for t in parts)
        ray_ptrs = np.array([t.data_ptr() for t in rays], np.uint64)
        ray_arg = ray_ptrs.ctypes.data_as(ctypes.c_void_p)
        mask = None if active is None else active.to(torch.bool).contiguous()
    hit = _trace.Hit(
        torch.empty((n,), dtype=real, device=device),
        torch.empty((n,), dtype=torch.int32, device=device),
        torch.empty((n,), dtype=torch.int32, device=device),
    )
    args = (
        ints.ctypes.data_as(ctypes.c_void_p), ptrs.ctypes.data_as(ctypes.c_void_p), ray_arg,
        None if mask is None else mask.data_ptr(), float(t_min), min(float(t_max), BIG),
        *(x.data_ptr() for x in hit), n, torch.cuda.current_stream(device).cuda_stream,
    )
    keep = (ints, ptrs, tables, rays, mask, None if flat else ray_ptrs)
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


def closest_hit_flat(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min: float,
    t_max: float = INF, active=None,
) -> _trace.Hit:
    """``closest_hit`` through the kernel's first design, for measurement;
    CUDA tensors only."""
    args, hit, _keep = launch_args(scene, origin, direction, time, t_min, t_max, active,
                                   flat=True)
    _launch("zwrt_closest_hit_flat", args)
    closest_hit_flat.launches += 1
    return hit


closest_hit_flat.launches = 0
