"""The closest-hit kernel (counterpart of ``ops/pallas_trace.py``:
``closest_hit_pallas`` and its three kernels).

``closest_hit`` returns each ray's (t, kind, idx) as ``ops/trace.py``'s
``closest_hit`` does.  For CUDA tensors it launches ``closest_hit_kernel``
(``csrc/closest_hit.cu`` over the trace in ``csrc/zwrt_device.cuh``); for
CPU tensors it runs that plain PyTorch version.  Any other device raises.
``closest_hit.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..dtypes import BIG, INF, real
from ..math.v3 import V3
from ..scene import CompiledScene
from . import _build
from . import trace as _trace
from .fused_render import trace_args


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
            scene, origin, direction, time, t_min, t_max, active=active
        )
    if device.type != "cuda":
        raise ValueError(f"closest_hit runs on cuda or cpu tensors, not {device}")
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
    rays = torch.stack(parts).contiguous()
    mask = None
    if active is not None:
        if active.device != device or active.shape != (n,):
            raise ValueError(f"active must be ({n},) on {device}")
        mask = active.to(torch.int32).contiguous()

    lib = _build.load_library()
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    t = torch.empty((n,), dtype=real, device=device)
    kind = torch.empty((n,), dtype=torch.int32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    err = lib.zwrt_closest_hit(
        trace_ints.ctypes.data_as(ctypes.c_void_p),
        trace_ptrs.ctypes.data_as(ctypes.c_void_p),
        rays.data_ptr(), None if mask is None else mask.data_ptr(),
        float(t_min), min(float(t_max), BIG), t.data_ptr(), kind.data_ptr(),
        idx.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"closest_hit_kernel launch failed: cudaError {err}")
    closest_hit.launches += 1
    return _trace.Hit(t, kind, idx)


closest_hit.launches = 0
