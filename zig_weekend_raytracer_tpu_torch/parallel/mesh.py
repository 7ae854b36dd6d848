"""Device meshes (counterpart of ``parallel/mesh.py``).

A mesh is a tuple of ``torch.device``: one process drives every entry, as
the JAX package's single controller drives its ``jax.sharding.Mesh``.  An
entry may repeat: its shards then render in turn on that device.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

AXIS = "devices"
SHARD_MODES = ("samples", "rows")

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D mesh of ``n_devices`` entries.  On ``cuda``: the first
    ``n_devices`` cards (all by default); fewer cards, or none, raise.  On
    ``cpu``: the CPU device ``n_devices`` times (default ``ZWRT_CPU_DEVICES``
    or 1), the counterpart of the JAX package's virtual CPU devices."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): CUDA is not available")
        present = torch.cuda.device_count()
        n = present if n_devices is None else n_devices
        if present < n:
            raise ValueError(f"requested {n} devices but only {present} present")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    elif kind == "cpu":
        n = int(os.environ.get("ZWRT_CPU_DEVICES", "1")) if n_devices is None else n_devices
        devs = (torch.device("cpu"),) * n
    else:
        raise ValueError(f"make_mesh: no mesh of {device!r} devices (cuda | cpu)")
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return devs


def resolve_mesh(mesh, default_device) -> Mesh:
    """``mesh`` as indexed devices (``"cuda"`` is the current card), or
    ``make_mesh`` on ``default_device``'s type when None.  A CUDA entry
    without a GPU raises."""
    if mesh is None:
        return make_mesh(device=torch.device(default_device).type)
    out = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: CUDA is not available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return tuple(out)
