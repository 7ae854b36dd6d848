"""Axis-aligned bounding boxes (counterpart of ``math/aabb.py``): the
batched robust slab test over torch tensors, and the numpy helpers the
group-tree build (``geometry/bvh.py``) shares.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import AABB_MAX_MULT
from .v3 import V3


def aabb_hit(
    box_min: V3, box_max: V3, origin: V3, inv_dir: V3, t_min, t_max,
) -> torch.Tensor:
    """Batched robust slab test; ``inv_dir`` is the reciprocal direction.

    ``torch.minimum``/``maximum`` propagate NaN as ``jnp.minimum`` does: a
    direction component of 0 makes ``inv_dir`` infinite, and a box face
    through the origin then gives 0 * inf = NaN, which fails the test.  The
    4-ULP ``AABB_MAX_MULT`` on the far end keeps f32 rounding at box faces
    from reporting false misses."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    near = torch.maximum(
        torch.maximum(torch.minimum(t0.x, t1.x), torch.minimum(t0.y, t1.y)),
        torch.maximum(torch.minimum(t0.z, t1.z), torch.as_tensor(t_min, dtype=t0.x.dtype, device=t0.x.device)),
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(t0.x, t1.x), torch.maximum(t0.y, t1.y)),
        torch.minimum(torch.maximum(t0.z, t1.z), torch.as_tensor(t_max, dtype=t0.x.dtype, device=t0.x.device)),
    ) * AABB_MAX_MULT
    return far > near


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers of the tree build
# ---------------------------------------------------------------------------

_PAD_DELTA = 1e-4  # degenerate-axis padding


def aabb_pad_to_minimum(bmin: np.ndarray, bmax: np.ndarray):
    """Expand any axis thinner than the padding delta so boxes never
    collapse to zero volume."""
    bmin = np.array(bmin, dtype=np.float64, copy=True)
    bmax = np.array(bmax, dtype=np.float64, copy=True)
    thin = (bmax - bmin) < _PAD_DELTA
    bmin[thin] -= _PAD_DELTA / 2
    bmax[thin] += _PAD_DELTA / 2
    return bmin, bmax


def aabb_union(a_min, a_max, b_min, b_max):
    return np.minimum(a_min, b_min), np.maximum(a_max, b_max)


def aabb_longest_axis(bmin: np.ndarray, bmax: np.ndarray) -> int:
    """Index of the longest box axis."""
    return int(np.argmax(bmax - bmin))
