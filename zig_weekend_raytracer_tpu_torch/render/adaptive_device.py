"""The adaptive sampler's plan on the scene's device (counterpart of
``render/adaptive_device.py``): torch twins of ``render/adaptive.py``'s
``variance_weights``, ``allocate_extra`` and ``build_adaptive_plan``, so
that the pilot framebuffers never leave the device and the plan's lane
arrays are made there.  The host functions are their plain versions.

  * weights: the same luminance half-difference and 3x3 box, in float32
    (the host's float64 may break ties otherwise: both are plans of the
    same budget);
  * allocation: floor shares and largest-remainder singles under the
    per-pixel cap, exact conservation, 4 passes that hand out again what
    the cap clipped (the host loops to convergence; 4 suffice unless the
    cap binds almost everywhere, where the rest stays out as on the host);
  * plan: the host's lanes, lane for lane (tile order, ceil(n / lane_cap)
    windows, the descending-length sort), in ``m_lanes`` lanes, a bound
    that depends on the image size only: sum ceil(n / lane_cap) <= pixels
    + extra / lane_cap <= 1.5 pixels, since lane_cap >= 2 times the mean
    extra budget.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dtypes import LUM_B, LUM_G, LUM_R
from .adaptive import _RESERVE, _SMOOTH, _WEIGHT_FLOOR


def variance_weights_dev(half_a: torch.Tensor, half_b: torch.Tensor) -> torch.Tensor:
    """``adaptive.variance_weights`` in float32 on the tensors' device:
    (rows, W, 3) half-pilot means -> (rows, W)."""
    d = torch.abs(half_a - half_b)
    lum = LUM_R * d[..., 0] + LUM_G * d[..., 1] + LUM_B * d[..., 2]
    k = 2 * _SMOOTH + 1
    p = F.pad(lum[None, None], (_SMOOTH,) * 4, mode="replicate")[0, 0]
    rows, width = lum.shape
    sm = torch.zeros_like(lum)
    for i in range(k):
        for j in range(k):
            sm = sm + p[i : i + rows, j : j + width]
    return sm / float(k * k)


def allocate_extra_dev(weight: torch.Tensor, extra_total: int, cap) -> torch.Tensor:
    """``adaptive.allocate_extra`` in float32 on the weights' device, with
    4 passes of floor shares and largest-remainder singles.  ``cap`` is a
    scalar or a per-pixel tensor of the weights' (flattened) size.  Returns
    int32 of the weights' shape."""
    shape = weight.shape
    dev = weight.device
    w = weight.reshape(-1).to(torch.float32)
    w = w + torch.clamp(w.mean(), min=1e-30) * _WEIGHT_FLOOR
    size = w.shape[0]
    cap = torch.as_tensor(cap, dtype=torch.int32, device=dev).reshape(-1)
    n = torch.zeros((size,), dtype=torch.int32, device=dev)
    remaining = torch.tensor(int(extra_total), dtype=torch.int32, device=dev)
    ranks = torch.arange(size, dtype=torch.int32, device=dev)
    for _ in range(4):
        room = cap - n
        open_w = torch.where(room > 0, w, 0.0)
        tot = open_w.sum()
        share = torch.where(tot > 0, remaining.to(torch.float32) * open_w
                            / torch.clamp(tot, min=1e-30), 0.0)
        add = torch.minimum(torch.floor(share).to(torch.int32), room)
        n = n + add
        remaining = remaining - add.sum(dtype=torch.int32)
        # largest-remainder singles among the pixels with room left
        room2 = cap - n
        frac = torch.where(room2 > 0, share - torch.floor(share), -1.0)
        order = torch.argsort(-frac, stable=True)
        rank = torch.empty_like(ranks).scatter_(0, order, ranks)
        give = ((rank < remaining) & (room2 > 0)).to(torch.int32)
        n = n + give
        remaining = remaining - give.sum(dtype=torch.int32)
    return n.reshape(shape)


def plan_lane_budget(pixels: int, blk: int) -> int:
    """The plan's lane count: the largest ceil-split (<= 1.5 pixels, see
    the module docstring) rounded up to a power of two that is a multiple
    of ``blk``."""
    m = max(blk, -(-3 * pixels // 2))
    m = 1 << int(m - 1).bit_length()
    return max(m, blk)


def build_adaptive_plan_dev(n_extra: torch.Tensor, order: torch.Tensor, *, band_y0: int,
                            pilot: int, lane_cap: int, sort_lanes: bool, m_lanes: int,
                            width: int):
    """``adaptive.build_adaptive_plan`` on the device, in ``m_lanes``
    lanes: ``n_extra`` (rows, W) int extra samples per pixel, ``order``
    the tile-order pixel permutation (rows * W,).  Returns (px, py, s0,
    s1) int32; dead lanes have s1 == s0 == 0."""
    dev = n_extra.device
    rows = n_extra.shape[0]
    i32 = torch.int32
    n = n_extra.reshape(-1).to(i32)[order]
    ys = (order // width).to(i32) + band_y0
    xs = (order % width).to(i32)

    k = -(-n // lane_cap)  # ceil; no lane for n == 0
    csum = torch.cumsum(k, 0, dtype=i32)
    starts = csum - k
    total = csum[-1]

    lane = torch.arange(m_lanes, dtype=i32, device=dev)
    pix = torch.searchsorted(csum, lane, right=True).to(i32)
    live = lane < total
    pixc = torch.clamp(pix, max=rows * width - 1).long()

    j = lane - starts[pixc]
    nn = n[pixc]
    kk = torch.clamp(k[pixc], min=1)
    s0 = pilot + torch.div(j * nn, kk, rounding_mode="floor")
    s1 = pilot + torch.div((j + 1) * nn, kk, rounding_mode="floor")

    px = torch.where(live, xs[pixc], 0)
    py = torch.where(live, ys[pixc], band_y0)
    s0 = torch.where(live, s0, 0)
    s1 = torch.where(live, s1, 0)
    if sort_lanes:
        by_len = torch.argsort(-(s1 - s0), stable=True)
        px, py, s0, s1 = px[by_len], py[by_len], s0[by_len], s1[by_len]
    return tuple(a.to(i32).contiguous() for a in (px, py, s0, s1))


def reserve_base(spp: int, pilot: int) -> int:
    """Every pixel's unconditional share of the post-pilot budget."""
    return int((spp - pilot) * _RESERVE)


def plan_pipeline(sum_a, sum_b, order, *, half, base, extra_total, cap, band_y0, pilot,
                  lane_cap, sort_lanes, m_lanes, width, rows_eff):
    """Weights, allocation and lane plan of one band from its two pilot
    sums (band_rows, W, 3) on the device.  Returns (n_extra (rows_eff, W)
    int32, px, py, s0, s1 (m_lanes,) int32)."""
    inv = float(1.0 / half)
    weight = variance_weights_dev(sum_a[:rows_eff] * inv, sum_b[:rows_eff] * inv)
    n_extra = base + allocate_extra_dev(weight, extra_total, cap - base)
    n_full = torch.zeros((sum_a.shape[0], width), dtype=torch.int32, device=sum_a.device)
    n_full[:rows_eff] = n_extra
    px, py, s0, s1 = build_adaptive_plan_dev(
        n_full, order, band_y0=band_y0, pilot=pilot, lane_cap=lane_cap,
        sort_lanes=sort_lanes, m_lanes=m_lanes, width=width,
    )
    return n_extra, px, py, s0, s1
