"""Edge-aware à-trous wavelet denoiser guided by the first-hit AOVs
(counterpart of ``render/denoise.py``).

Per iteration i (hole size 2^i): 5x5 B3-spline taps dilated by the hole
size, each weighted by four edge stops against the centre pixel: normal
(dot^sigma_n), relative depth (exp(-|dz| / (sigma_z step (|z| + 1)))),
demodulated luminance (exp(-|dl| / sigma_l)) and albedo (exp(-|da|_1 /
sigma_a)), the weights renormalized per pixel.  The colour is demodulated
by the albedo first (irradiance = colour / albedo) and remodulated after,
so texture detail survives the smoothing; the albedo stop keeps a flush
emitter apart from the wall around it.

``sigma_l="auto"`` scales the luminance stop with the framebuffer's
measured noise (``estimate_noise_sigma``, host numpy as in the JAX package,
times ``_SIGMA_L_PER_NOISE``).  The constants and defaults are the JAX
package's, whose docstring records their calibration.

The filter is 25 shifted multiply-adds per iteration over (H, W) arrays,
plain torch on the framebuffer's device; the JAX package leaves it to XLA
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import LUM_B, LUM_G, LUM_R, real

# 1D B3-spline; the 2D kernel is the outer product
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_EPS = 1e-4
# sigma_l = _SIGMA_L_PER_NOISE * estimate_noise_sigma (sigma_l="auto")
_SIGMA_L_PER_NOISE = 7.0


def _shift2d(x, dy, dx):
    """(H, W, C) ``x`` shifted by (dy, dx) with edge clamping:
    out[y, x] = x[clamp(y - dy), clamp(x - dx)]."""
    h, w = x.shape[0], x.shape[1]
    rows = torch.clamp(torch.arange(h, device=x.device) - dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=x.device) - dx, 0, w - 1)
    return x[rows][:, cols]


def _atrous(color, albedo, normal, depth, sigma_l, *, iterations, sigma_z, sigma_n, sigma_a):
    alb = torch.clamp(albedo, min=_EPS)
    irr = color / alb
    lum_w = torch.tensor([LUM_R, LUM_G, LUM_B], dtype=color.dtype, device=color.device)
    # the AOV normal is a mean over samples, not renormalized: normalize
    # the guide (direction is the edge signal) and mark |n| ~ 0 as a miss
    n_len = torch.sqrt((normal * normal).sum(-1, keepdim=True))
    miss = n_len < 0.25
    n_hat = normal / torch.clamp(n_len, min=_EPS)
    miss_f = miss.to(irr.dtype)
    z_c = depth[..., None]
    # sigma_l is a float32 value (a traced scalar in the JAX package), so
    # its sum with _EPS rounds to float32
    l_den = float(np.float32(sigma_l) + np.float32(_EPS))

    out = irr
    for i in range(iterations):
        step = 1 << i
        lum_c = (out * lum_w).sum(-1, keepdim=True)
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(lum_c)
        for ty in range(-2, 3):
            for tx in range(-2, 3):
                k = float(_B3[ty + 2] * _B3[tx + 2])
                dy, dx = ty * step, tx * step
                irr_t = _shift2d(out, dy, dx)
                n_t = _shift2d(n_hat, dy, dx)
                m_t = _shift2d(miss_f, dy, dx) > 0.5
                z_t = _shift2d(z_c, dy, dx)
                lum_t = (irr_t * lum_w).sum(-1, keepdim=True)

                w_n = torch.clamp((n_hat * n_t).sum(-1, keepdim=True), min=0.0)
                w_n = w_n ** sigma_n
                # misses mix with misses (weight 1), never with hits
                w_n = torch.where(miss | m_t, (miss == m_t).to(w_n.dtype), w_n)
                w_z = torch.exp(
                    -torch.abs(z_c - z_t) / (sigma_z * step * (torch.abs(z_c) + 1.0) + _EPS)
                )
                w_l = torch.exp(-torch.abs(lum_c - lum_t) / l_den)
                a_t = _shift2d(albedo, dy, dx)
                w_a = torch.exp(-torch.abs(albedo - a_t).sum(-1, keepdim=True) / (sigma_a + _EPS))
                w = k * w_n * w_z * w_l * w_a
                acc = acc + irr_t * w
                wacc = wacc + w
        # a pixel whose every tap weight vanished keeps its value
        out = torch.where(wacc > _EPS, acc / torch.clamp(wacc, min=_EPS), out)
    return out * alb


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def estimate_noise_sigma(color, aovs: dict) -> float:
    """Global Monte-Carlo noise level of a framebuffer in demodulated-
    luminance units (host numpy, as in the JAX package): the median
    absolute response of Immerkaer's high-pass over pixels away from AOV
    discontinuities (all pixels when fewer than 16 remain), over 0.6745 x 6."""
    fb = np.asarray(_numpy(color), np.float32)
    alb = np.maximum(np.asarray(_numpy(aovs["albedo"]), np.float32), _EPS)
    irr = fb / alb
    lum = (
        np.float32(LUM_R) * irr[..., 0] + np.float32(LUM_G) * irr[..., 1]
        + np.float32(LUM_B) * irr[..., 2]
    )
    # Immerkaer response, valid interior = [1:-1, 1:-1]
    c = lum[1:-1, 1:-1]
    resp = (
        4.0 * c
        - 2.0 * (lum[:-2, 1:-1] + lum[2:, 1:-1] + lum[1:-1, :-2] + lum[1:-1, 2:])
        + lum[:-2, :-2] + lum[:-2, 2:] + lum[2:, :-2] + lum[2:, 2:]
    )

    def steps(a):  # max abs diff to the 4 neighbours, interior-shaped
        ax = np.abs(np.diff(a, axis=0)), np.abs(np.diff(a, axis=1))
        return np.maximum(
            np.maximum(ax[0][:-1, 1:-1], ax[0][1:, 1:-1]),
            np.maximum(ax[1][1:-1, :-1], ax[1][1:-1, 1:]),
        )

    a_step = steps(np.asarray(_numpy(aovs["albedo"]), np.float32).sum(-1))
    z = np.asarray(_numpy(aovs["depth"]), np.float32)
    z_step = steps(z) / (np.abs(z[1:-1, 1:-1]) + 1.0)
    n = np.asarray(_numpy(aovs["normal"]), np.float32)
    n_len = np.sqrt((n * n).sum(-1))
    miss = n_len < 0.25
    edge = (a_step > 0.05) | (z_step > 0.02) | (steps(miss.astype(np.float32)) > 0.0)
    n_hat = n / np.maximum(n_len, _EPS)[..., None]
    n_dot = np.ones_like(n_len)
    for axis in (0, 1):
        d = (np.take(n_hat, range(0, n_hat.shape[axis] - 1), axis)
             * np.take(n_hat, range(1, n_hat.shape[axis]), axis)).sum(-1)
        pad = [(0, 0), (0, 0)]
        pad[axis] = (0, 1)
        n_dot = np.minimum(n_dot, np.pad(d, pad, constant_values=1.0))
        pad[axis] = (1, 0)
        n_dot = np.minimum(n_dot, np.pad(d, pad, constant_values=1.0))
    edge = edge | (n_dot[1:-1, 1:-1] < 0.95) | miss[1:-1, 1:-1]
    # dilate by 1: the high-pass stencil touches neighbours
    ep = np.pad(edge, 1, mode="edge")
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge = edge | ep[1 + dy : ep.shape[0] - 1 + dy, 1 + dx : ep.shape[1] - 1 + dx]
    flat = np.abs(resp[~edge])
    if flat.size < 16:
        flat = np.abs(resp).reshape(-1)
    if flat.size == 0:
        return 0.0
    return float(np.median(flat) / (0.6745 * 6.0))


def denoise(color, aovs: dict, *, iterations: int = 3, sigma_l: "float | str" = "auto",
            sigma_z: float = 0.05, sigma_n: float = 64.0, sigma_a: float = 0.1) -> torch.Tensor:
    """Denoise a linear (H, W, 3) framebuffer (a tensor, or an array taken
    to the CPU) with the AOVs of ``render/aov.py``; returns the (H, W, 3)
    float32 tensor on the framebuffer's device.  ``iterations`` passes with
    doubling hole size (0: the framebuffer as it is); ``sigma_l`` the
    luminance stop ("auto": from the measured noise); ``sigma_z`` the depth
    stop per dilation step; ``sigma_n`` the normal stop's exponent;
    ``sigma_a`` the albedo stop."""
    color = torch.as_tensor(color).to(real)
    if iterations <= 0:
        return color
    if sigma_l == "auto":
        sigma_l = _SIGMA_L_PER_NOISE * estimate_noise_sigma(color, aovs)
    guide = lambda a: torch.as_tensor(a).to(device=color.device, dtype=real)
    return _atrous(
        color, guide(aovs["albedo"]), guide(aovs["normal"]), guide(aovs["depth"]),
        sigma_l, iterations=int(iterations), sigma_z=float(sigma_z),
        sigma_n=float(sigma_n), sigma_a=float(sigma_a),
    )
