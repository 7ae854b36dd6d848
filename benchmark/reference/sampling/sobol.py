"""Sobol quasi-Monte-Carlo sampler over torch tensors (counterpart of
``sampling/sobol.py``, bitwise equal to it).

The JAX package carries 64-bit sample indices as (hi, lo) u32 pairs because
the TPU has no u64; here they are plain int64 tensors (the bit pattern of
the u64 index), and the CUDA kernel uses ``uint64_t``.  u32 values are
int64 tensors in [0, 2^32) as in ``hashrng``.

The direction-number tables are the port's own copy of the JAX package's
``sampling/sobol_data.npz`` (``sampling/sobol_data.npz`` here, byte for
byte), so the port reads nothing of the JAX package.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..dtypes import ONE_MINUS_EPS, real
from .hashrng import U32_MASK

N_SOBOL_DIMENSIONS = 1024
SOBOL_MATRIX_SIZE = 52
# Sample-index bits the interval-to-index delta covers (as the JAX package).
MAX_SPP_LOG2 = 28

SOBOL_DATA_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "sobol_data.npz"
)


@functools.lru_cache(maxsize=1)
def _data():
    with np.load(SOBOL_DATA_PATH) as z:
        return {k: z[k] for k in z.files}


def sobol_matrix(dim: int) -> np.ndarray:
    """The 52 u32 generator-matrix columns for one Sobol dimension."""
    return _data()["sobol32"][dim]


def vdc_columns(log2_scale: int):
    """(vdc_lo, vdc_inv) for a pixel-space scale: the 52 u32 van der Corput
    columns and the 52 u64 inverse columns (hi << 32 | lo) as Python ints."""
    d = _data()
    vdc_lo = [int(c) for c in d["vdc_lo"][log2_scale - 1]]
    vdc_inv = [
        (int(h) << 32) | int(l)
        for h, l in zip(d["vdc_inv_hi"][log2_scale - 1], d["vdc_inv_lo"][log2_scale - 1])
    ]
    return vdc_lo, vdc_inv


def _xor_columns(bits_src: torch.Tensor, cols) -> torch.Tensor:
    """XOR of ``cols[i]`` over the set bits i of ``bits_src`` (int64).

    Vectorised as an (N, C) masked table folded by halves with ``^``; the
    columns are Python ints (u32 or u64 bit patterns)."""
    cols = [c - (1 << 64) if c >= (1 << 63) else c for c in cols]
    width = 1 << max(0, (len(cols) - 1).bit_length())
    cols = cols + [0] * (width - len(cols))
    dev = bits_src.device
    col_t = torch.tensor(cols, dtype=torch.int64, device=dev)
    shifts = torch.arange(width, dtype=torch.int64, device=dev)
    bits = (bits_src.unsqueeze(-1) >> shifts) & 1
    v = bits * col_t
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] ^ v[..., half:]
    return v[..., 0]


def bit_reverse32(v: torch.Tensor) -> torch.Tensor:
    """Reverse the bits of u32 values (5 masked swaps)."""
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & U32_MASK


def owen_fast_scramble(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Owen-fast hash scrambling of u32 values with a u32 ``seed``."""
    m = U32_MASK
    seed = int(seed) & m
    v = bit_reverse32(v)
    v = v ^ ((v * 0x3D20ADEA) & m)
    v = (v + seed) & m
    v = (v * ((seed >> 16) | 1)) & m
    v = v ^ ((v * 0x05526C56) & m)
    v = v ^ ((v * 0x53A22864) & m)
    return bit_reverse32(v)


def murmur2_32(key: int, seed: int) -> int:
    """Murmur2 hash of a single u32 (per-dimension scramble seed)."""
    mask = U32_MASK
    m = 0x5BD1E995
    k = int(key) & mask
    h = (int(seed) & mask) ^ 4
    k = (k * m) & mask
    k ^= k >> 24
    k = (k * m) & mask
    h = (h * m) & mask
    h ^= k
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def sobol_sample_u32(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Raw u32 Sobol value of the int64 sample index ``idx`` in ``dim``."""
    return _xor_columns(idx, [int(c) for c in sobol_matrix(dim)])


def u32_to_unit_float(v: torch.Tensor) -> torch.Tensor:
    """u32 -> [0, 1) float as ``min(v * 2^-32, 1-eps)`` (round to nearest)."""
    vf = v.to(torch.float64).to(real) * (2.0 ** -32)
    return torch.clamp(vf, max=ONE_MINUS_EPS)


def sobol_sample(idx: torch.Tensor, dim: int, scramble_seed=None) -> torch.Tensor:
    """[0,1) Sobol sample; optionally Owen-fast scrambled."""
    v = sobol_sample_u32(idx, dim)
    if scramble_seed is not None:
        v = owen_fast_scramble(v, scramble_seed)
    return u32_to_unit_float(v)


def sobol_interval_to_index(
    log2_scale: int,
    sample_idx: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
) -> torch.Tensor:
    """Global Sobol index (int64 bit pattern of the u64) of the
    ``sample_idx``-th sample landing in pixel (px, py), for a sampling
    domain scaled by 2^log2_scale."""
    sample_idx = sample_idx.to(torch.int64) & U32_MASK
    if log2_scale == 0:
        return sample_idx
    vdc_lo, vdc_inv = vdc_columns(log2_scale)
    index = sample_idx << (2 * log2_scale)
    delta = _xor_columns(sample_idx, vdc_lo[:MAX_SPP_LOG2])
    b = ((px.to(torch.int64) << log2_scale) | py.to(torch.int64)) ^ delta
    b = b & U32_MASK
    return index ^ _xor_columns(b, vdc_inv[: 2 * log2_scale])


def sobol_pixel_u32(log2_scale: int, sample_idx, px, py, dim: int) -> torch.Tensor:
    """The pixel sampler's raw u32 of dimension ``dim`` (0 or 1) for the
    ``sample_idx``-th sample of pixel (px, py): the bit loops of
    ``sobol_interval_to_index`` and ``sobol_sample_u32``."""
    return sobol_sample_u32(sobol_interval_to_index(log2_scale, sample_idx, px, py), dim)


# The factored sampler.  Every step above is an XOR of table columns, so
# the u32 is linear over GF(2) in the sample's bits and in the pixel's bits
# (pixel bits (px << L) | py with px, py < 2^L, as every pixel of the image
# has): with L = log2_scale and C_d the 52 columns of dimension d,
#   v_d(s, px, py) = P_d(s) ^ Q_d(px, py),
#   P_d(s) = C_d ((s << 2L) ^ Inv VdC s) = v_d(s, 0, 0),
#   Q_d(px, py) = C_d Inv ((px << L) | py) = v_d(0, px, py),
# and when L = 0, Q_d = 0 and P_d(s) = C_d s.  P_d is linear in s, so it is
# the XOR of one table entry per byte of s.  The CUDA kernels read P_d's
# byte tables from shared memory and compute Q_d once per lane
# (csrc/zwrt_device.cuh:SobolPixel).


def sobol_sample_bytes(spp: int) -> int:
    """Bytes of the sample index that samples 0 .. spp - 1 use (at least
    one)."""
    return max(1, -(-max(int(spp) - 1, 0).bit_length() // 8))


def sobol_p_tables(log2_scale: int, n_bytes: int, device="cpu") -> torch.Tensor:
    """(2, n_bytes, 256) int64 u32 values: entry [d, k, b] is P_d(b << 8k),
    for dimensions 0 and 1."""
    byte = torch.arange(256, dtype=torch.int64, device=device)
    zero = torch.zeros_like(byte)
    return torch.stack([
        torch.stack([sobol_pixel_u32(log2_scale, byte << (8 * k), zero, zero, d)
                     for k in range(n_bytes)])
        for d in (0, 1)
    ])


def sobol_p(tables: torch.Tensor, sample_idx) -> torch.Tensor:
    """(2, N) P_d of u32 sample indices below 2^(8 n_bytes): one table
    entry per byte of the index, XORed."""
    s = torch.as_tensor(sample_idx).to(torch.int64) & U32_MASK
    n_bytes = tables.shape[1]
    if bool((s >> (8 * n_bytes)).any()):
        raise ValueError(f"a sample index needs more than the tables' {n_bytes} bytes")
    v = torch.zeros((2,) + tuple(s.shape), dtype=torch.int64, device=s.device)
    for k in range(n_bytes):
        v = v ^ tables[:, k][:, (s >> (8 * k)) & 0xFF]
    return v


def sobol_q(log2_scale: int, px, py) -> torch.Tensor:
    """(2, N) Q_d of pixels (px, py): the pixel part, once per pixel."""
    px = torch.as_tensor(px).to(torch.int64)
    zero = torch.zeros_like(px)
    return torch.stack([sobol_pixel_u32(log2_scale, zero, px, py, d) for d in (0, 1)])


def sobol_pixel_u32_factored(tables, log2_scale: int, sample_idx, px, py) -> torch.Tensor:
    """(2, N) u32 of dimensions 0 and 1, as P_d(s) ^ Q_d(px, py): bitwise
    ``sobol_pixel_u32`` of each dimension."""
    return sobol_p(tables, sample_idx) ^ sobol_q(log2_scale, px, py)


def ceil_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p
