"""The factored Sobol pixel sampler of the render and bounce kernels'
respawn (``sampling/sobol.py``: ``sobol_p_tables``, ``sobol_p``,
``sobol_q``, ``sobol_pixel_u32_factored``), bitwise against the bit loops
(``sobol_interval_to_index`` + ``sobol_sample_u32``) and against the JAX
package's sampler u32s.

  1. P_d(s) ^ Q_d(px, py) equals the direct u32 for every pixel-space scale
     L in 0..10, random pixels of a 2^L image and samples up to 2^20.
  2. The same u32s against the JAX package's ``sobol_interval_to_index`` +
     ``sobol_sample_u32`` ((hi, lo) u32 index pairs).
  3. The tables: P is linear (a table entry per byte), the kernels' int32
     upload (``ops/fused_render.py:sobol_p_table``) holds the same bits, and
     the bytes a launch stages in shared memory stay within 8 KB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_weekend_raytracer_tpu.sampling import sobol as jsob
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.sampling import sobol as tsob
from zig_weekend_raytracer_tpu_torch.sampling.sampler import SamplerKind

N = 3000
MAX_SAMPLE = 1 << 20


def _inputs(log2_scale, seed, n=N):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, MAX_SAMPLE, n)
    s[:4] = (0, 1, MAX_SAMPLE - 1, 255)
    px = rng.integers(0, 1 << log2_scale, n)
    py = rng.integers(0, 1 << log2_scale, n)
    return s, px, py


def _direct(log2_scale, s, px, py):
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    return torch.stack([tsob.sobol_pixel_u32(log2_scale, t(s), t(px), t(py), d) for d in (0, 1)])


@pytest.mark.parametrize("log2_scale", range(11))
def test_factored_equals_the_bit_loops(log2_scale):
    s, px, py = _inputs(log2_scale, log2_scale)
    tables = tsob.sobol_p_tables(log2_scale, tsob.sobol_sample_bytes(MAX_SAMPLE))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    got = tsob.sobol_pixel_u32_factored(tables, log2_scale, t(s), t(px), t(py))
    assert torch.equal(got, _direct(log2_scale, s, px, py))
    # the pixel part alone is the u32 of sample 0; Q vanishes when L = 0
    q = tsob.sobol_q(log2_scale, t(px), t(py))
    assert torch.equal(q, _direct(log2_scale, np.zeros_like(s), px, py))
    if log2_scale == 0:
        assert not q.any()


@pytest.mark.parametrize("log2_scale", [0, 1, 5, 9, 10])
def test_factored_equals_the_jax_sampler(log2_scale):
    s, px, py = _inputs(log2_scale, 100 + log2_scale, 1000)
    u32 = lambda a: jnp.asarray(np.asarray(a, np.uint32))
    hi, lo = jsob.sobol_interval_to_index(log2_scale, u32(s), u32(px), u32(py))
    want = np.stack([np.asarray(jsob.sobol_sample_u32(hi, lo, d)).astype(np.int64)
                     for d in (0, 1)])
    tables = tsob.sobol_p_tables(log2_scale, 3)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    got = tsob.sobol_pixel_u32_factored(tables, log2_scale, t(s), t(px), t(py))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_part_is_one_entry_per_byte():
    tables = tsob.sobol_p_tables(9, 3)
    assert tables.shape == (2, 3, 256) and not tables[:, :, 0].any()
    s = torch.tensor([0x0A0B0C, 0x000001, 0x010000])
    want = tables[:, 0, 0x0C] ^ tables[:, 1, 0x0B] ^ tables[:, 2, 0x0A]
    assert torch.equal(tsob.sobol_p(tables, s)[:, 0], want)
    zero = torch.zeros(3, dtype=torch.int64)
    assert torch.equal(tsob.sobol_p(tables, s), _direct(9, s.numpy(), zero.numpy(), zero.numpy()))
    with pytest.raises(ValueError, match="3 bytes"):
        tsob.sobol_p(tables, torch.tensor([1 << 24]))


@pytest.mark.parametrize("spp,n_bytes", [(1, 1), (2, 1), (256, 1), (257, 2), (1024, 2),
                                         (65536, 2), (65537, 3), (1 << 24, 3), (1 << 32, 4)])
def test_sample_bytes(spp, n_bytes):
    assert tsob.sobol_sample_bytes(spp) == n_bytes
    # both dimensions' tables in shared memory: at most 8 KB
    smem = fused_render.sobol_smem_bytes(SamplerKind.SOBOL, spp)
    assert smem == 2 * n_bytes * 256 * 4 <= 8192
    assert fused_render.sobol_smem_bytes(SamplerKind.STRATIFIED, spp) == 0


def test_kernel_upload_holds_the_same_bits():
    fused_render.sobol_p_table.cache_clear()
    up = fused_render.sobol_p_table(torch.device("cpu"), 9, 2)
    assert up.dtype == torch.int32 and up.shape == (2 * 2 * 256,)
    want = tsob.sobol_p_tables(9, 2).reshape(-1)
    assert torch.equal(up.to(torch.int64) & 0xFFFFFFFF, want)
