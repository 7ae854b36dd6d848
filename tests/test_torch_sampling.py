"""Integer streams of the PyTorch port, bitwise against the JAX package:
PCG4D draws, Sobol / Owen samples (sample indices above 2^32 included),
pixel offsets of all three samplers, and ray ids.

The JAX side carries a u64 Sobol index as (hi, lo) u32 arrays; the port as
one int64 tensor holding the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_weekend_raytracer_tpu.render import renderer as jr
from zig_weekend_raytracer_tpu.sampling import hashrng as jh
from zig_weekend_raytracer_tpu.sampling import sampler as js
from zig_weekend_raytracer_tpu.sampling import sobol as jsob
from zig_weekend_raytracer_tpu_torch.render import renderer as tr
from zig_weekend_raytracer_tpu_torch.sampling import hashrng as th
from zig_weekend_raytracer_tpu_torch.sampling import sampler as ts
from zig_weekend_raytracer_tpu_torch.sampling import sobol as tsob

N = 4096


def _u32(rng, n=N):
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy u32/i32 -> int64 tensor (the port's u32 carrier)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(j, t):
    np.testing.assert_array_equal(
        np.asarray(j).astype(np.int64), t.numpy().astype(np.int64)
    )


def test_pcg4d_bitwise():
    rng = np.random.default_rng(0)
    a, b, c, d = (_u32(rng) for _ in range(4))
    out_j = jh.pcg4d(*(jnp.asarray(x) for x in (a, b, c, d)))
    out_t = th.pcg4d(*(_t(x) for x in (a, b, c, d)))
    for j, t in zip(out_j, out_t):
        _eq(j, t)


@pytest.mark.parametrize("seed,stream", [(0, 0), (7, 9), (0xFFFFFFFF, 45)])
def test_uniform4_bitwise(seed, stream):
    rng = np.random.default_rng(1)
    rid = _u32(rng)
    out_j = jh.uniform4(jnp.uint32(seed), jnp.asarray(rid), stream)
    out_t = th.uniform4(seed, _t(rid), stream)
    for j, t in zip(out_j, out_t):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_owen_scramble_and_murmur_bitwise():
    rng = np.random.default_rng(2)
    v = _u32(rng)
    for dim in (2, 3, 17, 1023):
        for seed in (0, 5, 0xDEADBEEF):
            h_j = int(jsob.murmur2_32(jnp.uint32(dim), seed))
            h_t = tsob.murmur2_32(dim, seed)
            assert h_j == h_t
            _eq(jsob.owen_fast_scramble(jnp.asarray(v), h_j),
                tsob.owen_fast_scramble(_t(v), h_t))


@pytest.mark.parametrize("log2_scale", [0, 3, 9, 16])
def test_sobol_interval_to_index_bitwise(log2_scale):
    rng = np.random.default_rng(3 + log2_scale)
    side = 1 << log2_scale
    sample = rng.integers(0, 2**28, N).astype(np.uint32)
    px = rng.integers(0, side, N).astype(np.uint32)
    py = rng.integers(0, side, N).astype(np.uint32)
    hi, lo = jsob.sobol_interval_to_index(
        log2_scale, jnp.asarray(sample), jnp.asarray(px), jnp.asarray(py)
    )
    idx = tsob.sobol_interval_to_index(log2_scale, _t(sample), _t(px), _t(py))
    _eq(hi, (idx >> 32) & 0xFFFFFFFF)
    _eq(lo, idx & 0xFFFFFFFF)


@pytest.mark.parametrize("dim", [0, 1, 2, 5, 600])
def test_sobol_sample_bitwise_above_2_32(dim):
    rng = np.random.default_rng(10 + dim)
    # indices up to 2^52 (the matrix width): hi words are nonzero
    idx = rng.integers(0, 2**52, N, dtype=np.int64)
    idx[:4] = [0, 2**32 - 1, 2**32, 2**52 - 1]
    hi = jnp.asarray((idx >> 32).astype(np.uint32))
    lo = jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32))
    it = torch.from_numpy(idx)
    _eq(jsob.sobol_sample_u32(hi, lo, dim), tsob.sobol_sample_u32(it, dim))
    seed = int(jsob.murmur2_32(jnp.uint32(dim), 0))
    np.testing.assert_array_equal(
        np.asarray(jsob.sobol_sample(hi, lo, dim, scramble_seed=seed)),
        tsob.sobol_sample(it, dim, scramble_seed=seed).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(js.sample_dimension(hi, lo, dim, 3)),
        ts.sample_dimension(it, dim, 3).numpy(),
    )


@pytest.mark.parametrize("kind", list(js.SamplerKind))
@pytest.mark.parametrize("width,height,spp", [(16, 16, 4), (400, 400, 1024), (37, 23, 9)])
def test_pixel_offsets_bitwise(kind, width, height, spp):
    rng = np.random.default_rng(width * 7 + spp)
    px = rng.integers(0, width, N).astype(np.int32)
    py = rng.integers(0, height, N).astype(np.int32)
    sample = rng.integers(0, spp, N).astype(np.int32)
    rid = ((sample.astype(np.uint64) * height + py) * width + px).astype(np.uint32)
    ox_j, oy_j = js.pixel_offsets(
        kind, jnp.uint32(3), jnp.asarray(rid), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(sample), spp, width, height,
    )
    ox_t, oy_t = ts.pixel_offsets(
        ts.SamplerKind(kind.value), 3, _t(rid), _t(px), _t(py), _t(sample),
        spp, width, height,
    )
    np.testing.assert_array_equal(np.asarray(ox_j), ox_t.numpy())
    np.testing.assert_array_equal(np.asarray(oy_j), oy_t.numpy())


@pytest.mark.parametrize(
    "width,height,band_y0,band_rows,sample0,spp_chunk",
    [(16, 16, 0, 16, 0, 2), (70, 50, 8, 40, 3, 2), (400, 400, 0, 400, 0, 1)],
)
def test_ray_grid_bitwise(width, height, band_y0, band_rows, sample0, spp_chunk):
    tile = jr.pick_tile(width, band_rows)
    assert tile == tr.pick_tile(width, band_rows)
    out_j = jr.ray_grid(width, height, band_y0, band_rows, sample0, spp_chunk, tile)
    out_t = tr.ray_grid(width, height, band_y0, band_rows, sample0, spp_chunk, tile)
    for j, t in zip(out_j, out_t):
        _eq(j, t)
    np.testing.assert_array_equal(
        jr.tile_order_lane_index(width, band_rows, tile),
        tr.tile_order_lane_index(width, band_rows, tile),
    )


def test_sobol_data_is_the_ports_own_copy():
    """The port reads its own copy of the direction numbers, inside its
    package, and every array equals the JAX package's."""
    import os

    import zig_weekend_raytracer_tpu_torch as pkg

    assert os.path.dirname(tsob.SOBOL_DATA_PATH) == os.path.join(
        os.path.dirname(pkg.__file__), "sampling"
    )
    with np.load(tsob.SOBOL_DATA_PATH) as t, np.load(jsob.__file__.replace("sobol.py", "sobol_data.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
