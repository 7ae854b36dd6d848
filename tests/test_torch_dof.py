"""Depth of field in the PyTorch port against the JAX package.

  * ``gauss2``: its uniform draws are bitwise JAX's (PCG4D); the normals
    agree within rtol 1e-6, because XLA's CPU log, sin and cos and torch's
    round differently in the last bits (at most 3 ulp seen here).
  * ``unit_disk_xy``: bitwise JAX's wherever torch's CPU sqrt is correctly
    rounded.  XLA's CPU sqrt always is (test_sqrt_rounding_witness); torch's
    CPU sqrt misses by one ulp on under 1% of inputs, and there the disk
    point moves by at most 2 ulp.  On the card both torch.sqrt and the
    kernel's sqrtf are correctly rounded.
  * camera rays of balls' lens (defocus angle 0.6 degrees) within the rtol
    1e-5 / atol 1e-6 of test_torch_geometry.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.sampling import hashrng as jrng
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.sampling import hashrng as trng

N = 4096


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed,stream", [(0, 5), (7, 5), (0xDEADBEEF, 13)])
def test_gauss2_matches_jax(seed, stream):
    rid = _ids(seed)
    rid_t = torch.from_numpy(rid.astype(np.int64))
    uj = jrng.uniform4(jnp.uint32(seed), jnp.asarray(rid), stream)
    ut = trng.uniform4(seed, rid_t, stream)
    for j, t in zip(uj[:2], ut[:2]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    gj = jrng.gauss2(jnp.uint32(seed), jnp.asarray(rid), stream)
    gt = trng.gauss2(seed, rid_t, stream)
    for j, t in zip(gj, gt):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_sqrt_rounding_witness():
    """XLA's CPU sqrt is correctly rounded; torch's CPU sqrt is not always.
    float64 sqrt rounded to float32 is the correctly rounded result."""
    x = np.random.default_rng(2).uniform(0, 10, N).astype(np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), exact)
    off = torch.sqrt(torch.from_numpy(x)).numpy() != exact
    assert off.mean() < 0.02
    assert (_ulps(torch.sqrt(torch.from_numpy(x)).numpy(), exact) <= 1).all()


def test_unit_disk_xy_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.uniform(0, 1, N).astype(np.float32)
    g = rng.normal(size=(2, N)).astype(np.float32)
    g[:, :4] = 0.0  # the clamp of the norm
    gx, gy = (torch.from_numpy(c) for c in g)
    dj = jrng.unit_disk_xy(jnp.asarray(u), jnp.asarray(g[0]), jnp.asarray(g[1]))
    dt = trng.unit_disk_xy(torch.from_numpy(u), gx, gy)
    n2 = torch.clamp(gx * gx + gy * gy, min=1e-24).numpy()
    exact_sqrt = torch.sqrt(torch.from_numpy(n2)).numpy() == np.sqrt(n2.astype(np.float64)).astype(np.float32)
    assert exact_sqrt.mean() > 0.98
    for j, t in zip(dj, dt):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(t[exact_sqrt], j[exact_sqrt])
        assert (_ulps(t, j) <= 2).all()
    assert (np.hypot(dt[0].numpy(), dt[1].numpy()) <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("sampler", ["sobol", "independent"])
def test_generate_rays_with_dof(sampler):
    sj, st = zj.models.load_scene("balls"), zt.models.load_scene("balls", device="cpu")
    assert st.camera.has_depth_of_field
    w, h, spp = 40, 30, 16
    rng = np.random.default_rng(6)
    px = rng.integers(0, w, N).astype(np.int32)
    py = rng.integers(0, h, N).astype(np.int32)
    s = rng.integers(0, spp, N).astype(np.int32)
    rid = ((s.astype(np.uint64) * h + py) * w + px).astype(np.uint32)
    consts = tcam.camera_consts(st.camera, w, h)
    f32 = lambda c: np.asarray(c, np.float64).astype(np.float32)
    np.testing.assert_array_equal(f32(consts), f32(jcam.camera_consts(sj.camera, w, h)))
    assert any(c != 0.0 for c in consts[4])  # a real lens
    out_j = jcam.generate_rays(
        jcam.camera_params(sj.camera, w, h), True, JKind(sampler), jnp.uint32(0),
        jnp.asarray(rid), jnp.asarray(px), jnp.asarray(py), jnp.asarray(s), spp, w, h,
    )
    T = lambda a: torch.from_numpy(a.astype(np.int64))
    out_t = tcam.generate_rays(
        tcam.camera_params(st.camera, w, h), True, zt.sampling.SamplerKind(sampler), 0,
        T(rid), T(px), T(py), T(s), spp, w, h,
    )
    for vj, vt in zip(out_j[:2], out_t[:2]):
        for cj, ct in zip(vj, vt):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    # the origins spread over the lens
    assert out_t[0].x.std() > 0
