"""Geometry, shading, material, light-PDF and camera functions of the
PyTorch port against the JAX package, on the same numpy inputs.

Tolerance rtol=1e-5, atol=1e-6: both sides compute in float32 with the
same operation order, but the two frameworks' sqrt, rsqrt and
transcendental kernels may round a last bit differently.  Hit kinds and
indices must be equal except where the two ``t`` are within tolerance of
each other (a tie decided by that last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu import materials as jmat
from zig_weekend_raytracer_tpu.geometry import quad as jquad
from zig_weekend_raytracer_tpu.geometry import sphere as jsph
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops import shade as jshade
from zig_weekend_raytracer_tpu.ops.trace import _closest_hit_brute
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.render import pdfs as jpdfs
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch import materials as tmat
from zig_weekend_raytracer_tpu_torch.geometry import quad as tquad
from zig_weekend_raytracer_tpu_torch.geometry import sphere as tsph
from zig_weekend_raytracer_tpu_torch.math.v3 import V3 as TV3
from zig_weekend_raytracer_tpu_torch.ops import shade as tshade
from zig_weekend_raytracer_tpu_torch.ops.trace import Hit as THit
from zig_weekend_raytracer_tpu_torch.ops.trace import closest_hit
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import pdfs as tpdfs

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _v3(a):
    """(N, 3) float32 numpy -> (JAX V3, torch V3)."""
    a = np.asarray(a, np.float32)
    return (
        JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
        TV3(*(torch.from_numpy(a[:, i].copy()) for i in range(3))),
    )


def _close(j, t):
    if isinstance(t, tuple):
        for a, b in zip(j, t):
            _close(a, b)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def cornell():
    return zj.models.load_scene("cornell_box"), zt.models.load_scene("cornell_box", device="cpu")


def _rays(seed, n=N):
    """Rays from inside the Cornell box in random directions."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return rng, _v3(org), _v3(d)


def test_sphere_hit_t():
    rng, (oj, ot), (dj, dt) = _rays(0)
    center_j, center_t = JV3(190.0, 90.0, 190.0), TV3(190.0, 90.0, 190.0)
    t_j, v_j = jsph.hit_t(center_j, np.float32(90.0), oj, dj, np.float32(1e-3), jnp.inf)
    t_t, v_t = tsph.hit_t(center_t, 90.0, ot, dt, 1e-3, float("inf"))
    np.testing.assert_array_equal(np.asarray(v_j), v_t.numpy())
    _close(t_j, t_t)


def test_quad_hit_t():
    rng, (oj, ot), (dj, dt) = _rays(1)
    start, eu, ev = np.array([0.0, 0, 0]), np.array([555.0, 0, 0]), np.array([0.0, 0, 555])
    n_raw = np.cross(eu, ev)
    nn = float(n_raw @ n_raw)
    nrm, w = n_raw / np.sqrt(nn), n_raw / nn
    off = float(nrm @ start)
    f = lambda a: np.asarray(a, np.float32)
    jv = lambda a: JV3(*(jnp.asarray(x) for x in f(a)))
    tv = lambda a: TV3(*(float(x) for x in f(a)))
    out_j = jquad.hit_t(jv(start), jv(nrm), jv(w), jv(eu), jv(ev), np.float32(off),
                        oj, dj, np.float32(1e-3), jnp.inf)
    out_t = tquad.hit_t(tv(start), tv(nrm), tv(w), tv(eu), tv(ev), float(np.float32(off)),
                        ot, dt, 1e-3, float("inf"))
    np.testing.assert_array_equal(np.asarray(out_j[3]), out_t[3].numpy())
    _close(out_j[:3], out_t[:3])


def test_closest_hit_brute(cornell):
    sj, st = cornell
    rng, (oj, ot), (dj, dt) = _rays(2)
    time = rng.uniform(0, 1, N).astype(np.float32)
    hj = _closest_hit_brute(sj.compiled, oj, dj, jnp.asarray(time), np.float32(1e-3), jnp.inf)
    ht = closest_hit(st.compiled, ot, dt, torch.from_numpy(time), 1e-3, float("inf"))
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    np.testing.assert_array_equal(np.isfinite(tj), np.isfinite(tt))
    fin = np.isfinite(tj)
    np.testing.assert_allclose(tt[fin], tj[fin], rtol=RTOL, atol=ATOL)
    same = (np.asarray(hj.kind) == ht.kind.numpy()) & (np.asarray(hj.idx) == ht.idx.numpy())
    # a disagreement is only allowed as a tie within tolerance
    assert same.mean() > 0.99
    assert np.all(same | np.isclose(tt, tj, rtol=RTOL, atol=ATOL))


def test_shade_attrs(cornell):
    sj, st = cornell
    rng, (oj, ot), (dj, dt) = _rays(3)
    hj = _closest_hit_brute(sj.compiled, oj, dj, jnp.zeros(N), np.float32(1e-3), jnp.inf)
    ht = THit(*(torch.from_numpy(np.array(x)) for x in hj))
    aj = jshade.shade_attrs(sj.compiled, hj, oj, dj, jnp.zeros(N))
    at = tshade.shade_attrs(st.compiled, ht, ot, dt, torch.zeros(N))
    hit = np.asarray(hj.kind) >= 0
    for f in ("mat_type", "tex_kind", "front"):
        np.testing.assert_array_equal(np.asarray(getattr(aj, f))[hit], getattr(at, f).numpy()[hit])
    for f in ("point", "normal", "rgb", "rgb2"):
        for cj, ct in zip(getattr(aj, f), getattr(at, f)):
            np.testing.assert_allclose(ct.numpy()[hit], np.asarray(cj)[hit], rtol=RTOL, atol=ATOL)
    for f in ("u", "v", "inv_scale", "fuzz", "refract"):
        np.testing.assert_allclose(
            getattr(at, f).numpy()[hit], np.asarray(getattr(aj, f))[hit], rtol=RTOL, atol=ATOL
        )


def test_materials():
    rng = np.random.default_rng(4)
    (nj, nt), (dj, dt) = _v3(rng.normal(size=(N, 3))), _v3(rng.normal(size=(N, 3)))
    unit = np.asarray(jnp.stack(list(nj), 1))
    unit = unit / np.linalg.norm(unit, axis=1, keepdims=True)
    (nj, nt) = _v3(unit)
    mt = rng.integers(0, 5, N).astype(np.int32)
    _close(jmat.scattering_pdf(jnp.asarray(mt), nj, dj),
           tmat.scattering_pdf(torch.from_numpy(mt), nt, dt))
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    ri = rng.uniform(1.0, 2.5, N).astype(np.float32)
    _close(jmat.schlick_reflectance(jnp.asarray(cos), jnp.asarray(ri)),
           tmat.schlick_reflectance(torch.from_numpy(cos), torch.from_numpy(ri)))


def test_light_pdf_and_sample(cornell):
    sj, st = cornell
    rng, (oj, ot), (dj, dt) = _rays(5)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    _close(jpdfs.light_pdf_value(sj.compiled, oj, dj),
           tpdfs.light_pdf_value(st.compiled, ot, dt))
    _close(
        jpdfs.sample_light_direction(sj.compiled, oj, *(jnp.asarray(x) for x in u)),
        tpdfs.sample_light_direction(st.compiled, ot, *(torch.from_numpy(x) for x in u)),
    )


@pytest.mark.parametrize("sampler", ["sobol", "independent", "stratified"])
def test_generate_rays(cornell, sampler):
    sj, st = cornell
    w, h, spp = 40, 30, 16
    rng = np.random.default_rng(6)
    px = rng.integers(0, w, N).astype(np.int32)
    py = rng.integers(0, h, N).astype(np.int32)
    s = rng.integers(0, spp, N).astype(np.int32)
    rid = ((s.astype(np.uint64) * h + py) * w + px).astype(np.uint32)
    cj = jcam.camera_params(sj.camera, w, h)
    ct = tcam.camera_params(st.camera, w, h)
    assert tcam.camera_consts(st.camera, w, h) == jcam.camera_consts(sj.camera, w, h)
    out_j = jcam.generate_rays(cj, False, JKind(sampler), jnp.uint32(0), jnp.asarray(rid),
                               jnp.asarray(px), jnp.asarray(py), jnp.asarray(s), spp, w, h)
    T = lambda a: torch.from_numpy(a.astype(np.int64))
    out_t = tcam.generate_rays(ct, False, zt.sampling.SamplerKind(sampler), 0, T(rid),
                               T(px), T(py), T(s), spp, w, h)
    _close(out_j, out_t)


def test_camera_viewport_with_raster_shift():
    import dataclasses

    cam_j = zj.models.load_scene("cornell_box").camera
    cam_t = zt.models.load_scene("cornell_box", device="cpu").camera
    cam_j = dataclasses.replace(cam_j, raster_shift=(0.5, 0.5))
    cam_t = dataclasses.replace(cam_t, raster_shift=(0.5, 0.5))
    for a, b in zip(cam_j.viewport(64, 48), cam_t.viewport(64, 48)):
        np.testing.assert_array_equal(a, b)
