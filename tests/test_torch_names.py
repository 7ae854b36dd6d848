"""The JAX package's last public names in the PyTorch port, against the JAX
package: ``materials.emitted`` and ``materials.is_specular``,
``math/v3.length_squared``, ``length`` and ``lerp``, ``V3.of`` and
``V3.from_array``, and ``CompiledScene.n_lights``.

The port's integrator and kernels inline emission and the specular test;
these names are the public helpers the JAX package exports beside them.
The checks mirror tests/test_materials.py:62 and tests/test_math.py:40,
:65 and :78, then hold ``emitted`` to JAX's on the same seeded hits of a
solid light (front and back faces, every material of cornell_box) and of an
image-textured lamp, and ``n_lights`` to JAX's on all six scenes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu import materials as jmat
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu_torch import materials
from zig_weekend_raytracer_tpu_torch.math import v3
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
)

SCENES = ("balls", "shrek_quads", "emissive", "cornell_box", "rtw_final", "earth")


def sv(x, y, z):
    """Single-lane V3 (shape (1,))."""
    return V3(*(torch.tensor([c], dtype=torch.float32) for c in (x, y, z)))


def as_np(v: V3) -> np.ndarray:
    return v.to_array().numpy()[0]


# ---- tests/test_materials.py:62 and tests/test_math.py:40, :65, :78 ----

def test_is_specular():
    codes = torch.tensor([MAT_LAMBERTIAN, MAT_ISOTROPIC, MAT_METAL, MAT_DIELECTRIC,
                          MAT_DIFFUSE_LIGHT])
    np.testing.assert_array_equal(materials.is_specular(codes).numpy(),
                                  [False, False, True, True, False])
    np.testing.assert_array_equal(
        materials.is_specular(codes).numpy(), np.asarray(jmat.is_specular(jnp.asarray(codes))))


def test_length():
    assert float(v3.length(sv(1, 1, 1))[0]) == pytest.approx(np.sqrt(3.0))
    assert float(v3.length_squared(sv(1, 2, 3))[0]) == 14.0
    n = v3.normalize(sv(1, 2, 3))
    assert float(v3.length(n)[0]) == pytest.approx(1.0, rel=1e-5)


def test_lerp():
    out = v3.lerp(sv(0, 0, 0), sv(2, 4, 6), 0.5)
    np.testing.assert_allclose(as_np(out), [1, 2, 3], atol=1e-6)


def test_array_roundtrip():
    a = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    v = V3.from_array(a)
    assert v.shape == (2,)
    np.testing.assert_array_equal(v.to_array().numpy(), a.numpy())
    o = V3.of(1.0, 2.0, 3.0)
    assert all(torch.is_tensor(c) and c.dtype == torch.float32 for c in o)
    np.testing.assert_array_equal(torch.stack(list(o)).numpy(), [1.0, 2.0, 3.0])


def test_vector_names_match_jax():
    rng = np.random.default_rng(11)
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    t = rng.uniform(size=64).astype(np.float32)
    ta, tb = V3.from_array(torch.from_numpy(a)), V3.from_array(torch.from_numpy(b))
    ja, jb = JV3.from_array(jnp.asarray(a)), JV3.from_array(jnp.asarray(b))
    for got, want in ((v3.length_squared(ta), zj.math.v3.length_squared(ja)),
                      (v3.length(ta), zj.math.v3.length(ja))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(v3.lerp(ta, tb, torch.from_numpy(t)).to_array().numpy(),
                               np.asarray(zj.math.v3.lerp(ja, jb, jnp.asarray(t)).to_array()),
                               rtol=1e-6, atol=1e-7)


# ---- emitted ----

def _image_lamp(mod):
    """tests/test_torch_texlut.py's image lamp: a quad lamp textured with a
    4x4 two-colour image over a gray floor."""
    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = (200, 40, 40)
    img[1::2, 1::2] = (40, 200, 40)
    b = mod.scene.SceneBuilder()
    m_lamp = b.diffuse_light(b.image_texture(img))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), m_gray))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), m_lamp))
    b.set_camera(mod.scene.Camera(look_from=(0, 2, 8), look_at=(0, 1, 0)))
    return b


def _emitted_both(cs_t, cs_j, mat_id, front, u, v, p):
    """The port's and JAX's ``emitted`` on the same hits, as (N, 3) arrays."""
    got = materials.emitted(
        cs_t, cs_t.mat_type[torch.from_numpy(mat_id).long()], torch.from_numpy(mat_id),
        torch.from_numpy(front), torch.from_numpy(u), torch.from_numpy(v),
        V3.from_array(torch.from_numpy(p)))
    jid = jnp.asarray(mat_id)
    want = jmat.emitted(cs_j, cs_j.mat_type[jid], jid, jnp.asarray(front), jnp.asarray(u),
                        jnp.asarray(v), JV3.from_array(jnp.asarray(p)))
    return got.to_array().numpy(), np.asarray(want.to_array())


def _hits(rng, n, n_mats):
    mat_id = rng.integers(0, n_mats, n).astype(np.int32)
    front = rng.integers(0, 2, n).astype(bool)
    u, v = (rng.uniform(-0.1, 1.1, n).astype(np.float32) for _ in range(2))
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    return mat_id, front, u, v, p


def test_emitted_solid_light_front_and_back():
    cs_t = zt.models.load_scene("cornell_box", device="cpu").compiled
    cs_j = zj.models.load_scene("cornell_box").compiled
    n_mats = cs_t.mat_type.shape[0]
    mat_id, front, u, v, p = _hits(np.random.default_rng(5), 256, n_mats)
    got, want = _emitted_both(cs_t, cs_j, mat_id, front, u, v, p)
    np.testing.assert_array_equal(got, want)
    light = cs_t.mat_type.numpy()[mat_id] == MAT_DIFFUSE_LIGHT
    assert (light & front).any() and (light & ~front).any() and (~light).any()
    assert (got[light & front] > 0).all()
    assert (got[~(light & front)] == 0).all()  # back faces and other materials


def test_emitted_image_lamp():
    cs_t = _image_lamp(zt).compile(device="cpu").compiled
    cs_j = _image_lamp(zj).compile().compiled
    lamp = int(np.flatnonzero(cs_t.mat_type.numpy() == MAT_DIFFUSE_LIGHT)[0])
    rng = np.random.default_rng(6)
    _, front, u, v, p = _hits(rng, 256, 1)
    mat_id = np.full(256, lamp, np.int32)
    got, want = _emitted_both(cs_t, cs_j, mat_id, front, u, v, p)
    np.testing.assert_array_equal(got, want)
    lit = got[front]
    assert (got[~front] == 0).all()
    # both texel colours, gamma-2 linear
    assert {tuple(np.round(c, 6)) for c in lit} >= {
        tuple(np.round(np.float32([200, 40, 40]) ** 2 / 255.0 ** 2, 6)),
        tuple(np.round(np.float32([40, 200, 40]) ** 2 / 255.0 ** 2, 6))}


@pytest.mark.parametrize("name", SCENES)
def test_n_lights_matches_jax(name):
    cs_t = zt.models.load_scene(name, device="cpu").compiled
    n = zj.models.load_scene(name).compiled.n_lights
    assert cs_t.n_lights == n == len(cs_t.lights)
    assert cs_t.has_lights == (n > 0)
