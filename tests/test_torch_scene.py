"""Scene compilation of the PyTorch port against the JAX package.

Both builds are host numpy, so every table must be equal exactly, field by
field, the image atlas included; ``compiled_from_arrays`` of the JAX
scene's tables must give the same scene.  Features of later slices (nested
checkers, the unified tree) raise NotImplementedError.  Group trees are held to JAX's in test_torch_bvh.py
and, for the image scenes, here."""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_bvh import assert_same_trees
from zig_weekend_raytracer_tpu_torch.scene import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    V3_FIELDS,
    SceneBuilder,
    compiled_from_arrays,
)


def _np(value):
    if isinstance(value, tuple):
        return np.stack([_np(v) for v in value])
    return value.cpu().numpy()


def _assert_same(cs_t, cs_j):
    for f in ARRAY_FIELDS:
        got, want = _np(getattr(cs_t, f)), np.asarray(getattr(cs_j, f))
        if want.dtype == np.uint32:  # the atlas: int32 in the port
            got = got.view(np.uint32)
        assert got.shape == want.shape, f
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(cs_t, f) == getattr(cs_j, f), f


@pytest.fixture(scope="module")
def cornell_j():
    return zj.models.load_scene("cornell_box")


def test_cornell_tables_equal_jax(cornell_j):
    st = zt.models.load_scene("cornell_box", device="cpu")
    _assert_same(st.compiled, cornell_j.compiled)
    assert st.camera == zt.scene.Camera(**cornell_j.camera.__dict__)
    assert st.compiled.device == torch.device("cpu")


def test_compiled_from_arrays_of_jax_tables(cornell_j):
    cs = cornell_j.compiled
    fields = {f: np.asarray(getattr(cs, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(cs, f) for f in STATIC_FIELDS + ("has_bvh", "has_image_textures")}
    got = compiled_from_arrays(fields, static, "cpu")
    _assert_same(got, cs)
    for f in V3_FIELDS:
        assert all(c.dtype == torch.float32 for c in getattr(got, f)), f


def test_compiled_from_arrays_refuses_later_slices(cornell_j):
    cs = cornell_j.compiled
    fields = {f: np.asarray(getattr(cs, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(cs, f) for f in STATIC_FIELDS}
    for flag in ("has_uni_tree", "has_nested_checker"):
        with pytest.raises(NotImplementedError, match="slice"):
            compiled_from_arrays(fields, {**static, flag: True}, "cpu")
    # image emitters are this slice's: the flag is carried
    assert compiled_from_arrays(fields, {**static, "has_emissive_image": True},
                                "cpu").has_emissive_image
    # the binary BVH flag is accepted: the port walks the group trees
    assert not compiled_from_arrays(fields, {**static, "has_bvh": True}, "cpu").has_sph_tree


@pytest.mark.parametrize("name", ["emissive"])
def test_later_scenes_raise(name):
    """emissive was the last scene of a later slice: it loads now, by name
    or SceneType, and an unknown scene raises."""
    assert zt.models.load_scene(name, device="cpu").name == name
    assert zt.models.load_scene(zt.models.SceneType(name), device="cpu").name == name
    with pytest.raises(ValueError, match="unknown scene"):
        zt.models.load_scene("bogus", device="cpu")


@pytest.mark.parametrize("name", ["earth", "shrek_quads", "rtw_final"])
def test_image_scene_tables_equal_jax(name):
    """Every table of an image scene, at the suite's leaf span: the atlas
    and its image dims, the shade records with their image columns, both
    group trees and the light geometry."""
    st, sj = zt.models.load_scene(name, device="cpu"), zj.models.load_scene(name)
    _assert_same(st.compiled, sj.compiled)
    assert_same_trees(st.compiled, sj.compiled)
    assert st.compiled.has_image_textures and sj.compiled.has_image_textures
    assert st.camera == zt.scene.Camera(**sj.camera.__dict__)


def test_image_scene_from_jax_arrays():
    """compiled_from_arrays takes the JAX scene's atlas fields."""
    cs = zj.models.load_scene("shrek_quads").compiled
    fields = {f: np.asarray(getattr(cs, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(cs, f) for f in STATIC_FIELDS}
    got = compiled_from_arrays(fields, static, "cpu")
    _assert_same(got, cs)
    assert got.atlas_packed.dtype == torch.int32 and got.image_dims == ((300, 292),)


def test_default_device_is_the_card():
    """load_scene and compile default to CUDA: without a GPU they raise
    rather than build on the CPU; device="cpu" builds there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py builds on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zt.models.load_scene("rtw_final")
    b = SceneBuilder()
    b.add(b.sphere((0, 0, 0), 1.0, b.lambertian(b.solid_color((0.5, 0.5, 0.5)))))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.compile()
    assert b.compile(device="cpu").compiled.device == torch.device("cpu")


def test_builder_refuses_images_and_trees(monkeypatch):
    """Images build into the atlas and image emitters compile, while
    nested checkers raise (a later slice); use_bvh builds group trees from
    TREE_MIN_PRIMS primitives of a kind on, and the unified tree (K4)
    raises."""
    for nested in (False, True):
        b = SceneBuilder()
        img = b.image_texture(np.zeros((2, 2, 3), np.uint8))
        solid = b.solid_color((0.5, 0.5, 0.5))
        tex = b.checkerboard(1.0, b.checkerboard(1.0, solid, img), solid) if nested else img
        b.add(b.sphere((0, 0, 0), 1.0, b.diffuse_light(tex) if not nested else b.lambertian(tex)))
        if nested:
            with pytest.raises(NotImplementedError, match="nested checkers"):
                b.compile(device="cpu")
        else:
            cs = b.compile(device="cpu").compiled
            assert cs.has_emissive_image and cs.has_image_textures
    b = SceneBuilder()
    chk = b.checkerboard(1.0, b.solid_color((0.5, 0.5, 0.5)), b.image_texture(np.zeros((2, 3, 3), np.uint8)))
    b.add(b.sphere((0, 0, 0), 1.0, b.lambertian(chk)))
    cs = b.compile(device="cpu").compiled
    assert cs.has_image_textures and cs.image_dims == ((3, 2),)
    row = cs.shade_rows[0].tolist()
    assert (row[18], row[28]) == (-1.0, 0.0) and row[22:25] == [1.0, 1.0, 1.0]
    b = SceneBuilder()
    m = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for i in range(40):
        b.add(b.sphere((i, 0, 0), 0.4, m))
    b.use_bvh(True)
    assert not b.compile(device="cpu").compiled.has_sph_tree  # 40 < TREE_MIN_PRIMS
    for i in range(40):
        b.add(b.sphere((i, 2, 0), 0.4, m))
        b.add(b.quad((i, 4, 0), (0.5, 0, 0), (0, 0.5, 0), m))
    cs = b.compile(device="cpu").compiled
    assert cs.has_sph_tree and not cs.has_quad_tree and cs.n_quads == 40
    for i in range(40):
        b.add(b.quad((i, 6, 0), (0.5, 0, 0), (0, 0.5, 0), m))
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    with pytest.raises(NotImplementedError, match="K4"):
        b.compile(device="cpu")


def test_checker_moving_sphere_scene_equal_jax():
    """A scene with a checker, a moving sphere, fuzzy metal and isotropic
    media builds the same tables on both sides."""

    def build(mod):
        b = mod.scene.SceneBuilder()
        chk = b.checkerboard(0.3, b.solid_color((0.2, 0.3, 0.1)), b.solid_color((0.9, 0.9, 0.9)))
        b.add(b.quad((-5, -1, -5), (10, 0, 0), (0, 0, 10), b.lambertian(chk)))
        b.add(b.sphere((0, 0.5, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.3)))
        b.add(b.moving_sphere((2, 0.5, 0), (2, 1.0, 0), 0.7,
                              b.isotropic(b.solid_color((0.5, 0.5, 0.9)))))
        light = b.add(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                             b.diffuse_light(b.solid_color((8, 8, 8)))))
        b.set_lights([light])
        b.set_background((0.3, 0.4, 0.6))
        return b.compile(**({"device": "cpu"} if mod is zt else {}))

    _assert_same(build(zt).compiled, build(zj).compiled)
