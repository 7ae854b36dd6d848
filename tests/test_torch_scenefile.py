"""JSON scene files in the PyTorch port on the CPU (``models/scenefile.py``,
``--scene_file``), against the JAX package and its tests
(tests/test_scenefile.py).

  1. A file scene compiles to tables bitwise equal to JAX's for the same
     file and to the port's Python scene: JAX's test scene, its
     kitchen-sink entities, and the cornell box of
     ``models/cornell_box.json`` against ``load_scene("cornell_box")``;
     a file scene renders bitwise as the Python scene does.
  2. Image paths resolve relative to the file.
  3. Each schema error raises JAX's exception type with JAX's message.
  4. A checker of checkers, which JAX's loader accepts, compiles to JAX's
     tables with the nested flag (the fixed-depth path renders it).
"""

import json
import os

import numpy as np
import pytest

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from test_torch_scene import _assert_same
from zig_weekend_raytracer_tpu.models import load_scene_file as jload
from zig_weekend_raytracer_tpu_torch.models import load_scene_file
from zig_weekend_raytracer_tpu_torch.scene import Camera, SceneBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_FILE = os.path.join(REPO, "zig_weekend_raytracer_tpu_torch", "models", "cornell_box.json")

_MINI = {
    "background": [0.0, 0.0, 0.0],
    "camera": {"look_from": [0, 2, 6], "look_at": [0, 1, 0], "vfov_degrees": 45},
    "textures": {
        "red": {"solid": [0.65, 0.05, 0.05]},
        "white": {"solid": [0.73, 0.73, 0.73]},
        "check": {"checker": {"inv_scale": 0.5, "even": "red", "odd": "white"}},
        "bright": {"solid": [8, 8, 8]},
    },
    "materials": {
        "floor": {"lambertian": "check"},
        "ball": {"metal": {"albedo": [0.8, 0.7, 0.6], "fuzz": 0.05}},
        "glass": {"dielectric": 1.5},
        "lamp": {"diffuse_light": "bright"},
    },
    "entities": [
        {"quad": {"start": [-6, 0, -6], "edge_u": [12, 0, 0], "edge_v": [0, 0, 12],
                  "material": "floor"}},
        {"sphere": {"center": [-1.2, 1, 0], "radius": 1, "material": "ball"}},
        {"sphere": {"center": [1.2, 1, 0], "radius": 1, "material": "glass"}},
        {"quad": {"start": [-1, 4, -1], "edge_u": [2, 0, 0], "edge_v": [0, 0, 2],
                  "material": "lamp"}, "light": True},
    ],
}

_SINK = {
    "camera": {"look_from": [0, 0, 9], "look_at": [0, 0, 0]},
    "textures": {"w": {"solid": [0.7, 0.7, 0.7]}},
    "materials": {"m": {"lambertian": "w"}, "fog": {"isotropic": "w"}},
    "entities": [
        {"box": {"a": [-1, -1, -1], "b": [1, 1, 1], "material": "m"}},
        {"translate": {"offset": [3, 0, 0], "child": {"rotate_y": {
            "angle_degrees": 30, "child": {"box": {"a": [0, 0, 0], "b": [1, 2, 1],
                                                   "material": "m"}}}}}},
        {"moving_sphere": {"center0": [0, 3, 0], "center1": [1, 3, 0], "radius": 0.5,
                           "material": "fog"}},
        {"collection": {"children": [{"sphere": {"center": [-3, 0, 0], "radius": 0.5,
                                                 "material": "m"}}], "bvh": True}},
    ],
    "use_bvh": {"enable": True, "min_prims": 2},
}


def _write(tmp_path, doc, name="scene.json"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def _mini_builder():
    b = SceneBuilder()
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45))
    red = b.solid_color((0.65, 0.05, 0.05))
    white = b.solid_color((0.73, 0.73, 0.73))
    check = b.checkerboard(0.5, red, white)
    bright = b.solid_color((8, 8, 8))
    floor = b.lambertian(check)
    ball = b.metal((0.8, 0.7, 0.6), 0.05)
    glass = b.dielectric(1.5)
    lamp = b.diffuse_light(bright)
    b.add(b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), floor))
    b.add(b.sphere((-1.2, 1, 0), 1, ball))
    b.add(b.sphere((1.2, 1, 0), 1, glass))
    light = b.add(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), lamp))
    b.set_lights([light])
    return b.compile(device="cpu")


@pytest.mark.parametrize("doc", [_MINI, _SINK], ids=["mini", "kitchen_sink"])
def test_file_scene_tables_equal_jax(doc, tmp_path):
    path = _write(tmp_path, doc)
    st, sj = load_scene_file(path, device="cpu"), jload(path)
    _assert_same(st.compiled, sj.compiled)
    assert st.camera == Camera(**sj.camera.__dict__)
    assert st.background == sj.background and st.name == sj.name == "scene.json"
    fb = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3).render(st, 8, 8)
    assert np.isfinite(fb).all()


def test_file_scene_renders_as_python_scene(tmp_path):
    st = load_scene_file(_write(tmp_path, _MINI), device="cpu")
    sp = _mini_builder()
    _assert_same(st.compiled, jload(_write(tmp_path, _MINI)).compiled)
    r = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=4, seed=0)
    np.testing.assert_array_equal(r.render(st, 8, 8), r.render(sp, 8, 8))


def test_cornell_file_equals_the_builtin_scene():
    st = load_scene_file(CORNELL_FILE, device="cpu")
    sb = zt.models.load_scene("cornell_box", device="cpu")
    want = jload(CORNELL_FILE).compiled
    _assert_same(st.compiled, want)
    _assert_same(sb.compiled, want)
    assert st.camera == sb.camera and tuple(st.background) == tuple(sb.background)
    r = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3)
    np.testing.assert_array_equal(r.render(st, 8, 8), r.render(sb, 8, 8))


def test_image_texture_resolves_relative_to_file(tmp_path):
    from PIL import Image

    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 1] = 200  # green
    (tmp_path / "sub").mkdir()
    Image.fromarray(img).save(tmp_path / "sub" / "tex.png")
    doc = {
        "camera": {"look_from": [0, 0, 5], "look_at": [0, 0, 0]},
        "textures": {"t": {"image": "tex.png"}},
        "materials": {"m": {"diffuse_light": "t"}},
        "entities": [{"quad": {"start": [-50, -50, -1], "edge_u": [100, 0, 0],
                               "edge_v": [0, 100, 0], "material": "m"}}],
    }
    path = _write(tmp_path / "sub", doc)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # not the file's directory
    try:
        st = load_scene_file(path, device="cpu")
        sj = jload(path)
    finally:
        os.chdir(cwd)
    _assert_same(st.compiled, sj.compiled)
    fb = zt.render.Renderer(samples_per_pixel=1, max_ray_bounce_depth=2).render(st, 4, 4)
    assert fb[..., 1].mean() > 10 * max(fb[..., 0].mean(), 1e-6)


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("camera"),
    lambda d: d["materials"].update({"bad": {"lambertian": "nope"}}),
    lambda d: d["entities"].append({"frob": {}}),
    lambda d: d["textures"].update({"bad": {"plaid": 1}}),
    lambda d: d["camera"].update({"zoom": 2}),
    lambda d: d["entities"].append({"sphere": {"center": [0, 0, 0], "radius": 1,
                                               "material": "nope"}}),
    lambda d: d["entities"].append({"translate": {"offset": [0, 0, 0], "child": {
        "sphere": {"center": [0, 5, 0], "radius": 1, "material": "floor"}, "light": True}}}),
    lambda d: d["entities"].append({"sphere": {"center": [0, 0], "radius": 1,
                                               "material": "floor"}}),
    lambda d: d["textures"].update({"c2": {"checker": {"inv_scale": 1, "even": "red",
                                                       "odd": "ghost"}}}),
    lambda d: d["materials"].update({"two": {"lambertian": "red", "metal": {}}}),
    lambda d: d["entities"].append({"quad": {"start": [0, 0, 0], "edge_u": [1, 0, 0],
                                             "material": "floor"}}),
], ids=["no_camera", "unknown_texture", "unknown_entity", "unknown_texture_kind",
        "camera_field", "unknown_material", "nested_light", "short_vector",
        "checker_child", "two_kinds", "missing_key"])
def test_schema_errors_as_jax(mutate, tmp_path):
    doc = json.loads(json.dumps(_MINI))
    mutate(doc)
    path = _write(tmp_path, doc)
    with pytest.raises(Exception) as want:
        jload(path)
    with pytest.raises(type(want.value)) as got:
        load_scene_file(path, device="cpu")
    assert str(got.value) == str(want.value)


def test_top_level_must_be_an_object(tmp_path):
    path = tmp_path / "list.json"
    path.write_text("[1, 2]")
    with pytest.raises(ValueError, match="top level must be an object"):
        load_scene_file(str(path), device="cpu")


def test_checker_of_checkers_is_a_later_slice(tmp_path):
    doc = json.loads(json.dumps(_MINI))
    doc["textures"]["check2"] = {"checker": {"inv_scale": 1.0, "even": "check", "odd": "red"}}
    doc["materials"]["floor"] = {"lambertian": "check2"}
    path = _write(tmp_path, doc)
    want = jload(path)  # the JAX package renders it on XLA
    got = load_scene_file(path, device="cpu")
    assert got.compiled.has_nested_checker and want.compiled.has_nested_checker
    _assert_same(got.compiled, want.compiled)
