"""The benchmark's scene data: through the port's scene-file entry it
compiles, on the CPU, to the tables of the port's built-in scenes, so the
port's earlier figures stay comparable; and the reference, at 8x8 and 4
samples a pixel, agrees with the port's plain version within the limits."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import check, spec

from conftest import TINY

DOC = spec.load_spec()
CONFIGS = {c["name"]: c for c in DOC["configs"]}
# the texture tables and the shade record's texture-id column (29) name
# textures by their order of declaration, which a scene file orders
# differently (checkers after every other texture); compared resolved
TEXTURE_FIELDS = {"mat_tex", "tex_type", "tex_rgb", "tex_inv_scale", "tex_even", "tex_odd"}
TEXID_COLUMN = 29


def _equal(a, b):
    if hasattr(a, "x") and hasattr(a, "z") and isinstance(a, tuple):
        return all(_equal(getattr(a, c), getattr(b, c)) for c in "xyz")
    if torch.is_tensor(a):
        return a.shape == b.shape and bool(torch.equal(a, b))
    if isinstance(a, tuple) and a and torch.is_tensor(a[0]):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return a == b


def _texture_of(cs, mat):
    """The texture a material reads, resolved to its content."""
    t = int(cs.mat_tex[mat])

    def content(t):
        kind = int(cs.tex_type[t])
        rgb = tuple(float(c[t]) for c in cs.tex_rgb)
        if kind == 1:
            return (kind, float(cs.tex_inv_scale[t]), content(int(cs.tex_even[t])),
                    content(int(cs.tex_odd[t])))
        return (kind, rgb)

    return content(t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scene_file_compiles_to_the_builtin_tables(name):
    from zig_weekend_raytracer_tpu_torch.models import load_scene, load_scene_file

    builtin = load_scene(name, device="cpu")
    ours = load_scene_file(spec.resolve(DOC, next(
        w["name"] for w in DOC["workloads"] if w["config"] == name)).config_path, device="cpu")
    assert builtin.camera == ours.camera and builtin.background == ours.background
    a, b = builtin.compiled, ours.compiled
    for f in dataclasses.fields(a):
        if f.name in TEXTURE_FIELDS or f.name == "shade_rows":
            continue
        assert _equal(getattr(a, f.name), getattr(b, f.name)), f.name
    keep = [i for i in range(a.shade_rows.shape[1]) if i != TEXID_COLUMN]
    assert torch.equal(a.shade_rows[:, keep], b.shade_rows[:, keep])
    assert a.n_materials == b.n_materials
    for m in range(a.n_materials):
        if int(a.mat_type[m]) in (0, 1, 4):  # texture-driven materials
            assert _texture_of(a, m) == _texture_of(b, m), m


def test_balls_file_renders_the_builtin_image():
    from zig_weekend_raytracer_tpu_torch.models import load_scene, load_scene_file
    from zig_weekend_raytracer_tpu_torch.render.renderer import Renderer

    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=4, seed=9)
    builtin = r.render(load_scene("balls", device="cpu"), 8, 8)
    ours = r.render(load_scene_file(CONFIGS["balls"]["file"], device="cpu"), 8, 8)
    assert np.array_equal(builtin, ours)


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_reference_agrees_with_the_ports_plain_version(cell):
    from zig_weekend_raytracer_tpu_torch.models import load_scene_file
    from zig_weekend_raytracer_tpu_torch.render.renderer import Renderer

    c = spec.resolve(DOC, cell)
    t = {**c.traffic, **TINY}
    seed = 2**33 + 5
    r = Renderer(samples_per_pixel=t["spp"], max_ray_bounce_depth=t["depth"],
                 seed=seed % 2**32)
    scene = load_scene_file(c.config_path, device="cpu")
    img = r.render_device(scene, t["width"], t["height"])
    xs, ys = check.pixel_sample(seed, t["width"], t["height"], t["check_block"])
    ref = check.reference_pixels(check.reference_scene(c.config_path, "cpu"), t,
                                 seed % 2**32, xs, ys)
    mean_rel, max_rel = check.rel_gaps(img[ys, xs], ref)
    assert mean_rel <= t["limits"]["img_mean_rel"]
    assert max_rel <= t["limits"]["img_max_rel"]
    assert float(ref.abs().mean()) > 0


def test_pixel_sample_is_one_pixel_a_tile_and_repeats():
    xs, ys = check.pixel_sample(2**31 + 3, 20, 12, 8)
    assert len(xs) == 3 * 2
    assert np.all((xs // 8) * 2 + 0 >= 0)
    tiles = sorted(zip((ys // 8).tolist(), (xs // 8).tolist()))
    assert tiles == sorted({(y, x) for y in range(2) for x in range(3)})
    assert np.all(xs < 20) and np.all(ys < 12)
    x2, y2 = check.pixel_sample(2**31 + 3, 20, 12, 8)
    assert np.array_equal(xs, x2) and np.array_equal(ys, y2)


def test_request_seeds_are_distinct_and_repeat():
    run_seed = 2**31 + 3
    seeds = [check.request_seed(run_seed, i) for i in range(20000)]
    assert len(set(seeds)) == len(seeds) and all(0 <= s < 2**32 for s in seeds)
    assert seeds == [check.request_seed(run_seed, i) for i in range(20000)]
    nearby = {check.request_seed(run_seed + 1, i) for i in range(20000)}
    assert len(nearby & set(seeds)) < 5


def test_keeper_draws_its_sample_from_the_seed():
    def kept(seed, offers, n_keep=4):
        keeper = check.Keeper(seed, n_keep)
        for i in range(offers):
            keeper.offer(i, check.request_seed(seed, i), torch.full((3, 3, 3), float(i)))
        assert keeper.seen == offers
        return [int(img[0, 0, 0]) for _, _, img in keeper.kept]

    assert sorted(kept(7, 3)) == [0, 1, 2]
    a = kept(7, 500)
    assert len(set(a)) == 4 and a == kept(7, 500) and a != kept(8, 500)
    assert max(max(kept(s, 500)) for s in range(20)) >= 250


def test_keeper_gathers_the_checked_pixels_in_request_order():
    keeper = check.Keeper(1, 3)
    for i in range(3):
        keeper.offer(i, 100 + i, torch.arange(48, dtype=torch.float32).reshape(4, 4, 3) + i)
    xs, ys = check.pixel_sample(1, 4, 4, 2)
    got = keeper.gather(xs, ys)
    assert [s for s, _ in got] == [100, 101, 102] and keeper.kept == []
    base = torch.arange(48, dtype=torch.float32).reshape(4, 4, 3)
    for i, (_, px) in enumerate(got):
        assert torch.equal(px, base[torch.as_tensor(ys), torch.as_tensor(xs)] + i)
