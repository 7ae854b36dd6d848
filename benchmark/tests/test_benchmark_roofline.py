"""The render kernel's bound: the reference's count repeats exactly for a
fixed seed, and the bound it prices is the operations' on these scenes."""

import pytest

from benchmark import check, roofline, spec
from benchmark.reference.utils import workcount

from conftest import TINY

DOC = spec.load_spec()


def _bound(cell, seed):
    c = spec.resolve(DOC, cell)
    t = {**c.traffic, **TINY}
    scene = check.reference_scene(c.config_path, "cpu")
    xs, ys = check.pixel_sample(seed, t["width"], t["height"], t["check_block"])
    with workcount.counting() as counts:
        check.reference_pixels(scene, t, seed, xs, ys)
    return dict(counts), roofline.k1_bound(scene.compiled, dict(counts), len(xs),
                                           scene.camera.has_depth_of_field, t["spp"],
                                           t["width"], t["height"])


@pytest.mark.parametrize("cell", ["cornell_box.north_star", "balls.canonical"])
def test_count_repeats_exactly(cell):
    counts1, b1 = _bound(cell, 4242)
    counts2, b2 = _bound(cell, 4242)
    assert counts1 == counts2 and b1 == b2
    assert counts1["camera_ray"] == 16 * TINY["spp"]
    assert b1["by"] == "operations" and b1["ms"] > 0


def test_tree_scene_counts_the_walk_and_brute_scene_the_scan():
    balls, _ = _bound("balls.canonical", 7)
    cornell, _ = _bound("cornell_box.north_star", 7)
    assert balls.get("slab_test", 0) > 0 and balls.get("leaf_visit", 0) > 0
    assert cornell.get("slab_test", 0) == 0
    assert cornell["quad_test"] == 12 * cornell["trace"]


def test_rates_are_the_data_sheets():
    assert roofline.RATES == {"fp": 33.5e12, "cmp": 16.75e12, "int": 16.75e12}
    assert roofline.PEAK_BYTES == 3.35e12


# k1_bound at TINY and seed 4242 on scenes without images, held bit for
# bit: the image table's byte term adds nothing to them
IMAGE_FREE_BOUNDS = {
    "cornell_box.north_star": ("0x1.0bb5d4e2960b2p-16", 7600),
    "balls.canonical": ("0x1.86e8fe91d5a23p-15", 88656),
}


@pytest.mark.parametrize("cell", sorted(IMAGE_FREE_BOUNDS))
def test_bound_without_images_is_unchanged(cell):
    _, b = _bound(cell, 4242)
    ms, nbytes = IMAGE_FREE_BOUNDS[cell]
    assert b["ms"] == float.fromhex(ms) and b["bytes"] == nbytes
    scene = check.reference_scene(spec.resolve(DOC, cell).config_path, "cpu")
    assert roofline.image_table_bytes(scene.compiled) == 0


@pytest.mark.parametrize("texture_lut", [None, 512])
def test_image_scene_adds_its_texel_table(tmp_path, texture_lut):
    from benchmark.reference.models.scenefile import load_scene_file
    from benchmark.reference.sampling.sobol import sobol_sample_bytes

    from test_benchmark_decode import write_image_scene

    cs = load_scene_file(write_image_scene(str(tmp_path)), device="cpu",
                         texture_lut=texture_lut).compiled
    texels = cs.tex_lut_tab if texture_lut else cs.atlas_packed
    assert (cs.tex_lut_tab is not None) == bool(texture_lut)
    spp, w, h = 4, 8, 8
    n_bytes = sobol_sample_bytes(spp)
    image_free = (roofline.K1_LANE_BYTES * w * h + roofline.trace_bytes(cs)
                  + cs.shade_rows.numel() * 4 + 5 * 52 * 4 + 2 * n_bytes * 256 * 4)
    b = roofline.k1_bound(cs, {"camera_ray": w * h * spp, "bounce": w * h * spp}, w * h,
                          False, spp, w, h)
    assert texels.dtype.itemsize == 4 and texels.numel() > 0
    assert b["bytes"] - image_free == texels.numel() * 4 == roofline.image_table_bytes(cs)
