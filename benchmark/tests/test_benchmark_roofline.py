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
