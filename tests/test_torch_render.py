"""The slice as a whole: ``Renderer.render`` of the PyTorch port on the CPU.

  1. cornell 16x16, 2 spp, depth 3 against the JAX package's
     ``Renderer.render`` (its XLA path on the CPU): every pixel within
     rtol=1e-5, atol=1e-6 but the EDGE_PIXELS, whose camera rays meet the
     floor/red-wall edge exactly, where XLA's fused multiply-adds and the
     port's rounded products decide hit or miss differently (the witness
     is test_torch_fused_render.py's EDGE_LANES test);
  2. 64x64, 32 spp, depth 10 against tests/golden/cornell_box.npz with the
     tolerances of tests/test_golden_images.py;
  3. the same framebuffer through the port's goldengate against the
     golden's region statistics;
  4. two renders by one Renderer(regen_min_wave=1): the second goes through
     the cost-sorted plan and must give the first image within rtol=2e-5,
     atol=2e-6 (the bound tests/test_pallas.py sets for the JAX balanced
     driver)."""

import pathlib

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer, region_means

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "cornell_box.npz"
PIXEL_ATOL, PIXEL_RTOL, MEAN_REL_TOL = 0.02, 0.05, 0.02  # test_golden_images.py
# (px, py) of test_torch_fused_render.py's EDGE_LANES at 16x16, 2 spp
EDGE_PIXELS = ((12, 12), (13, 13), (14, 14))


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


def test_render_matches_jax_renderer(cornell):
    fb_j = np.asarray(
        zj.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0).render(
            zj.models.load_scene("cornell_box"), 16, 16
        )
    )
    fb_t = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0).render(
        cornell, 16, 16
    )
    assert fb_t.shape == fb_j.shape == (16, 16, 3) and fb_t.dtype == np.float32
    assert np.isfinite(fb_t).all()
    other = np.ones((16, 16), bool)
    for x, y in EDGE_PIXELS:
        other[y, x] = False
    np.testing.assert_allclose(fb_t[other], fb_j[other], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def golden_render(cornell):
    data = np.load(GOLDEN)
    r = zt.render.Renderer(
        samples_per_pixel=int(data["spp"]), max_ray_bounce_depth=int(data["depth"]),
        seed=int(data["seed"]),
    )
    fb = r.render(cornell, int(data["width"]), int(data["height"]))
    return fb, data["fb"]


def test_render_matches_golden(golden_render):
    fb, ref = golden_render
    assert fb.shape == ref.shape and np.isfinite(fb).all()
    assert abs(fb.mean() - ref.mean()) / ref.mean() < MEAN_REL_TOL
    bad = np.abs(fb - ref) > (PIXEL_ATOL + PIXEL_RTOL * np.abs(ref))
    assert bad.mean() < 0.005, np.abs(fb - ref).max()


def test_render_passes_goldengate(golden_render):
    fb, ref = golden_render
    verdict = check_framebuffer(fb, float(ref.mean()), region_means(ref, 8))
    assert verdict.startswith("pass"), verdict


def test_sorted_plan_render_matches_first(cornell):
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=4, regen_min_wave=1)
    assert r.regen_geometry(24, 24, 8)[0] == 1
    calls = integrator.render_fused_reference.calls
    fb1 = r.render(cornell, 24, 24)
    fb2 = r.render(cornell, 24, 24)
    assert integrator.render_fused_reference.calls == calls + 2
    (entry,) = r._plan_cache[cornell.compiled].values()
    assert "plan" in entry  # the second render ran the sorted plan
    assert np.isfinite(fb2).all()
    np.testing.assert_allclose(fb2, fb1, rtol=2e-5, atol=2e-6)


def test_sorted_plan_pads_with_dead_items():
    from zig_weekend_raytracer_tpu_torch.render.renderer import sorted_plan

    # 3 x 4 band at y0 = 5, two rows valid; flat lane order (no tile)
    work = np.array([1, 7, 3, 7, 2, 9, 0, 4, 8, 8, 8, 8], np.int32)
    px, py, live = sorted_plan(work, 4, 3, 2, 5, 16)
    assert all(a.dtype == np.int32 and a.shape == (16,) for a in (px, py, live))
    # descending cost, ties in image order: 9, 7, 7, 4, 3, 2, 1, 0
    assert list(zip(px[:8], py[:8])) == [(1, 6), (1, 5), (3, 5), (3, 6), (2, 5), (0, 6),
                                         (0, 5), (2, 6)]
    assert live.tolist() == [1] * 8 + [0] * 8
    assert (px[8:] == 0).all() and (py[8:] == 5).all()


def test_memo_plan_entry_evicts_the_oldest_config(cornell):
    import weakref

    from zig_weekend_raytracer_tpu_torch.render.renderer import memo_plan_entry

    cache = weakref.WeakKeyDictionary()
    first = memo_plan_entry(cache, cornell.compiled, 0, 2)
    first["plan"] = 1
    assert memo_plan_entry(cache, cornell.compiled, 0, 2) is first
    memo_plan_entry(cache, cornell.compiled, 1, 2)
    memo_plan_entry(cache, cornell.compiled, 2, 2)
    assert list(cache[cornell.compiled]) == [1, 2]
    assert memo_plan_entry(cache, cornell.compiled, 0, 2) == {}


def test_renderer_guards(cornell):
    with pytest.raises(ValueError, match="exceeds u32"):
        zt.render.Renderer(samples_per_pixel=1 << 16).render_device(cornell, 256, 256)
    # a shard mode that no renderer takes
    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer
    with pytest.raises(ValueError, match="unknown shard mode"):
        ProgressiveRenderer(zt.render.Renderer(), "c.npz", shard="columns")
    with pytest.raises(ValueError, match="differs"):
        zt.render.Renderer(device="meta").render_device(cornell, 4, 4)


def test_ppm_encoding_matches_jax(tmp_path):
    from zig_weekend_raytracer_tpu.io.ppm import _write_ppm_numpy, encode_pixels

    rng = np.random.default_rng(0)
    fb = rng.uniform(-0.5, 2.0, (5, 7, 3)).astype(np.float32)
    fb[0, 0, 0] = np.nan
    np.testing.assert_array_equal(zt.io.encode_pixels(fb), encode_pixels(fb))
    zt.io.write_ppm(str(tmp_path / "t.ppm"), fb)
    _write_ppm_numpy(str(tmp_path / "j.ppm"), encode_pixels(fb))
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
