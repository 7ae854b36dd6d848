"""``ProgressiveRenderer`` of the PyTorch port on the CPU (``--checkpoint``),
against the JAX package and its tests (tests/test_progressive.py).

  1. ``_fingerprint`` is JAX's string for the same settings, so a
     checkpoint names its render the same way in both packages.
  2. A progressive render equals the one-shot render within rtol 1e-5 /
     atol 1e-7 (other float32 sums' order); a render interrupted after a
     batch and resumed from its checkpoint equals the uninterrupted
     progressive render bitwise; a checkpoint of other settings restarts;
     the stratified sampler keeps the total's strata; the checkpoint is a
     plain .npz with JAX's keys.
  3. A progressive render against JAX's (Pallas interpret) within rtol
     1e-5 / atol 1e-6 at cornell 12x12, 8 spp, depth 3, independent
     sampler (its jitter keeps off test_torch_fused_render's edge rays).
  4. ``shard`` other than "none" is slice 6: it raises.
"""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.render import progressive as jprog
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer, _fingerprint

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def scene():
    return zt.models.load_scene("cornell_box", device="cpu")


@pytest.mark.parametrize("opts", [
    {},
    {"samples_per_pixel": 64, "max_ray_bounce_depth": 7, "seed": 3, "russian_roulette": 2,
     "clamp_indirect": 4.5, "max_rays_per_chunk": 1 << 18, "regen_min_wave": 1},
    {"sampler": "stratified"},
    {"sampler": "independent", "clamp_indirect": 0.25},
])
def test_fingerprint_equals_jax(opts, scene):
    sampler = opts.pop("sampler", "sobol")
    t = zt.render.Renderer(sampler=zt.sampling.SamplerKind(sampler), **opts)
    j = zj.render.Renderer(sampler=JKind(sampler), **opts)
    sj = zj.models.load_scene("cornell_box")
    assert _fingerprint(scene, 12, 10, t) == jprog._fingerprint(sj, 12, 10, j)


def test_progressive_equals_oneshot(scene, tmp_path):
    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    oneshot = base.render(scene, 12, 12)
    fb = ProgressiveRenderer(base, str(tmp_path / "ck.npz")).render(scene, 12, 12, batch_spp=3)
    np.testing.assert_allclose(fb, oneshot, rtol=RTOL, atol=ATOL)


def test_resume_from_checkpoint_is_bitwise(scene, tmp_path):
    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    whole = ProgressiveRenderer(base, str(tmp_path / "whole.npz")).render(
        scene, 12, 12, batch_spp=3)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bail(done, _img):
        if done >= 3:
            raise Stop

    with pytest.raises(Stop):
        ProgressiveRenderer(base, ck).render(scene, 12, 12, batch_spp=3, on_batch=bail)
    z = np.load(ck)
    assert sorted(z.files) == ["fb_sum", "fingerprint", "samples_done", "total_spp"]
    assert int(z["samples_done"]) == 3 and int(z["total_spp"]) == 8
    assert z["fb_sum"].dtype == np.float32
    fb = ProgressiveRenderer(base, ck).render(scene, 12, 12, batch_spp=3)
    np.testing.assert_array_equal(fb, whole)
    assert int(np.load(ck)["samples_done"]) == 8


def test_mismatched_checkpoint_restarts(scene, tmp_path):
    ck = str(tmp_path / "ck.npz")
    r8 = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    ProgressiveRenderer(r8, ck).render(scene, 12, 12, batch_spp=8)
    r_other = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=9)
    fb = ProgressiveRenderer(r_other, ck).render(scene, 12, 12, batch_spp=8)
    np.testing.assert_allclose(fb, r_other.render(scene, 12, 12), rtol=RTOL, atol=ATOL)


def test_progressive_stratified_equals_oneshot(scene, tmp_path):
    base = zt.render.Renderer(samples_per_pixel=9, max_ray_bounce_depth=3, seed=4,
                              sampler=zt.sampling.SamplerKind.STRATIFIED)
    oneshot = base.render(scene, 8, 8)
    fb = ProgressiveRenderer(base, str(tmp_path / "ck.npz")).render(scene, 8, 8, batch_spp=4)
    np.testing.assert_allclose(fb, oneshot, rtol=RTOL, atol=ATOL)


def test_progressive_matches_jax(pallas_interpret, scene, tmp_path):
    opts = dict(samples_per_pixel=8, max_ray_bounce_depth=3, seed=1)
    want = jprog.ProgressiveRenderer(
        zj.render.Renderer(sampler=JKind.INDEPENDENT, **opts), str(tmp_path / "j.npz"),
    ).render(zj.models.load_scene("cornell_box"), 12, 12, batch_spp=4)
    got = ProgressiveRenderer(
        zt.render.Renderer(sampler=zt.sampling.SamplerKind.INDEPENDENT, **opts),
        str(tmp_path / "t.npz"),
    ).render(scene, 12, 12, batch_spp=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_shard_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="slice 6"):
        ProgressiveRenderer(zt.render.Renderer(), "c.npz", shard="samples")
