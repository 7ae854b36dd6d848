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
  4. The batches of a brute scene at one sample in flight per pixel follow
     the cost-sorted plan from the second on, bitwise the plain lanes.
  5. ``shard``: a sharded progressive render (2 CPU entries, samples)
     interrupted after 2 batches and resumed is bitwise the uninterrupted
     sharded render, within rtol 1e-5 / atol 1e-7 of the unsharded one; its
     fingerprint names the mode and mesh size, so a checkpoint of another
     mesh size is not resumed; an unknown mode raises.
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
    # the same settings: the port's default chunk is its own
    # (``MAX_RAYS_PER_CHUNK``, sized to the card; JAX's 1 << 21)
    j = zj.render.Renderer(sampler=JKind(sampler),
                           **{"max_rays_per_chunk": t.max_rays_per_chunk, **opts})
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


def test_batches_follow_the_sorted_plan(scene, tmp_path, monkeypatch):
    """At one sample in flight per pixel a brute scene's batches after the
    first render the cost-sorted plan, bitwise the plain lanes'
    (ZWRT_NO_SORT)."""
    from zig_weekend_raytracer_tpu_torch.parallel import render as prender

    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2,
                              regen_min_wave=1)
    planned = []
    band = prender._render_band_balanced
    monkeypatch.setattr(prender, "_render_band_balanced",
                        lambda *a, **k: planned.append(a[2]) or band(*a, **k))
    prender._plan_cache.pop(scene.compiled, None)
    fb = ProgressiveRenderer(base, str(tmp_path / "a.npz")).render(scene, 12, 12, batch_spp=2)
    assert len(planned) == 3  # batches 2 to 4, one band each
    monkeypatch.setenv("ZWRT_NO_SORT", "1")
    plain = ProgressiveRenderer(base, str(tmp_path / "b.npz")).render(scene, 12, 12,
                                                                      batch_spp=2)
    assert len(planned) == 3
    np.testing.assert_array_equal(fb, plain)


def test_shard_is_a_later_slice(scene, tmp_path, caplog):
    """Sharded batches render (the name is the test's from when they were a
    later slice of the port)."""
    import logging

    from zig_weekend_raytracer_tpu_torch.parallel import make_mesh

    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    two = make_mesh(2, device="cpu")
    whole = ProgressiveRenderer(base, str(tmp_path / "whole.npz"), shard="samples",
                                mesh=two).render(scene, 12, 12, batch_spp=2)
    np.testing.assert_allclose(whole, base.render(scene, 12, 12), rtol=RTOL, atol=ATOL)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bail(done, _img):
        if done >= 4:
            raise Stop

    with pytest.raises(Stop):
        ProgressiveRenderer(base, ck, shard="samples", mesh=two).render(
            scene, 12, 12, batch_spp=2, on_batch=bail)
    z = np.load(ck)
    assert int(z["samples_done"]) == 4
    assert str(z["fingerprint"]) == _fingerprint(scene, 12, 12, base) + ":shard-samples-2"
    with caplog.at_level(logging.INFO, logger="zwrt"):
        fb = ProgressiveRenderer(base, ck, shard="samples", mesh=two).render(
            scene, 12, 12, batch_spp=2)
    assert any("resuming render from checkpoint: 4/8" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(fb, whole)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="zwrt"):
        ProgressiveRenderer(base, ck, shard="samples", mesh=make_mesh(3, device="cpu")).render(
            scene, 12, 12, batch_spp=4)
    assert any("fingerprint mismatch" in r.getMessage() for r in caplog.records)
    with pytest.raises(ValueError, match="unknown shard mode"):
        ProgressiveRenderer(base, ck, shard="tiles")
