"""The work queue of the render kernel and of the bounce kernel's
regenerating mode on the CPU: the chunk rule (``ops/fused_render.py:
item_chunk``), its items (``render/integrator.py:item_windows``) and the
plain versions over them (``render_fused_items_reference``,
``bounce_regen_items_reference``).  For each split the items cover every
sample of every lane once and in order, and the plain version rendered
item by item and summed in the kernel's chunk order equals the unsplit
render within float32 rounding, each lane's work count exactly; the
regenerating mode's final state, a resumed live path included, is the
unsplit drain's."""

import numpy as np
import pytest
import torch

# the image scene's test loads earth.png, as the parity files' images do
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

SPP = 13


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


@pytest.fixture(scope="module")
def earth():
    """An image-textured scene without a LUT: the bounce kernel's
    regenerating mode renders it."""
    scene = zt.models.load_scene("earth", device="cpu")
    assert scene.compiled.has_image_textures and not scene.compiled.tex_lut_dims
    return scene


def _lanes(w, h, stride, windows):
    """(px, py, s0, s1): ``stride`` lanes a pixel, lane k of a pixel from
    sample k, to SPP ("full") or to uneven ends, some lanes dead, as an
    adaptive or balanced plan leaves them ("uneven")."""
    i32 = torch.int32
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    px = xs.reshape(-1).repeat(stride).to(i32)
    py = ys.reshape(-1).repeat(stride).to(i32)
    k = torch.arange(px.shape[0])
    s0 = (k // (w * h)).to(i32)
    s1 = torch.full_like(s0, SPP)
    if windows == "uneven":
        s0 = s0 + stride * (k % 3).to(i32)
        s1 = torch.minimum(s1, s0 + (k * 7 % 11).to(i32))
    return px, py, s0.contiguous(), s1.contiguous()


@pytest.mark.parametrize("w, h, stride, windows, threads", [
    pytest.param(4, 4, 1, "full", 64, id="stride1-below-threads"),
    pytest.param(4, 4, 4, "full", 64, id="stride4-below-threads"),
    pytest.param(5, 3, 1, "full", 4, id="chunk-not-dividing"),
    pytest.param(4, 4, 2, "uneven", 16, id="uneven-windows"),
    pytest.param(4, 4, 1, "uneven", 1, id="above-threads"),
    pytest.param(4, 4, 4, "full", 1, id="stride4-above-threads"),
])
def test_items_cover_each_window_once_and_sum_to_the_unsplit_render(
        cornell, request, w, h, stride, windows, threads):
    px, py, s0, s1 = _lanes(w, h, stride, windows)
    n = px.shape[0]
    longest = max(0, -(-int((s1 - s0).max()) // stride))
    chunk = fused.item_chunk(n, longest, threads)
    if request.node.callspec.id == "chunk-not-dividing":
        assert longest % chunk                   # the last chunk is short
    if n >= fused.ITEMS_PER_THREAD * threads:
        assert chunk == longest                  # the lanes alone are enough items
    else:
        assert 1 <= chunk < longest              # several items a lane
    lane, first, end, chunks = integrator.item_windows(s0, s1, stride, chunk)
    assert chunks == -(-longest // chunk)
    assert lane.tolist() == list(range(n)) * chunks     # chunk-major, lanes in plan order
    for l in range(n):
        got = []
        for item in range(l, chunks * n, n):
            samples = list(range(int(first[item]), int(end[item]), stride))
            assert len(samples) <= chunk
            got += samples
        assert got == list(range(int(s0[l]), int(s1[l]), stride))

    kw = dict(camera_consts=camera_consts(cornell.camera, w, h),
              sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=h, spp=SPP,
              stride=stride, max_depth=4, has_dof=False)
    whole, work = integrator.render_fused_reference(cornell.compiled, px, py, s0, s1, 5,
                                                    zt.dtypes.T_MIN, want_work=True, **kw)
    split, split_work = integrator.render_fused_items_reference(
        cornell.compiled, px, py, s0, s1, 5, zt.dtypes.T_MIN, chunk=chunk, want_work=True, **kw)
    assert torch.equal(split_work, work) and int(work.sum()) > 0
    assert split_work.dtype == work.dtype
    torch.testing.assert_close(split.to_array(), whole.to_array(), rtol=1e-5, atol=1e-5)

    # the kernel's order: each item from zero, a lane's items added in chunk order
    items = integrator.render_fused_reference(cornell.compiled, px[lane], py[lane], first, end,
                                              5, zt.dtypes.T_MIN, **kw).to_array()
    acc = torch.zeros((n, 3))
    for c in range(chunks):
        acc = acc + items[c * n:(c + 1) * n]
    assert torch.equal(split.to_array(), acc)


@pytest.mark.parametrize("n, longest, threads, chunk", [
    (160000, 1024, 135168, 74),      # the north star (400x400, stride 1) on 1,056 slots of 128
    (160000, 128, 118272, 11),       # canonical on 924 slots
    (160000, 10000, 135168, 715),    # ref_10k50
    (4_000_000, 64, 135168, 64),     # the lanes alone are several times the threads
    (100, 1, 135168, 1),             # one sample a lane: nothing to cut
    (10, 3, 128, 1),                 # fewer samples than items asked for: one a chunk
    (1, 0, 128, 1),                  # no samples
])
def test_item_chunk_rule(n, longest, threads, chunk):
    assert fused.item_chunk(n, longest, threads) == chunk


def test_a_pixels_chunks_do_not_depend_on_the_plan():
    """The tiled first pass (its lanes padded to whole tiles) and the
    sorted plan that follows it (one lane a pixel) of one render cut each
    pixel's samples at the same chunks, since the rule counts the render's
    lanes (``launch_lanes``), not the plan's: so a seed's image is the same
    bit for bit on either plan, as it was with one thread a lane."""
    from zig_weekend_raytracer_tpu_torch.render import renderer as rd

    w = h = 72
    spp, threads = 64, 4096
    px, py, sidx, _ = rd.ray_grid(w, h, 0, h, 0, 1, rd.pick_tile(w, h))
    first = (px, py, sidx, torch.full_like(px, spp))
    work = np.random.default_rng(0).integers(1, 50, px.shape[0])
    spx, spy, live = rd.sorted_plan(work, w, h, h, 0, w * h)
    spx, spy, live = (torch.from_numpy(a) for a in (spx, spy, live))
    plan = (spx, spy, torch.zeros_like(live), live * spp)
    assert first[0].shape[0] > w * h == plan[0].shape[0]

    def items(lanes):
        px, py, s0, s1 = (t.to(torch.int32) for t in lanes)
        chunk = fused.item_chunk(fused.launch_lanes(w, h, 1), spp, threads)
        lane, a, b, _ = integrator.item_windows(s0, s1, 1, chunk)
        live = b > a
        return {(int(px[k]), int(py[k]), int(x), int(y))
                for k, x, y in zip(lane[live], a[live], b[live])}

    assert items(first) == items(plan)
    # the plans' own lane counts would have cut them apart
    assert (fused.item_chunk(first[0].shape[0], spp, threads)
            != fused.item_chunk(plan[0].shape[0], spp, threads))


def _live(scene, px, py, s0, seed, kw):
    """Each lane one bounce into its first sample ``s0``, as a drain cut
    after its first pass leaves it: live where the path goes on, dead where
    it ended, its radiance so far, its work 1."""
    from zig_weekend_raytracer_tpu_torch.render.camera import (
        camera_params_from_consts, generate_rays)
    from zig_weekend_raytracer_tpu_torch.sampling import hashrng

    w, h = kw["width"], kw["height"]
    x, y, s = (t.to(torch.int64) for t in (px, py, s0))
    rid = ((s * h + y) * w + x) & hashrng.U32_MASK
    o, d, t = generate_rays(camera_params_from_consts(kw["camera_consts"]), False,
                            kw["sampler"], seed, rid, x, y, s, kw["spp"], w, h)
    n, dev = px.shape[0], px.device
    one = zt.math.v3.V3.full((n,), 1.0, 1.0, 1.0, dev)
    o, d, thr, rad, alive = integrator.bounce(
        scene.compiled, seed, zt.dtypes.T_MIN, torch.zeros((n,), dtype=torch.int64, device=dev),
        o, d, t, rid, one, zt.math.v3.V3.zeros((n,), dev),
        torch.ones((n,), dtype=torch.bool, device=dev))
    ones = torch.ones((n,), dtype=torch.int32, device=dev)
    return integrator.RegenState(o, d, t, rid, thr, rad, alive & (kw["max_depth"] > 1), s0,
                                 ones, ones)


@pytest.mark.parametrize("w, h, stride, windows, threads, start", [
    pytest.param(3, 3, 1, "full", 64, "fresh", id="stride1-threads-above-lanes"),
    pytest.param(3, 3, 4, "full", 64, "fresh", id="stride4-threads-above-lanes"),
    pytest.param(3, 3, 1, "full", 1, "fresh", id="threads-below-lanes"),
    pytest.param(3, 3, 2, "uneven", 16, "fresh", id="uneven-windows"),
    pytest.param(3, 3, 4, "uneven", 1, "fresh", id="uneven-stride4-threads-below-lanes"),
    pytest.param(3, 3, 1, "full", 16, "live", id="resumes-a-live-path"),
    pytest.param(3, 3, 2, "uneven", 16, "live", id="resumes-a-live-path-uneven-windows"),
])
def test_k2_items_sum_to_the_unsplit_drain(earth, w, h, stride, windows, threads, start):
    px, py, s0, s1 = _lanes(w, h, stride, windows)
    n = px.shape[0]
    seed = 5
    kw = dict(camera_consts=camera_consts(earth.camera, w, h),
              sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=h, spp=SPP,
              stride=stride, max_depth=4, has_dof=False)
    state = integrator.initial_regen_state(s0, stride)
    if start == "live":
        # the path of sample s0 one bounce in; the windows go on after it
        state = _live(earth, px, py, s0, seed, kw)
        assert 0 < int(state.alive.sum()) < n
    first = state.sample + stride
    longest = max(0, -(-int((s1 - first).max()) // stride))
    chunk = fused.item_chunk(fused.launch_lanes(w, h, stride), longest, threads)
    if n >= fused.ITEMS_PER_THREAD * threads:
        assert chunk == longest                  # one item a lane
    else:
        assert 1 <= chunk < longest              # several items a lane
    cs = earth.compiled
    whole = integrator.bounce_regen_reference(cs, state, px, py, s1, seed, zt.dtypes.T_MIN, **kw)
    split = integrator.bounce_regen_items_reference(cs, state, px, py, s1, seed,
                                                    zt.dtypes.T_MIN, chunk=chunk, **kw)
    assert torch.equal(split.work, whole.work) and split.work.dtype == whole.work.dtype
    assert int((whole.work - state.work).sum()) > 0
    torch.testing.assert_close(split.radiance.to_array(), whole.radiance.to_array(),
                               rtol=1e-5, atol=1e-5)
    # the path fields are those of each lane's last sample, every lane dead
    # with its window used up
    for name in ("origin", "direction", "throughput"):
        assert torch.equal(getattr(split, name).to_array(), getattr(whole, name).to_array())
    for name in ("time", "ray_id", "alive", "sample", "bounce"):
        assert torch.equal(getattr(split, name), getattr(whole, name)), name
    assert not bool(split.alive.any())
    assert not bool((split.sample.to(torch.int64) + stride < s1).any())
    live = state.alive & (first >= s1)          # a live path and no sample after it
    assert torch.equal(split.sample[live], state.sample[live])

    # the kernel's order: chunk 0 from the given state, a lane's items
    # added in chunk order from zero
    lane, a, b, chunks = integrator.item_windows(first, s1, stride, chunk)
    start_st = integrator.initial_regen_state(a, stride)
    given = integrator.RegenState(*(
        torch.cat([g, f[n:]]) if isinstance(g, torch.Tensor)
        else zt.math.v3.V3(*(torch.cat([x, y[n:]]) for x, y in zip(g, f)))
        for g, f in zip(state, start_st)))
    items = integrator.bounce_regen_reference(cs, given, px[lane], py[lane], b, seed,
                                              zt.dtypes.T_MIN, **kw).radiance.to_array()
    acc = torch.zeros((n, 3))
    for c in range(chunks):
        acc = acc + items[c * n:(c + 1) * n]
    assert torch.equal(split.radiance.to_array(), acc)
