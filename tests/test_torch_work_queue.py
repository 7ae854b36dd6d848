"""The render kernel's work queue on the CPU: the chunk rule
(``ops/fused_render.py:item_chunk``), its items (``render/integrator.py:
item_windows``) and the plain version over them
(``render_fused_items_reference``).  For each split the items cover every
sample of every lane once and in order, and the plain version rendered
item by item and summed in the kernel's chunk order equals the unsplit
render within float32 rounding, each lane's work count exactly."""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

SPP = 13


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


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
