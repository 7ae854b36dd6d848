"""The coherent lane plan of tree scenes (``render/renderer.py:
coherent_plan``): on the CPU its plain version against the NumPy plan the
renderer built before it (the eager first-hit probe, ``np.lexsort`` of
(lane, hit key) on the host, the lanes uploaded); on the card
(``card`` tests, skipped without one: ``python -m pytest --noconftest -m
card tests/test_torch_coherent_plan.py`` there) the keys of one launch of
``coherent_keys_kernel`` (with the lane index the renderer ORs in) against
the eager probe, the image over the
card-built plan against the image over the host-built plan, and the build
without a host sync."""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
from zig_weekend_raytracer_tpu_torch.render import renderer as rmod
from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
from zig_weekend_raytracer_tpu_torch.sampling.sampler import SamplerKind

_SCENES = {}


def _tree_scene(device):
    """A seeded scene with a sphere tree (half its spheres moving) and a
    multi-node quad tree, seen through a lens."""
    rng = np.random.default_rng(20)
    b = zt.scene.SceneBuilder()
    mats = [b.lambertian(b.solid_color(tuple(rng.uniform(0.1, 0.9, 3)))) for _ in range(4)]
    mats += [b.metal((0.8, 0.8, 0.9), 0.1), b.dielectric(1.5)]
    for i in range(120):
        c = rng.uniform(-8, 8, 3)
        r = float(rng.uniform(0.2, 0.8))
        b.add(b.moving_sphere(c, c + rng.uniform(-0.5, 0.5, 3), r, mats[i % 6]) if i % 2
              else b.sphere(c, r, mats[i % 6]))
    for i in range(300):
        b.add(b.quad(rng.uniform(-8, 8, 3), rng.uniform(-1.5, 1.5, 3), rng.uniform(-1.5, 1.5, 3),
                     mats[i % 6]))
    b.set_background((0.5, 0.6, 0.9))
    b.set_camera(zt.scene.Camera(look_from=(0.0, 2.0, 24.0), look_at=(0.0, 0.0, 0.0),
                                 vfov_degrees=45.0, focus_dist=24.0,
                                 defocus_angle_degrees=0.4))
    b.use_bvh(True, min_prims=2)
    return b.compile("trees", device=device)


def _scene(name, device="cpu"):
    if (name, device) not in _SCENES:
        _SCENES[name, device] = (_tree_scene(device) if name == "trees"
                                 else zt.models.load_scene(name, device=device))
    return _SCENES[name, device]


def test_the_tree_scene_has_both_trees():
    cs = _scene("trees").compiled
    assert cs.has_sph_tree and cs.has_quad_tree and cs.has_moving
    assert cs.quad_tree_box.shape[0] > 1


def _host_plan(scene, seed, band_y0, rows_eff, band_rows, *, width, height, spp, sampler,
               has_dof, cam_consts):
    """The plan as the renderer built it on the host: the eager probe,
    its keys fetched, ``np.lexsort`` of (lane, hit key), four uploads."""
    cs = scene.compiled
    ys, xs = np.divmod(np.arange(rows_eff * width), width)
    i64 = lambda a: torch.as_tensor(a.astype(np.int64), device=cs.device)
    kind, idx = rmod._first_hit_probe(
        scene, seed, i64(xs), i64(ys + band_y0), width=width, height=height, spp=spp,
        sampler=sampler, has_dof=has_dof, cam_consts=cam_consts,
    )
    kind = kind.cpu().numpy().astype(np.int64)
    idx = idx.cpu().numpy().astype(np.int64)
    hit_key = np.where(kind < 0, -1, (kind << 24) + idx)
    tile = rmod.pick_tile(width, band_rows)
    lane_ord = rmod.tile_order_lane_index(width, band_rows, tile)[:rows_eff]
    order = np.lexsort((lane_ord.reshape(-1), hit_key))
    return tuple(
        torch.as_tensor(np.asarray(a, np.int32), device=cs.device)
        for a in (xs[order], ys[order] + band_y0, np.zeros(order.size), np.full(order.size, spp))
    )


# (scene, sampler, depth of field, width, height, band_y0, rows_eff, band_rows)
CASES = [
    # tiled, the last band of an image cut short: rows_eff < band_rows
    ("balls", SamplerKind.SOBOL, True, 64, 40, 32, 8, 32),
    ("balls", SamplerKind.INDEPENDENT, False, 64, 32, 0, 32, 32),
    ("balls", SamplerKind.STRATIFIED, True, 64, 64, 32, 32, 32),
    # flat (untiled) tiny bands, one of them cut short
    ("balls", SamplerKind.STRATIFIED, False, 8, 8, 0, 8, 8),
    ("balls", SamplerKind.SOBOL, True, 16, 13, 8, 5, 8),
    # sphere and quad trees, moving spheres
    ("trees", SamplerKind.SOBOL, False, 64, 40, 32, 8, 32),
    ("trees", SamplerKind.INDEPENDENT, True, 8, 8, 0, 8, 8),
    ("trees", SamplerKind.STRATIFIED, True, 16, 13, 8, 5, 8),
]


@pytest.mark.parametrize("name, sampler, has_dof, w, h, y0, rows, band_rows", CASES)
def test_plain_plan_is_the_host_plan(name, sampler, has_dof, w, h, y0, rows, band_rows):
    scene = _scene(name)
    kw = dict(width=w, height=h, spp=16, sampler=sampler, has_dof=has_dof,
              cam_consts=camera_consts(scene.camera, w, h))
    got = rmod.coherent_plan(scene, 11, y0, rows, band_rows, **kw)
    want = _host_plan(scene, 11, y0, rows, band_rows, **kw)
    for g, e in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert torch.equal(g, e)
    # a pure permutation of the band's pixels, every sample on one lane
    pix = (got[1].long() - y0) * w + got[0].long()
    assert torch.equal(torch.sort(pix).values, torch.arange(rows * w))


LANE_SHAPES = [(64, 32, 32), (400, 400, 32), (70, 45, 32), (16, 13, None), (8, 8, None)]


@pytest.mark.parametrize("width, rows, tile", LANE_SHAPES)
def test_lane_order_on_a_device_is_the_host_order(width, rows, tile):
    """The keys' lane words come from the one formula of the tiled lane
    order, made on the plan's device: the host's array, value for value."""
    on_device = rmod.tile_order_lane_index(width, rows, tile, torch.device("cpu"))
    host = rmod.tile_order_lane_index(width, rows, tile)
    assert on_device.dtype == torch.int64 and host.shape == (rows, width)
    assert torch.equal(on_device, torch.from_numpy(host))
    if tile is None:
        assert np.array_equal(host.reshape(-1), np.arange(rows * width))
    else:
        # a pixel's lane is its tile's first lane plus its place in the tile
        y, x = rows - 1, width - 1
        nbx = -(-width // tile)
        assert host[y, x] == ((y // tile) * nbx + x // tile) * tile * tile \
            + (y % tile) * tile + x % tile
    assert len(np.unique(host)) == rows * width


def test_keys_hold_hit_and_lane():
    scene = _scene("balls")
    w, h = 64, 32
    cam = camera_consts(scene.camera, w, h)
    keys = rmod.coherent_plan_keys(scene, 2, 0, h, rmod.pick_tile(w, h), width=w, height=h, spp=4,
                              sampler=SamplerKind.SOBOL, has_dof=True, cam_consts=cam)
    lane = torch.from_numpy(rmod.tile_order_lane_index(w, h, rmod.TILE).reshape(-1))
    assert keys.dtype == torch.int64 and torch.equal(keys & 0xFFFFFFFF, lane)
    pix = torch.arange(w * h)
    kind, idx = rmod._first_hit_probe(scene, 2, pix % w, pix // w, width=w, height=h, spp=4,
                                      sampler=SamplerKind.SOBOL, has_dof=True, cam_consts=cam)
    hit = (keys >> 32) - 1
    assert torch.equal(hit < 0, kind < 0) and bool((hit < 0).any()) and bool((hit >= 0).any())
    assert torch.equal(hit[kind >= 0], idx[kind >= 0].long())


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: coherent_keys_kernel runs on the card only")


CARD_CASES = [("balls", 64), ("balls", 400), ("trees", 400)]


def _card_renderer(seed=0):
    # one sample in flight a pixel, one band
    return zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=5, seed=seed,
                              regen_min_wave=1)


@pytest.mark.card
@pytest.mark.parametrize("name, size", CARD_CASES)
def test_card_keys_match_the_eager_probe(card, name, size):
    scene = _scene(name, "cuda")
    cam = camera_consts(scene.camera, size, size)
    tile = rmod.pick_tile(size, size)
    launches = ch.coherent_keys.launches
    for sampler in SamplerKind:
        kw = dict(width=size, height=size, spp=16, sampler=sampler,
                  has_dof=scene.camera.has_depth_of_field, cam_consts=cam)
        high = ch.coherent_keys(scene.compiled, 9, 0, size, rmod.PROBE_T_MIN,
                                camera_consts=cam, **{k: v for k, v in kw.items()
                                                      if k != "cam_consts"})
        assert not bool((high & 0xFFFFFFFF).any())   # the low word is the renderer's
        keys = rmod.coherent_plan_keys(scene, 9, 0, size, tile, **kw)
        pix = torch.arange(size * size, device="cuda")
        kind, idx = rmod._first_hit_probe(scene, 9, pix % size, pix // size, **kw)
        eager = torch.where(kind < 0, -1, (kind.long() << 24) + idx)
        lane = torch.from_numpy(rmod.tile_order_lane_index(size, size, tile).reshape(-1))
        assert torch.equal((keys & 0xFFFFFFFF).cpu(), lane)
        differ = int(((keys >> 32) - 1 != eager).sum())
        print(f"{name} {size}x{size} {sampler.name}: {differ} of {size * size} keys differ "
              "from the eager probe's")
        assert differ <= 1e-3 * size * size
    assert ch.coherent_keys.launches == launches + 2 * len(SamplerKind)


@pytest.mark.card
@pytest.mark.parametrize("name, size", CARD_CASES)
def test_card_plan_image_is_the_host_plan_image(card, name, size):
    scene = _scene(name, "cuda")
    r = _card_renderer(seed=4)
    assert r.regen_geometry(size, size, r.samples_per_pixel) == (1, size)
    on_card = r.render_device(scene, size, size)
    ((key, entry),) = r._plan_cache[scene.compiled].items()
    assert key[0] == "coh"
    host = _host_plan(scene, r.seed, 0, size, size, width=size, height=size,
                      spp=r.samples_per_pixel, sampler=r.sampler,
                      has_dof=scene.camera.has_depth_of_field,
                      cam_consts=camera_consts(scene.camera, size, size))
    moved = int((entry["plan"][0] != host[0]).sum() + (entry["plan"][1] != host[1]).sum())
    print(f"{name} {size}x{size}: {moved} lane coordinates differ between the plans")
    entry["plan"] = host
    on_host = r.render_device(scene, size, size)
    # each lane owns one pixel's whole sample range, so the lane order
    # cannot move a pixel's sum
    assert torch.equal(on_card, on_host)


@pytest.mark.card
def test_card_plan_build_does_not_wait_for_the_card(card):
    scene = _scene("balls", "cuda")
    size = 400
    _card_renderer().render_device(scene, size, size)   # the launch's tables, once
    kw = dict(width=size, height=size, spp=16, sampler=SamplerKind.SOBOL, has_dof=True,
              cam_consts=camera_consts(scene.camera, size, size))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = rmod.coherent_plan(scene, 123, 0, size, size, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = _host_plan(scene, 123, 0, size, size, **kw)
    pix = (plan[1].long() * size + plan[0].long()).cpu()
    assert torch.equal(torch.sort(pix).values, torch.arange(size * size))
    assert torch.equal(plan[2], host[2]) and torch.equal(plan[3], host[3])
