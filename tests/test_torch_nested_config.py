"""The nested-checker configuration of the benchmark
(``benchmark/configs/nested.json``, the cell ``nested.fixed_depth``) on the
CPU at tiny sizes: the scene file is ``benchmark/configs/balls.json`` with
its ground checker nested, and the port's ``load_scene("nested")``; the
port sends it down
the fixed-depth wavefront (``render/integrator.py:trace_paths``), where
the port's image agrees with the benchmark's plain reference
(``benchmark/check.py:reference_pixels``) and the reference's bfloat16
copy does not; and the wavefront's spans and counters
(``render.fixed.sync``, ``render.fixed.bounce``, ``fixed.bounces``,
``fixed.lane_slots``, ``fixed.live_lanes``) with the three readers of the
benchmark that read them (``benchmark/metrics/fixed_depth_roofline.py``,
``fixed.live_share.py``, ``driver.fixed_sync_ms.py``)."""

import json
import os

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from benchmark import check, control, spec
from benchmark.harness import Run
from zig_weekend_raytracer_tpu_torch.models import load_scene, load_scene_file
from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_bounce_kernel
from zig_weekend_raytracer_tpu_torch.render import camera, integrator
from zig_weekend_raytracer_tpu_torch.utils import profiler

CELL = spec.resolve(spec.load_spec(), "nested.fixed_depth")
BALLS = os.path.join(os.path.dirname(CELL.config_path), "balls.json")
# the agreement's size: every pixel of a 16x16 image at 8 samples, depth 6
SIZE, SPP, DEPTH = 16, 8, 6
TRAFFIC = {"width": SIZE, "height": SIZE, "spp": SPP, "depth": DEPTH}
SEEDS = (2**31 + 2601, 3226000517)
# Over the reference's mean |value|.  The port and the reference trace the
# same paths in float32 and differ only in the order of the sums (a chunk's
# samples against a lane's): 4.9e-08 mean and 1.8e-07 max were measured.
MEAN_TOL, MAX_TOL = 1e-6, 1e-5
READERS = ("fixed_depth_roofline", "fixed.live_share", "driver.fixed_sync_ms")


@pytest.fixture(autouse=True)
def fresh_records():
    was = profiler.profiling_enabled()
    profiler.set_profiling(False)
    profiler.reset_zones()
    yield
    profiler.set_profiling(was)
    profiler.reset_zones()


@pytest.fixture(scope="module")
def scene():
    return load_scene_file(CELL.config_path, device="cpu")


@pytest.fixture(scope="module")
def images(scene):
    """The port's image at each seed, rendered once for every case."""
    cache = {}

    def image(seed):
        if seed not in cache:
            r = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=seed)
            cache[seed] = r.render_device(scene, SIZE, SIZE)
        return cache[seed]

    return image


def test_scene_file_is_balls_with_its_ground_nested():
    """The file is ``balls.json`` key for key, but for its notes and the
    ground's checker, whose even cells now hold a checker of the ground's
    two colours at scale 2.0."""
    with open(CELL.config_path) as f:
        nested = json.load(f)
    with open(BALLS) as f:
        balls = json.load(f)
    assert set(nested) - set(balls) == {"about", "assumed"}
    for key in balls:
        if key != "textures":
            assert nested[key] == balls[key], key
    tex = nested["textures"]
    assert {k: v for k, v in tex.items() if k != "inner"} | {"ground": None} == \
        balls["textures"] | {"ground": None}
    assert tex["inner"] == {"checker": {"inv_scale": 2.0, "even": "even", "odd": "odd"}}
    assert tex["ground"] == {"checker": {"inv_scale": 0.32, "even": "inner", "odd": "odd"}}
    assert balls["textures"]["ground"] == {
        "checker": {"inv_scale": 0.32, "even": "even", "odd": "odd"}}


GEOMETRY = ("sph_center", "sph_radius", "sph_mat", "mat_type", "mat_albedo", "mat_fuzz",
            "mat_refract", "sph_tree_box", "sph_tree_link")


def test_scene_is_the_balls_builtin_but_its_ground(scene):
    """``load_scene("nested")`` (the file's builtin) is ``load_scene("balls")``
    in geometry, materials, sphere trees, camera and background; only the
    ground's texture is a checker of checkers."""
    balls = load_scene("balls", device="cpu")
    builtin = load_scene("nested", device="cpu")
    for s in (builtin, scene):
        assert s.camera == balls.camera and s.background == balls.background
        a, b = balls.compiled, s.compiled
        assert (a.n_spheres, a.n_quads, a.n_materials) == (b.n_spheres, b.n_quads,
                                                          b.n_materials) == (485, 0, 485)
        for field in GEOMETRY:
            u, v = getattr(a, field), getattr(b, field)
            pairs = zip(u, v) if isinstance(u, tuple) else ((u, v),)
            assert all(torch.equal(x, y) for x, y in pairs), field
        assert not a.has_nested_checker and b.has_nested_checker
    cs = builtin.compiled
    checkers = [t for t in range(len(cs.tex_type)) if int(cs.tex_type[t]) == 1]
    assert len(checkers) == 2
    ground = next(t for t in checkers if int(cs.tex_even[t]) in checkers)
    inner, odd = int(cs.tex_even[ground]), int(cs.tex_odd[ground])
    assert ground in {int(cs.mat_tex[m]) for m in range(cs.n_materials)}
    assert float(cs.tex_inv_scale[ground]) == pytest.approx(0.32)
    assert float(cs.tex_inv_scale[inner]) == 2.0 and int(cs.tex_odd[inner]) == odd


def test_scene_takes_the_fixed_depth_wavefront(scene, monkeypatch):
    cs = scene.compiled
    assert cs.has_nested_checker and cs.has_sph_tree and not cs.has_image_textures
    assert not supports_bounce_kernel(cs)
    for fn in (integrator.trace_paths, integrator.render_fused_reference,
               integrator.bounce_regen_reference):
        monkeypatch.setattr(fn, "bounces" if fn is integrator.trace_paths else "calls", 0)
    zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=5).render_device(
        scene, 8, 8)
    assert integrator.trace_paths.bounces > 0
    assert integrator.render_fused_reference.calls == 0
    assert integrator.bounce_regen_reference.calls == 0


@pytest.mark.parametrize("package,seed,agrees", [
    (check.REFERENCE, SEEDS[0], True),
    (check.REFERENCE, SEEDS[1], True),
    ("bfloat16", SEEDS[0], False),
])
def test_port_against_the_reference(images, package, seed, agrees):
    """Every pixel of the port's image within MEAN_TOL and MAX_TOL of the
    float32 reference; the bfloat16 copy of the reference, the precision
    below the configuration's, outside at least one of them."""
    if package == "bfloat16":
        package = control.low_precision_package()
    ref_scene = check.reference_scene(CELL.config_path, "cpu", package=package)
    ys, xs = (a.reshape(-1) for a in np.meshgrid(np.arange(SIZE), np.arange(SIZE),
                                                  indexing="ij"))
    ref = check.reference_pixels(ref_scene, TRAFFIC, seed % 2**32, xs, ys, package=package)
    assert float(ref.abs().mean()) > 0
    mean_rel, max_rel = check.rel_gaps(images(seed % 2**32)[ys, xs], ref)
    assert (mean_rel <= MEAN_TOL and max_rel <= MAX_TOL) == agrees, (mean_rel, max_rel)


def _camera_rays(scene, n_side=8):
    """One camera ray a pixel of an n_side x n_side image, sample 0."""
    px, py = (torch.as_tensor(a.reshape(-1), dtype=torch.int64) for a in np.meshgrid(
        np.arange(n_side), np.arange(n_side), indexing="xy"))
    sidx = torch.zeros_like(px)
    ray_id = py * n_side + px
    origin, direction, time = camera.generate_rays(
        camera.camera_params(scene.camera, n_side, n_side), False,
        zt.render.Renderer().sampler, 7, ray_id, px, py, sidx, 1, n_side, n_side)
    return origin, direction, time, ray_id


class _Watched(torch.Tensor):
    """The lanes' alive mask as ``trace_paths`` holds it between bounces,
    logging the reads of it that ``trace_paths`` makes."""

    log: list = []

    def any(self, *a, **k):
        _Watched.log.append("any")
        return super().any(*a, **k)

    def sum(self, *a, **k):
        _Watched.log.append("sum")
        return super().sum(*a, **k)


def _watch_bounces(monkeypatch):
    """Wraps ``integrator.bounce``: each call's live lanes entering it, and
    its alive mask handed back watched (the bounce itself sees a plain
    tensor)."""
    bounce, live = integrator.bounce, []
    _Watched.log = []

    def watched(*args, **kw):
        args = list(args)
        alive = args[10].as_subclass(torch.Tensor)
        live.append(int(alive.sum()))
        args[10] = alive
        out = bounce(*args, **kw)
        return (*out[:4], out[4].as_subclass(_Watched))

    watched.calls = 0  # the module's name ``bounce`` now counts here
    monkeypatch.setattr(integrator, "bounce", watched)
    return live


@pytest.mark.parametrize("max_depth", [3, 10])
def test_trace_paths_records_its_bounces(scene, monkeypatch, max_depth):
    origin, direction, time, ray_id = _camera_rays(scene)
    live = _watch_bounces(monkeypatch)
    monkeypatch.setattr(integrator.trace_paths, "bounces", 0)
    profiler.set_profiling(True)
    integrator.trace_paths(scene.compiled, origin, direction, time, 7, ray_id, max_depth)
    snap = profiler.snapshot()
    bounces = integrator.trace_paths.bounces
    names = [s["name"] for s in snap["spans"]]
    # a read before each bounce, and one more that finds no lane alive
    # when every path ended before max_depth
    assert names.count("render.fixed.bounce") == bounces == len(live)
    assert names.count("render.fixed.sync") == bounces + (bounces < max_depth)
    assert all(s["end_ns"] >= s["start_ns"] > 0 for s in snap["spans"])
    c = snap["counters"]
    assert c["fixed.bounces"] == bounces
    assert c["fixed.lane_slots"] == bounces * origin.shape[0]
    assert c["fixed.live_lanes"] == sum(live) <= c["fixed.lane_slots"]
    assert live[0] == origin.shape[0] and _Watched.log and set(_Watched.log) == {"sum"}


def test_trace_paths_reads_only_any_while_off(scene, monkeypatch):
    origin, direction, time, ray_id = _camera_rays(scene)
    live = _watch_bounces(monkeypatch)
    assert not profiler.recording()
    integrator.trace_paths(scene.compiled, origin, direction, time, 7, ray_id, 4)
    assert len(live) > 1 and _Watched.log and set(_Watched.log) == {"any"}
    assert profiler.snapshot() == {"spans": [], "counters": {}, "images": 0}


def test_readers_read_the_recorded_render(scene):
    profiler.set_profiling(True)
    zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=3).render_device(
        scene, 8, 8)
    snap = profiler.snapshot()
    c = snap["counters"]
    syncs = [s for s in snap["spans"] if s["name"] == "render.fixed.sync"]
    assert snap["images"] == 1 and syncs
    # every span of the wavefront lies inside a chunk's rayColorLine
    for s in syncs:
        assert snap["spans"][s["parent"]]["name"] == "rayColorLine"
    run = Run(traffic={}, setup_s=0.0, window_s=1.0, requests=1, paths_per_request=1,
              latency_ms=[1.0])
    assert spec.load_reader("fixed.live_share")(run) == pytest.approx(
        100.0 * c["fixed.live_lanes"] / c["fixed.lane_slots"])
    assert spec.load_reader("driver.fixed_sync_ms")(run) == pytest.approx(
        sum(s["end_ns"] - s["start_ns"] for s in syncs) / 1e6)
    assert spec.load_reader("fixed_depth_roofline")(run) is None


def test_roofline_reader_on_a_built_run():
    trace = {"busy_s": 2.0, "window_s": 2.5, "kernels": {
        "closest_hit_kernel": (40, 0.1), "at::native::elementwise_kernel": (900, 1.8)}}
    run = Run(traffic={}, setup_s=0.0, window_s=1.0, requests=1, paths_per_request=1,
              latency_ms=[1.0], trace=trace, traced_requests=4, k1_bound_ms=5.0)
    read = spec.load_reader("fixed_depth_roofline")
    # 5 ms of bound over 2000 ms busy / 4 images
    assert read(run) == pytest.approx(1.0)
    for kw in ({"trace": None}, {"k1_bound_ms": None}, {"traced_requests": 0},
               {"trace": {**trace, "kernels": {"fused_render_kernel": (4, 1.9)}}}):
        assert read(Run(**{**run.__dict__, **kw})) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_their_data(name):
    run = Run(traffic={}, setup_s=0.0, window_s=1.0, requests=1, paths_per_request=1,
              latency_ms=[1.0])
    assert spec.load_reader(name)(run) is None
    profiler.set_profiling(True)
    with profiler.named_zone("Renderer::render", image=True):
        profiler.count("k1.lane_work", 3)
    assert spec.load_reader(name)(run) is None
