"""The readers of the bounce kernel K2's metrics and of its driver's span
(``k2_roofline``, ``k2.slot_occupancy``, ``k2.lane_efficiency``,
``driver.regen_launch_ms``) on a synthetic trace summary and a synthetic
snapshot of the port's profiler, and on runs and programs without their
data: a program that recorded nothing, one without such a profiler, and
one that records K1's counters only (as before K2 recorded its own)."""

import sys
import types

import pytest

from benchmark import harness, spec

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"
PROGRAM_READERS = ("k2.slot_occupancy", "k2.lane_efficiency", "driver.regen_launch_ms")


def _run(**kw):
    cell = spec.resolve(spec.load_spec(), "rtw_final.book2")
    base = dict(traffic=cell.traffic, setup_s=10.5, window_s=30.0, requests=1100,
                paths_per_request=400 * 400 * 64, latency_ms=[27.0])
    base.update(kw)
    return harness.Run(**base)


def _span(name, start_ms, end_ms, image, parent=-1):
    return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "parent": parent, "image_id": image}


SNAPSHOT = {
    "images": 2,
    "spans": [
        _span("Renderer::render", 0, 30, 0), _span("render.plan", 0.5, 1.5, 0, 0),
        _span("rayColorLine", 2, 29, 0, 0), _span("render.regen.poll", 2, 2.2, 0, 2),
        _span("render.regen.launch", 2.2, 5.2, 0, 2),
        _span("render.regen.launch.wait", 2.5, 4, 0, 4),
        _span("render.regen.poll", 5.2, 28.8, 0, 2),
        _span("Renderer::render", 30, 60, 1), _span("rayColorLine", 31, 59, 1, 7),
        _span("render.regen.launch", 31.5, 32.5, 1, 8),
    ],
    "counters": {"plan.miss.coherent": 2, "k2.launches": 2, "k2.lane_work": 810,
                 "k2.warp_work": 900, "k2.block_ns": 30, "k2.slot_ns": 60},
}


def _program(monkeypatch, snapshot):
    module = types.ModuleType(PROFILER)
    if snapshot is not None:
        module.snapshot = lambda: snapshot
    monkeypatch.setitem(sys.modules, PROFILER, module)


def test_program_readers_on_a_synthetic_snapshot(monkeypatch):
    _program(monkeypatch, SNAPSHOT)
    read = {name: spec.load_reader(name)(_run()) for name in PROGRAM_READERS}
    assert read["k2.slot_occupancy"] == pytest.approx(50.0)
    assert read["k2.lane_efficiency"] == pytest.approx(90.0)
    # the launch spans, not their waits or the polls, over the images
    assert read["driver.regen_launch_ms"] == pytest.approx((3.0 + 1.0) / 2)


@pytest.mark.parametrize("snapshot", [
    None,                                                    # no snapshot(): an older program
    {"images": 0, "spans": [], "counters": {}},              # recorded nothing
    {**SNAPSHOT, "images": 0},
    # a program whose K2 records nothing: K1's counters, no regen spans
    {"images": 2, "spans": [_span("Renderer::render", 0, 30, 0)],
     "counters": {"k1.lane_work": 3, "k1.warp_work": 4, "k1.block_ns": 1, "k1.slot_ns": 2}},
])
def test_program_readers_read_nothing_without_their_data(monkeypatch, snapshot):
    _program(monkeypatch, snapshot)
    for name in PROGRAM_READERS:
        assert spec.load_reader(name)(_run()) is None, name


def test_program_readers_read_nothing_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, PROFILER, raising=False)
    for name in PROGRAM_READERS:
        assert spec.load_reader(name)(_run()) is None, name


def test_k2_readers_need_only_their_own_counters(monkeypatch):
    # a program on the CPU records lane work but no block stamps
    _program(monkeypatch, {**SNAPSHOT, "counters": {"k2.lane_work": 3, "k2.warp_work": 4}})
    assert spec.load_reader("k2.slot_occupancy")(_run()) is None
    assert spec.load_reader("k2.lane_efficiency")(_run()) == pytest.approx(75.0)
    assert spec.load_reader("driver.regen_launch_ms")(_run()) == pytest.approx(2.0)


TRACE = {"window_s": 5.0, "busy_s": 4.3,
         "kernels": {"zwrt::bounce_kernel": (180, 4.26), "zwrt::coherent_keys_kernel": (180, 0.015),
                     "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel": (720, 0.012)}}


def test_k2_roofline_on_a_synthetic_trace():
    run = _run(trace=TRACE, traced_requests=180, k1_bound_ms=1.614)
    assert spec.load_reader("k2_roofline")(run) == pytest.approx(100 * 1.614 / (4260 / 180))
    # K1 reads nothing where K2 ran alone
    assert spec.load_reader("k1_roofline")(run) is None


@pytest.mark.parametrize("kw", [
    {},                                                          # no trace
    {"trace": TRACE, "traced_requests": 180},                    # no count
    {"trace": TRACE, "traced_requests": 0, "k1_bound_ms": 1.6},  # no image traced
    {"trace": {**TRACE, "kernels": {"zwrt::fused_render_kernel": (9, 0.2)}},
     "traced_requests": 9, "k1_bound_ms": 1.6},                  # no K2 launch
])
def test_k2_roofline_reads_nothing_without_its_data(kw):
    assert spec.load_reader("k2_roofline")(_run(**kw)) is None
