"""The readers of the metrics that the program records itself
(``driver.plan_ms``, ``k1.slot_occupancy``, ``k1.lane_efficiency`` and
their ``.trees`` cells) on a synthetic snapshot of the port's profiler, and
on programs that recorded nothing or have no such profiler."""

import sys
import types

import pytest

from benchmark import harness, spec

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"
READERS = ("driver.plan_ms", "k1.slot_occupancy", "k1.slot_occupancy.trees",
           "k1.lane_efficiency", "k1.lane_efficiency.trees")


def _run():
    cell = spec.resolve(spec.load_spec(), "balls.canonical")
    return harness.Run(traffic=cell.traffic, setup_s=7.5, window_s=30.0, requests=300,
                       paths_per_request=400 * 400 * 128, latency_ms=[1.0])


def _span(name, start_ms, end_ms, image, parent=-1):
    return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "parent": parent, "image_id": image}


SNAPSHOT = {
    "images": 2,
    "spans": [
        _span("Renderer::render", 0, 60, 0), _span("render.plan", 1, 31, 0, 0),
        _span("render.plan.sort", 5, 25, 0, 1), _span("rayColorLine", 31, 59, 0, 0),
        _span("Renderer::render", 60, 100, 1), _span("render.plan", 61, 71, 1, 4),
        _span("rayColorLine", 71, 99, 1, 4),
    ],
    "counters": {"plan.miss.coherent": 2, "k1.lane_work": 600, "k1.warp_work": 800,
                 "k1.block_ns": 45, "k1.slot_ns": 60},
}


def _program(monkeypatch, snapshot):
    module = types.ModuleType(PROFILER)
    if snapshot is not None:
        module.snapshot = lambda: snapshot
    monkeypatch.setitem(sys.modules, PROFILER, module)


def test_readers_on_a_synthetic_snapshot(monkeypatch):
    _program(monkeypatch, SNAPSHOT)
    run = _run()
    read = {name: spec.load_reader(name)(run) for name in READERS}
    assert read["driver.plan_ms"] == pytest.approx((30 + 10) / 2)
    assert read["k1.slot_occupancy"] == read["k1.slot_occupancy.trees"] == pytest.approx(75.0)
    assert read["k1.lane_efficiency"] == read["k1.lane_efficiency.trees"] == pytest.approx(75.0)


@pytest.mark.parametrize("snapshot", [
    None,                                                    # no snapshot(): an older program
    {"images": 0, "spans": [], "counters": {}},              # recorded nothing
    {**SNAPSHOT, "images": 0},
])
def test_readers_read_nothing_from_a_program_that_recorded_no_image(monkeypatch, snapshot):
    _program(monkeypatch, snapshot)
    for name in READERS:
        assert spec.load_reader(name)(_run()) is None, name


def test_readers_read_nothing_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, PROFILER, raising=False)
    for name in READERS:
        assert spec.load_reader(name)(_run()) is None, name


def test_k1_readers_read_nothing_without_their_counters(monkeypatch):
    # a program on the CPU records lane work but no block stamps
    _program(monkeypatch, {**SNAPSHOT, "counters": {"k1.lane_work": 3, "k1.warp_work": 4}})
    assert spec.load_reader("k1.slot_occupancy")(_run()) is None
    assert spec.load_reader("k1.lane_efficiency")(_run()) == pytest.approx(75.0)
    _program(monkeypatch, {**SNAPSHOT, "counters": {}})
    assert spec.load_reader("k1.lane_efficiency")(_run()) is None
    assert spec.load_reader("driver.plan_ms")(_run()) == pytest.approx(20.0)
