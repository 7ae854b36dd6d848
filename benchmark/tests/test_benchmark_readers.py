"""The metric readers on a synthetic run record (a CPU run reports no
device number, so its readers are tested here)."""

import math

import pytest

from benchmark import harness, spec


def _run(**kw):
    cell = spec.resolve(spec.load_spec(), "balls.canonical")
    base = dict(traffic=cell.traffic, setup_s=7.5, window_s=30.0, requests=300,
                paths_per_request=400 * 400 * 128, latency_ms=[float(i) for i in range(1, 101)])
    base.update(kw)
    return harness.Run(**base)


def test_end_to_end_readers():
    run = _run()
    assert spec.load_reader("setup_s")(run) == 7.5
    assert math.isclose(spec.load_reader("mpaths_per_s")(run), 300 * 20.48e6 / 30 / 1e6)
    assert math.isclose(spec.load_reader("image_ms_p95")(run), 95.05)


def test_trace_readers_read_nothing_without_a_trace():
    run = _run()
    for name in ("k1_roofline", "device.idle_share.render"):
        assert spec.load_reader(name)(run) is None


def test_trace_readers():
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "kernels": {"fused_render_kernel": (10, 0.7), "closest_hit_kernel": (1, 0.01)}}
    run = _run(trace=trace, traced_requests=10, k1_bound_ms=16.0)
    assert spec.load_reader("k1_roofline")(run) == pytest.approx(100 * 16.0 / 70.0)
    assert spec.load_reader("device.idle_share.render")(run) == pytest.approx(25.0)
    for split, base in (("k1_roofline.trees", "k1_roofline"),
                        ("device.idle_share.trees", "device.idle_share.render"),
                        ("mpaths_per_s.trees", "mpaths_per_s")):
        assert spec.load_reader(split)(run) == spec.load_reader(base)(run)
    run.trace = {**trace, "kernels": {}}
    assert spec.load_reader("k1_roofline")(run) is None
