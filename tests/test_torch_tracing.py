"""The port's tracing (``utils/profiler.py``) and what records it: the
render driver's spans and plan-cache counters (``render/renderer.py``) and
K1's lane and block counters (``ops/fused_render.py``), on the CPU at
tiny sizes; the block stamps of the CUDA kernel on the card (the ``card``
test, skipped without one: ``python -m pytest --noconftest -m card
tests/test_torch_tracing.py`` there, since this directory's conftest
imports JAX)."""

import json

import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
from zig_weekend_raytracer_tpu_torch.utils import profiler

PLAN_STAGES = ("render.plan.probe", "render.plan.fetch", "render.plan.sort",
               "render.plan.upload")
# the coherent plan's stages: its keys and their sort, with no copy between
# host and card
COHERENT_STAGES = ("render.plan.probe", "render.plan.sort")


@pytest.fixture(autouse=True)
def fresh_records():
    was = profiler.profiling_enabled()
    profiler.set_profiling(False)
    profiler.reset_zones()
    yield
    profiler.set_profiling(was)
    profiler.reset_zones()


@pytest.fixture(scope="module")
def balls():
    return zt.models.load_scene("balls", device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


def _renderer(seed=0):
    # one sample in flight a pixel at 8x8, so the lane plans are built
    return zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=seed,
                              regen_min_wave=1)


def _under_profiler(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_nothing_is_recorded_while_off(cornell, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiler.recording()
    _renderer().render_device(cornell, 8, 8)
    profiler.count("plan.hit.sorted")
    profiler.count("k1.lane_work", torch.tensor(3))
    assert profiler.snapshot() == {"spans": [], "counters": {}, "images": 0}


def test_the_profiler_or_profiling_turns_recording_on():
    assert not profiler.recording()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler.recording()
    assert not profiler.recording()
    profiler.set_profiling(True)
    assert profiler.recording()


def test_coherent_plan_spans_nest_in_one_image(balls):
    r = _renderer()
    _under_profiler(lambda: r.render_device(balls, 8, 8))
    snap = profiler.snapshot()
    assert snap["images"] == 1
    assert snap["counters"]["plan.miss.coherent"] == 1
    assert "plan.hit.coherent" not in snap["counters"]
    # built by the plain version on the CPU, not by the card's launch
    assert "plan.card.coherent" not in snap["counters"]
    (image,) = _by_name(snap, "Renderer::render")
    (plan,) = _by_name(snap, "render.plan")
    spans = snap["spans"]
    assert spans[plan["parent"]] is image
    stages = [s for s in spans if s["parent"] >= 0 and spans[s["parent"]] is plan]
    assert [s["name"] for s in stages] == list(COHERENT_STAGES)
    assert {s["image_id"] for s in spans} == {0}
    for child, parent in [(plan, image)] + [(s, plan) for s in stages]:
        assert parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert len(_by_name(snap, "rayColorLine")) == 1
    assert len(_by_name(snap, "render.accumulate")) == 2


def test_a_second_render_of_the_seed_hits_the_coherent_plan(balls):
    r = _renderer()
    _under_profiler(lambda: [r.render_device(balls, 8, 8) for _ in range(2)])
    snap = profiler.snapshot()
    assert snap["images"] == 2
    assert snap["counters"]["plan.miss.coherent"] == 1
    assert snap["counters"]["plan.hit.coherent"] == 1
    assert [s["image_id"] for s in _by_name(snap, "render.plan")] == [0]
    assert [s["image_id"] for s in _by_name(snap, "rayColorLine")] == [0, 1]


def test_sorted_plan_counts_and_its_hit_path_spans(cornell):
    r = _renderer()
    _under_profiler(lambda: [r.render_device(cornell, 8, 8) for _ in range(3)])
    snap = profiler.snapshot()
    assert snap["counters"]["plan.miss.sorted"] == 1
    assert snap["counters"]["plan.hit.sorted"] == 2
    # the first render measures the work counts, the second builds the plan
    # from them, the third reuses it
    assert [s["image_id"] for s in _by_name(snap, "render.plan")] == [1]
    assert [s["name"] for s in snap["spans"] if s["parent"] >= 0
            and snap["spans"][s["parent"]]["name"] == "render.plan"] == list(PLAN_STAGES[1:])


def test_a_new_seed_misses_the_plan(balls):
    _under_profiler(lambda: [_renderer(seed).render_device(balls, 8, 8) for seed in (1, 2)])
    counters = profiler.snapshot()["counters"]
    assert counters["plan.miss.coherent"] == 2 and "plan.hit.coherent" not in counters


def test_recording_changes_no_image(balls, cornell):
    for scene in (balls, cornell):
        off = _renderer(7).render_device(scene, 8, 8)
        on, _ = _under_profiler(lambda: _renderer(7).render_device(scene, 8, 8))
        assert torch.equal(off, on)


def test_lane_counters_sum_the_launch_work(cornell):
    r = _renderer()
    _under_profiler(lambda: r.render_device(cornell, 8, 8))
    counters = profiler.snapshot()["counters"]
    # the sorted driver's first render keeps the work counts of its launch
    (entry,) = r._plan_cache[cornell.compiled].values()
    lane, warp = fused.lane_sums(entry["work"])
    assert counters["k1.lane_work"] == int(entry["work"].sum()) == int(lane) > 0
    assert counters["k1.warp_work"] == int(warp) >= int(lane)


@pytest.mark.parametrize("work, lane, warp", [
    (torch.arange(64, dtype=torch.int32), sum(range(64)), 32 * 31 + 32 * 63),
    (torch.full((32,), 5, dtype=torch.int32), 160, 160),
    (torch.tensor([4, 0, 1], dtype=torch.int32), 5, 32 * 4),
    (torch.cat([torch.zeros(31, dtype=torch.int32), torch.tensor([9, 2], dtype=torch.int32)]),
     11, 32 * 9 + 32 * 2),
])
def test_lane_sums_on_hand_made_counts(work, lane, warp):
    got = fused.lane_sums(work)
    assert [int(v) for v in got] == [lane, warp]
    assert all(v.dtype == torch.int64 for v in got)


@pytest.mark.parametrize("rows, slots, block_ns, slot_ns", [
    # two blocks on two slots, overlapping: 10 + 20 of 2 x 25
    ([[0, 100, 110], [1, 105, 125]], 2, 30, 50),
    # one wave and a tail: three slots, four blocks of 10, the last after
    ([[0, 0, 10], [1, 0, 10], [2, 0, 10], [0, 10, 20]], 3, 40, 60),
])
def test_block_sums_on_hand_made_stamps(rows, slots, block_ns, slot_ns):
    got = fused.block_sums(torch.tensor(rows, dtype=torch.int64), slots)
    assert [int(v) for v in got] == [block_ns, slot_ns]


def test_device_counters_sum_until_the_snapshot():
    profiler.set_profiling(True)
    for v in (3, 4):
        profiler.count("k1.slot_ns", torch.tensor(v, dtype=torch.int64))
    profiler.count("plan.hit.sorted")
    profiler.count("plan.hit.sorted", 2)
    assert profiler.snapshot()["counters"] == {"k1.slot_ns": 7, "plan.hit.sorted": 3}


def test_a_nested_image_span_keeps_the_outer_id():
    profiler.set_profiling(True)
    with profiler.named_zone("outer", image=True):
        with profiler.named_zone("inner", image=True):
            pass
    with profiler.named_zone("next", image=True):
        pass
    snap = profiler.snapshot()
    assert [(s["name"], s["parent"], s["image_id"]) for s in snap["spans"]] == [
        ("outer", -1, 0), ("inner", 0, 0), ("next", -1, 1)]
    assert snap["images"] == 2


def test_spans_are_user_annotations_in_the_chrome_trace(balls, tmp_path):
    _, prof = _under_profiler(lambda: _renderer().render_device(balls, 8, 8))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    notes = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            notes.setdefault(e["name"], []).append(e)
    snap = profiler.snapshot()
    for name in ("Renderer::render", "render.plan", *PLAN_STAGES, "rayColorLine",
                 "render.accumulate"):
        assert len(notes.get(name, [])) == len(_by_name(snap, name)), name
    # each span's record holds its event on the trace's clock, to the
    # first entry's set-up in a process (a few hundred us here; the card
    # test holds them to 50 us on the card's host)
    for span in snap["spans"]:
        ev = min(notes[span["name"]],
                 key=lambda e: abs(e["ts"] * 1e3 + base - span["start_ns"]))
        start = ev["ts"] * 1e3 + base
        assert span["start_ns"] - 2e6 <= start <= start + ev["dur"] * 1e3 <= span["end_ns"] + 2e6


def test_idle_by_span_on_hand_made_intervals():
    spans = [dict(name="render", start_ns=0, end_ns=100, parent=-1, image_id=0),
             dict(name="plan", start_ns=10, end_ns=40, parent=0, image_id=0)]
    busy = [(100, 110), (40, 60), (50, 90)]
    # gaps [0, 40) (middle 20: plan), [90, 100) (render), [110, 130) (outside)
    idle = profiler.idle_by_span(busy, 0, 130, spans)
    assert idle == {"plan": 40 / 1e6, "render": 10 / 1e6, profiler.OUTSIDE: 20 / 1e6}
    assert profiler.idle_by_span([(0, 130)], 0, 130, spans) == {}
    table = profiler.format_idle_summary(idle)
    assert table.splitlines()[1].startswith("plan") and "TOTAL" in table


def test_profile_modes_print_counters_and_idle_by_span(tmp_path, capsys):
    from zig_weekend_raytracer_tpu_torch import cli

    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=1",
            "--ray_bounce_max_depth=2", "--scene=cornell_box",
            f"--image_out_path={tmp_path / 'c.ppm'}"]
    assert cli.main(argv + ["--profile=host"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "counter" in out and "k1.lane_work" in out and "plan.miss.sorted" in out
    assert cli.main(argv + ["--profile=device"], device="cpu") == 0
    out = capsys.readouterr().out
    # no card: the whole render is device idle time, put down to its spans
    assert "idle span" in out and "rayColorLine" in out


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the block stamps are written by the CUDA kernel")


@pytest.mark.card
def test_block_stamps_on_the_card(card):
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    scene = zt.models.load_scene("balls", device="cuda")
    w = h = 400                                 # one sample in flight a pixel
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=5, seed=3)
    off = r.render_device(scene, w, h)          # builds the coherent plan
    on, _ = _under_profiler(lambda: r.render_device(scene, w, h))
    assert torch.equal(off, on)
    counters = profiler.snapshot()["counters"]
    assert 0 < counters["k1.block_ns"] <= counters["k1.slot_ns"]
    assert 0 < counters["k1.lane_work"] <= counters["k1.warp_work"]

    px, py, s0, s1, stride = r.render_lanes(scene, w, h)
    n = px.shape[0]
    stamps = torch.zeros((-(-n // fused.THREADS), fused.BLOCK_STAMP_COLS), dtype=torch.int64,
                         device="cuda")
    kw = dict(camera_consts=camera_consts(scene.camera, w, h), sampler=r.sampler, width=w,
              height=h, spp=r.samples_per_pixel, stride=stride, max_depth=r.max_ray_bounce_depth,
              has_dof=scene.camera.has_depth_of_field)
    rad, _, _, _ = fused._launch(scene.compiled, px, py, s0, s1, r.seed, zt.dtypes.T_MIN, 0,
                                 False, out_blocks=stamps, **kw)
    plain, _, _, _ = fused._launch(scene.compiled, px, py, s0, s1, r.seed, zt.dtypes.T_MIN, 0,
                                   False, **kw)
    assert torch.equal(rad.to_array(), plain.to_array())
    s = stamps.cpu()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert bool((s[:, 0] >= 0).all()) and bool((s[:, 0] < sms).all())
    assert bool((s[:, 1] > 0).all()) and bool((s[:, 1] <= s[:, 2]).all())
    # every block ran inside the launch's span, on more than one SM
    assert int(s[:, 2].max() - s[:, 1].min()) < 60e9 and len(set(s[:, 0].tolist())) > 1


@pytest.mark.card
def test_coherent_plans_on_the_card_are_counted(card):
    scene = zt.models.load_scene("balls", device="cuda")
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=5, seed=5,
                           regen_min_wave=1)    # one sample in flight a pixel
    r.render_device(scene, 64, 64)              # builds the launch's tables
    for seed in (6, 7):
        r.seed = seed
        _under_profiler(lambda: r.render_device(scene, 64, 64))
    snap = profiler.snapshot()
    assert snap["counters"]["plan.card.coherent"] == snap["counters"]["plan.miss.coherent"] == 2
    plans = _by_name(snap, "render.plan")
    assert len(plans) == 2
    for plan in plans:
        stages = [s["name"] for s in snap["spans"] if s["parent"] >= 0
                  and snap["spans"][s["parent"]] is plan]
        assert stages == list(COHERENT_STAGES)
