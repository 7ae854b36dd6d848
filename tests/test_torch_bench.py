"""The port's north-star harness (``tools/bench.py``) on the CPU, against
the JAX package's root ``bench.py``, at cornell_box 16x16, 4 spp, depth 3
with ``--device=cpu`` (the kernels' plain versions).

  a. The harness's framebuffer is bitwise ``Renderer.render`` of the port;
     its off-north-star gate holds the scene to scene_regions.json's layout
     at a cut size (test_torch_writers.py's ``cut_regions``: statistics of
     the JAX package's render at 64x64, 8 spp, depth 4), and a shifted
     mean fails it: exit 1, every measured field null.
  b. Its ``iters_per_path`` (64 spp, the production work counter) equals
     the root harness's ``measure_iterations_per_path`` at the same cut
     (``bench.WIDTH``, ``HEIGHT`` and ``DEPTH`` patched; JAX's kernel in
     interpret mode) but for PROBE_EDGE_PIXELS: pixels whose camera rays
     lie in the box's x = y plane and meet the floor / red-wall edge, where
     JAX's contracted multiply-adds miss and the port's rounded products
     hit (tests/test_torch_fused_render.py's witness); the difference of
     the two figures is those pixels' work difference.
  c. Its north-star gate gives the root harness's verdict string on the
     same numpy framebuffer, on a pass and on a fail (one region scaled).
  d. Without a card and without ``--device=cpu`` the module exits 75 and
     prints one JSON line with ``value`` null, in a subprocess that blocks
     ``jax`` and the JAX package (test_torch_import.py's meta-path hook).
  e. The line's keys are the harness's ``KEYS`` (an error adds ``error``
     and ``detail``), every measured field null on the CPU.
  f. Its bound equals what ``chip_smoke.py``'s ``render_bound`` computed
     before it moved into ``utils/roofline.py``, from the same counts.
  g. Exit 2: usage errors, a scene without a region golden, nested
     checkers; ``Renderer.kernel_call`` sums to the render.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_fixed_depth import _nested
from test_torch_import import _BLOCK
from test_torch_writers import cut_regions  # noqa: F401
from zig_weekend_raytracer_tpu_torch.render.camera import camera_params, generate_rays
from zig_weekend_raytracer_tpu_torch.sampling.sobol import sobol_sample_bytes
from zig_weekend_raytracer_tpu_torch.tools import bench
from zig_weekend_raytracer_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP, DEPTH = 16, 4, 3
ARGS = ["cornell_box", str(SIZE), str(SIZE), str(SPP), str(DEPTH), "--device=cpu"]
# (x, y) of the pixels whose 64-sample probe work differs from JAX's at
# 16x16 d3: camera rays on the floor / red-wall edge
PROBE_EDGE_PIXELS = ((12, 12), (13, 13), (14, 14), (15, 15))


@pytest.fixture(scope="module")
def run(cut_regions):  # noqa: F811
    path, _ = cut_regions
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "REGIONS", str(path))
        return bench.measure(bench.parse(ARGS))


def _render():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    return zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                              seed=0).render(scene, SIZE, SIZE)


def test_framebuffer_is_the_renderers(run):
    out, rc, details = run
    assert rc == 0 and out["correctness"].startswith("pass")
    fb = details["fb"].numpy()
    assert fb.shape == (SIZE, SIZE, 3) and np.isfinite(fb).all()
    np.testing.assert_array_equal(fb, _render())


def test_failed_gate_exits_1_without_numbers(cut_regions, tmp_path, monkeypatch):  # noqa: F811
    _, ref = cut_regions
    shifted = tmp_path / "shifted.json"
    shifted.write_text(json.dumps({"grid": 8, "scenes": {
        "cornell_box": {**ref, "mean": ref["mean"] * 1.05}}}))
    monkeypatch.setattr(bench, "REGIONS", str(shifted))
    out, rc, _ = bench.measure(bench.parse(ARGS))
    assert rc == 1 and out["correctness"].startswith("fail:global-mean")
    assert all(out[k] is None for k in ("value", "vs_baseline", "iters_per_path", "kernel_ms",
                                        "bound_ms", "roofline_share", "host_ms", "warmup_s",
                                        "times_s"))


def _probe_work(scene, width, depth, spp):
    """Per-pixel work of the probe's layout through the port's
    trace_paths_regen (what bench.iterations_per_path sums)."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.render.integrator import trace_paths_regen

    idx = torch.arange(width * width, dtype=torch.int32)
    _, work = trace_paths_regen(
        scene.compiled, camera_consts(scene.camera, width, width), 0, idx % width,
        idx // width, torch.zeros_like(idx), torch.full_like(idx, spp),
        sampler=zt.sampling.SamplerKind.SOBOL, width=width, height=width, spp=spp, stride=1,
        max_depth=depth, has_dof=False, want_work=True)
    return work.numpy()


def _jax_probe_work(width, depth, spp):
    """Per-pixel work of the root harness's probe layout through JAX's
    trace_paths_regen (what measure_iterations_per_path sums)."""
    import jax.numpy as jnp

    from zig_weekend_raytracer_tpu.render.camera import camera_consts
    from zig_weekend_raytracer_tpu.render.integrator import trace_paths_regen

    scene = zj.models.load_scene("cornell_box")
    blk = scene.compiled.rows * 128
    n_pix = width * width
    n = -(-n_pix // blk) * blk
    ys, xs = np.divmod(np.arange(n) % n_pix, width)
    limit = np.where(np.arange(n) < n_pix, spp, 0).astype(np.int32)
    _, work = trace_paths_regen(
        scene.compiled, camera_consts(scene.camera, width, width), jnp.uint32(0),
        jnp.asarray(xs.astype(np.int32)), jnp.asarray(ys.astype(np.int32)),
        jnp.zeros((n,), jnp.int32), jnp.asarray(limit), sampler=zj.sampling.SamplerKind.SOBOL,
        width=width, height=width, spp=spp, stride=1, max_depth=depth, has_dof=False,
        want_work=True)
    return np.asarray(work)[:n_pix], scene


def test_iters_per_path_is_the_root_harness_count(run, pallas_interpret, monkeypatch):
    out, _, _ = run
    monkeypatch.setattr(jbench, "WIDTH", SIZE)
    monkeypatch.setattr(jbench, "HEIGHT", SIZE)
    monkeypatch.setattr(jbench, "DEPTH", DEPTH)
    n = SIZE * SIZE * bench.PROBE_SPP
    work_j, scene_j = _jax_probe_work(SIZE, DEPTH, bench.PROBE_SPP)
    want = jbench.measure_iterations_per_path(scene_j)
    assert want == work_j.sum() / n
    scene = zt.models.load_scene("cornell_box", device="cpu")
    work_t = _probe_work(scene, SIZE, DEPTH, bench.PROBE_SPP)
    assert out["iters_per_path"] == work_t.sum() / n
    differ = np.nonzero(work_t != work_j)[0]
    assert sorted((int(i % SIZE), int(i // SIZE)) for i in differ) == sorted(PROBE_EDGE_PIXELS)
    assert out["iters_per_path"] * n - want * n == (work_t[differ] - work_j[differ]).sum()
    # every named pixel has probe rays in the box's x = y plane
    s = torch.arange(bench.PROBE_SPP).repeat_interleave(len(PROBE_EDGE_PIXELS))
    px, py = (torch.tensor(c).repeat(bench.PROBE_SPP) for c in zip(*PROBE_EDGE_PIXELS))
    o, d, _ = generate_rays(camera_params(scene.camera, SIZE, SIZE), False,
                            zt.sampling.SamplerKind.SOBOL, 0, (s * SIZE + py) * SIZE + px, px, py,
                            s, bench.PROBE_SPP, SIZE, SIZE)
    plane = ((d.x == d.y) & (o.x == o.y)).numpy()
    assert {(int(x), int(y)) for x, y in zip(px.numpy()[plane], py.numpy()[plane])} == set(
        PROBE_EDGE_PIXELS)


def _north_star_fb():
    """A 400x400 framebuffer of the golden's region means, grey, with
    seeded noise that leaves each region's mean within a hair of it."""
    with open(bench.GOLDEN) as f:
        ref = json.load(f)
    means = np.asarray(ref["region_means"], np.float32)
    grid = means.shape[0]
    side = bench.NORTH_STAR[1] // grid
    fb = np.repeat(np.repeat(means, side, 0), side, 1)[..., None].repeat(3, 2)
    noise = np.random.default_rng(3).normal(0.0, 1e-4, fb.shape).astype(np.float32)
    return fb + noise


@pytest.mark.parametrize("case", ["pass", "fail"])
def test_gate_verdict_is_the_root_harness(case):
    fb = _north_star_fb()
    if case == "fail":
        fb[100:150, 200:250] *= 1.5
    verdict = bench.check_regions(fb)
    assert verdict == jbench.check_regions(fb)
    assert verdict.startswith(case)
    # through the harness's gate: the same verdict at the north star, and a
    # maximum of at most 1 (the light unseen) fails before the regions
    cfg = bench.parse(["--device=cpu"])
    assert cfg.north_star
    lit = fb.copy()
    lit[0, 0] = 2.0
    assert bench.gate(cfg, torch.from_numpy(lit)) == jbench.check_regions(lit)
    assert bench.gate(cfg, torch.from_numpy(np.minimum(fb, 1.0))).startswith("fail:max")
    nan = lit.copy()
    nan[5, 5, 1] = np.nan
    assert bench.gate(cfg, torch.from_numpy(nan)).startswith("fail:nan")


def test_without_a_card_exits_75_blocking_jax():
    script = _BLOCK + (
        "import runpy\n"
        "runpy.run_module('zig_weekend_raytracer_tpu_torch.tools.bench', run_name='__main__')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == bench.EX_TEMPFAIL, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and line["error"] == "gpu-unavailable"
    assert set(line) == set(bench.KEYS) | {"error", "detail"}
    assert "blocked import" not in res.stderr


def test_keys_and_cpu_fields(run):
    out, _, _ = run
    assert list(out) == list(bench.KEYS)
    assert json.loads(json.dumps(out)) == out
    assert out["metric"] == "cornell_box 16x16 @4spp depth3 path throughput (1 GPU)"
    assert out["unit"] == "Mpaths/s" and out["device"] == "cpu" and out["kernel"] == "K1"
    for k in ("value", "vs_baseline", "kernel_ms", "roofline_share", "host_ms", "warmup_s",
              "times_s"):
        assert out[k] is None, k
    assert out["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K3c": 0, "K5": 0}
    assert out["peak_source"] == "data_sheet" and out["bound_by"] in ("operations", "bytes")
    assert bench.parse([]).metric == (
        "cornell_box 400x400 @1024spp depth10 path throughput (1 GPU; north-star config)")


def _old_render_bound(scene, counts, kernel_work, lane_bytes, has_dof, spp, walk=None,
                      ops_rate=None):
    """chip_smoke.py's render_bound before the move."""
    factor = float(kernel_work) / max(counts.get("bounce", 0), 1)
    n_bytes = sobol_sample_bytes(spp)
    ops = roofline.render_ops(roofline.scaled(counts, factor), scene.compiled, has_dof,
                              sobol=n_bytes)
    nbytes = lane_bytes + roofline.render_table_bytes(scene.compiled, n_bytes, walk)
    ms, by = roofline.bound_ms(ops, nbytes, ops_rate)
    return {"bound_ms": ms, "bound_by": by, "bound_ops": ops, "bound_bytes": nbytes,
            "peak_source": roofline.peak_source(ops_rate)}


@pytest.mark.parametrize("variant", ["harness", "measured_rates"])
def test_bound_is_chip_smokes_before_the_move(run, variant):
    out, _, details = run
    scene = zt.models.load_scene("cornell_box", device="cpu")
    counts, work, lane_bytes = (details[k] for k in ("counts", "kernel_work", "lane_bytes"))
    assert counts["bounce"] > 0 and work > 0
    assert lane_bytes == SIZE * SIZE * SPP * roofline.LANE_BYTES["K1"]  # s_par 4 at 16x16
    kw = {"ops_rate": ({"fp": 3.3e13, "cmp": 1.7e13, "int": 2.3e13}
                       if variant == "measured_rates" else None)}
    want = _old_render_bound(scene, counts, work, lane_bytes, False, SPP, **kw)
    got = roofline.render_bound(scene.compiled, counts, work, lane_bytes, False, SPP, **kw)
    assert got == want
    if variant == "harness":
        assert (out["bound_ms"], out["bound_by"], out["peak_source"]) == (
            want["bound_ms"], want["bound_by"], want["peak_source"])


@pytest.mark.parametrize("argv", [["--rr=3"], ["a", "1", "2", "3", "4", "5"], ["cornell_box", "x"],
                                  ["cornell_box", "0"], ["--device=tpu"], ["--texture_lut=-1"]])
def test_usage_errors_exit_2(argv, capsys):
    assert bench.main(argv) == 2
    assert capsys.readouterr().err.startswith("bench: ")


def test_scene_without_golden_exits_2(tmp_path, monkeypatch):
    regions = tmp_path / "regions.json"
    regions.write_text(json.dumps({"grid": 8, "scenes": {}}))
    monkeypatch.setattr(bench, "REGIONS", str(regions))
    out, rc, _ = bench.measure(bench.parse(ARGS))
    assert rc == 2 and out["error"] == "no-golden" and out["value"] is None


def test_nested_checkers_exit_2(monkeypatch):
    monkeypatch.setattr(zt.models, "load_scene", lambda *a, **kw: _nested(zt))
    out, rc, _ = bench.measure(bench.parse(ARGS))
    assert rc == 2 and out["error"] == "unsupported-scene" and out["kernel"] is None


def test_kernel_call_sums_to_the_render():
    """Renderer.kernel_call over render_lanes (the plain lane layout at
    16x16: 4 samples in flight a pixel) adds up to the render."""
    scene = zt.models.load_scene("cornell_box", device="cpu")
    r = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=0)
    px, py, s0, s1, stride = r.render_lanes(scene, SIZE, SIZE)
    assert stride == 4 and px.shape[0] == SIZE * SIZE * 4 and px.dtype == torch.int32
    rad, work = r.kernel_call(scene, SIZE, SIZE)()
    fb = torch.zeros(SIZE * SIZE, 3).index_add_(0, (py * SIZE + px).long(), rad.to_array())
    np.testing.assert_allclose(fb.reshape(SIZE, SIZE, 3).numpy() / SPP, _render(),
                               rtol=1e-6, atol=0)
    assert int(work.sum()) > 0
    with pytest.raises(ValueError, match="more than one band"):
        zt.render.Renderer(samples_per_pixel=SPP, max_rays_per_chunk=64).render_lanes(
            scene, SIZE, SIZE)
