"""The port's ``tools/quality_prodres.py`` against the JAX package's, on the
CPU at ``--size=16 --spp=4 --seeds=1 --ref_spp=8`` (cornell_box and balls,
depth 10).  JAX's tool runs under ``pallas_interpret``: its XLA path has no
adaptive driver and would render the adaptive pipeline uniformly.

Both tools run once, each with its ``_mse``, ``render_adaptive`` (and, in
JAX's, ``denoise``) wrapped to record what they computed.

  1. The rows have the JAX tool's keys in its order, the summary line is
     the JAX tool's, and the port's printed numbers are its own pipelines'
     (recomputed from the recorded arrays, exactly).
  2. The uniform and reference renders equal JAX's within rtol 1e-5 / atol
     1e-6 on every pixel but the named WITNESS pixels, where XLA's
     contracted multiply-adds send a path across a grazing hit at depth 10
     (the settled cases of tests/test_torch_render.py's EDGE_PIXELS and
     tests/test_torch_rtw_samplers_witness.py).
  3. The adaptive pipeline: the sample-count map equals JAX's but on the
     named ALLOCATION pixels, each one sample apart (the pilot's witness
     pixels change their noise, which moves the budget's rounding), and
     the render equals JAX's off WITNESS and ALLOCATION.
  4. Off those named pixels, the MSE of the uniform and adaptive pipelines
     against the reference is JAX's within rtol 1e-3 (here ~1e-7).
  5. The denoised pipelines: the port's filter on the JAX tool's own
     inputs is JAX's filter within rtol 1e-5 / atol 1e-6
     (tests/test_torch_denoise.py's bound) and gives JAX's MSE within rtol
     1e-3.  On the tools' own inputs the two filters read the named
     pixels' differences, which the à-trous taps spread over the image and
     the automatic luminance stop moves with, so the printed
     ``mse_uniform`` and ``mse_ratio`` are held to JAX's through 2.-5., not
     directly (cornell's adaptive ratio prints 0.5002 against 0.4785).
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from tools import quality_prodres as jtool
from zig_weekend_raytracer_tpu.ops.trace import _use_pallas_backend
from zig_weekend_raytracer_tpu.render import denoise as jden
from zig_weekend_raytracer_tpu_torch.render import denoise as tden
from zig_weekend_raytracer_tpu_torch.tools import quality_prodres as ttool

RTOL, ATOL = 1e-5, 1e-6
MSE_RTOL = 1e-3
ARGS = ["--size=16", "--spp=4", "--seeds=1", "--ref_spp=8"]
SCENES = ("cornell_box", "balls")
PIPELINES = ("uniform", "adaptive", "denoise", "both")
# (x, y) pixels of the 16x16 renders where JAX's jitted arithmetic differs
WITNESS = {
    ("cornell_box", "uniform"): ((12, 12), (9, 13), (13, 13)),
    ("cornell_box", "reference"): ((6, 4), (13, 12), (13, 13)),
    ("balls", "uniform"): ((4, 2), (14, 6), (2, 7), (9, 14)),
    ("balls", "reference"): ((6, 2), (0, 7)),
}
ALLOCATION = {
    "cornell_box": ((8, 2), (1, 7), (3, 8), (12, 12), (13, 12), (3, 13), (9, 13), (10, 13),
                    (11, 13), (12, 13), (13, 13), (14, 13), (1, 14), (3, 14), (13, 14),
                    (14, 14)),
    "balls": ((14, 1), (5, 9)),
}


def _pixels(mask):
    return sorted((int(x), int(y)) for y, x in zip(*np.nonzero(mask)))


def _mask(*groups):
    keep = np.ones((16, 16), bool)
    for group in groups:
        for x, y in group:
            keep[y, x] = False
    return keep


def _named(scene):
    return _mask(WITNESS[(scene, "uniform")], WITNESS[(scene, "reference")], ALLOCATION[scene])


def _record_run(main, mod, renderer_cls, argv):
    """Runs a tool's ``main`` with its ``_mse`` and ``render_adaptive``
    recording; (stdout lines, [(fb, ref)] in call order, [n_samples])."""
    pairs, maps = [], []
    real_mse, real_adaptive = mod._mse, renderer_cls.render_adaptive

    def mse(a, b):
        pairs.append((np.array(a, np.float64), np.array(b, np.float64)))
        return real_mse(a, b)

    def adaptive(self, *a, **k):
        fb, stats = real_adaptive(self, *a, return_stats=True, **k)
        maps.append(np.array(stats["n_samples"]))
        return fb

    mod._mse, renderer_cls.render_adaptive = mse, adaptive
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        mod._mse, renderer_cls.render_adaptive = real_mse, real_adaptive
    return out.getvalue().splitlines(), pairs, maps


@pytest.fixture(scope="module")
def runs():
    seen = []
    real_den = jden.denoise

    def den(color, aovs, **k):
        out = np.array(real_den(color, aovs, **k))
        seen.append((np.array(color), {n: np.array(v) for n, v in aovs.items()}, out))
        return out

    def jax_main(argv):
        old = sys.argv
        sys.argv = ["quality_prodres.py", *argv]
        try:
            jtool.main()
        finally:
            sys.argv = old

    os.environ["ZWRT_PALLAS_INTERPRET"] = "1"
    _use_pallas_backend.cache_clear()
    jden.denoise = den
    try:
        jax_run = _record_run(jax_main, jtool, zj.render.Renderer, ARGS)
    finally:
        jden.denoise = real_den
        del os.environ["ZWRT_PALLAS_INTERPRET"]
        _use_pallas_backend.cache_clear()
    port_run = _record_run(ttool.main, ttool, zt.render.Renderer, [*ARGS, "--device=cpu"])
    return {"jax": jax_run, "port": port_run, "denoise_inputs": seen}


def _pipeline(run, scene):
    """{pipeline: (fb, ref)} of one scene's row (one seed, one spp)."""
    pairs = run[1][4 * SCENES.index(scene): 4 * SCENES.index(scene) + 4]
    return dict(zip(PIPELINES, pairs))


def test_rows_have_jax_keys(runs):
    (lines_t, _, _), (lines_j, _, _) = runs["port"], runs["jax"]
    rows_t, rows_j = [json.loads(x) for x in lines_t], [json.loads(x) for x in lines_j]
    assert len(rows_t) == len(rows_j) == len(SCENES) + 1
    assert rows_t[-1] == rows_j[-1] == {"summary": "quality_prodres", "rows": 2}
    for t, j in zip(rows_t[:-1], rows_j[:-1]):
        assert list(t) == list(j)
        assert list(t["mse_ratio"]) == list(j["mse_ratio"]) == list(PIPELINES)
        assert list(t["wall_s"]) == list(j["wall_s"]) == list(PIPELINES)
        for k in ("scene", "size", "spp", "seeds", "ref_spp"):
            assert t[k] == j[k]
        assert all(np.isfinite(v) for v in t["mse_ratio"].values())


def test_port_rows_are_its_pipelines(runs):
    lines, _, _ = runs["port"]
    for scene, line in zip(SCENES, lines):
        row = json.loads(line)
        mse = {k: float(np.mean((fb - ref) ** 2)) for k, (fb, ref) in
               _pipeline(runs["port"], scene).items()}
        assert row["mse_uniform"] == round(mse["uniform"], 6)
        assert row["mse_ratio"] == {k: round(v / mse["uniform"], 4) for k, v in mse.items()}


@pytest.mark.parametrize("scene", SCENES)
def test_renders_match_jax_off_named_pixels(runs, scene):
    got, want = _pipeline(runs["port"], scene), _pipeline(runs["jax"], scene)
    differ = lambda a, b: ~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(-1)
    assert _pixels(differ(got["uniform"][0], want["uniform"][0])) == sorted(
        WITNESS[(scene, "uniform")])
    assert _pixels(differ(got["uniform"][1], want["uniform"][1])) == sorted(
        WITNESS[(scene, "reference")])
    n_t, n_j = runs["port"][2][SCENES.index(scene)], runs["jax"][2][SCENES.index(scene)]
    assert _pixels(n_t != n_j) == sorted(ALLOCATION[scene])
    assert np.abs(n_t - n_j).max() == 1 and n_t.sum() == n_j.sum() == 16 * 16 * 4
    off = _mask(WITNESS[(scene, "uniform")], ALLOCATION[scene])
    assert not differ(got["adaptive"][0], want["adaptive"][0])[off].any()


@pytest.mark.parametrize("scene", SCENES)
def test_mse_matches_jax_off_named_pixels(runs, scene):
    keep = _named(scene)
    got, want = _pipeline(runs["port"], scene), _pipeline(runs["jax"], scene)
    for k in ("uniform", "adaptive"):
        mse_t = np.mean(((got[k][0] - got[k][1]) ** 2)[keep])
        mse_j = np.mean(((want[k][0] - want[k][1]) ** 2)[keep])
        assert mse_t == pytest.approx(mse_j, rel=MSE_RTOL), k


@pytest.mark.parametrize("scene", SCENES)
def test_denoiser_on_jax_inputs(runs, scene):
    want = _pipeline(runs["jax"], scene)
    ref = want["uniform"][1]
    # the JAX tool's filter calls, in order: the uniform then the adaptive
    # render of each scene
    inputs = runs["denoise_inputs"][2 * SCENES.index(scene): 2 * SCENES.index(scene) + 2]
    for k, (color, aovs, dn_j) in zip(("denoise", "both"), inputs):
        dn_t = tden.denoise(torch.from_numpy(color),
                            {n: torch.from_numpy(v) for n, v in aovs.items()}).numpy()
        np.testing.assert_allclose(dn_t, dn_j, rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(want[k][0], dn_j)
        assert np.mean((dn_t - ref) ** 2) == pytest.approx(np.mean((dn_j - ref) ** 2),
                                                           rel=MSE_RTOL)


def test_device(capsys):
    if not torch.cuda.is_available():
        assert ttool.main(ARGS) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="expected 'cuda' or 'cpu'"):
        ttool.main([*ARGS, "--device=xpu"])
