"""The port's ``tools/lut_quality.py`` against the JAX package's, on the CPU
at shrek_quads 16x16, 4 spp, depth 4, budget 8192.

  1. ``render``: the exact render (budget 0) and the LUT render against
     the JAX tool's ``render`` (``tools/lut_quality.py:25``) under
     ``pallas_interpret`` (JAX's XLA path has no texture LUT: it would
     read the atlas), within rtol 1e-5 / atol 1e-6 on every pixel but
     SHREK_EDGE_PIXELS (tests/test_torch_images.py: camera rays along quad
     edges that XLA's contracted multiply-adds decide otherwise); whether
     the LUT is active is equal.  The port passes the budget to the scene
     compile and leaves ``ZWRT_TEX_LUT`` as it found it.
  2. The statistics: on identical framebuffers (``render`` replaced in
     both tools), the port's stderr rows and stdout line are the JAX
     tool's, character for character.
  3. Without a card the default device exits 1; an unknown device value
     is refused.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from tools import lut_quality as jtool
from zig_weekend_raytracer_tpu_torch.tools import lut_quality as ttool

RTOL, ATOL = 1e-5, 1e-6
SHREK_EDGE_PIXELS = ((13, 3), (14, 5), (6, 13))  # test_torch_images.py, shrek 16x16
SCENE, SPP, SIZE, DEPTH, BUDGET = "shrek_quads", 4, 16, 4, 8192


def _off_witnesses():
    keep = np.ones((SIZE, SIZE), bool)
    for x, y in SHREK_EDGE_PIXELS:
        keep[y, x] = False
    return keep


@pytest.mark.parametrize("budget", [0, BUDGET])
def test_render_matches_jax_tool(pallas_interpret, monkeypatch, budget):
    monkeypatch.delenv("ZWRT_TEX_LUT", raising=False)
    fb_j, lut_j = jtool.render(SCENE, budget, SPP, SIZE, DEPTH)
    fb_t, lut_t = ttool.render(SCENE, budget, SPP, SIZE, DEPTH, device="cpu")
    assert "ZWRT_TEX_LUT" not in os.environ
    assert lut_t == lut_j == bool(budget)
    assert fb_t.shape == fb_j.shape == (SIZE, SIZE, 3) and np.isfinite(fb_t).all()
    keep = _off_witnesses()
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)


def test_stats_lines_match_jax_on_identical_arrays(monkeypatch, capsys):
    rng = np.random.default_rng(7)
    exact = rng.uniform(0.0, 1.5, (SIZE, SIZE, 3)).astype(np.float32)
    fbs = {0: (exact, False)}
    for budget in (BUDGET, 32768):
        fbs[budget] = ((exact + rng.normal(0.0, 0.01, exact.shape)).astype(np.float32), True)
    fbs[65536] = (exact.copy(), True)  # mse 0: psnr None
    budgets = [str(b) for b in (BUDGET, 32768, 65536)]

    monkeypatch.setattr(jtool, "render", lambda name, b, *a: fbs[b])
    monkeypatch.setattr(ttool, "render", lambda name, b, *a, **k: fbs[b])
    monkeypatch.setattr(sys, "argv", ["lut_quality.py", SCENE, *budgets, f"--spp={SPP}"])
    assert jtool.main() == 0
    want = capsys.readouterr()
    assert ttool.main([SCENE, *budgets, f"--spp={SPP}", "--device=cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    summary = json.loads(got.out)
    assert [r["budget"] for r in summary["rows"]] == [BUDGET, 32768, 65536]
    assert summary["rows"][-1]["psnr_db"] is None
    assert len(got.err.splitlines()) == 3


def test_exact_render_must_not_pack_a_lut(monkeypatch):
    monkeypatch.setattr(ttool, "render", lambda *a, **k: (np.zeros((2, 2, 3), np.float32), True))
    with pytest.raises(AssertionError, match="packed a texture LUT"):
        ttool.main([SCENE, "--device=cpu"])


def test_device(capsys):
    if not torch.cuda.is_available():
        assert ttool.main([SCENE]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="expected 'cuda' or 'cpu'"):
        ttool.main([SCENE, "--device=gpu"])
