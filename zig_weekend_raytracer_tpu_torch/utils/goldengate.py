"""Region-statistics correctness gate: a numpy copy of the JAX package's
``utils/goldengate.py``, so the port gates its framebuffers without
importing that package.

Compares a framebuffer rendered on the current device against reference
region statistics (``tests/golden/bench_cornell_regions.json`` for the
main path).  Float divergence between backends decorrelates a few chaotic
paths, so a single-region 2% gate would false-positive, while a real
miscompile is either systematic (shifts the global mean / many regions) or
localized-but-large:

  * global mean must match within 1% (systematic shift);
  * HARD per-region bound: >10% relative AND >5e-3 absolute luminance
    fails outright (localized pattern break);
  * SOFT count: more than ``soft_budget`` regions off by >2% relative AND
    >1e-3 absolute fails (distributed shift below the mean gate).
"""

from __future__ import annotations

import numpy as np

__all__ = ["region_means", "check_framebuffer"]


def region_means(fb: np.ndarray, grid: int) -> np.ndarray:
    """(H, W, 3) framebuffer -> (grid, grid) luminance region means."""
    h, w, _ = fb.shape
    lum = fb.mean(axis=2)
    return lum.reshape(grid, h // grid, grid, w // grid).mean(axis=(1, 3))


def check_framebuffer(
    fb: np.ndarray,
    ref_mean: float,
    ref_region_means: np.ndarray,
    *,
    soft_budget: int = 5,
) -> str:
    """Gate ``fb`` against reference statistics.

    Returns ``"pass (N soft-divergent regions)"`` or ``"fail:<detail>"``.
    """
    if np.isnan(fb).any():
        return "fail:nan"
    grid = ref_region_means.shape[0]
    g_mean = float(fb.mean())
    if abs(g_mean - ref_mean) > 0.01 * max(ref_mean, 1e-6):
        return f"fail:global-mean {g_mean:.4f} vs {ref_mean:.4f}"
    means = region_means(fb, grid)
    diff = np.abs(means - ref_region_means)
    rel = diff / np.maximum(ref_region_means, 1e-3)
    hard = (rel > 0.10) & (diff > 5e-3)
    if hard.any():
        iy, ix = np.unravel_index(int((rel * hard).argmax()), rel.shape)
        return (
            f"fail:region({iy},{ix}) {means[iy, ix]:.4f} vs "
            f"{ref_region_means[iy, ix]:.4f} (rel {rel[iy, ix]:.3f}, "
            f"abs {diff[iy, ix]:.4f})"
        )
    soft = (rel > 0.02) & (diff > 1e-3)
    n_soft = int(soft.sum())
    if n_soft > soft_budget:
        return (
            f"fail:{n_soft}/{grid * grid} regions beyond 2%+1e-3 "
            "(systematic shift)"
        )
    return f"pass ({n_soft} soft-divergent regions)"
