"""Image comparison: MSE / PSNR / mean statistics between two renders
(counterpart of the JAX package's ``tools/imgdiff.py``).

    python -m zig_weekend_raytracer_tpu_torch.tools.imgdiff a.ppm b.png [ref.png]

With two images, prints their difference statistics.  With three, prints
each of the first two images' error against the reference, the workflow
for judging the adaptive sampler or the indirect clamp at equal budget:

    python -m zig_weekend_raytracer_tpu_torch.tools.imgdiff uniform.png adaptive.png ref.png

Reads the plain-text PPM the renderers write, and PNG, JPEG, BMP and binary
PPM through stb_image (``io/native.py``; no imaging package); compares in
linear space by inverting the writers' gamma 2 (``io/ppm.py:encode_pixels``).
A host tool: it decodes and compares on the CPU and needs no card.  A
missing or undecodable file exits 1."""

from __future__ import annotations

import sys

import numpy as np


def load_linear(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear values of the image at ``path``.  A missing
    file raises ``OSError`` (where ``io/image.load_image`` would give its
    magenta debug image), one that does not decode ``ValueError``."""
    from ..io.native import decode_image
    from ..io.ppm import decode_ppm_bytes

    with open(path, "rb") as f:
        data = f.read()
    pixels = decode_ppm_bytes(data) if data[:2] == b"P3" else decode_image(data)
    srgb = pixels.astype(np.float32) / 255.0
    return srgb * srgb  # invert gamma-2


def stats(a: np.ndarray, b: np.ndarray) -> dict:
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    d = a - b
    mse = float((d * d).mean())
    peak = max(float(a.max()), float(b.max()), 1e-20)
    return {
        "mse": mse,
        "rmse": mse ** 0.5,
        "psnr_db": float("inf") if mse == 0 else
        10.0 * np.log10(peak * peak / mse),
        "mean_a": float(a.mean()),
        "mean_b": float(b.mean()),
        "max_abs": float(np.abs(d).max()),
    }


def _fmt(s: dict) -> str:
    return (
        f"mse={s['mse']:.3e} rmse={s['rmse']:.3e} psnr={s['psnr_db']:.2f}dB "
        f"max|d|={s['max_abs']:.4f} means={s['mean_a']:.4f}/{s['mean_b']:.4f}"
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    try:
        imgs = [load_linear(p) for p in argv]
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if len(argv) == 2:
        print(f"{argv[0]} vs {argv[1]}: {_fmt(stats(imgs[0], imgs[1]))}")
    else:
        ref = imgs[2]
        for path, im in zip(argv[:2], imgs[:2]):
            print(f"{path} vs ref: {_fmt(stats(im, ref))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
