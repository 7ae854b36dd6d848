"""PPM (P3) output (counterpart of ``io/ppm.py``'s numpy path): NaN scrub,
gamma-2 sqrt, clamp to [0, 0.999], * 256 truncated to u8, one "r g b"
line per pixel."""

from __future__ import annotations

import numpy as np


def encode_pixels(fb: np.ndarray) -> np.ndarray:
    """Linear f32 (H, W, 3) -> u8 (H, W, 3)."""
    color = np.asarray(fb, np.float32)
    color = np.where(np.isnan(color), 0.0, color)
    color = np.sqrt(np.maximum(color, 0.0))
    color = np.clip(color, 0.0, 0.999)
    return (color * 256.0).astype(np.uint8)


def write_ppm(path: str, fb: np.ndarray) -> None:
    """Write a linear-space framebuffer to a P3 PPM file."""
    pixels = encode_pixels(fb)
    h, w, _ = pixels.shape
    lut = np.array([str(i).encode() for i in range(256)], dtype=object)
    flat = pixels.reshape(-1, 3)
    lines = lut[flat[:, 0]] + b" " + lut[flat[:, 1]] + b" " + lut[flat[:, 2]] + b"\n"
    with open(path, "wb") as f:
        f.write(f"P3\n{w} {h}\n255\n".encode())
        f.write(b"".join(lines.tolist()))
