"""PPM (P3) output, byte-compatible with the reference writer (counterpart
of ``io/ppm.py``).

Encoding (reference: src/writer/writer.zig:68-94): NaN scrub to 0, gamma-2
sqrt, clamp to [0, 0.999], * 256 truncated to u8, one "r g b" line per
pixel.  ``write_ppm`` formats the text with the native threaded writer
(``io/native.py``); a failed build or write raises.  ``encode_ppm_bytes``
is its plain numpy version, which the tests hold the native bytes to;
``decode_ppm_bytes`` reads the P3 file back.
"""

from __future__ import annotations

import numpy as np


def encode_pixels(fb) -> np.ndarray:
    """Linear f32 (H, W, 3) -> u8 (H, W, 3)."""
    color = np.asarray(fb, np.float32)
    color = np.where(np.isnan(color), 0.0, color)
    color = np.sqrt(np.maximum(color, 0.0))
    color = np.clip(color, 0.0, 0.999)
    return (color * 256.0).astype(np.uint8)


def encode_ppm_bytes(pixels_u8: np.ndarray) -> bytes:
    """The P3 file of (H, W, 3) uint8 pixels, formatted in numpy."""
    h, w, _ = pixels_u8.shape
    lut = np.array([str(i).encode() for i in range(256)], dtype=object)
    flat = pixels_u8.reshape(-1, 3)
    lines = lut[flat[:, 0]] + b" " + lut[flat[:, 1]] + b" " + lut[flat[:, 2]] + b"\n"
    return f"P3\n{w} {h}\n255\n".encode() + b"".join(lines.tolist())


def decode_ppm_bytes(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a P3 (plain text) PPM with maxval 255, the
    format ``write_ppm`` writes and stb_image does not read; '#' comments
    are skipped.  Raises ``ValueError`` on any other file."""
    lines = [ln.split(b"#", 1)[0] for ln in data.splitlines()]
    tokens = b" ".join(lines).split()
    if len(tokens) < 4 or tokens[0] != b"P3":
        raise ValueError("not a P3 PPM")
    w, h, maxval = (int(t) for t in tokens[1:4])
    if maxval != 255 or len(tokens) != 4 + 3 * w * h:
        raise ValueError(f"P3 PPM of {w}x{h}, maxval {maxval}: {len(tokens) - 4} samples")
    px = np.array(tokens[4:], dtype=np.int64)
    if px.min(initial=0) < 0 or px.max(initial=0) > 255:
        raise ValueError("P3 PPM sample outside [0, 255]")
    return px.astype(np.uint8).reshape(h, w, 3)


def write_ppm(path: str, fb, n_threads: int = 0) -> None:
    """Write a linear-space framebuffer to a P3 PPM file with the native
    writer (``n_threads`` sizes its pool, 0 = one per core)."""
    from . import native

    native.write_ppm(path, encode_pixels(fb), n_threads=n_threads)


def extension(path: str) -> str:
    """The lower-case extension of ``path``, "" when it has none."""
    return path.rsplit(".", 1)[-1].lower() if "." in path else ""


def write_image(path: str, fb, n_threads: int = 0) -> None:
    """Write a linear-space framebuffer, the format chosen by extension
    (case-blind) as the JAX package chooses it: ``.png``, ``.jpg`` /
    ``.jpeg`` and ``.bmp`` encode the same pixel bytes (``io/png.py``,
    ``io/jpeg.py``, ``io/bmp.py``, no imaging package); anything else is a
    P3 PPM."""
    ext = extension(path)
    if ext == "png":
        from .png import write_png

        write_png(path, encode_pixels(fb))
    elif ext in ("jpg", "jpeg"):
        from .jpeg import write_jpeg

        write_jpeg(path, encode_pixels(fb))
    elif ext == "bmp":
        from .bmp import write_bmp

        write_bmp(path, encode_pixels(fb))
    else:
        write_ppm(path, fb, n_threads=n_threads)
