"""PNG output with the standard library alone (``zlib`` and ``struct``):
8-bit RGB or grayscale (L), no interlace, filter 0 on every row.  The port
writes its AOV buffers and ``.png`` images with it; it needs no imaging
package."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour types: 0 grayscale, 2 RGB
_COLOR_TYPE = {2: 0, 3: 2}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels_u8: np.ndarray) -> bytes:
    """The PNG file of (H, W, 3) RGB or (H, W) grayscale uint8 pixels."""
    px = np.ascontiguousarray(pixels_u8)
    if px.dtype != np.uint8 or px.ndim not in _COLOR_TYPE or (px.ndim == 3 and px.shape[2] != 3):
        raise ValueError(f"PNG pixels must be (H, W, 3) or (H, W) uint8, got "
                         f"{px.shape} {px.dtype}")
    h, w = px.shape[:2]
    rows = px.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[px.ndim], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels_u8: np.ndarray) -> None:
    """Write (H, W, 3) or (H, W) uint8 pixels to ``path`` as a PNG."""
    data = encode_png(pixels_u8)
    with open(path, "wb") as f:
        f.write(data)
