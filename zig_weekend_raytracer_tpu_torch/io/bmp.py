"""BMP output with the standard library alone: 24-bit BI_RGB, rows bottom
up in BGR order, each padded to a multiple of 4 bytes, 96 dpi.  The bytes
are those that PIL's ``Image.save`` writes for the same RGB pixels; the port
needs no imaging package."""

from __future__ import annotations

import struct

import numpy as np

# 96 dpi in pixels per metre, as PIL rounds it: int(96 * 39.3701 + 0.5)
_PIXELS_PER_METRE = 3780
_FILE_HEADER = 14
_INFO_HEADER = 40


def encode_bmp(pixels_u8: np.ndarray) -> bytes:
    """The BMP file of (H, W, 3) RGB uint8 pixels."""
    px = np.asarray(pixels_u8)
    if px.dtype != np.uint8 or px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"BMP pixels must be (H, W, 3) uint8, got {px.shape} {px.dtype}")
    h, w, _ = px.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = px[::-1, :, ::-1].reshape(h, w * 3)
    image = stride * h
    offset = _FILE_HEADER + _INFO_HEADER
    header = b"BM" + struct.pack("<IiI", offset + image, 0, offset)
    info = struct.pack("<IiiHHIIiiII", _INFO_HEADER, w, h, 1, 24, 0, image,
                       _PIXELS_PER_METRE, _PIXELS_PER_METRE, 0, 0)
    return header + info + rows.tobytes()


def write_bmp(path: str, pixels_u8: np.ndarray) -> None:
    """Write (H, W, 3) RGB uint8 pixels to ``path`` as a 24-bit BMP."""
    data = encode_bmp(pixels_u8)
    with open(path, "wb") as f:
        f.write(data)
