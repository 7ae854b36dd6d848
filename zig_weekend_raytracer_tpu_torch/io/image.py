"""Texture image loading (counterpart of ``io/image.py``): decode happens
once at scene build and the pixels then live in the scene's atlas.

A path that does not exist resolves to the magenta 1x1 debug image, as in
the reference (its null-object image).  A file that exists but does not
decode raises: a silent magenta atlas would pass every parity check and
still be wrong.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from . import native

log = logging.getLogger("zwrt")

DEBUG_MAGENTA = np.full((1, 1, 3), (255, 0, 255), np.uint8)


def load_image(path: str) -> np.ndarray:
    """Returns (H, W, 3) uint8; the magenta debug image when ``path`` does
    not exist."""
    if not os.path.exists(path):
        log.warning("image not found, using debug color: %s", path)
        return DEBUG_MAGENTA.copy()
    with open(path, "rb") as f:
        data = f.read()
    try:
        img = native.decode_image(data)
    except ValueError as e:
        raise ValueError(f"cannot decode image {path}: {e}") from None
    log.debug("Loaded %s (%dx%d)", path, img.shape[1], img.shape[0])
    return img
