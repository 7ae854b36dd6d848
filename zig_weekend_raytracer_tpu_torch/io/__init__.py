"""Image output: byte-compatible PPM encoding."""

from .ppm import encode_pixels, write_ppm
