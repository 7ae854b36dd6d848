"""Image input and output: stb_image decode of texture images and
byte-compatible PPM encoding."""

from .image import load_image
from .ppm import encode_pixels, write_ppm
