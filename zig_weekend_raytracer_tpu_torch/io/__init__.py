"""Image input and output: stb_image decode of texture images and
byte-compatible PPM encoding through the native writer."""

from .image import load_image
from .ppm import encode_pixels, encode_ppm_bytes, write_image, write_ppm
