"""Image input and output: stb_image decode of texture images,
byte-compatible PPM encoding through the native writer, and PNG encoding
with the standard library."""

from .image import load_image
from .png import encode_png, write_png
from .ppm import encode_pixels, encode_ppm_bytes, write_image, write_ppm
