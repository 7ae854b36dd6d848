"""Image input and output: stb_image decode of texture images,
byte-compatible PPM encoding through the native writer (and its plain-text
decode), and PNG, BMP and baseline JPEG encoding with the standard library
and numpy."""

from .bmp import encode_bmp, write_bmp
from .image import load_image
from .jpeg import encode_jpeg, write_jpeg
from .png import encode_png, write_png
from .ppm import decode_ppm_bytes, encode_pixels, encode_ppm_bytes, write_image, write_ppm
