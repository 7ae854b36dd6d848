"""Image decode and the PPM writer through the repository's native library
(counterpart of ``io/native.py``).

``native/zwrt_native.cpp`` wraps the vendored stb_image
(``native/third_party/stb/``), the decoder the JAX package uses, so both
packages get the same bytes from a JPEG, and holds the threaded mmap'd P3
writer.  At first use ``g++`` builds it into the port's ``build/``
directory (named by a hash of the sources and flags) and ``ctypes`` binds
``zwrt_decode_image``, ``zwrt_free`` and ``zwrt_write_ppm``.  A failed
build raises; there is no fallback decoder or writer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "build")
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
SOURCES = (
    os.path.join(NATIVE_DIR, "zwrt_native.cpp"),
    os.path.join(NATIVE_DIR, "third_party", "stb", "stb_image.h"),
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def build() -> str:
    """Compile the native library if this source hash has none yet;
    returns its path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libzwrt_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCES[0]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(), use_errno=True)
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.zwrt_decode_image.restype = u8p
    lib.zwrt_decode_image.argtypes = [u8p, ctypes.c_int64, ip, ip, ip]
    lib.zwrt_free.restype = None
    lib.zwrt_free.argtypes = [ctypes.c_void_p]
    lib.zwrt_write_ppm.restype = ctypes.c_int
    lib.zwrt_write_ppm.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int]
    return lib


def write_ppm(path: str, pixels_u8: np.ndarray, n_threads: int = 0) -> None:
    """Write (H, W, 3) uint8 pixels as a P3 PPM with the native writer
    (``n_threads`` 0: one per core); raises ``OSError`` naming the failed
    stage."""
    if pixels_u8.dtype != np.uint8 or pixels_u8.ndim != 3 or pixels_u8.shape[2] != 3:
        raise ValueError(f"pixels must be (H, W, 3) uint8, got {pixels_u8.dtype} "
                         f"{pixels_u8.shape}")
    lib = load_library()
    h, w, _ = pixels_u8.shape
    buf = np.ascontiguousarray(pixels_u8)
    ctypes.set_errno(0)
    rc = lib.zwrt_write_ppm(
        os.fsencode(path), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        int(n_threads),
    )
    if rc != 0:
        # rc names the failing stage (native/zwrt_native.cpp); errno the cause
        stage = {-1: "open", -2: "ftruncate", -3: "mmap"}.get(rc, "write")
        err = ctypes.get_errno()
        detail = f": {os.strerror(err)}" if err else ""
        raise OSError(err, f"native PPM write failed at {stage} (rc={rc}){detail}: {path}")


def decode_image(data: bytes) -> np.ndarray:
    """Decode JPG/PNG/BMP bytes to (H, W, 3) uint8 with stb_image; raises
    ``ValueError`` when stb_image cannot decode them."""
    lib = load_library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    arr = np.frombuffer(data, np.uint8)
    ptr = lib.zwrt_decode_image(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if not ptr:
        raise ValueError(f"stb_image could not decode {arr.size} bytes")
    try:
        n = w.value * h.value * 3
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(h.value, w.value, 3)
    finally:
        lib.zwrt_free(ptr)
