"""Build and load the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per source,
all started together, then links them into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), which is loaded
with ``ctypes``.  The build runs at first use, writes into ``build/`` inside
the package, and is redone when a source or the flags change: the library's
file name carries a hash of both.  A failed build raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of zig_weekend_raytracer_tpu_torch are built from csrc/ at first use"
    )


def build() -> dict:
    """Compile the kernels if this source hash has no library yet.
    Returns {"path", "log", "seconds", "cached"}; ``log`` holds nvcc's
    output, ``-Xptxas -v`` register and spill counts included."""
    digest = _source_hash()
    lib = os.path.join(BUILD_DIR, f"libzwrt_kernels_{digest}.so")
    log_path = lib + ".log"
    if os.path.exists(lib):
        with open(log_path) as f:
            return {"path": lib, "log": f.read(), "seconds": 0.0, "cached": True}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log = ""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + log)
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return {"path": lib, "log": log, "seconds": seconds, "cached": False}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ``argtypes`` and
    ``restype`` declared for every launcher."""
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zwrt_fused_render.argtypes = ([p] * 6 + [i] + [p] * 12 + [i, i, i, p, i, i, i, i, i]
                                      + [p] * 6)
    lib.zwrt_fused_render.restype = ctypes.c_int
    lib.zwrt_closest_hit.argtypes = [p] * 4 + [f, f] + [p] * 3 + [i, p]
    lib.zwrt_closest_hit.restype = ctypes.c_int
    lib.zwrt_coherent_keys.argtypes = [p] * 6 + [i, p, i, p]
    lib.zwrt_coherent_keys.restype = ctypes.c_int
    lib.zwrt_bounce.argtypes = [p] * 6 + [i] + [p] * 11 + [i] * 5 + [p, i, i, p, p]
    lib.zwrt_bounce.restype = ctypes.c_int
    lib.zwrt_fp32_chain.argtypes = [i, i, i, p, p, i, i, p]
    lib.zwrt_fp32_chain.restype = ctypes.c_int
    return lib
