"""The JAX reference decodes with its own stb_image library in every parity
test of the port.

The JAX package's loader (``zig_weekend_raytracer_tpu/io/image.py``)
decodes with the repository's stb_image library when
``io/native.py:available()`` is true and falls back to PIL, silently, when
it is not.  ``available()`` tries once a process and keeps the answer; it
builds ``native/libzwrt_native.so`` only when that file is missing, and
g++ writes it in place.  Test workers that collect at once on a fresh
checkout can so read it half written and decode with PIL for the rest of
the process, and PIL's JPEG decode is not stb_image's (on wap.jpg 5.69%
of values differ), so every comparison of the port with a JAX scene that
holds a JPEG fails there.

``bind_reference_native()`` builds the reference library once into a
private path named by a hash of its sources, under a file lock, with the
JAX package's own ``build()``, renames it into place, and points the JAX
loader at it.  It raises, naming the path and the error, when the library
cannot be built or loaded: no skip, no fallback.  It runs when this module
is imported (each xdist worker imports every test file before it runs any
test), and every port test file that reaches the JAX loader imports the
autouse fixture ``reference_decodes_with_stb``, which binds again before
each such module.

  (a) The fault: with the JAX loader pointed at a 0-byte library, its
      decode of wap.jpg is PIL's and differs from the port's on more than
      1% of values.
  (b) The repair: on that 0-byte path, ``bind_reference_native()`` makes
      JAX's decode of wap.jpg and me.jpg bitwise the port's.
  (c) Two spawned processes binding at once against an empty directory
      both end on stb_image, bitwise the port's, and leave one library.
  (d) Every ``tests/test_torch_*.py`` that names an image scene, a JPEG or
      ``load_image`` imports the fixture.
"""

import contextlib
import fcntl
import glob
import hashlib
import io
import logging
import multiprocessing
import os
import re

import numpy as np
import pytest
from PIL import Image

from zig_weekend_raytracer_tpu.io import image as jimage
from zig_weekend_raytracer_tpu.io import native as jnative
from zig_weekend_raytracer_tpu_torch.io import image as timage

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ASSETS = os.path.join(REPO, "assets")
SOURCES = (
    os.path.join(REPO, "native", "zwrt_native.cpp"),
    os.path.join(REPO, "native", "third_party", "stb", "stb_image.h"),
)
PRIVATE_DIR = os.path.join(TESTS, ".reference_native")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _zwrt_warnings():
    """The JAX package's warnings while the block runs: its build and load
    report their errors there and return nothing else."""
    said = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: said.append(record.getMessage())
    logger = logging.getLogger("zwrt")
    logger.addHandler(handler)
    try:
        yield said
    finally:
        logger.removeHandler(handler)


def bind_reference_native(private_dir: str = PRIVATE_DIR) -> str:
    """Point this process's JAX loader at the reference's stb_image library
    in ``private_dir`` (built there at most once, atomically) and return
    its path; raise when it cannot be built or loaded."""
    digest = _source_hash()
    lib = os.path.join(private_dir, f"libzwrt_native_{digest}.so")
    if jnative._LIB_PATH == lib and jnative._lib is not None:
        return lib
    os.makedirs(private_dir, exist_ok=True)
    with open(os.path.join(private_dir, f"libzwrt_native_{digest}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            shared = jnative._LIB_PATH
            jnative._LIB_PATH = tmp
            try:
                with _zwrt_warnings() as said:
                    built = jnative.build(force=True)
            finally:
                jnative._LIB_PATH = shared
            if not built:
                raise RuntimeError(f"the reference's stb_image library did not build into "
                                   f"{tmp}: {' '.join(said) or 'no message'}")
            os.replace(tmp, lib)
    with jnative._lock:
        jnative._LIB_PATH, jnative._tried, jnative._lib = lib, False, None
    with _zwrt_warnings() as said:
        loaded = jnative.available()
    if not loaded:
        raise RuntimeError(f"the reference's stb_image library {lib} did not load: "
                           f"{' '.join(said) or 'no message'}")
    return lib


bind_reference_native()


@pytest.fixture(scope="module", autouse=True)
def reference_decodes_with_stb():
    """Each module that imports this fixture runs with the JAX loader on
    the private stb_image library, bound again if it was left elsewhere."""
    lib = bind_reference_native()
    assert jnative._LIB_PATH == lib and jnative._lib is not None
    yield


def _point_jax_at(monkeypatch, path):
    """Aim the JAX loader at ``path`` as a fresh process would find it."""
    monkeypatch.setattr(jnative, "_LIB_PATH", str(path))
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)


def _half_built(tmp_path):
    empty = tmp_path / "libzwrt_native.so"
    empty.write_bytes(b"")
    return empty


# ---- (a) the fault ----

def test_half_built_library_sends_jax_to_pil(tmp_path, monkeypatch):
    _point_jax_at(monkeypatch, _half_built(tmp_path))
    path = os.path.join(ASSETS, "wap.jpg")
    got, want = jimage.load_image(path), timage.load_image(path)
    assert not jnative.available()  # latched: the process stays on PIL
    with open(path, "rb") as f, Image.open(io.BytesIO(f.read())) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB"), np.uint8))
    assert got.shape == want.shape
    assert (got != want).mean() > 0.01


# ---- (b) the repair ----

@pytest.mark.parametrize("name", ["wap.jpg", "me.jpg"])
def test_binding_repairs_a_latched_fallback(tmp_path, monkeypatch, name):
    _point_jax_at(monkeypatch, _half_built(tmp_path))
    assert not jnative.available()
    lib = bind_reference_native()
    assert jnative._LIB_PATH == lib and jnative.available()
    path = os.path.join(ASSETS, name)
    got, want = jimage.load_image(path), timage.load_image(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- (c) the race ----

def _bind_in_child(private_dir, barrier, results):
    try:
        barrier.wait()
        lib = bind_reference_native(private_dir)
        img = jimage.load_image(os.path.join(ASSETS, "wap.jpg"))
        results.put((lib, jnative._LIB_PATH, jnative._lib is not None, img.shape,
                     hashlib.sha256(img.tobytes()).hexdigest()))
    except Exception as e:
        results.put(repr(e))  # the parent's assertion shows it
        raise


def test_two_processes_bind_at_once(tmp_path):
    private = tmp_path / "private"
    private.mkdir()
    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=_bind_in_child, args=(str(private), barrier, results))
             for _ in range(2)]
    for p in procs:
        p.start()
    try:
        got = [results.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    want = timage.load_image(os.path.join(ASSETS, "wap.jpg"))
    lib = os.path.join(str(private), f"libzwrt_native_{_source_hash()}.so")
    expected = (lib, lib, True, want.shape, hashlib.sha256(want.tobytes()).hexdigest())
    assert got == [expected, expected]
    assert [p.exitcode for p in procs] == [0, 0]
    assert sorted(os.listdir(private)) == sorted([os.path.basename(lib),
                                                  os.path.basename(lib)[:-3] + ".lock"])


# ---- (d) the guard ----

FIXTURE_IMPORT = "from test_torch_reference_native import reference_decodes_with_stb"
REACHES_LOADER = re.compile(r"shrek_quads|rtw_final|\.jpg|load_image|earth|\"image\"")


def test_every_image_parity_file_imports_the_fixture():
    reaching, missing = [], []
    for path in sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py"))):
        name = os.path.basename(path)
        with open(path) as f:
            src = f.read()
        if name == os.path.basename(__file__) or not REACHES_LOADER.search(src):
            continue
        reaching.append(name)
        if FIXTURE_IMPORT not in src:
            missing.append(name)
    assert {"test_torch_images.py", "test_torch_tool_lut_quality.py"} <= set(reaching)
    assert not missing, f"these files reach the JAX loader without the fixture: {missing}"
