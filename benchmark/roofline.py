"""The render kernel's roofline bound on one NVIDIA H100 SXM, frozen with
the benchmark (a copy of the port's ``utils/roofline.py`` at commit
07b96da, priced at the data sheet's rates only).

A kernel's bound is the larger of two times: its lane-operations at the
card's dispatch rates, and the bytes it must move (each input read once,
each output written once) over the HBM3 rate (3.35 TB/s).  ``OPS`` counts
the lane-operations of each unit of work in the device code in three
classes, each at its own rate:

  * ``fp``: FP32 add, sub, mul, div, sqrt, rsqrt, transcendentals and
    conversions (the build has no FMAs): one lane-operation per FP32 lane
    per clock, the data sheet's 67 TFLOP/s over two;
  * ``cmp``: compares, selects, min/max and clamps, at half that rate;
  * ``int``: integer work (the PCG4D hash, the Sobol sampler's table
    reads, addresses), at half that rate.

Every class passes one dispatch slot per clock (the fp rate) and runs on
its own pipe at its own rate, so the least time of ``ops`` is the larger
of sum(ops) / rate["fp"] and each class's ops / rate[class].  The work is
what the reference (``benchmark/reference``) counts while it renders the
pixels a run checks, scaled to the whole image (``k1_bound``): each bounce,
hit by material, camera ray, brute primitive test, and, on a tree scene,
the cond walk's node tests, leaf visits and leaf-slot tests over the
reference's own copy of the port's group trees.
"""

from __future__ import annotations

from .reference.sampling.sampler import sobol_log2_scale
from .reference.sampling.sobol import MAX_SPP_LOG2, SOBOL_MATRIX_SIZE, sobol_sample_bytes
from .reference.scene import PRIM_SPHERE
from .reference.textures import image_table

# FP32 lane-operations per second, CUDA cores: NVIDIA's data sheet (H100
# SXM, 700 W) gives 67 TFLOP/s counting an FMA as two FLOPs, one FP32
# operation per lane per clock (132 SMs x 128 lanes x 1.98 GHz = 33.45e12)
PEAK_FP32_OPS = 33.5e12
PEAK_BYTES = 3.35e12     # HBM3 bytes per second, the same data sheet
CLASSES = ("fp", "cmp", "int")
RATES = {"fp": PEAK_FP32_OPS, "cmp": PEAK_FP32_OPS / 2, "int": PEAK_FP32_OPS / 2}
# bytes a lane of the render kernel reads and writes beside the tables:
# its lane (px, py, s0, s1) in, its radiance and work out
K1_LANE_BYTES = 16 + 16


def _ops(fp=0, cmp=0, int=0):
    return {"fp": fp, "cmp": cmp, "int": int}


# Per unit: the FP32 operations (compares and selects once counted as
# FP32 too), split into fp and cmp by
# reading the device code, and the integer operations.
OPS = {
    # the ray through the viewport and the time draw (one PCG4D, the ray
    # id); the Sobol sampler's integer work is sobol_ops'
    "camera_ray": _ops(24, 6, 24),
    # the defocus disk: two uniforms (two PCG4D), gauss2, the lens offset
    "camera_dof": _ops(28, 3, 44),
    # trace_closest's setup: 1/d, a = d.d, 1/a
    "trace": _ops(9, 0, 2),
    # one sphere or quad against a ray (brute or leaf slot)
    "sphere_test": _ops(21, 7, 2),
    "quad_test": _ops(30, 9, 2),
    # one node's slab test: 12 NaN-propagating min/max, the compare
    "slab_test": _ops(13, 25, 4),
    # a leaf's 8-column reduction
    "leaf_visit": _ops(0, 16, 8),
    # a hit's shade: point, facing, the bounce's four uniforms (PCG4D)
    "shade": _ops(12, 4, 28),
    # the sphere's outward normal (moving centre included)
    "hit_sphere": _ops(12),
    # checker parity: three scaled floors
    "checker": _ops(6, 0, 3),
    # background on a miss, emission on a hit light
    "miss": _ops(6),
    "hit_emissive": _ops(5, 1),
    # scatter per material, through the throughput update
    "hit_lambertian": _ops(78, 9),
    "hit_isotropic": _ops(49, 6, 20),
    "hit_metal": _ops(20, 4),
    "hit_metal_gauss": _ops(52, 8, 20),
    "hit_dielectric": _ops(58, 10),
    # UVs and the texel's unpack: sphere (rotation, acos, atan2), quad
    # (two cross-dot products); the same whether the texel comes from the
    # atlas or the texture LUT (one fetch, zwrt_device.cuh:image_texel)
    "texel_sphere": _ops(22, 4, 8),
    "texel_quad": _ops(40, 4, 8),
    # the light list: one light's PDF and sample, by kind
    "light_pdf_sphere": _ops(41, 11),
    "light_pdf_quad": _ops(62, 11),
    "light_sample_sphere": _ops(72, 5),
    "light_sample_quad": _ops(15),
}


def sobol_ops(log2_scale: int, n_bytes: int, loop: bool) -> dict:
    """Integer operations of one Sobol camera sample (both dimensions).
    ``loop``: the earlier bit loops, 3 per VdC column (28), 6 per 64-bit
    inverse column (2L) and 4 per generator column (52 per dimension);
    else the factored form: a byte's extract, address and XOR (3) per byte
    of the sample index and dimension, and the XOR with the lane's pixel
    part per dimension."""
    if loop:
        inv = 2 * log2_scale if log2_scale else 0
        delta = MAX_SPP_LOG2 if log2_scale else 0
        return _ops(int=3 * delta + 6 * inv + 2 * 4 * SOBOL_MATRIX_SIZE)
    return _ops(int=2 * 3 * n_bytes + 2)


def add(*parts) -> dict:
    """The class-wise sum of operation counts (dicts) and their multiples."""
    out = _ops()
    for p in parts:
        for c in CLASSES:
            out[c] += p[c]
    return out


def times(ops: dict, k: float) -> dict:
    return {c: ops[c] * k for c in CLASSES}


def total(ops) -> float:
    """All lane-operations of ``ops`` (a class dict, or a number)."""
    return sum(ops[c] for c in CLASSES) if isinstance(ops, dict) else float(ops)


def mixture_ops(scene) -> dict:
    """Operations of the 50/50 light mixture on one diffuse bounce: the
    light uniforms (one PCG4D) and choice, half a light sample (the other
    half takes the material's direction), every light's PDF and the mix."""
    kinds = [k for k, _ in scene.light_params]
    if not kinds:
        return _ops()
    name = lambda k: "sphere" if k == PRIM_SPHERE else "quad"
    sample = times(add(*(OPS[f"light_sample_{name(k)}"] for k in kinds)), 0.5 / len(kinds))
    pdf = add(*(OPS[f"light_pdf_{name(k)}"] for k in kinds), _ops(fp=len(kinds) + 1))
    return add(_ops(fp=7, cmp=2, int=24), sample, pdf)


def trace_ops(counts) -> dict:
    """Operations of the closest hits in ``counts``."""
    return add(*(times(OPS[k], counts.get(k, 0)) for k in (
        "trace", "sphere_test", "quad_test", "slab_test", "leaf_visit")))


def render_ops(counts, scene, has_dof: bool, sobol=None) -> dict:
    """Operations by class of a render (or a drain) whose plain version
    counted ``counts``: camera rays, traces, shading and scatter by
    material.  ``sobol`` = (log2_scale, n_bytes, loop) adds the Sobol
    sampler's integer work per camera ray (``sobol_ops``); None counts
    none (another sampler)."""
    bounces = counts.get("bounce", 0)
    hits = bounces - counts.get("miss", 0)
    metal = "hit_metal_gauss" if scene.needs_gauss else "hit_metal"
    camera = add(OPS["camera_ray"], OPS["camera_dof"] if has_dof else _ops(),
                 sobol_ops(*sobol) if sobol else _ops())
    parts = [trace_ops(counts), times(OPS["shade"], hits),
             times(camera, counts.get("camera_ray", 0))]
    for k in ("hit_sphere", "checker", "miss", "hit_emissive", "hit_lambertian",
              "hit_isotropic", "hit_dielectric", "texel_sphere", "texel_quad"):
        parts.append(times(OPS[k], counts.get(k, 0)))
    parts.append(times(OPS[metal], counts.get("hit_metal", 0)))
    diffuse = counts.get("hit_lambertian", 0) + counts.get("hit_isotropic", 0)
    parts.append(times(mixture_ops(scene), diffuse))
    return add(*parts)


def scaled(counts, factor: float) -> dict:
    """Work counts times ``factor``."""
    return {k: v * factor for k, v in counts.items()}


def trace_bytes(scene) -> int:
    """Bytes of the tables a trace reads: per kind the brute rows or the
    tree (boxes, links, leaf slots and their original indices)."""
    n = 0
    for kind, n_prims, width in (("sph", scene.n_spheres, 8), ("quad", scene.n_quads, 16)):
        if getattr(scene, f"has_{kind}_tree"):
            n += getattr(scene, f"{kind}_tree_box").numel() * 4
            n += getattr(scene, f"{kind}_tree_link").numel() * 4
            n += getattr(scene, f"{kind}_tree_attrs")[-1].numel() * (width + 1) * 4
        else:
            n += n_prims * width * 4
    return n


def image_table_bytes(scene) -> int:
    """Bytes of the image table the kernels' texel fetch reads
    (``reference/textures.py:image_table``): the texture LUT when the scene
    has one, else the atlas as it is laid out, every image padded to the
    largest; none without images."""
    if not scene.has_image_textures:
        return 0
    return image_table(scene)[1].numel() * 4


def render_table_bytes(scene, sobol_bytes: int) -> int:
    """Bytes of the tables the render kernel reads: the trace's, the shade
    records, the Sobol table, the factored Sobol tables (2 x
    ``sobol_bytes`` x 256 u32) and, on a scene with images, its image
    table (``image_table_bytes``)."""
    return (trace_bytes(scene) + scene.shade_rows.numel() * 4 + 5 * 52 * 4
            + 2 * sobol_bytes * 256 * 4 + image_table_bytes(scene))


def ops_seconds(ops: dict) -> float:
    """The least time of ``ops``: every lane-operation through the one
    dispatch slot at the fp rate, and each class on its own pipe at its
    own rate, whichever is longer."""
    return max(total(ops) / RATES["fp"], *(ops[c] / RATES[c] for c in CLASSES))


def bound_ms(ops: dict, nbytes: float):
    """(least time in ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops_seconds(ops), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k1_bound(scene, counts, n_pixels_counted: int, has_dof: bool, spp: int, width: int,
             height: int) -> dict:
    """The bound of one render-kernel image at ``width`` x ``height`` and
    ``spp``, one lane a pixel: the reference's ``counts`` over
    ``n_pixels_counted`` pixels (every sample of each) scaled to the
    image's pixels, the Sobol respawn in its factored form; bytes are the
    lanes' and the tables'.  Returns {"ms", "by", "ops", "bytes"}.

    It bounds the render's work, whichever render kernel runs it: K1, or
    the bounce kernel K2 in its regenerating mode, which the program sends
    scenes with an image atlas to.  The reference counts the same paths
    either way, so a reader of K2's share divides this same bound by K2's
    device time an image."""
    pixels = width * height
    n_bytes = sobol_sample_bytes(spp)
    ops = render_ops(scaled(counts, pixels / n_pixels_counted), scene, has_dof,
                     sobol=(sobol_log2_scale(width, height), n_bytes, False))
    nbytes = K1_LANE_BYTES * pixels + render_table_bytes(scene, n_bytes)
    ms, by = bound_ms(ops, nbytes)
    return {"ms": ms, "by": by, "ops": ops, "bytes": nbytes}
