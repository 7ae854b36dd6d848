"""Roofline bounds of the port's kernels on one NVIDIA H100 SXM.

A kernel's bound is the larger of two times: its FP32 operations over the
card's peak FP32 rate outside the tensor cores (67 TFLOP/s), and the bytes
it must move (each input read once, each output written once) over the
HBM3 rate (3.35 TB/s), both from NVIDIA's data sheet at the 700 W limit.

``OPS`` counts the FP32 operations of each unit of work in the device code
(``csrc/zwrt_device.cuh``): each float add, sub, mul, div, compare, min or
max counts 1, as does each sqrt, rsqrt or transcendental; the build has
no FMAs (``-fmad=false``); integer work (PCG4D, Sobol bits, indices) and
selects are not counted.  The work comes from the plain versions' counts
(``utils/workcount.py``) on the same inputs, or on a slice of them scaled
to the kernel's own bounce count.
"""

from __future__ import annotations

from ..scene import PRIM_SPHERE
from ..textures import image_table

PEAK_FP32_OPS = 67e12    # FP32 operations per second, CUDA cores
PEAK_BYTES = 3.35e12     # HBM3 bytes per second

OPS = {
    # sobol pixel sample, the ray through the viewport, the time draw
    "camera_ray": 30,
    # the defocus disk: two uniforms, gauss2, the lens offset
    "camera_dof": 31,
    # trace_closest's setup: 1/d, a = d.d, 1/a
    "trace": 9,
    # one sphere or quad against a ray (brute or leaf slot)
    "sphere_test": 28,
    "quad_test": 39,
    # one node's slab test
    "slab_test": 26,
    # a leaf's 8-column reduction
    "leaf_visit": 16,
    # a hit's shade: point, facing, the bounce's four uniforms
    "shade": 16,
    # the sphere's outward normal (moving centre included)
    "hit_sphere": 12,
    # checker parity: three scaled floors
    "checker": 6,
    # background on a miss, emission on a hit light
    "miss": 6,
    "hit_emissive": 6,
    # scatter per material, through the throughput update
    "hit_lambertian": 87,
    "hit_isotropic": 55,
    "hit_metal": 24,
    "hit_metal_gauss": 60,
    "hit_dielectric": 68,
    # UVs and the texel's unpack: sphere (rotation, acos, atan2), quad
    # (two cross-dot products); the same whether the texel comes from the
    # atlas or the texture LUT (one fetch, zwrt_device.cuh:image_texel)
    "texel_sphere": 26,
    "texel_quad": 44,
    # the light list: one light's PDF and sample, by kind
    "light_pdf_sphere": 52,
    "light_pdf_quad": 73,
    "light_sample_sphere": 77,
    "light_sample_quad": 15,
}


def mixture_ops(scene) -> float:
    """FP32 operations of the 50/50 light mixture on one diffuse bounce:
    the light uniforms and choice, half a light sample (the other half
    takes the material's direction), every light's PDF and the mix."""
    kinds = [k for k, _ in scene.light_params]
    if not kinds:
        return 0.0
    name = lambda k: "sphere" if k == PRIM_SPHERE else "quad"
    sample = sum(OPS[f"light_sample_{name(k)}"] for k in kinds) / len(kinds)
    pdf = sum(OPS[f"light_pdf_{name(k)}"] + 1 for k in kinds) + 1
    return 4 + 1 + 0.5 * sample + pdf + 3 + 1


def trace_ops(counts) -> float:
    """Operations of the closest hits in ``counts``."""
    return sum(OPS[k] * counts.get(k, 0) for k in (
        "trace", "sphere_test", "quad_test", "slab_test", "leaf_visit"))


def render_ops(counts, scene, has_dof: bool) -> float:
    """Operations of a render (or a drain) whose plain version counted
    ``counts``: camera rays, traces, shading and scatter by material."""
    bounces = counts.get("bounce", 0)
    hits = bounces - counts.get("miss", 0)
    metal = "hit_metal_gauss" if scene.needs_gauss else "hit_metal"
    ops = trace_ops(counts) + OPS["shade"] * hits
    ops += counts.get("camera_ray", 0) * (OPS["camera_ray"] + (OPS["camera_dof"] if has_dof else 0))
    for k in ("hit_sphere", "checker", "miss", "hit_emissive", "hit_lambertian",
              "hit_isotropic", "hit_dielectric", "texel_sphere", "texel_quad"):
        ops += OPS[k] * counts.get(k, 0)
    ops += OPS[metal] * counts.get("hit_metal", 0)
    diffuse = counts.get("hit_lambertian", 0) + counts.get("hit_isotropic", 0)
    return ops + mixture_ops(scene) * diffuse


def scaled(counts, factor: float) -> dict:
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
    """Bytes of the image table the kernels read: the texture LUT when the
    scene has one, else the atlas; none without images."""
    if not scene.has_image_textures:
        return 0
    return image_table(scene)[1].numel() * 4


def render_table_bytes(scene) -> int:
    """Bytes of the tables a render kernel reads: the trace's, the shade
    records, the Sobol table and, for an image scene, its image table."""
    return (trace_bytes(scene) + scene.shade_rows.numel() * 4 + 5 * 52 * 4
            + image_table_bytes(scene))


def bound_ms(ops: float, nbytes: float):
    """(least time in ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
