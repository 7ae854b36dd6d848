"""Roofline bounds of the port's kernels on one NVIDIA H100 SXM.

A kernel's bound is the larger of two times: its lane-operations at the
card's dispatch rates, and the bytes it must move (each input read once, each
output written once) over the HBM3 rate (3.35 TB/s, NVIDIA's data sheet at
the 700 W limit).

``OPS`` counts the lane-operations of each unit of work in the device code
(``csrc/zwrt_device.cuh``) in three classes, each priced at its own rate:

  * ``fp``: FP32 add, sub, mul, div, sqrt, rsqrt, transcendentals and
    conversions; the build has no FMAs (``-fmad=false``).  Rate: the
    ``add`` chain of the FP32-peak microbenchmark (``tools/fp32_peak.py``,
    kernel K5), one lane-operation per FP32 lane per clock.
  * ``cmp``: compares, selects, min/max and clamps (FSETP, FSEL, FMNMX; a
    NaN-propagating min or max is a compare and a select).  Rate: K5's
    ``select`` chain, half the add rate on an H100.
  * ``int``: integer work: PCG4D (20 per draw: multiply-adds, shifts,
    XORs), the Sobol sampler's factored table reads and its pixel part's
    bit loops, addresses and indices.  Rate: K5's ``int`` chain (IMAD and LOP3).

Every class passes one dispatch slot per clock per partition (the
add rate) and runs on its own pipe at its own rate, so the least time of
``ops`` is the larger of sum(ops) / rate["fp"] and each class's ops /
rate[class] (``ops_seconds``).  A run that measured the rates with K5
passes them (``rates`` of ``tools/fp32_peak.py:run``); otherwise the data
sheet's FP32 rate prices ``fp`` and half of it the others
(``DATA_SHEET_RATES``), and ``peak_source`` names which a bound used.  The
work comes from the plain versions' counts (``utils/workcount.py``) on the
same inputs, or on a slice of them scaled to the kernel's own bounce count.
"""

from __future__ import annotations

from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..sampling.sobol import MAX_SPP_LOG2, SOBOL_MATRIX_SIZE, sobol_sample_bytes
from ..scene import PRIM_SPHERE
from ..textures import image_table

# FP32 lane-operations per second, CUDA cores: the data sheet's 67 TFLOP/s
# counts an FMA as two FLOPs, and the card issues one FP32 operation per
# lane per clock (132 x 128 x 1.98 GHz = 33.45e12)
PEAK_FP32_OPS = 33.5e12
PEAK_BYTES = 3.35e12     # HBM3 bytes per second
CLASSES = ("fp", "cmp", "int")
DATA_SHEET_RATES = {"fp": PEAK_FP32_OPS, "cmp": PEAK_FP32_OPS / 2, "int": PEAK_FP32_OPS / 2}
# bytes a lane of a render-kernel run reads and writes beside the tables:
# K1 its lane table (px, py, s0, s1) in and its radiance and work out; K2's
# regenerating mode 13 float and 5 int state rows and (px, py, limit) in
# and the 18 state rows out
LANE_BYTES = {"K1": 16 + 16, "K2": 84 + 72}


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
    # the AOV pass's work per first hit past the trace: the hit point and
    # facing, the dielectric, miss and normal selects, the three sums
    "aov_hit": _ops(19, 9, 0),
}


def sobol_ops(n_bytes: int) -> dict:
    """Integer operations of one Sobol camera sample (both dimensions) in
    the factored form: a byte's extract, address and XOR (3) per byte of
    the sample index and dimension, and the XOR with the lane's pixel part
    per dimension."""
    return _ops(int=2 * 3 * n_bytes + 2)


def sobol_pixel_ops(log2_scale: int) -> dict:
    """Integer operations of a pixel's Sobol part (zwrt_device.cuh:
    sobol_pixel, both dimensions at sample 0), by the bit loops: 3 per VdC
    column (28), 6 per 64-bit inverse column (2L) and 4 per generator
    column (52 per dimension)."""
    inv = 2 * log2_scale if log2_scale else 0
    delta = MAX_SPP_LOG2 if log2_scale else 0
    return _ops(int=3 * delta + 6 * inv + 2 * 4 * SOBOL_MATRIX_SIZE)


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
    material.  ``sobol``, the bytes of the sample index, adds the Sobol
    sampler's integer work per camera ray (``sobol_ops``); None counts
    none (another sampler)."""
    bounces = counts.get("bounce", 0)
    hits = bounces - counts.get("miss", 0)
    metal = "hit_metal_gauss" if scene.needs_gauss else "hit_metal"
    camera = add(OPS["camera_ray"], OPS["camera_dof"] if has_dof else _ops(),
                 _ops() if sobol is None else sobol_ops(sobol))
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


def trace_bytes(scene, walk=None) -> int:
    """Bytes of the tables a trace reads: per kind the brute rows or the
    tree (boxes, links, leaf slots and their original indices); under the
    ``uni`` walk the unified tree alone (its nodes, packed in 32 bytes
    each, and its leaf slots with their original indices)."""
    if walk == "uni":
        return (scene.uni_tree_box.shape[0] * 32
                + scene.uni_sph_attrs[-1].numel() * (8 + 1) * 4
                + scene.uni_quad_attrs[-1].numel() * (16 + 1) * 4)
    n = 0
    for kind, n_prims, width in (("sph", scene.n_spheres, 8), ("quad", scene.n_quads, 16)):
        if getattr(scene, f"has_{kind}_tree"):
            n += getattr(scene, f"{kind}_tree_box").numel() * 4
            n += getattr(scene, f"{kind}_tree_link").numel() * 4
            n += getattr(scene, f"{kind}_tree_attrs")[-1].numel() * (width + 1) * 4
        else:
            n += n_prims * width * 4
    return n


def hit_bytes(scene, n_rays: int, live=None) -> float:
    """Bytes of a closest-hit launch and the trace's tables.  Unmasked
    (``live`` None): each ray's origin, direction and time in (28) and its
    (t, kind, idx) out (12).  Masked, ``live`` of the ``n_rays`` rays alive:
    every ray's mask byte in and its hit out (13), and a live ray's origin,
    direction and time (28); a dead ray reads nothing else."""
    if live is None:
        return n_rays * (28 + 12) + trace_bytes(scene)
    return n_rays * (1 + 12) + live * 28 + trace_bytes(scene)


def hit_bound_ms(counts, scene, n_rays: int, ops_rate=None, live=None):
    """(ms, by) of the closest-hit kernel on ``n_rays`` rays whose plain
    version counted ``counts`` (``bound_ms``); ``live`` as in
    ``hit_bytes``."""
    return bound_ms(trace_ops(counts), hit_bytes(scene, n_rays, live), ops_rate)


def aov_bound_ms(counts, scene, n_rays: int, hits: int, sphere_hits: int, pixels: int,
                 has_dof: bool, sobol=None, ops_rate=None):
    """(ms, by) of the first-hit AOV pass (render/aov.py) over ``n_rays``
    camera rays on ``pixels`` pixels: the camera rays (``sobol`` as in
    ``render_ops``), their closest hits (``counts``), per hit ``aov_hit``
    and per sphere hit its normal; bytes are the trace's tables, the shade
    records and the four float32 buffers (8 floats a pixel) written once.
    The checker and texel work of textured hits is not counted, so the
    bound is low on such scenes."""
    camera = add(OPS["camera_ray"], OPS["camera_dof"] if has_dof else _ops(),
                 _ops() if sobol is None else sobol_ops(sobol))
    ops = add(times(camera, n_rays), trace_ops(counts), times(OPS["aov_hit"], hits),
              times(OPS["hit_sphere"], sphere_hits))
    nbytes = trace_bytes(scene) + scene.shade_rows.numel() * 4 + pixels * 8 * 4
    return bound_ms(ops, nbytes, ops_rate)


# coherent_keys_kernel's work for one pixel beside its closest hit
# (trace_ops), counted from csrc/closest_hit.cu and
# zwrt_device.cuh:generate_ray at sample 0, one lane-operation per
# operator of the source and a multiply-add one, as OPS counts
KEYS_OPS = {
    # the pixel's coordinates from the thread index (4 int), the ray id
    # (2), pxf and pyf, the viewport point and the direction (19 fp), the
    # time draw (one PCG4D, to_unit) and the key: the miss select, the
    # shift and add of (kind, idx), +1 and the shift into the high word
    "common": _ops(21, 1, 31),
    # the pixel offset of each sampler: a PCG4D draw, two to_unit and two
    # offsets; stratified adds the stratum's division and remainder, their
    # conversions and scales; Sobol the float part of its two dimensions
    # (fscale, sobol_unit, the clamped offsets; sobol_pixel_ops and
    # sobol_ops count the bits: the pixel part by the bit loops, the sample
    # part from the tables)
    SamplerKind.INDEPENDENT: _ops(6, 0, 22),
    SamplerKind.STRATIFIED: _ops(12, 0, 24),
    SamplerKind.SOBOL: _ops(9, 6, 1),
    # the defocus disk: two PCG4D draws (ud; gauss2 with its log, sqrt, cos
    # and sin), the normalisation and the lens offset of the origin
    "dof": _ops(34, 2, 43),
}


def keys_pixel_ops(sampler: SamplerKind, has_dof: bool, width: int, height: int) -> dict:
    """coherent_keys_kernel's operations for one pixel of a ``width`` x
    ``height`` image beside its closest hit (``KEYS_OPS``)."""
    parts = [KEYS_OPS["common"], KEYS_OPS[sampler]]
    if has_dof:
        parts.append(KEYS_OPS["dof"])
    if sampler == SamplerKind.SOBOL:
        log2_scale = sobol_log2_scale(width, height)
        parts += [sobol_pixel_ops(log2_scale), sobol_ops(sobol_sample_bytes(1))]
    return add(*parts)


def keys_bound_ms(counts, scene, n_pixels: int, sampler: SamplerKind, has_dof: bool,
                  width: int, height: int, ops_rate=None):
    """(ms, by) of one coherent_keys_kernel launch over ``n_pixels`` pixels
    whose sample-0 rays' closest hits the plain version counted as
    ``counts``: ``keys_pixel_ops`` per pixel and ``trace_ops``; bytes are
    the trace's tables, the Sobol tables the launch stages (the sampler's
    52-column table and the factored tables of sample 0) and 8 bytes of
    key a pixel written once."""
    ops = add(times(keys_pixel_ops(sampler, has_dof, width, height), n_pixels),
              trace_ops(counts))
    sobol = 5 * 52 * 4 + 2 * sobol_sample_bytes(1) * 256 * 4 \
        if sampler == SamplerKind.SOBOL else 0
    return bound_ms(ops, trace_bytes(scene) + sobol + n_pixels * 8, ops_rate)


def image_table_bytes(scene) -> int:
    """Bytes of the image table the kernels read: the texture LUT when the
    scene has one, else the atlas; none without images."""
    if not scene.has_image_textures:
        return 0
    return image_table(scene)[1].numel() * 4


def render_table_bytes(scene, sobol_bytes: int = 0, walk=None) -> int:
    """Bytes of the tables a render kernel reads: the trace's under
    ``walk`` (``trace_bytes``), the shade records, the Sobol table, the
    factored Sobol tables (2 x ``sobol_bytes`` x 256 u32; 0 without) and,
    for an image scene, its image table."""
    return (trace_bytes(scene, walk) + scene.shade_rows.numel() * 4 + 5 * 52 * 4
            + 2 * sobol_bytes * 256 * 4 + image_table_bytes(scene))


def peak_source(ops_rate=None) -> str:
    """Which rates a bound used: "fp32_peak" for rates measured by
    tools/fp32_peak.py, "data_sheet" for ``DATA_SHEET_RATES``."""
    return "data_sheet" if ops_rate is None else "fp32_peak"


def _rates(ops_rate) -> dict:
    """Class rates from None (the data sheet's), one number (the fp rate,
    the others at the data sheet's ratio to it) or a class dict."""
    if ops_rate is None:
        return dict(DATA_SHEET_RATES)
    if isinstance(ops_rate, dict):
        return {c: float(ops_rate[c]) for c in CLASSES}
    return {c: float(ops_rate) * DATA_SHEET_RATES[c] / PEAK_FP32_OPS for c in CLASSES}


def ops_seconds(ops, ops_rate=None) -> float:
    """The least time of ``ops`` (a class dict; a number counts as fp):
    every lane-operation through the one dispatch slot at the fp rate, and
    each class on its own pipe at its own rate, whichever is longer."""
    if not isinstance(ops, dict):
        ops = _ops(fp=float(ops))
    rate = _rates(ops_rate)
    return max(total(ops) / rate["fp"], *(ops[c] / rate[c] for c in CLASSES))


def bound_ms(ops, nbytes: float, ops_rate=None):
    """(least time in ms, "operations" or "bytes"): ``ops`` (a class dict,
    or a number of fp lane-operations) at ``ops_rate`` (a class dict of
    lane-operations per second as tools/fp32_peak.py measures them, one fp
    rate, or None for the data sheet's), ``nbytes`` over ``PEAK_BYTES``."""
    t_ops, t_bytes = ops_seconds(ops, ops_rate), nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def render_bound(scene, counts, kernel_work, lane_bytes, has_dof: bool, spp: int, walk=None,
                 ops_rate=None) -> dict:
    """The bound of a render-kernel run (K1, or K2's regenerating mode) at
    ``spp`` whose lanes did ``kernel_work`` bounces in all: the plain
    version's ``counts`` (on a slice) scaled to that bounce count, the
    Sobol respawn in its factored form, at ``ops_rate`` (``bound_ms``);
    bytes are ``lane_bytes`` (what the lanes read and write) and the tables
    the kernel reads, the trace's under ``walk``.  Returns ``bound_ms``,
    ``bound_by``, the operations by class (``bound_ops``), the bytes
    (``bound_bytes``) and ``peak_source``."""
    factor = float(kernel_work) / max(counts.get("bounce", 0), 1)
    n_bytes = sobol_sample_bytes(spp)
    ops = render_ops(scaled(counts, factor), scene, has_dof, sobol=n_bytes)
    nbytes = lane_bytes + render_table_bytes(scene, n_bytes, walk)
    ms, by = bound_ms(ops, nbytes, ops_rate)
    return {"bound_ms": ms, "bound_by": by, "bound_ops": ops, "bound_bytes": nbytes,
            "peak_source": peak_source(ops_rate)}
