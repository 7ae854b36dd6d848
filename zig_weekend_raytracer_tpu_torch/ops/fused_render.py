"""The whole-render kernel (counterpart of
``ops/pallas_bounce.py:render_fused`` and its ``_fused_render_kernel``).

``render_fused`` renders every lane's sample window [s0, s1) of pixel
(px, py) and returns per-lane radiance sums.  For CUDA tensors it launches
``fused_render_kernel`` (``csrc/fused_render.cu`` over the device functions
in ``csrc/zwrt_device.cuh``); for CPU tensors it runs the kernel's plain
PyTorch version, ``render/integrator.py:render_fused_reference``.  Any
other device raises.  ``render_fused.launches`` counts kernel launches,
per tree walk ({walk: launches}).

``kernel_tables`` and ``trace_args`` pack the scene for the kernels' shared
trace (``trace_closest``), which ``ops/closest_hit.py`` launches too;
``image_args`` packs its image table (the texture LUT, or else the atlas)
for the kernels' shared texel fetch.  The kernel takes image scenes that
have a texture LUT (instantiated with the fetch) and scenes without
images (instantiated without it).

Each launch of the render and bounce kernels takes the tree walk of
``ops/trace.py:walk_of`` as it reads then (the unified tree when the scene
has one, else ``ZWRT_TRAV``) and the instantiation compiled for that walk;
``walk_args`` allocates the walk's leaf queue.  The walk is never cached
with the scene, so one process can launch every walk.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from ..dtypes import real
from ..math.v3 import V3
from ..render.integrator import render_fused_reference
from ..sampling import sobol as _sobol
from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..scene import PRIM_QUAD, PRIM_SPHERE, CompiledScene
from ..textures import image_table
from . import _build
from .trace import WALKS, WARP, walk_of

# Must match csrc/zwrt_device.cuh.
MAX_IMAGES = 16
MAX_LIGHTS = 8
LIGHT_FLOATS = 17
THREADS = 128           # threads per block of every launcher
SMEM_LIMIT = 232448     # dynamic shared memory a block can have (227 KB)
_SAMPLER_CODE = {
    SamplerKind.INDEPENDENT: 0, SamplerKind.STRATIFIED: 1, SamplerKind.SOBOL: 2,
}


@functools.lru_cache(maxsize=16)
def sobol_table(device: torch.device, log2_scale: int) -> torch.Tensor:
    """The kernel's Sobol table for one pixel-space scale, uploaded once per
    (device, scale): dims 0 and 1, the van der Corput columns (the first 28,
    zero-padded) and the inverse columns' low and high words, 52 u32 each,
    as int32 bit patterns."""
    d = _sobol._data()
    vdc = np.zeros(52, np.uint32)
    inv_lo = np.zeros(52, np.uint32)
    inv_hi = np.zeros(52, np.uint32)
    if log2_scale > 0:
        delta_cols = _sobol.MAX_SPP_LOG2
        vdc[:delta_cols] = d["vdc_lo"][log2_scale - 1][:delta_cols]
        inv_lo[:] = d["vdc_inv_lo"][log2_scale - 1]
        inv_hi[:] = d["vdc_inv_hi"][log2_scale - 1]
    tab = np.concatenate(
        [d["sobol32"][0], d["sobol32"][1], vdc, inv_lo, inv_hi]
    ).astype(np.uint32)
    return torch.from_numpy(tab.view(np.int32).copy()).to(device)


def kernel_tables(scene: CompiledScene):
    """(sph_tab (S, 8), quad_tab (Q, 16)) float32 on the scene's device:
    spheres as [cx cy cz r^2 mx my mz 0]; quads as [start, normal,
    A = v x w, B = w x u, offset, 0 0 0], the products in the plain
    version's operation order."""
    n_s, n_q = max(scene.n_spheres, 1), max(scene.n_quads, 1)
    c, m, r = scene.sph_center, scene.sph_move, scene.sph_radius
    zs = torch.zeros_like(r)
    sph = torch.stack([c.x, c.y, c.z, r * r, m.x, m.y, m.z, zs], dim=1)[:n_s]
    qu, qv, qw = scene.quad_u, scene.quad_v, scene.quad_w
    s, nrm = scene.quad_start, scene.quad_normal
    zq = torch.zeros_like(scene.quad_offset)
    quad = torch.stack([
        s.x, s.y, s.z, nrm.x, nrm.y, nrm.z,
        qv.y * qw.z - qv.z * qw.y,
        qv.z * qw.x - qv.x * qw.z,
        qv.x * qw.y - qv.y * qw.x,
        qw.y * qu.z - qw.z * qu.y,
        qw.z * qu.x - qw.x * qu.z,
        qw.x * qu.y - qw.y * qu.x,
        scene.quad_offset, zq, zq, zq,
    ], dim=1)[:n_q]
    return sph.contiguous(), quad.contiguous()


# Per-kind trace modes of csrc/zwrt_device.cuh (TraceMode), as
# pallas_bounce._scene_trace_inputs chooses them.
TRACE_NONE, TRACE_BRUTE, TRACE_TREE = 0, 1, 2
_TRACE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _leaf_table(attrs, width):
    """Tree leaf-slot attributes (all but the last, original-index entry)
    as an (n_slots, width) float32 table, zero-padded on the right."""
    cols = list(attrs[:-1])
    cols += [torch.zeros_like(cols[0])] * (width - len(cols))
    return torch.stack(cols, dim=1).contiguous()


def trace_args(scene: CompiledScene):
    """(ints, ptrs, tensors) of the kernels' trace over ``scene``, cached
    per scene: ``ints`` (int32) per kind mode, n_prims, n_nodes, span, then
    has_moving and the unified tree's node count (0 without one) and span;
    ``ptrs`` (uint64) per kind the row table, node boxes, links and
    leaf-slot original indices (0 where the mode reads none), then the
    unified tree's boxes and links and its sphere and quad leaf tables and
    original indices; ``tensors`` keeps the device tables alive."""
    cached = _TRACE_CACHE.get(scene)
    if cached is not None:
        return cached
    sph_tab, quad_tab = kernel_tables(scene)
    ints, ptrs, tensors = [], [], []
    kinds = (
        ("sph", scene.n_spheres, sph_tab, 8),
        ("quad", scene.n_quads, quad_tab, 16),
    )
    for kind, n_prims, brute_tab, width in kinds:
        if getattr(scene, f"has_{kind}_tree"):
            box = getattr(scene, f"{kind}_tree_box").contiguous()
            link = getattr(scene, f"{kind}_tree_link").contiguous()
            attrs = getattr(scene, f"{kind}_tree_attrs")
            tab = _leaf_table(attrs, width)
            oi = attrs[-1].contiguous()
            ints += [TRACE_TREE, n_prims, box.shape[0], getattr(scene, f"{kind}_leaf_span")]
            group = (tab, box, link, oi)
        elif n_prims > 0:
            ints += [TRACE_BRUTE, n_prims, 0, 0]
            group = (brute_tab, None, None, None)
        else:
            ints += [TRACE_NONE, 0, 0, 0]
            group = (None, None, None, None)
        ptrs += [0 if t is None else t.data_ptr() for t in group]
        tensors += [t for t in group if t is not None]
    ints.append(int(bool(scene.has_moving)))
    uni = (None,) * 6
    if scene.has_uni_tree:
        sph, quad = scene.uni_sph_attrs, scene.uni_quad_attrs
        uni = (scene.uni_tree_box.contiguous(), scene.uni_tree_link.contiguous(),
               _leaf_table(sph, 8), sph[-1].contiguous(), _leaf_table(quad, 16),
               quad[-1].contiguous())
    ints += [uni[0].shape[0] if scene.has_uni_tree else 0, scene.uni_leaf_span]
    ptrs += [0 if t is None else t.data_ptr() for t in uni]
    tensors += [t for t in uni if t is not None]
    out = (np.array(ints, np.int32), np.array(ptrs, np.uint64), tuple(tensors))
    _TRACE_CACHE[scene] = out
    return out


def queue_capacity(scene: CompiledScene, walk: str) -> int:
    """Leaf-queue entries of the queue walks, per thread (``queue``) or per
    warp (``rowqueue``): a skip-link tree of n nodes has at most
    (n + 1) // 2 leaves, plus one as in pallas_bounce.py:_queue_cap, over
    the kinds that have trees; 0 for the other walks."""
    if walk not in ("queue", "rowqueue"):
        return 0
    nodes = [getattr(scene, f"{k}_tree_box").shape[0] for k in ("sph", "quad")
             if getattr(scene, f"has_{k}_tree")]
    return max(((n + 1) // 2 + 1 for n in nodes), default=0)


def walk_args(scene: CompiledScene, n: int):
    """(walk, walk code, queue capacity, queue tensor or None) of a launch
    over ``n`` lanes, the walk as ``walk_of`` reads it now.  ``queue`` keeps
    a lane-major int32 queue per thread of the launch; ``rowqueue`` keeps
    one per warp in shared memory.  Raises when the queue does not fit:
    past 2**31 - 1 entries (the kernel indexes it with 32-bit ints), or
    past a block's 227 KB of shared memory."""
    walk = walk_of(scene)
    cap = queue_capacity(scene, walk)
    queue = None
    if walk == "queue" and cap:
        threads = -(-n // THREADS) * THREADS
        if cap * threads > 2**31 - 1:
            raise ValueError(
                f"the queue walk needs {cap} leaf entries for each of {threads} threads, "
                "past the kernel's 32-bit queue index"
            )
        queue = torch.empty((cap * threads,), dtype=torch.int32, device=scene.device)
    if walk == "rowqueue" and THREADS // WARP * cap * 8 > SMEM_LIMIT:
        raise ValueError(
            f"the rowqueue walk needs {THREADS // WARP * cap * 8} bytes of shared memory per "
            f"block ({cap} leaf entries per warp), past the card's {SMEM_LIMIT}"
        )
    return walk, WALKS.index(walk), cap, queue


def image_args(scene: CompiledScene):
    """(ints, texels) of the kernels' image table: ``ints`` (int32) is
    [n_images, then width, height, base, row stride per image] and
    ``texels`` the int32 table on the scene's device.  The texture LUT when
    the scene has one (each image at its own base, stride its width), else
    the atlas (image i at i * ah * aw, stride aw)."""
    dims, texels = image_table(scene)
    if len(dims) > MAX_IMAGES:
        raise NotImplementedError(
            f"the kernels take at most {MAX_IMAGES} images, got {len(dims)}"
        )
    ints = np.array([len(dims), *(v for d in dims for v in d)], np.int32)
    return ints, texels.contiguous()


def launch_params(scene, seed, t_min, camera_consts, sampler, width, height,
                  spp, stride, max_depth, has_dof):
    """Host arrays (int32, float32) in the order the C launcher reads them."""
    n_l = len(scene.light_params)
    if n_l > MAX_LIGHTS:
        raise NotImplementedError(
            f"the fused kernel takes at most {MAX_LIGHTS} lights, got {n_l}"
        )
    strat_sqrt = max(1, int(np.sqrt(spp)))
    kinds = [k for k, _ in scene.light_params] + [0] * (MAX_LIGHTS - n_l)
    ints = np.array(
        [width, height, spp, stride, max_depth, _SAMPLER_CODE[sampler],
         sobol_log2_scale(width, height), strat_sqrt, int(seed) & 0xFFFFFFFF,
         scene.n_spheres, scene.n_quads, scene.shade_rows.shape[0], n_l,
         int(bool(scene.needs_gauss)), int(bool(has_dof)), *kinds],
        dtype=np.int64,
    ).astype(np.uint32).view(np.int32)
    lights = np.zeros((MAX_LIGHTS, LIGHT_FLOATS), np.float32)
    for k, (kind, p) in enumerate(scene.light_params):
        lights[k, : len(p)] = p
        if kind not in (PRIM_SPHERE, PRIM_QUAD):
            raise ValueError(f"unknown light kind {kind}")
    position, pixel00, du, dv, defocus_u, defocus_v = camera_consts
    floats = np.concatenate([
        np.array([t_min, 1.0 / strat_sqrt], np.float32),
        *(np.asarray(v, np.float32)
          for v in (position, pixel00, du, dv, defocus_u, defocus_v)),
        np.asarray(scene.background_rgb, np.float32), lights.reshape(-1),
    ]).astype(np.float32)
    return np.ascontiguousarray(ints), np.ascontiguousarray(floats)


def check_lane_tensor(name, t, device, n, dtype=torch.int32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def render_fused(
    scene: CompiledScene,
    px: torch.Tensor, py: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
    seed: int, t_min: float, *,
    camera_consts, sampler: SamplerKind, width: int, height: int, spp: int,
    stride: int, max_depth: int, has_dof: bool, want_work: bool = False,
):
    """Render each lane's samples s0, s0 + stride, ... below s1 of pixel
    (px, py).  Lane tensors are (N,) int32.  Returns the per-lane radiance
    sums as V3 of (N,) float32, plus the per-lane work count (int32: loop
    passes in which the lane's path was alive) when ``want_work``.  With
    ``has_dof`` camera rays start on the defocus disk of ``camera_consts``.
    An image scene needs a texture LUT: without one it raises, since the
    kernel reads no atlas (``trace_paths_regen`` sends such scenes to
    ``ops/bounce.py:bounce_regen``)."""
    if scene.has_image_textures and not scene.tex_lut_dims:
        raise NotImplementedError(
            "render_fused takes an image-texture scene only with a texture "
            "LUT; trace_paths_regen sends the others to the bounce kernel "
            "(ops/bounce.py)"
        )
    device = px.device
    if device.type == "cpu":
        return render_fused_reference(
            scene, px, py, s0, s1, seed, t_min,
            camera_consts=camera_consts, sampler=sampler, width=width,
            height=height, spp=spp, stride=stride, max_depth=max_depth,
            has_dof=has_dof, want_work=want_work,
        )
    if device.type != "cuda":
        raise ValueError(f"render_fused runs on cuda or cpu tensors, not {device}")
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("s0", s0), ("s1", s1)):
        check_lane_tensor(name, t, device, n)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, lanes on {device}")

    lib = _build.load_library()
    ints, floats = launch_params(
        scene, seed, t_min, camera_consts, sampler, width, height, spp,
        stride, max_depth, has_dof,
    )
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    image_ints = texels = None
    if scene.has_image_textures:
        image_ints, texels = image_args(scene)
    shade_rows = scene.shade_rows.contiguous()
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    walk, code, cap, queue = walk_args(scene, n)
    rad = torch.empty((3, n), dtype=real, device=device)
    work = torch.empty((n,), dtype=torch.int32, device=device) if want_work else None
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.zwrt_fused_render(
        ints.ctypes.data_as(ctypes.c_void_p),
        floats.ctypes.data_as(ctypes.c_void_p),
        trace_ints.ctypes.data_as(ctypes.c_void_p),
        trace_ptrs.ctypes.data_as(ctypes.c_void_p),
        None if image_ints is None else image_ints.ctypes.data_as(ctypes.c_void_p),
        None if texels is None else texels.data_ptr(),
        px.data_ptr(), py.data_ptr(), s0.data_ptr(), s1.data_ptr(),
        shade_rows.data_ptr(), sobol.data_ptr(), rad.data_ptr(),
        work.data_ptr() if want_work else None,
        code, cap, None if queue is None else queue.data_ptr(),
        0 if queue is None else queue.numel(), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_render_kernel ({walk} walk) launch failed: cudaError {err}")
    render_fused.launches[walk] += 1
    radiance = V3(rad[0], rad[1], rad[2])
    if want_work:
        return radiance, work
    return radiance


render_fused.launches = dict.fromkeys(WALKS, 0)
