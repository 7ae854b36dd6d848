"""The whole-render kernel (counterpart of
``ops/pallas_bounce.py:render_fused`` and its ``_fused_render_kernel``).

``render_fused`` renders every lane's sample window [s0, s1) of pixel
(px, py) and returns per-lane radiance sums.  For CUDA tensors it launches
``fused_render_kernel`` (``csrc/fused_render.cu`` over the device functions
in ``csrc/zwrt_device.cuh``); for CPU tensors it runs the kernel's plain
PyTorch version, ``render/integrator.py:render_fused_reference``.  Any
other device raises.  The kernel is persistent: its grid is the blocks
the card holds at once, and its threads take (lane, sample chunk) items
from a work queue, each window cut into chunks of ``item_chunk`` samples;
each lane's sum adds its items' in chunk order, as
``render/integrator.py:render_fused_items_reference`` does at
``launch_chunk``'s chunk, so that a seed renders the same image on every
run.  ``render_fused.launches`` counts kernel launches,
per tree walk ({walk: launches}); ``render_fused.estimator_launches``
those of them that took the estimator instantiation.

``kernel_tables`` and ``trace_args`` pack the scene for the kernels' shared
trace (``trace_closest``), whose stages the closest-hit kernel
(``ops/closest_hit.py``) walks too;
``image_args`` packs its image table (the texture LUT, or else the atlas)
for the kernels' shared texel fetch, ``light_table`` its light list and
``sobol_p_table`` the factored Sobol sampler's byte tables, all device
tables of any length.  The kernel takes image scenes that have a texture
LUT (instantiated with the fetch) and scenes without images (instantiated
without it).

With Russian roulette or the indirect clamp on (``rr_start``, ``clamp``,
gated by ``render/integrator.py:estimator_options``) a launch takes the
kernel's estimator instantiation (``FLAG_ESTIMATOR``), built for every
walk; without them the default one, which compiles as it did before the
options.  The factored Sobol tables cover the sample indices the launch
renders: up to the largest window end ``s1``, which may pass ``spp``
(the adaptive driver's extra samples).

``render_fused_profile`` launches the kernel's phase profile
(``csrc/render_kernels.cuh``, ``FLAG_PROF``): the same work-queue kernel,
grid and items as ``render_fused``, each thread timing its phases over
all of its items.  No path of the renderer launches it, and
``render_fused_profile.launches`` counts it apart.
``render_fused_occupancy`` launches nothing: it reports the blocks per SM
and the shared memory of the instantiation a launch would take.

While ``utils/profiler.py`` records, ``render_fused`` asks every launch
on the card for its blocks' stamps (the launcher's ``out_blocks``: each
block's SM and its start and end on the card's global nanosecond clock)
and each thread's passes, and counts on the card ``k1.lane_work`` and
``k1.warp_work`` (``lane_sums`` over the threads of the grid, whose warps
are the physical ones: a lane of the plan no longer belongs to one warp),
``k1.block_ns`` and ``k1.slot_ns`` (``block_sums``), and on the host
``k1.items`` and ``k1.pulls`` (``queue_counts``: the items of the launch
and those taken after a thread's first); on the CPU ``k1.lane_work`` and
``k1.warp_work`` over the plain version's lanes.  Nothing waits for the
card until the profiler's ``snapshot`` reads them.  Recording changes no
output.

Each launch of the render and bounce kernels takes the tree walk of
``ops/trace.py:walk_of`` as it reads then (the unified tree when the scene
has one, else ``ZWRT_TRAV``) and the instantiation compiled for that walk;
``walk_args`` sizes the walk's leaf queue (in the block's shared memory
for queue and rowqueue, in device memory for spec and uni) and
``node_args`` gives every walk but cond its
packed node tables (rowqueue stages the first ``ROWQUEUE_NODE_BYTES`` of
them in each block's shared memory).  The walk is never cached with the
scene, so one process can launch every walk.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dtypes import real
from ..math.v3 import V3
from ..render.integrator import estimator_options, render_fused_reference
from ..sampling import sobol as _sobol
from ..sampling.sampler import SamplerKind, sobol_log2_scale
from ..scene import PRIM_QUAD, PRIM_SPHERE, CompiledScene
from ..textures import image_table
from ..utils import profiler
from . import _build
from .trace import QUEUE_CAP, WALKS, WARP, walk_of

# Must match csrc/zwrt_device.cuh and csrc/render_kernels.cuh.
LIGHT_FLOATS = 17
BLOCK_STAMP_COLS = 3    # a block's SM, start ns, end ns (render_kernels.cuh:kBlockStampCols)
IMAGE_DIMS = 4          # w, h, base, row stride per image
PROF_PHASES = ("respawn", "trace", "shade")
PROF_COLS = 3 * len(PROF_PHASES) + 1  # cycles, entries, active lanes; total
FLAG_PROF, FLAG_ESTIMATOR = 1, 2      # zwrt_device.cuh:DrainFlags
PROFILE_WALKS = ("cond", "queue")     # the walks the phase profile is built for
THREADS = 128           # threads per block of every launcher (zwrt_device.cuh:kThreads)
SMEM_LIMIT = 232448     # dynamic shared memory a block can have (227 KB)
# shared memory of a block that the queue walk's leaf queues take: QUEUE_CAP
# int32 entries for each thread (zwrt_device.cuh:bounded_queue)
QUEUE_SMEM_BYTES = QUEUE_CAP * THREADS * 4
NODE_BYTES = 32         # a packed node (zwrt_device.cuh:PackedNode)
# blocks of a render or bounce kernel that share an SM at most
# (render_kernels.cuh:kMaxBlocksPerSM, which says why)
MAX_BLOCKS_PER_SM = 8
# shared memory of a block that the rowqueue walk fills with packed nodes
# (zwrt_device.cuh:kRowQueueNodeBytes, which says how it was sized)
ROWQUEUE_NODE_BYTES = 14336
# items of the render kernel's work queue that item_chunk aims at for each
# thread the card holds (picked on an H100 from 4, 8, 16, 24 and 32: PERF.md)
ITEMS_PER_THREAD = 16
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


@functools.lru_cache(maxsize=16)
def sobol_p_table(device: torch.device, log2_scale: int, n_bytes: int) -> torch.Tensor:
    """The factored sampler's byte tables (``sampling/sobol.py:
    sobol_p_tables``), (2 * n_bytes * 256,) int32 bit patterns, uploaded once
    per (device, scale, bytes); the kernels stage them in shared memory."""
    tab = _sobol.sobol_p_tables(log2_scale, n_bytes).reshape(-1)
    tab = torch.where(tab >= 2**31, tab - 2**32, tab).to(torch.int32)
    return tab.to(device)


_LIGHT_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def light_table(scene: CompiledScene):
    """(kinds (L,) int32, rows (L, 17) float32) of the scene's light list on
    its device, cached per scene: each light's kind and its parameters,
    zero-padded on the right (``light_pdf`` and ``light_sample`` read
    them); any number of lights."""
    cached = _LIGHT_CACHE.get(scene)
    if cached is not None:
        return cached
    n_l = len(scene.light_params)
    rows = np.zeros((max(n_l, 1), LIGHT_FLOATS), np.float32)
    kinds = np.zeros((max(n_l, 1),), np.int32)
    for k, (kind, p) in enumerate(scene.light_params):
        if kind not in (PRIM_SPHERE, PRIM_QUAD):
            raise ValueError(f"unknown light kind {kind}")
        kinds[k] = kind
        rows[k, : len(p)] = p
    out = (torch.from_numpy(kinds).to(scene.device), torch.from_numpy(rows).to(scene.device))
    _LIGHT_CACHE[scene] = out
    return out


def launch_tables(scene: CompiledScene, sampler: SamplerKind, width: int, height: int,
                  sample_end: int):
    """(ptrs, tensors): the host array of device pointers the launchers
    read beside ``launch_params`` (light kinds, light rows, the factored
    Sobol tables for sample indices below ``sample_end``, or 0 for another
    sampler) and the tensors behind them."""
    kinds, rows = light_table(scene)
    tensors = [kinds, rows]
    if sampler == SamplerKind.SOBOL:
        tensors.append(sobol_p_table(scene.device, sobol_log2_scale(width, height),
                                     _sobol.sobol_sample_bytes(sample_end)))
    ptrs = np.array([t.data_ptr() for t in tensors] + [0] * (3 - len(tensors)), np.uint64)
    return ptrs, tuple(tensors)


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
    """Leaf-queue entries that hold every leaf a walk may queue, per thread
    (``spec``, ``uni``) or per warp (``rowqueue``): a skip-link tree of n
    nodes has at most (n + 1) // 2 leaves, plus one as in
    pallas_bounce.py:_queue_cap, over the kinds that have trees, or of the
    unified tree under ``uni``; 0 for ``cond`` and ``queue`` (which holds
    ``QUEUE_CAP`` instead, ``walk_args``)."""
    if walk == "uni":
        return (scene.uni_tree_box.shape[0] + 1) // 2 + 1
    if walk not in ("rowqueue", "spec"):
        return 0
    nodes = [getattr(scene, f"{k}_tree_box").shape[0] for k in ("sph", "quad")
             if getattr(scene, f"has_{k}_tree")]
    return max(((n + 1) // 2 + 1 for n in nodes), default=0)


def pack_nodes(box: torch.Tensor, link: torch.Tensor) -> torch.Tensor:
    """A tree's nodes as the spec and uni walks read them
    (``zwrt_device.cuh:PackedNode``): (n, 8) float32, 32 bytes a node, [min
    x y z, miss link] and [max x y z, leaf word], the two ints stored as
    their bits.  The leaf word is the first leaf group times 2 plus the
    leaf's kind (``link`` column 2 of the unified tree; 0 in a per-kind
    tree, whose ``link`` has two columns), or -1 for an interior node."""
    bits = box.contiguous().view(torch.int32)
    leaf = link[:, 1]
    kind = link[:, 2] if link.shape[1] > 2 else torch.zeros_like(leaf)
    word = torch.where(leaf >= 0, leaf * 2 + kind, -1)
    packed = torch.cat([bits[:, :3], link[:, :1], bits[:, 3:], word[:, None]], dim=1)
    return packed.to(torch.int32).contiguous().view(torch.float32)


_NODE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def node_args(scene: CompiledScene, walk: str):
    """(ptrs, tensors) of the packed node tables a launch of ``walk`` reads:
    ``ptrs`` (uint64) the sphere tree's, the quad tree's and the unified
    tree's (``pack_nodes``; 0 where the scene has no such tree); None and
    () for cond, which reads none.  Built the first time a launch takes
    another walk (the default queue walk's first launch) and cached per
    scene beside ``trace_args``."""
    if walk == "cond":
        return None, ()
    cached = _NODE_CACHE.get(scene)
    if cached is None:
        tabs = [pack_nodes(getattr(scene, f"{k}_tree_box"), getattr(scene, f"{k}_tree_link"))
                if getattr(scene, f"has_{k}_tree") else None for k in ("sph", "quad", "uni")]
        ptrs = np.array([0 if t is None else t.data_ptr() for t in tabs], np.uint64)
        cached = (ptrs, tuple(t for t in tabs if t is not None))
        _NODE_CACHE[scene] = cached
    return cached


def rowqueue_staged_nodes(scene: CompiledScene) -> dict:
    """{tree: nodes} that a block of a rowqueue launch stages in shared
    memory (zwrt_device.cuh:set_walk): the first nodes in preorder of the
    sphere tree, then of the quad tree, as many as ``ROWQUEUE_NODE_BYTES``
    holds."""
    room = ROWQUEUE_NODE_BYTES // NODE_BYTES
    out = {}
    for k in ("sph", "quad"):
        if getattr(scene, f"has_{k}_tree"):
            out[k] = min(getattr(scene, f"{k}_tree_box").shape[0], room)
            room -= out[k]
    return out


def walk_args(scene: CompiledScene, n: int, smem_before: int = 0):
    """(walk, walk code, queue capacity, queue tensor or None) of a launch
    over ``n`` lanes, the walk as ``walk_of`` reads it now.  ``queue``
    keeps ``QUEUE_CAP`` entries per thread in shared memory after
    ``smem_before`` bytes of staged tables, where the scene has a tree, and
    no device queue; ``rowqueue`` one queue per warp in shared memory, after
    those tables and its staged nodes (``rowqueue_staged_nodes``); ``spec``
    and ``uni`` a lane-major int32 queue per thread of the launch in device
    memory.  Raises when the queue does not fit: past 2**31 - 1 entries (the
    kernel indexes it with 32-bit ints), or past a block's 227 KB of shared
    memory."""
    walk = walk_of(scene)
    bounded = walk == "queue"
    cap = QUEUE_CAP if bounded else queue_capacity(scene, walk)
    queue = None
    trees = scene.has_sph_tree or scene.has_quad_tree
    if bounded and trees and smem_before + QUEUE_SMEM_BYTES > SMEM_LIMIT:
        raise ValueError(
            f"the queue walk needs {QUEUE_SMEM_BYTES} bytes of shared memory per block "
            f"({QUEUE_CAP} leaf entries per thread) after {smem_before} bytes of tables, "
            f"past the card's {SMEM_LIMIT}"
        )
    if walk in ("spec", "uni") and cap:
        threads = -(-n // THREADS) * THREADS
        if cap * threads > 2**31 - 1:
            raise ValueError(
                f"the {walk} walk needs {cap} leaf entries for each of {threads} threads, "
                "past the kernel's 32-bit queue index"
            )
        queue = torch.empty((cap * threads,), dtype=torch.int32, device=scene.device)
    if walk == "rowqueue":
        nodes = sum(rowqueue_staged_nodes(scene).values()) * NODE_BYTES
        if smem_before + nodes + THREADS // WARP * cap * 8 > SMEM_LIMIT:
            raise ValueError(
                f"the rowqueue walk needs {THREADS // WARP * cap * 8} bytes of shared memory "
                f"per block ({cap} leaf entries per warp) after {smem_before} bytes of tables "
                f"and {nodes} of staged nodes, past the card's {SMEM_LIMIT}"
            )
    return walk, WALKS.index(walk), cap, queue


_IMAGE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def image_args(scene: CompiledScene):
    """(dims, texels) of the kernels' image table on the scene's device,
    cached per scene: ``dims`` (n_images, 4) int32 holds each image's
    width, height, base and row stride, ``texels`` the int32 table.  The
    texture LUT when the scene has one (each image at its own base, stride
    its width), else the atlas (image i at i * ah * aw, stride aw).  Any
    number of images."""
    cached = _IMAGE_CACHE.get(scene)
    if cached is not None:
        return cached
    dims, texels = image_table(scene)
    table = torch.tensor(np.array(dims, np.int32).reshape(-1, IMAGE_DIMS), dtype=torch.int32)
    out = (table.to(texels.device).contiguous(), texels.contiguous())
    _IMAGE_CACHE[scene] = out
    return out


def launch_params(scene, seed, t_min, camera_consts, sampler, width, height,
                  spp, stride, max_depth, has_dof, sample_end=None, rr_start=0, clamp=0.0):
    """Host arrays (int32, float32) in the order the C launcher reads them
    (zwrt_device.cuh:read_params); the light list and the Sobol tables go
    as device tables (``launch_tables``).  The Sobol tables cover sample
    indices below ``sample_end`` (default ``spp``); ``rr_start`` and
    ``clamp`` are the estimator options as the launch applies them."""
    strat_sqrt = max(1, int(np.sqrt(spp)))
    ints = np.array(
        [width, height, spp, stride, max_depth, _SAMPLER_CODE[sampler],
         sobol_log2_scale(width, height), strat_sqrt, int(seed) & 0xFFFFFFFF,
         scene.n_spheres, scene.n_quads, scene.shade_rows.shape[0],
         len(scene.light_params), int(bool(scene.needs_gauss)), int(bool(has_dof)),
         _sobol.sobol_sample_bytes(spp if sample_end is None else sample_end),
         int(rr_start)],
        dtype=np.int64,
    ).astype(np.uint32).view(np.int32)
    position, pixel00, du, dv, defocus_u, defocus_v = camera_consts
    floats = np.concatenate([
        np.array([t_min, 1.0 / strat_sqrt], np.float32),
        *(np.asarray(v, np.float32)
          for v in (position, pixel00, du, dv, defocus_u, defocus_v)),
        np.asarray(scene.background_rgb, np.float32),
        np.array([clamp], np.float32),
    ]).astype(np.float32)
    return np.ascontiguousarray(ints), np.ascontiguousarray(floats)


def sobol_smem_bytes(sampler: SamplerKind, sample_end: int) -> int:
    """Shared memory per block of the staged Sobol tables for sample
    indices below ``sample_end``."""
    if sampler != SamplerKind.SOBOL:
        return 0
    return 2 * _sobol.sobol_sample_bytes(sample_end) * 256 * 4


def launch_windows(s0: torch.Tensor, s1: torch.Tensor, stride: int):
    """(the end of the sample indices a launch renders: the largest window
    end ``s1`` over its lanes, at least 1, since a lane renders indices
    below its window end only; the longest window: the most samples a lane
    renders, ceil((s1 - s0) / stride) at its largest, 0 without lanes), in
    one read of the card."""
    if not s1.numel():
        return 1, 0
    end, span = torch.stack([s1.max(), (s1 - s0).max()]).tolist()
    return max(1, end), max(0, -(-span // stride))


def item_chunk(lanes: int, longest: int, threads: int) -> int:
    """Samples an item of the render kernel's work queue takes at most
    (``zwrt_device.cuh:Items``): ``lanes`` windows of up to ``longest``
    samples cut into as many chunks as make ``ITEMS_PER_THREAD`` items for
    each of the ``threads`` the card holds at once, so that threads that
    finish early take more items while the others drain; the whole window
    where the lanes alone are that many.  At least 1.  A launch counts the
    render's own lanes, width x height x stride (``launch_lanes``)."""
    if longest < 2 or lanes >= ITEMS_PER_THREAD * threads:
        return max(1, longest)
    chunks = min(longest, -(-ITEMS_PER_THREAD * threads // max(lanes, 1)))
    return -(-longest // chunks)


def launch_lanes(width: int, height: int, stride: int) -> int:
    """The lanes that ``item_chunk`` sizes a launch's items by: the
    render's, one a pixel and sample in flight, whatever plan the launch
    carries (the tiled first pass with its padding, the sorted or coherent
    plan, a band, a shard).  So every plan of one render cuts a pixel's
    samples at the same chunks, and its float32 sums, added in chunk
    order, do not depend on the plan: a seed's image is bitwise the same
    on the first pass and on the sorted plan that follows it."""
    return width * height * stride


def queue_counts(chunks: int, n: int, threads: int):
    """(items, pulls) of a launch of the work queue: ``chunks`` items for
    each of ``n`` lanes, and those of them that a thread of the grid's
    ``threads`` takes after its first (each thread starts on one item, and
    every later item is taken once)."""
    items = chunks * n
    return items, max(0, items - threads)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_flags(walk: str, flags: int) -> None:
    """Raises for flags that no instantiation has: the phase profile exists
    for the walks of ``PROFILE_WALKS``, without the estimator options; the
    estimator instantiation exists for every walk."""
    if not flags & FLAG_PROF:
        return
    if flags & FLAG_ESTIMATOR:
        raise ValueError("the phase profile has no Russian roulette or indirect clamp: "
                         "launch it with rr_start = 0 and clamp = 0")
    if walk not in PROFILE_WALKS:
        raise ValueError(f"no phase profile for the {walk} walk; one of {PROFILE_WALKS}")


def estimator_flags(scene: CompiledScene, rr_start, clamp):
    """(flags, rr_start, clamp) of a launch: FLAG_ESTIMATOR when either
    option is on after the gate (``estimator_options``), else 0."""
    rr_start, clamp = estimator_options(scene, rr_start, clamp)
    return (FLAG_ESTIMATOR if rr_start or clamp else 0), rr_start, clamp


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
    rr_start: int = 0, clamp: float = 0.0,
):
    """Render each lane's samples s0, s0 + stride, ... below s1 of pixel
    (px, py).  Lane tensors are (N,) int32.  Returns the per-lane radiance
    sums as V3 of (N,) float32, plus the per-lane work count (int32: loop
    passes in which the lane's path was alive) when ``want_work``.  With
    ``has_dof`` camera rays start on the defocus disk of ``camera_consts``;
    ``rr_start`` and ``clamp`` are Russian roulette's first bounce and the
    indirect clamp (0: off).  An image scene needs a texture LUT: without
    one it raises, since the kernel reads no atlas (``trace_paths_regen``
    sends such scenes to ``ops/bounce.py:bounce_regen``)."""
    kw = dict(camera_consts=camera_consts, sampler=sampler, width=width, height=height,
              spp=spp, stride=stride, max_depth=max_depth, has_dof=has_dof,
              rr_start=rr_start, clamp=clamp)
    record = profiler.recording()
    if px.device.type == "cpu":
        _check_supported(scene)
        rad, work = render_fused_reference(scene, px, py, s0, s1, seed, t_min,
                                           want_work=True, **kw)
    else:
        flags, kw["rr_start"], kw["clamp"] = estimator_flags(scene, rr_start, clamp)
        out = _launch(scene, px, py, s0, s1, seed, t_min, flags, want_work, record=record, **kw)
        rad, work, q = out.rad, out.work, out.queue
        render_fused.launches[out.walk] += 1
        render_fused.estimator_launches += bool(flags)
        if record and q is not None:
            block_ns, slot_ns = block_sums(q.stamps, q.slots)
            profiler.count("k1.block_ns", block_ns)
            profiler.count("k1.slot_ns", slot_ns)
            lane_work, warp_work = lane_sums(q.thread_work)
            profiler.count("k1.lane_work", lane_work)
            profiler.count("k1.warp_work", warp_work)
            items, pulls = queue_counts(q.chunks, px.shape[0], q.grid * THREADS)
            profiler.count("k1.items", items)
            profiler.count("k1.pulls", pulls)
        return (rad, work) if want_work else rad
    if record and work.numel():
        lane_work, warp_work = lane_sums(work)
        profiler.count("k1.lane_work", lane_work)
        profiler.count("k1.warp_work", warp_work)
    if want_work:
        return rad, work
    return rad


render_fused.launches = dict.fromkeys(WALKS, 0)
render_fused.estimator_launches = 0


def lane_sums(work: torch.Tensor):
    """(sum of the lanes' work counts, sum over warps of WARP times the
    warp's largest count) as int64 scalars on ``work``'s device: lanes i
    and j share a warp when i // WARP == j // WARP, the last warp padded
    with idle lanes.  Their ratio is the share of the warps' lane passes
    that did work."""
    w = torch.nn.functional.pad(work.to(torch.int64), (0, -work.numel() % WARP))
    return w.sum(), w.view(-1, WARP).amax(dim=1).sum() * WARP


def block_sums(stamps: torch.Tensor, slots: int):
    """(sum of the blocks' times, ``slots`` times the launch's time from
    its first block's start to its last block's end) in ns, as int64
    scalars on ``stamps``' device; ``stamps`` holds a row of
    ``BLOCK_STAMP_COLS`` per block (SM, start, end) and ``slots`` the
    blocks that the card holds at once.  Their ratio is the share of the
    card's block slots that the launch filled."""
    start, end = stamps[:, 1], stamps[:, 2]
    return (end - start).sum(), (end.max() - start.min()) * slots


def render_fused_profile(scene: CompiledScene, px, py, s0, s1, seed: int, t_min: float, **kw):
    """``render_fused`` with its work counts through the kernel's phase
    profile, for the walks of ``PROFILE_WALKS``: the same work-queue
    kernel, grid and items, so the same sums bit for bit.  Returns
    ((radiance, work), profile): (PROF_COLS, grid * THREADS) int64, one
    column a thread of the launch's grid summed over all of its items, per
    phase of ``PROF_PHASES`` the clock64 cycles, the entries and the
    converged lanes at entry, then the thread's whole cycles.  CPU tensors
    take the plain version and return no profile.
    ``render_fused_profile.launches`` counts launches per walk."""
    if px.device.type == "cpu":
        return render_fused(scene, px, py, s0, s1, seed, t_min, want_work=True, **kw), None
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    out = _launch(scene, px, py, s0, s1, seed, t_min, FLAG_PROF | est, True, **kw)
    render_fused_profile.launches[out.walk] += 1
    return (out.rad, out.work), out.prof


render_fused_profile.launches = dict.fromkeys(PROFILE_WALKS, 0)


def render_fused_occupancy(scene: CompiledScene, px, py, s0, s1, seed: int, t_min: float, **kw):
    """(blocks per SM, dynamic shared memory bytes a block) of the
    instantiation that ``render_fused`` on these CUDA lanes would launch
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the launcher has
    raised the shared memory of an instantiation that more than
    ``MAX_BLOCKS_PER_SM`` blocks would fit); launches nothing and counts
    nothing."""
    est, kw["rr_start"], kw["clamp"] = estimator_flags(
        scene, kw.get("rr_start", 0), kw.get("clamp", 0.0))
    occ = np.zeros(2, np.int32)
    _launch(scene, px, py, s0, s1, seed, t_min, est, False, occupancy=occ, **kw)
    return int(occ[0]), int(occ[1])


def launch_chunk(scene: CompiledScene, px, py, s0, s1, seed: int, t_min: float, **kw) -> int:
    """The samples an item takes (``item_chunk``) in the work queue that
    ``render_fused`` would launch over these CUDA lanes: what
    ``integrator.render_fused_items_reference`` needs to sum as the kernel
    does."""
    blocks, _ = render_fused_occupancy(scene, px, py, s0, s1, seed, t_min, **kw)
    _, longest = launch_windows(s0, s1, kw["stride"])
    return item_chunk(launch_lanes(kw["width"], kw["height"], kw["stride"]), longest,
                      blocks * sm_count(px.device) * THREADS)


def _check_supported(scene):
    if scene.has_nested_checker:
        raise NotImplementedError(
            "render_fused does not take nested checkers: the renderer sends them "
            "to the fixed-depth wavefront (render/integrator.py:trace_paths)"
        )
    if scene.has_image_textures and not scene.tex_lut_dims:
        raise NotImplementedError(
            "render_fused takes an image-texture scene only with a texture "
            "LUT; trace_paths_regen sends the others to the bounce kernel "
            "(ops/bounce.py)"
        )


class QueueRun(NamedTuple):
    """A launch's work queue: ``grid`` blocks of the ``slots`` the card
    holds at once, items of at most ``chunk`` samples, ``chunks`` a lane;
    while recording the blocks' stamps ((grid, BLOCK_STAMP_COLS) int64) and
    each thread's passes ((grid * THREADS,) int32), else None."""
    grid: int
    slots: int
    chunk: int
    chunks: int
    stamps: Optional[torch.Tensor]
    thread_work: Optional[torch.Tensor]


class Launch(NamedTuple):
    rad: V3
    work: Optional[torch.Tensor]
    prof: Optional[torch.Tensor]
    walk: str
    queue: Optional[QueueRun]


# the block slots of the card for each instantiation a scene's launches
# fed from the work queue take, {(kernel, device, walk, flags, shared
# memory): slots}
_RESIDENT_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def queue_plan(scene: CompiledScene, device, key: tuple, ask, n: int, width: int, height: int,
               stride: int, longest: int):
    """(grid, slots, chunk, chunks) of a launch fed from the work queue
    over ``n`` lanes on ``device`` whose longest window is ``longest``
    samples: ``slots`` the blocks the card holds at once of the
    instantiation that ``key`` names (``ask(occ)`` writes its blocks per SM into the host int32 array
    ``occ``; asked once per scene and key), ``item_chunk``'s chunk from
    the render's lanes (``launch_lanes``) and those blocks' threads, the
    chunks the longest window takes, and a grid of those slots, or fewer
    where the items are fewer.  Raises past the kernels' 32-bit item
    index."""
    per_scene = _RESIDENT_CACHE.setdefault(scene, {})
    slots = per_scene.get(key)
    if slots is None:
        occ = np.zeros(2, np.int32)
        ask(occ)
        slots = per_scene[key] = int(occ[0]) * sm_count(device)
    chunk = item_chunk(launch_lanes(width, height, stride), longest, slots * THREADS)
    chunks = max(1, -(-longest // chunk))
    if chunks * n > 2**31 - 1:
        raise ValueError(f"{chunks} chunks of {n} lanes pass the kernel's 32-bit item index")
    return min(slots, -(-chunks * n // THREADS)), slots, chunk, chunks


def queue_buffers(grid: int, chunks: int, n: int, device, want_work: bool, record: bool):
    """(next, part_rad, part_work, stamps, thread_work) of a launch fed from
    the work queue (``csrc/render_kernels.cuh:QueueLaunch``): the queue's
    counter; with more than one chunk the items' radiance sums (chunks, 3,
    n) and, ``want_work``, their passes (chunks, n), which
    ``item_sum_kernel`` adds up; with ``record`` the blocks' stamps (grid,
    ``BLOCK_STAMP_COLS``) and each thread's passes (grid * THREADS), zeroed;
    None where not asked.  All from torch's caching allocator."""
    nxt = torch.empty((1,), dtype=torch.int32, device=device)
    part_rad = part_work = stamps = thread_work = None
    if chunks > 1:
        part_rad = torch.empty((chunks, 3, n), dtype=real, device=device)
        if want_work:
            part_work = torch.empty((chunks, n), dtype=torch.int32, device=device)
    if record:
        stamps = torch.zeros((grid, BLOCK_STAMP_COLS), dtype=torch.int64, device=device)
        thread_work = torch.zeros((grid * THREADS,), dtype=torch.int32, device=device)
    return nxt, part_rad, part_work, stamps, thread_work


def _launch(scene, px, py, s0, s1, seed, t_min, flags, want_work, *, camera_consts,
            sampler, width, height, spp, stride, max_depth, has_dof, rr_start=0, clamp=0.0,
            occupancy=None, record=False):
    """One launch of the render kernel's instantiation for ``flags``
    (a Launch), fed from the work queue: the grid is the blocks the card
    holds at once of the instantiation without the profile (asked once per
    scene and instantiation; the profile's is held to the same blocks a SM
    and runs the same grid and items), or fewer where the items are fewer,
    and ``item_chunk`` sizes the items from the render's lanes
    (``launch_lanes``), the longest window and those blocks' threads; with
    ``record`` the launch stamps its blocks and counts each thread's
    passes.  With ``occupancy`` (a host int32 array of 2) nothing is
    launched: the launcher writes the instantiation's blocks per SM and
    shared memory there."""
    _check_supported(scene)
    device = px.device
    if device.type != "cuda":
        raise ValueError(f"render_fused runs on cuda or cpu tensors, not {device}")
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("s0", s0), ("s1", s1)):
        check_lane_tensor(name, t, device, n)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, lanes on {device}")

    lib = _build.load_library()
    sample_end, longest = launch_windows(s0, s1, stride)
    ints, floats = launch_params(
        scene, seed, t_min, camera_consts, sampler, width, height, spp,
        stride, max_depth, has_dof, sample_end, rr_start, clamp,
    )
    tables, _keep = launch_tables(scene, sampler, width, height, sample_end)
    trace_ints, trace_ptrs, _tables = trace_args(scene)
    dims = texels = None
    if scene.has_image_textures:
        dims, texels = image_args(scene)
    shade_rows = scene.shade_rows.contiguous()
    sobol = sobol_table(device, sobol_log2_scale(width, height))
    smem = sobol_smem_bytes(sampler, sample_end)
    ptr = lambda t: None if t is None else t.data_ptr()
    host = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    def call(grid, outs, queue_args=(1, 1, None, None, None, None), occ=None, flags=flags):
        walk, code, cap, queue = walk_args(scene, grid * THREADS, smem)
        check_flags(walk, flags)
        nodes, _nodes = node_args(scene, walk)
        rad, work, prof, stamps = outs
        chunk, chunks, nxt, part_rad, part_work, thread_work = queue_args
        err = lib.zwrt_fused_render(
            host(ints), host(floats), host(tables), host(trace_ints), host(trace_ptrs),
            host(nodes), 0 if dims is None else dims.shape[0], ptr(dims), ptr(texels),
            px.data_ptr(), py.data_ptr(), s0.data_ptr(), s1.data_ptr(),
            shade_rows.data_ptr(), sobol.data_ptr(), ptr(rad), ptr(work), ptr(prof),
            ptr(stamps), code, flags, cap, ptr(queue), 0 if queue is None else queue.numel(),
            n, grid, chunk, chunks, ptr(nxt), ptr(part_rad), ptr(part_work), ptr(thread_work),
            host(occ), torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_render_kernel ({walk} walk, flags {flags}) launch failed: "
                               f"cudaError {err}")
        return walk

    lane_blocks = -(-n // THREADS)
    if occupancy is not None:
        call(max(lane_blocks, 1), (None,) * 4, occ=occupancy)
        return None
    rad = torch.empty((3, n), dtype=real, device=device)
    work = torch.empty((n,), dtype=torch.int32, device=device) if want_work else None
    if n == 0:
        return Launch(V3(rad[0], rad[1], rad[2]), work, None,
                      call(lane_blocks, (rad, work, None, None)), None)

    key = ("fused_render", device, walk_of(scene), flags & ~FLAG_PROF, smem)
    grid, slots, chunk, chunks = queue_plan(
        scene, device, key, lambda occ: call(lane_blocks, (None,) * 4, occ=occ, flags=flags & ~FLAG_PROF),
        n, width, height, stride, longest)
    nxt, part_rad, part_work, stamps, thread_work = queue_buffers(
        grid, chunks, n, device, work is not None, record)
    prof = (torch.empty((PROF_COLS, grid * THREADS), dtype=torch.int64, device=device)
            if flags & FLAG_PROF else None)
    walk = call(grid, (rad, work, prof, stamps),
                (chunk, chunks, nxt, part_rad, part_work, thread_work))
    return Launch(V3(rad[0], rad[1], rad[2]), work, prof, walk,
                  QueueRun(grid, slots, chunk, chunks, stamps, thread_work))
