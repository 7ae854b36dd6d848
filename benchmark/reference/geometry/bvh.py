"""Group trees: the host-side median-split build, flattened to stackless
skip-link arrays (counterpart of ``geometry/bvh.py``'s group tree; the
numpy build is the JAX package's, so every array comes out identical).

Each leaf holds ``leaf_groups`` groups of 8 primitive slots (padded with
-1).  Nodes are stored in DFS preorder: a hit on an interior node falls
through to node i + 1, a miss (or a finished leaf) jumps to the node's miss
link.  A ray then walks the tree with one node pointer and no stack, which
is how each CUDA thread walks it (``csrc/zwrt_device.cuh:tree_walk``).
``build_group_tree_unified`` builds one such tree over both kinds, with
kind-pure leaves (the ``ZWRT_UNI_TREE`` walk, ``uni_tree_walk``).

The JAX package's binary BVH (``build_bvh``, the ``bvh_*`` fields) serves
only its XLA path and is not carried into the port (ROADMAP.md).
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..math.aabb import aabb_pad_to_minimum

PRIM_SPHERE = 0
PRIM_QUAD = 1

_F = np.float32
_I = np.int32


# The port's leaf span: one group of 8 slots per leaf, so each thread's walk
# tests boxes and sweeps at most 8 primitives per leaf, up to this many
# primitives per kind; past it two groups, which halves the leaf queue's
# device scratch (ops/fused_render.py:queue_capacity) of larger scenes.
SMALL_SPAN_MAX_PRIMS = 4096


def pick_leaf_span(n_prims: int) -> int:
    """Groups of 8 primitive slots per leaf for a kind with ``n_prims``
    primitives: the port's own policy, sized for one CUDA thread's walk
    (the reference takes no override).

    The JAX package takes 64 up to 512 primitives, else 32, swept on a TPU
    v5e for an (8, 128) tile that walks in lockstep: balls' 485 spheres
    make one 512-slot leaf.  On the H100 each thread walks alone, and
    tools/span_sweep.py (NVIDIA H100 80GB HBM3, 700.00 W; Mpaths/s, best of
    three renders after a warmup) found span 1 fastest under both walks on
    both scenes it sweeps, each render equal to the JAX-span render on every
    pixel:

      balls 400x400@128 d10:  span 1 / 2 / 4 / 8 cond 415.43 / 275.58 /
                              193.08 / 195.02, queue 595.54 / 456.46 /
                              326.60 / 245.24; JAX span 64 cond 151.18
      rtw_final 400x400@64 d8 (1,005 spheres, 2,401 quads): cond 317.60 /
                              256.68 / 192.03 / 143.70, queue 329.40 /
                              291.27 / 247.14 / 186.25; JAX span 32 cond
                              77.30

    Scenes past ``SMALL_SPAN_MAX_PRIMS`` (none that the package ships) were
    not swept."""
    if n_prims <= SMALL_SPAN_MAX_PRIMS:
        return 1
    return 2


def _prim_bboxes(sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v):
    """(kinds, idxs, bmins, bmaxs) of every sphere, then every quad; float64
    boxes padded on degenerate axes; a moving sphere's box spans both ends
    of its motion."""
    kinds: List[int] = []
    idxs: List[int] = []
    bmins: List[np.ndarray] = []
    bmaxs: List[np.ndarray] = []
    for i in range(sph_center.shape[0]):
        c = sph_center[i].astype(np.float64)
        r = float(sph_radius[i])
        mv = sph_move[i].astype(np.float64)
        bmin, bmax = aabb_pad_to_minimum(
            np.minimum(c - r, c + mv - r), np.maximum(c + r, c + mv + r)
        )
        kinds.append(PRIM_SPHERE)
        idxs.append(i)
        bmins.append(bmin)
        bmaxs.append(bmax)
    for i in range(quad_start.shape[0]):
        s = quad_start[i].astype(np.float64)
        corners = np.stack(
            [s, s + quad_u[i], s + quad_v[i], s + quad_u[i] + quad_v[i]]
        )
        bmin, bmax = aabb_pad_to_minimum(corners.min(0), corners.max(0))
        kinds.append(PRIM_QUAD)
        idxs.append(i)
        bmins.append(bmin)
        bmaxs.append(bmax)
    return np.array(kinds, _I), np.array(idxs, _I), np.stack(bmins), np.stack(bmaxs)


def _emit_preorder(root, node_box, node_link, leaf):
    """Write ``root``'s nodes in DFS preorder: boxes, miss links, and for
    each node ``leaf(i, node)``, which fills the rest of its link row."""
    cursor = [0]

    def emit(node: "_Tree", miss: int) -> None:
        i = cursor[0]
        cursor[0] += 1
        node_box[i, 0:3] = node.bmin
        node_box[i, 3:6] = node.bmax
        node_link[i, 0] = miss
        leaf(i, node)
        if node.prims is None:
            emit(node.left, miss=i + 1 + node.left.size)
            emit(node.right, miss=miss)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * root.size + 64))
    try:
        emit(root, miss=root.size)
    finally:
        sys.setrecursionlimit(old_limit)


class _Tree:
    __slots__ = ("bmin", "bmax", "left", "right", "prims", "size")

    def __init__(self, bmin, bmax, left=None, right=None, prims=None):
        self.bmin = bmin
        self.bmax = bmax
        self.left = left
        self.right = right
        self.prims = prims  # prim-order indices of a leaf
        self.size = 1 + (left.size if left else 0) + (right.size if right else 0)


def build_group_tree(
    bmins: np.ndarray, bmaxs: np.ndarray, group_size: int = 8,
    leaf_groups: int = 1,
):
    """Preorder skip-link tree over (n, 3) primitive boxes whose leaves each
    own ``leaf_groups`` consecutive groups of ``group_size`` slots.

    Splits are median on the longest axis of the span's union box, after a
    stable sort by box minimum; the median is rounded up to a leaf-span
    multiple, so only the rightmost leaf of the tree can be partial.

    Returns a dict with ``node_box`` (n_nodes, 6) f32 [min xyz, max xyz],
    ``node_link`` (n_nodes, 2) i32 [miss link, first leaf group or -1] and
    ``prim_slots`` (n_groups * group_size,) i32, the primitive of each leaf
    slot or -1."""
    n = int(bmins.shape[0])
    assert n > 0
    leaf_span = group_size * leaf_groups

    def build(span: np.ndarray) -> _Tree:
        bmin = bmins[span].min(0)
        bmax = bmaxs[span].max(0)
        if span.shape[0] <= leaf_span:
            return _Tree(bmin, bmax, prims=list(span))
        axis = int(np.argmax(bmax - bmin))
        span = span[np.argsort(bmins[span, axis], kind="stable")]
        mid = (span.shape[0] // 2 + leaf_span - 1) // leaf_span * leaf_span
        mid = min(mid, span.shape[0] - 1)
        return _Tree(bmin, bmax, left=build(span[:mid]), right=build(span[mid:]))

    root = build(np.arange(n))

    node_box = np.zeros((root.size, 6), _F)
    node_link = np.zeros((root.size, 2), _I)
    slots: List[int] = []

    def leaf(i, node):
        if node.prims is None:
            node_link[i, 1] = -1
            return
        node_link[i, 1] = len(slots) // group_size
        slots.extend(int(p) for p in node.prims)
        slots.extend([-1] * (leaf_span - len(node.prims)))

    _emit_preorder(root, node_box, node_link, leaf)
    return {
        "node_box": node_box,
        "node_link": node_link,
        "prim_slots": np.array(slots, _I),
    }


def build_group_tree_unified(
    bmins: np.ndarray, bmaxs: np.ndarray, kinds: np.ndarray,
    local_idx: np.ndarray, group_size: int = 8, leaf_groups: int = 1,
):
    """One preorder skip-link tree over both primitive kinds, with
    kind-pure leaves: ``build_group_tree``'s median split, where a span
    that fits a leaf but mixes kinds becomes an interior node over two
    kind-pure leaves.  Each leaf owns ``leaf_groups`` consecutive groups of
    its own kind's slot array.

    Returns a dict with ``node_box`` (n_nodes, 6) f32, ``node_link``
    (n_nodes, 3) i32 [miss link, first leaf group or -1, leaf kind
    (PRIM_SPHERE / PRIM_QUAD) or -1], and ``sph_slots`` / ``quad_slots``,
    the kind-local primitive index (``local_idx``) of each slot or -1; a
    kind without leaves gets one leaf of padding slots."""
    n = int(bmins.shape[0])
    assert n > 0
    leaf_span = group_size * leaf_groups

    def build(span: np.ndarray) -> _Tree:
        bmin = bmins[span].min(0)
        bmax = bmaxs[span].max(0)
        k = kinds[span]
        if span.shape[0] <= leaf_span:
            if (k == k[0]).all():
                return _Tree(bmin, bmax, prims=list(span))
            left, right = span[k == k[0]], span[k != k[0]]
            return _Tree(
                bmin, bmax,
                left=_Tree(bmins[left].min(0), bmaxs[left].max(0), prims=list(left)),
                right=_Tree(bmins[right].min(0), bmaxs[right].max(0), prims=list(right)),
            )
        axis = int(np.argmax(bmax - bmin))
        span = span[np.argsort(bmins[span, axis], kind="stable")]
        mid = (span.shape[0] // 2 + leaf_span - 1) // leaf_span * leaf_span
        mid = min(mid, span.shape[0] - 1)
        return _Tree(bmin, bmax, left=build(span[:mid]), right=build(span[mid:]))

    root = build(np.arange(n))
    node_box = np.zeros((root.size, 6), _F)
    node_link = np.zeros((root.size, 3), _I)
    slot_lists = {PRIM_SPHERE: [], PRIM_QUAD: []}

    def leaf(i, node):
        if node.prims is None:
            node_link[i, 1:] = -1
            return
        kind = int(kinds[node.prims[0]])
        slots = slot_lists[kind]
        node_link[i, 1] = len(slots) // group_size
        node_link[i, 2] = kind
        slots.extend(int(local_idx[p]) for p in node.prims)
        slots.extend([-1] * (leaf_span - len(node.prims)))

    _emit_preorder(root, node_box, node_link, leaf)
    pad = [-1] * leaf_span
    return {
        "node_box": node_box,
        "node_link": node_link,
        "sph_slots": np.array(slot_lists[PRIM_SPHERE] or pad, _I),
        "quad_slots": np.array(slot_lists[PRIM_QUAD] or pad, _I),
    }
