"""Group trees: the host-side median-split build, flattened to stackless
skip-link arrays (counterpart of ``geometry/bvh.py``'s group tree; the
numpy build is the JAX package's, so every array comes out identical).

Each leaf holds ``leaf_groups`` groups of 8 primitive slots (padded with
-1).  Nodes are stored in DFS preorder: a hit on an interior node falls
through to node i + 1, a miss (or a finished leaf) jumps to the node's miss
link.  A ray then walks the tree with one node pointer and no stack, which
is how each CUDA thread walks it (``csrc/zwrt_device.cuh:tree_walk``).

The JAX package's binary BVH (``build_bvh``, the ``bvh_*`` fields) serves
only its XLA path and is not carried into the port (ROADMAP.md).
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

from ..math.aabb import aabb_pad_to_minimum

PRIM_SPHERE = 0
PRIM_QUAD = 1

_F = np.float32
_I = np.int32


def pick_leaf_span(n_prims: int) -> int:
    """Groups of 8 primitive slots per leaf for a kind with ``n_prims``
    primitives (the JAX package's choice: 64 up to 512 primitives, so balls'
    485 spheres make one leaf, else 32).  ``ZWRT_LEAF_GROUPS`` overrides it,
    read at each scene compile."""
    env = os.environ.get("ZWRT_LEAF_GROUPS")
    if env:
        return int(env)
    if n_prims <= 512:
        return 64
    return 32


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

    n_nodes = root.size
    node_box = np.zeros((n_nodes, 6), _F)
    node_link = np.zeros((n_nodes, 2), _I)
    slots: List[int] = []
    cursor = [0]

    def emit(node: _Tree, miss: int) -> None:
        i = cursor[0]
        cursor[0] += 1
        node_box[i, 0:3] = node.bmin
        node_box[i, 3:6] = node.bmax
        node_link[i, 0] = miss
        if node.prims is not None:
            node_link[i, 1] = len(slots) // group_size
            slots.extend(int(p) for p in node.prims)
            slots.extend([-1] * (leaf_span - len(node.prims)))
        else:
            node_link[i, 1] = -1
            emit(node.left, miss=i + 1 + node.left.size)
            emit(node.right, miss=miss)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n_nodes + 64))
    try:
        emit(root, miss=n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    return {
        "node_box": node_box,
        "node_link": node_link,
        "prim_slots": np.array(slots, _I),
    }
