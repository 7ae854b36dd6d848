"""Closest-hit tracing over the compiled scene tables (counterpart of
``ops/trace.py``): the plain versions of the closest-hit kernel.

``closest_hit`` computes what the JAX package's ``closest_hit_pallas``
computes (``ops/pallas_trace.py:_trace_call``): a sphere stage, brute or
group tree, then a quad stage seeded with the sphere result.  It is the
plain PyTorch version of ``closest_hit_kernel`` (``ops/closest_hit.py``)
and the trace of the fused render kernel's plain version.  Tie rules:

  * a brute stage keeps the smallest index of equal ``t``;
  * a leaf sweep takes, in each of its 8 slot columns (sublanes), the first
    slot reaching the column's best ``t``, then the smallest original index
    among the columns at the leaf's best ``t``;
  * across leaves and stages only a strictly smaller ``t`` replaces the
    running best, so the first leaf visited keeps a tie and a quad never
    displaces a sphere at the same distance.

The running best starts at ``min(t_max, BIG)`` (finite, so the slab
test's far clip stays finite) and a ray that found nothing reports +inf
and kind -1.  On a scene without trees both stages are brute, which is the
JAX package's ``_closest_hit_brute``.

A tree stage walks the skip links in one of the JAX package's traversal
variants (``pallas_bounce.py:_trace_values``), each the plain version of
one walk of the kernels' shared trace (``csrc/zwrt_device.cuh``):

  * ``cond`` (the default): each lane follows its own node pointer and
    sweeps a hit leaf at once, so its running t culls the rest of the walk;
  * ``queue``: each lane culls with its running t and queues the leaves
    it hits in preorder, at most ``QUEUE_CAP`` of them; when its queue is
    full or its walk has ended it sweeps them in order, and the rest of
    its walk culls with the t the sweep tightened.  At a capacity of the
    tree's leaves or more (``closest_hit``'s ``queue_cap``) no queue fills
    before its walk's end, so the whole walk culls with the stage's seed t,
    as the spec walk's does;
  * ``rowqueue``: lanes in groups of 32 consecutive indices walk one node
    pointer with the seed t, descending when any walking lane of the group
    hits; a hit leaf is queued with the group's mask of lanes that hit it
    (a warp of the kernel); then, for each entry in preorder, each marked
    lane tests the leaf's box again against its running t (one more
    ``slab_test``) and sweeps the leaf only where that test passes, so it
    sweeps the ``cond`` walk's leaves;
  * ``spec``: the ``queue`` walk that slab-tests, at each node, both of
    its successors with the seed t (the box of each step's node is tested
    at its parent), then sweeps its queue with the fresh t;
  * ``uni``: one ``queue`` walk over the unified tree, whose kind-pure
    leaves are then swept by their kind: every sphere leaf in preorder,
    then every quad leaf in preorder, as the kernel's two-ended queue
    holds them.  A sphere keeps a tie with a quad, as in the per-kind
    stages; two leaves of one kind at exactly equal t resolve by the
    unified tree's preorder.

All of them keep the tie rules above; their hits are the ``cond`` walk's,
since a stale t only admits more leaves and only a strictly closer hit
replaces the best.  ``closest_hit`` takes the unified
walk when the scene has that tree and otherwise reads ``ZWRT_TRAV`` at
each call (an unknown value walks ``queue``, as in the JAX package).
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch

from ..dtypes import BIG, BIG_IDX, INF, QUAD_PARALLEL_EPS, real
from ..geometry import quad as quad_g
from ..geometry import sphere as sphere_g
from ..math.aabb import aabb_hit
from ..math.v3 import V3
from ..scene import PRIM_QUAD, PRIM_SPHERE, CompiledScene
from ..utils import workcount

NO_HIT = -1
# Tree walks, as the kernels' trace number them (zwrt_device.cuh:Walk).
WALKS = ("cond", "queue", "rowqueue", "spec", "uni")
WARP = 32  # lanes that walk together in ``rowqueue``
# leaf entries a lane of the ``queue`` walk holds before it sweeps them
# (zwrt_device.cuh:kQueueCap)
QUEUE_CAP = 8
# workcount keys of one primitive test per kind
_TEST = {PRIM_SPHERE: "sphere_test", PRIM_QUAD: "quad_test"}
# Leaf sweeps handle at most this many (lane, slot) pairs at once.
_SWEEP_ELEMS = 1 << 22


class Hit(NamedTuple):
    t: torch.Tensor       # (N,) f32, +inf on miss
    kind: torch.Tensor    # (N,) i32, PRIM_SPHERE / PRIM_QUAD / -1 miss
    idx: torch.Tensor     # (N,) i32 primitive index within its table


def _brute_stage(scene, code, origin, direction, time, t_min, best: Hit) -> Hit:
    """Linear scan of one kind; a primitive replaces the best only with a
    strictly smaller t."""
    t_best, kind, idx = best
    n = scene.n_spheres if code == PRIM_SPHERE else scene.n_quads
    for i in range(n):
        if code == PRIM_SPHERE:
            center = scene.sph_center[i]
            if scene.has_moving:
                center = center + scene.sph_move[i] * time
            t, _ = sphere_g.hit_t(
                center, scene.sph_radius[i], origin, direction, t_min, t_best
            )
        else:
            t, _, _, _ = quad_g.hit_t(
                scene.quad_start[i], scene.quad_normal[i], scene.quad_w[i],
                scene.quad_u[i], scene.quad_v[i], scene.quad_offset[i],
                origin, direction, t_min, t_best,
            )
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kind = torch.where(closer, code, kind)
        idx = torch.where(closer, i, idx)
    return Hit(t_best, kind, idx)


def _fresh(n, t_start, device) -> Hit:
    return Hit(
        torch.full((n,), t_start, dtype=real, device=device),
        torch.full((n,), NO_HIT, dtype=torch.int32, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _slot_candidates(code, attrs, slots, o: V3, d: V3, tm, t_min):
    """Each (lane, slot)'s hit distance, BIG where it misses: spheres take
    the first root in (t_min, BIG), quads a plane distance in [t_min, BIG)
    inside the parallelogram.  ``slots`` is (k, L) and the ray values are
    (k, 1)."""
    col = lambda j: attrs[j][slots]
    if code == PRIM_SPHERE:
        cx, cy, cz = col(0), col(1), col(2)
        if tm is not None:
            cx = cx + col(4) * tm
            cy = cy + col(5) * tm
            cz = cz + col(6) * tm
        ocx, ocy, ocz = cx - o.x, cy - o.y, cz - o.z
        a = d.x * d.x + d.y * d.y + d.z * d.z
        inv_a = 1.0 / a
        h = d.x * ocx + d.y * ocy + d.z * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - col(3)
        disc = h * h - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        root1 = (h - sq) * inv_a
        root2 = (h + sq) * inv_a
        in1 = (root1 > t_min) & (root1 < BIG)
        in2 = (root2 > t_min) & (root2 < BIG)
        t = torch.where(in1, root1, root2)
        hit = (disc >= 0.0) & (in1 | in2)
    else:
        nx, ny, nz = col(3), col(4), col(5)
        denom = nx * d.x + ny * d.y + nz * d.z
        not_par = torch.abs(denom) >= QUAD_PARALLEL_EPS
        t = (col(12) - (nx * o.x + ny * o.y + nz * o.z)) / torch.where(
            not_par, denom, 1.0
        )
        px = o.x + d.x * t - col(0)
        py = o.y + d.y * t - col(1)
        pz = o.z + d.z * t - col(2)
        alpha = px * col(6) + py * col(7) + pz * col(8)
        beta = px * col(9) + py * col(10) + pz * col(11)
        interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        hit = not_par & (t >= t_min) & (t < BIG) & interior
    return torch.where(hit, t, BIG)


def _leaf_sweep(code, attrs, span, group0, o: V3, d: V3, tm, t_min):
    """(t, original index) of the leaves starting at group ``group0`` (k,)
    for the (k,) lanes, with the 8-column tie rule of the module doc; t is
    BIG where nothing was hit."""
    k = group0.shape[0]
    lanes_t, lanes_i = [], []
    step = max(1, _SWEEP_ELEMS // (span * 8))
    for lo in range(0, k, step):
        g0 = group0[lo:lo + step].to(torch.int64)
        slots = g0[:, None] * 8 + torch.arange(span * 8, device=g0.device)[None, :]
        ray = lambda v: V3(*(c[lo:lo + step, None] for c in v))
        t = _slot_candidates(
            code, attrs, slots, ray(o), ray(d),
            None if tm is None else tm[lo:lo + step, None],
            t_min if not torch.is_tensor(t_min) else t_min[lo:lo + step, None],
        ).reshape(-1, span, 8)
        # per column: its best t and the first group reaching it
        t_col = t.amin(dim=1)
        first = torch.argmax((t == t_col[:, None, :]).to(torch.uint8), dim=1)
        oi = attrs[-1][slots].reshape(-1, span, 8)
        i_col = torch.gather(oi, 1, first[:, None, :]).squeeze(1)
        t_row = t_col.amin(dim=1)
        i_row = torch.where(t_col <= t_row[:, None], i_col, BIG_IDX).amin(dim=1)
        lanes_t.append(t_row)
        lanes_i.append(i_row)
    return torch.cat(lanes_t), torch.cat(lanes_i)


def _sweep_into(code, attrs, span, lanes, group0, o: V3, d: V3, tm, t_min, best: Hit):
    """Sweep leaf ``group0`` (k,) for ``lanes`` (k,), each lane at most once,
    and keep a strictly closer hit in ``best`` (in place)."""
    _sweep_entries(code, attrs, span, [(lanes, group0)], o, d, tm, t_min, best)


def _sweep_entries(code, attrs, span, entries, o: V3, d: V3, tm, t_min, best: Hit):
    """``_sweep_into`` of each (lanes, group0) of ``entries`` in turn.  A
    leaf's hit does not depend on the running t, so every entry's leaves
    are swept in one batch, and each entry then keeps its strictly closer
    hits in order."""
    t_best, kind, idx = best
    every = torch.cat([lanes for lanes, _ in entries])
    if workcount.enabled():
        workcount.add("leaf_visit", every.numel())
        workcount.add(_TEST[code], every.numel() * span * 8)
    if every.numel() == 0:
        return
    t_rows, i_rows = _leaf_sweep(
        code, attrs, span, torch.cat([group0 for _, group0 in entries]),
        V3(o.x[every], o.y[every], o.z[every]), V3(d.x[every], d.y[every], d.z[every]),
        None if tm is None else tm[every],
        t_min[every] if torch.is_tensor(t_min) else t_min,
    )
    at = 0
    for lanes, _ in entries:
        t_row, i_row = t_rows[at:at + lanes.numel()], i_rows[at:at + lanes.numel()]
        at += lanes.numel()
        better = t_row < t_best[lanes]
        t_best[lanes] = torch.where(better, t_row, t_best[lanes])
        kind[lanes] = torch.where(better, code, kind[lanes])
        idx[lanes] = torch.where(better, i_row.to(torch.int32), idx[lanes])


def _slab(box, nd, o: V3, inv_d: V3, t_min, t, lanes):
    """Slab test of node ``nd`` (k,) for ``lanes`` (k,) against t (k,)."""
    if workcount.enabled():
        workcount.add("slab_test", lanes.numel())
    b = box[nd]
    sub = lambda v: V3(v.x[lanes], v.y[lanes], v.z[lanes])
    return aabb_hit(
        V3(b[:, 0], b[:, 1], b[:, 2]), V3(b[:, 3], b[:, 4], b[:, 5]),
        sub(o), sub(inv_d), t_min[lanes] if torch.is_tensor(t_min) else t_min, t,
    )


def _walk_cond(box, link, o, d, t_min, walking, t_best, sweep, spec=False):
    """Per-lane skip-link walk: a lane tests its node's box against its t
    in ``t_best`` (N,); a hit leaf goes to ``sweep(lanes, node)`` at once,
    a hit interior node descends to node + 1, anything else jumps to the
    miss link.  A ``sweep`` that updates ``t_best`` in place culls the rest
    of the walk with it (the cond walk).  ``spec`` tests the box of each
    step's node while at its parent, both successors at once (clamped to
    the last node for the test), with the parent's t from before its
    sweep."""
    n_nodes = box.shape[0]
    node = torch.zeros_like(walking, dtype=torch.int64)
    inv_d = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    walking = walking.clone()
    if spec:
        every = torch.nonzero(walking).squeeze(1)
        carried = torch.zeros_like(walking)
        carried[every] = _slab(box, node[every], o, inv_d, t_min, t_best[every], every)
    while True:
        lanes = torch.nonzero(walking).squeeze(1)
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        miss = link[nd, 0].to(torch.int64)
        if spec:
            t_pre = t_best[lanes]
            hit_desc = _slab(box, torch.clamp(nd + 1, max=n_nodes - 1), o, inv_d, t_min, t_pre, lanes)
            hit_miss = _slab(box, torch.clamp(miss, max=n_nodes - 1), o, inv_d, t_min, t_pre, lanes)
            hit = carried[lanes]
        else:
            hit = _slab(box, nd, o, inv_d, t_min, t_best[lanes], lanes)
        leaf = link[nd, 1]
        visit = hit & (leaf >= 0)
        sweep(lanes[visit], nd[visit])
        desc = hit & (leaf < 0)
        nxt = torch.where(desc, nd + 1, miss)
        if spec:
            carried[lanes] = torch.where(desc, hit_desc, hit_miss)
        node[lanes] = nxt
        walking[lanes] = nxt < n_nodes


def _walk_queue(box, link, o, d, t_min, walking, t_seed, per_warp):
    """The queue walks' first pass: cull with the seed t, per lane or (with
    ``per_warp``) in lockstep groups of WARP consecutive lanes.  Returns the
    hit leaves as a list of (lanes, nodes) in walk order; a lane is in each
    entry at most once, so the list is every lane's queue in preorder."""
    n_nodes = box.shape[0]
    inv_d = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    n = walking.shape[0]
    owner = torch.arange(n, device=walking.device) // (WARP if per_warp else 1)
    node = torch.zeros((int(owner[-1]) + 1 if n else 0,), dtype=torch.int64,
                       device=walking.device)
    running = torch.zeros_like(node, dtype=torch.bool)
    running.index_fill_(0, owner[walking], True)
    queue = []
    while True:
        lanes = torch.nonzero(walking & running[owner]).squeeze(1)
        if lanes.numel() == 0:
            break
        nd = node[owner[lanes]]
        hit = _slab(box, nd, o, inv_d, t_min, t_seed[lanes], lanes)
        any_hit = torch.zeros_like(running)
        any_hit.index_fill_(0, owner[lanes[hit]], True)
        leaf = link[nd, 1]
        marked = hit & (leaf >= 0)
        if bool(marked.any()):
            queue.append((lanes[marked], nd[marked]))
        groups = torch.unique(owner[lanes])
        g_node = node[groups]
        desc = any_hit[groups] & (link[g_node, 1] < 0)
        nxt = torch.where(desc, g_node + 1, link[g_node, 0].to(torch.int64))
        node[groups] = nxt
        running[groups] = nxt < n_nodes
    return queue


def _walk_bounded(box, link, o, d, t_min, walking, t_best, cap, sweep):
    """The ``queue`` walk: each lane culls with its running t in ``t_best``
    (N,) and pushes its hit leaves in preorder to a queue of ``cap``
    entries; when a lane's queue is full or its walk has ended,
    ``sweep(entries)`` gets the queue, a list of (lanes, nodes) in queue
    order with each lane at most once in an entry, and the lane's walk goes
    on from where it stopped under the t the sweep tightened (in place in
    ``t_best``)."""
    n_nodes = box.shape[0]
    inv_d = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    node = torch.zeros_like(walking, dtype=torch.int64)
    queue = torch.zeros((walking.shape[0], cap), dtype=torch.int64, device=walking.device)
    size = torch.zeros_like(node)
    walking = walking.clone()
    while True:
        lanes = torch.nonzero(walking).squeeze(1)
        if lanes.numel():
            nd = node[lanes]
            hit = _slab(box, nd, o, inv_d, t_min, t_best[lanes], lanes)
            leaf = link[nd, 1]
            push = hit & (leaf >= 0)
            pushed = lanes[push]
            queue[pushed, size[pushed]] = nd[push]
            size[pushed] += 1
            nxt = torch.where(hit & (leaf < 0), nd + 1, link[nd, 0].to(torch.int64))
            node[lanes] = nxt
            walking[lanes] = nxt < n_nodes
        full = torch.nonzero((size == cap) | (~walking & (size > 0))).squeeze(1)
        if full.numel():
            held = size[full]
            sweep([(full[held > j], queue[full[held > j], j]) for j in range(int(held.max()))])
            size[full] = 0
        elif lanes.numel() == 0:
            return


def _tree_stage(code, box, link, attrs, span, o: V3, d: V3, tm, t_min, walking, best: Hit,
                walk, queue_cap) -> Hit:
    """One kind's group tree, walked as ``walk`` says (module doc); the
    ``queue`` walk holds ``queue_cap`` leaves a lane."""
    best = Hit(*(x.clone() for x in best))
    sweep = lambda lanes, nd: _sweep_into(code, attrs, span, lanes, link[nd, 1], o, d, tm,
                                          t_min, best)
    if walk == "cond":
        _walk_cond(box, link, o, d, t_min, walking, best.t, sweep)
        return best
    if walk == "queue":
        _walk_bounded(box, link, o, d, t_min, walking, best.t, queue_cap,
                      lambda entries: _sweep_entries(
                          code, attrs, span, [(lanes, link[nd, 1]) for lanes, nd in entries],
                          o, d, tm, t_min, best))
        return best
    if walk == "spec":
        queue = []
        _walk_cond(box, link, o, d, t_min, walking, best.t.clone(),
                   lambda lanes, nd: queue.append((lanes, nd)), spec=True)
    else:
        queue = _walk_queue(box, link, o, d, t_min, walking, best.t.clone(),
                            per_warp=walk == "rowqueue")
    if walk == "rowqueue":
        inv_d = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    for lanes, nd in queue:
        if walk == "rowqueue":
            again = _slab(box, nd, o, inv_d, t_min, best.t[lanes], lanes)
            lanes, nd = lanes[again], nd[again]
        sweep(lanes, nd)
    return best


_uni_cond = False


@contextlib.contextmanager
def uni_cond_walk():
    """Inside the block the plain ``uni`` walk takes its first design's
    form: one ``cond`` walk of the unified tree that sweeps each hit leaf
    at once by its kind and culls the rest of the walk with the running t.
    Its hits are the deferred walk's but for a sphere and a quad at exactly
    equal t, which it resolves by preorder; its work counts, the culling
    walk's, price the uni walk's roofline bound (chip_smoke.py)."""
    global _uni_cond
    prev, _uni_cond = _uni_cond, True
    try:
        yield
    finally:
        _uni_cond = prev


def _uni_tree_stage(scene, o: V3, d: V3, tm, t_min, walking, best: Hit) -> Hit:
    """One per-lane queue walk of the unified tree with the seed t, then
    its queue swept by kind (link column 2) with that kind's leaf slots:
    every sphere leaf in walk order, then every quad leaf in walk order
    (inside ``uni_cond_walk``, one cond walk that sweeps each leaf at
    once)."""
    best = Hit(*(x.clone() for x in best))
    link = scene.uni_tree_link
    span = scene.uni_leaf_span
    kinds = ((PRIM_SPHERE, scene.uni_sph_attrs, tm), (PRIM_QUAD, scene.uni_quad_attrs, None))

    def sweep(code, attrs, tmv, lanes, nd):
        mine = link[nd, 2] == code
        _sweep_into(code, attrs, span, lanes[mine], link[nd[mine], 1], o, d, tmv, t_min, best)

    if _uni_cond:
        def sweep_both(lanes, nd):
            for k in kinds:
                sweep(*k, lanes, nd)

        _walk_cond(scene.uni_tree_box, link, o, d, t_min, walking, best.t, sweep_both)
        return best
    queue = _walk_queue(scene.uni_tree_box, link, o, d, t_min, walking, best.t.clone(),
                        per_warp=False)
    for k in kinds:
        for lanes, nd in queue:
            sweep(*k, lanes, nd)
    return best


# The walk when ZWRT_TRAV is unset.  The JAX package walks cond; on the
# H100 the queue walk beat cond at the port's leaf span on both scenes that
# tools/span_sweep.py times, in 5 of 5 alternating pairs each (NVIDIA H100
# 80GB HBM3, 700.00 W; render medians: balls 400x400@128 d10 0.0343 vs
# 0.0509 s, rtw_final 400x400@64 d8 0.0302 vs 0.0327 s).
DEFAULT_WALK = "queue"


def walk_of(scene: CompiledScene) -> str:
    """The tree walk the kernels take for ``scene``: ``uni`` when it has
    the unified tree, else ``ZWRT_TRAV`` as read now (``DEFAULT_WALK`` when
    unset; ``ZWRT_TRAV=cond`` gives the JAX package's walk; an unknown
    value walks ``queue``, as in the JAX package)."""
    if scene.has_uni_tree:
        return "uni"
    trav = os.environ.get("ZWRT_TRAV", DEFAULT_WALK)
    return trav if trav in ("cond", "rowqueue", "spec") else "queue"


def closest_hit(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min,
    t_max=INF, active=None, walk=None, queue_cap=QUEUE_CAP,
) -> Hit:
    """Closest hit of each ray: the sphere stage (brute or tree), then the
    quad stage seeded with it, or one walk of the unified tree.  ``time``
    is (N,); ``t_min`` a float or (N,) tensor; ``active`` an optional (N,)
    bool mask whose False rays report no hit; ``walk`` one of ``WALKS``,
    ``walk_of(scene)`` when None; ``queue_cap`` the leaves a lane of the
    ``queue`` walk holds before it sweeps them (the kernels'; at the
    tree's leaves or more, such as ``fused_render.queue_capacity``, the
    work of the whole walk with the seed t)."""
    closest_hit.calls += 1
    walk = walk_of(scene) if walk is None else walk
    if walk not in WALKS:
        raise ValueError(f"unknown tree walk {walk!r}; one of {WALKS}")
    if walk == "uni" and not scene.has_uni_tree:
        raise ValueError("the uni walk needs a scene compiled with its unified tree")
    n = origin.shape[0]
    dev = origin.x.device
    alive = (
        torch.ones((n,), dtype=torch.bool, device=dev) if active is None
        else active.to(torch.bool)
    )
    best = _fresh(n, min(float(t_max), BIG), dev)
    tm = time if scene.has_moving else None
    if workcount.enabled():
        n_rays = int(alive.sum())
        workcount.add("trace", n_rays)
        for code, has_tree, n_prims in (
            (PRIM_SPHERE, scene.has_sph_tree, scene.n_spheres),
            (PRIM_QUAD, scene.has_quad_tree, scene.n_quads),
        ):
            if not has_tree and walk != "uni":
                workcount.add(_TEST[code], n_rays * n_prims)
    if walk == "uni":
        best = _uni_tree_stage(scene, origin, direction, tm, t_min, alive, best)
    else:
        for code, kind, tmv in ((PRIM_SPHERE, "sph", tm), (PRIM_QUAD, "quad", None)):
            if getattr(scene, f"has_{kind}_tree"):
                best = _tree_stage(
                    code, getattr(scene, f"{kind}_tree_box"), getattr(scene, f"{kind}_tree_link"),
                    getattr(scene, f"{kind}_tree_attrs"), getattr(scene, f"{kind}_leaf_span"),
                    origin, direction, tmv, t_min, alive, best, walk, queue_cap,
                )
            else:
                best = _brute_stage(scene, code, origin, direction, time, t_min, best)
    t, kind, idx = best
    missed = (kind == NO_HIT) | ~alive
    return Hit(
        torch.where(missed, INF, t),
        torch.where(alive, kind, NO_HIT),
        torch.where(alive, idx, 0),
    )


closest_hit.calls = 0
