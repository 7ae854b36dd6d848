"""Closest-hit tracing over the compiled scene tables: the plain version
of the port's closest hit, as the render kernel computes it, a sphere stage
(brute or group tree) then a quad stage seeded with the sphere result.
Tie rules:

  * a brute stage keeps the smallest index of equal ``t``;
  * a leaf sweep takes, in each of its 8 slot columns (sublanes), the first
    slot reaching the column's best ``t``, then the smallest original index
    among the columns at the leaf's best ``t``;
  * across leaves and stages only a strictly smaller ``t`` replaces the
    running best, so the first leaf visited keeps a tie and a quad never
    displaces a sphere at the same distance.

The running best starts at ``min(t_max, BIG)`` (finite, so the slab
test's far clip stays finite) and a ray that found nothing reports +inf
and kind -1.  A tree stage is the cond walk: each lane follows its own
node pointer along the skip links and sweeps a hit leaf at once, so its
running t culls the rest of the walk.  Every walk of the kernels keeps
the cond walk's hits, and its counts (``utils/workcount.py``: node tests,
leaf visits, leaf-slot tests) price a tree scene's trace.
"""

from __future__ import annotations

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
    t_best, kind, idx = best
    if workcount.enabled():
        workcount.add("leaf_visit", lanes.numel())
        workcount.add(_TEST[code], lanes.numel() * span * 8)
    if lanes.numel() == 0:
        return
    t_row, i_row = _leaf_sweep(
        code, attrs, span, group0,
        V3(o.x[lanes], o.y[lanes], o.z[lanes]), V3(d.x[lanes], d.y[lanes], d.z[lanes]),
        None if tm is None else tm[lanes],
        t_min[lanes] if torch.is_tensor(t_min) else t_min,
    )
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


def _walk_cond(box, link, o, d, t_min, walking, t_best, sweep):
    """Per-lane skip-link walk: a lane tests its node's box against its t
    in ``t_best`` (N,); a hit leaf goes to ``sweep(lanes, node)`` at once,
    a hit interior node descends to node + 1, anything else jumps to the
    miss link.  ``sweep`` updates ``t_best`` in place, so it culls the
    rest of the walk."""
    n_nodes = box.shape[0]
    node = torch.zeros_like(walking, dtype=torch.int64)
    inv_d = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    walking = walking.clone()
    while True:
        lanes = torch.nonzero(walking).squeeze(1)
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        miss = link[nd, 0].to(torch.int64)
        hit = _slab(box, nd, o, inv_d, t_min, t_best[lanes], lanes)
        leaf = link[nd, 1]
        visit = hit & (leaf >= 0)
        sweep(lanes[visit], nd[visit])
        desc = hit & (leaf < 0)
        nxt = torch.where(desc, nd + 1, miss)
        node[lanes] = nxt
        walking[lanes] = nxt < n_nodes


def _tree_stage(code, box, link, attrs, span, o: V3, d: V3, tm, t_min, walking,
                best: Hit) -> Hit:
    """One kind's group tree, walked by the cond walk."""
    best = Hit(*(x.clone() for x in best))
    _walk_cond(box, link, o, d, t_min, walking, best.t,
               lambda lanes, nd: _sweep_into(code, attrs, span, lanes, link[nd, 1], o, d, tm,
                                             t_min, best))
    return best


def closest_hit(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min, t_max=INF, active=None,
) -> Hit:
    """Closest hit of each ray: the sphere stage (brute or tree), then the
    quad stage seeded with it.  ``time`` is (N,); ``t_min`` a float or (N,)
    tensor; ``active`` an optional (N,) bool mask whose False rays report
    no hit."""
    closest_hit.calls += 1
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
            if not has_tree:
                workcount.add(_TEST[code], n_rays * n_prims)
    for code, kind, tmv in ((PRIM_SPHERE, "sph", tm), (PRIM_QUAD, "quad", None)):
        if getattr(scene, f"has_{kind}_tree"):
            best = _tree_stage(
                code, getattr(scene, f"{kind}_tree_box"), getattr(scene, f"{kind}_tree_link"),
                getattr(scene, f"{kind}_tree_attrs"), getattr(scene, f"{kind}_leaf_span"),
                origin, direction, tmv, t_min, alive, best,
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
