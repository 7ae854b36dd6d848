"""The redesigned rowqueue walk of the PyTorch port (kernel K4b:
``csrc/zwrt_device.cuh:tree_walk_warpqueue``), through its plain version
on the CPU.

  1. The plain rowqueue walk (``ops/trace.py``: groups of 32 lanes walk one
     node pointer with the seed t, then each marked lane re-tests every
     queued leaf against its running t before sweeping it) gives hits
     (t, kind, idx) bitwise the cond walk's, on rtw_final's 64x64 camera
     rays and on 4,000 seeded random rays of a scene of 100 spheres and
     600 quads, at leaf spans 1 and 2, with every lane walking and with
     every other lane dead (groups with gaps).  Tolerance: none, bitwise.
  2. Its leaf sweeps are the cond walk's: ``leaf_visit`` (and so the
     primitive tests) equal to cond's and at most the per-thread queue
     walk's, which sweeps every leaf its seed t admits.  Exact counts.
  3. ``node_args`` builds the packed node tables for rowqueue, the same
     tables as spec's; ``rowqueue_staged_nodes`` stages the preorder prefix
     of the sphere tree and then of the quad tree within
     ``ROWQUEUE_NODE_BYTES``; ``walk_args`` counts those nodes in its
     shared-memory check and raises past ``SMEM_LIMIT``.

The CUDA walk is held against this plain version on the card by
chip_smoke.py (phases 17 and 18).
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from test_torch_walks_redesign import _camera_rays, _random_rays, _random_scene, _with_env
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.utils import workcount

SPANS = (1, 2)
CAMERA_W = 64
LANES = ("all", "every other dead")


@pytest.fixture(scope="module")
def cases():
    """{(name, span): (compiled scene with per-kind trees, rays)}."""
    out = {}
    for span in SPANS:
        compile_at = lambda fn: _with_env(fn, ZWRT_LEAF_GROUPS=span)
        rtw = compile_at(lambda: zt.models.load_scene("rtw_final", device="cpu"))
        out[("rtw_final", span)] = (rtw.compiled, _camera_rays(rtw, CAMERA_W))
        out[("random", span)] = (compile_at(_random_scene), _random_rays())
    for cs, _ in out.values():
        assert cs.has_sph_tree and cs.has_quad_tree and not cs.has_uni_tree
    return out


@pytest.fixture(scope="module")
def traced():
    """{(name, span, lanes, walk): (hit, work counts)}, each traced once."""
    return {}


def _trace(cases, traced, name, span, lanes, walk):
    key = (name, span, lanes, walk)
    if key not in traced:
        cs, rays = cases[(name, span)]
        n = rays[2].shape[0]
        active = None if lanes == "all" else torch.arange(n) % 2 == 1
        with workcount.counting() as c:
            hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, active=active, walk=walk)
        traced[key] = (hit, dict(c))
    return traced[key]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_rowqueue_hits_are_the_cond_walks(cases, traced, name, span, lanes):
    ref, _ = _trace(cases, traced, name, span, lanes, "cond")
    hit, _ = _trace(cases, traced, name, span, lanes, "rowqueue")
    n = ref.kind.shape[0]
    assert int((ref.kind >= 0).sum()) > n // (4 if lanes == "all" else 8)
    assert {0, 1} <= set(ref.kind.tolist())
    if lanes != "all":
        assert (ref.kind[::2] == ttrace.NO_HIT).all()
    for got, want in zip(hit, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_rowqueue_sweeps_the_cond_walks_leaves(cases, traced, name, span, lanes):
    """The re-test before each sweep drops exactly the leaves that the cond
    walk's running t culls: a parent's box holds its children's and the
    slab test is monotone in t, so a leaf that passes at the running t
    would have been reached by the cond walk."""
    c = {w: _trace(cases, traced, name, span, lanes, w)[1]
         for w in ("cond", "queue", "rowqueue")}
    assert c["rowqueue"]["leaf_visit"] == c["cond"]["leaf_visit"] > 0
    assert c["rowqueue"]["leaf_visit"] <= c["queue"]["leaf_visit"]
    for key in ("sphere_test", "quad_test"):
        assert c["rowqueue"][key] == c["cond"][key]
    # the lockstep walk tests every node its group walks for each walking
    # lane, and each queued entry once more for each marked lane
    assert c["rowqueue"]["slab_test"] > c["queue"]["slab_test"] >= c["cond"]["slab_test"]


def test_node_args_builds_packed_tables_for_rowqueue():
    cs = _with_env(_random_scene, ZWRT_LEAF_GROUPS=2)
    fused_render._NODE_CACHE.pop(cs, None)
    ptrs, tables = fused_render.node_args(cs, "rowqueue")
    assert cs in fused_render._NODE_CACHE
    assert fused_render.node_args(cs, "spec")[1] is tables
    assert ptrs.dtype == np.uint64 and ptrs.shape == (3,)
    assert (ptrs[:2] != 0).all() and ptrs[2] == 0 and len(tables) == 2
    for t, tree in zip(tables, ("sph", "quad")):
        want = fused_render.pack_nodes(getattr(cs, f"{tree}_tree_box"),
                                       getattr(cs, f"{tree}_tree_link"))
        assert torch.equal(t.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("span", SPANS)
def test_rowqueue_stages_the_preorder_prefix(cases, span):
    """The sphere tree first, then the quad tree, as many nodes as the
    budget holds: rtw_final at span 1 (251 + 601 nodes) stages its quad
    tree in part, at span 2 (125 + 301) both trees whole."""
    room = fused_render.ROWQUEUE_NODE_BYTES // fused_render.NODE_BYTES
    cs, _ = cases[("rtw_final", span)]
    n_sph, n_quad = cs.sph_tree_box.shape[0], cs.quad_tree_box.shape[0]
    staged = fused_render.rowqueue_staged_nodes(cs)
    assert staged["sph"] == min(n_sph, room)
    assert staged["quad"] == min(n_quad, room - staged["sph"])
    assert sum(staged.values()) * fused_render.NODE_BYTES <= fused_render.ROWQUEUE_NODE_BYTES
    if span == 1:
        assert staged["sph"] == n_sph and 0 < staged["quad"] < n_quad
    else:
        assert staged == {"sph": n_sph, "quad": n_quad}
    balls = _with_env(lambda: zt.models.load_scene("balls", device="cpu"), ZWRT_LEAF_GROUPS=span)
    assert fused_render.rowqueue_staged_nodes(balls.compiled) == {
        "sph": balls.compiled.sph_tree_box.shape[0]}


def test_walk_args_counts_the_staged_nodes(cases, monkeypatch):
    monkeypatch.setenv("ZWRT_TRAV", "rowqueue")
    cs, _ = cases[("rtw_final", 1)]
    cap = fused_render.queue_capacity(cs, "rowqueue")
    nodes = sum(fused_render.rowqueue_staged_nodes(cs).values()) * fused_render.NODE_BYTES
    queues = fused_render.THREADS // ttrace.WARP * cap * 8
    room = fused_render.SMEM_LIMIT - nodes - queues
    walk, code, got_cap, queue = fused_render.walk_args(cs, 1000, room)
    assert (walk, code, got_cap, queue) == ("rowqueue", ttrace.WALKS.index("rowqueue"), cap, None)
    with pytest.raises(ValueError, match=f"and {nodes} of staged nodes, past the card's"):
        fused_render.walk_args(cs, 1000, room + 1)
