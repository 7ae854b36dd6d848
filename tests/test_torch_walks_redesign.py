"""The redesigned spec and uni walks of the PyTorch port (kernel K4:
``csrc/zwrt_device.cuh:tree_walk_spec``, ``uni_tree_walk``), through their
plain versions on the CPU.

  1. The queue-form plain walks (``ops/trace.py``: ``spec``, ``uni``) give
     hits (t, kind, idx) bitwise the cond walk's over the per-kind trees,
     on rtw_final's 64x64 camera rays and on 4,000 seeded random rays of a
     scene of 100 spheres and 600 quads, at leaf spans 1 and 2.
  2. The packed node table (``ops/fused_render.py:pack_nodes``, 32 bytes a
     node) round-trips to ``uni_tree_box`` / ``uni_tree_link`` and to each
     per-kind ``*_tree_box`` / ``*_tree_link``: boxes bitwise, links and
     kinds equal; ``node_args`` builds the tables for every walk but cond,
     once per scene, and ``trace_args`` does not carry them.
  3. ``queue_capacity`` covers the unified tree's leaves under uni and the
     per-kind trees' under spec, and every lane's queue of the random rays
     at span 1.
  4. The plain uni walk inside ``ops/trace.py:uni_cond_walk`` (the cond
     walk of the unified tree, whose counts price the uni walk's bound)
     gives the same hits with fewer node tests.

The CUDA walks are held against these plain versions on the card by
chip_smoke.py (phases 17 and 18).
"""

import os

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.render import camera as tcam

SPANS = (1, 2)
REDESIGNED = ("spec", "uni")
CAMERA_W = 64
N_RANDOM = 4000


def _with_env(fn, **env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _random_scene():
    rng = np.random.default_rng(0)
    b = zt.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for _ in range(100):
        b.add(b.sphere(rng.uniform(-10, 10, 3), rng.uniform(0.2, 1.5), mat))
    for _ in range(600):
        b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), mat))
    b.use_bvh(True, min_prims=2)
    return b.compile(device="cpu").compiled


def _random_rays():
    rng = np.random.default_rng(1)
    f = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    org, d = rng.uniform(-15, 15, (N_RANDOM, 3)), rng.normal(size=(N_RANDOM, 3))
    return (V3(*(f(org[:, i]) for i in range(3))), V3(*(f(d[:, i]) for i in range(3))),
            f(rng.uniform(0, 1, N_RANDOM)))


def _camera_rays(scene, w):
    """Every pixel's sample-0 camera ray at w x w, as the first-hit probe
    makes them (Sobol, seed 0)."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    return tcam.generate_rays(
        tcam.camera_params_from_consts(tcam.camera_consts(scene.camera, w, w)),
        scene.camera.has_depth_of_field, zt.sampling.SamplerKind.SOBOL, 0, py * w + px, px, py,
        torch.zeros_like(px), 1, w, w)


@pytest.fixture(scope="module")
def cond_hits():
    """The cond walk's hits per case, computed once."""
    return {}


@pytest.fixture(scope="module")
def cases():
    """{(name, span): (compiled scene with per-kind and unified trees, rays)}:
    rtw_final and the random scene, each compiled under ZWRT_UNI_TREE=1 at
    leaf spans 1 and 2."""
    out = {}
    for span in SPANS:
        compile_at = lambda fn: _with_env(fn, ZWRT_LEAF_GROUPS=span, ZWRT_UNI_TREE=1)
        rtw = compile_at(lambda: zt.models.load_scene("rtw_final", device="cpu"))
        out[("rtw_final", span)] = (rtw.compiled, _camera_rays(rtw, CAMERA_W))
        out[("random", span)] = (compile_at(_random_scene), _random_rays())
    for cs, _ in out.values():
        assert cs.has_uni_tree and cs.has_sph_tree and cs.has_quad_tree
    return out


@pytest.mark.parametrize("walk", REDESIGNED)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_queue_form_walk_hits_are_the_cond_walks(cases, cond_hits, name, span, walk):
    cs, rays = cases[(name, span)]
    assert cs.uni_leaf_span == cs.sph_leaf_span == span
    if (name, span) not in cond_hits:
        cond_hits[(name, span)] = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk="cond")
    ref = cond_hits[(name, span)]
    hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk=walk)
    assert int((ref.kind >= 0).sum()) > ref.kind.shape[0] // 4
    assert {0, 1} <= set(ref.kind.tolist())
    for got, want in zip(hit, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_uni_cond_walk_culls_to_the_same_hits(cases, cond_hits, name, span):
    """The unified tree's first-design form (one cond walk, leaves swept at
    once), whose counts price the uni walk's bound: the cond walk's hits,
    no more node tests or leaf visits than the deferred walk, and the
    deferred walk again once the block ends."""
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    cs, rays = cases[(name, span)]
    if (name, span) not in cond_hits:
        cond_hits[(name, span)] = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk="cond")
    counts = {}
    for form in ("cond", "deferred"):
        with workcount.counting() as c:
            if form == "cond":
                with ttrace.uni_cond_walk():
                    hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk="uni")
            else:
                hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk="uni")
        counts[form] = dict(c)
        for got, want in zip(hit, cond_hits[(name, span)]):
            assert torch.equal(got, want)
    for key in ("slab_test", "leaf_visit", "sphere_test", "quad_test"):
        assert 0 < counts["cond"][key] <= counts["deferred"][key], key
    assert counts["cond"]["slab_test"] < counts["deferred"]["slab_test"]
    assert not ttrace._uni_cond


def _unpack(nodes):
    """(box bits (n, 6), miss (n,), leaf word (n,)) of a packed table."""
    bits = nodes.view(torch.int32)
    return torch.cat([bits[:, :3], bits[:, 4:7]], dim=1), bits[:, 3], bits[:, 7]


@pytest.mark.parametrize("tree", ["sph", "quad", "uni"])
def test_packed_nodes_round_trip(cases, tree):
    for span in SPANS:
        cs, _ = cases[("rtw_final", span)]
        box, link = getattr(cs, f"{tree}_tree_box"), getattr(cs, f"{tree}_tree_link")
        nodes = fused_render.pack_nodes(box, link)
        assert nodes.dtype == torch.float32 and nodes.shape == (box.shape[0], 8)
        assert nodes.is_contiguous() and nodes.element_size() * nodes.shape[1] == 32
        bits, miss, word = _unpack(nodes)
        assert torch.equal(bits, box.contiguous().view(torch.int32))
        assert torch.equal(miss, link[:, 0])
        assert torch.equal(torch.where(word >= 0, word >> 1, -1), link[:, 1])
        kind = link[:, 2] if tree == "uni" else torch.zeros_like(word)
        assert torch.equal(torch.where(word >= 0, word & 1, -1),
                           torch.where(link[:, 1] >= 0, kind, -1))
        assert ((link[:, 1] >= 0) == (word >= 0)).all()


def test_node_args_only_for_spec_and_uni():
    """Only the redesigned walks (queue, rowqueue, spec, uni) read packed
    nodes, all the same tables; cond reads none."""
    cs = _with_env(_random_scene, ZWRT_LEAF_GROUPS=2, ZWRT_UNI_TREE=1)
    assert fused_render.node_args(cs, "cond") == (None, ())
    assert cs not in fused_render._NODE_CACHE
    ptrs, tables = fused_render.node_args(cs, "spec")
    assert cs in fused_render._NODE_CACHE and fused_render.node_args(cs, "uni")[1] is tables
    assert fused_render.node_args(cs, "rowqueue")[1] is tables
    assert fused_render.node_args(cs, "queue")[1] is tables
    assert ptrs.dtype == np.uint64 and ptrs.shape == (3,) and (ptrs != 0).all()
    assert [t.data_ptr() for t in tables] == ptrs.tolist()
    for t, tree in zip(tables, ("sph", "quad", "uni")):
        want = fused_render.pack_nodes(getattr(cs, f"{tree}_tree_box"),
                                       getattr(cs, f"{tree}_tree_link"))
        assert torch.equal(t.view(torch.int32), want.view(torch.int32))
    # the default walk's trace tables carry no packed nodes
    _, t_ptrs, _ = fused_render.trace_args(cs)
    assert len(t_ptrs) == 14 and not set(ptrs.tolist()) & set(t_ptrs.tolist())
    # a scene without a unified tree: a null pointer in its place
    per_kind = _with_env(_random_scene, ZWRT_LEAF_GROUPS=2)
    assert not per_kind.has_uni_tree
    p2, tables2 = fused_render.node_args(per_kind, "spec")
    assert (p2[:2] != 0).all() and p2[2] == 0 and len(tables2) == 2


def _queue_lengths(cs, rays, walk):
    """Each lane's queue length under the kernel's queue walk of ``walk``:
    the unified tree's hit leaves under uni, the longer kind's under spec
    (the stages reuse one queue)."""
    from zig_weekend_raytracer_tpu_torch.dtypes import BIG

    o, d, _ = rays
    n = o.shape[0]
    walking = torch.ones(n, dtype=torch.bool)
    seed = torch.full((n,), BIG)
    trees = ("uni",) if walk == "uni" else ("sph", "quad")
    longest = torch.zeros(n, dtype=torch.int64)
    for tree in trees:
        entries = ttrace._walk_queue(getattr(cs, f"{tree}_tree_box"),
                                     getattr(cs, f"{tree}_tree_link"), o, d, zt.dtypes.T_MIN,
                                     walking, seed, per_warp=False)
        count = torch.zeros(n, dtype=torch.int64)
        for lanes, _ in entries:
            count[lanes] += 1
        longest = torch.maximum(longest, count)
    return longest


@pytest.mark.parametrize("walk", REDESIGNED)
def test_queue_capacity_covers_the_walks_leaves(cases, walk):
    for (name, span), (cs, rays) in cases.items():
        cap = fused_render.queue_capacity(cs, walk)
        trees = ("uni",) if walk == "uni" else ("sph", "quad")
        leaves = max(int((getattr(cs, f"{t}_tree_link")[:, 1] >= 0).sum()) for t in trees)
        assert cap >= leaves + 1, (name, span)
        nodes = max(getattr(cs, f"{t}_tree_box").shape[0] for t in trees)
        assert cap == (nodes + 1) // 2 + 1
    cs, rays = cases[("random", 1)]
    assert int(_queue_lengths(cs, rays, walk).max()) < fused_render.queue_capacity(cs, walk)
