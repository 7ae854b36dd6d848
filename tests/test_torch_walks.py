"""The tree walks of the PyTorch port (the TPU's traversal variants, K4)
against the JAX package and against the default walk, on the CPU.

  1. ``build_group_tree_unified`` and the scene's unified-tree fields equal
     the JAX package's bitwise: random boxes at several spans (mixed-kind
     small spans included), the 70 + 70 scene of tests/test_pallas.py:241
     at this suite's span, and rtw_final at this suite's span and at the
     package default.
  2. Each plain walk (``ops/trace.py``: queue, rowqueue, spec, uni) against
     the default walk on seeded random rays in a scene of 100 spheres and
     600 quads: (t, kind, idx) bitwise.  The unified walk sweeps its
     sphere leaves before its quad leaves, so a sphere keeps a tie with a
     quad as in the per-kind stages, but two leaves of one kind at exactly
     equal t resolve by the unified tree's preorder; such tie lanes would
     be named and counted (tests/test_torch_walks_redesign.py finds none).
  3. The work each walk counts (``utils/workcount.py``) is the work it does.
  4. The wrappers' walk selection, queue capacities and refusals, and the
     trace tables of a scene with the unified tree, reached directly (the
     kernels that read them run only on the card).
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_bvh import random_scene
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu.geometry import bvh as jbvh
from zig_weekend_raytracer_tpu_torch.geometry import bvh as tbvh
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.utils import workcount

NEW_WALKS = ("queue", "rowqueue", "spec", "uni")


def assert_same_uni(ct, cj):
    assert ct.has_uni_tree == bool(cj.has_uni_tree) and ct.uni_leaf_span == cj.uni_leaf_span
    for f in ("uni_tree_box", "uni_tree_link"):
        got, want = getattr(ct, f).numpy(), np.asarray(getattr(cj, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f, n in (("uni_sph_attrs", 8), ("uni_quad_attrs", 14)):
        attrs_t, attrs_j = getattr(ct, f), getattr(cj, f)
        assert len(attrs_t) == len(attrs_j) == (n if ct.has_uni_tree else 0), f
        for a_t, a_j in zip(attrs_t, attrs_j):
            a_j = np.asarray(a_j)
            assert a_t.numpy().dtype == a_j.dtype
            np.testing.assert_array_equal(a_t.numpy(), a_j, err_msg=f)


@pytest.mark.parametrize("leaf_groups", [1, 2, 4])
def test_build_group_tree_unified_equals_jax(leaf_groups):
    """Random boxes of both kinds, clustered so that small spans mix kinds."""
    rng = np.random.default_rng(leaf_groups)
    n = 150
    lo = rng.uniform(-10, 10, (n, 3))
    hi = lo + rng.uniform(0.01, 2.0, (n, 3))
    kinds = (rng.uniform(size=n) < 0.4).astype(np.int32)
    local = np.zeros(n, np.int32)
    for k in (0, 1):
        local[kinds == k] = np.arange((kinds == k).sum())
    got = tbvh.build_group_tree_unified(lo, hi, kinds, local, leaf_groups=leaf_groups)
    want = jbvh.build_group_tree_unified(lo, hi, kinds, local, leaf_groups=leaf_groups)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    link = got["node_link"]
    assert ((link[:, 1] < 0) == (link[:, 2] < 0)).all() and set(link[:, 2]) == {-1, 0, 1}


def test_unified_tree_of_one_kind_pads_the_other():
    lo = np.arange(30, dtype=np.float64)[:, None] * np.ones(3)
    got = tbvh.build_group_tree_unified(lo, lo + 0.5, np.zeros(30, np.int32),
                                        np.arange(30, dtype=np.int32), leaf_groups=1)
    np.testing.assert_array_equal(got["quad_slots"], [-1] * 8)
    assert (got["node_link"][:, 2] != 1).all()


def test_uni_fields_equal_jax_random_scene(monkeypatch):
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    cj = random_scene(zj, 11, 70, 70)[0]
    ct = random_scene(zt, 11, 70, 70)[0]
    assert ct.has_uni_tree and ct.uni_tree_box.shape[0] > 3
    assert_same_uni(ct, cj)
    monkeypatch.delenv("ZWRT_UNI_TREE")
    assert_same_uni(random_scene(zt, 11, 70, 70)[0], random_scene(zj, 11, 70, 70)[0])


@pytest.mark.parametrize("span", ["4", None])
def test_uni_fields_equal_jax_rtw_final(monkeypatch, span):
    """At this suite's span and at the port's default (1 for rtw_final's
    3,406 primitives), the JAX package built at that span."""
    if span is None:
        monkeypatch.delenv("ZWRT_LEAF_GROUPS", raising=False)
    else:
        monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    ct = zt.models.load_scene("rtw_final", device="cpu").compiled
    assert ct.uni_leaf_span == (1 if span is None else 4)
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", str(ct.uni_leaf_span))
    cj = zj.models.load_scene("rtw_final").compiled
    assert_same_uni(ct, cj)


@pytest.fixture(scope="module")
def big_scene():
    """100 spheres and 600 quads with use_bvh, compiled with and without the
    unified tree, and 4,000 seeded random rays with times."""
    import os

    def build(uni):
        old = os.environ.pop("ZWRT_UNI_TREE", None)
        if uni:
            os.environ["ZWRT_UNI_TREE"] = "1"
        try:
            rng = np.random.default_rng(0)
            b = zt.scene.SceneBuilder()
            mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
            for _ in range(100):
                b.add(b.sphere(rng.uniform(-10, 10, 3), rng.uniform(0.2, 1.5), mat))
            for _ in range(600):
                b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3),
                             rng.uniform(-2, 2, 3), mat))
            b.use_bvh(True, min_prims=2)
            return b.compile(device="cpu").compiled
        finally:
            os.environ.pop("ZWRT_UNI_TREE", None)
            if old is not None:
                os.environ["ZWRT_UNI_TREE"] = old

    rng = np.random.default_rng(1)
    n = 4000
    f = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    org, d = rng.uniform(-15, 15, (n, 3)), rng.normal(size=(n, 3))
    rays = (V3(*(f(org[:, i]) for i in range(3))), V3(*(f(d[:, i]) for i in range(3))),
            f(rng.uniform(0, 1, n)))
    per_kind, uni = build(False), build(True)
    assert per_kind.has_sph_tree and per_kind.has_quad_tree and not per_kind.has_uni_tree
    assert uni.has_uni_tree
    return per_kind, uni, rays


def _trace(scene, rays, walk, active=None):
    with workcount.counting() as c:
        hit = ttrace.closest_hit(scene, *rays, zt.dtypes.T_MIN, active=active, walk=walk)
    return hit, dict(c)


@pytest.mark.parametrize("walk", NEW_WALKS)
def test_plain_walk_matches_default(big_scene, walk):
    per_kind, uni, rays = big_scene
    active = torch.from_numpy(np.random.default_rng(2).uniform(size=4000) < 0.9)
    ref, _ = _trace(per_kind, rays, "cond", active)
    hit, _ = _trace(uni if walk == "uni" else per_kind, rays, walk, active)
    assert (ref.kind >= 0).sum() > 1000 and (ref.kind[~active] == -1).all()
    differ = (hit.kind != ref.kind) | (hit.idx != ref.idx)
    if walk == "uni":
        # tie lanes: two leaves at exactly the same t
        ties = torch.nonzero(differ).squeeze(1).tolist()
        assert torch.equal(hit.t[differ], ref.t[differ]), f"non-tie lanes {ties}"
        assert len(ties) <= 2, f"tie lanes {ties}"
    else:
        assert not differ.any()
    assert torch.equal(hit.t, ref.t)


def test_walk_work_counts(big_scene):
    """spec slab-tests both successors at every step (after one root test
    per lane and stage); the queue walk culls with a t that only its sweeps
    of QUEUE_CAP leaves tighten, so it tests and sweeps at least the cond
    walk's nodes and leaves and at most its first design's, which culls
    with the seed t; rowqueue tests every node its 32-lane group walks for
    each lane of the group, then re-tests each queued leaf against the
    lane's running t, so it sweeps the cond walk's leaves."""
    per_kind, uni, rays = big_scene
    c = {w: _trace(per_kind, rays, w)[1] for w in ("cond", "queue", "rowqueue", "spec")}
    with workcount.counting() as first:
        ttrace.closest_hit(per_kind, *rays, zt.dtypes.T_MIN, walk="queue",
                           queue_cap=fused_render.queue_capacity(per_kind, "queue"))
    for key in ("slab_test", "leaf_visit"):
        assert c["cond"][key] <= c["queue"][key] <= first[key], key
    n = rays[2].shape[0]
    assert all(c[w]["trace"] == n for w in c)
    assert (c["spec"]["slab_test"] - 2 * n) % 2 == 0
    assert c["spec"]["slab_test"] >= 2 * c["cond"]["slab_test"]
    assert c["queue"]["leaf_visit"] >= c["cond"]["leaf_visit"]
    assert c["cond"]["leaf_visit"] == c["rowqueue"]["leaf_visit"] <= c["queue"]["leaf_visit"]
    assert c["rowqueue"]["slab_test"] > c["queue"]["slab_test"] >= c["cond"]["slab_test"]
    for w in c:
        assert c[w]["sphere_test"] + c[w]["quad_test"] == c[w]["leaf_visit"] * 4 * 8
    cu = _trace(uni, rays, "uni")[1]
    assert cu["slab_test"] > 0 and cu["sphere_test"] + cu["quad_test"] == cu["leaf_visit"] * 4 * 8


def test_walk_of_reads_the_environment(monkeypatch, big_scene):
    per_kind, uni, _ = big_scene
    monkeypatch.delenv("ZWRT_TRAV", raising=False)
    # the port's default walk (the JAX package's is cond)
    assert ttrace.walk_of(per_kind) == ttrace.DEFAULT_WALK == "queue"
    assert ttrace.walk_of(uni) == "uni"
    for value, walk in (("queue", "queue"), ("rowqueue", "rowqueue"), ("spec", "spec"),
                        ("cond", "cond"), ("bogus", "queue")):
        monkeypatch.setenv("ZWRT_TRAV", value)
        assert ttrace.walk_of(per_kind) == walk
        assert ttrace.walk_of(uni) == "uni"  # the unified tree wins, as in JAX


def test_closest_hit_refuses_bad_walks(big_scene):
    per_kind, _, rays = big_scene
    with pytest.raises(ValueError, match="unknown tree walk"):
        ttrace.closest_hit(per_kind, *rays, 1e-3, walk="bogus")
    with pytest.raises(ValueError, match="unified tree"):
        ttrace.closest_hit(per_kind, *rays, 1e-3, walk="uni")


def test_probe_keeps_the_default_walk(monkeypatch, big_scene):
    """The closest-hit kernel's plain version walks the per-kind trees with
    the default walk whatever ZWRT_TRAV says, as the TPU's _tree_kernel."""
    _, uni, rays = big_scene
    monkeypatch.setenv("ZWRT_TRAV", "spec")
    with workcount.counting() as c:
        hit = ch.closest_hit(uni, *rays, 1e-3)
    ref, c_ref = _trace(uni, rays, "cond")
    assert dict(c) == c_ref
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)


def test_walk_args_and_queue_capacity(monkeypatch, big_scene):
    """The launch's walk, its code and its leaf queue, read at each launch:
    QUEUE_CAP entries per thread in shared memory and no device queue for
    queue; per thread in device memory for the queue walk's first design,
    spec and uni (lane-major, every thread of the launch's blocks; uni's over
    the unified tree's nodes), per warp in shared memory for rowqueue, none
    for cond."""
    per_kind, uni, _ = big_scene
    n_s, n_q = per_kind.sph_tree_box.shape[0], per_kind.quad_tree_box.shape[0]
    cap = (max(n_s, n_q) + 1) // 2 + 1  # a skip-link tree's most leaves, plus one
    u_cap = (uni.uni_tree_box.shape[0] + 1) // 2 + 1
    for value, code in (("queue", 1), ("rowqueue", 2), ("spec", 3), ("cond", 0), (None, 1)):
        if value is None:
            monkeypatch.delenv("ZWRT_TRAV", raising=False)
        else:
            monkeypatch.setenv("ZWRT_TRAV", value)
        walk, got_code, got_cap, queue = fused_render.walk_args(per_kind, 300)
        assert got_code == code == ttrace.WALKS.index(walk)
        if walk == "queue":
            assert (got_cap, queue) == (ttrace.QUEUE_CAP, None)
            _, _, got_cap, queue = fused_render.walk_args(per_kind, 300, first=True)
            assert got_cap == cap and queue.dtype == torch.int32 and queue.numel() == cap * 384
        else:
            assert got_cap == (cap if walk in ("rowqueue", "spec") else 0)
        if walk == "spec":
            assert queue.dtype == torch.int32 and queue.numel() == cap * 384
        elif walk != "queue":
            assert queue is None
        walk, got_code, got_cap, queue = fused_render.walk_args(uni, 300)
        assert (walk, got_code, got_cap) == ("uni", 4, u_cap)
        assert queue.dtype == torch.int32 and queue.numel() == u_cap * 384


def test_walk_args_refuses_queues_that_do_not_fit(monkeypatch, big_scene):
    per_kind, _, _ = big_scene
    monkeypatch.setenv("ZWRT_TRAV", "queue")
    with pytest.raises(ValueError, match="32-bit queue index"):
        fused_render.walk_args(per_kind, 2**31 // 8, first=True)
    monkeypatch.setenv("ZWRT_TRAV", "rowqueue")
    cap = fused_render.queue_capacity(per_kind, "rowqueue")
    monkeypatch.setattr(fused_render, "SMEM_LIMIT", 4 * cap * 8 - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_render.walk_args(per_kind, 128)


def test_trace_args_carry_the_unified_tree(big_scene):
    _, uni, _ = big_scene
    ints, ptrs, tables = fused_render.trace_args(uni)
    n_u = uni.uni_tree_box.shape[0]
    assert list(ints[9:]) == [n_u, uni.uni_leaf_span] and len(ptrs) == 14
    assert (ptrs != 0).all()
    box, link, s_tab, s_oi, q_tab, q_oi = tables[-6:]
    assert box.shape == (n_u, 6) and link.shape == (n_u, 3)
    assert s_tab.shape == (uni.uni_sph_attrs[0].shape[0], 8)
    assert q_tab.shape == (uni.uni_quad_attrs[0].shape[0], 16)
    assert torch.equal(s_oi, uni.uni_sph_attrs[-1]) and torch.equal(q_oi, uni.uni_quad_attrs[-1])
    assert torch.equal(q_tab[:, 12], uni.uni_quad_attrs[12]) and (q_tab[:, 13:] == 0).all()
