"""Group trees and the AABB slab test of the PyTorch port against the JAX
package.

The tree build is host numpy on both sides, so node boxes, links, leaf-slot
attributes and spans must be equal exactly whenever ``ZWRT_LEAF_GROUPS``
sets the span (the pin every JAX-parity test rests on): for balls at the
port's default span (the JAX package built at that span), at this suite's
span 4 and at span 2, for balls and rtw_final at spans 1, 8, 32 and 64,
and for the random scenes of tests/test_pallas.py:57-64.  Unset, the port
takes its own span policy, the JAX package its own.  ``aabb_hit`` must
give JAX's verdicts, including rays with a zero direction component whose
origin lies on a box face, where 0 * inf = NaN fails the test on both
sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.geometry import bvh as jbvh
from zig_weekend_raytracer_tpu.math import aabb as jaabb
from zig_weekend_raytracer_tpu.math import interval as jinterval
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops.pallas_trace import pick_leaf_span as j_pick_leaf_span
from zig_weekend_raytracer_tpu_torch.geometry import bvh as tbvh
from zig_weekend_raytracer_tpu_torch.math import aabb as taabb
from zig_weekend_raytracer_tpu_torch.math import interval as tinterval
from zig_weekend_raytracer_tpu_torch.math.v3 import V3 as TV3

# tests/test_pallas.py:57-64: (seed, spheres, quads, moving)
RANDOM_SCENES = [
    (0, 100, 70, False), (1, 100, 70, True), (2, 70, 10, False),
    (3, 5, 70, False), (4, 40, 20, False), (5, 9, 0, False),
]


def random_scene(mod, seed, n_s, n_q, moving=False):
    """tests/test_pallas.py:_random_scene built with ``mod``'s builder;
    returns the compiled scene and the rng, positioned for the rays."""
    rng = np.random.default_rng(seed)
    b = mod.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for i in range(n_s):
        c = rng.uniform(-10, 10, 3)
        r = rng.uniform(0.2, 1.5)
        if moving and i % 3 == 0:
            b.add(b.moving_sphere(c, c + rng.uniform(-1, 1, 3), r, mat))
        else:
            b.add(b.sphere(c, r, mat))
    for _ in range(n_q):
        b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), mat))
    b.use_bvh(True, min_prims=2)
    b.set_camera(mod.scene.Camera(look_from=(0, 0, 30), look_at=(0, 0, 0)))
    return b.compile(**({"device": "cpu"} if mod is zt else {})).compiled, rng


def assert_same_trees(ct, cj):
    for kind in ("sph", "quad"):
        for f in ("has_{}_tree", "{}_leaf_span"):
            f = f.format(kind)
            assert getattr(ct, f) == getattr(cj, f), f
        if not getattr(cj, f"has_{kind}_tree"):
            assert getattr(ct, f"{kind}_tree_attrs") == ()
            continue
        for f in ("box", "link"):
            got = getattr(ct, f"{kind}_tree_{f}").numpy()
            want = np.asarray(getattr(cj, f"{kind}_tree_{f}"))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {f}")
        attrs_t, attrs_j = getattr(ct, f"{kind}_tree_attrs"), getattr(cj, f"{kind}_tree_attrs")
        assert len(attrs_t) == len(attrs_j) == (8 if kind == "sph" else 14)
        for a_t, a_j in zip(attrs_t, attrs_j):
            a_j = np.asarray(a_j)
            assert a_t.numpy().dtype == a_j.dtype
            np.testing.assert_array_equal(a_t.numpy(), a_j)


@pytest.mark.parametrize("span", [None, "4", "2"])
def test_balls_trees_equal_jax(monkeypatch, span):
    """None: the port's default span, the JAX package built at it."""
    if span is None:
        monkeypatch.delenv("ZWRT_LEAF_GROUPS", raising=False)
    else:
        monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    ct = zt.models.load_scene("balls", device="cpu").compiled
    if span is None:
        assert ct.sph_leaf_span == tbvh.pick_leaf_span(485) == 1
        monkeypatch.setenv("ZWRT_LEAF_GROUPS", str(ct.sph_leaf_span))
    assert_same_trees(ct, zj.models.load_scene("balls").compiled)
    assert ct.has_sph_tree and not ct.has_quad_tree
    n_nodes = ct.sph_tree_box.shape[0]
    assert (n_nodes == 121) if span is None else (n_nodes > 3)


@pytest.mark.parametrize("span", ["1", "8", "32", "64"])
def test_trees_equal_jax_whenever_the_span_is_set(monkeypatch, span):
    """The per-kind trees of balls and rtw_final, and rtw_final's unified
    tree, equal the JAX package's at any span ZWRT_LEAF_GROUPS sets."""
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    for name in ("balls", "rtw_final"):
        ct = zt.models.load_scene(name, device="cpu").compiled
        assert ct.sph_leaf_span == int(span)
        assert_same_trees(ct, zj.models.load_scene(name).compiled)
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    ct = zt.models.load_scene("rtw_final", device="cpu").compiled
    cj = zj.models.load_scene("rtw_final").compiled
    assert ct.uni_leaf_span == cj.uni_leaf_span == int(span)
    for f in ("uni_tree_box", "uni_tree_link"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)))


@pytest.mark.parametrize("seed,n_s,n_q,moving", RANDOM_SCENES)
@pytest.mark.parametrize("span", ["2", "4"])
def test_random_scene_trees_equal_jax(monkeypatch, span, seed, n_s, n_q, moving):
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    ct, _ = random_scene(zt, seed, n_s, n_q, moving)
    cj, _ = random_scene(zj, seed, n_s, n_q, moving)
    assert_same_trees(ct, cj)
    assert ct.has_sph_tree == (n_s >= 64) and ct.has_quad_tree == (n_q >= 64)


def test_build_group_tree_and_prim_boxes_equal_jax():
    rng = np.random.default_rng(3)
    c = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, 50).astype(np.float32)
    mv = np.where(rng.uniform(size=(50, 1)) < 0.3, rng.uniform(-1, 1, (50, 3)), 0).astype(np.float32)
    qs = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    qu = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    qv = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    qu[:5, 1] = qv[:5, 1] = 0.0  # flat in y: padded axis
    got, want = tbvh._prim_bboxes(c, r, mv, qs, qu, qv), jbvh._prim_bboxes(c, r, mv, qs, qu, qv)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for leaf_groups in (1, 2, 3):
        tt = tbvh.build_group_tree(got[2], got[3], leaf_groups=leaf_groups)
        tj = jbvh.build_group_tree(want[2], want[3], leaf_groups=leaf_groups)
        for k in ("node_box", "node_link", "prim_slots"):
            np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 64, 300, 512, 513, 5000])
def test_pick_leaf_span_equals_jax(monkeypatch, n):
    """Set, ZWRT_LEAF_GROUPS gives both packages the same span; unset, the
    port sizes leaves for one thread's walk (one group up to 4,096
    primitives, then two) where the JAX package takes 64 or 32."""
    monkeypatch.delenv("ZWRT_LEAF_GROUPS", raising=False)
    assert tbvh.pick_leaf_span(n) == (1 if n <= tbvh.SMALL_SPAN_MAX_PRIMS else 2)
    assert j_pick_leaf_span(n) == (64 if n <= 512 else 32)
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "3")
    assert tbvh.pick_leaf_span(n) == j_pick_leaf_span(n) == 3


def _v3(a):
    a = np.asarray(a, np.float32)
    return (
        JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
        TV3(*(torch.from_numpy(a[:, i].copy()) for i in range(3))),
    )


def test_aabb_hit_equals_jax_with_axis_parallel_rays():
    rng = np.random.default_rng(4)
    n = 4096
    lo = rng.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 3)).astype(np.float32)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # a quarter of the rays run parallel to an axis plane, half of those
    # with their origin on a face of the box (0 * inf = NaN in the test)
    axis = rng.integers(0, 3, n)
    par = np.arange(n) < n // 4
    d[par, axis[par]] = 0.0
    on_face = par & (np.arange(n) % 2 == 0)
    org[on_face, axis[on_face]] = lo[on_face, axis[on_face]]
    t_max = rng.uniform(0.5, 10, n).astype(np.float32)
    (loj, lot), (hij, hit_), (oj, ot) = _v3(lo), _v3(hi), _v3(org)
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    ij, it = _v3(inv)
    hj = np.asarray(jaabb.aabb_hit(loj, hij, oj, ij, np.float32(1e-3), jnp.asarray(t_max)))
    ht = taabb.aabb_hit(lot, hit_, ot, it, 1e-3, torch.from_numpy(t_max)).numpy()
    np.testing.assert_array_equal(ht, hj)
    assert ht.any() and not ht.all()
    assert not ht[on_face].any()  # NaN slabs miss on both sides


def test_aabb_host_helpers_and_interval_equal_jax():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(-1, 1, (2, 3)), rng.uniform(-1, 1, (2, 3))
    a[0, 1] = a[1, 1] = 0.25  # a degenerate axis
    for got, want in zip(taabb.aabb_pad_to_minimum(a[0], a[1]), jaabb.aabb_pad_to_minimum(a[0], a[1])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(taabb.aabb_union(*a, *b), jaabb.aabb_union(*a, *b)):
        np.testing.assert_array_equal(got, want)
    assert taabb.aabb_longest_axis(a[0], b[1]) == jaabb.aabb_longest_axis(a[0], b[1])

    x = rng.uniform(-2, 2, 64).astype(np.float32)
    ti = tinterval.Interval(torch.tensor(-0.5), torch.tensor(1.0))
    ji = jinterval.Interval(jnp.float32(-0.5), jnp.float32(1.0))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for name in ("contains", "surrounds", "clamp"):
        np.testing.assert_array_equal(getattr(ti, name)(xt).numpy(), np.asarray(getattr(ji, name)(xj)))
    u_t, u_j = ti.union(tinterval.INTERVAL_01).expand(0.5).offset(1.0), ji.union(jinterval.INTERVAL_01).expand(0.5).offset(1.0)
    assert float(u_t.min) == float(u_j.min) and float(u_t.max) == float(u_j.max)
    assert float(u_t.size()) == float(u_j.size())
