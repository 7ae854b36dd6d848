"""The closest-hit kernel's module: ``ops/closest_hit.py:closest_hit`` on
CPU tensors (its plain version, ``ops/trace.py:closest_hit``) against the
JAX package, on the random scenes of tests/test_pallas.py:57-64 with 640
rays: sphere tree + brute quads, brute spheres + quad tree, both trees,
both brute, moving spheres, a non-multiple-of-8 table.

  * against ``closest_hit_pallas``, whose Pallas kernels run in interpret
    mode, at leaf span 2 (multi-node trees);
  * against ``_closest_hit_brute`` (XLA) at spans 2 and 4 and at the
    package default span.

Bar (tests/test_pallas.py:78-86): kind and idx equal on every ray, miss
or hit equal, and t within rtol 3e-4 / atol 1e-3 where it is finite (near-
tangent hits amplify float32 cancellation in the sphere discriminant
between differently fused compilations).  Dead rays report no hit.  The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py; here, without a GPU, its entry point must refuse rather than
fall back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops.trace import _closest_hit_brute
from zig_weekend_raytracer_tpu_torch.math.v3 import V3 as TV3
from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace

from test_torch_bvh import RANDOM_SCENES, random_scene

N_RAYS = 640  # not a multiple of the JAX kernel's 1024-ray tile


def _case(seed, n_s, n_q, moving):
    """(JAX scene, port scene, JAX rays, port rays) with the rays of
    tests/test_pallas.py:_random_rays and uniform times."""
    cj, rng = random_scene(zj, seed, n_s, n_q, moving)
    ct, _ = random_scene(zt, seed, n_s, n_q, moving)
    org = rng.uniform(-15, 15, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    tm = rng.uniform(0, 1, N_RAYS).astype(np.float32)
    J = lambda a: JV3(*(jnp.asarray(a[:, i]) for i in range(3)))
    T = lambda a: TV3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
    return cj, ct, (J(org), J(d), jnp.asarray(tm)), (T(org), T(d), torch.from_numpy(tm))


def _port_hit(ct, rays_t, **kw):
    launches = ch.closest_hit.launches
    hit = ch.closest_hit(ct, *rays_t, 1e-3, **kw)
    assert ch.closest_hit.launches == launches  # CPU tensors launch nothing
    assert hit.t.dtype == torch.float32 and hit.kind.dtype == hit.idx.dtype == torch.int32
    return hit


def _assert_same(hit_t, t_j, kind_j, idx_j):
    np.testing.assert_array_equal(hit_t.kind.numpy(), np.asarray(kind_j))
    np.testing.assert_array_equal(hit_t.idx.numpy(), np.asarray(idx_j))
    tt, tj = hit_t.t.numpy(), np.asarray(t_j)
    finite = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(tt), finite)
    np.testing.assert_allclose(tt[finite], tj[finite], rtol=3e-4, atol=1e-3)


# sphere tree + brute quads, brute spheres + quad tree, both trees with
# moving spheres, both brute
PALLAS_CASES = [RANDOM_SCENES[i] for i in (2, 3, 1, 4)]


@pytest.mark.parametrize("seed,n_s,n_q,moving", PALLAS_CASES)
def test_closest_hit_matches_pallas_kernels(pallas_interpret, monkeypatch, seed, n_s, n_q, moving):
    from zig_weekend_raytracer_tpu.ops.pallas_trace import closest_hit_pallas

    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "2")
    cj, ct, rays_j, rays_t = _case(seed, n_s, n_q, moving)
    assert ct.has_sph_tree == (n_s >= 64) and ct.has_quad_tree == (n_q >= 64)
    _assert_same(_port_hit(ct, rays_t), *closest_hit_pallas(cj, *rays_j, 1e-3))


@pytest.mark.parametrize("seed,n_s,n_q,moving", RANDOM_SCENES)
@pytest.mark.parametrize("span", ["2", "4", None])
def test_closest_hit_matches_brute(monkeypatch, span, seed, n_s, n_q, moving):
    if span is None:
        monkeypatch.delenv("ZWRT_LEAF_GROUPS", raising=False)
    else:
        monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    cj, ct, rays_j, rays_t = _case(seed, n_s, n_q, moving)
    ref = _closest_hit_brute(cj, *rays_j, np.float32(1e-3), jnp.inf)
    _assert_same(_port_hit(ct, rays_t), ref.t, ref.kind, ref.idx)


def test_dead_rays_report_no_hit(monkeypatch):
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "2")
    _, ct, _, rays_t = _case(0, 100, 70, False)
    active = torch.arange(N_RAYS) % 3 != 0
    full = _port_hit(ct, rays_t)
    part = _port_hit(ct, rays_t, active=active)
    dead = ~active
    assert (part.kind[dead] == -1).all() and torch.isinf(part.t[dead]).all()
    assert (part.idx[dead] == 0).all()
    assert (full.kind[dead] >= 0).any()  # they would have hit
    for a, b in zip(part, full):
        assert torch.equal(a[active], b[active])


def test_t_max_bounds_the_search(monkeypatch):
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "2")
    _, ct, _, rays_t = _case(0, 100, 70, False)
    full = _port_hit(ct, rays_t)
    near = _port_hit(ct, rays_t, t_max=10.0)
    keep = full.t < 10.0
    assert keep.any() and (~keep & (full.kind >= 0)).any()
    for a, b in zip(near, full):
        assert torch.equal(a[keep], b[keep])
    assert (near.kind[~keep] == -1).all()


def test_closest_hit_refuses_without_gpu_and_other_devices(monkeypatch):
    """On this CPU-only host a CUDA call raises and nothing traces on the
    CPU in its place; other devices raise too."""
    _, ct, _, _ = _case(4, 40, 20, False)
    calls = []
    monkeypatch.setattr(ttrace, "closest_hit", lambda *a, **k: calls.append(1))
    launches = ch.closest_hit.launches
    meta = TV3(*(torch.zeros(4, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ch.closest_hit(ct, meta, meta, torch.zeros(4, device="meta"), 1e-3)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cuda = TV3(*(torch.zeros(4, device="cuda") for _ in range(3)))
            ch.closest_hit(ct, cuda, cuda, torch.zeros(4, device="cuda"), 1e-3)
    assert ch.closest_hit.launches == launches and not calls


def test_trace_args_of_tree_scenes(monkeypatch):
    """The kernels' trace tables: a tree kind passes its node boxes, links,
    a leaf-slot row table (8 sphere or 16 quad columns) and the slots'
    original indices, cached per scene; a scene without the unified tree
    passes no node and null pointers for it."""
    from zig_weekend_raytracer_tpu_torch.ops import fused_render

    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "2")
    _, ct, _, _ = _case(0, 100, 70, False)
    ints, ptrs, tables = fused_render.trace_args(ct)
    assert fused_render.trace_args(ct) is fused_render.trace_args(ct)
    n_sph, n_quad = ct.sph_tree_box.shape[0], ct.quad_tree_box.shape[0]
    tree = fused_render.TRACE_TREE
    assert list(ints) == [tree, 100, n_sph, 2, tree, 70, n_quad, 2, 0, 0, 2]
    assert (ptrs[:8] != 0).all() and (ptrs[8:] == 0).all() and len(ptrs) == 14
    sph_tab, sph_box, sph_link, sph_oi, quad_tab, *_ = tables
    assert sph_tab.shape == (ct.sph_tree_attrs[0].shape[0], 8)
    assert quad_tab.shape == (ct.quad_tree_attrs[0].shape[0], 16)
    assert torch.equal(sph_tab[:, 3], ct.sph_tree_attrs[3]) and (sph_tab[:, 7] == 0).all()
    assert torch.equal(sph_oi, ct.sph_tree_attrs[-1]) and sph_oi.dtype == torch.int32
    assert sph_box.shape == (n_sph, 6) and sph_link.shape == (n_sph, 2)
