"""The redesigned queue walk of the PyTorch port, the default tree walk
(kernel K4a: ``csrc/zwrt_device.cuh:tree_walk_queue``), through its plain
version on the CPU.

  1. The plain queue walk (``ops/trace.py``: each lane culls with its
     running t, queues at most ``QUEUE_CAP`` hit leaves in preorder and
     sweeps them when the queue is full or its walk has ended) gives hits
     (t, kind, idx) bitwise the cond walk's, on rtw_final's 64x64 camera
     rays and on 4,000 seeded random rays of a scene of 100 spheres and
     600 quads, at leaf spans 1 and 2, with every lane walking and with
     every other lane dead.  Tolerance: none, bitwise.
  2. Its work counts (``slab_test``, ``leaf_visit``) are bracketed: at a
     capacity of 1 they are the cond walk's exactly (each hit leaf is swept
     before the next node test), at a capacity of the tree's leaves those
     of the whole walk with the seed t exactly (as at the capacity of a
     device queue that holds every leaf, ``queue_capacity``), and at
     ``QUEUE_CAP`` between the two.  Exact counts.
  3. ``QUEUE_CAP``, the launchers' thread count and their blocks a SM at
     most equal the headers' constants, read out of ``csrc/``.
  4. ``walk_args`` gives the queue walk no device queue, only its
     ``QUEUE_SMEM_BYTES`` of shared memory a block (refused past
     ``SMEM_LIMIT``); ``node_args`` builds the packed node tables for
     queue.
  5. The walk codes a launch passes are the header's, and on a scene
     without trees every walk but uni traces the cond walk's brute stages
     (hits and counts bitwise), which is what lets the kernels launch one
     tree-less instantiation (``kWalkNoTree``) for all of them.

The CUDA walk is held against this plain version on the card by
chip_smoke.py (phases 17 and 18).
"""

import os
import re

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
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "zig_weekend_raytracer_tpu_torch", "csrc", "zwrt_device.cuh")


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
    """{(name, span, lanes, form): (hit, work counts)}, each traced once."""
    return {}


def _leaves(cs):
    """The most leaves of either per-kind tree."""
    return max(int((getattr(cs, f"{k}_tree_link")[:, 1] >= 0).sum()) for k in ("sph", "quad"))


def _trace(cases, traced, name, span, lanes, form):
    """``form``: "cond", or a capacity of the queue walk: "1", "cap" for
    QUEUE_CAP, "leaves" for the tree's leaves, "device" for a device queue
    that holds every leaf ((n_nodes + 1) // 2 + 1 of the larger tree)."""
    key = (name, span, lanes, form)
    if key not in traced:
        cs, rays = cases[(name, span)]
        n = rays[2].shape[0]
        active = None if lanes == "all" else torch.arange(n) % 2 == 1
        cap = {"1": 1, "cap": ttrace.QUEUE_CAP, "leaves": _leaves(cs),
               "device": fused_render.queue_capacity(cs, "spec")}.get(form)
        with workcount.counting() as c:
            if form == "cond":
                hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, active=active, walk="cond")
            else:
                hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, active=active,
                                         walk="queue", queue_cap=cap)
        traced[key] = (hit, dict(c))
    return traced[key]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_queue_hits_are_the_cond_walks(cases, traced, name, span, lanes):
    ref, _ = _trace(cases, traced, name, span, lanes, "cond")
    hit, _ = _trace(cases, traced, name, span, lanes, "cap")
    n = ref.kind.shape[0]
    assert int((ref.kind >= 0).sum()) > n // (4 if lanes == "all" else 8)
    assert {0, 1} <= set(ref.kind.tolist())
    if lanes != "all":
        assert (ref.kind[::2] == ttrace.NO_HIT).all()
    for got, want in zip(hit, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["1", "cap", "leaves"])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["rtw_final", "random"])
def test_queue_counts_are_bracketed(cases, traced, name, span, lanes, form):
    """Capacity 1 sweeps each hit leaf before the next node test, as the
    cond walk does; a capacity that holds every leaf never sweeps before
    the walk's end, so the whole walk culls with the seed t, whatever the
    capacity past the leaves; QUEUE_CAP lies between.  Every form's hits
    are the cond walk's."""
    cond, c_cond = _trace(cases, traced, name, span, lanes, "cond")
    seed_t, c_seed = _trace(cases, traced, name, span, lanes, "device")
    hit, c = _trace(cases, traced, name, span, lanes, form)
    for got, want in zip(hit, cond):
        assert torch.equal(got, want)
    for got, want in zip(seed_t, cond):
        assert torch.equal(got, want)
    keys = ("slab_test", "leaf_visit", "sphere_test", "quad_test")
    if form == "1":
        assert {k: c[k] for k in keys} == {k: c_cond[k] for k in keys}
    elif form == "leaves":
        assert {k: c[k] for k in keys} == {k: c_seed[k] for k in keys}
    else:
        for k in ("slab_test", "leaf_visit"):
            assert c_cond[k] <= c[k] <= c_seed[k], k
        # on these rays the queue's sweeps do cull: fewer leaves than the
        # whole walk with the seed t, more than the cond walk
        assert c_cond["leaf_visit"] < c["leaf_visit"] < c_seed["leaf_visit"]


def _header_int(name, header=HEADER):
    with open(header) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, name
    return int(m.group(1))


def test_queue_cap_equals_the_headers():
    """The Python mirrors of the headers' constants: the queue walk's
    capacity, the launchers' threads a block and blocks a SM at most, and
    the rowqueue walk's staged-node budget."""
    assert ttrace.QUEUE_CAP == _header_int("kQueueCap")
    assert fused_render.THREADS == _header_int("kThreads")
    assert fused_render.ROWQUEUE_NODE_BYTES == _header_int("kRowQueueNodeBytes")
    assert fused_render.QUEUE_SMEM_BYTES == ttrace.QUEUE_CAP * fused_render.THREADS * 4
    kernels = os.path.join(os.path.dirname(HEADER), "render_kernels.cuh")
    assert fused_render.MAX_BLOCKS_PER_SM == _header_int("kMaxBlocksPerSM", kernels)


def test_walk_args_gives_queue_no_device_queue(cases, monkeypatch):
    """The queue walk keeps QUEUE_CAP entries a thread in shared memory: no
    device queue at any lane count, and a launch refused where the queues
    do not fit beside the staged tables."""
    monkeypatch.setenv("ZWRT_TRAV", "queue")
    cs, _ = cases[("rtw_final", 1)]
    for n in (1, 1000, 160_000, 2**31 // 8):
        assert fused_render.walk_args(cs, n) == ("queue", 1, ttrace.QUEUE_CAP, None)
    room = fused_render.SMEM_LIMIT - fused_render.QUEUE_SMEM_BYTES
    assert fused_render.walk_args(cs, 1000, room)[3] is None
    with pytest.raises(ValueError, match=f"{ttrace.QUEUE_CAP} leaf entries per thread"):
        fused_render.walk_args(cs, 1000, room + 1)
    # a scene without trees keeps no queue at all
    cornell = zt.models.load_scene("cornell_box", device="cpu").compiled
    assert not (cornell.has_sph_tree or cornell.has_quad_tree)
    assert fused_render.walk_args(cornell, 1000, fused_render.SMEM_LIMIT)[3] is None


def test_node_args_builds_packed_tables_for_queue():
    cs = _with_env(_random_scene, ZWRT_LEAF_GROUPS=2)
    fused_render._NODE_CACHE.pop(cs, None)
    ptrs, tables = fused_render.node_args(cs, "queue")
    assert cs in fused_render._NODE_CACHE
    assert fused_render.node_args(cs, "rowqueue")[1] is tables
    assert ptrs.dtype == np.uint64 and ptrs.shape == (3,)
    assert (ptrs[:2] != 0).all() and ptrs[2] == 0 and len(tables) == 2
    for t, tree in zip(tables, ("sph", "quad")):
        want = fused_render.pack_nodes(getattr(cs, f"{tree}_tree_box"),
                                       getattr(cs, f"{tree}_tree_link"))
        assert torch.equal(t.view(torch.int32), want.view(torch.int32))


def test_walk_codes_equal_the_headers():
    """A launch passes ``WALKS.index(walk)`` (``walk_args``): the header's
    Walk enum numbers the walks in that order, and its compile-time-only
    walk (``kWalkNoTree``) comes after them."""
    with open(HEADER) as f:
        codes = {k: int(v) for k, v in re.findall(r"\b(kWalk\w+) = (\d+)", f.read())}
    names = {"cond": "kWalkCond", "queue": "kWalkQueue", "rowqueue": "kWalkRowQueue",
             "spec": "kWalkSpec", "uni": "kWalkUni"}
    assert [codes[names[w]] for w in ttrace.WALKS] == list(range(len(ttrace.WALKS)))
    rest = sorted(v for k, v in codes.items() if k not in names.values())
    assert "kWalkNoTree" in codes and rest == list(range(len(ttrace.WALKS), len(codes)))


def test_walk_enum_is_walks_then_no_tree():
    """The header's Walk enum, read in its order, is ``WALKS`` and then
    ``kWalkNoTree``, numbered from 0, with no other code: every walk has
    one design."""
    with open(HEADER) as f:
        body = re.search(r"enum Walk \{([^}]*)\};", f.read())
    assert body
    enum = re.findall(r"\b(kWalk\w+) = (\d+)", body.group(1))
    names = ["kWalk" + {"rowqueue": "RowQueue"}.get(w, w.capitalize()) for w in ttrace.WALKS]
    assert [k for k, _ in enum] == names + ["kWalkNoTree"]
    assert [int(v) for _, v in enum] == list(range(len(ttrace.WALKS) + 1))


@pytest.mark.parametrize("walk", ttrace.WALKS)
def test_phase_profile_flags(walk):
    """``check_flags``: the phase profile exists for cond and queue only,
    and never with the estimator options."""
    if walk in ("cond", "queue"):
        fused_render.check_flags(walk, fused_render.FLAG_PROF)
    else:
        with pytest.raises(ValueError, match="no phase profile"):
            fused_render.check_flags(walk, fused_render.FLAG_PROF)
    with pytest.raises(ValueError, match="Russian roulette"):
        fused_render.check_flags(walk, fused_render.FLAG_PROF | fused_render.FLAG_ESTIMATOR)
    fused_render.check_flags(walk, fused_render.FLAG_ESTIMATOR)
    fused_render.check_flags(walk, 0)


@pytest.fixture(scope="module")
def treeless():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    cs = scene.compiled
    assert not (cs.has_sph_tree or cs.has_quad_tree or cs.has_uni_tree)
    return cs, _camera_rays(scene, 32)


@pytest.mark.parametrize("walk", ["queue", "rowqueue", "spec"])
def test_treeless_scene_traces_alike_under_every_walk(treeless, walk):
    cs, rays = treeless
    out = {}
    for w in ("cond", walk):
        with workcount.counting() as c:
            out[w] = (ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk=w), dict(c))
    for got, want in zip(out[walk][0], out["cond"][0]):
        assert torch.equal(got, want)
    assert out[walk][1] == out["cond"][1]
    assert "slab_test" not in out[walk][1] and out[walk][1]["sphere_test"] > 0
    assert int((out[walk][0].kind >= 0).sum()) > 32 * 32 // 2
