"""The image-texture slice in the PyTorch port on the CPU, against the JAX
package: decode, the atlas fetch, one bounce, and full renders of
shrek_quads (brute quads, quad UVs), earth (brute spheres, sphere UVs, a
checker ground) and rtw_final (group trees of both kinds, two images,
instancing, a quad light, fuzzy metal).

  1. stb_image decode equal to the JAX package's byte for byte; a missing
     path gives magenta, an undecodable file raises.
  2. ``atlas_flat_index`` / ``atlas_lookup`` bitwise equal to JAX's,
     including u and v outside [0, 1] and exactly on texel edges.
  3. One bounce of 1,024 seeded rays at depths 0 and 1: the port's plain
     ``bounce`` against JAX's ``bounce_pallas`` in interpret mode followed
     by the atlas multiply of ``integrator.py:394-396``, within rtol 3e-5 /
     atol 3e-6 (the texel multiplies in at another place: reassociation),
     and against the JAX XLA integrator's bounce within rtol 1e-5 / atol
     1e-6.  alive equal, except on earth's texel-boundary lanes (< 2%):
     the JAX kernel's polynomial acos/atan2 pick a neighbouring texel
     there (tests/test_pallas.py:127-152).  On earth's sphere hits the new
     origins and directions agree to 2e-4 of their length (see the test).
  4. Renders: against JAX's Pallas-interpret render (the bounce kernel)
     at 16x16, 2 spp, depth 3 for shrek_quads and earth, and at 16x16,
     4 spp, depth 5 for the synthetic tree-and-image scene of
     tests/test_pallas.py:345-361 (the scene where JAX's K-slot atlas chain
     engages), within rtol 3e-5 / atol 3e-6; earth under the texel
     allowance of tests/test_pallas.py:149-152; rtw_final against JAX's
     XLA render at 8x8, 2 spp, depth 3.  The jitted JAX renders contract
     multiply-adds (camera rays, light PDFs) where the port rounds each
     product, as ROADMAP Queue 3 records for cornell: SHREK_EDGE_PIXELS
     are camera rays along quad edges that hit or miss differently, and
     rtw_final's light-sampled lanes move by up to 1e-3 relative.  The
     witness test holds the port to the eager (unfused) JAX chain on the
     same rays, lane for lane.
  5. Plans: the sorted (shrek_quads) and coherent (synthetic tree scene)
     plans give the plain render's image within rtol 2e-5 / atol 2e-6.
  6. A scene carried with ``compiled_from_arrays`` renders as compiled.

The 64x64 goldens and 200x200 region gates of the three scenes run on the
card in chip_smoke.py: the plain CPU path is too slow for them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu import textures as jtex
from zig_weekend_raytracer_tpu.io.image import load_image as j_load_image
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops import pallas_bounce
from zig_weekend_raytracer_tpu.ops.trace import _use_pallas_backend
from zig_weekend_raytracer_tpu.render.integrator import trace_paths as j_trace_paths
from zig_weekend_raytracer_tpu_torch import textures as ttex
from zig_weekend_raytracer_tpu_torch.io import image as timage
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import bounce as tbounce
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.scene import ARRAY_FIELDS, STATIC_FIELDS, compiled_from_arrays

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
RTOL, ATOL = 3e-5, 3e-6          # kernel chain vs XLA order: reassociation
XLA_RTOL, XLA_ATOL = 1e-5, 1e-6  # the port's order is the XLA integrator's
# (x, y) of shrek_quads 16x16 pixels whose camera rays run along quad
# edges: the jitted JAX render's contracted camera rays decide them
# differently (test_render_matches_eager_jax_chain is the witness)
SHREK_EDGE_PIXELS = ((13, 3), (14, 5), (6, 13))


@pytest.fixture(scope="module")
def scenes():
    return {
        name: (zj.models.load_scene(name), zt.models.load_scene(name, device="cpu"))
        for name in ("shrek_quads", "earth")
    }


# ---- 1. decode ----

@pytest.mark.parametrize("name", ["earth.png", "wap.jpg", "me.jpg"])
def test_decode_equals_jax(name):
    path = os.path.join(ASSETS, name)
    got, want = timage.load_image(path), j_load_image(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_missing_image_is_magenta_and_bad_file_raises(tmp_path):
    np.testing.assert_array_equal(
        timage.load_image(str(tmp_path / "missing.png")), [[[255, 0, 255]]]
    )
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="cannot decode"):
        timage.load_image(str(bad))


# ---- 2. the atlas fetch ----

def _two_image_scenes():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (5, 7, 3), np.uint8), rng.integers(0, 256, (9, 4, 3), np.uint8)]

    def build(mod, **kw):
        b = mod.scene.SceneBuilder()
        for i, im in enumerate(imgs):
            b.add(b.sphere((3 * i, 0, 0), 1.0, b.lambertian(b.image_texture(im))))
        return b.compile(**kw).compiled

    return build(zj), build(zt, device="cpu")


def _uv_cases(n=4096):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 2, n).astype(np.int32)
    u = rng.uniform(-0.3, 1.3, n).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, n).astype(np.float32)
    # exactly on texel edges of either image, and the clamp limits
    edges = np.concatenate([np.arange(8) / 7.0, np.arange(10) / 9.0, np.arange(5) / 4.0,
                            [0.0, 1.0, -0.0, np.nextafter(1, 0), np.nextafter(0, 1)]])
    u[: edges.size] = edges
    v[edges.size: 2 * edges.size] = edges
    v[: edges.size] = edges[::-1]
    return img, u, v


def test_atlas_fetch_bitwise():
    cj, ct = _two_image_scenes()
    assert ct.image_dims == cj.image_dims == ((7, 5), (4, 9))
    img, u, v = _uv_cases()
    _, ah, aw = ct.atlas_packed.shape
    flat_j = np.asarray(jtex.atlas_flat_index(cj.image_dims, (ah, aw), jnp.asarray(img),
                                              jnp.asarray(u), jnp.asarray(v)))
    flat_t = ttex.atlas_flat_index(ct.image_dims, (ah, aw), torch.from_numpy(img),
                                   torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    rgb_j = jtex.atlas_lookup(cj, jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    rgb_t = ttex.atlas_lookup(ct, torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(rgb_t, rgb_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- 3. one bounce ----

def _seeded_rays(name, n=1024):
    """Rays from around the scene's camera toward its subject, with random
    throughput, radiance, ray ids, times and ~90% alive."""
    rng = np.random.default_rng(5)
    eye, at = {"shrek_quads": ((0, 0, 9), (0, 0, 0)), "earth": ((13, 3, 3), (0, 2, 0))}[name]
    o = np.asarray(eye, np.float32) + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = (np.asarray(at, np.float32) + rng.uniform(-4, 4, (n, 3)) - o).astype(np.float32)
    f32 = lambda *s: rng.uniform(0.0, 1.0, s).astype(np.float32)
    return dict(
        origin=o.T.copy(), direction=d.T.copy(), time=f32(n),
        ray_id=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        throughput=0.2 + 0.8 * f32(3, n), radiance=0.5 * f32(3, n),
        alive=rng.uniform(size=n) < 0.9,
    )


def _port_bounce(st, r, depth):
    n = r["alive"].size
    v3 = lambda a: V3(*(torch.from_numpy(a[i]) for i in range(3)))
    return integrator.bounce(
        st.compiled, 0, zt.dtypes.T_MIN, torch.full((n,), depth), v3(r["origin"]),
        v3(r["direction"]), torch.from_numpy(r["time"]),
        torch.from_numpy(r["ray_id"].astype(np.int64)), v3(r["throughput"]),
        v3(r["radiance"]), torch.from_numpy(r["alive"]),
    )


def _jax_kernel_bounce(sj, r, depth):
    """bounce_pallas, then the atlas multiply of integrator.py:394-396."""
    v3 = lambda a: JV3(*(jnp.asarray(a[i]) for i in range(3)))
    o, d, thr, rad, alive, (u, v, io) = pallas_bounce.bounce_pallas(
        sj.compiled, v3(r["origin"]), v3(r["direction"]), jnp.asarray(r["time"]),
        jnp.asarray(r["ray_id"]), v3(r["throughput"]), v3(r["radiance"]),
        jnp.asarray(r["alive"]), jnp.uint32(0), depth, np.float32(zt.dtypes.T_MIN),
    )
    img_rgb = jtex.atlas_lookup(sj.compiled, jnp.maximum(io, 0), u, v)
    thr = JV3.where(io >= 0, thr * img_rgb, thr)
    return o, d, thr, rad, alive


def _stack(state):
    o, d, thr, rad, alive = state
    arr = lambda v: np.stack([np.asarray(c) for c in v])
    return np.concatenate([arr(o), arr(d), arr(thr), arr(rad)]), np.asarray(alive)


@pytest.mark.parametrize("name", ["shrek_quads", "earth"])
@pytest.mark.parametrize("depth", [0, 1])
def test_one_bounce_matches_jax_kernel(pallas_interpret, scenes, name, depth):
    sj, st = scenes[name]
    r = _seeded_rays(name)
    got, alive_t = _stack(_port_bounce(st, r, depth))
    want, alive_j = _stack(_jax_kernel_bounce(sj, r, depth))
    differ = alive_t != alive_j
    limit = 0.02 * alive_t.size if name == "earth" else 0
    assert differ.sum() <= limit, differ.sum()
    same = ~differ
    # rows 0-5 (origin, direction) only matter where the path goes on
    keep = same & alive_t
    if name == "shrek_quads":
        np.testing.assert_allclose(got[:6, keep], want[:6, keep], rtol=RTOL, atol=ATOL)
    else:
        # sphere hits: the quadratic's cancellation (a 1000-radius ground,
        # grazing rays) amplifies the multiply-adds that XLA contracts in
        # the JAX interpreter, so points and the directions reflected about
        # their normals agree to 2e-4 of the vector's length
        for rows in (slice(0, 3), slice(3, 6)):
            err = np.linalg.norm(got[rows, keep] - want[rows, keep], axis=0)
            assert (err <= 2e-4 * np.linalg.norm(want[rows, keep], axis=0)).all(), err.max()
    close = np.isclose(got[6:, same], want[6:, same], rtol=RTOL, atol=ATOL).all(0)
    # earth: a texel-boundary lane keeps its alive flag but takes the
    # neighbouring texel's colour
    assert (~close).sum() <= limit, (~close).sum()
    assert (r["alive"] & ~alive_t).any() and alive_t.any()


@pytest.mark.parametrize("name", ["shrek_quads", "earth"])
def test_one_bounce_chain_matches_jax_xla(scenes, name):
    """Radiance after one and after two bounces (depths 0 and 1) from the
    seeded rays at unit throughput, against the JAX XLA integrator."""
    sj, st = scenes[name]
    r = _seeded_rays(name)
    n = r["alive"].size
    r.update(throughput=np.ones((3, n), np.float32), radiance=np.zeros((3, n), np.float32),
             alive=np.ones(n, bool))
    os.environ["ZWRT_NO_PALLAS"] = "1"
    _use_pallas_backend.cache_clear()
    try:
        for depth in (1, 2):
            want = j_trace_paths(
                sj.compiled, JV3(*(jnp.asarray(c) for c in r["origin"])),
                JV3(*(jnp.asarray(c) for c in r["direction"])), jnp.asarray(r["time"]),
                jnp.uint32(0), jnp.asarray(r["ray_id"]), depth,
            )
            state = (None, None, None, None, None)
            rr = dict(r)
            for k in range(depth):
                state = _port_bounce(st, rr, k)
                rr.update(origin=np.stack([c.numpy() for c in state[0]]),
                          direction=np.stack([c.numpy() for c in state[1]]),
                          throughput=np.stack([c.numpy() for c in state[2]]),
                          radiance=np.stack([c.numpy() for c in state[3]]),
                          alive=state[4].numpy())
            np.testing.assert_allclose(rr["radiance"], np.stack([np.asarray(c) for c in want]),
                                       rtol=XLA_RTOL, atol=XLA_ATOL)
    finally:
        del os.environ["ZWRT_NO_PALLAS"]
        _use_pallas_backend.cache_clear()


# ---- 4. renders ----

def _jax_render(scene, w, spp, depth, pallas):
    key = "ZWRT_PALLAS_INTERPRET" if pallas else "ZWRT_NO_PALLAS"
    os.environ[key] = "1"
    _use_pallas_backend.cache_clear()
    try:
        return np.asarray(zj.render.Renderer(
            samples_per_pixel=spp, max_ray_bounce_depth=depth, seed=0).render(scene, w, w))
    finally:
        del os.environ[key]
        _use_pallas_backend.cache_clear()


def _port_render(st, w, spp, depth, **kw):
    return zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth, **kw).render(st, w, w)


def test_shrek_render_matches_jax_kernel(scenes):
    sj, st = scenes["shrek_quads"]
    passes = integrator.trace_paths_regen.passes
    fb_t = _port_render(st, 16, 2, 3)
    assert integrator.trace_paths_regen.passes == passes + 1  # one pass per band
    fb_j = _jax_render(sj, 16, 2, 3, pallas=True)
    assert np.isfinite(fb_t).all()
    other = np.ones((16, 16), bool)
    for x, y in SHREK_EDGE_PIXELS:
        other[y, x] = False
    np.testing.assert_allclose(fb_t[other], fb_j[other], rtol=RTOL, atol=ATOL)


def test_earth_render_matches_jax_kernel(scenes):
    sj, st = scenes["earth"]
    fb_t = _port_render(st, 16, 2, 3)
    fb_j = _jax_render(sj, 16, 2, 3, pallas=True)
    assert np.isfinite(fb_t).all()
    d = np.abs(fb_t - fb_j).max(-1)
    bad = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=ATOL).all(-1)
    assert bad.mean() < 0.02, bad.sum()  # isolated texel-boundary pixels
    assert d.max() < 0.1, d.max()  # a texel step, not a divergent path
    np.testing.assert_allclose(fb_t.mean(), fb_j.mean(), rtol=1e-3)


def _synthetic_scene(mod, **kw):
    """tests/test_pallas.py:test_atlas_chain_kernel_matches_xla's scene: 80
    gray spheres in a tree around two image-textured spheres."""
    rng = np.random.default_rng(7)
    b = mod.scene.SceneBuilder()
    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = (200, 40, 40)
    img[1::2, 1::2] = (40, 200, 40)
    m_img = b.lambertian(b.image_texture(img))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.sphere((-3, 0, 0), 3.0, m_img))
    b.add(b.sphere((4, 0, -2), 2.5, m_img))
    for _ in range(80):
        b.add(b.sphere(rng.uniform(-12, 12, 3), rng.uniform(0.3, 1.0), m_gray))
    b.use_bvh(True, min_prims=2)
    b.set_camera(mod.scene.Camera(look_from=(0, 0, 25), look_at=(0, 0, 0)))
    b.set_background((0.7, 0.8, 1.0))
    return b.compile(**kw)


@pytest.fixture(scope="module")
def synthetic():
    return _synthetic_scene(zj), _synthetic_scene(zt, device="cpu")


def test_tree_image_render_matches_jax_chain(synthetic):
    sj, st = synthetic
    assert st.compiled.has_sph_tree and st.compiled.has_image_textures
    fb_t = _port_render(st, 16, 4, 5)
    fb_j = _jax_render(sj, 16, 4, 5, pallas=True)
    assert np.isfinite(fb_t).all()
    np.testing.assert_allclose(fb_t, fb_j, rtol=RTOL, atol=ATOL)


def test_rtw_final_render_matches_jax_xla():
    sj, st = zj.models.load_scene("rtw_final"), zt.models.load_scene("rtw_final", device="cpu")
    fb_t = _port_render(st, 8, 2, 3)
    fb_j = _jax_render(sj, 8, 2, 3, pallas=False)
    assert np.isfinite(fb_t).all() and fb_t.mean() > 0
    bad = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=ATOL).all(-1)
    # lanes whose light PDF XLA contracts (witness: the eager chain below)
    assert bad.sum() <= 2, bad.sum()
    np.testing.assert_allclose(fb_t, fb_j, rtol=2e-3, atol=ATOL)
    np.testing.assert_allclose(fb_t.mean(), fb_j.mean(), rtol=1e-4)


@pytest.mark.parametrize("name,w,lanes", [
    ("shrek_quads", 16, None),
    # the (x, y, sample) lanes of the 8x8 render whose light PDF the jitted
    # JAX render contracts (the eager interpreter is slow over rtw_final's
    # tree walk, so only these run)
    ("rtw_final", 8, ((3, 2, 0), (4, 3, 0), (4, 3, 1), (6, 5, 1))),
])
def test_render_matches_eager_jax_chain(name, w, lanes):
    """Witness for the exemptions above: on the port's camera rays, the
    port's bounce chain equals JAX's XLA integrator run eagerly (no fusion,
    so no contracted multiply-adds) on every lane, 2 spp, depth 3."""
    sj, st = zj.models.load_scene(name), zt.models.load_scene(name, device="cpu")
    s, y, x = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(2), torch.arange(w), torch.arange(w), indexing="ij"))
    if lanes is not None:
        x, y, s = (torch.tensor(c) for c in zip(*lanes))
    rid = (s * w + y) * w + x
    o, d, tm = tcam.generate_rays(
        tcam.camera_params_from_consts(tcam.camera_consts(st.camera, w, w)), False,
        zt.sampling.SamplerKind.SOBOL, 0, rid, x, y, s, 2, w, w,
    )
    n = rid.shape[0]
    thr, rad = V3.full((n,), 1.0, 1.0, 1.0, "cpu"), V3.zeros((n,), "cpu")
    oo, dd, alive = o, d, torch.ones(n, dtype=torch.bool)
    for k in range(3):
        oo, dd, thr, rad, alive = integrator.bounce(
            st.compiled, 0, zt.dtypes.T_MIN, torch.full((n,), k), oo, dd, tm, rid, thr, rad, alive
        )
    j = lambda v: JV3(*(jnp.asarray(c.numpy()) for c in v))
    os.environ["ZWRT_NO_PALLAS"] = "1"
    _use_pallas_backend.cache_clear()
    try:
        with jax.disable_jit():
            want = j_trace_paths(sj.compiled, j(o), j(d), jnp.asarray(tm.numpy()), jnp.uint32(0),
                                 jnp.asarray(rid.numpy().astype(np.uint32)), 3)
    finally:
        del os.environ["ZWRT_NO_PALLAS"]
        _use_pallas_backend.cache_clear()
    np.testing.assert_allclose(rad.to_array().numpy(), np.stack([np.asarray(c) for c in want], -1),
                               rtol=XLA_RTOL, atol=XLA_ATOL)


# ---- 5. plans ----

def test_sorted_plan_matches_plain_render(scenes):
    _, st = scenes["shrek_quads"]
    fb_plain = _port_render(st, 16, 4, 4)
    r = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=4, regen_min_wave=1)
    r.render(st, 16, 16)  # records the cost map
    fb_sorted = r.render(st, 16, 16)
    (entry,) = r._plan_cache[st.compiled].values()
    assert "plan" in entry
    np.testing.assert_allclose(fb_sorted, fb_plain, rtol=2e-5, atol=2e-6)


def test_coherent_plan_matches_plain_render(synthetic):
    _, st = synthetic
    fb_plain = _port_render(st, 16, 4, 5)
    r = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=5, regen_min_wave=1)
    fb_coh = r.render(st, 16, 16)
    ((key, _),) = r._plan_cache[st.compiled].items()
    assert key[0] == "coh"
    np.testing.assert_allclose(fb_coh, fb_plain, rtol=2e-5, atol=2e-6)


# ---- 6. carried state and devices ----

def test_carried_image_scene_renders_as_compiled(scenes):
    sj, st = scenes["earth"]
    cs = sj.compiled
    fields = {f: np.asarray(getattr(cs, f)) for f in ARRAY_FIELDS}
    carried = zt.scene.Scene(
        compiled_from_arrays(fields, {f: getattr(cs, f) for f in STATIC_FIELDS}, "cpu"),
        st.camera, st.background, "earth",
    )
    np.testing.assert_array_equal(_port_render(carried, 8, 2, 3), _port_render(st, 8, 2, 3))


def test_bounce_wrappers_refuse_other_devices(scenes):
    _, st = scenes["shrek_quads"]
    meta = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    z = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbounce.bounce(st.compiled, 0, 1e-3, 0, meta, meta, z, z.long(), meta, meta, z.bool())
    lanes = torch.zeros(4, dtype=torch.int32, device="meta")
    state = integrator.initial_regen_state(lanes, 1)
    kw = dict(camera_consts=tcam.camera_consts(st.camera, 2, 2),
              sampler=zt.sampling.SamplerKind.SOBOL, width=2, height=2, spp=1, stride=1,
              max_depth=2, has_dof=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbounce.bounce_regen(st.compiled, state, lanes, lanes, lanes, 0, 1e-3, **kw)
    # the whole-render kernel has no atlas fetch
    assert not tbounce.supports_fused_render(st.compiled)
    with pytest.raises(NotImplementedError, match="bounce kernel"):
        fused_render.render_fused(st.compiled, lanes, lanes, lanes, lanes, 0, 1e-3, **kw)
    assert sum(tbounce.bounce.launches.values()) == 0
    assert sum(tbounce.bounce_regen.launches.values()) == 0
