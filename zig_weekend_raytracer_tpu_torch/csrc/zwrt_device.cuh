// Device functions of the path tracer, shared by the CUDA kernels of
// zig_weekend_raytracer_tpu_torch: PCG4D, Sobol, camera rays with the
// defocus disk, sphere and quad hits, the closest-hit stages (brute scan,
// slab test, leaf sweep, skip-link tree walk), shade-record reads, the five
// materials, the light-list PDF, sphere and quad UVs with the image texel
// fetch (from the atlas or the texture LUT), and the bounce step and
// regenerating drain that fused_render.cu and bounce.cu share.  All three
// kernels trace through trace_closest, a template on the tree walk (Walk):
// the default per-thread walk, the leaf queue per thread, the leaf queue
// per warp, the speculative two-successor walk, or the unified tree.
//
// Every function follows the plain PyTorch version in the package
// (sampling/, geometry/, render/, ops/) operation for operation, so that a
// build with -fmad=false rounds as the unfused torch ops do: sums are
// evaluated left to right, x ** 5 is x * (x^2)^2, clamps pass NaN through as
// torch.clamp does, and the slab test's min/max propagate NaN as
// torch.minimum/maximum do (fminf/fmaxf would drop it).  Integer streams (PCG4D, Sobol, ray ids) are bitwise the
// JAX package's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace zwrt {

// ---------------------------------------------------------------------------
// Constants shared with the host wrapper (ops/fused_render.py)
// ---------------------------------------------------------------------------

constexpr int kMaxLights = 8;
constexpr int kLightFloats = 17;   // quad: s3 u3 v3 n3 w3 offset area
constexpr int kRecordWidth = 32;   // shade_rows columns (ops/shade.py)
constexpr int kSphereCols = 8;     // cx cy cz r2 mx my mz pad
constexpr int kQuadCols = 16;      // sx sy sz nx ny nz ax ay az bx by bz off pad3
constexpr int kSobolCols = 52;
constexpr int kSobolDeltaCols = 28;  // sample-index bits of the VdC delta

// Sobol table layout (kSobolCols u32 each): dim 0, dim 1, vdc, inv lo, inv hi.
constexpr int kSobolDim0 = 0;
constexpr int kSobolDim1 = kSobolCols;
constexpr int kSobolVdc = 2 * kSobolCols;
constexpr int kSobolInvLo = 3 * kSobolCols;
constexpr int kSobolInvHi = 4 * kSobolCols;
constexpr int kSobolTable = 5 * kSobolCols;

enum SamplerKind { kIndependent = 0, kStratified = 1, kSobol = 2 };
enum PrimKind { kSphere = 0, kQuad = 1 };
enum MatType {
  kLambertian = 0, kIsotropic = 1, kMetal = 2, kDielectric = 3, kDiffuseLight = 4
};

// record columns (ops/shade.py)
constexpr int kColMat = 16;
constexpr int kColTexKind = 17;
constexpr int kColImg = 18;
constexpr int kColRgb = 19;
constexpr int kColRgb2 = 22;
constexpr int kColInvScale = 25;
constexpr int kColFuzz = 26;
constexpr int kColRefract = 27;
constexpr int kColImg2 = 28;

constexpr int kBounceBase = 8;
constexpr int kSitesPerBounce = 4;
constexpr int kSiteDof = 1;
constexpr int kSiteTime = 2;

// Closest-hit stages (ops/trace.py): the running best t before any hit,
// the identity sentinel of a leaf sweep, the slab test's 4-ULP slack.
constexpr float kBig = 3.0e38f;
constexpr int kBigIdx = 1 << 30;
constexpr float kAabbMaxMult = 1.00000024f;
constexpr int kGroup = 8;  // slots per leaf group (the JAX kernels' sublanes)
enum TraceMode { kTraceNone = 0, kTraceBrute = 1, kTraceTree = 2 };
// Tree walks (ops/trace.py:WALKS, in its order).
enum Walk { kWalkCond = 0, kWalkQueue = 1, kWalkRowQueue = 2, kWalkSpec = 3, kWalkUni = 4 };
constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kHalfInvPi = 0.15915494309189535f;
constexpr float kInv255 = 0.00392156862745098f;
constexpr float kInv4Pi = 0.07957747154594767f;
constexpr float kOneMinusEps = 0.99999994f;
constexpr float kTMinPdf = 1e-3f;
constexpr float kQuadParallelEps = 1e-8f;

// Everything a launch needs besides the tables, passed by value.
struct Params {
  int width, height, spp, stride, max_depth;
  int sampler, log2_scale, strat_sqrt;
  uint32_t seed;
  int n_sph, n_quad, n_rows, n_lights, needs_gauss, has_dof;
  float t_min, strat_recip;
  float cam_pos[3], pixel00[3], du[3], dv[3], defocus_u[3], defocus_v[3], bg[3];
  int light_kind[kMaxLights];
  float light[kMaxLights][kLightFloats];
};

// ---------------------------------------------------------------------------
// Vector math (math/v3.py)
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator-(V3 a) { return mk(-a.x, -a.y, -a.z); }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// torch.clamp semantics: a NaN input stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ V3 normalize(V3 a) { return a * rsqrtf(dot(a, a)); }
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return v - n * (2.0f * dot(v, n)); }
__device__ __forceinline__ V3 refract(V3 vn, V3 n, float index) {
  float cos_theta = clamp_max(dot(-vn, n), 1.0f);
  V3 perp = (vn + n * cos_theta) * index;
  V3 par = n * (-sqrtf(fabsf(1.0f - dot(perp, perp))));
  return perp + par;
}

struct Onb {
  V3 u, v, w;
};

__device__ __forceinline__ Onb ortho_basis(V3 n) {
  Onb b;
  b.w = normalize(n);
  bool cond = fabsf(b.w.y) > 0.9f;
  V3 a = mk(cond ? 1.0f : 0.0f, cond ? 0.0f : 1.0f, 0.0f);
  b.u = normalize(cross(b.w, a));
  b.v = cross(b.w, b.u);
  return b;
}

__device__ __forceinline__ V3 onb_transform(const Onb& b, V3 l) {
  return b.u * l.x + b.v * l.y + b.w * l.z;
}

// ---------------------------------------------------------------------------
// Content-addressed RNG (sampling/hashrng.py)
// ---------------------------------------------------------------------------

struct U4 {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ U4 pcg4d(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  a = a * mul + add;
  b = b * mul + add;
  c = c * mul + add;
  d = d * mul + add;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  return U4{a, b, c, d};
}

__device__ __forceinline__ float to_unit(uint32_t v) {
  return (float)(int)(v >> 8) * (1.0f / 16777216.0f);
}

struct F4 {
  float x, y, z, w;
};

__device__ __forceinline__ F4 uniform4(uint32_t seed, uint32_t ray_id, uint32_t stream) {
  U4 h = pcg4d(ray_id, stream, seed, 0x9E3779B9u);
  return F4{to_unit(h.a), to_unit(h.b), to_unit(h.c), to_unit(h.d)};
}

__device__ __forceinline__ V3 gauss3(uint32_t seed, uint32_t ray_id, uint32_t stream) {
  F4 u = uniform4(seed, ray_id, stream);
  float r1 = sqrtf(-2.0f * logf(clamp_min(u.x, 1e-10f)));
  float r2 = sqrtf(-2.0f * logf(clamp_min(u.z, 1e-10f)));
  return mk(r1 * cosf(kTwoPi * u.y), r1 * sinf(kTwoPi * u.y), r2 * cosf(kTwoPi * u.w));
}

// Two standard normals (hashrng.gauss2).
__device__ __forceinline__ void gauss2(uint32_t seed, uint32_t ray_id, uint32_t stream, float* gx,
                                       float* gy) {
  F4 u = uniform4(seed, ray_id, stream);
  float r = sqrtf(-2.0f * logf(clamp_min(u.x, 1e-10f)));
  *gx = r * cosf(kTwoPi * u.y);
  *gy = r * sinf(kTwoPi * u.y);
}

__device__ __forceinline__ V3 unit_sphere(V3 g) {
  float norm = sqrtf(clamp_min(dot(g, g), 1e-24f));
  return g * (1.0f / norm);
}

__device__ __forceinline__ V3 cosine_direction_z(float u1, float u2) {
  float phi = kTwoPi * u1;
  float sq = sqrtf(u2);
  return mk(cosf(phi) * sq, sinf(phi) * sq, sqrtf(1.0f - u2));
}

__device__ __forceinline__ V3 cone_direction_z(float u1, float u2, float cos_theta_max) {
  float z = 1.0f + u2 * (cos_theta_max - 1.0f);
  float phi = kTwoPi * u1;
  float sz2 = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  return mk(cosf(phi) * sz2, sinf(phi) * sz2, z);
}

// ---------------------------------------------------------------------------
// Sobol pixel sampler (sampling/sobol.py, sampling/sampler.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sobol_interval_to_index(
    const uint32_t* tab, int log2_scale, uint32_t sample, uint32_t px, uint32_t py) {
  if (log2_scale == 0) return sample;
  uint64_t index = (uint64_t)sample << (2 * log2_scale);
  uint32_t delta = 0;
  for (int c = 0; c < kSobolDeltaCols; ++c)
    delta ^= tab[kSobolVdc + c] & (0u - ((sample >> c) & 1u));
  uint32_t b = ((px << log2_scale) | py) ^ delta;
  for (int c = 0; c < 2 * log2_scale; ++c) {
    uint64_t col = ((uint64_t)tab[kSobolInvHi + c] << 32) | tab[kSobolInvLo + c];
    index ^= col & (0ull - (uint64_t)((b >> c) & 1u));
  }
  return index;
}

__device__ __forceinline__ float sobol_sample(const uint32_t* cols, uint64_t index) {
  uint32_t v = 0;
  for (int i = 0; i < kSobolCols; ++i)
    v ^= cols[i] & (0u - (uint32_t)((index >> i) & 1ull));
  return clamp_max(__uint2float_rn(v) * 2.3283064365386963e-10f, kOneMinusEps);
}

__device__ __forceinline__ uint32_t ray_id_of(const Params& p, int sample, int px, int py) {
  return ((uint32_t)sample * (uint32_t)p.height + (uint32_t)py) * (uint32_t)p.width + (uint32_t)px;
}

// Camera ray of one (pixel, sample); returns the time draw.
__device__ __forceinline__ float generate_ray(
    const Params& p, const uint32_t* sobol, uint32_t rid, int px, int py, int sample,
    V3* origin, V3* direction) {
  float pxf = (float)px, pyf = (float)py;
  float ox, oy;
  if (p.sampler == kSobol) {
    uint64_t idx = sobol_interval_to_index(sobol, p.log2_scale, (uint32_t)sample,
                                           (uint32_t)px, (uint32_t)py);
    float fscale = (float)(1 << p.log2_scale);
    float sx = sobol_sample(sobol + kSobolDim0, idx);
    float sy = sobol_sample(sobol + kSobolDim1, idx);
    ox = clamp_max(clamp_min(sx * fscale - pxf, 0.0f), kOneMinusEps);
    oy = clamp_max(clamp_min(sy * fscale - pyf, 0.0f), kOneMinusEps);
  } else {
    F4 u = uniform4(p.seed, rid, 0u);
    if (p.sampler == kStratified) {
      float si = (float)(sample / p.strat_sqrt);
      float sj = (float)(sample % p.strat_sqrt);
      ox = (u.x + si) * p.strat_recip - 0.5f;
      oy = (u.y + sj) * p.strat_recip - 0.5f;
    } else {
      ox = u.x - 0.5f;
      oy = u.y - 0.5f;
    }
  }
  V3 sample_pos;
  sample_pos.x = p.pixel00[0] + p.du[0] * (pxf + ox) + p.dv[0] * (pyf + oy);
  sample_pos.y = p.pixel00[1] + p.du[1] * (pxf + ox) + p.dv[1] * (pyf + oy);
  sample_pos.z = p.pixel00[2] + p.du[2] * (pxf + ox) + p.dv[2] * (pyf + oy);
  *origin = mk(p.cam_pos[0], p.cam_pos[1], p.cam_pos[2]);
  if (p.has_dof) {
    // defocus disk (render/camera.py, hashrng.unit_disk_xy)
    float ud = uniform4(p.seed, rid, (uint32_t)kSiteDof).x;
    float gx, gy;
    gauss2(p.seed, rid, (uint32_t)(kSiteDof + 4), &gx, &gy);
    float norm = sqrtf(clamp_min(gx * gx + gy * gy, 1e-24f));
    float dx = ud * gx / norm, dy = ud * gy / norm;
    V3 du = mk(p.defocus_u[0], p.defocus_u[1], p.defocus_u[2]);
    V3 dv = mk(p.defocus_v[0], p.defocus_v[1], p.defocus_v[2]);
    *origin = *origin + du * dx + dv * dy;
  }
  *direction = sample_pos - *origin;
  return uniform4(p.seed, rid, (uint32_t)kSiteTime).x;
}

// ---------------------------------------------------------------------------
// Primitive hits (geometry/sphere.py, geometry/quad.py)
// ---------------------------------------------------------------------------

// Sphere root strictly inside (t_min, t_max); returns false on a miss.
__device__ __forceinline__ bool sphere_hit(
    V3 center, float r2, V3 o, V3 d, float a, float inv_a, float t_min, float t_max,
    float* t_out) {
  V3 oc = center - o;
  float h = dot(d, oc);
  float c = dot(oc, oc) - r2;
  float disc = h * h - a * c;
  float sq = sqrtf(clamp_min(disc, 0.0f));
  float root1 = (h - sq) * inv_a;
  float root2 = (h + sq) * inv_a;
  bool in1 = (root1 > t_min) && (root1 < t_max);
  bool in2 = (root2 > t_min) && (root2 < t_max);
  *t_out = in1 ? root1 : root2;
  return (disc >= 0.0f) && (in1 || in2);
}

// Quad hit with t in [t_min, t_max] and the interior test through the
// precomputed A = v x w, B = w x u; returns false on a miss.
__device__ __forceinline__ bool quad_hit(
    V3 start, V3 normal, V3 A, V3 B, float offset, V3 o, V3 d, float t_min, float t_max,
    float* t_out) {
  float denom = dot(normal, d);
  bool not_parallel = fabsf(denom) >= kQuadParallelEps;
  float t = (offset - dot(normal, o)) / (not_parallel ? denom : 1.0f);
  bool in_range = (t >= t_min) && (t <= t_max);
  V3 planar = o + d * t - start;
  float alpha = dot(planar, A);
  float beta = dot(planar, B);
  bool interior = (alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f);
  *t_out = t;
  return not_parallel && in_range && interior;
}

// ---------------------------------------------------------------------------
// Closest hit (ops/trace.py:closest_hit): a sphere stage, then a quad stage
// seeded with it, each brute or a group-tree walk
// ---------------------------------------------------------------------------

// torch.minimum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// One kind's tables.  Brute: ``tab`` has one row per primitive.  Tree:
// ``box`` (n_nodes, 6) [min xyz, max xyz], ``link`` (n_nodes, 2) [miss
// link, first leaf group or -1], ``tab`` one row per leaf slot and ``oi``
// each slot's original index.  Rows: spheres kSphereCols, quads kQuadCols.
struct KindTables {
  int mode, n_prims, n_nodes, span;
  const float* tab;
  const float* box;
  const int* link;
  const int* oi;
};

// ``usph`` and ``uquad`` are the unified tree's leaf tables (tab, oi and
// span read), ``ubox`` (u_nodes, 6) and ``ulink`` (u_nodes, 3) [miss
// link, first leaf group or -1, leaf kind] its nodes.  ``queue`` is the
// per-thread leaf queue of kWalkQueue, lane-major: entry j of thread t at
// queue[j * q_stride + t], q_stride the launch's thread count;
// kWalkRowQueue keeps q_cap entries per warp in dynamic shared memory.
struct TraceScene {
  KindTables sph, quad;
  int has_moving;
  KindTables usph, uquad;
  int u_nodes;
  const float* ubox;
  const int* ulink;
  int* queue;
  int q_stride, q_cap;
};

// Robust slab test (math/aabb.py:aabb_hit) against the running best t.
__device__ __forceinline__ bool slab_hit(const float* b, V3 o, V3 inv_d, float t_min, float t) {
  float tx0 = (b[0] - o.x) * inv_d.x;
  float tx1 = (b[3] - o.x) * inv_d.x;
  float ty0 = (b[1] - o.y) * inv_d.y;
  float ty1 = (b[4] - o.y) * inv_d.y;
  float tz0 = (b[2] - o.z) * inv_d.z;
  float tz1 = (b[5] - o.z) * inv_d.z;
  float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                       nan_max(nan_min(tz0, tz1), t_min));
  float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                      nan_min(nan_max(tz0, tz1), t)) * kAabbMaxMult;
  return far > near;
}

// A ray with its derived values.
struct Ray {
  V3 o, d, inv_d;
  float a, inv_a, t_min, time;
};

// Hit distance of one table row strictly below ``t_max``; false on a miss.
template <int KIND>
__device__ __forceinline__ bool row_hit(const float* r, const Ray& ray, bool moving, float t_max,
                                        float* t) {
  if (KIND == kSphere) {
    V3 center = mk(r[0], r[1], r[2]);
    if (moving) center = center + mk(r[4], r[5], r[6]) * ray.time;
    return sphere_hit(center, r[3], ray.o, ray.d, ray.a, ray.inv_a, ray.t_min, t_max, t);
  }
  return quad_hit(mk(r[0], r[1], r[2]), mk(r[3], r[4], r[5]), mk(r[6], r[7], r[8]),
                  mk(r[9], r[10], r[11]), r[12], ray.o, ray.d, ray.t_min, t_max, t) &&
         *t < t_max;
}

// Brute stage: every primitive in index order, a strictly smaller t wins.
template <int KIND>
__device__ __forceinline__ void brute_stage(const KindTables& k, const Ray& ray, bool moving,
                                            float* best, int* kind, int* idx) {
  constexpr int cols = KIND == kSphere ? kSphereCols : kQuadCols;
  for (int i = 0; i < k.n_prims; ++i) {
    float t;
    if (row_hit<KIND>(k.tab + (size_t)i * cols, ray, moving, *best, &t)) {
      *best = t;
      *kind = KIND;
      *idx = i;
    }
  }
}

// Leaf sweep: the ``span`` groups of 8 slots from ``group0``.  Each slot
// column keeps its first strictly-closer slot; the leaf's hit is the
// smallest original index among the columns at the leaf's best t, and it
// replaces the running best only when strictly closer.
template <int KIND>
__device__ __forceinline__ void leaf_sweep(const KindTables& k, int group0, const Ray& ray,
                                           bool moving, float* best, int* kind, int* idx) {
  constexpr int cols = KIND == kSphere ? kSphereCols : kQuadCols;
  float t8[kGroup];
  int i8[kGroup];
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    t8[s] = kBig;
    i8[s] = kBigIdx;
  }
  for (int g = 0; g < k.span; ++g) {
    const int slot0 = (group0 + g) * kGroup;
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      float t;
      if (row_hit<KIND>(k.tab + (size_t)(slot0 + s) * cols, ray, moving, t8[s], &t)) {
        t8[s] = t;
        i8[s] = k.oi[slot0 + s];
      }
    }
  }
  float t_row = t8[0];
#pragma unroll
  for (int s = 1; s < kGroup; ++s) t_row = t8[s] < t_row ? t8[s] : t_row;
  int i_row = kBigIdx;
#pragma unroll
  for (int s = 0; s < kGroup; ++s)
    if (t8[s] <= t_row && i8[s] < i_row) i_row = i8[s];
  if (t_row < *best) {
    *best = t_row;
    *kind = KIND;
    *idx = i_row;
  }
}

// Skip-link walk of one kind's group tree by this thread alone: a hit
// leaf is swept, a hit interior node descends to node + 1, anything else
// jumps to the miss link.
template <int KIND>
__device__ __forceinline__ void tree_walk(const KindTables& k, const Ray& ray, bool moving,
                                          float* best, int* kind, int* idx) {
  int node = 0;
  while (node < k.n_nodes) {
    bool hit = slab_hit(k.box + (size_t)node * 6, ray.o, ray.inv_d, ray.t_min, *best);
    int miss = k.link[2 * node], leaf = k.link[2 * node + 1];
    if (hit && leaf >= 0) leaf_sweep<KIND>(k, leaf, ray, moving, best, kind, idx);
    node = (hit && leaf < 0) ? node + 1 : miss;
  }
}

// kWalkQueue (pallas_bounce.py:_tree_pass_queue, per_row=False): walk with
// the stage's seed t and only (node, cursor) live, push each hit leaf to
// this thread's queue in preorder, then sweep the queue with the fresh t.
// A tree of n nodes has at most (n + 1) / 2 leaves, which the wrapper's
// capacity covers, so a push never overflows.
template <int KIND>
__device__ __forceinline__ void tree_walk_queue(const KindTables& k, const TraceScene& s,
                                                const Ray& ray, bool moving, float* best,
                                                int* kind, int* idx) {
  int* q = s.queue + blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = s.q_stride;
  const float t_seed = *best;
  int node = 0, sp = 0;
  while (node < k.n_nodes) {
    bool hit = slab_hit(k.box + (size_t)node * 6, ray.o, ray.inv_d, ray.t_min, t_seed);
    int miss = k.link[2 * node], leaf = k.link[2 * node + 1];
    if (hit && leaf >= 0) q[(sp++) * stride] = leaf;
    node = (hit && leaf < 0) ? node + 1 : miss;
  }
  for (int j = 0; j < sp; ++j) leaf_sweep<KIND>(k, q[j * stride], ray, moving, best, kind, idx);
}

__device__ __forceinline__ int2* warp_queues() {
  extern __shared__ int2 zwrt_warp_queue_smem[];
  return zwrt_warp_queue_smem;
}

// kWalkRowQueue (_tree_pass_queue, per_row=True): the lanes of ``group``
// walk one node pointer, descending when any of them hits with its seed t.
// ``group`` names the lanes of this warp that trace in this step, and the
// caller takes it with a ballot that all of them reach (drain's loop head,
// the one-bounce mode's entry): __activemask() would name only the lanes
// that happen to run converged, which independent thread scheduling does
// not promise, and two such subsets would share the warp's queue.  Each
// __ballot_sync(group, ...) makes the group meet.  A hit leaf goes to the
// warp's queue in shared memory with the ballot of the lanes that hit it;
// every lane writes the same entry, so each reads back its own write.  Each
// lane then sweeps, in queue order, only the leaves its bit marks, and the
// group meets before the queue is reused.
template <int KIND>
__device__ __forceinline__ void tree_walk_warpqueue(const KindTables& k, const TraceScene& s,
                                                    const Ray& ray, bool moving, unsigned group,
                                                    float* best, int* kind, int* idx) {
  const unsigned me = 1u << (threadIdx.x % kWarp);
  int2* q = warp_queues() + (threadIdx.x / kWarp) * s.q_cap;
  const float t_seed = *best;
  int node = 0, sp = 0;
  while (node < k.n_nodes) {
    bool hit = slab_hit(k.box + (size_t)node * 6, ray.o, ray.inv_d, ray.t_min, t_seed);
    unsigned bits = __ballot_sync(group, hit);
    int miss = k.link[2 * node], leaf = k.link[2 * node + 1];
    if (bits != 0u && leaf >= 0) q[sp++] = make_int2(leaf, (int)bits);
    node = (bits != 0u && leaf < 0) ? node + 1 : miss;
  }
  for (int j = 0; j < sp; ++j) {
    int2 e = q[j];
    if ((unsigned)e.y & me) leaf_sweep<KIND>(k, e.x, ray, moving, best, kind, idx);
  }
  __syncwarp(group);
}

// kWalkSpec (_tree_pass_spec): the default walk, but each step loads and
// slab-tests both successors (node + 1 and the miss link, clamped for the
// load only) against the t from before this step's leaf sweep, so the box
// loads are in flight while the sweep runs.  A stale t only admits more
// boxes; the sweep always uses the fresh t.
template <int KIND>
__device__ __forceinline__ void tree_walk_spec(const KindTables& k, const Ray& ray, bool moving,
                                               float* best, int* kind, int* idx) {
  const int last = k.n_nodes - 1;
  bool hit = slab_hit(k.box, ray.o, ray.inv_d, ray.t_min, *best);
  int node = 0;
  while (node < k.n_nodes) {
    int miss = k.link[2 * node], leaf = k.link[2 * node + 1];
    const float t_pre = *best;
    const int desc_node = node + 1 < last ? node + 1 : last;
    const int miss_node = miss < last ? miss : last;
    bool hit_desc = slab_hit(k.box + (size_t)desc_node * 6, ray.o, ray.inv_d, ray.t_min, t_pre);
    bool hit_miss = slab_hit(k.box + (size_t)miss_node * 6, ray.o, ray.inv_d, ray.t_min, t_pre);
    if (hit && leaf >= 0) leaf_sweep<KIND>(k, leaf, ray, moving, best, kind, idx);
    bool desc = hit && leaf < 0;
    node = desc ? node + 1 : miss;
    hit = desc ? hit_desc : hit_miss;
  }
}

// kWalkUni (_uni_tree_pass): one default walk over the unified tree, each
// kind-pure leaf swept by its kind.
__device__ __forceinline__ void uni_tree_walk(const TraceScene& s, const Ray& ray, bool moving,
                                              float* best, int* kind, int* idx) {
  int node = 0;
  while (node < s.u_nodes) {
    bool hit = slab_hit(s.ubox + (size_t)node * 6, ray.o, ray.inv_d, ray.t_min, *best);
    int miss = s.ulink[3 * node], leaf = s.ulink[3 * node + 1];
    if (hit && leaf >= 0) {
      if (s.ulink[3 * node + 2] == kSphere) leaf_sweep<kSphere>(s.usph, leaf, ray, moving, best, kind, idx);
      else leaf_sweep<kQuad>(s.uquad, leaf, ray, false, best, kind, idx);
    }
    node = (hit && leaf < 0) ? node + 1 : miss;
  }
}

// One kind's tree stage in the walk WALK (not kWalkUni); ``group`` as
// tree_walk_warpqueue takes it.
template <int KIND, int WALK>
__device__ __forceinline__ void tree_stage(const KindTables& k, const TraceScene& s,
                                           const Ray& ray, bool moving, unsigned group,
                                           float* best, int* kind, int* idx) {
  if (WALK == kWalkQueue) tree_walk_queue<KIND>(k, s, ray, moving, best, kind, idx);
  else if (WALK == kWalkRowQueue)
    tree_walk_warpqueue<KIND>(k, s, ray, moving, group, best, kind, idx);
  else if (WALK == kWalkSpec) tree_walk_spec<KIND>(k, ray, moving, best, kind, idx);
  else tree_walk<KIND>(k, ray, moving, best, kind, idx);
}

// The closest hit of one ray below ``t_start``; kind -1 on a miss, with
// *best then still t_start.  WALK picks the tree walk at compile time;
// kWalkRowQueue reads ``group``, the lanes of the warp that call it
// together (tree_walk_warpqueue).
template <int WALK>
__device__ __forceinline__ void trace_closest(const TraceScene& s, V3 o, V3 d, float time,
                                              float t_min, float t_start, float* best,
                                              int* kind, int* idx,
                                              unsigned group = kAllLanes) {
  Ray ray;
  ray.o = o;
  ray.d = d;
  ray.inv_d = mk(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  ray.a = dot(d, d);
  ray.inv_a = 1.0f / ray.a;
  ray.t_min = t_min;
  ray.time = time;
  *best = t_start;
  *kind = -1;
  *idx = 0;
  const bool moving = s.has_moving != 0;
  if (WALK == kWalkUni) {
    uni_tree_walk(s, ray, moving, best, kind, idx);
    return;
  }
  if (s.sph.mode == kTraceBrute) brute_stage<kSphere>(s.sph, ray, moving, best, kind, idx);
  else if (s.sph.mode == kTraceTree)
    tree_stage<kSphere, WALK>(s.sph, s, ray, moving, group, best, kind, idx);
  if (s.quad.mode == kTraceBrute) brute_stage<kQuad>(s.quad, ray, false, best, kind, idx);
  else if (s.quad.mode == kTraceTree)
    tree_stage<kQuad, WALK>(s.quad, s, ray, false, group, best, kind, idx);
}

// Host side: the TraceScene from the ints and pointers the wrappers pack
// (ops/fused_render.py:trace_args): per kind mode, n_prims, n_nodes,
// span, then has_moving, the unified tree's n_nodes (0 without one) and
// span; per kind tab, box, link, oi, then the unified tree's box, link,
// sphere tab and oi, quad tab and oi.  No queue yet (set_walk).
inline TraceScene read_trace_scene(const int* ints, const void* const* ptrs) {
  TraceScene s = {};
  KindTables* kinds[2] = {&s.sph, &s.quad};
  for (int j = 0; j < 2; ++j) {
    KindTables* k = kinds[j];
    k->mode = ints[4 * j];
    k->n_prims = ints[4 * j + 1];
    k->n_nodes = ints[4 * j + 2];
    k->span = ints[4 * j + 3];
    k->tab = static_cast<const float*>(ptrs[4 * j]);
    k->box = static_cast<const float*>(ptrs[4 * j + 1]);
    k->link = static_cast<const int*>(ptrs[4 * j + 2]);
    k->oi = static_cast<const int*>(ptrs[4 * j + 3]);
  }
  s.has_moving = ints[8];
  s.u_nodes = ints[9];
  s.usph.span = s.uquad.span = ints[10];
  s.ubox = static_cast<const float*>(ptrs[8]);
  s.ulink = static_cast<const int*>(ptrs[9]);
  s.usph.tab = static_cast<const float*>(ptrs[10]);
  s.usph.oi = static_cast<const int*>(ptrs[11]);
  s.uquad.tab = static_cast<const float*>(ptrs[12]);
  s.uquad.oi = static_cast<const int*>(ptrs[13]);
  return s;
}

// Host side: checks a launch's walk against the scene and sets up its leaf
// queue: ``queue`` holds ``queue_len`` ints, ``q_cap`` entries per thread
// (kWalkQueue) or per warp (kWalkRowQueue, whose dynamic shared memory per
// block is returned in *smem).  Returns a cudaError_t: invalid for an
// unknown walk, a uni walk without the unified tree, or a queue too short.
inline int set_walk(TraceScene* s, int walk, int q_cap, int* queue, int queue_len, int blocks,
                    int threads, size_t* smem) {
  s->queue = queue;
  s->q_stride = blocks * threads;
  s->q_cap = q_cap;
  *smem = 0;
  if (walk < kWalkCond || walk > kWalkUni || q_cap < 0) return (int)cudaErrorInvalidValue;
  if (walk == kWalkUni && s->u_nodes < 1) return (int)cudaErrorInvalidValue;
  if (walk == kWalkQueue && q_cap > 0 &&
      (queue == nullptr || (long long)queue_len < (long long)q_cap * s->q_stride))
    return (int)cudaErrorInvalidValue;
  if (walk == kWalkRowQueue) *smem = (size_t)(threads / kWarp) * q_cap * sizeof(int2);
  return 0;
}

// Host side: f(std::integral_constant<int, W>{}) for the walk W that
// ``walk`` names, so that each launcher picks its kernel's instantiation in
// one place; cudaErrorInvalidValue for an unknown walk.
template <typename F>
inline int dispatch_walk(int walk, F f) {
  switch (walk) {
    case kWalkCond: return f(std::integral_constant<int, kWalkCond>{});
    case kWalkQueue: return f(std::integral_constant<int, kWalkQueue>{});
    case kWalkRowQueue: return f(std::integral_constant<int, kWalkRowQueue>{});
    case kWalkSpec: return f(std::integral_constant<int, kWalkSpec>{});
    case kWalkUni: return f(std::integral_constant<int, kWalkUni>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Host side: lets ``kernel`` take ``smem`` bytes of dynamic shared memory
// (past 48 KB a kernel must ask for it); returns a cudaError_t.
template <typename K>
inline int allow_smem(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// ---------------------------------------------------------------------------
// Light list (render/pdfs.py); geometry from Params::light
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 lv(const float* l, int i) { return mk(l[i], l[i + 1], l[i + 2]); }

__device__ __forceinline__ float light_pdf(const Params& p, V3 origin, V3 dir) {
  float total = 0.0f;
  for (int k = 0; k < p.n_lights; ++k) {
    const float* l = p.light[k];
    float pdf = 0.0f;
    if (p.light_kind[k] == kSphere) {
      V3 center = lv(l, 0);
      float radius = l[3];
      float a = dot(dir, dir);
      float t;
      bool valid = sphere_hit(center, radius * radius, origin, dir, a, 1.0f / a,
                              kTMinPdf, INFINITY, &t);
      V3 diff = center - origin;
      float dist_sq = dot(diff, diff);
      float ctm = sqrtf(clamp_min(1.0f - radius * radius / dist_sq, 0.0f));
      float solid_angle = kTwoPi * (1.0f - ctm);
      if (valid) pdf = 1.0f / clamp_min(solid_angle, 1e-20f);
    } else {
      V3 start = lv(l, 0), eu = lv(l, 3), ev = lv(l, 6), nrm = lv(l, 9), w = lv(l, 12);
      float t;
      bool valid = quad_hit(start, nrm, cross(ev, w), cross(w, eu), l[15], origin, dir,
                            kTMinPdf, INFINITY, &t);
      if (valid) {
        float dir_len_sq = dot(dir, dir);
        float dist_sq = t * t * dir_len_sq;
        float cosv = fabsf(dot(dir, nrm)) / sqrtf(dir_len_sq);
        pdf = dist_sq / clamp_min(cosv * l[16], 1e-20f);
      }
    }
    total = total + pdf;
  }
  return total / (float)p.n_lights;
}

__device__ __forceinline__ V3 light_sample(const Params& p, V3 origin, float u_choice, float u1,
                                           float u2) {
  int n_l = p.n_lights;
  int chosen = (int)(u_choice * (float)n_l);
  if (chosen > n_l - 1) chosen = n_l - 1;
  const float* l = p.light[chosen];
  if (p.light_kind[chosen] == kSphere) {
    V3 dir = lv(l, 0) - origin;
    float dist_sq = dot(dir, dir);
    float ctm = sqrtf(clamp_min(1.0f - l[3] * l[3] / dist_sq, 0.0f));
    V3 local = cone_direction_z(u1, u2, ctm);
    return onb_transform(ortho_basis(dir), local);
  }
  return lv(l, 0) + lv(l, 3) * u1 + lv(l, 6) * u2 - origin;
}

// ---------------------------------------------------------------------------
// Materials (materials.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float scattering_pdf(int mat_type, V3 normal, V3 dir) {
  float cos_theta = dot(normal, normalize(dir));
  float lam = clamp_min(cos_theta * kInvPi, 0.0f);
  return mat_type == kIsotropic ? kInv4Pi : lam;
}

__device__ __forceinline__ float schlick_reflectance(float cos_theta, float ri) {
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  float x = 1.0f - cos_theta;
  float x2 = x * x;
  return r0 + (1.0f - r0) * (x * (x2 * x2));
}

// ---------------------------------------------------------------------------
// Image textures (geometry/sphere.py:uv, ops/shade.py, textures.py)
// ---------------------------------------------------------------------------

constexpr int kMaxImages = 16;

// One table of images, texels r | g << 8 | b << 16: image i is w[i] x h[i]
// texels, texel (x, y) at texels[base[i] + y * stride[i] + x].  The atlas
// (n_images, ah, aw) has base = i * ah * aw and stride = aw
// (textures.py:atlas_flat_index); the texture LUT has each image's own base
// and stride = w (textures.py:lut_flat_index).
struct Images {
  const int* texels;
  int n_images;
  int w[kMaxImages], h[kMaxImages], base[kMaxImages], stride[kMaxImages];
};

// Spherical UVs from the object-space outward normal.
__device__ __forceinline__ void sphere_uv(V3 n, float* u, float* v) {
  float theta = acosf(clamp_max(clamp_min(-n.y, -1.0f), 1.0f));
  float phi = atan2f(-n.z, n.x) + kPi;
  *u = phi * kHalfInvPi;
  *v = theta * kInvPi;
}

// Nearest texel of image ``img`` at (u, v), byte -> linear by the gamma-2
// square: textures.py:atlas_flat_index's (or lut_flat_index's) arithmetic,
// then one 4-byte load.
__device__ __forceinline__ V3 image_texel(const Images& a, int img, float u, float v) {
  float wf = 0.0f, hf = 0.0f;
  int wi = 0, hi = 0, base = 0, stride = 0;
#pragma unroll
  for (int i = 0; i < kMaxImages; ++i) {
    if (i < a.n_images && img == i) {
      wf = (float)a.w[i];
      hf = (float)a.h[i];
      wi = a.w[i];
      hi = a.h[i];
      base = a.base[i];
      stride = a.stride[i];
    }
  }
  float uc = clamp_max(clamp_min(u, 0.0f), 1.0f);
  float vc = 1.0f - clamp_max(clamp_min(v, 0.0f), 1.0f);
  int x = (int)(uc * wf);
  int y = (int)(vc * hf);
  x = x < 0 ? 0 : (x > wi - 1 ? wi - 1 : x);
  y = y < 0 ? 0 : (y > hi - 1 ? hi - 1 : y);
  uint32_t t = (uint32_t)__ldg(a.texels + (size_t)base + (size_t)y * stride + x);
  V3 c = mk((float)(t & 0xFFu) * kInv255, (float)((t >> 8) & 0xFFu) * kInv255,
            (float)((t >> 16) & 0xFFu) * kInv255);
  return c * c;
}

// ---------------------------------------------------------------------------
// The bounce (render/integrator.py:bounce) and the regenerating drain
// (render/integrator.py:_drain)
// ---------------------------------------------------------------------------

// One path's state between bounces.
struct Path {
  V3 o, d, thr, rad;
  float time;
  uint32_t rid;
  int depth;
};

// One bounce of a live path: closest hit, shade record, texture, the
// material's scatter.  Returns whether the path goes on (before the depth
// cutoff).  ``group`` is the warp's lanes that bounce together, read by the
// kWalkRowQueue trace only.  IMAGES compiles the image fetch: the texel of
// an image texture (or a checker's image child) replaces the record colour
// at the hit, before emission and scatter, as the XLA integrator and the
// JAX whole-render kernel's LUT fetch order it.  Without IMAGES ``images``
// is never read.
template <bool IMAGES, int WALK>
__device__ __forceinline__ bool bounce_step(const Params& p, const TraceScene& scene,
                                            const float* __restrict__ shade_rows,
                                            const Images* images, Path& s, unsigned group) {
  // ---- closest hit: sphere stage, then quad stage (or the unified walk) ----
  float best;
  int kind, idx;
  trace_closest<WALK>(scene, s.o, s.d, s.time, p.t_min, kBig, &best, &kind, &idx, group);
  if (kind < 0) {
    // ---- miss: background, the path ends ----
    s.rad = s.rad + s.thr * mk(p.bg[0], p.bg[1], p.bg[2]);
    return false;
  }

  // ---- shade record and hit attributes (ops/shade.py) ----
  int row = kind == kSphere ? idx : p.n_sph + idx;
  row = row < 0 ? 0 : (row > p.n_rows - 1 ? p.n_rows - 1 : row);
  const float* rec = shade_rows + (size_t)row * kRecordWidth;
  V3 point = s.o + s.d * best;
  V3 outward;
  if (kind == kSphere) {
    V3 center = mk(rec[0], rec[1], rec[2]) + mk(rec[3], rec[4], rec[5]) * s.time;
    outward = (point - center) * rec[6];
  } else {
    outward = mk(rec[3], rec[4], rec[5]);
  }
  bool front = dot(s.d, outward) < 0.0f;
  V3 normal = front ? outward : -outward;
  int mat = (int)rec[kColMat];
  V3 rgb = mk(rec[kColRgb], rec[kColRgb + 1], rec[kColRgb + 2]);
  bool odd = false;
  if ((int)rec[kColTexKind] == 1) {
    float inv_scale = rec[kColInvScale];
    int xi = (int)floorf(inv_scale * point.x);
    int yi = (int)floorf(inv_scale * point.y);
    int zi = (int)floorf(inv_scale * point.z);
    odd = ((xi + yi + zi) & 1) != 0;
  }
  V3 tex_rgb = odd ? mk(rec[kColRgb2], rec[kColRgb2 + 1], rec[kColRgb2 + 2]) : rgb;
  if (IMAGES) {
    int img = (int)rec[odd ? kColImg2 : kColImg];
    if (img >= 0) {
      float u, v;
      if (kind == kSphere) {
        // object-space normal: undo the instance's y rotation (cols 7-8)
        float c = rec[7], sn = rec[8];
        sphere_uv(mk(c * outward.x - sn * outward.z, outward.y, sn * outward.x + c * outward.z),
                  &u, &v);
      } else {
        // plane coordinates (alpha, beta) through w (cols 6-8), edges u
        // (9-11) and v (12-14)
        V3 w = mk(rec[6], rec[7], rec[8]);
        V3 planar = point - mk(rec[0], rec[1], rec[2]);
        u = dot(w, cross(planar, mk(rec[12], rec[13], rec[14])));
        v = dot(w, cross(mk(rec[9], rec[10], rec[11]), planar));
      }
      tex_rgb = image_texel(*images, img, u, v);
    }
  }

  // ---- RNG draws of this bounce ----
  uint32_t site = (uint32_t)(kBounceBase + s.depth * kSitesPerBounce);
  F4 u = uniform4(p.seed, s.rid, site);

  bool survives = false;
  V3 mult = mk(1.0f, 1.0f, 1.0f);
  V3 new_dir = s.d;
  if (mat == kDiffuseLight) {
    // ---- emission on front faces; the path ends ----
    if (front) s.rad = s.rad + s.thr * tex_rgb;
  } else if (mat == kMetal) {
    V3 metal_dir = reflect(s.d, normal);
    if (p.needs_gauss) {
      float fuzz = clamp_max(clamp_min(rec[kColFuzz], 0.0f), 1.0f);
      metal_dir = metal_dir + unit_sphere(gauss3(p.seed, s.rid, site + 2u)) * fuzz;
    }
    survives = dot(metal_dir, normal) > 0.0f;
    new_dir = metal_dir;
    mult = rgb;
  } else if (mat == kDielectric) {
    float ri = rec[kColRefract];
    float index = front ? 1.0f / ri : ri;
    V3 unit_in = normalize(s.d);
    float cos_theta = clamp_max(dot(-unit_in, normal), 1.0f);
    float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    bool must_reflect =
        (index * sin_theta > 1.0f) || (schlick_reflectance(cos_theta, ri) > u.x);
    new_dir = must_reflect ? reflect(unit_in, normal) : refract(unit_in, normal, index);
    survives = true;
  } else {
    // ---- diffuse: cosine or isotropic sample, light mixture ----
    V3 mat_dir;
    if (mat == kIsotropic) {
      mat_dir = unit_sphere(gauss3(p.seed, s.rid, site + 2u));
    } else {
      mat_dir = onb_transform(ortho_basis(normal), cosine_direction_z(u.y, u.z));
    }
    float scatter_pdf, sample_pdf;
    if (p.n_lights > 0) {
      F4 ul = uniform4(p.seed, s.rid, site + 1u);
      V3 diff_dir = u.w < 0.5f ? light_sample(p, point, ul.x, ul.y, ul.z) : mat_dir;
      float mat_pdf = scattering_pdf(mat, normal, diff_dir);
      float l_pdf = light_pdf(p, point, diff_dir);
      sample_pdf = 0.5f * l_pdf + 0.5f * mat_pdf;
      scatter_pdf = mat_pdf;
      new_dir = diff_dir;
    } else {
      scatter_pdf = scattering_pdf(mat, normal, mat_dir);
      sample_pdf = scatter_pdf;
      new_dir = mat_dir;
    }
    float ratio = sample_pdf > 0.0f ? scatter_pdf / sample_pdf : 0.0f;
    mult = tex_rgb * ratio;
    survives = true;
  }
  if (survives) {
    s.thr = s.thr * mult;
    survives = (s.thr.x != 0.0f) || (s.thr.y != 0.0f) || (s.thr.z != 0.0f);
  }
  s.o = point;
  s.d = new_dir;
  return survives;
}

// Runs one lane until its sample window is used up: a dead lane respawns
// its pixel's next sample (sample += stride, while below ``limit``), every
// pass counts one unit of work and runs one bounce, and a path ends after
// p.max_depth bounces.  Under kWalkRowQueue a ballot at the loop head, which
// every lane of the warp still in the loop reaches, names the lanes that
// bounce in this pass (the group of tree_walk_warpqueue).
template <bool IMAGES, int WALK>
__device__ __forceinline__ void drain(const Params& p, const TraceScene& scene,
                                      const float* __restrict__ shade_rows, const Images* images,
                                      const uint32_t* __restrict__ sobol, int px, int py,
                                      int limit, Path& s, bool& alive, int& sample, int& work) {
  const int stride = p.stride;
  unsigned group = kAllLanes;
  for (;;) {
    const bool more = alive || sample + stride < limit;
    if (WALK == kWalkRowQueue) group = __ballot_sync(group, more);
    if (!more) break;
    if (!alive) {
      sample += stride;
      s.rid = ray_id_of(p, sample, px, py);
      s.time = generate_ray(p, sobol, s.rid, px, py, sample, &s.o, &s.d);
      s.thr = mk(1.0f, 1.0f, 1.0f);
      s.depth = 0;
      alive = true;
    }
    work += 1;
    bool survives = bounce_step<IMAGES, WALK>(p, scene, shade_rows, images, s, group);
    s.depth += 1;
    alive = survives && s.depth < p.max_depth;
  }
}

// Host side: the image table from [n_images, then w, h, base, stride per
// image] as the wrappers pack it (ops/fused_render.py:image_args); false when
// n_images is out of range.
inline bool read_images(const int* ints, const int* texels, Images* out) {
  *out = Images{};
  out->texels = texels;
  out->n_images = ints[0];
  if (out->n_images < 1 || out->n_images > kMaxImages) return false;
  for (int k = 0; k < out->n_images; ++k) {
    out->w[k] = ints[1 + 4 * k];
    out->h[k] = ints[2 + 4 * k];
    out->base[k] = ints[3 + 4 * k];
    out->stride[k] = ints[4 + 4 * k];
  }
  return true;
}

// Host side: Params from the int32 and float32 arrays the wrappers pack
// (ops/fused_render.py:_params), in their order.
inline Params read_params(const int* iparams, const float* fparams) {
  Params p;
  int k = 0;
  p.width = iparams[k++];
  p.height = iparams[k++];
  p.spp = iparams[k++];
  p.stride = iparams[k++];
  p.max_depth = iparams[k++];
  p.sampler = iparams[k++];
  p.log2_scale = iparams[k++];
  p.strat_sqrt = iparams[k++];
  p.seed = (uint32_t)iparams[k++];
  p.n_sph = iparams[k++];
  p.n_quad = iparams[k++];
  p.n_rows = iparams[k++];
  p.n_lights = iparams[k++];
  p.needs_gauss = iparams[k++];
  p.has_dof = iparams[k++];
  for (int l = 0; l < kMaxLights; ++l) p.light_kind[l] = iparams[k++];
  int f = 0;
  p.t_min = fparams[f++];
  p.strat_recip = fparams[f++];
  for (int c = 0; c < 3; ++c) p.cam_pos[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.pixel00[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.du[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.dv[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.defocus_u[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.defocus_v[c] = fparams[f++];
  for (int c = 0; c < 3; ++c) p.bg[c] = fparams[f++];
  for (int l = 0; l < kMaxLights; ++l)
    for (int c = 0; c < kLightFloats; ++c) p.light[l][c] = fparams[f++];
  return p;
}

}  // namespace zwrt
