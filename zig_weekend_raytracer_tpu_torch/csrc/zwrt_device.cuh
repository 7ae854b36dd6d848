// Device functions of the path tracer, shared by the CUDA kernels of
// zig_weekend_raytracer_tpu_torch: PCG4D, Sobol, camera rays with the
// defocus disk, sphere and quad hits, the closest-hit stages (brute scan,
// slab test, leaf sweep, skip-link tree walk), shade-record reads, the five
// materials, the light-list PDF, sphere and quad UVs with the image texel
// fetch (from the atlas or the texture LUT), and the bounce step and
// regenerating drain that the render and bounce kernels share
// (render_kernels.cuh), with the estimator options (Russian roulette, the
// indirect clamp) compiled into their kFlagEstimator instantiations.  All three kernels trace through trace_closest, a
// template on the tree walk (Walk):
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
// The factored sampler's tables (sampling/sobol.py:sobol_p_tables): per
// dimension and per byte of the sample index, 256 u32.
constexpr int kSobolByteVals = 256;

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
// Tree walks (ops/trace.py:WALKS, in its order), then kWalkNoTree, which
// the launches of every walk but uni take on a scene where neither kind has
// a tree (render_kernels.cuh:dispatch_flags_walk): two brute stages, no
// walk's code or state.  kWalkNoTree is never a launch's walk code.
enum Walk {
  kWalkCond = 0, kWalkQueue = 1, kWalkRowQueue = 2, kWalkSpec = 3, kWalkUni = 4,
  kWalkNoTree = 5
};
// Threads per block of the render and bounce launchers
// (ops/fused_render.py:THREADS).
constexpr int kThreads = 128;
// Leaf entries of kWalkQueue's per-thread queue in shared memory
// (ops/trace.py:QUEUE_CAP): the walk sweeps them when it holds this many.
// Chosen on an NVIDIA H100 80GB HBM3 at 700 W from 4, 8 and 16, each a
// throwaway build timed at five plans of balls and rtw_final (PERF.md): 8
// was the fastest summed over the three main paths and the only one ahead
// of the design it replaced on all five; 4 ran the rtw_final paths 1-8%
// faster but balls 6% slower, 16 balls 1-3% faster but rtw_final 12-21%
// slower.
constexpr int kQueueCap = 8;
// The walks whose lanes walk a warp's node pointer together: they read the
// group of lanes that trace together (trace_closest's ``group``).
__host__ __device__ constexpr bool warp_walk(int walk) { return walk == kWalkRowQueue; }
// Shared memory of a block that kWalkRowQueue fills with packed tree nodes
// (ops/fused_render.py:ROWQUEUE_NODE_BYTES): 448 nodes of 32 bytes, so that
// with the staged Sobol tables of up to 65,536 samples and the warp queues
// of rtw_final at the port's leaf span a block of 64 registers a thread
// keeps its 8 blocks per SM (228 KB of shared memory, 1 KB reserved a
// block).  Registers, not this, set the render kernel's rowqueue
// instantiation at 6 blocks per SM: ptxas gives it 80 registers.
constexpr int kRowQueueNodeBytes = 14336;
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
// Rec.709 luminance weights (dtypes.py) and Russian roulette's survival
// floor (sampling/hashrng.py:RR_P_MIN).
constexpr float kLumR = 0.2126f;
constexpr float kLumG = 0.7152f;
constexpr float kLumB = 0.0722f;
constexpr float kRrPMin = 0.05f;

// Everything a launch needs besides the scene tables, passed by value: the
// light list is a device table of any length (``light_kind`` (n_lights,),
// ``light`` (n_lights, kLightFloats)), and ``sobol_p`` the factored
// sampler's (2, sobol_bytes, 256) u32 tables, which the kernels stage in
// shared memory (stage_sobol), for every sample index the launch renders.
// ``rr_start`` (Russian roulette's first bounce) and ``clamp`` (the
// indirect luminance clamp), 0 for off, are read by the kFlagEstimator
// instantiations only.
struct Params {
  int width, height, spp, stride, max_depth;
  int sampler, log2_scale, strat_sqrt;
  uint32_t seed;
  int n_sph, n_quad, n_rows, n_lights, needs_gauss, has_dof, sobol_bytes, rr_start;
  float t_min, strat_recip;
  float cam_pos[3], pixel00[3], du[3], dv[3], defocus_u[3], defocus_v[3], bg[3];
  float clamp;
  const int* light_kind;
  const float* light;
  const uint32_t* sobol_p;
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

__device__ __forceinline__ uint32_t sobol_u32(const uint32_t* cols, uint64_t index) {
  uint32_t v = 0;
  for (int i = 0; i < kSobolCols; ++i)
    v ^= cols[i] & (0u - (uint32_t)((index >> i) & 1ull));
  return v;
}

__device__ __forceinline__ float sobol_unit(uint32_t v) {
  return clamp_max(__uint2float_rn(v) * 2.3283064365386963e-10f, kOneMinusEps);
}

// The dynamic shared memory of a block: the factored Sobol tables first
// (stage_sobol), then kWalkRowQueue's staged tree nodes (stage_nodes) and
// its warp queues (warp_queues).
__device__ __forceinline__ uint32_t* dyn_smem() {
  extern __shared__ __align__(16) uint32_t zwrt_dyn_smem[];
  return zwrt_dyn_smem;
}

// Every step of the pixel sampler is an XOR of table columns, so the u32
// of dimension d at (sample s, pixel px, py) factors into a sample part
// and a pixel part, v_d = P_d(s) ^ Q_d(px, py) (sampling/sobol.py:
// sobol_pixel_u32_factored).  Q_d is this lane's, computed once at drain
// entry by the bit loops with s = 0; P_d is read from byte tables that
// each block stages in shared memory, so a respawn costs sobol_bytes
// shared loads and XORs per dimension in place of ~150 loop steps.
struct SobolPixel {
  uint32_t q0, q1;
};

__device__ __forceinline__ SobolPixel sobol_pixel(const Params& p, const uint32_t* tab, int px,
                                                  int py) {
  SobolPixel q{0u, 0u};
  if (p.sampler == kSobol) {
    uint64_t idx = sobol_interval_to_index(tab, p.log2_scale, 0u, (uint32_t)px, (uint32_t)py);
    q.q0 = sobol_u32(tab + kSobolDim0, idx);
    q.q1 = sobol_u32(tab + kSobolDim1, idx);
  }
  return q;
}

// P_d(s) from dimension ``dim``'s byte tables in shared memory.
__device__ __forceinline__ uint32_t sobol_sample_part(const Params& p, int dim, uint32_t s) {
  const uint32_t* t = dyn_smem() + dim * p.sobol_bytes * kSobolByteVals;
  uint32_t v = 0;
  for (int k = 0; k < p.sobol_bytes; ++k) v ^= t[k * kSobolByteVals + ((s >> (8 * k)) & 0xFFu)];
  return v;
}

// Copies the factored sampler's tables to the start of the block's dynamic
// shared memory.  Every thread of the block calls it before any returns.
__device__ __forceinline__ void stage_sobol(const Params& p) {
  if (p.sampler != kSobol) return;
  uint32_t* dst = dyn_smem();
  const int words = 2 * p.sobol_bytes * kSobolByteVals;
  for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = __ldg(p.sobol_p + k);
  __syncthreads();
}

// Host side: the bytes of the staged tables.
inline size_t sobol_smem_bytes(const Params& p) {
  return p.sampler == kSobol ? (size_t)2 * p.sobol_bytes * kSobolByteVals * sizeof(uint32_t) : 0;
}

__device__ __forceinline__ uint32_t ray_id_of(const Params& p, int sample, int px, int py) {
  return ((uint32_t)sample * (uint32_t)p.height + (uint32_t)py) * (uint32_t)p.width + (uint32_t)px;
}

// Camera ray of one (pixel, sample); returns the time draw.  The Sobol
// u32s come from the factored tables and this lane's pixel part ``q``.
__device__ __forceinline__ float generate_ray(const Params& p, SobolPixel q, uint32_t rid,
                                              int px, int py, int sample, V3* origin,
                                              V3* direction) {
  float pxf = (float)px, pyf = (float)py;
  float ox, oy;
  if (p.sampler == kSobol) {
    const uint32_t v0 = q.q0 ^ sobol_sample_part(p, 0, (uint32_t)sample);
    const uint32_t v1 = q.q1 ^ sobol_sample_part(p, 1, (uint32_t)sample);
    float fscale = (float)(1 << p.log2_scale);
    float sx = sobol_unit(v0);
    float sy = sobol_unit(v1);
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
// ``nodes`` is the tree's packed node table (PackedNode), set for a launch
// of every walk but kWalkCond and kWalkUni (null for those).  Under
// kWalkRowQueue the block stages the first ``n_staged`` nodes (in preorder)
// in its dynamic shared memory from word ``staged_word`` (stage_nodes); 0
// for every other walk.
struct KindTables {
  int mode, n_prims, n_nodes, span, n_staged, staged_word;
  const float* tab;
  const float* box;
  const int* link;
  const int* oi;
  const float4* nodes;
};

// A tree node packed into 32 bytes, two float4 (ops/fused_render.py:
// pack_nodes): lo = [min x y z, miss link], hi = [max x y z, leaf word],
// the two ints as their bits.  The leaf word is the first leaf group times
// 2 plus the leaf's kind (the unified tree's; 0 in a per-kind tree), or -1
// for an interior node.  The kWalkQueue, kWalkRowQueue, kWalkSpec and
// kWalkUni walks read it with two 16-byte loads a step, where ``box`` and
// ``link`` take nine scattered words.
struct PackedNode {
  float4 lo, hi;
};

__device__ __forceinline__ PackedNode load_node(const float4* nodes, int node) {
  return PackedNode{__ldg(nodes + 2 * node), __ldg(nodes + 2 * node + 1)};
}
__device__ __forceinline__ int miss_of(const PackedNode& n) { return __float_as_int(n.lo.w); }
__device__ __forceinline__ int leaf_word_of(const PackedNode& n) { return __float_as_int(n.hi.w); }

// ``usph`` and ``uquad`` are the unified tree's leaf tables (tab, oi and
// span read), ``ubox`` (u_nodes, 6) and ``ulink`` (u_nodes, 3) [miss
// link, first leaf group or -1, leaf kind] its nodes as the wrappers pack
// them (no device walk reads them: they keep the parameter's layout), and
// ``unodes`` the same nodes packed (kWalkUni; null for a launch of another
// walk).  ``queue`` is the per-thread leaf queue in device memory of
// kWalkSpec and kWalkUni, lane-major:
// entry j of thread t at queue[j * q_stride + t], q_stride the launch's
// thread count.  The others keep theirs in the block's dynamic shared
// memory from word ``q_smem_words``: kWalkQueue kQueueCap entries per
// thread (bounded_queue), kWalkRowQueue q_cap entries per warp
// (warp_queues).
struct TraceScene {
  KindTables sph, quad;
  int has_moving;
  KindTables usph, uquad;
  int u_nodes;
  const float* ubox;
  const int* ulink;
  const float4* unodes;
  int* queue;
  int q_stride, q_cap, q_smem_words;
};

// Robust slab test (math/aabb.py:aabb_hit) of the box [lo, hi] against
// the running best t: the one copy of the NaN-ordered arithmetic, which
// every walk's bitwise parity rests on.
__device__ __forceinline__ bool slab_test(float lx, float ly, float lz, float hx, float hy,
                                          float hz, V3 o, V3 inv_d, float t_min, float t) {
  float tx0 = (lx - o.x) * inv_d.x;
  float tx1 = (hx - o.x) * inv_d.x;
  float ty0 = (ly - o.y) * inv_d.y;
  float ty1 = (hy - o.y) * inv_d.y;
  float tz0 = (lz - o.z) * inv_d.z;
  float tz1 = (hz - o.z) * inv_d.z;
  float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                       nan_max(nan_min(tz0, tz1), t_min));
  float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                      nan_min(nan_max(tz0, tz1), t)) * kAabbMaxMult;
  return far > near;
}

// slab_test of a node's six floats [min xyz, max xyz].
__device__ __forceinline__ bool slab_hit(const float* b, V3 o, V3 inv_d, float t_min, float t) {
  return slab_test(b[0], b[1], b[2], b[3], b[4], b[5], o, inv_d, t_min, t);
}

// slab_test of a packed node's box.
__device__ __forceinline__ bool slab_hit_packed(const PackedNode& n, V3 o, V3 inv_d, float t_min,
                                                float t) {
  return slab_test(n.lo.x, n.lo.y, n.lo.z, n.hi.x, n.hi.y, n.hi.z, o, inv_d, t_min, t);
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

// kWalkQueue's leaf queue of this thread: kQueueCap entries in the block's
// dynamic shared memory after the staged Sobol tables, lane-major (entry j
// of thread t at word j * kThreads + t), so that a warp's 32 lanes fall in
// 32 banks whatever entry each of them is at.
__device__ __forceinline__ int* bounded_queue(const TraceScene& s) {
  return reinterpret_cast<int*>(dyn_smem() + s.q_smem_words) + threadIdx.x;
}

// kWalkQueue, replacing pallas_bounce.py:_tree_pass_queue with
// per_row=False (:466).  Bound on this card: operations, the slab tests and
// leaf rows that the cond walk needs on the same trees, at K5's rates
// (utils/roofline.py, chip_smoke.py:walk_bound_counts); its packed nodes and
// leaf rows stay in L1 and L2, and its queue in shared memory, so bytes do
// not bound it.  chip_smoke.py phase 18 on an NVIDIA H100 80GB HBM3 at
// 700 W, at the port's leaf span: the bounce kernel on rtw_final
// 400x400@16 d8 takes 6.542 ms against a bound of 0.402 ms, the render
// kernel with the texture LUT 6.485, on balls 400x400@32 d10 9.301 against
// 0.961 (the design it replaced: 7.983, 7.697 and 9.110 ms, PERF.md); ptxas
// gives the render and regenerating bounce instantiations 72 registers, so
// 7 blocks a SM where the replaced design's 64 gave 8.  That design walked
// with the stage's seed t, pushed every hit leaf to a queue of (n_nodes +
// 1) / 2 ints a thread in device memory, each push and read-back its own
// 32-byte sector, and read the unpacked nodes (nine scattered words a
// step).
// Design, K3's bounded queue walk (closest_hit.cu:tree_walk_bounded) over
// packed nodes: (a) each step reads one packed 32-byte node (two 16-byte
// loads) and culls with the thread's running best t; (b) a hit leaf goes to
// this thread's kQueueCap entries of shared memory (bounded_queue) in
// preorder; (c) when the queue holds kQueueCap leaves, or the walk has
// ended, the thread sweeps them in order, and the walk goes on from the node
// where it stopped under the t the sweep tightened.  The walk's loop holds
// only slab tests, so a warp's threads stay together through it and meet
// again in the sweeps.  Leaves are swept in the order the cond walk sweeps
// them and only a strictly closer hit replaces the best, so the hits are the
// cond walk's, bitwise: a leaf that a stale t admits gives no strictly
// closer hit (a parent's box holds its children's and the slab test is
// monotone in t).
template <int KIND>
__device__ __forceinline__ void tree_walk_queue(const KindTables& k, const TraceScene& s,
                                                const Ray& ray, bool moving, float* best,
                                                int* kind, int* idx) {
  int* q = bounded_queue(s);
  int node = 0;
  do {
    int sp = 0;
    while (node < k.n_nodes && sp < kQueueCap) {
      const PackedNode n = load_node(k.nodes, node);
      const bool hit = slab_hit_packed(n, ray.o, ray.inv_d, ray.t_min, *best);
      const int leaf = leaf_word_of(n);
      if (hit && leaf >= 0) q[(sp++) * kThreads] = leaf >> 1;
      node = (hit && leaf < 0) ? node + 1 : miss_of(n);
    }
    for (int j = 0; j < sp; ++j)
      leaf_sweep<KIND>(k, q[j * kThreads], ray, moving, best, kind, idx);
  } while (node < k.n_nodes);
}

// kWalkRowQueue's warp queues, after the staged Sobol tables and nodes.
__device__ __forceinline__ int2* warp_queues(const TraceScene& s) {
  return reinterpret_cast<int2*>(dyn_smem() + s.q_smem_words);
}

// Copies the first n_staged packed nodes of each kind's tree to the block's
// dynamic shared memory (set_walk places them after the Sobol tables).
// Every thread of the block calls it before any returns.
__device__ __forceinline__ void stage_kind_nodes(const KindTables& k) {
  float4* dst = reinterpret_cast<float4*>(dyn_smem() + k.staged_word);
  for (int j = threadIdx.x; j < 2 * k.n_staged; j += blockDim.x) dst[j] = __ldg(k.nodes + j);
}

__device__ __forceinline__ void stage_nodes(const TraceScene& s) {
  stage_kind_nodes(s.sph);
  stage_kind_nodes(s.quad);
  if (s.sph.n_staged + s.quad.n_staged > 0) __syncthreads();
}

// Node ``node`` of a kWalkRowQueue walk: from shared memory when staged, a
// broadcast read where the warp's lanes agree on ``node``, else two __ldg.
__device__ __forceinline__ PackedNode walk_node(const KindTables& k, int node) {
  if (node < k.n_staged) {
    const float4* n = reinterpret_cast<const float4*>(dyn_smem() + k.staged_word) + 2 * node;
    return PackedNode{n[0], n[1]};
  }
  return load_node(k.nodes, node);
}

// kWalkRowQueue, replacing pallas_bounce.py:_tree_pass_queue with
// per_row=True (:466; its row mask :507-520, its per-row drain :544-594).
// Bound on this card: operations, the slab tests and leaf rows that the
// cond walk needs on the same trees, at K5's rates (utils/roofline.py,
// chip_smoke.py:walk_bound_counts); its nodes sit in shared memory and its
// leaf rows in L1 and L2, so bytes do not bound it.  chip_smoke.py phase
// 18 on an NVIDIA H100 80GB HBM3 at 700 W, leaf span 2: the render kernel
// on balls 400x400@32 d10 takes 13.693 ms against a bound of 1.159 ms, the
// bounce kernel on rtw_final 400x400@16 d8 12.971 against 0.485 (the
// design it replaced, the same lockstep walk over the unpacked nodes with
// no second test before the sweep: 15.030 and 15.078 ms; PERF.md).  The lockstep walk's union of its lanes' paths is what it loses
// to the queue walk: 1.6 to 3.5 times the cond walk's slab tests.  The
// lanes of ``group`` walk one node pointer, descending when any of them
// hits the node's box with its seed t, so the warp follows the union of
// their paths.  ``group`` names the lanes of this warp that trace in this step,
// and the caller takes it with a ballot that all of them reach (drain's
// loop head, the one-bounce mode's entry): __activemask() would name only
// the lanes that happen to run converged, which independent thread
// scheduling does not promise, and two such subsets would share the warp's
// queue.  Each __ballot_sync(group, ...) makes the group meet.  Design: (a)
// every step reads one packed 32-byte node at a warp-uniform index, from
// the block's staged copy (stage_nodes: a broadcast read from shared
// memory, no bank conflict) or, past the staged preorder prefix, through
// __ldg; (b) a hit leaf goes to the warp's queue as (its node, the ballot
// of the lanes that hit it), every lane writing the same entry, so each
// reads back its own write; (c) before sweeping an entry, each marked lane
// re-tests the leaf's box against its fresh t, and the warp skips an entry
// that no lane still hits: a leaf that cannot give a strictly closer hit
// is never swept, so each lane sweeps the cond walk's leaves (a parent's
// box holds its children's and the slab test is monotone in t) and the
// hits are bitwise the cond walk's.  The group meets before the queue is
// reused.
template <int KIND>
__device__ __forceinline__ void tree_walk_warpqueue(const KindTables& k, const TraceScene& s,
                                                    const Ray& ray, bool moving, unsigned group,
                                                    float* best, int* kind, int* idx) {
  const unsigned me = 1u << (threadIdx.x % kWarp);
  int2* q = warp_queues(s) + (threadIdx.x / kWarp) * s.q_cap;
  const float t_seed = *best;
  int node = 0, sp = 0;
  while (node < k.n_nodes) {
    const PackedNode n = walk_node(k, node);
    const bool hit = slab_hit_packed(n, ray.o, ray.inv_d, ray.t_min, t_seed);
    const unsigned bits = __ballot_sync(group, hit);
    const int leaf = leaf_word_of(n);
    if (bits != 0u && leaf >= 0) q[sp++] = make_int2(node, (int)bits);
    node = (bits != 0u && leaf < 0) ? node + 1 : miss_of(n);
  }
  for (int j = 0; j < sp; ++j) {
    const int2 e = q[j];
    const PackedNode n = walk_node(k, e.x);
    const bool again =
        ((unsigned)e.y & me) && slab_hit_packed(n, ray.o, ray.inv_d, ray.t_min, *best);
    if (__ballot_sync(group, again) == 0u) continue;
    if (again) leaf_sweep<KIND>(k, leaf_word_of(n) >> 1, ray, moving, best, kind, idx);
  }
  __syncwarp(group);
}

// The per-thread leaf queue of this thread in device memory (kWalkSpec,
// kWalkUni), lane-major.
__device__ __forceinline__ int* thread_queue(const TraceScene& s) {
  return s.queue + blockIdx.x * blockDim.x + threadIdx.x;
}

// kWalkSpec, replacing pallas_bounce.py:_tree_pass_spec (:640).  Bound on
// this card: operations, the slab tests and leaf rows that the cond walk
// needs on the same trees, at K5's rates (utils/roofline.py prices the
// plain cond walk's counts, ops/trace.py); its packed nodes and leaf rows
// stay in L1 and L2, so bytes do not bound it.  chip_smoke.py phase 18 on
// an NVIDIA H100 80GB HBM3 at 700 W, leaf span 2: the bounce kernel on
// rtw_final 400x400@16 d8 takes 9.612 ms against a bound of 0.481 ms, the
// render kernel on balls 400x400@32 d10 12.275 against 1.151 (the design
// it replaced, which swept each hit leaf inline over the unpacked nodes:
// 11.525 and 19.320 ms; PERF.md).  Design: each step issues the loads of
// both successors (node + 1 and the miss link, clamped for the load only)
// and slab-tests them against the stage's seed t, so the next node's box is
// in flight while this step's test and branch resolve, and the loop carries
// only (node, its miss link and leaf word, its hit, cursor).  A hit leaf is
// pushed to the per-thread queue in preorder and the queue is swept after
// the walk with the fresh t: the walk loop has no
// sweep to wait behind, and the hits are bitwise the cond walk's (a stale t
// only admits more leaves; only a strictly closer hit replaces the best).
// Each step reads two packed 32-byte nodes (PackedNode).  The queue holds
// at most (n_nodes + 1) / 2 leaves, which the wrapper's capacity covers.
template <int KIND>
__device__ __forceinline__ void tree_walk_spec(const KindTables& k, const TraceScene& s,
                                               const Ray& ray, bool moving, float* best,
                                               int* kind, int* idx) {
  int* q = thread_queue(s);
  const int stride = s.q_stride;
  const float t_seed = *best;
  const int last = k.n_nodes - 1;
  PackedNode cur = load_node(k.nodes, 0);
  bool hit = slab_hit_packed(cur, ray.o, ray.inv_d, ray.t_min, t_seed);
  int miss = miss_of(cur), leaf = leaf_word_of(cur);
  int node = 0, sp = 0;
  while (node < k.n_nodes) {
    const PackedNode desc_n = load_node(k.nodes, node + 1 < last ? node + 1 : last);
    const PackedNode miss_n = load_node(k.nodes, miss < last ? miss : last);
    const bool hit_desc = slab_hit_packed(desc_n, ray.o, ray.inv_d, ray.t_min, t_seed);
    const bool hit_miss = slab_hit_packed(miss_n, ray.o, ray.inv_d, ray.t_min, t_seed);
    if (hit && leaf >= 0) q[(sp++) * stride] = leaf >> 1;
    const bool desc = hit && leaf < 0;
    node = desc ? node + 1 : miss;
    hit = desc ? hit_desc : hit_miss;
    miss = desc ? miss_of(desc_n) : miss_of(miss_n);
    leaf = desc ? leaf_word_of(desc_n) : leaf_word_of(miss_n);
  }
  for (int j = 0; j < sp; ++j) leaf_sweep<KIND>(k, q[j * stride], ray, moving, best, kind, idx);
}

// kWalkUni, replacing pallas_bounce.py:_uni_tree_pass (:713).  Bound on
// this card: operations, as tree_walk_spec, from the cond walk of the
// unified tree (ops/trace.py:uni_cond_walk); on rtw_final 400x400@16 d8
// (chip_smoke.py phase 18, NVIDIA H100 80GB HBM3, 700 W) the bounce kernel
// takes 10.220 ms against 0.490 at leaf span 2 and 8.397 against 0.390 at
// the port's span 1 (the design it replaced, one cond walk of the unified
// tree that swept each leaf inline: 16.324 and 9.597 ms; PERF.md).  Design: one walk of the
// unified tree with the stage's seed t and only (node, cursors) live, over
// packed 32-byte nodes (two 16-byte loads a step); the loop has no
// leaf-kind branch and no sweep: a hit leaf is pushed to the per-thread
// queue, spheres from its front and quads from its back, each in preorder.
// The sweep then takes every sphere leaf and then every quad leaf with the
// fresh t, so a warp runs one kind's leaf_sweep at a time instead of both
// kinds' one after the other on every mixed step.  Only a strictly closer
// hit replaces the best, so a sphere keeps a tie with a quad, as in the
// per-kind stages (sphere stage, then quad stage).  The two ends together
// hold at most (u_nodes + 1) / 2 leaves, within the wrapper's capacity.
__device__ __forceinline__ void uni_tree_walk(const TraceScene& s, const Ray& ray, bool moving,
                                              float* best, int* kind, int* idx) {
  int* q = thread_queue(s);
  const int stride = s.q_stride;
  const float t_seed = *best;
  int node = 0, n_sph = 0, quad0 = s.q_cap;
  while (node < s.u_nodes) {
    const PackedNode n = load_node(s.unodes, node);
    const bool hit = slab_hit_packed(n, ray.o, ray.inv_d, ray.t_min, t_seed);
    const int leaf = leaf_word_of(n);
    if (hit && leaf >= 0) q[((leaf & 1) ? --quad0 : n_sph++) * stride] = leaf >> 1;
    node = (hit && leaf < 0) ? node + 1 : miss_of(n);
  }
  for (int j = 0; j < n_sph; ++j)
    leaf_sweep<kSphere>(s.usph, q[j * stride], ray, moving, best, kind, idx);
  for (int j = s.q_cap - 1; j >= quad0; --j)
    leaf_sweep<kQuad>(s.uquad, q[j * stride], ray, false, best, kind, idx);
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
  else if (WALK == kWalkSpec) tree_walk_spec<KIND>(k, s, ray, moving, best, kind, idx);
  else tree_walk<KIND>(k, ray, moving, best, kind, idx);
}

// The closest hit of one ray below ``t_start``; kind -1 on a miss, with
// *best then still t_start.  WALK picks the tree walk at compile time
// (kWalkNoTree: none, for a scene without trees); kWalkRowQueue reads
// ``group``, the lanes of the warp that call it together
// (tree_walk_warpqueue).
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
  else if (WALK != kWalkNoTree && s.sph.mode == kTraceTree)
    tree_stage<kSphere, WALK>(s.sph, s, ray, moving, group, best, kind, idx);
  if (s.quad.mode == kTraceBrute) brute_stage<kQuad>(s.quad, ray, false, best, kind, idx);
  else if (WALK != kWalkNoTree && s.quad.mode == kTraceTree)
    tree_stage<kQuad, WALK>(s.quad, s, ray, false, group, best, kind, idx);
}

// Whether a launch's scene has a per-kind tree: without one, every walk but
// uni traces as kWalkNoTree does.
inline bool has_kind_tree(const TraceScene& s) {
  return s.sph.mode == kTraceTree || s.quad.mode == kTraceTree;
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

// Host side: the packed node tables (PackedNode) of a launch of any walk
// but kWalkCond from the host array the wrappers pack
// (ops/fused_render.py:node_args): the sphere tree's, the quad tree's and
// the unified tree's (null where the scene has no such tree); ``nodes``
// null for a kWalkCond launch, which reads none.
inline void set_nodes(TraceScene* s, const void* const* nodes) {
  if (nodes == nullptr) return;
  s->sph.nodes = static_cast<const float4*>(nodes[0]);
  s->quad.nodes = static_cast<const float4*>(nodes[1]);
  s->unodes = static_cast<const float4*>(nodes[2]);
}

// Host side: checks a launch's walk against the scene and sets up its leaf
// queue.  kWalkQueue keeps kQueueCap entries per thread (``q_cap`` must say
// so: the wrapper priced that queue) in the block's dynamic shared memory
// after the ``smem_before`` bytes of staged tables, where its scene has a
// tree; kWalkRowQueue ``q_cap`` entries per warp there, after the first
// nodes in preorder of the sphere tree and then of the quad tree, as many
// as kRowQueueNodeBytes holds (stage_nodes); kWalkSpec and kWalkUni
// ``q_cap`` entries per thread in ``queue`` (``queue_len`` ints).  *smem is
// the block's dynamic shared memory in all.  Returns a cudaError_t: invalid
// for an unknown walk, a uni walk without the unified tree, a walk other
// than cond without its packed nodes, a per-thread or per-warp queue whose
// capacity does not cover the leaves of the trees it walks (a tree of n
// nodes has at most (n + 1) / 2; those walks push without a check, and the
// uni walk fills its queue from both ends), a device queue too short for
// the capacity, or a kWalkQueue launch whose ``q_cap`` is not kQueueCap.
inline int set_walk(TraceScene* s, int walk, int q_cap, int* queue, int queue_len, int blocks,
                    int threads, size_t smem_before, size_t* smem) {
  s->queue = queue;
  s->q_stride = blocks * threads;
  s->q_cap = q_cap;
  *smem = smem_before;
  if (walk < kWalkCond || walk > kWalkUni || q_cap < 0) return (int)cudaErrorInvalidValue;
  if (walk == kWalkUni &&
      (s->u_nodes < 1 || s->unodes == nullptr || q_cap < (s->u_nodes + 1) / 2))
    return (int)cudaErrorInvalidValue;
  const bool bounded = walk == kWalkQueue;
  KindTables* kinds[2] = {&s->sph, &s->quad};
  int room = kRowQueueNodeBytes / (int)sizeof(PackedNode);
  bool trees = false;
  for (KindTables* k : kinds) {
    if (walk == kWalkCond || walk == kWalkUni || k->mode != kTraceTree) continue;
    trees = true;
    const bool covered = bounded ? q_cap == kQueueCap : q_cap >= (k->n_nodes + 1) / 2;
    if (!covered || k->nodes == nullptr) return (int)cudaErrorInvalidValue;
    if (walk == kWalkRowQueue) {
      k->n_staged = k->n_nodes < room ? k->n_nodes : room;
      k->staged_word = (int)(*smem / sizeof(uint32_t));
      room -= k->n_staged;
      *smem += (size_t)k->n_staged * sizeof(PackedNode);
    }
  }
  const bool per_thread = walk == kWalkSpec || walk == kWalkUni;
  if (per_thread && q_cap > 0 &&
      (queue == nullptr || (long long)queue_len < (long long)q_cap * s->q_stride))
    return (int)cudaErrorInvalidValue;
  s->q_smem_words = (int)(*smem / sizeof(uint32_t));
  if (walk == kWalkRowQueue) *smem += (size_t)(threads / kWarp) * q_cap * sizeof(int2);
  if (bounded && trees) *smem += (size_t)kQueueCap * kThreads * sizeof(int);
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
// Light list (render/pdfs.py); geometry from the device table Params::light
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 lv(const float* l, int i) { return mk(l[i], l[i + 1], l[i + 2]); }

__device__ __forceinline__ float light_pdf(const Params& p, V3 origin, V3 dir) {
  float total = 0.0f;
  for (int k = 0; k < p.n_lights; ++k) {
    const float* l = p.light + (size_t)k * kLightFloats;
    float pdf = 0.0f;
    if (__ldg(p.light_kind + k) == kSphere) {
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
  const float* l = p.light + (size_t)chosen * kLightFloats;
  if (__ldg(p.light_kind + chosen) == kSphere) {
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

// One table of images, texels r | g << 8 | b << 16, with a device table of
// any number of images: ``dims`` (n_images, 4) holds each image's w, h,
// base and row stride, and texel (x, y) of image i is at texels[base + y *
// stride + x].  The atlas (n_images, ah, aw) has base = i * ah * aw and
// stride = aw (textures.py:atlas_flat_index); the texture LUT has each
// image's own base and stride = w (textures.py:lut_flat_index).
constexpr int kImageDims = 4;

struct Images {
  const int* texels;
  const int* dims;
  int n_images;
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
  img = img < a.n_images ? img : a.n_images - 1;
  const int4 dim = __ldg(reinterpret_cast<const int4*>(a.dims) + img);
  const int wi = dim.x, hi = dim.y, base = dim.z, stride = dim.w;
  const float wf = (float)wi, hf = (float)hi;
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

// Instantiation flags of the drain and the kernels (render_kernels.cuh).
// kFlagProf: each thread adds clock64() deltas per phase (respawn, trace,
// shade) and, at each phase's entry, the converged lanes of its warp
// (__popc(__activemask())) to a Prof; kFlagEstimator: the shading applies
// Params' rr_start and clamp (shade_hit); kFlagPull: the drain takes its
// windows from the render kernel's work queue (Items, next_item).  The
// bounce kernel's default instantiations take 0, the render kernel's
// kFlagPull.
enum DrainFlags { kFlagProf = 1, kFlagEstimator = 2, kFlagPull = 4 };
enum ProfPhase { kPhaseRespawn = 0, kPhaseTrace = 1, kPhaseShade = 2, kPhases = 3 };
// Columns of a thread's profile (int64): cycles, entries and active lanes
// summed per phase, then the drain's whole cycles.
constexpr int kProfCols = 3 * kPhases + 1;

struct Prof {
  long long cycles[kPhases];
  long long entries[kPhases];
  long long active[kPhases];
  long long total;
};

template <bool PROF>
__device__ __forceinline__ long long prof_enter(Prof* pr, int phase) {
  if (!PROF) return 0;
  pr->entries[phase] += 1;
  pr->active[phase] += __popc(__activemask());
  return clock64();
}

template <bool PROF>
__device__ __forceinline__ void prof_leave(Prof* pr, int phase, long long t0) {
  if (PROF) pr->cycles[phase] += clock64() - t0;
}

// A radiance contribution landed at bounce ``depth``, scaled where depth >=
// 1 so that its luminance is at most ``clamp`` (the indirect clamp,
// render/integrator.py:_clamp_contrib); scaling by 1 leaves it exact.
__device__ __forceinline__ V3 clamp_contrib(V3 c, int depth, float clamp) {
  float lum = kLumR * c.x + kLumG * c.y + kLumB * c.z;
  float scale = (depth >= 1 && lum > clamp) ? clamp / clamp_min(lum, 1e-20f) : 1.0f;
  return c * scale;
}

// The estimator options of one live path's bounce (EST): whether Russian
// roulette applies at this bounce, its survival probability p from the
// incoming throughput, and whether the clamp is on.
struct Estimator {
  bool rr, clamp;
  float p;
};

template <bool EST>
__device__ __forceinline__ Estimator estimator_of(const Params& p, const Path& s) {
  Estimator e{false, false, 1.0f};
  if (EST) {
    e.rr = p.rr_start != 0 && s.depth >= p.rr_start;
    e.clamp = p.clamp != 0.0f;
    e.p = clamp_max(clamp_min(nan_max(s.thr.x, nan_max(s.thr.y, s.thr.z)), kRrPMin), 1.0f);
  }
  return e;
}

template <bool EST>
__device__ __forceinline__ V3 contrib(const Params& p, const Estimator& e, const Path& s, V3 c) {
  return (EST && e.clamp) ? clamp_contrib(c, s.depth, p.clamp) : c;
}

// Russian roulette's weight on the throughput at the end of a bounce where
// it applies (every live path's, as the plain version scales it).
template <bool EST>
__device__ __forceinline__ void rr_weight(const Estimator& e, Path& s) {
  if (EST && e.rr) s.thr = s.thr * (1.0f / e.p);
}

// The shading half of a bounce, after the closest hit (best, kind, idx):
// shade record, texture, the material's scatter.  Returns whether the path
// goes on (before the depth cutoff).  IMAGES compiles the image fetch: the
// texel of an image texture (or a checker's image child) replaces the
// record colour at the hit, before emission and scatter, as the XLA
// integrator and the JAX whole-render kernel's LUT fetch order it.  Without
// IMAGES ``images`` is never read.  EST compiles the estimator options
// (render/integrator.py:bounce, in its order): the clamp on the background
// and the emission, and Russian roulette against the site-3 draw after the
// scatter, its 1 / p weight on the throughput.
template <bool IMAGES, bool EST = false>
__device__ __forceinline__ bool shade_hit(const Params& p, const float* __restrict__ shade_rows,
                                          const Images* images, Path& s, float best, int kind,
                                          int idx) {
  const Estimator est = estimator_of<EST>(p, s);
  if (kind < 0) {
    // ---- miss: background, the path ends ----
    s.rad = s.rad + contrib<EST>(p, est, s, s.thr * mk(p.bg[0], p.bg[1], p.bg[2]));
    rr_weight<EST>(est, s);
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
    if (front) s.rad = s.rad + contrib<EST>(p, est, s, s.thr * tex_rgb);
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
  if (EST && est.rr) {
    survives = survives && !(uniform4(p.seed, s.rid, site + 3u).x >= est.p);
    rr_weight<EST>(est, s);
  }
  s.o = point;
  s.d = new_dir;
  return survives;
}

// One bounce of a live path: the closest hit (sphere stage, then quad
// stage, or the unified walk), then shade_hit (EST: with the estimator
// options).  ``group`` is the warp's lanes that bounce together, read by
// the rowqueue walks' trace only; PROF times the two halves into ``prof``.
template <bool IMAGES, int WALK, bool PROF = false, bool EST = false>
__device__ __forceinline__ bool bounce_step(const Params& p, const TraceScene& scene,
                                            const float* __restrict__ shade_rows,
                                            const Images* images, Path& s, unsigned group,
                                            Prof* prof = nullptr) {
  float best;
  int kind, idx;
  long long t0 = prof_enter<PROF>(prof, kPhaseTrace);
  trace_closest<WALK>(scene, s.o, s.d, s.time, p.t_min, kBig, &best, &kind, &idx, group);
  prof_leave<PROF>(prof, kPhaseTrace, t0);
  t0 = prof_enter<PROF>(prof, kPhaseShade);
  const bool survives = shade_hit<IMAGES, EST>(p, shade_rows, images, s, best, kind, idx);
  prof_leave<PROF>(prof, kPhaseShade, t0);
  return survives;
}

// The render kernel's work queue (kFlagPull).  An item is (plan lane,
// chunk): chunk c of lane l renders the samples s0 + stride * (c * chunk +
// j), j < chunk, below the lane's s1, so its window is its pixel's samples
// [s0 + stride * c * chunk, min(s1, s0 + stride * (c + 1) * chunk)).  Items
// are numbered chunk-major, item = c * n + l, ``total`` of them: chunk 0 of
// every lane in plan order, then chunk 1, so that threads taking items
// together get neighbouring lanes.  Thread t of the grid starts on item t;
// the ``first`` = grid threads' items after that are taken from ``next``
// (zeroed before the launch).  Item k's radiance sum goes to ``rad``
// (chunks, 3, n) at c * 3n + channel * n + l, its passes to ``work``
// (chunks, n) when set; ``thread_work``, when set, adds each item's passes
// to the row of the thread that rendered it (grid threads, zeroed).
struct Items {
  const int* px;
  const int* py;
  const int* s0;
  const int* s1;
  int* next;
  float* rad;
  int* work;
  int* thread_work;
  int n, chunk, total, first;
};

// ``item``'s pixel and window: ``sample`` one stride before its first
// sample, ``limit`` its end.
__device__ __forceinline__ void item_window(const Params& p, const Items& q, int item, int& px,
                                            int& py, int& sample, int& limit) {
  const int c = item / q.n, lane = item - c * q.n;
  const int start = q.s0[lane] + p.stride * c * q.chunk;
  px = q.px[lane];
  py = q.py[lane];
  limit = min(q.s1[lane], start + p.stride * q.chunk);
  sample = start - p.stride;
}

// The end of ``item``'s window, 0 past the queue's end, and its pixel:
// read again where a tree walk's drain needs them (a dead path's test and
// its respawn), so that only the item and the sample stay in registers
// across the trace (the queue walk's 72, 7 blocks a SM, with no spill).
__device__ __forceinline__ int item_limit(const Params& p, const Items& q, int item) {
  if (item >= q.total) return 0;
  const int c = item / q.n, lane = item - c * q.n;
  return min(q.s1[lane], q.s0[lane] + p.stride * (c + 1) * q.chunk);
}

__device__ __forceinline__ void item_pixel(const Items& q, int item, int& px, int& py) {
  const int lane = item % q.n;
  px = q.px[lane];
  py = q.py[lane];
}

// Writes ``item``'s sums, where it is an item, and starts the next item's
// from zero.
__device__ __forceinline__ void flush_item(const Items& q, int item, V3& rad, int& work) {
  if (item >= q.total) return;
  const int c = item / q.n, lane = item - c * q.n;
  float* r = q.rad + (size_t)c * 3 * q.n + lane;
  r[0] = rad.x;
  r[q.n] = rad.y;
  r[2 * q.n] = rad.z;
  if (q.work) q.work[(size_t)c * q.n + lane] = work;
  if (q.thread_work) q.thread_work[blockIdx.x * blockDim.x + threadIdx.x] += work;
  rad = mk(0.0f, 0.0f, 0.0f);
  work = 0;
}

// Starts the thread on ``item`` (item_window), ``sp`` its pixel's Sobol
// part; whether it has a sample to render.
__device__ __forceinline__ bool start_item(const Params& p, const Items& q,
                                           const uint32_t* __restrict__ sobol, int item, int& px,
                                           int& py, int& sample, int& limit, SobolPixel& sp) {
  item_window(p, q, item, px, py, sample, limit);
  if (sample + p.stride >= limit) return false;
  sp = sobol_pixel(p, sobol, px, py);
  return true;
}

// The next item for each calling thread: one atomic for the warp's threads
// that call together, which take consecutive items in lane order.
__device__ __forceinline__ int pull_item(const Items& q) {
  const unsigned m = __activemask();
  const int me = (int)(threadIdx.x & (kWarp - 1)), leader = __ffs(m) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(q.next, __popc(m));
  base = __shfl_sync(m, base, leader);
  return q.first + base + __popc(m & ((1u << me) - 1u));
}

// Lane-level refills: a thread's item is used up: writes its sums and
// takes items until one has a sample to render (start_item); false, its
// sums written, when the queue is empty.
__device__ __forceinline__ bool next_item(const Params& p, const Items& q,
                                          const uint32_t* __restrict__ sobol, int& item,
                                          Path& s, int& work, int& px, int& py, int& sample,
                                          int& limit, SobolPixel& sp) {
  for (;;) {
    flush_item(q, item, s.rad, work);
    item = pull_item(q);
    if (item >= q.total) return false;
    if (start_item(p, q, sobol, item, px, py, sample, limit, sp)) return true;
  }
}

// Warp-level refills: every item of the warp is used up: each thread
// writes its sums, and the warp takes the next kWarp items, thread k of
// the warp the k-th, so that its threads hold neighbouring lanes of the
// plan again (an item past the queue's end is an empty window); false,
// for every thread of the warp, when the queue is empty.
__device__ __forceinline__ bool refill_warp(const Params& p, const Items& q,
                                            const uint32_t* __restrict__ sobol, int& item,
                                            Path& s, int& work, int& sample, SobolPixel& sp) {
  flush_item(q, item, s.rad, work);
  const int me = (int)(threadIdx.x & (kWarp - 1));
  int base = 0;
  if (me == 0) base = atomicAdd(q.next, kWarp);
  base = q.first + __shfl_sync(kAllLanes, base, 0);
  if (base >= q.total) return false;
  item = base + me;
  sample = -p.stride;
  int px, py, limit;
  if (item < q.total) start_item(p, q, sobol, item, px, py, sample, limit, sp);
  return true;
}

// Runs one lane until its sample window is used up: a dead lane respawns
// its pixel's next sample (sample += stride, while below ``limit``), every
// pass counts one unit of work and runs one bounce, and a path ends after
// p.max_depth bounces.  Under kFlagPull the window is that of ``item`` of
// ``items`` (an empty one past the queue's end), the thread runs on until
// the queue is empty, and its sums go to the item's slots.  Without trees
// (kWalkNoTree) a thread whose window is used up takes the next item at
// once (next_item), so that it never waits for its warp's longest pixel;
// a tree walk's warp takes kWarp items when all of its threads' windows are
// used up (refill_warp), so that its threads walk neighbouring lanes of
// the coherent plan (on an H100, PERF.md: balls took 23.2 ms an image with
// warp-level refills against 33.7 with lane-level ones, while cornell took
// 73.6 with lane-level refills against 75.5).  A ballot at
// the loop head, which every lane of the warp still in the loop reaches,
// names the lanes that bounce in this pass: the group of the rowqueue
// walks (warp_walk, tree_walk_warpqueue), and under kFlagPull the point
// where the warp's threads converge again each pass (without it a thread
// that refilled alone ran on out of step with its warp).  The lane's Sobol
// pixel part is computed once a pixel, at entry (timed with the respawn
// phase) or at a pull; FLAGS as DrainFlags, ``prof`` read under kFlagProf
// only.
template <bool IMAGES, int WALK, int FLAGS = 0>
__device__ __forceinline__ void drain(const Params& p, const TraceScene& scene,
                                      const float* __restrict__ shade_rows, const Images* images,
                                      const uint32_t* __restrict__ sobol, int px, int py,
                                      int limit, Path& s, bool& alive, int& sample, int& work,
                                      Prof* prof = nullptr, const Items* items = nullptr,
                                      int item = 0) {
  constexpr bool PROF = (FLAGS & kFlagProf) != 0;
  constexpr bool EST = (FLAGS & kFlagEstimator) != 0;
  constexpr bool PULL = (FLAGS & kFlagPull) != 0;
  constexpr bool LANE_PULL = PULL && WALK == kWalkNoTree;
  constexpr bool WARP_PULL = PULL && WALK != kWalkNoTree;
  const long long t_start = PROF ? clock64() : 0;
  SobolPixel q = sobol_pixel(p, sobol, px, py);
  if (PROF) prof->cycles[kPhaseRespawn] += clock64() - t_start;
  const int stride = p.stride;
  unsigned group = kAllLanes;
  for (;;) {
    bool more = alive || sample + stride < (WARP_PULL ? item_limit(p, *items, item) : limit);
    if (LANE_PULL && !more)
      more = next_item(p, *items, sobol, item, s, work, px, py, sample, limit, q);
    if (WARP_PULL) {
      group = __ballot_sync(kAllLanes, more);
      if (group == 0u) {
        if (!refill_warp(p, *items, sobol, item, s, work, sample, q)) break;
        more = sample + stride < item_limit(p, *items, item);
        group = __ballot_sync(kAllLanes, more);
      }
      if (!more) continue;
    } else {
      if (warp_walk(WALK) || LANE_PULL) group = __ballot_sync(group, more);
      if (!more) break;
    }
    if (!alive) {
      long long t0 = prof_enter<PROF>(prof, kPhaseRespawn);
      if (WARP_PULL) item_pixel(*items, item, px, py);
      sample += stride;
      s.rid = ray_id_of(p, sample, px, py);
      s.time = generate_ray(p, q, s.rid, px, py, sample, &s.o, &s.d);
      s.thr = mk(1.0f, 1.0f, 1.0f);
      s.depth = 0;
      alive = true;
      prof_leave<PROF>(prof, kPhaseRespawn, t0);
    }
    work += 1;
    bool survives =
        bounce_step<IMAGES, WALK, PROF, EST>(p, scene, shade_rows, images, s, group, prof);
    s.depth += 1;
    alive = survives && s.depth < p.max_depth;
  }
  if (PROF) prof->total += clock64() - t_start;
}

// Host side: the image table of ``n_images`` images, ``dims`` (n_images, 4)
// and ``texels`` device tables as the wrappers pack them
// (ops/fused_render.py:image_args); false when either is missing.
inline bool read_images(int n_images, const int* dims, const int* texels, Images* out) {
  *out = Images{texels, dims, n_images};
  return n_images >= 1 && dims != nullptr && texels != nullptr;
}

// Host side: Params from the int32 and float32 host arrays the wrappers pack
// (ops/fused_render.py:launch_params), in their order, and the device
// tables ``tables``: light kinds, light rows, the factored Sobol tables
// (null when the launch's sampler is not Sobol).  The estimator options
// close each array: rr_start after sobol_bytes, clamp after the background.
inline Params read_params(const int* iparams, const float* fparams, const void* const* tables) {
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
  p.sobol_bytes = iparams[k++];
  p.rr_start = iparams[k++];
  p.light_kind = static_cast<const int*>(tables[0]);
  p.light = static_cast<const float*>(tables[1]);
  p.sobol_p = static_cast<const uint32_t*>(tables[2]);
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
  p.clamp = fparams[f++];
  return p;
}

}  // namespace zwrt
