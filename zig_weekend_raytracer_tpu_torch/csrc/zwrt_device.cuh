// Device functions of the path tracer, shared by the CUDA kernels of
// zig_weekend_raytracer_tpu_torch: PCG4D, Sobol, camera rays, sphere and
// quad hits, shade-record reads, the five materials and the light-list PDF.
//
// Every function follows the plain PyTorch version in the package
// (sampling/, geometry/, render/, ops/) operation for operation, so that a
// build with -fmad=false rounds as the unfused torch ops do: sums are
// evaluated left to right, x ** 5 is x * (x^2)^2, clamps pass NaN through as
// torch.clamp does.  Integer streams (PCG4D, Sobol, ray ids) are bitwise the
// JAX package's.
#pragma once

#include <math.h>
#include <stdint.h>

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
constexpr int kColRgb = 19;
constexpr int kColRgb2 = 22;
constexpr int kColInvScale = 25;
constexpr int kColFuzz = 26;
constexpr int kColRefract = 27;

constexpr int kBounceBase = 8;
constexpr int kSitesPerBounce = 4;
constexpr int kSiteTime = 2;

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kInv4Pi = 0.07957747154594767f;
constexpr float kOneMinusEps = 0.99999994f;
constexpr float kTMinPdf = 1e-3f;
constexpr float kQuadParallelEps = 1e-8f;

// Everything a launch needs besides the tables, passed by value.
struct Params {
  int width, height, spp, stride, max_depth;
  int sampler, log2_scale, strat_sqrt;
  uint32_t seed;
  int n_sph, n_quad, n_rows, n_lights, needs_gauss;
  float t_min, strat_recip;
  float cam_pos[3], pixel00[3], du[3], dv[3], bg[3];
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

}  // namespace zwrt
