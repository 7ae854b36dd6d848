// fused_render_kernel: the whole regenerating path-tracing render, one
// thread per lane, for brute-trace and group-tree scenes, with depth of
// field in the camera.
//
// Replaces the TPU kernel zig_weekend_raytracer_tpu/ops/pallas_bounce.py:
// _fused_render_kernel (driven by render_fused), including its per-kind
// trace modes (_scene_trace_inputs: brute, tree or none) and its tree walk
// (_tree_pass, _leaf_visit, _node_slab_test).  Its plain PyTorch version
// is render/integrator.py:render_fused_reference, which this kernel follows
// bounce for bounce.
//
// What bounds it on Hopper: FP32 and SFU work (sqrt, rsqrt, sin/cos, log
// and divisions in the trace, the camera, the RNG-driven scatter and the
// light PDF) and warp divergence, since each lane's path has its own length
// and material sequence.  A lane's live state is about 20 values held in
// registers and it touches device memory only for 16 input bytes, its
// 12-16 output bytes and the scene tables (balls: 512 leaf slots of 32
// bytes), which stay in L1; device bandwidth does not bound it.
//
// The trace is trace_closest (zwrt_device.cuh), shared with
// closest_hit_kernel: each thread walks the group tree alone, where the TPU
// kernel walked an (8, 128) tile in lockstep over the union of its rays'
// nodes.
//
// What the design does about that: each thread loops on its own until its
// sample window [s0, s1) is used up, respawning its pixel's next sample as
// soon as a path ends, so a lane never idles waiting for a tile as the TPU
// kernel's (8, 128) tiles do; the caller orders lanes by their measured cost
// (renderer's sorted plan) so the threads of a warp run similar path
// counts, or for tree scenes by their first hit (coherent plan) so the
// threads of a warp walk the same nodes.  Scene tables are read with
// uniform addresses across the warp wherever its threads agree (brute
// scans, a leaf they all visit: broadcast loads); the shade record is one
// indexed row read.  No shared-memory staging of leaves, packets,
// persistent blocks or work queues yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

__global__ void __launch_bounds__(128) fused_render_kernel(
    const __grid_constant__ Params p, const int* __restrict__ lane_px,
    const int* __restrict__ lane_py, const int* __restrict__ lane_s0,
    const int* __restrict__ lane_s1, const __grid_constant__ TraceScene scene,
    const float* __restrict__ shade_rows, const uint32_t* __restrict__ sobol,
    float* __restrict__ out_rad, int* __restrict__ out_work, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int px = lane_px[i], py = lane_py[i], limit = lane_s1[i];
  const int stride = p.stride;

  int sample = lane_s0[i] - stride;
  bool alive = false;
  int depth = 0, work = 0;
  uint32_t rid = 0;
  float time = 0.0f;
  V3 o = mk(0.0f, 0.0f, 0.0f), d = mk(0.0f, 0.0f, 1.0f);
  V3 thr = mk(1.0f, 1.0f, 1.0f), rad = mk(0.0f, 0.0f, 0.0f);

  while (alive || sample + stride < limit) {
    // ---- respawn: a dead lane takes its pixel's next sample ----
    if (!alive) {
      sample += stride;
      rid = ray_id_of(p, sample, px, py);
      time = generate_ray(p, sobol, rid, px, py, sample, &o, &d);
      thr = mk(1.0f, 1.0f, 1.0f);
      depth = 0;
      alive = true;
    }
    work += 1;

    // ---- closest hit: sphere stage, then quad stage ----
    float best;
    int kind, idx;
    trace_closest(scene, o, d, time, p.t_min, kBig, &best, &kind, &idx);

    bool survives = false;
    if (kind < 0) {
      // ---- miss: background, the path ends ----
      rad = rad + thr * mk(p.bg[0], p.bg[1], p.bg[2]);
    } else {
      // ---- shade record and hit attributes (ops/shade.py) ----
      int row = kind == kSphere ? idx : p.n_sph + idx;
      row = row < 0 ? 0 : (row > p.n_rows - 1 ? p.n_rows - 1 : row);
      const float* rec = shade_rows + (size_t)row * kRecordWidth;
      V3 point = o + d * best;
      V3 outward;
      if (kind == kSphere) {
        V3 center = mk(rec[0], rec[1], rec[2]) + mk(rec[3], rec[4], rec[5]) * time;
        outward = (point - center) * rec[6];
      } else {
        outward = mk(rec[3], rec[4], rec[5]);
      }
      bool front = dot(d, outward) < 0.0f;
      V3 normal = front ? outward : -outward;
      int mat = (int)rec[kColMat];
      V3 rgb = mk(rec[kColRgb], rec[kColRgb + 1], rec[kColRgb + 2]);
      V3 tex_rgb = rgb;
      if ((int)rec[kColTexKind] == 1) {
        float inv_scale = rec[kColInvScale];
        int xi = (int)floorf(inv_scale * point.x);
        int yi = (int)floorf(inv_scale * point.y);
        int zi = (int)floorf(inv_scale * point.z);
        if ((xi + yi + zi) & 1) tex_rgb = mk(rec[kColRgb2], rec[kColRgb2 + 1], rec[kColRgb2 + 2]);
      }

      // ---- RNG draws of this bounce ----
      uint32_t site = (uint32_t)(kBounceBase + depth * kSitesPerBounce);
      F4 u = uniform4(p.seed, rid, site);

      V3 mult = mk(1.0f, 1.0f, 1.0f);
      V3 new_dir = d;
      if (mat == kDiffuseLight) {
        // ---- emission on front faces; the path ends ----
        if (front) rad = rad + thr * tex_rgb;
      } else if (mat == kMetal) {
        V3 metal_dir = reflect(d, normal);
        if (p.needs_gauss) {
          float fuzz = clamp_max(clamp_min(rec[kColFuzz], 0.0f), 1.0f);
          metal_dir = metal_dir + unit_sphere(gauss3(p.seed, rid, site + 2u)) * fuzz;
        }
        survives = dot(metal_dir, normal) > 0.0f;
        new_dir = metal_dir;
        mult = rgb;
      } else if (mat == kDielectric) {
        float ri = rec[kColRefract];
        float index = front ? 1.0f / ri : ri;
        V3 unit_in = normalize(d);
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
          mat_dir = unit_sphere(gauss3(p.seed, rid, site + 2u));
        } else {
          mat_dir = onb_transform(ortho_basis(normal), cosine_direction_z(u.y, u.z));
        }
        float scatter_pdf, sample_pdf;
        if (p.n_lights > 0) {
          F4 ul = uniform4(p.seed, rid, site + 1u);
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
        thr = thr * mult;
        survives = (thr.x != 0.0f) || (thr.y != 0.0f) || (thr.z != 0.0f);
      }
      o = point;
      d = new_dir;
    }
    depth += 1;
    alive = survives && depth < p.max_depth;
  }

  out_rad[i] = rad.x;
  out_rad[n + i] = rad.y;
  out_rad[2 * n + i] = rad.z;
  if (out_work) out_work[i] = work;
}

}  // namespace zwrt

// Host launcher with a plain C interface (loaded with ctypes).  ``iparams``,
// ``fparams``, ``trace_ints`` and ``trace_ptrs`` are host arrays in the
// order ops/fused_render.py packs them.  Launches on ``stream`` and returns
// the launch's cudaError_t.
extern "C" int zwrt_fused_render(
    const int* iparams, const float* fparams, const int* trace_ints,
    const void* const* trace_ptrs, const int* px, const int* py, const int* s0,
    const int* s1, const float* shade_rows, const uint32_t* sobol, float* out_rad,
    int* out_work, int n, void* stream) {
  using namespace zwrt;
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

  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  fused_render_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, px, py, s0, s1, scene, shade_rows, sobol, out_rad, out_work, n);
  return (int)cudaGetLastError();
}
