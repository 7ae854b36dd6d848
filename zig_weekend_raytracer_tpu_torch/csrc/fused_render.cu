// fused_render_kernel: the whole regenerating path-tracing render, one
// thread per lane, for brute-trace and group-tree scenes, with depth of
// field in the camera, and for image scenes with a texture LUT.
//
// Replaces the TPU kernel zig_weekend_raytracer_tpu/ops/pallas_bounce.py:
// _fused_render_kernel (driven by render_fused), including its per-kind
// trace modes (_scene_trace_inputs: brute, tree or none), its tree walk
// (_tree_pass, _leaf_visit, _node_slab_test) and its texture-LUT fetch
// (_texlut_fetch).  Its plain PyTorch version is
// render/integrator.py:render_fused_reference, which this kernel follows
// bounce for bounce.
//
// What bounds it on Hopper: FP32 and SFU work (sqrt, rsqrt, sin/cos, log
// and divisions in the trace, the camera, the RNG-driven scatter and the
// light PDF) and warp divergence, since each lane's path has its own length
// and material sequence.  A lane's live state is about 20 values held in
// registers and it touches device memory only for 16 input bytes, its
// 12-16 output bytes and the scene tables (balls: 512 leaf slots of 32
// bytes), which stay in L1; device bandwidth does not bound it.  With a
// texture LUT each image hit adds one scattered 4-byte texel load: the LUT
// holds the images unpadded (rtw_final at its native size: 7.24 M texels,
// 29 MB), so at a native budget it fits the 50 MB L2, where the padded
// atlas (57 MB) does not.
//
// The loop is zwrt_device.cuh:drain, shared with bounce_kernel
// (bounce.cu), instantiated without the image fetch (IMAGES = false:
// cornell, balls, emissive) and with it (IMAGES = true: LUT scenes).  The
// TPU kernel could not gather from a table in-kernel: _texlut_fetch made
// one lane shuffle per 128-texel LUT row, affordable only for small
// budgets.  Here the LUT is a second image table for the same one-load
// fetch K2 does from the atlas (image_texel), at any budget.  The trace is
// trace_closest, shared with closest_hit_kernel: each thread walks the
// group tree alone, where the TPU kernel walked an (8, 128) tile in
// lockstep over the union of its rays' nodes.
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
//
// It also replaces the TPU traversal variants that K1 hosts (kernel K4:
// _tree_pass_queue, _tree_pass_spec, _uni_tree_pass), as one instantiation
// per walk (zwrt_device.cuh:Walk), chosen at launch: WALK is a template
// parameter, not a runtime branch, so the default walk's code (64
// registers under __launch_bounds__(128)) does not carry the others'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

template <bool IMAGES, int WALK>
__global__ void __launch_bounds__(128) fused_render_kernel(
    const __grid_constant__ Params p, const int* __restrict__ lane_px,
    const int* __restrict__ lane_py, const int* __restrict__ lane_s0,
    const int* __restrict__ lane_s1, const __grid_constant__ TraceScene scene,
    const __grid_constant__ Images images, const float* __restrict__ shade_rows,
    const uint32_t* __restrict__ sobol, float* __restrict__ out_rad,
    int* __restrict__ out_work, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path s;
  s.o = mk(0.0f, 0.0f, 0.0f);
  s.d = mk(0.0f, 0.0f, 1.0f);
  s.thr = mk(1.0f, 1.0f, 1.0f);
  s.rad = mk(0.0f, 0.0f, 0.0f);
  s.time = 0.0f;
  s.rid = 0;
  s.depth = 0;
  bool alive = false;
  int sample = lane_s0[i] - p.stride, work = 0;
  drain<IMAGES, WALK>(p, scene, shade_rows, &images, sobol, lane_px[i], lane_py[i], lane_s1[i],
                      s, alive, sample, work);
  out_rad[i] = s.rad.x;
  out_rad[n + i] = s.rad.y;
  out_rad[2 * n + i] = s.rad.z;
  if (out_work) out_work[i] = work;
}

}  // namespace zwrt

// Host launcher with a plain C interface (loaded with ctypes).  ``iparams``,
// ``fparams``, ``trace_ints`` and ``trace_ptrs`` are host arrays in the
// order ops/fused_render.py packs them; ``image_ints`` (ops/fused_render.py:
// image_args) and ``image_texels`` are the texture LUT of an image scene,
// or both null for a scene without images.  ``walk`` picks the tree walk,
// ``q_cap`` and ``queue`` (``queue_len`` ints) its leaf queue
// (zwrt_device.cuh:set_walk).  Launches on ``stream`` and returns the
// launch's cudaError_t.
extern "C" int zwrt_fused_render(
    const int* iparams, const float* fparams, const int* trace_ints,
    const void* const* trace_ptrs, const int* image_ints, const int* image_texels,
    const int* px, const int* py, const int* s0, const int* s1, const float* shade_rows,
    const uint32_t* sobol, float* out_rad, int* out_work, int walk, int q_cap, int* queue,
    int queue_len, int n, void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  Params p = read_params(iparams, fparams);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  size_t smem = 0;
  int err = set_walk(&scene, walk, q_cap, queue, queue_len, blocks, threads, &smem);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  Images images = {};
  if (image_ints && !read_images(image_ints, image_texels, &images))
    return (int)cudaErrorInvalidValue;
  return dispatch_walk(walk, [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto kernel = fused_render_kernel<false, W>;
    if (image_ints) kernel = fused_render_kernel<true, W>;
    int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<blocks, threads, smem, st>>>(p, px, py, s0, s1, scene, images, shade_rows, sobol,
                                          out_rad, out_work, n);
    return (int)cudaGetLastError();
  });
}
