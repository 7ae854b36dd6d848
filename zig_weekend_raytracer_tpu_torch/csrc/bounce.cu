// bounce_kernel: the bounce of the image-texture path, one thread per lane,
// in two modes: one bounce of a wavefront, or the regenerating drain of each
// lane's sample window.
//
// Replaces the TPU kernel zig_weekend_raytracer_tpu/ops/pallas_bounce.py:
// _bounce_kernel (:842), driven there by bounce_pallas (one bounce) and
// bounce_pallas_regen (the regenerating drain under an XLA while loop that
// folds buffered atlas events between launches).  Its plain PyTorch
// versions are render/integrator.py:bounce (one-bounce mode) and
// bounce_regen_reference (regenerating mode), which this kernel follows
// bounce for bounce.
//
// What bounds it on Hopper: FP32 and SFU work (the trace's divisions and
// square roots, the RNG-driven scatter, the light PDF, and for image hits
// acosf/atan2f and the texel's unpack) and warp divergence, since each
// lane's path has its own length, material sequence and tree walk.  Device
// bandwidth does not bound it: a lane reads its 84 bytes of state and lane
// once and writes 72; the scene tables stay in L1 and L2.  The exception is
// the atlas: texel reads are scattered 4-byte loads from a table of up to
// 57 MB (rtw_final's two images), which fits the 50 MB L2 only in part.
// With a texture LUT the one-bounce mode reads the LUT instead (unpadded:
// 29 MB at rtw_final's native size); the wrappers hand either table to the
// same fetch (zwrt_device.cuh:image_texel).
//
// What the design does about that: one thread per path, looping on its own
// until its window is used up (the shared zwrt_device.cuh:drain, which K1
// runs too), so no lane idles for a tile; the caller
// orders lanes by the first hit of their camera ray (coherent plan) or by
// measured cost (sorted plan), so neighbouring threads hit neighbouring
// texels and walk the same nodes; and the texel is read only on a hit whose
// texture is an image, at the hit, so the path's throughput is final there.
// The TPU kernel could not gather from the atlas in-kernel: it suspended on
// atlas events and chained up to 12 of them per lane for an XLA fold.  Here
// there are no events, no chain and no suspend, and the driver loop's body
// runs once per band.  No shared-memory staging of texels or leaves yet.
//
// It also replaces the TPU traversal variants that K2 hosts (kernel K4:
// _tree_pass_queue, _tree_pass_spec, _uni_tree_pass), as one instantiation
// per walk (zwrt_device.cuh:Walk) and mode, chosen at launch; WALK is a
// template parameter so that the default walk's code stays as it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

// State rows, as ops/bounce.py packs them: floats ox oy oz dx dy dz thx
// thy thz rx ry rz time; ints ray_id alive, then in the regenerating mode
// sample bounce work.
template <bool REGEN, int WALK>
__global__ void __launch_bounds__(128) bounce_kernel(
    const __grid_constant__ Params p, const __grid_constant__ TraceScene scene,
    const __grid_constant__ Images images, const float* __restrict__ shade_rows,
    const uint32_t* __restrict__ sobol, float* __restrict__ fstate, int* __restrict__ istate,
    const int* __restrict__ lane_px, const int* __restrict__ lane_py,
    const int* __restrict__ lane_limit, int depth, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* f = fstate + i;
  int* st = istate + i;
  Path s;
  s.o = mk(f[0], f[n], f[2 * n]);
  s.d = mk(f[3 * n], f[4 * n], f[5 * n]);
  s.thr = mk(f[6 * n], f[7 * n], f[8 * n]);
  s.rad = mk(f[9 * n], f[10 * n], f[11 * n]);
  s.time = f[12 * n];
  s.rid = (uint32_t)st[0];
  bool alive = st[n] != 0;
  if (REGEN) {
    int sample = st[2 * n], work = st[4 * n];
    s.depth = st[3 * n];
    drain<true, WALK>(p, scene, shade_rows, &images, sobol, lane_px[i], lane_py[i],
                      lane_limit[i], s, alive, sample, work);
    f[12 * n] = s.time;
    st[0] = (int)s.rid;
    st[2 * n] = sample;
    st[3 * n] = s.depth;
    st[4 * n] = work;
  } else {
    // the live lanes of this warp, for the kWalkRowQueue trace
    const unsigned group = WALK == kWalkRowQueue ? __ballot_sync(kAllLanes, alive) : kAllLanes;
    if (alive) {
      s.depth = depth;
      alive = bounce_step<true, WALK>(p, scene, shade_rows, &images, s, group);
    }
  }
  f[0] = s.o.x;
  f[n] = s.o.y;
  f[2 * n] = s.o.z;
  f[3 * n] = s.d.x;
  f[4 * n] = s.d.y;
  f[5 * n] = s.d.z;
  f[6 * n] = s.thr.x;
  f[7 * n] = s.thr.y;
  f[8 * n] = s.thr.z;
  f[9 * n] = s.rad.x;
  f[10 * n] = s.rad.y;
  f[11 * n] = s.rad.z;
  st[n] = alive ? 1 : 0;
}

}  // namespace zwrt

// Host launcher with a plain C interface (loaded with ctypes).  ``iparams``,
// ``fparams``, ``trace_ints`` and ``trace_ptrs`` are host arrays in the
// order ops/fused_render.py packs them; ``image_ints`` and ``image_texels``
// are the image table, the atlas or the texture LUT (ops/fused_render.py:
// image_args: [n_images, then w, h, base, stride per image]).  ``fstate``
// (13, n) and ``istate`` (2 or 5, n) are updated in place; ``px``, ``py``
// and ``limit`` are read only in the regenerating mode (``regen`` != 0),
// ``depth`` only in the one-bounce mode.  ``walk`` picks the tree walk,
// ``q_cap`` and ``queue`` (``queue_len`` ints) its leaf queue
// (zwrt_device.cuh:set_walk).  Launches on ``stream`` and returns the
// launch's cudaError_t.
extern "C" int zwrt_bounce(const int* iparams, const float* fparams, const int* trace_ints,
                           const void* const* trace_ptrs, const int* image_ints,
                           const int* image_texels, const float* shade_rows,
                           const uint32_t* sobol, float* fstate, int* istate, const int* px,
                           const int* py, const int* limit, int regen, int depth, int walk,
                           int q_cap, int* queue, int queue_len, int n, void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  Images images;
  if (!read_images(image_ints, image_texels, &images)) return (int)cudaErrorInvalidValue;
  Params p = read_params(iparams, fparams);
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  size_t smem = 0;
  int err = set_walk(&scene, walk, q_cap, queue, queue_len, blocks, threads, &smem);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_walk(walk, [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto kernel = bounce_kernel<false, W>;
    if (regen) kernel = bounce_kernel<true, W>;
    int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<blocks, threads, smem, s>>>(p, scene, images, shade_rows, sobol, fstate, istate, px,
                                         py, limit, depth, n);
    return (int)cudaGetLastError();
  });
}
