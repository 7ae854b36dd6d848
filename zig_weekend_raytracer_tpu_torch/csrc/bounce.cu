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
// template parameter so that the default walk's code stays as it was, and
// a scene without trees takes kWalkNoTree, which carries no walk's code.
//
// Redesigned for Hopper, with K1 (fused_render.cu): leaves sized
// for one thread's walk, and a regenerating mode whose respawn reads the
// Sobol sample part from byte tables staged in shared memory at each
// block's start, the pixel part computed once per lane and launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "render_kernels.cuh"

// Host launcher with a plain C interface (loaded with ctypes).  ``iparams``,
// ``fparams``, ``tables``, ``trace_ints`` and ``trace_ptrs`` as
// zwrt_fused_render takes them, and ``nodes`` as it does; ``image_dims``
// ((n_images, 4) on the card)
// and ``image_texels`` are the image table, the atlas or the texture LUT
// (ops/fused_render.py:image_args).  ``fstate`` (13, n) and ``istate`` (2 or
// 5, n) are updated in place; ``px``, ``py`` and ``limit`` are read only in
// the regenerating mode (``regen`` != 0), ``depth`` only in the one-bounce
// mode.  ``walk`` picks the tree walk, ``q_cap`` and ``queue``
// (``queue_len`` ints) its leaf queue (zwrt_device.cuh:set_walk); ``flags``
// the instantiation (render_kernels.cuh): 0 by default, kFlagEstimator for
// Russian roulette and the indirect clamp in either mode, or kFlagProf for
// the regenerating mode's phase profile, which writes kProfCols rows of n
// int64 to ``out_prof``.  ``out_blocks``, null or a zeroed buffer of
// kBlockStampCols uint64 a block, takes the default and estimator
// instantiations' block stamps (render_kernels.cuh:stamp_block_start); the
// profile takes none.  Launches on ``stream`` and returns the
// launch's cudaError_t; with ``occupancy`` set it launches nothing and
// writes there the instantiation's blocks per SM and dynamic shared memory
// (render_kernels.cuh:RenderLaunch).
extern "C" int zwrt_bounce(const int* iparams, const float* fparams, const void* const* tables,
                           const int* trace_ints, const void* const* trace_ptrs,
                           const void* const* nodes, int n_images,
                           const int* image_dims, const int* image_texels,
                           const float* shade_rows, const uint32_t* sobol, float* fstate,
                           int* istate, const int* px, const int* py, const int* limit,
                           long long* out_prof, unsigned long long* out_blocks, int regen,
                           int depth, int walk, int flags,
                           int q_cap, int* queue, int queue_len, int n, int* occupancy,
                           void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  if (n_images < 1) return (int)cudaErrorInvalidValue;
  RenderLaunch L;
  int err = read_launch(&L, iparams, fparams, tables, trace_ints, trace_ptrs, nodes, n_images,
                        image_dims, image_texels, shade_rows, sobol, walk, q_cap, queue,
                        queue_len, n, occupancy, stream);
  if (err != 0) return err;
  if (flags == kFlagEstimator)
    return bounce_estimator(L, fstate, istate, px, py, limit, out_blocks, regen, depth);
  if (flags == kFlagProf && regen)
    return bounce_profile(L, fstate, istate, px, py, limit, out_prof);
  if (flags != 0) return (int)cudaErrorInvalidValue;
  return launch_bounce<0>(L, fstate, istate, px, py, limit, nullptr, out_blocks, regen, depth);
}
