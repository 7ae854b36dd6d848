// The render kernel's estimator instantiations (render_kernels.cuh,
// kFlagEstimator, fed from the work queue: kFlagPull) for every walk: Russian roulette from Params::rr_start
// and the indirect clamp Params::clamp in the shading
// (zwrt_device.cuh:shade_hit).  ops/fused_render.py:render_fused launches
// them when either option is on; the default instantiations of
// fused_render.cu compile without them.  A file of their own, so that nvcc
// builds them beside fused_render.cu.

#include "render_kernels.cuh"

namespace zwrt {

int fused_render_estimator(const RenderLaunch& L, const int* px, const int* py, const int* s0,
                           const int* s1, float* out_rad, int* out_work,
                           unsigned long long* out_blocks, const QueueLaunch* Q) {
  return launch_fused_render<kFlagEstimator | kFlagPull>(L, px, py, s0, s1, out_rad, out_work,
                                                         nullptr, out_blocks, Q);
}

}  // namespace zwrt
