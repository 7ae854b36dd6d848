// The bounce kernel's estimator instantiations (render_kernels.cuh,
// kFlagEstimator; the regenerating mode's fed from the work queue) for
// every walk, in both modes: Russian roulette from
// Params::rr_start and the indirect clamp Params::clamp in the shading
// (zwrt_device.cuh:shade_hit).  ops/bounce.py launches them when either
// option is on after the gate (off on atlas scenes); the default
// instantiations of bounce.cu compile without them.  A file of their own,
// so that nvcc builds them beside bounce.cu.

#include "render_kernels.cuh"

namespace zwrt {

int bounce_estimator(const RenderLaunch& L, float* fstate, int* istate, const float* fin,
                     const int* iin, const int* px, const int* py, const int* s0,
                     const int* limit, unsigned long long* out_blocks, int regen, int depth,
                     const QueueLaunch* Q) {
  return launch_bounce<kFlagEstimator>(L, fstate, istate, fin, iin, px, py, s0, limit, nullptr,
                                       out_blocks, regen, depth, Q);
}

}  // namespace zwrt
