// The render kernel's measurement variants (render_kernels.cuh): for the
// walks kWalkCond and kWalkQueue the phase profile (kFlagProf), the Sobol
// earlier bit-loop respawn (kFlagLoopSobol), and both; for the walks
// kWalkQueue, kWalkSpec, kWalkUni and kWalkRowQueue their first designs
// (kFlagFirstWalk: zwrt_device.cuh:tree_walk_queue_first,
// tree_walk_spec_first, uni_tree_walk_first, tree_walk_warpqueue_first),
// which chip_smoke.py times against the redesigned walks.  Only
// ops/fused_render.py:render_fused_variant launches them; no path of the
// renderer does.  A file of their own, so that nvcc builds them beside the
// default instantiations of fused_render.cu.

#include "render_kernels.cuh"

namespace zwrt {

int fused_render_variant(int flags, const RenderLaunch& L, const int* px, const int* py,
                         const int* s0, const int* s1, float* out_rad, int* out_work,
                         long long* out_prof) {
  switch (flags) {
    case kFlagProf:
      return launch_fused_render<kFlagProf>(L, px, py, s0, s1, out_rad, out_work, out_prof,
                                            nullptr);
    case kFlagLoopSobol:
      return launch_fused_render<kFlagLoopSobol>(L, px, py, s0, s1, out_rad, out_work,
                                                 out_prof, nullptr);
    case kFlagProf | kFlagLoopSobol:
      return launch_fused_render<kFlagProf | kFlagLoopSobol>(L, px, py, s0, s1, out_rad, out_work,
                                                             out_prof, nullptr);
    case kFlagFirstWalk:
      return launch_fused_render<kFlagFirstWalk>(L, px, py, s0, s1, out_rad, out_work,
                                                 out_prof, nullptr);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace zwrt
