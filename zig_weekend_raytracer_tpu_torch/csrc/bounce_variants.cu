// The bounce kernel's measurement variants of its regenerating mode
// (render_kernels.cuh): for the walks kWalkCond and kWalkQueue the phase
// profile (kFlagProf), the earlier respawn through the Sobol bit loops
// (kFlagLoopSobol), and both; for the walks kWalkQueue, kWalkSpec, kWalkUni
// and kWalkRowQueue their first designs (kFlagFirstWalk).  Only
// ops/bounce.py:bounce_regen_variant launches them; no path of the renderer
// does.  A file of their own, so that nvcc builds them beside the default
// instantiations of bounce.cu.

#include "render_kernels.cuh"

namespace zwrt {

int bounce_variant(int flags, const RenderLaunch& L, float* fstate, int* istate, const int* px,
                   const int* py, const int* limit, long long* out_prof) {
  switch (flags) {
    case kFlagProf:
      return launch_bounce<kFlagProf>(L, fstate, istate, px, py, limit, out_prof, nullptr, 1, 0);
    case kFlagLoopSobol:
      return launch_bounce<kFlagLoopSobol>(L, fstate, istate, px, py, limit, out_prof, nullptr, 1,
                                           0);
    case kFlagProf | kFlagLoopSobol:
      return launch_bounce<kFlagProf | kFlagLoopSobol>(L, fstate, istate, px, py, limit, out_prof,
                                                       nullptr, 1, 0);
    case kFlagFirstWalk:
      return launch_bounce<kFlagFirstWalk>(L, fstate, istate, px, py, limit, out_prof, nullptr, 1,
                                           0);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace zwrt
