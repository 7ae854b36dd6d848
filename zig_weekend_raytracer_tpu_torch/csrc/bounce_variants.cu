// The bounce kernel's phase profile of its regenerating mode
// (render_kernels.cuh, kFlagProf) for the walks kWalkCond and kWalkQueue,
// one thread a lane as the regenerating mode runs.  Only ops/bounce.py:
// bounce_regen_profile launches it; no path of the renderer does.  A file
// of its own, so that nvcc builds it beside the default instantiations of
// bounce.cu.

#include "render_kernels.cuh"

namespace zwrt {

int bounce_profile(const RenderLaunch& L, float* fstate, int* istate, const int* px,
                   const int* py, const int* limit, long long* out_prof) {
  return launch_bounce<kFlagProf>(L, fstate, istate, px, py, limit, out_prof, nullptr, 1, 0);
}

}  // namespace zwrt
