// The bounce kernel's phase profile of its regenerating mode
// (render_kernels.cuh, kFlagProf | kFlagPull) for the walks kWalkCond and
// kWalkQueue and, on a scene without trees, kWalkNoTree: the work-queue
// kernel that bounce_regen launches, each thread adding up its clock64()
// cycles per phase over all of its items.  Only ops/bounce.py:
// bounce_regen_profile launches it; no path of the renderer does.  A file
// of its own, so that nvcc builds it beside the default instantiations of
// bounce.cu.

#include "render_kernels.cuh"

namespace zwrt {

int bounce_profile(const RenderLaunch& L, float* fstate, int* istate, const float* fin,
                   const int* iin, const int* px, const int* py, const int* s0,
                   const int* limit, long long* out_prof, const QueueLaunch* Q) {
  return launch_bounce<kFlagProf>(L, fstate, istate, fin, iin, px, py, s0, limit, out_prof,
                                  nullptr, 1, 0, Q);
}

}  // namespace zwrt
