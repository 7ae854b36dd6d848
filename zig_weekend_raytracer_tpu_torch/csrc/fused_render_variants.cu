// The render kernel's phase profile (render_kernels.cuh, kFlagProf |
// kFlagPull): the work-queue kernel that render_fused launches, for the
// walks kWalkCond and kWalkQueue and, on a scene without trees, kWalkNoTree,
// each thread adding up its clock64() cycles per phase over all of its
// items.  Only ops/fused_render.py:render_fused_profile launches it; no
// path of the renderer does.  A file of its own, so that nvcc builds it
// beside the default instantiations of fused_render.cu.

#include "render_kernels.cuh"

namespace zwrt {

int fused_render_profile(const RenderLaunch& L, const int* px, const int* py, const int* s0,
                         const int* s1, float* out_rad, int* out_work, long long* out_prof,
                         const QueueLaunch* Q) {
  return launch_fused_render<kFlagProf | kFlagPull>(L, px, py, s0, s1, out_rad, out_work,
                                                    out_prof, nullptr, Q);
}

}  // namespace zwrt
