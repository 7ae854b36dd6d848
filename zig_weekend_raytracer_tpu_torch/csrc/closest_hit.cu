// closest_hit_kernel: the closest hit of a batch of rays, one thread per
// ray: a sphere stage (brute scan or group-tree walk), then a quad stage
// (brute scan or group-tree walk) seeded with the sphere result.
//
// Replaces three TPU kernels of zig_weekend_raytracer_tpu/ops/pallas_trace.py,
// which _trace_call chains per primitive kind: _sphere_kernel (brute
// spheres), _quad_kernel (brute quads, seeded) and _tree_kernel (the
// group-tree walk of either kind, with its leaf body _tree_leaf).  Its
// plain PyTorch version is ops/trace.py:closest_hit; both compute what
// _trace_call computes, with its tie rules (ops/trace.py), through the
// device functions K1 traces with (zwrt_device.cuh:trace_closest).
//
// What bounds it on Hopper: FP32 and SFU work per primitive test (a sqrt
// and a division per sphere slot) and, for tree scenes, divergence: each
// thread walks its own path through the skip links, and a warp runs the
// union of its threads' node sequences.  Device memory carries 28 input
// and 12 output bytes per ray; the tables (balls: one node and 512 leaf
// slots of 32 bytes) stay in L1, so bandwidth does not bound it.
//
// What the design does about that: one thread per ray walks alone (no
// tile lockstep as on the TPU, where an (8, 128) tile descended whenever
// any of its rays hit a node), and neighbouring rays of a camera batch
// follow nearly the same nodes, so a warp's threads mostly read the same
// leaf rows (broadcast loads).  No shared-memory staging of leaves,
// packets or persistent threads yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

__global__ void __launch_bounds__(128) closest_hit_kernel(
    const __grid_constant__ TraceScene scene, const float* __restrict__ rays,
    const int* __restrict__ active, float t_min, float t_start, float* __restrict__ out_t,
    int* __restrict__ out_kind, int* __restrict__ out_idx, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = t_start;
  int kind = -1, idx = 0;
  if (active == nullptr || active[i] != 0) {
    V3 o = mk(rays[i], rays[n + i], rays[2 * n + i]);
    V3 d = mk(rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
    trace_closest<kWalkCond>(scene, o, d, rays[6 * n + i], t_min, t_start, &best, &kind, &idx);
  }
  out_t[i] = kind < 0 ? INFINITY : best;
  out_kind[i] = kind;
  out_idx[i] = idx;
}

}  // namespace zwrt

// Host launcher with a plain C interface (loaded with ctypes).  ``rays`` is
// the (7, n) device array ox oy oz dx dy dz time; ``active`` an (n,) int
// mask or null; ``trace_ints`` and ``trace_ptrs`` are host arrays packed by
// ops/fused_render.py:trace_args.  Launches on ``stream`` and returns the
// launch's cudaError_t.
extern "C" int zwrt_closest_hit(const int* trace_ints, const void* const* trace_ptrs,
                                const float* rays, const int* active, float t_min,
                                float t_start, float* out_t, int* out_kind, int* out_idx,
                                int n, void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  closest_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      scene, rays, active, t_min, t_start, out_t, out_kind, out_idx, n);
  return (int)cudaGetLastError();
}
