// closest_hit_kernel: the closest hit of a batch of rays, one thread
// per ray: a sphere stage (brute scan or group-tree walk), then a quad stage
// (brute scan or group-tree walk) seeded with the sphere result.
//
// Replaces three TPU kernels of zig_weekend_raytracer_tpu/ops/pallas_trace.py,
// which _trace_call chains per primitive kind: _sphere_kernel (brute
// spheres), _quad_kernel (brute quads, seeded) and _tree_kernel (the
// group-tree walk of either kind, with its leaf body _tree_leaf).  Its
// plain PyTorch version is ops/trace.py:closest_hit; both compute what
// _trace_call computes, with its tie rules (ops/trace.py), through the
// device functions K1 traces with (zwrt_device.cuh: slab_hit, leaf_sweep,
// brute_stage, tree_walk).
//
// What bounds it on Hopper: FP32 and SFU work per primitive test (a sqrt
// and a division per sphere slot) and, for tree scenes, the walk: a slab
// test of 12 NaN-propagating min/max per node, and divergence between the
// threads' node sequences.  Device memory carries 28 input and 12 output
// bytes per ray; the tables are small (balls: 121 nodes; rtw_final: 251 +
// 601 nodes) and stay in L1 and L2, so bandwidth does not bound it.
//
// What the design does about that:
//   * the walk: each thread culls with its running best t and queues the
//     leaves it hits, in preorder, in kHitQueueCap entries of shared memory
//     of its own; it sweeps the queue when it is full and when the walk
//     ends, and each sweep tightens the t the walk culls with.  The walk's
//     loop then holds only slab tests, so a warp's threads stay together
//     through it and meet again in the sweeps.  Its scratch is 4 KB a
//     block, whatever the ray count or the tree.  The render and bounce
//     kernels' queue walk (zwrt_device.cuh:tree_walk_queue) is this walk
//     over the packed 32-byte nodes, with its queue in dynamic shared
//     memory after the Sobol tables; this one reads the unpacked node
//     arrays, so it keeps its own copy.  Leaves are swept in the order
//     the per-thread walk (tree_walk: sweep each hit leaf at once) sweeps
//     them, and a sweep replaces the best only at a strictly smaller t, so
//     the result is that walk's, bitwise;
//   * the ray rows are read through their own pointers: no stacked copy of
//     the rays before the launch, and a bool mask taken as it is.
// Staging the node arrays in shared memory per block, and a persistent grid
// looping over rays, were tried on the card and ran slower than the design
// without them: the nodes stay in L1, and the staging's copy and a
// persistent grid's uneven last round cost more than they saved.
//
// closest_hit_flat_kernel is the first design, kept to measure the new one
// against: the per-thread walk, rays from a stacked (7, n) array and an int
// mask.  No path launches it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

constexpr int kHitThreads = 128;
constexpr int kHitQueueCap = 8;

// The seven ray rows, each an (n,) float32 array.
struct HitRays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *time;
};

// The bounded queue walk: cull with the running best, queue hit leaves in
// preorder in this thread's column ``q`` of the block's queue (entry j at
// q[j * kHitThreads]), and sweep them when the queue is full or the walk is
// done.
template <int KIND>
__device__ __forceinline__ void tree_walk_bounded(const KindTables& k, int* q, const Ray& ray,
                                                  bool moving, float* best, int* kind,
                                                  int* idx) {
  int node = 0;
  while (true) {
    int sp = 0;
    while (node < k.n_nodes && sp < kHitQueueCap) {
      bool hit = slab_hit(k.box + (size_t)node * 6, ray.o, ray.inv_d, ray.t_min, *best);
      int miss = k.link[2 * node], leaf = k.link[2 * node + 1];
      if (hit && leaf >= 0) q[(sp++) * kHitThreads] = leaf;
      node = (hit && leaf < 0) ? node + 1 : miss;
    }
    for (int j = 0; j < sp; ++j)
      leaf_sweep<KIND>(k, q[j * kHitThreads], ray, moving, best, kind, idx);
    if (node >= k.n_nodes) return;
  }
}

template <int KIND>
__device__ __forceinline__ void hit_stage(const KindTables& k, int* q, const Ray& ray,
                                          bool moving, float* best, int* kind, int* idx) {
  if (k.mode == kTraceBrute) brute_stage<KIND>(k, ray, moving, best, kind, idx);
  else if (k.mode == kTraceTree) tree_walk_bounded<KIND>(k, q, ray, moving, best, kind, idx);
}

// One thread per ray; the block's leaf queue in its static shared memory.
__global__ void __launch_bounds__(kHitThreads) closest_hit_kernel(
    const __grid_constant__ TraceScene scene, const __grid_constant__ HitRays rays,
    const uint8_t* __restrict__ active, float t_min, float t_start, float* __restrict__ out_t,
    int* __restrict__ out_kind, int* __restrict__ out_idx, int n) {
  __shared__ int queue[kHitQueueCap * kHitThreads];
  const int i = blockIdx.x * kHitThreads + threadIdx.x;
  if (i >= n) return;
  float best = t_start;
  int kind = -1, idx = 0;
  if (active == nullptr || active[i] != 0) {
    // trace_closest's ray setup
    Ray ray;
    ray.o = mk(rays.ox[i], rays.oy[i], rays.oz[i]);
    ray.d = mk(rays.dx[i], rays.dy[i], rays.dz[i]);
    ray.inv_d = mk(1.0f / ray.d.x, 1.0f / ray.d.y, 1.0f / ray.d.z);
    ray.a = dot(ray.d, ray.d);
    ray.inv_a = 1.0f / ray.a;
    ray.t_min = t_min;
    ray.time = rays.time[i];
    const bool moving = scene.has_moving != 0;
    int* q = queue + threadIdx.x;
    hit_stage<kSphere>(scene.sph, q, ray, moving, &best, &kind, &idx);
    hit_stage<kQuad>(scene.quad, q, ray, false, &best, &kind, &idx);
  }
  out_t[i] = kind < 0 ? INFINITY : best;
  out_kind[i] = kind;
  out_idx[i] = idx;
}

__global__ void __launch_bounds__(128) closest_hit_flat_kernel(
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

// Host launcher with a plain C interface (loaded with ctypes).  ``ray_ptrs``
// holds the device pointers of the seven (n,) float32 rows ox oy oz dx dy
// dz time; ``active`` an (n,) bool mask or null; ``trace_ints`` and
// ``trace_ptrs`` are host arrays packed by ops/fused_render.py:trace_args.
// Launches on ``stream`` and returns the launch's cudaError_t.
extern "C" int zwrt_closest_hit(const int* trace_ints, const void* const* trace_ptrs,
                                const void* const* ray_ptrs, const uint8_t* active, float t_min,
                                float t_start, float* out_t, int* out_kind, int* out_idx, int n,
                                void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  const float* const* r = reinterpret_cast<const float* const*>(ray_ptrs);
  HitRays rays = {r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
  const int blocks = (n + kHitThreads - 1) / kHitThreads;
  closest_hit_kernel<<<blocks, kHitThreads, 0, (cudaStream_t)stream>>>(
      scene, rays, active, t_min, t_start, out_t, out_kind, out_idx, n);
  return (int)cudaGetLastError();
}

// The first design's launcher: ``rays`` the (7, n) device array ox oy oz
// dx dy dz time, ``active`` an (n,) int mask or null.
extern "C" int zwrt_closest_hit_flat(const int* trace_ints, const void* const* trace_ptrs,
                                     const float* rays, const int* active, float t_min,
                                     float t_start, float* out_t, int* out_kind, int* out_idx,
                                     int n, void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  TraceScene scene = read_trace_scene(trace_ints, trace_ptrs);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  closest_hit_flat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      scene, rays, active, t_min, t_start, out_t, out_kind, out_idx, n);
  return (int)cudaGetLastError();
}
