// The render kernel (fused_render_kernel, K1) and the bounce kernel
// (bounce_kernel, K2) as templates, with their host-side launch helpers, so
// that the default instantiations (fused_render.cu, bounce.cu), the
// estimator instantiations (*_estimator.cu) and the phase profile
// (*_variants.cu) compile in separate nvcc processes.  The design notes are
// in fused_render.cu and bounce.cu.
//
// FLAGS (zwrt_device.cuh:DrainFlags) is 0 in every bounce kernel
// instantiation the wrapper launches by default, and kFlagPull in every
// render kernel instantiation: one per walk, and kWalkNoTree, which every
// walk but uni takes on a scene without trees (dispatch_flags_walk).
// kFlagPull makes the render kernel persistent: its grid is the blocks the
// card holds at once, and its threads take (lane, sample chunk) items from
// a work queue (zwrt_device.cuh:Items), whose sums item_sum_kernel adds up
// per lane.  kFlagEstimator, instantiated for every walk and both kernels'
// modes (fused_render_estimator.cu; bounce_estimator.cu), applies Russian
// roulette and the indirect clamp; the wrappers launch it when either
// option is on.  kFlagProf, without the estimator, for the walks kWalkCond
// and kWalkQueue (and kWalkNoTree, where the render kernel's launches take
// it) and the bounce kernel's regenerating mode, writes each thread's phase
// profile (kProfCols int64 columns) to ``out_prof``: no render path
// launches it (ops/fused_render.py:render_fused_profile, ops/bounce.py:
// bounce_regen_profile).  Beside the Sobol tables in the block's dynamic
// shared memory, kWalkQueue keeps its per-thread leaf queues
// (zwrt_device.cuh:bounded_queue), and kWalkRowQueue stages packed tree
// nodes (stage_nodes) at every block's start and keeps its warp queues.
//
// Each kernel's ``out_blocks``, when not null, takes kBlockStampCols uint64
// a block (stamp_block_start, stamp_block_end); the production launches
// pass null, ops/fused_render.py:render_fused and ops/bounce.py:
// bounce_regen pass a zeroed buffer while the port's profiler records.
// Like ``out_work`` it is a runtime argument, so it adds no instantiation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "zwrt_device.cuh"

namespace zwrt {

__device__ __forceinline__ void write_prof(long long* out, const Prof& pr, int i, int n) {
  for (int ph = 0; ph < kPhases; ++ph) {
    out[(size_t)ph * n + i] = pr.cycles[ph];
    out[(size_t)(kPhases + ph) * n + i] = pr.entries[ph];
    out[(size_t)(2 * kPhases + ph) * n + i] = pr.active[ph];
  }
  out[(size_t)(3 * kPhases) * n + i] = pr.total;
}

// A block's stamps, kBlockStampCols uint64 zeroed by the caller: its SM, and
// %globaltimer (the card's nanosecond clock) when thread 0 has staged the
// block's tables and when the block's last live thread has finished (the
// largest of its threads' ends, a reduction that returns nothing).  Placed
// so that no default or estimator instantiation takes another register
// (chip_smoke.py:DEFAULT_RESOURCES; stamping the start at the kernel's
// entry cost the queue walk's estimator eight).
constexpr int kBlockStampCols = 3;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* stamp_row(unsigned long long* b) {
  return b + (size_t)kBlockStampCols * blockIdx.x;
}

__device__ __forceinline__ void stamp_block_start(unsigned long long* b) {
  stamp_row(b)[1] = global_ns();
}

__device__ __forceinline__ void stamp_block_end(unsigned long long* b) {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  b = stamp_row(b);
  b[0] = sm;
  atomicMax(b + 2, global_ns());
}

// Blocks a SM that the render kernel's instantiations are held to: the
// tree-less one to kMaxBlocksPerSM (8), as launch_or_report holds every
// launch, and a tree walk's to 7, the queue walk's blocks a SM before the
// work queue (72 registers at most: 65,536 / (7 * kThreads) is 73), so that
// ptxas keeps each in its bucket.
constexpr int k1_min_blocks(int walk) { return walk == kWalkNoTree ? 8 : 7; }

// The render kernel, persistent and fed from the work queue (kFlagPull):
// thread i of the grid starts on item i, or past the queue's end on an
// empty window, so that every thread of a warp reaches drain's ballots;
// drain writes every item's sums.  Under kFlagProf each thread writes the
// Prof it accumulated over all of its items to column i of ``out_prof``
// (kProfCols rows of grid * kThreads).  ``lane_px`` to ``out_work`` and
// ``n`` keep the parameter's layout: the items carry the lanes.
template <bool IMAGES, int WALK, int FLAGS>
__global__ void __launch_bounds__(kThreads, k1_min_blocks(WALK)) fused_render_kernel(
    const __grid_constant__ Params p, const int* __restrict__ lane_px,
    const int* __restrict__ lane_py, const int* __restrict__ lane_s0,
    const int* __restrict__ lane_s1, const __grid_constant__ TraceScene scene,
    const __grid_constant__ Images images, const float* __restrict__ shade_rows,
    const uint32_t* __restrict__ sobol, float* __restrict__ out_rad,
    int* __restrict__ out_work, long long* __restrict__ out_prof,
    unsigned long long* __restrict__ out_blocks, int n, const __grid_constant__ Items items) {
  static_assert((FLAGS & kFlagPull) != 0, "the render kernel is fed from the work queue");
  stage_sobol(p);
  if (WALK == kWalkRowQueue) stage_nodes(scene);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (out_blocks && threadIdx.x == 0) stamp_block_start(out_blocks);
  Path s;
  s.o = mk(0.0f, 0.0f, 0.0f);
  s.d = mk(0.0f, 0.0f, 1.0f);
  s.thr = mk(1.0f, 1.0f, 1.0f);
  s.rad = mk(0.0f, 0.0f, 0.0f);
  s.time = 0.0f;
  s.rid = 0;
  s.depth = 0;
  bool alive = false;
  int work = 0;
  Prof prof = {};
  int px = 0, py = 0, sample = -p.stride, limit = 0;
  if (i < items.total) item_window(p, items, i, px, py, sample, limit);
  drain<IMAGES, WALK, FLAGS>(p, scene, shade_rows, &images, sobol, px, py, limit, s, alive,
                             sample, work, &prof, &items, i);
  if (FLAGS & kFlagProf) write_prof(out_prof, prof, i, items.first);
  if (out_blocks) stamp_block_end(out_blocks);
}

// A lane's sums over its items, in chunk order from zero, so that a seed
// renders the same image on every run whatever order the items ran in:
// radiance from K1's ``part_rad`` (chunks, 3, n) into ``out_rad`` (3, n),
// and, when ``out_work`` is set, passes from ``part_work`` (chunks, n).
static __global__ void __launch_bounds__(kThreads) item_sum_kernel(
    const float* __restrict__ part_rad, const int* __restrict__ part_work,
    float* __restrict__ out_rad, int* __restrict__ out_work, int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < 3; ++k) {
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c) acc += part_rad[((size_t)c * 3 + k) * n + i];
    out_rad[(size_t)k * n + i] = acc;
  }
  if (!out_work) return;
  int w = 0;
  for (int c = 0; c < chunks; ++c) w += part_work[(size_t)c * n + i];
  out_work[i] = w;
}

// State rows, as ops/bounce.py packs them: floats ox oy oz dx dy dz thx
// thy thz rx ry rz time; ints ray_id alive, then in the regenerating mode
// sample bounce work.
template <bool REGEN, int WALK, int FLAGS>
__global__ void __launch_bounds__(kThreads) bounce_kernel(
    const __grid_constant__ Params p, const __grid_constant__ TraceScene scene,
    const __grid_constant__ Images images, const float* __restrict__ shade_rows,
    const uint32_t* __restrict__ sobol, float* __restrict__ fstate, int* __restrict__ istate,
    const int* __restrict__ lane_px, const int* __restrict__ lane_py,
    const int* __restrict__ lane_limit, long long* __restrict__ out_prof,
    unsigned long long* __restrict__ out_blocks, int depth, int n) {
  if (REGEN) stage_sobol(p);
  if (WALK == kWalkRowQueue) stage_nodes(scene);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (out_blocks && threadIdx.x == 0) stamp_block_start(out_blocks);
  float* f = fstate + i;
  int* st = istate + i;
  Path s;
  s.o = mk(f[0], f[n], f[2 * n]);
  s.d = mk(f[3 * n], f[4 * n], f[5 * n]);
  s.thr = mk(f[6 * n], f[7 * n], f[8 * n]);
  s.rad = mk(f[9 * n], f[10 * n], f[11 * n]);
  s.time = f[12 * n];
  s.rid = (uint32_t)st[0];
  bool alive = st[n] != 0;
  if (REGEN) {
    int sample = st[2 * n], work = st[4 * n];
    s.depth = st[3 * n];
    Prof prof = {};
    drain<true, WALK, FLAGS>(p, scene, shade_rows, &images, sobol, lane_px[i], lane_py[i],
                             lane_limit[i], s, alive, sample, work, &prof);
    f[12 * n] = s.time;
    st[0] = (int)s.rid;
    st[2 * n] = sample;
    st[3 * n] = s.depth;
    st[4 * n] = work;
    if (FLAGS & kFlagProf) write_prof(out_prof, prof, i, n);
  } else {
    // the live lanes of this warp, for the rowqueue walks' trace
    const unsigned group = warp_walk(WALK) ? __ballot_sync(kAllLanes, alive) : kAllLanes;
    if (alive) {
      s.depth = depth;
      alive = bounce_step<true, WALK, false, (FLAGS & kFlagEstimator) != 0>(p, scene, shade_rows,
                                                                           &images, s, group);
    }
  }
  f[0] = s.o.x;
  f[n] = s.o.y;
  f[2 * n] = s.o.z;
  f[3 * n] = s.d.x;
  f[4 * n] = s.d.y;
  f[5 * n] = s.d.z;
  f[6 * n] = s.thr.x;
  f[7 * n] = s.thr.y;
  f[8 * n] = s.thr.z;
  f[9 * n] = s.rad.x;
  f[10 * n] = s.rad.y;
  f[11 * n] = s.rad.z;
  st[n] = alive ? 1 : 0;
  if (out_blocks) stamp_block_end(out_blocks);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// What a launch of either kernel reads, from the wrappers' host arrays.
// ``occupancy``, when set, asks for no launch: the launcher writes there the
// blocks per SM that the instantiation and its dynamic shared memory allow
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and those bytes.
struct RenderLaunch {
  Params p;
  TraceScene scene;
  Images images;
  const float* shade_rows;
  const uint32_t* sobol;
  int walk, q_cap, queue_len, n;
  int* queue;
  int* occupancy;
  cudaStream_t stream;
};

// At most this many blocks of a render or bounce kernel share an SM: where
// an instantiation's registers and shared memory let more in (the render
// kernel's tree-less instantiation, 56 registers: 9), cap_blocks_per_sm
// raises the block's dynamic shared memory until no more fit.  On an NVIDIA
// H100 80GB HBM3 at 700 W that instantiation took, at cornell's
// 400x400@1024 d10 plan, 76.9 ms at 9 blocks a SM, 69.8 at 8 and 75.1 at 7
// (the same code, the blocks set by shared memory), and emissive's 6.0-6.2
// ms at each (PERF.md).
constexpr int kMaxBlocksPerSM = 8;

// Host side: raises ``*smem`` so that at most kMaxBlocksPerSM blocks of
// ``kernel`` fit an SM (an SM's shared memory over kMaxBlocksPerSM, less
// the shared memory reserved for each block); returns a cudaError_t.
template <typename K>
inline int cap_blocks_per_sm(K* kernel, size_t* smem) {
  int blocks = 0, dev = 0, per_sm = 0, reserved = 0;
  int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, *smem);
  if (e != 0 || blocks <= kMaxBlocksPerSM) return e;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  e = (int)cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e != 0) return e;
  e = (int)cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != 0) return e;
  *smem = (size_t)(per_sm / kMaxBlocksPerSM - reserved);
  return 0;
}

// Launches ``kernel`` as RenderLaunch ``L`` asks, or reports its occupancy,
// at most kMaxBlocksPerSM blocks a SM.
template <typename K, typename... Args>
inline int launch_or_report(const RenderLaunch& L, K* kernel, int blocks, size_t smem,
                            Args... args) {
  int e = allow_smem(kernel, smem);
  if (e == 0) e = cap_blocks_per_sm(kernel, &smem);
  if (e == 0) e = allow_smem(kernel, smem);
  if (e != 0) return e;
  if (L.occupancy) {
    L.occupancy[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(L.occupancy, kernel, kThreads,
                                                              smem);
  }
  kernel<<<blocks, kThreads, smem, L.stream>>>(args...);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, W>{}) for the walk W: every walk for the
// default and estimator instantiations, kWalkCond and kWalkQueue for the
// profile (kFlagProf), and kWalkNoTree for every walk but uni where
// ``scene`` has no per-kind tree, so that a tree-less scene (cornell,
// emissive) carries no walk's registers; the bounce kernel's profile, which
// no render path's kernel shares a drain with, keeps its walk's.
template <int FLAGS, typename F>
inline int dispatch_flags_walk(const TraceScene& scene, int walk, F f) {
  constexpr bool PROF = (FLAGS & kFlagProf) != 0;
  if (PROF && walk != kWalkCond && walk != kWalkQueue) return (int)cudaErrorInvalidValue;
  if constexpr (!PROF || (FLAGS & kFlagPull) != 0) {
    if (walk >= kWalkCond && walk < kWalkUni && !has_kind_tree(scene))
      return f(std::integral_constant<int, kWalkNoTree>{});
  }
  if constexpr (PROF) {
    if (walk == kWalkCond) return f(std::integral_constant<int, kWalkCond>{});
    return f(std::integral_constant<int, kWalkQueue>{});
  } else {
    return dispatch_walk(walk, f);
  }
}

// The render kernel's work queue as the wrapper sizes it (kFlagPull,
// ops/fused_render.py:render_fused): ``grid`` blocks, ``chunk`` samples an
// item and ``chunks`` items a lane (Items); ``next`` one int, zeroed on the
// stream before the launch; for more than one chunk ``part_rad`` (chunks,
// 3, n) floats and, where the launch counts work, ``part_work`` (chunks, n)
// ints, which item_sum_kernel sums into the outputs after the launch (with
// one chunk the items write the outputs); ``thread_work`` null or grid *
// kThreads zeroed ints.
struct QueueLaunch {
  int grid, chunk, chunks;
  int* next;
  float* part_rad;
  int* part_work;
  int* thread_work;
};

template <int FLAGS>
int launch_fused_render(const RenderLaunch& L, const int* px, const int* py, const int* s0,
                        const int* s1, float* out_rad, int* out_work, long long* out_prof,
                        unsigned long long* out_blocks, const QueueLaunch* Q) {
  if ((FLAGS & kFlagProf) && out_prof == nullptr && !L.occupancy)
    return (int)cudaErrorInvalidValue;
  if (Q == nullptr || Q->grid < 1 || Q->chunk < 1 || Q->chunks < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)Q->chunks * L.n;
  const bool parts = Q->chunks > 1;
  if (total > 2147483647LL || (long long)Q->grid * kThreads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (!L.occupancy && (Q->next == nullptr || (parts && Q->part_rad == nullptr) ||
                       (parts && out_work && Q->part_work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = Q->grid;
  const Items items{px, py, s0, s1, Q->next, parts ? Q->part_rad : out_rad,
                    out_work ? (parts ? Q->part_work : out_work) : nullptr, Q->thread_work,
                    L.n, Q->chunk, (int)total, blocks * kThreads};
  TraceScene scene = L.scene;
  size_t smem = 0;
  int err = set_walk(&scene, L.walk, L.q_cap, L.queue, L.queue_len, blocks, kThreads,
                     sobol_smem_bytes(L.p), &smem);
  if (err != 0) return err;
  if (!L.occupancy) {
    err = (int)cudaMemsetAsync(Q->next, 0, sizeof(int), L.stream);
    if (err != 0) return err;
  }
  err = dispatch_flags_walk<FLAGS>(scene, L.walk, [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto kernel = fused_render_kernel<false, W, FLAGS>;
    if (L.images.texels) kernel = fused_render_kernel<true, W, FLAGS>;
    return launch_or_report(L, kernel, blocks, smem, L.p, px, py, s0, s1, scene, L.images,
                            L.shade_rows, L.sobol, out_rad, out_work, out_prof, out_blocks,
                            L.n, items);
  });
  if (err != 0 || L.occupancy || Q->chunks == 1) return err;
  item_sum_kernel<<<(L.n + kThreads - 1) / kThreads, kThreads, 0, L.stream>>>(
      Q->part_rad, items.work ? Q->part_work : nullptr, out_rad, out_work, L.n, Q->chunks);
  return (int)cudaGetLastError();
}

template <int FLAGS>
int launch_bounce(const RenderLaunch& L, float* fstate, int* istate, const int* px,
                  const int* py, const int* limit, long long* out_prof,
                  unsigned long long* out_blocks, int regen, int depth) {
  if ((FLAGS & ~kFlagEstimator) != 0 && !regen) return (int)cudaErrorInvalidValue;
  if ((FLAGS & kFlagProf) && out_prof == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (L.n + kThreads - 1) / kThreads;
  TraceScene scene = L.scene;
  size_t smem = 0;
  const size_t tables = regen ? sobol_smem_bytes(L.p) : 0;
  int err = set_walk(&scene, L.walk, L.q_cap, L.queue, L.queue_len, blocks, kThreads, tables,
                     &smem);
  if (err != 0) return err;
  return dispatch_flags_walk<FLAGS>(scene, L.walk, [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto kernel = bounce_kernel<true, W, FLAGS>;
    if constexpr ((FLAGS & ~kFlagEstimator) == 0) {
      if (!regen) kernel = bounce_kernel<false, W, FLAGS>;
    }
    return launch_or_report(L, kernel, blocks, smem, L.p, scene, L.images, L.shade_rows,
                            L.sobol, fstate, istate, px, py, limit, out_prof, out_blocks, depth,
                            L.n);
  });
}

// The launch from the wrappers' arrays (ops/fused_render.py packs them):
// ``iparams``/``fparams`` and the device ``tables`` as read_params takes
// them, the trace as read_trace_scene and its packed nodes as set_nodes,
// the image table as read_images (n_images 0: none), ``occupancy`` as
// RenderLaunch takes it.  Returns a cudaError_t.
inline int read_launch(RenderLaunch* L, const int* iparams, const float* fparams,
                       const void* const* tables, const int* trace_ints,
                       const void* const* trace_ptrs, const void* const* nodes,
                       int n_images, const int* image_dims,
                       const int* image_texels, const float* shade_rows, const uint32_t* sobol,
                       int walk, int q_cap, int* queue, int queue_len, int n, int* occupancy,
                       void* stream) {
  L->p = read_params(iparams, fparams, tables);
  if (L->p.n_lights > 0 && (L->p.light_kind == nullptr || L->p.light == nullptr))
    return (int)cudaErrorInvalidValue;
  if (L->p.sampler == kSobol && (L->p.sobol_p == nullptr || L->p.sobol_bytes < 1))
    return (int)cudaErrorInvalidValue;
  L->scene = read_trace_scene(trace_ints, trace_ptrs);
  set_nodes(&L->scene, nodes);
  L->images = Images{};
  if (n_images != 0 && !read_images(n_images, image_dims, image_texels, &L->images))
    return (int)cudaErrorInvalidValue;
  L->shade_rows = shade_rows;
  L->sobol = sobol;
  L->walk = walk;
  L->q_cap = q_cap;
  L->queue = queue;
  L->queue_len = queue_len;
  L->occupancy = occupancy;
  L->n = n;
  L->stream = (cudaStream_t)stream;
  return 0;
}

// The phase profile's instantiations, defined in fused_render_variants.cu
// and bounce_variants.cu.
int fused_render_profile(const RenderLaunch& L, const int* px, const int* py, const int* s0,
                         const int* s1, float* out_rad, int* out_work, long long* out_prof,
                         const QueueLaunch* Q);
int bounce_profile(const RenderLaunch& L, float* fstate, int* istate, const int* px,
                   const int* py, const int* limit, long long* out_prof);
// The estimator instantiations, defined in fused_render_estimator.cu and
// bounce_estimator.cu.
int fused_render_estimator(const RenderLaunch& L, const int* px, const int* py, const int* s0,
                           const int* s1, float* out_rad, int* out_work,
                           unsigned long long* out_blocks, const QueueLaunch* Q);
int bounce_estimator(const RenderLaunch& L, float* fstate, int* istate, const int* px,
                     const int* py, const int* limit, unsigned long long* out_blocks, int regen,
                     int depth);

}  // namespace zwrt
