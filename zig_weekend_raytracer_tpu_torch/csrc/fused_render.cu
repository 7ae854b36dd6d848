// fused_render_kernel: the whole regenerating path-tracing render, its
// persistent threads fed (lane, sample chunk) items from a work queue, for
// brute-trace and group-tree scenes, with depth of field in the camera,
// and for image scenes with a texture LUT.
//
// Replaces the TPU kernel zig_weekend_raytracer_tpu/ops/pallas_bounce.py:
// _fused_render_kernel (driven by render_fused), including its per-kind
// trace modes (_scene_trace_inputs: brute, tree or none), its tree walk
// (_tree_pass, _leaf_visit, _node_slab_test) and its texture-LUT fetch
// (_texlut_fetch).  Its plain PyTorch version is
// render/integrator.py:render_fused_reference, which this kernel follows
// bounce for bounce.
//
// What bounds it on Hopper: FP32 and SFU work (sqrt, rsqrt, sin/cos, log
// and divisions in the trace, the camera, the RNG-driven scatter and the
// light PDF) and warp divergence, since each lane's path has its own length
// and material sequence.  A lane's live state is about 20 values held in
// registers and it touches device memory only for 16 input bytes, its
// 12-16 output bytes and the scene tables (balls: 512 leaf slots of 32
// bytes), which stay in L1; device bandwidth does not bound it.  With a
// texture LUT each image hit adds one scattered 4-byte texel load: the LUT
// holds the images unpadded (rtw_final at its native size: 7.24 M texels,
// 29 MB), so at a native budget it fits the 50 MB L2, where the padded
// atlas (57 MB) does not.
//
// The loop is zwrt_device.cuh:drain, shared with bounce_kernel
// (bounce.cu), instantiated without the image fetch (IMAGES = false:
// cornell, balls, emissive) and with it (IMAGES = true: LUT scenes).  The
// TPU kernel could not gather from a table in-kernel: _texlut_fetch made
// one lane shuffle per 128-texel LUT row, affordable only for small
// budgets.  Here the LUT is a second image table for the same one-load
// fetch K2 does from the atlas (image_texel), at any budget.  The trace is
// trace_closest, shared with closest_hit_kernel: each thread walks the
// group tree alone, where the TPU kernel walked an (8, 128) tile in
// lockstep over the union of its rays' nodes.
//
// What the design does about that: each thread loops on its own until its
// sample window is used up, respawning its pixel's next sample as soon as
// a path ends, so a lane never idles waiting for a tile as the TPU
// kernel's (8, 128) tiles do.  The kernel is persistent and fed from a
// work queue (kFlagPull, zwrt_device.cuh:Items): the grid is the blocks
// the card holds at once (blocks a SM times SMs), and the work is items
// of (plan lane, sample chunk), each lane's window [s0, s1) cut into
// chunks of at most ``chunk`` samples, numbered chunk-major so that
// threads taking items together get neighbouring lanes of the plan.
// Thread t starts on item t; a thread whose item is used up writes the
// item's sums to its own slot and takes the next item inside the drain
// loop, one atomic on a device counter for the warp's threads that take
// items together (pull_item).  So threads refill one by one and never wait
// for their warp's longest pixel, and blocks never end before the queue is
// empty, where one thread a lane drained the card as its unequal blocks
// ended.  item_sum_kernel then adds each lane's item sums in chunk order,
// so that a seed renders the same image bit for bit on every run.
// ops/fused_render.py:item_chunk sizes the chunks from the render's lanes
// (width x height x stride, whatever the plan), the longest window and the
// threads the card holds: several items a thread, or whole windows where
// the lanes alone outnumber the threads several times.  The caller orders lanes by their measured cost
// (renderer's sorted plan) so the threads of a warp run similar path
// counts, or for tree scenes by their first hit (coherent plan) so the
// threads of a warp walk the same nodes.  Scene tables are read with
// uniform addresses across the warp wherever its threads agree (brute
// scans, a leaf they all visit: broadcast loads); the shade record is one
// indexed row read.  No shared-memory staging of leaves or packets yet.
//
// Redesigned for Hopper.  (1) Each thread walks its tree alone, so
// the port sizes leaves for one thread's walk (geometry/bvh.py:
// pick_leaf_span), not for the TPU's (8, 128) tile, whose 64-group leaf made
// balls' every bounce a brute sweep of 485 spheres.  (2) A lane whose path
// ended respawns its pixel's next camera ray inside a divergent branch, so
// a warp pays the whole respawn whenever any lane restarts; the Sobol
// sampler's ~150 bit-loop steps there became a few shared-memory loads:
// v_d = P_d(s) ^ Q_d(px, py) (zwrt_device.cuh:SobolPixel), P_d read from
// byte tables that each block stages in shared memory at its start, Q_d
// computed once per lane.  The lights and the image dims are device tables
// of any length.
//
// It also replaces the TPU traversal variants that K1 hosts (kernel K4:
// _tree_pass_queue, _tree_pass_spec, _uni_tree_pass), as one instantiation
// per walk (zwrt_device.cuh:Walk), chosen at launch: WALK is a template
// parameter, not a runtime branch, so the default walk's code (72
// registers, 7 blocks per SM, to which __launch_bounds__ holds every tree
// walk's instantiation fed from the work queue: render_kernels.cuh:
// k1_min_blocks) does not carry the others', and a scene without trees
// (cornell, emissive) takes kWalkNoTree, which carries no walk's code
// (render_kernels.cuh: dispatch_flags_walk) and is held to 8 blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "render_kernels.cuh"

// Host launcher with a plain C interface (loaded with ctypes).  ``iparams``,
// ``fparams``, ``tables`` (device pointers: light kinds, light rows, the
// factored Sobol tables), ``trace_ints`` and ``trace_ptrs`` are host arrays
// in the order ops/fused_render.py packs them; ``nodes`` the packed node
// tables of a launch of any walk but cond (zwrt_device.cuh:set_nodes;
// null for cond); ``image_dims`` ((n_images, 4) on the card) and
// ``image_texels`` are the texture LUT of an image scene (n_images 0 and
// both null for a scene without images).  ``walk`` picks the tree walk,
// ``q_cap`` and ``queue`` (``queue_len`` ints) its leaf queue
// (zwrt_device.cuh:set_walk); ``flags`` the instantiation
// (render_kernels.cuh): 0 by default, kFlagEstimator for Russian roulette
// and the indirect clamp, or kFlagProf for the phase profile, which writes
// kProfCols rows of grid * kThreads int64 to ``out_prof``.  ``out_blocks``,
// null or a zeroed buffer of kBlockStampCols uint64 a block, takes the
// default and estimator instantiations' block stamps (render_kernels.cuh:
// stamp_block_start); the profile takes none.  Every instantiation is fed
// from the work queue that ``grid``, ``chunk``, ``chunks``, ``next``,
// ``part_rad``, ``part_work`` and ``thread_work`` describe
// (render_kernels.cuh:QueueLaunch).  Launches on ``stream`` and returns the launch's cudaError_t; with
// ``occupancy`` set it launches nothing and writes there the
// instantiation's blocks per SM and dynamic shared memory
// (render_kernels.cuh:RenderLaunch).
extern "C" int zwrt_fused_render(
    const int* iparams, const float* fparams, const void* const* tables, const int* trace_ints,
    const void* const* trace_ptrs, const void* const* nodes, int n_images, const int* image_dims,
    const int* image_texels,
    const int* px, const int* py, const int* s0, const int* s1, const float* shade_rows,
    const uint32_t* sobol, float* out_rad, int* out_work, long long* out_prof,
    unsigned long long* out_blocks, int walk,
    int flags, int q_cap, int* queue, int queue_len, int n, int grid, int chunk, int chunks,
    int* next, float* part_rad, int* part_work, int* thread_work, int* occupancy,
    void* stream) {
  using namespace zwrt;
  if (n <= 0) return 0;
  RenderLaunch L;
  int err = read_launch(&L, iparams, fparams, tables, trace_ints, trace_ptrs, nodes, n_images,
                        image_dims, image_texels, shade_rows, sobol, walk, q_cap, queue,
                        queue_len, n, occupancy, stream);
  if (err != 0) return err;
  const QueueLaunch Q{grid, chunk, chunks, next, part_rad, part_work, thread_work};
  if (flags == kFlagEstimator)
    return fused_render_estimator(L, px, py, s0, s1, out_rad, out_work, out_blocks, &Q);
  if (flags == kFlagProf)
    return fused_render_profile(L, px, py, s0, s1, out_rad, out_work, out_prof, &Q);
  if (flags != 0) return (int)cudaErrorInvalidValue;
  return launch_fused_render<kFlagPull>(L, px, py, s0, s1, out_rad, out_work, nullptr, out_blocks,
                                        &Q);
}
