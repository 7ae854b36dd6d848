// chain_kernel: register-resident FP32 (and int32) operation chains, the
// dispatch-limited peak rate of one operation class on this card.
//
// Replaces the TPU kernel tools/vpu_peak.py:_chain_kernel (built by
// vpu_peak.build): each thread carries CHAINS independent accumulators,
// starting at 1 + 0.001 k, and applies OP to each of them UNROLL times per
// trip for ``iters`` trips; it writes the sum of its chains in chain
// order.  Its plain PyTorch version is tools/fp32_peak.py:chain_reference,
// and tools/fp32_peak.py turns its times into the lane-operation rate that
// utils/roofline.py divides by.
//
// What bounds it on Hopper: FP32 issue alone.  An SM issues one FP32
// instruction per clock on each of its four 32-lane partitions, so 128
// lane-operations per clock; nothing is read or written inside the loop.
// With CHAINS independent accumulators per thread and 32 warps or more per
// SM, every partition has an independent instruction to issue at every
// clock in spite of the 4-cycle FP32 latency.
//
// What the design does about folding (vpu_peak.py:73-81): the multiplier
// ``c`` is a kernel argument read at run time (c[thread % 128]), so the
// compiler can neither fold the affine chains nor prove the select chain
// idempotent.  The build has no FMA contraction (-fmad=false), so the fma
// chain is written with __fmaf_rn, which is one FFMA in the SASS; the add
// chain is one FADD (its product c * 0.0005 is loop-invariant and hoisted),
// the select chain a compare and a select, the newton chain an FFMA and an
// FMUL.  The int chain (a = (a * m + k) ^ x on u32, m, k and x from the
// bits of c) is an IMAD and a LOP3: the rate of the integer work (PCG4D,
// Sobol bits, indices) that utils/roofline.py prices; it writes the bits of
// its u32 sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace zwrt {

// Operation classes, as tools/fp32_peak.py:OPS numbers them.
enum ChainOp { kChainFma = 0, kChainAdd = 1, kChainSelect = 2, kChainNewton = 3, kChainInt = 4 };

// The int chain's constants from the bits of the multiplier (as
// tools/fp32_peak.py:int_constants).
__device__ __forceinline__ void int_constants(float c, uint32_t* m, uint32_t* k, uint32_t* x) {
  const uint32_t b = __float_as_uint(c);
  *m = b | 1u;
  *k = b >> 3;
  *x = 0x9E3779B9u ^ *k;
}

template <int OP>
__device__ __forceinline__ float chain_step(float a, float c, float add_c, float sel_c) {
  const float d = 0.0005f;
  if (OP == kChainFma) return __fmaf_rn(a, c, d);
  if (OP == kChainAdd) return a + add_c;
  if (OP == kChainSelect) return a > sel_c ? d : a;
  return a * __fmaf_rn(-c, a, 2.0f);
}

template <int CHAINS, int UNROLL>
__device__ __forceinline__ float int_chain(float cv, int iters) {
  uint32_t m, k, x;
  int_constants(cv, &m, &k, &x);
  uint32_t acc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) acc[j] = 1u + (uint32_t)j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) acc[j] = (acc[j] * m + k) ^ x;
    }
  }
  uint32_t sum = acc[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) sum += acc[j];
  return __uint_as_float(sum);
}

template <int OP, int CHAINS, int UNROLL>
__global__ void __launch_bounds__(128) chain_kernel(const float* __restrict__ c,
                                                    float* __restrict__ out, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float cv = c[i % 128];
  if (OP == kChainInt) {
    out[i] = int_chain<CHAINS, UNROLL>(cv, iters);
    return;
  }
  const float add_c = cv * 0.0005f;
  const float sel_c = cv + 2.0f;
  float acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = 1.0f + 0.001f * (float)k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) acc[k] = chain_step<OP>(acc[k], cv, add_c, sel_c);
    }
  }
  float sum = acc[0];
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) sum = sum + acc[k];
  out[i] = sum;
}

template <int OP, int CHAINS>
int launch_chain_unroll(int unroll, int blocks, cudaStream_t st, const float* c, float* out,
                        int iters) {
  switch (unroll) {
    case 1: chain_kernel<OP, CHAINS, 1><<<blocks, 128, 0, st>>>(c, out, iters); break;
    case 4: chain_kernel<OP, CHAINS, 4><<<blocks, 128, 0, st>>>(c, out, iters); break;
    case 16: chain_kernel<OP, CHAINS, 16><<<blocks, 128, 0, st>>>(c, out, iters); break;
    case 64: chain_kernel<OP, CHAINS, 64><<<blocks, 128, 0, st>>>(c, out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int OP>
int launch_chain(int chains, int unroll, int blocks, cudaStream_t st, const float* c,
                 float* out, int iters) {
  switch (chains) {
    case 4: return launch_chain_unroll<OP, 4>(unroll, blocks, st, c, out, iters);
    case 8: return launch_chain_unroll<OP, 8>(unroll, blocks, st, c, out, iters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace zwrt

// Host launcher with a plain C interface (loaded with ctypes): ``n`` threads
// (a multiple of 128, one output each) run chain_kernel<op, chains, unroll>
// (op as ChainOp; chains 4 or 8; unroll 1, 4, 16 or 64) reading the 128
// multipliers ``c`` and writing ``out`` (the int chain: its u32 bits).  Launches on ``stream`` and returns
// the launch's cudaError_t.
extern "C" int zwrt_fp32_chain(int op, int chains, int unroll, const float* c, float* out,
                               int iters, int n, void* stream) {
  using namespace zwrt;
  if (n <= 0 || n % 128 != 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const int blocks = n / 128;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kChainFma: return launch_chain<kChainFma>(chains, unroll, blocks, st, c, out, iters);
    case kChainAdd: return launch_chain<kChainAdd>(chains, unroll, blocks, st, c, out, iters);
    case kChainSelect:
      return launch_chain<kChainSelect>(chains, unroll, blocks, st, c, out, iters);
    case kChainNewton:
      return launch_chain<kChainNewton>(chains, unroll, blocks, st, c, out, iters);
    case kChainInt: return launch_chain<kChainInt>(chains, unroll, blocks, st, c, out, iters);
    default: return (int)cudaErrorInvalidValue;
  }
}
