"""The card's FP32 peak, measured (counterpart of ``tools/vpu_peak.py``).

    python -m zig_weekend_raytracer_tpu_torch.tools.fp32_peak [--quick]

``chain_kernel`` (``csrc/fp32_peak.cu``) runs register-resident chains of
one FP32 operation class with nothing read or written inside its loop, so
its time is the card's issue limit for that class:

  * ``fma``:    a = fma(a, c, d)       1 lane-operation, 2 FLOPs
  * ``add``:    a = a + c * 0.0005     1 lane-operation (the product is
                                       loop-invariant), 1 FLOP
  * ``select``: a = a > c + 2 ? d : a  2 lane-operations (compare and
                                       select), 0 FLOPs
  * ``newton``: a = a * fma(-c, a, 2)  2 lane-operations, 3 FLOPs; a
                                       quadratic chain with no closed form,
                                       the check that the affine chains
                                       were not folded
  * ``int``:    a = (a * m + k) ^ x    2 lane-operations (IMAD, LOP3) on
                                       u32, m, k and x from the bits of c;
                                       0 FLOPs

``c`` is read at run time, so no chain folds.  Each class is swept over
(blocks per SM, chains, unroll) shapes, every grid a multiple of the SM
count, timed by CUDA events (best of 3), and its best lane-operation rate
(Gops/s) and FLOP rate kept.  Two checks make a reading trustworthy: the
time must scale with ``iters`` at a fixed shape (1x, 2x, 4x: the 4x / 1x
time ratio within [3, 5]), and no rate may exceed 105% of the physics
bound, SMs x 128 FP32 lanes x the maximum SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``), x 2 for FLOPs.  The ``add`` rate is the
lane-operation rate that ``utils/roofline.py`` divides the kernels' FP32
operation counts by; ``select`` prices their compares and selects and
``int`` their integer operations (``rates``).

Prints one JSON line; exits 1 when a check fails and 2 without a card.
``chain_reference`` is the kernel's plain PyTorch version, which ``chain``
runs for CPU tensors.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _build

OPS = ("fma", "add", "select", "newton", "int")  # csrc/fp32_peak.cu:ChainOp order
OPS_PER_ELEM = {"fma": 1, "add": 1, "select": 2, "newton": 2, "int": 2}
FLOPS_PER_ELEM = {"fma": 2, "add": 1, "select": 0, "newton": 3, "int": 0}
# utils/roofline.py's operation classes and the chain that measures each
RATE_OF_CLASS = {"fp": "add", "cmp": "select", "int": "int"}
LANE = 128        # multipliers, indexed by thread % 128
THREADS = 128     # threads per block
CHAINS = (4, 8)
UNROLLS = (1, 4, 16, 64)
# (blocks per SM, chains, unroll): 8 blocks of 128 threads are 32 warps per
# SM, 16 the most an SM holds; the counterpart of vpu_peak.py's (rows,
# chains, unroll) sweep
SWEEP = ((8, 8, 1), (8, 8, 4), (8, 8, 16), (8, 8, 64), (16, 8, 64), (8, 4, 64))
SCALING_SHAPE = (8, 8, 64)
ITERS, ITERS_QUICK = 400_000, 50_000
C_VALUE = 0.999
D_VALUE = 0.0005
MAX_OF_PHYSICS = 1.05
SCALING_RANGE = (3.0, 5.0)


def multipliers(device) -> torch.Tensor:
    """The 128 runtime multipliers, all ``C_VALUE``."""
    return torch.full((LANE,), C_VALUE, dtype=torch.float32, device=device)


def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors: the exact product and one rounding
    in float64, then float32 (off by one ulp only in the rare case where
    the float64 sum lands on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def int_constants(c: torch.Tensor):
    """(m, k, x) of the int chain from the bits of float32 ``c``, as int64
    tensors of u32 values (csrc/fp32_peak.cu:int_constants)."""
    b = c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k = b >> 3
    return b | 1, k, 0x9E3779B9 ^ k


def _int_chain(cv, iters, chains, unroll):
    m, k, x = int_constants(cv)
    mask = 0xFFFFFFFF
    acc = (1 + torch.arange(chains, dtype=torch.int64, device=cv.device))[:, None]
    acc = acc.expand(chains, cv.shape[0])
    for _ in range(iters * unroll):
        acc = ((acc * m + k) & mask) ^ x
    total = acc.sum(0) & mask
    return torch.where(total >= 2**31, total - 2**32, total).to(torch.int32).view(torch.float32)


def chain_reference(op: str, c: torch.Tensor, n: int, iters: int, chains: int,
                    unroll: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``chain_kernel``: (n,) float32, thread i's
    chains with multiplier c[i % 128], summed in chain order (the int
    chain: the bits of its u32 sum)."""
    const = lambda v: torch.tensor(v, dtype=torch.float32, device=c.device)
    cv = c[torch.arange(n, device=c.device) % LANE]
    if op == "int":
        return _int_chain(cv, iters, chains, unroll)
    d, two = const(D_VALUE), const(2.0)
    k = torch.arange(chains, dtype=torch.float32, device=c.device)[:, None]
    acc = (const(1.0) + const(0.001) * k).expand(chains, n)
    add_c = cv * const(0.0005)
    sel_c = cv + two
    for _ in range(iters * unroll):
        if op == "fma":
            acc = _fma(acc, cv, d)
        elif op == "add":
            acc = acc + add_c
        elif op == "select":
            acc = torch.where(acc > sel_c, d, acc)
        elif op == "newton":
            acc = acc * _fma(-cv, acc, two)
        else:
            raise ValueError(f"unknown op {op!r}; one of {OPS}")
    out = acc[0]
    for j in range(1, chains):
        out = out + acc[j]
    return out


def chain(op: str, c: torch.Tensor, n: int, iters: int, chains: int,
          unroll: int = 1) -> torch.Tensor:
    """``chain_kernel`` over ``n`` threads (a multiple of 128) for CUDA
    multipliers ``c`` (128,) float32; its plain version for CPU ones.  Any
    other device, an op, chain count or unroll the kernel was not built
    for, raises.  ``chain.launches`` counts kernel launches."""
    if c.device.type == "cpu":
        return chain_reference(op, c, n, iters, chains, unroll)
    if c.device.type != "cuda":
        raise ValueError(f"chain runs on cuda or cpu tensors, not {c.device}")
    if op not in OPS or chains not in CHAINS or unroll not in UNROLLS:
        raise ValueError(f"no chain_kernel for op {op!r}, {chains} chains, unroll {unroll}")
    if n <= 0 or n % THREADS:
        raise ValueError(f"n must be a positive multiple of {THREADS}, got {n}")
    if c.dtype != torch.float32 or c.shape != (LANE,) or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous ({LANE},) float32 tensor")
    out = torch.empty((n,), dtype=torch.float32, device=c.device)
    err = _build.load_library().zwrt_fp32_chain(
        OPS.index(op), chains, unroll, c.data_ptr(), out.data_ptr(), iters, n,
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"chain_kernel launch failed: cudaError {err}")
    chain.launches += 1
    return out


chain.launches = 0


def measure(op: str, blocks_per_sm: int, chains: int, unroll: int, iters: int,
            reps: int = 3) -> dict:
    """Best of ``reps`` CUDA-event times of one shape (after a warmup
    launch), with its lane-operation and FLOP rates."""
    c = multipliers("cuda")
    n = torch.cuda.get_device_properties(0).multi_processor_count * blocks_per_sm * THREADS
    chain(op, c, n, iters, chains, unroll)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(op, c, n, iters, chains, unroll)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    elems = n * chains * iters * unroll
    return {
        "op": op, "blocks_per_sm": blocks_per_sm, "threads": n, "chains": chains,
        "unroll": unroll, "iters": iters, "time_s": best,
        "gops": elems * OPS_PER_ELEM[op] / best / 1e9,
        "gflops": elems * FLOPS_PER_ELEM[op] / best / 1e9,
    }


def iters_scaling(op: str, iters: int) -> dict:
    """Time at 1x, 2x and 4x ``iters`` at ``SCALING_SHAPE``: a kernel bound
    by issue takes 4x the time at 4x the work."""
    blocks, chains, unroll = SCALING_SHAPE
    points = [dict(measure(op, blocks, chains, unroll, iters * m), iters_mult=m) for m in (1, 2, 4)]
    ratio = points[-1]["time_s"] / points[0]["time_s"]
    return {"op": op, "shape": SCALING_SHAPE, "base_iters": iters, "points": points,
            "time_ratio_4x": ratio,
            "linear": SCALING_RANGE[0] <= ratio <= SCALING_RANGE[1]}


def physics_bound() -> dict:
    """SMs x 128 FP32 lanes x the maximum SM clock: the most lane-operations
    per second the card can issue, and twice that in FLOPs (an FMA)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lane_ops = sms * 128 * mhz * 1e6
    return {"sms": sms, "fp32_lanes_per_sm": 128, "max_sm_clock_mhz": mhz,
            "gops": lane_ops / 1e9, "gflops": 2 * lane_ops / 1e9}


def run(iters: int = ITERS) -> dict:
    """The sweep, the scaling check and the physics bound; ``ok`` is False
    when a rate passes 105% of the bound or the scaling ratio leaves
    [3, 5].  ``add_gops`` is the rate the roofline divides FP32 operations
    by, ``rates`` the lane-operations per second of each of its classes."""
    sweep = [measure(op, b, ch, u, iters) for op in OPS for b, ch, u in SWEEP]
    best = {op: max((r for r in sweep if r["op"] == op), key=lambda r: r["gops"]) for op in OPS}
    scaling = iters_scaling("fma", iters)
    phys = physics_bound()
    over = [op for op in OPS
            if best[op]["gops"] > MAX_OF_PHYSICS * phys["gops"]
            or best[op]["gflops"] > MAX_OF_PHYSICS * phys["gflops"]]
    return {
        "device": torch.cuda.get_device_name(0),
        "gops": {op: best[op]["gops"] for op in OPS},
        "gflops": {op: best[op]["gflops"] for op in OPS},
        "best_shape": {op: [best[op][k] for k in ("blocks_per_sm", "chains", "unroll")]
                       for op in OPS},
        "add_gops": best["add"]["gops"],
        "rates": {cls: best[op]["gops"] * 1e9 for cls, op in RATE_OF_CLASS.items()},
        "physics_bound": phys,
        "over_physics": over,
        "iters_scaling": scaling,
        "ok": not over and scaling["linear"],
        "sweep": sweep,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("fp32_peak: CUDA is not available", file=sys.stderr)
        return 2
    out = run(ITERS_QUICK if "--quick" in argv else ITERS)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
