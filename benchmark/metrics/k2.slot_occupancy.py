"""k2.slot_occupancy: the share of the card's block slots that the bounce
kernel K2 filled while its regenerating launches ran, in percent: the sum
of K2's blocks' times over its block slots (blocks a SM times SMs) times
each launch's time from its first block's start to its last block's end,
both stamped by K2 on the card's clock and summed by the port while it
records (its ``k2.block_ns`` and ``k2.slot_ns`` counters).  Nothing to read
when the program recorded no image or no stamps."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"] or not snap["counters"].get("k2.slot_ns"):
        return None
    return 100.0 * snap["counters"]["k2.block_ns"] / snap["counters"]["k2.slot_ns"]
