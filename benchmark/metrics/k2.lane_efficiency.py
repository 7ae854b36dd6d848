"""k2.lane_efficiency: the share of the bounce kernel K2's warp passes in
which a lane did work, in percent: the lanes' work counts over each
regenerating launch (loop passes with a live path) summed, over 32 times
each warp's largest count summed, as the port sums them on the card while
it records (its ``k2.lane_work`` and ``k2.warp_work`` counters).  Nothing
to read when the program recorded no image or no count."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"] or not snap["counters"].get("k2.warp_work"):
        return None
    return 100.0 * snap["counters"]["k2.lane_work"] / snap["counters"]["k2.warp_work"]
