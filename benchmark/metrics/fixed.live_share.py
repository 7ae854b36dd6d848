"""fixed.live_share: the share of the fixed-depth wavefront's lane slots
that held a live path, in percent: the live lanes entering each bounce
summed, over the lanes each bounce processes summed (every lane of the
chunk, dead ones included), as the port counts them while it records
(its ``fixed.live_lanes`` and ``fixed.lane_slots`` counters,
``render/integrator.py:trace_paths``).  Nothing to read when the program
recorded no image or no count: the control, or a program without the
counters."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"] or not snap["counters"].get("fixed.lane_slots"):
        return None
    return 100.0 * snap["counters"].get("fixed.live_lanes", 0) / snap["counters"]["fixed.lane_slots"]
