"""driver.fixed_sync_ms: the host's time waiting for the card in the
fixed-depth wavefront's loop, in ms an image: the port's
``render.fixed.sync`` spans (each read of whether a lane is still alive,
``render/integrator.py:trace_paths``, where the host waits for the bounce
before) summed over the traced window, over the images the program
recorded there.  It is the host's lead on the card, not a cost: a faster
card lowers it, a faster host enqueue raises it, and at 0 the host is the
limit and the card idles (``device.idle_share.render``); so higher reads
as better while the rate holds.  Nothing to read when the program
recorded no image or no such span: the control, or a program without the
spans."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"
SPAN = "render.fixed.sync"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"]:
        return None
    spans = [s for s in snap["spans"] if s["name"] == SPAN]
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / snap["images"]
