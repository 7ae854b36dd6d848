"""driver.regen_launch_ms: the render driver's host time launching the
bounce kernel K2's regenerating mode, in ms an image: the port's
``render.regen.launch`` spans (each pass of ``trace_paths_regen``'s loop:
the lane checks, the state's packing, the read of the window ends where
the host waits for the card, the parameters' and tables' packing and the
enqueue; ``utils/profiler.py``) summed over the traced window, over the
images the program recorded there.  Nothing to read when the program
recorded no image or no such span: the control, or a program without the
spans."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"
SPAN = "render.regen.launch"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"]:
        return None
    spans = [s for s in snap["spans"] if s["name"] == SPAN]
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / snap["images"]
