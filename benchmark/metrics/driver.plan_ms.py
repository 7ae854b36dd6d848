"""driver.plan_ms: the render driver's host time building lane plans, in
ms an image: the port's ``render.plan`` spans (its first-hit probe, the
copies to the host, the sort and the upload; ``utils/profiler.py``)
summed over the traced window, over the images the program recorded
there.  Nothing to read when the program recorded no image: the control,
or a program without the spans."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"]:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"] if s["name"] == "render.plan")
    return ns / 1e6 / snap["images"]
