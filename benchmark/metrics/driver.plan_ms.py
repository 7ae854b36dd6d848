"""driver.plan_ms: the render driver's host time building lane plans, in
ms an image: the port's ``render.plan`` spans (on tree scenes the
coherent plan built on the card: the enqueue of the key launch, which
makes each pixel's first-hit key from its camera ray, and of the device
sort and the lane tensors; ``utils/profiler.py``) summed over the traced
window, over the images the program recorded there.  Nothing to read when
the program recorded no image: the control, or a program without the
spans."""

import sys

PROFILER = "zig_weekend_raytracer_tpu_torch.utils.profiler"


def read(run):
    snapshot = getattr(sys.modules.get(PROFILER), "snapshot", None)
    snap = snapshot() if snapshot is not None else None
    if not snap or not snap["images"]:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"] if s["name"] == "render.plan")
    return ns / 1e6 / snap["images"]
