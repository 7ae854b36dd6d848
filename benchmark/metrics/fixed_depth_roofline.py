"""fixed_depth_roofline: the fixed-depth wavefront's share of the render's
roofline bound (``benchmark/roofline.py:k1_bound``, from the reference's
counts: the bound of the image's work, whichever path renders it) over
the card's busy time per image in the traced window, in percent; on
nested-checker scenes, which no render kernel takes.  Every kernel of the
path is in the denominator (the closest-hit kernel K3 at each bounce and
the eager shading's kernels), because the path, not one kernel, renders
the image.  Nothing to read without a traced K3 launch or a count."""

K3 = "closest_hit_kernel"


def read(run):
    if run.trace is None or run.k1_bound_ms is None or not run.traced_requests:
        return None
    k3 = [v for k, v in run.trace["kernels"].items() if k == K3 or k.endswith("::" + K3)]
    if not sum(n for n, _ in k3) or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.k1_bound_ms / (run.trace["busy_s"] * 1e3 / run.traced_requests)
