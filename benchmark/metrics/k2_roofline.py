"""k2_roofline: the bounce kernel K2's share of the render's roofline bound
(``benchmark/roofline.py:k1_bound``, from the reference's counts: the
bound of the image's work, whichever kernel renders it) over K2's device
time per image in the traced window, in percent; on image scenes without
a texture LUT, which K2's regenerating mode renders.  Nothing to read
without a traced K2 launch or a count."""

K2 = "bounce_kernel"


def read(run):
    if run.trace is None or run.k1_bound_ms is None or not run.traced_requests:
        return None
    k2 = [v for k, v in run.trace["kernels"].items() if k == K2 or k.endswith("::" + K2)]
    launches = sum(n for n, _ in k2)
    seconds = sum(s for _, s in k2)
    if not launches:
        return None
    return 100.0 * run.k1_bound_ms / (seconds * 1e3 / run.traced_requests)
