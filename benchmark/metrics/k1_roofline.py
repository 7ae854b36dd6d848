"""k1_roofline: the render kernel K1's roofline bound for one image
(``benchmark/roofline.py:k1_bound``, from the reference's counts) over
K1's device time per image in the traced window, in percent.  Nothing to
read without a traced K1 launch or a count."""

K1 = "fused_render_kernel"


def read(run):
    if run.trace is None or run.k1_bound_ms is None or not run.traced_requests:
        return None
    k1 = [v for k, v in run.trace["kernels"].items() if k == K1 or k.endswith("::" + K1)]
    launches = sum(n for n, _ in k1)
    seconds = sum(s for _, s in k1)
    if not launches:
        return None
    return 100.0 * run.k1_bound_ms / (seconds * 1e3 / run.traced_requests)
