"""device.idle_share.render: the share of the traced window in which no
kernel, memcpy or memset ran on the card, in percent, on the render
cells."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
