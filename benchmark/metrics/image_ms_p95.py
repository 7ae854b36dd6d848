"""image_ms_p95: the 95th percentile of the window's request latencies,
each from the call to its last device operation by CUDA events."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latency_ms, np.float64), 95))
