"""setup_s: seconds from process start to the window's start (loading the
port and the scene, building the kernels on a fresh checkout, the warm-up
requests that build the lane plan)."""


def read(run):
    return run.setup_s
