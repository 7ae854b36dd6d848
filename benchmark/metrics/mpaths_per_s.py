"""mpaths_per_s: camera paths the window's requests rendered (width x
height x samples a pixel each), per second of the whole window, in
millions."""


def read(run):
    return run.requests * run.paths_per_request / run.window_s / 1e6
