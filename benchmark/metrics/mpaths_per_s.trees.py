"""mpaths_per_s.trees: camera paths per second of the window, in millions
(as ``mpaths_per_s``), on the cells whose scenes have group trees: each
new image there runs the first-hit probe and the host's sort of the
coherent lane plan, so the rate is partly the host's and spreads more
between runs."""

from benchmark.spec import load_reader

read = load_reader("mpaths_per_s")
