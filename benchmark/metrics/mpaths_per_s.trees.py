"""mpaths_per_s.trees: camera paths per second of the window, in millions
(as ``mpaths_per_s``), on the cells whose scenes have group trees: each
new image there builds its coherent lane plan on the card (the key
launch and a device sort) before the render kernel, and the host that
enqueues them and packs the launches shows in the rate, which spreads
more between runs."""

from benchmark.spec import load_reader

read = load_reader("mpaths_per_s")
