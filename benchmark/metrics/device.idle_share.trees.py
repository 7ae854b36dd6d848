"""device.idle_share.trees: the card's idle share of the traced window (as
``device.idle_share.render``), on the cells whose scenes have group
trees."""

from benchmark.spec import load_reader

read = load_reader("device.idle_share.render")
