"""k1.lane_efficiency.trees: the share of K1's warp passes in which a lane
did work (as ``k1.lane_efficiency``), on the cells whose scenes have group
trees."""

from benchmark.spec import load_reader

read = load_reader("k1.lane_efficiency")
