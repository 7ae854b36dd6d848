"""k1.slot_occupancy.trees: the render kernel K1's share of the card's
block slots (as ``k1.slot_occupancy``), on the cells whose scenes have
group trees."""

from benchmark.spec import load_reader

read = load_reader("k1.slot_occupancy")
