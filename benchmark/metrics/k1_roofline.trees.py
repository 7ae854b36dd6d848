"""k1_roofline.trees: the render kernel K1's share of its roofline bound
(as ``k1_roofline``), on the cells whose scenes have group trees."""

from benchmark.spec import load_reader

read = load_reader("k1_roofline")
