"""lm_solve_roofline.mesh: ``lm_solve_roofline``'s arithmetic in the cells on
a mesh of cards, where it moves ``mesh_solves_per_s`` (read on the card
whose device time per call is largest)."""

from ikbench.harness import reader

read = reader("lm_solve_roofline")
