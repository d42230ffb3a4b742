"""mesh_solves_per_s (solves/s): ``solves_per_s`` of the cells on a mesh of
cards: every pose of every sharded call completed in the window over the
time from its start to its last fetch.  A metric of its own so that its
bound follows the mesh's spread, not one card's."""

from ikbench.harness import reader

read = reader("solves_per_s")
