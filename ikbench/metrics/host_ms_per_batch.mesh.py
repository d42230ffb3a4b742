"""host_ms_per_batch.mesh: ``host_ms_per_batch.ik``'s arithmetic in the cells
on a mesh of cards, where it moves ``mesh_solves_per_s`` (read on the card
whose device time per call is largest)."""

from ikbench.harness import reader

read = reader("host_ms_per_batch.ik")
