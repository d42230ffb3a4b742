"""idle_in_program_pct.mesh: ``idle_in_program_pct``'s arithmetic in the cells
on a mesh of cards, the merge's spans among the program's, where it moves
``mesh_solves_per_s`` (read on the card the other ``.mesh`` metrics read)."""

from ikbench.harness import reader

read = reader("idle_in_program_pct")
