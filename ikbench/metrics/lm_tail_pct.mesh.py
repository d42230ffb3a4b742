"""lm_tail_pct.mesh: ``lm_tail_pct``'s arithmetic in the cells on a mesh of
cards, where each card runs its share of the restarts and it moves
``mesh_solves_per_s`` (read on the card the other ``.mesh`` metrics read)."""

from ikbench.harness import reader

read = reader("lm_tail_pct")
