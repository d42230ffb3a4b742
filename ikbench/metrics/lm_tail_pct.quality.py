"""lm_tail_pct.quality: ``lm_tail_pct``'s arithmetic in the Quality cells:
the LM kernel's time after its last draw from the pose queue (the last
wave's drain) over its span, from the program's counters."""

from ikbench.harness import reader

read = reader("lm_tail_pct")
