"""device_idle_pct.quality: ``device_idle_pct.ik``'s arithmetic in the
Quality cells: the share of the traced segment in which no kernel, copy or
set runs on the card."""

from ikbench.harness import reader

read = reader("device_idle_pct.ik")
