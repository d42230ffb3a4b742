"""host_ms_per_batch.quality: ``host_ms_per_batch.ik``'s arithmetic in the
Quality cells: the facade's host time per call, the mean over the
untraced window's calls of the benchmark's span around
``Robot.ik_batch``."""

from ikbench.harness import reader

read = reader("host_ms_per_batch.ik")
