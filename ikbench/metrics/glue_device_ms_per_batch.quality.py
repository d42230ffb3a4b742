"""glue_device_ms_per_batch.quality: ``glue_device_ms_per_batch``'s
arithmetic in the Quality cells: device time per call of everything but
the LM solve, there the layout of the (B, 64, A) seeds and the selection
of each pose's success nearest its seed."""

from ikbench.harness import reader

read = reader("glue_device_ms_per_batch")
