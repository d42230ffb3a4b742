"""ik_mfu_pct.quality: ``ik_mfu_pct``'s arithmetic in the Quality cells:
the frozen FP32 operations of one call over the untraced window's time per
call and the card's FP32 peak.  The cell's frozen lane-iterations per
solve are the lanes' busy iterations (``workcount.lane_iters_quality``),
the work the answer needs, not the slots the kernel holds."""

from ikbench.harness import reader

read = reader("ik_mfu_pct")
