"""lm_solve_roofline.quality: ``lm_solve_roofline``'s arithmetic in the
Quality cells, where the LM kernel's Quality build does the work: the
configuration's frozen FP32 operations per lane-iteration times the cell's
frozen lane-iterations per solve, over the ``lm_solve`` kernels' device
time per call.  In a Quality cell the frozen count is the lanes' busy
iterations (``workcount.lane_iters_quality``): every restart runs to its
end, and the slots where a lane whose attempts ended early waits for the
pose's slowest lane are no work the answer needs."""

from ikbench.harness import reader

read = reader("lm_solve_roofline")
