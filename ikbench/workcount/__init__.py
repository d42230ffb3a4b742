"""Recounts of the work the roofline reads, frozen in the configuration
files (FP32 operations per lane-iteration, ``ops.py``) and the cells'
files (lane-iterations per solve, ``lane_iters.py``)."""
