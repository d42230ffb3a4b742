"""The plain reference: plain PyTorch, NumPy and SciPy, independent of the
program under test (it imports nothing of ``optik_tpu_torch``).  It reads
the robot from the frozen URDF text, works out the restart stream again,
solves the sampled poses and lanes itself and judges the program's
answers against its own (``check.py``)."""
