"""Measurement and probe scripts of the port, each with a hand-written CUDA
kernel under ``optik_tpu_torch/csrc/`` and a plain torch version beside it."""
