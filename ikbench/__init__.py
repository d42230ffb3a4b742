"""ikbench: the benchmark of the PyTorch/CUDA port ``optik_tpu_torch``.

``python3 ikbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``harness.py`` says how a cell's files are found)."""
