"""Probe and parity scripts of the port.  The port's benchmark is
``ikbench/`` (``python3 ikbench/run.py --workload <cell>``); nothing here
defines a speed of the port.

* ``bench_fp32_peak``, ``exp_warp_probe``, ``exp_bisect``: hand-written
  CUDA kernels under ``optik_tpu_torch/csrc/`` that stand for the JAX
  package's Pallas probe kernels, each with a plain torch version beside it
  (``chip_smoke.py`` phase 10 runs them on the card).
* ``parity_native``, ``parity_hard``, ``parity_scipy``: success parity of
  the kernel, the native host library and SLSQP on the same poses.
* ``exp_lm_schedule``: the LM kernel alone with its schedule probe.
* ``timing``: the card's name, the host CPU, the solvers' dtype and a
  CUDA-event timer, shared by the scripts above and ``chip_smoke.py``.
"""
