"""Full-float32 contractions.

Reduced-precision contractions (bf16 passes on a TPU, TF32 on an NVIDIA
card) keep about three decimal digits.  The IK pipeline chains 7+ small
rotation products per FK and feeds the result into a 1e-6 tolerance check,
so that noise destroys convergence: success fell from ~94% to ~12% on the
Panda benchmark when the JAX package let bf16 in (docs/DESIGN.md,
"Precision").  The contractions here are tiny, so full f32 costs nothing.
"""

from __future__ import annotations

import torch


def use_full_f32_matmuls() -> None:
    """Turn TF32 off for matmuls and cuDNN; set matmul precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
