"""optik_tpu_torch: the PyTorch / CUDA port of optik_tpu.

Imports torch and numpy, never jax and never ``optik_tpu``.  The JAX
package stays in the repository as the reference the port is held against
(tests/test_torch_*.py).
"""

from .config import SolutionMode, SolverConfig
from .robot import Robot

__version__ = "0.1.0"

__all__ = ["Robot", "SolverConfig", "SolutionMode", "__version__"]
