"""Core compute ops on torch tensors: FK, Jacobians, objective/residual
kernels; the hand-written CUDA kernel's wrapper is ``ops/cuda``."""

from . import kinematics, objective
from .kinematics import ChainParams

__all__ = ["kinematics", "objective", "ChainParams"]
