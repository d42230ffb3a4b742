"""Lie-group math (SO(3)/SE(3)) on torch tensors with leading batch
dimensions: the array-path counterpart of ``ops/soa.py``."""

from . import linalg, se3, so3

__all__ = ["so3", "se3", "linalg"]
