"""Batched solvers: projected LM for IK, ADMM QP for differential IK."""

from . import ik, lm

__all__ = ["ik", "lm"]
