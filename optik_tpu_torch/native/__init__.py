"""Native host runtime (C++): latency-path FK/Jacobian/IK via ctypes."""

from .host import HostChain, build

__all__ = ["HostChain", "build"]
