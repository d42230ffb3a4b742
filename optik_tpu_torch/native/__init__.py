"""Native host runtime (C++): latency-path FK/Jacobian/IK via ctypes."""

from .host import HostChain, build, build_example

__all__ = ["HostChain", "build", "build_example"]
