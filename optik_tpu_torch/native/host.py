"""ctypes binding for the native host runtime (``liboptik_host_torch``).

The latency path: single-query FK, Jacobian, IK and diff-IK in a few
microseconds on the host CPU, with no device round trip, and the C ABI that
C++ clients use (``include/optik_host.h``, the RAII wrapper
``include/optik.hpp``).  The surface is ``optik_tpu/native/host.py``'s: the
same names, signatures, error strings and return conventions.

The port keeps its own copy of the C++ source and headers beside this file
(importing ``optik_tpu.native`` would import jax through ``optik_tpu``).  The
library is compiled with g++ at first use, with the JAX binding's flags, into
``build/optik_tpu_torch/native-<key>/`` at the repository root, keyed by a
hash of the source, the headers, the flags and the host CPU's model (the
flags hold ``-march=native``, so a library built on one CPU may not run on
another).  It is written through a temporary file and moved into place, so
two processes building at once never load half a library.  Its file name
differs from the JAX binding's,
and each binding loads its library with ``RTLD_LOCAL`` and binds symbols
through its own handle, so one process can hold both.  Without g++ every
entry point raises ``RuntimeError``; nothing stands in for the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "optik_host.cpp"
HEADERS = (_HERE / "include" / "optik_host.h", _HERE / "include" / "optik.hpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "liboptik_host_torch.so"
BUILD_ROOT = _HERE.parents[1] / "build" / "optik_tpu_torch"
_lock = threading.Lock()
_lib = None

_ERR_LEN = 512


class CSolverConfig(ctypes.Structure):
    """Mirror of ``optik_host_solver_config`` (include/optik_host.h), which
    itself mirrors the reference's repr(C) CSolverConfig
    (crates/optik-cpp/src/lib.rs:11-20) plus deterministic budget knobs."""

    _fields_ = [
        ("solution_mode", ctypes.c_int),     # 1 = quality, 2 = speed
        ("max_time", ctypes.c_double),
        ("max_restarts", ctypes.c_int),
        ("tol_f", ctypes.c_double),
        ("tol_df", ctypes.c_double),
        ("tol_dx", ctypes.c_double),
        ("linear_weight", ctypes.c_double * 3),
        ("angular_weight", ctypes.c_double * 3),
        ("max_iters", ctypes.c_int),
        ("rng_seed", ctypes.c_uint64),
    ]


def cpu_model() -> str:
    """The host CPU's model: its name, vendor, family, model and stepping
    from ``/proc/cpuinfo`` on Linux (a virtual machine may report the name
    as "unknown"), else what ``platform`` knows."""
    info = pathlib.Path("/proc/cpuinfo")
    fields = {}
    if info.exists():
        for line in info.read_text().splitlines():
            key, _, value = line.partition(":")
            key = key.strip()
            if not key:
                break  # the first processor's block is enough
            fields.setdefault(key, value.strip())
    if "model name" not in fields:
        return platform.processor() or platform.machine()
    return (f"{fields['model name']} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}"
            f" stepping {fields.get('stepping', '?')})")


def library_path() -> pathlib.Path:
    """Where the library of this source, these headers, flags and host CPU
    lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in HEADERS:
        digest.update(b"\0" + header.name.encode() + b"\0"
                      + header.read_bytes())
    digest.update("\0".join(FLAGS + (cpu_model(),)).encode())
    return BUILD_ROOT / f"native-{digest.hexdigest()[:16]}" / LIB_NAME


def build(force: bool = False) -> pathlib.Path:
    """Compile the library if it is not built yet; returns its path.

    The g++ command is kept beside the library in ``command.txt``."""
    lib_path = library_path()
    if lib_path.exists() and not force:
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host runtime "
                           f"is compiled from {SOURCE}")
    out_dir = lib_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        cmd = [gxx, *FLAGS, str(SOURCE), "-o", str(tmp_lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}:\n{proc.stderr}")
        (pathlib.Path(tmp) / "command.txt").write_text(" ".join(cmd) + "\n")
        os.replace(pathlib.Path(tmp) / "command.txt", out_dir / "command.txt")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(str(path))

        dptr = ctypes.POINTER(ctypes.c_double)
        u8ptr = ctypes.POINTER(ctypes.c_uint8)

        lib.optik_host_chain_new.restype = ctypes.c_void_p
        lib.optik_host_chain_new.argtypes = [
            ctypes.c_int, dptr, dptr, dptr, u8ptr, dptr, dptr, dptr, dptr]
        lib.optik_host_chain_from_urdf_str.restype = ctypes.c_void_p
        lib.optik_host_chain_from_urdf_str.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.optik_host_chain_from_urdf_file.restype = ctypes.c_void_p
        lib.optik_host_chain_from_urdf_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.optik_host_chain_free.argtypes = [ctypes.c_void_p]
        lib.optik_host_num_positions.restype = ctypes.c_int
        lib.optik_host_num_positions.argtypes = [ctypes.c_void_p]
        lib.optik_host_joint_limits.argtypes = [ctypes.c_void_p, dptr, dptr]
        lib.optik_host_random_configuration.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, dptr]
        lib.optik_host_fk.argtypes = [ctypes.c_void_p, dptr, dptr, dptr]
        lib.optik_host_jacobian.argtypes = [ctypes.c_void_p, dptr, dptr, dptr]
        lib.optik_host_ik.restype = ctypes.c_int
        lib.optik_host_ik.argtypes = [
            ctypes.c_void_p, dptr, dptr, dptr, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, dptr, dptr]
        lib.optik_host_solver_config_default.restype = CSolverConfig
        lib.optik_host_solver_config_default.argtypes = []
        lib.optik_host_ik_cfg.restype = ctypes.c_int
        lib.optik_host_ik_cfg.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(CSolverConfig), dptr, dptr, dptr,
            dptr, dptr]
        lib.optik_host_diff_ik.restype = ctypes.c_int
        lib.optik_host_diff_ik.argtypes = [
            ctypes.c_void_p, dptr, dptr, dptr, dptr, dptr, dptr]
        _lib = lib
        return lib


def _as_dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _opt_pose_ptr(pose) -> Tuple[Optional[np.ndarray], object]:
    """(array keep-alive, pointer) for an optional row-major 4x4 pose."""
    if pose is None:
        return None, ctypes.POINTER(ctypes.c_double)()
    arr = np.ascontiguousarray(pose, dtype=np.float64).reshape(16)
    return arr, _as_dptr(arr)


class HostChain:
    """Native chain handle with FK / Jacobian / single-solve IK / diff-IK."""

    def __init__(self, spec=None, *, _ptr=None, _n=None):
        lib = _load()
        self._lib = lib
        if _ptr is not None:
            self._ptr = _ptr
            self.n = _n
            return
        self.n = spec.num_positions
        # Keep the arrays alive for the duration of the C call.
        org_r = np.ascontiguousarray(spec.origin_r, dtype=np.float64)
        org_t = np.ascontiguousarray(spec.origin_t, dtype=np.float64)
        axis = np.ascontiguousarray(spec.axis, dtype=np.float64)
        pris = np.ascontiguousarray(spec.prismatic > 0.5, dtype=np.uint8)
        lower = np.ascontiguousarray(spec.lower, dtype=np.float64)
        upper = np.ascontiguousarray(spec.upper, dtype=np.float64)
        tip_r = np.ascontiguousarray(spec.tip_r, dtype=np.float64)
        tip_t = np.ascontiguousarray(spec.tip_t, dtype=np.float64)
        self._ptr = lib.optik_host_chain_new(
            self.n, _as_dptr(org_r), _as_dptr(org_t), _as_dptr(axis),
            pris.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _as_dptr(lower), _as_dptr(upper), _as_dptr(tip_r),
            _as_dptr(tip_t))

    @classmethod
    def from_urdf_str(cls, xml: str, base_link: str, ee_link: str
                      ) -> "HostChain":
        """Build from URDF text via the native ingest (no Python parsing)."""
        lib = _load()
        err = ctypes.create_string_buffer(_ERR_LEN)
        ptr = lib.optik_host_chain_from_urdf_str(
            xml.encode(), base_link.encode(), ee_link.encode(), err, _ERR_LEN)
        if not ptr:
            raise ValueError(err.value.decode())
        return cls(_ptr=ptr, _n=lib.optik_host_num_positions(ptr))

    @classmethod
    def from_urdf_file(cls, path, base_link: str, ee_link: str) -> "HostChain":
        lib = _load()
        err = ctypes.create_string_buffer(_ERR_LEN)
        ptr = lib.optik_host_chain_from_urdf_file(
            str(path).encode(), base_link.encode(), ee_link.encode(), err,
            _ERR_LEN)
        if not ptr:
            raise ValueError(err.value.decode())
        return cls(_ptr=ptr, _n=lib.optik_host_num_positions(ptr))

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.optik_host_chain_free(ptr)
            self._ptr = None

    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.empty(self.n)
        hi = np.empty(self.n)
        self._lib.optik_host_joint_limits(self._ptr, _as_dptr(lo),
                                          _as_dptr(hi))
        return lo, hi

    def random_configuration(self, seed: int = 0) -> np.ndarray:
        out = np.empty(self.n)
        self._lib.optik_host_random_configuration(
            self._ptr, ctypes.c_uint64(seed), _as_dptr(out))
        return out

    def fk(self, q, ee_offset=None) -> np.ndarray:
        q = np.ascontiguousarray(q, dtype=np.float64)
        _keep, ee_ptr = _opt_pose_ptr(ee_offset)
        out = np.empty(16)
        self._lib.optik_host_fk(self._ptr, _as_dptr(q), ee_ptr, _as_dptr(out))
        return out.reshape(4, 4)

    def jacobian(self, q, ee_offset=None) -> np.ndarray:
        q = np.ascontiguousarray(q, dtype=np.float64)
        _keep, ee_ptr = _opt_pose_ptr(ee_offset)
        out = np.empty(6 * self.n)
        self._lib.optik_host_jacobian(self._ptr, _as_dptr(q), ee_ptr,
                                      _as_dptr(out))
        return out.reshape(6, self.n)

    def ik(self, target, x0, tol_f: float = 1e-6, max_iters: int = 64,
           max_restarts: int = 64, rng_seed: int = 42, ee_offset=None,
           solution_mode: str = "speed", tol_df: float = -1.0,
           tol_dx: float = -1.0,
           linear_weight=(1.0, 1.0, 1.0), angular_weight=(1.0, 1.0, 1.0),
           ) -> Optional[Tuple[np.ndarray, float]]:
        """Single-solve IK with the full reference config surface.

        Mirrors the reference C ABI's CSolverConfig fields
        (crates/optik-cpp/src/lib.rs:11-20): Speed/Quality selection,
        per-axis weights, tol_df/tol_dx success criteria.  An out-of-limits
        seed raises ValueError with the reference's panic message
        (lib.rs:251-254)."""
        target = np.ascontiguousarray(target, dtype=np.float64)
        x0 = np.ascontiguousarray(x0, dtype=np.float64)
        _keep, ee_ptr = _opt_pose_ptr(ee_offset)
        x_out = np.empty(self.n)
        f_out = np.empty(1)

        cfg = self._lib.optik_host_solver_config_default()
        cfg.solution_mode = {"quality": 1, "speed": 2}[solution_mode]
        cfg.max_restarts = max_restarts
        cfg.tol_f = tol_f
        cfg.tol_df = tol_df
        cfg.tol_dx = tol_dx
        cfg.linear_weight = (ctypes.c_double * 3)(*linear_weight)
        cfg.angular_weight = (ctypes.c_double * 3)(*angular_weight)
        cfg.max_iters = max_iters
        cfg.rng_seed = rng_seed

        ok = self._lib.optik_host_ik_cfg(
            self._ptr, ctypes.byref(cfg), _as_dptr(target), _as_dptr(x0),
            ee_ptr, _as_dptr(x_out), _as_dptr(f_out))
        if ok < 0:
            raise ValueError("seed joint position outside of joint limits")
        if not ok:
            return None
        return x_out, float(f_out[0])

    def diff_ik(self, x0, v_we, v_max, ee_offset=None
                ) -> Optional[Tuple[float, np.ndarray]]:
        """Velocity-limited diff-IK step; (alpha, v) or None (lib.rs:101-239)."""
        x0 = np.ascontiguousarray(x0, dtype=np.float64)
        v_we = np.ascontiguousarray(v_we, dtype=np.float64)
        v_max = np.ascontiguousarray(v_max, dtype=np.float64)
        _keep, ee_ptr = _opt_pose_ptr(ee_offset)
        alpha = np.empty(1)
        v = np.empty(self.n)
        ok = self._lib.optik_host_diff_ik(
            self._ptr, _as_dptr(x0), _as_dptr(v_we), _as_dptr(v_max), ee_ptr,
            _as_dptr(alpha), _as_dptr(v))
        if not ok:
            return None
        return float(alpha[0]), v
