"""Build a CUDA source of the port into a shared library at first use.

Every kernel of the port is a ``.cu`` file under ``optik_tpu_torch/csrc/``
with a plain C interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``.  The library goes to ``build/optik_tpu_torch/<name>-<hash>/`` at
the repository root, keyed by a hash of the source, the flags and the text
of any generated header: an edit, another variant (``-D`` flags,
``--fmad=false``) or another robot's chain constants builds anew, and a
second process reuses the build.  Generated headers are written into that
directory, which is on the include path; the ``-Xptxas -v`` report
(registers, spills) is kept beside the library in ``ptxas.txt``.

:func:`build_library` may be called from several threads at once (one
``nvcc`` process each), which is how a caller builds many variants in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Mapping, NamedTuple, Optional, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "optik_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    seconds: float       # nvcc wall time (0.0 when the library was cached)
    cached: bool
    ptxas: str           # the -Xptxas -v report (registers, spills)
    path: pathlib.Path   # the shared library


def find_cuda_tool(name: str) -> Optional[str]:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``) under
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or on ``PATH``, or
    None."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / name
    return str(cand) if cand.exists() else shutil.which(name)


def cuda_tool(name: str) -> str:
    """:func:`find_cuda_tool`, raising where the program is missing."""
    found = find_cuda_tool(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin and PATH): the "
            "CUDA toolkit is needed to build optik_tpu_torch/csrc/*.cu")
    return found


def build_key(source: pathlib.Path, flags: Sequence[str],
              headers: Mapping[str, str]) -> str:
    """The key of one build: a hash of the source, the full nvcc flags and
    the generated headers' names and text."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    for name in sorted(headers):
        digest.update(f"\0{name}\0{headers[name]}".encode())
    return digest.hexdigest()[:16]


def library_path(source: pathlib.Path, flags: Sequence[str] = (),
                 fmad: bool = True,
                 headers: Optional[Mapping[str, str]] = None) -> pathlib.Path:
    """Where :func:`build_library` puts the library of these arguments
    (nothing is built)."""
    flags = NVCC_FLAGS + tuple(flags) + (() if fmad else ("--fmad=false",))
    key = build_key(source, flags, dict(headers or {}))
    return BUILD_ROOT / f"{source.stem}-{key}" / f"lib{source.stem}.so"


def build_library(source: pathlib.Path, flags: Sequence[str] = (),
                  fmad: bool = True,
                  headers: Optional[Mapping[str, str]] = None):
    """Compile ``source`` with ``NVCC_FLAGS + flags`` and load it:
    ``(ctypes.CDLL, BuildInfo)``.

    ``headers`` maps file names to the text of headers generated for this
    build (``#include "name"`` in the source finds them); their text is part
    of the key.

    ``fmad=False`` adds ``--fmad=false``: without multiply-add contraction a
    kernel rounds every operation as torch's elementwise CUDA kernels do,
    which is what makes a bitwise comparison with a plain torch version
    possible.
    """
    lib_path = library_path(source, flags, fmad, headers)
    flags = NVCC_FLAGS + tuple(flags) + (() if fmad else ("--fmad=false",))
    headers = dict(headers or {})
    out_dir = lib_path.parent
    log_path = out_dir / "ptxas.txt"
    seconds, cached = 0.0, lib_path.exists()
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = pathlib.Path(tmp) / lib_path.name
            for name, text in headers.items():
                # Written whole, then moved: a second process building the
                # same key never reads half a header.
                (pathlib.Path(tmp) / name).write_text(text)
                os.replace(pathlib.Path(tmp) / name, out_dir / name)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [cuda_tool("nvcc"), *flags, "-I", str(out_dir), "-o",
                 str(tmp_lib), str(source)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {source} with "
                    f"{' '.join(flags)}:\n{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp_lib, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptxas = log_path.read_text() if log_path.exists() else ""
    return lib, BuildInfo(seconds, cached, ptxas, lib_path)


def ptxas_usage(report: str, kernel: str = "") -> dict:
    """Registers, stack and spill bytes of the first kernel of a
    ``-Xptxas -v`` report whose mangled name contains ``kernel``."""
    m = re.search(
        rf"Compiling entry function '[^']*{re.escape(kernel)}[^']*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", report, re.S)
    if m is None:
        raise RuntimeError(f"no ptxas report for a kernel named *{kernel}*")
    stack, st, ld, regs = (int(v) for v in m.groups())
    return {"registers": regs, "stack": stack, "spill_stores": st,
            "spill_loads": ld}
