"""Build and load the port's CUDA kernels.

The kernels in ``graph_neural_pde_tpu_torch/csrc/*.cu`` are compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface and loaded with ``ctypes``. The build happens at first use, on the
machine with the card, into ``build/kernels/`` under the checkout root
(ignored by git). The library's file name carries a hash of the sources and
flags, so an edited source triggers a rebuild and an unchanged one is
reused.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# every C entry point takes this many device pointers, then (int, int,
# stream), and returns its cudaGetLastError() code
_ENTRY_POINTS = {
    "gnpde_csr_spmm": 5,
    "gnpde_edge_dot": 5,
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and CUDA_HOME/bin); the CUDA "
            "kernels are built on the machine with the card")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgnpde_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists.
    ``verbose`` prints ptxas's register and spill report."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, n_ptr in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {code})")
