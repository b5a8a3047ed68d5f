"""Build and load the port's CUDA kernels.

The kernels in ``graph_neural_pde_tpu_torch/csrc/*.cu`` are compiled by
``nvcc`` for Hopper (``sm_90a``), one object per source with all ``nvcc``
processes started together, and linked into one shared library with a plain
C interface that is loaded with ``ctypes``. The build happens at first use,
on the machine with the card, into ``build/kernels/`` under the checkout
root (ignored by git). The library's file name carries a hash of the sources
and flags, so an edited source triggers a rebuild and an unchanged one is
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# argument types of every C entry point (device pointers, ints, the stream
# last); each returns its cudaGetLastError() code
_ENTRY_POINTS = {
    # rowptr, col, w, x, out, n_rows, dim, stream
    "gnpde_csr_spmm": [_PTR] * 5 + [_INT, _INT, _PTR],
    # row, col, a, b, out, n_edges, dim, stream
    "gnpde_edge_dot": [_PTR] * 5 + [_INT, _INT, _PTR],
    # rowptr, perm (nullable), s, out, den, n_rows, heads, mode, stream
    "gnpde_segment_norm": [_PTR] * 5 + [_INT, _INT, _INT, _PTR],
    # rowptr, perm (nullable), out, g, den, ds, n_rows, heads, mode, stream
    "gnpde_segment_norm_bwd": [_PTR] * 6 + [_INT, _INT, _INT, _PTR],
    # The fused RHS kernels (csrc/fused_rhs.cu). qtab and ktab are scratch
    # tables [n_rows, att]; kw_t is Kw transposed.
    # rowptr, col, x, qw, qb, kw, kb, gmax, var, ls, shifts, alpha (the last
    # four nullable), qtab, ktab, out, den, num (nullable), n_rows, dim,
    # att, heads, flags, stream
    "gnpde_fused_rhs_fwd": [_PTR] * 17 + [_INT] * 5 + [_PTR],
    # rowptr, col, x, qw, qb, kw, kb, qtab, ktab, smax, n_rows, dim, att,
    # heads, stream
    "gnpde_fused_rowmax": [_PTR] * 10 + [_INT] * 4 + [_PTR],
    # rowptr, col, x, qw, qb, kw, kb, gmax, var, ls, shifts (the last three
    # nullable), ct_ax, recip_p, ct_den, kw_t, qtab, ktab, dq, dxg, dke,
    # row_sums, partials, n_rows, dim, att, heads, flags, n_slots,
    # reduce_blocks, stream
    "gnpde_fused_rhs_bwd": [_PTR] * 22 + [_INT] * 7 + [_PTR],
    # rowptr, col, x, qw, qb, kw, kb, gmax, var, ls (the last two nullable),
    # ct_ax, recip_p, ct_den, kw_t, qtab, ktab, dq, dxrow, dkn, row_sums,
    # partials, n_rows, dim, att, heads, flags, reduce_blocks, stream
    "gnpde_fused_rhs_bwd_sym": [_PTR] * 21 + [_INT] * 6 + [_PTR],
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


def _run_all(cmds):
    """Start every command at once, wait for all; raise on the first that
    failed. Returns the compiler output of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists.
    ``verbose`` prints ptxas's register and spill report."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    ptxas = ["-Xptxas=-v"] if verbose else []
    logs = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                      str(src)] for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    text = "".join(logs)
    if verbose and text:
        print(text)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``gnpde_<name>`` with ``args`` on the current
    stream of ``device``; raise if it returned a nonzero cudaError_t."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(library(), f"gnpde_{name}")(*args, stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {code})")
