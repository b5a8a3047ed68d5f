"""Build and load the port's CUDA kernels.

The kernels in ``graph_neural_pde_tpu_torch/csrc/*.cu`` (with the device
code they share in ``*.cuh``) are compiled by ``nvcc`` for Hopper
(``sm_90a``), one object per source with all ``nvcc`` processes started
together, and linked into one shared library with a plain
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
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# argument types of every C entry point (device pointers, ints, the stream
# last); each returns its cudaGetLastError() code
_ENTRY_POINTS = {
    # rowptr, col, w, x, out, n_rows, dim, lanes, vec, stage (kernels/
    # lanes.py's csr_design), dtype of x (0 float32, 1 bfloat16), stream
    "gnpde_csr_spmm": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    # row, col, a, b, out, n_valid, n_slots, dim, lanes, vec
    # (kernels/lanes.py), dtype of b (0 float32, 1 bfloat16), stream
    "gnpde_edge_dot": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    # piece_ptr, piece_seg, piece_slot, multi_piece (the segments'
    # pieces), segptr, perm (nullable), s, out, den, part (nullable without
    # multi-piece segments), n_segs, n_pieces, n_slots, piece (the
    # pieces' members, at most), capacity, heads, mode, lanes, vec
    # (kernels/lanes.py's segment_design), stream
    "gnpde_segment_norm": [_PTR] * 10 + [_INT] * 9 + [_PTR],
    # the segments' pieces as above, segptr, perm, out, g, den, ds, part,
    # then the same ints, stream
    "gnpde_segment_norm_bwd": [_PTR] * 11 + [_INT] * 9 + [_PTR],
    # The fused RHS kernels (csrc/fused_fwd.cu: K6, K7; csrc/fused_rhs.cu:
    # K9, K17; csrc/fused_bwd_rows.cu, csrc/fused_bwd_edges.cu: K8 without
    # and with dxg). qtab and ktab are scratch tables [n_rows, att]; kw_t is
    # Kw transposed. K6-K9 and K17 take a TABLES code: 0 float32 (x is the
    # column table too), 1 x float32 with the bfloat16 column table xcol, 2
    # both bfloat16.
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, x, xcol, qw, qb, kw, kb, gmax, var, ls, shifts, alpha
    # (the last four nullable), qtab, ktab, out, den, num (nullable), part
    # (nullable without multi-piece rows), n_rows, n_pieces, n_multi, dim,
    # att, heads, flags, vec (dim % 4 == 0 and the D-wide rows 16-byte
    # aligned), tables, stream
    "gnpde_fused_rhs_fwd": [_PTR] * 23 + [_INT] * 9 + [_PTR],
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, x, xcol, qw, qb, kw, kb, qtab, ktab, smax, part
    # (nullable without multi-piece rows), n_rows, n_pieces, n_multi, dim,
    # att, heads, tables, stream
    "gnpde_fused_rowmax": [_PTR] * 16 + [_INT] * 7 + [_PTR],
    # K8 with dxg (csrc/fused_bwd_edges.cu): piece_ptr, piece_row,
    # piece_slot, multi_row, multi_ptr (the rows' pieces), row, col, x,
    # xcol, qw, qb, kw, kb, gmax, var, ls, shifts (the last three
    # nullable), ct_ax, recip_p, ct_den, kw_t, qtab, ktab, dq, dxg, dke, w,
    # row_sums, part (nullable without multi-piece rows), partials, n_rows,
    # n_pieces, n_multi, dim, att, heads, flags, n_slots, reduce_blocks,
    # vec, tables, stream
    "gnpde_fused_rhs_bwd": [_PTR] * 30 + [_INT] * 11 + [_PTR],
    # K8 without dxg (csrc/fused_bwd_rows.cu): piece_ptr, piece_row,
    # piece_slot, multi_row, multi_ptr (the rows' pieces), col, x, xcol,
    # qw, qb, kw, kb, gmax, var, ls, shifts (the last three nullable),
    # ct_ax, recip_p, ct_den, qtab, ktab, dq, row_sums, part (nullable
    # without multi-piece rows), n_rows, n_pieces, n_multi, dim, att,
    # heads, flags, vec, project (0: qtab and ktab are filled already),
    # tables, stream
    "gnpde_fused_rhs_bwd_rows": [_PTR] * 24 + [_INT] * 10 + [_PTR],
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, x, xcol, qw, qb, kw, kb, gmax, var, ls (the last two
    # nullable), ct_ax, rc (each node's (recip_p, ct_den) per head), kw_t,
    # qtab, ktab, dq, dxrow, dkn, row_sums, part (nullable without
    # multi-piece rows), partials, n_rows, n_pieces, n_multi, dim, att,
    # heads, flags, reduce_blocks, vec (dim % 4 == 0 and the D-wide rows
    # 16-byte aligned), tables, stream
    "gnpde_fused_rhs_bwd_sym": [_PTR] * 26 + [_INT] * 10 + [_PTR],
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, u, x, num, den, part (nullable without multi-piece
    # rows), n_rows, n_pieces, n_multi, dim, heads, lanes, vec
    # (kernels/lanes.py), dtype of x (0 float32, 1 bfloat16), stream
    "gnpde_dual_scatter": [_PTR] * 11 + [_INT] * 8 + [_PTR],
    # the rows' pieces as above, col, rev, u, x, ct_num, ct_den, du, dx,
    # part (rev and dx nullable together; part nullable without dx or
    # without multi-piece rows), n_rows, n_pieces, n_multi, n_slots (du's
    # rows), dim, heads, lanes, vec (the du walk's), dx_lanes, dx_vec (the
    # dx walk's), dtype of x, stream
    "gnpde_dual_gather": [_PTR] * 14 + [_INT] * 11 + [_PTR],
    # piece_ptr, piece_col, piece_slot, multi_col, multi_ptr (the CSC
    # view's column pieces), row_by_col, x, xcol, qw, qb, kw, kb, gmax, var,
    # ls (the last two nullable), ct_ax, recip_p, ct_den, kw_t, qtab, ktab,
    # dx, dkn, part (nullable without multi-piece columns), partials,
    # n_cols, n_pieces, n_multi, dim, att, heads, flags, reduce_blocks,
    # project (0: qtab and ktab are filled already), tables, stream
    "gnpde_fused_rhs_bwd_col": [_PTR] * 25 + [_INT] * 10 + [_PTR],
    # The per-edge payload kernels (csrc/fused_payload.cu: K18 for the key
    # families, K8's per-head mode for them).
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces, Graph.scatter_pieces), row, xg, q (x_n Qw + qb), kw, kb, gmax,
    # var, ls, shifts (the last three nullable), num, den, part (nullable
    # without multi-piece rows), n_rows, n_pieces, n_multi, dim, att,
    # heads, flags, n_edges (the pieces' edges), cap (kernels/fused_rhs.py's
    # key_design), vec (16-byte rows of xg), dtype of xg (0 float32, 1
    # bfloat16), stream
    "gnpde_payload_keys": [_PTR] * 17 + [_INT] * 11 + [_PTR],
    # K8's per-head mode takes the TABLES code for the node rows x and the
    # per-edge payload xg: 0 both float32, 1 x float32 and xg bfloat16, 2
    # both bfloat16.
    # rowptr, xg, x, qw, qb, kw, kb, gmax, var, ls (the last two nullable),
    # ct_num, ct_den, dq, dxg, dke, row_sums, partials, n_rows, dim, att,
    # heads, flags, n_slots, reduce_blocks, tables, stream
    "gnpde_fused_rhs_bwd_heads": [_PTR] * 17 + [_INT] * 8 + [_PTR],
    # K18 and K8's per-head mode for the scaled-dot score (csrc/
    # payload_fwd.cu, csrc/payload_bwd.cu: Kw folded into each row's
    # query). piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the
    # rows' pieces, Graph.scatter_pieces), xg, q, kwt (Kw^T), kb, gmax,
    # shifts (nullable), num, den, part (nullable without multi-piece
    # rows), n_rows, n_pieces, n_multi, dim, att, heads, square_plus, lanes,
    # vec (kernels/lanes.py, payload_walk), dtype of xg (0 float32, 1
    # bfloat16), stream
    "gnpde_payload_aggregate": [_PTR] * 14 + [_INT] * 10 + [_PTR],
    # K19 (csrc/payload_fwd.cu): the rows' pieces as above, xg, q, kwt, kb,
    # partial, out, n_rows, n_pieces, dim, att, heads, lanes, vec, dtype of
    # xg, stream
    "gnpde_payload_score_max": [_PTR] * 11 + [_INT] * 8 + [_PTR],
    # the rows' pieces as above, xg, q, kwt, kw, kb, gmax, ct_num, ct_den,
    # dxg, ab ([a | b] a row), part, dq, node_part, node_bsum, dkw, dkb,
    # dgmax, n_rows, n_pieces, n_multi, n_slots, dim, att, heads,
    # square_plus, lanes, vec, dtype of xg, ranges (the node pass's), stream
    "gnpde_payload_bwd": [_PTR] * 22 + [_INT] * 12 + [_PTR],
    # The column-normalised RHS kernels (csrc/norm1_den.cu, csrc/norm1.cu),
    # with K6-K9's TABLES code (xcol the bfloat16 column table, ignored
    # with 0).
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, x, xcol, qw, qb, kw, kb, gmax, var, ls, ct (the last
    # three nullable), qtab, ktab, out, part (nullable without multi-piece
    # rows), n_rows, n_pieces, n_multi, dim, att, heads, flags, vec,
    # project (0: qtab and ktab are filled already), tables, stream
    "gnpde_norm1_den": [_PTR] * 20 + [_INT] * 10 + [_PTR],
    # piece_ptr, piece_row, piece_slot, multi_row, multi_ptr (the rows'
    # pieces), col, x, xcol, qw, qb, kw, kb, gmax, var, ls (the last two
    # nullable), recip, qtab, ktab, out, part (nullable without multi-piece
    # rows), n_rows, n_pieces, n_multi, dim, att, heads, flags, vec,
    # project, tables, stream
    "gnpde_norm1_fwd": [_PTR] * 20 + [_INT] * 10 + [_PTR],
    # as gnpde_fused_rhs_bwd_sym, with project before tables
    "gnpde_norm1_bwd": [_PTR] * 26 + [_INT] * 11 + [_PTR],
    # The dense products of the fused kernels alone (csrc/dense.cu).
    # x, xcol, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att, tables, stream
    "gnpde_node_tables": [_PTR] * 8 + [_INT] * 4 + [_PTR],
    # x, w, b, out, n_rows, dim, att, dtype of x (0 float32, 1 bfloat16),
    # stream: one table, out = x w + b
    "gnpde_dense_project": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # x, idx (nullable), dk, partials, rows, dim, att, blocks, dtype of x
    # (0 float32, 1 bfloat16), stream
    "gnpde_outer_reduce": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    # The blocked-plan kernels (csrc/blocked.cu).
    # rowptr, slot, col (the plan's valid slots by row), w, x, out, n_rows,
    # dim, lanes, vec, stream
    "gnpde_blocked_spmm": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    # row, col, slot (the valid slots in K15's order), chunk_rows,
    # chunk_cols, chunk_valid, a, b, out, n_valid, n_chunks, chunk, block_n,
    # dim, lanes, vec (kernels/lanes.py's edge_dot entry), stream
    "gnpde_blocked_sddmm": [_PTR] * 9 + [_INT] * 7 + [_PTR],
    # rowptr, table, out, n_rows, dim, dtype of out (0 float32, 1
    # bfloat16), stream (csrc/row_gather.cu)
    "gnpde_row_gather": [_PTR] * 3 + [_INT] * 3 + [_PTR],
    # idx, table, out, n_idx, t_rows, dim, dtype (0 float32, 1 bfloat16),
    # stream (csrc/smem_gather.cu)
    "gnpde_smem_gather": [_PTR] * 3 + [_INT] * 4 + [_PTR],
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
    for src in sorted(CSRC.glob("*.cu*")):     # the shared headers too
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


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device pointer for a nullable kernel argument; None (a
    null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``gnpde_<name>`` with ``args`` on the current
    stream of ``device``; raise if it returned a nonzero cudaError_t."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(library(), f"gnpde_{name}")(*args, stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {code})")
