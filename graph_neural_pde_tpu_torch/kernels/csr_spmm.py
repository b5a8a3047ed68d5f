"""K1 ``csr_spmm``: the weighted row-sorted SpMM ``A_w x``.

``out[n] = sum_{e in [rowptr[n], rowptr[n+1])} w[e] * x[col[e]]``

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_scatter_w_kernel`` / ``_stripe_scatter_w_call`` (see the source note in
``csrc/csr_spmm.cu`` for what bounds it on the H100 and how it is laid out).
On a CUDA tensor the wrapper launches the hand-written kernel or raises; on
a CPU tensor it runs :func:`csr_spmm_plain`, the plain PyTorch version that
defines the kernel's semantics.

The table ``x`` is float32 or bfloat16 (the JAX package's bf16 payload,
``rhs_payload_dtype``): a bf16 row is converted to float32 before its
product with the float32 weight, and the sums and the output are float32.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import build

# the table dtypes K1 and K2 read, and their codes at the C entry points
TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def csr_spmm_plain(rowptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather, scale and ``index_add`` over the valid prefix
    ``[0, rowptr[-1])`` of the row-sorted edge arrays (a bfloat16 ``x``
    gathered, then widened to float32). Differentiable."""
    n_valid = int(rowptr[-1])
    r, c = row[:n_valid].long(), col[:n_valid].long()
    xe = x[c]
    if xe.dtype == torch.bfloat16:
        xe = xe.float()
    vals = xe * w[:n_valid, None]
    return torch.zeros((rowptr.shape[0] - 1, x.shape[1]), dtype=vals.dtype,
                       device=x.device).index_add(0, r, vals)


def _check(rowptr, row, col, w, x, table):
    dev = x.device
    for name, t in (("rowptr", rowptr), ("row", row), ("col", col),
                    ("w", w)):
        if t.device != dev:
            raise ValueError(f"csr_spmm: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"csr_spmm: {name} must be contiguous")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("csr_spmm: x must be a contiguous [N, D] tensor")
    # the plain version also takes float64 on the CPU (a float64 reference)
    wide = dev.type == "cpu" and x.dtype == torch.float64
    if not (x.dtype in TABLE_DTYPES and w.dtype == torch.float32 or wide
            and w.dtype in (torch.float32, torch.float64)):
        raise TypeError(f"csr_spmm: x must be float32 or bfloat16 and w "
                        f"float32, not {x.dtype} and {w.dtype}")
    for name, t in (("rowptr", rowptr), ("row", row), ("col", col)):
        if t.dtype != torch.int32:
            raise TypeError(f"csr_spmm: {name} must be int32")
    if rowptr.dim() != 1 or rowptr.shape[0] < 1 or (
            not table and rowptr.shape[0] != x.shape[0] + 1):
        raise ValueError(f"csr_spmm: rowptr {tuple(rowptr.shape)} does not "
                         f"match {x.shape[0]} rows")
    if not (row.shape == col.shape == w.shape and col.dim() == 1):
        raise ValueError("csr_spmm: row, col and w must be equal-length 1-D")


def csr_spmm(rowptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
             w: torch.Tensor, x: torch.Tensor, table: bool = False
             ) -> torch.Tensor:
    """``A_w x`` over a row-sorted graph whose valid edges are the prefix
    ``[0, rowptr[-1])`` of ``row``/``col``/``w``. ``row`` is only read by the
    plain version. With ``table`` the gathered ``x`` is any table of rows
    that ``col`` indexes (a per-edge array summed over each row's reverse
    edges), not the [N, D] node state. ``x`` float32 or bfloat16; the
    output is float32. Not differentiable by itself (see
    ``ops.spmm.make_spmm``)."""
    _check(rowptr, row, col, w, x, table)
    if x.device.type == "cpu":
        return csr_spmm_plain(rowptr, row, col, w, x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"csr_spmm: no kernel for {x.device}")
    n, d = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    build.launch("csr_spmm", x.device, rowptr.data_ptr(), col.data_ptr(),
                 w.data_ptr(), x.data_ptr(), out.data_ptr(), n, d,
                 TABLE_DTYPES[x.dtype])
    csr_spmm.launches += 1
    csr_spmm.table_launches += table
    csr_spmm.bf16_launches += x.dtype == torch.bfloat16
    csr_spmm.table_bf16_launches += table and x.dtype == torch.bfloat16
    return out


csr_spmm.launches = 0
csr_spmm.table_launches = 0     # the launches in table mode, among them
csr_spmm.bf16_launches = 0      # the launches on a bfloat16 table, among them
csr_spmm.table_bf16_launches = 0    # those in table mode, among those


def column_sum(g, table: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_{e: col[e]=n, e valid} table[e]`` for a per-edge
    table [E_pad, D] over a row-sorted graph ``g``: one launch in table
    mode, through the reverse edges on a symmetric edge multiset
    (``g.rev``), over the CSC view (``g.colptr``, ``g.col_perm``)
    otherwise. Slots outside ``g.mask`` weigh 0."""
    w = g.mask.to(table.dtype)
    if g.rev is not None:
        return csr_spmm(g.rowptr, g.row, g.rev, w[g.rev.long()], table,
                        table=True)
    return csr_spmm(g.colptr, g.col_by_col, g.col_perm,
                    w[g.col_perm.long()], table, table=True)
