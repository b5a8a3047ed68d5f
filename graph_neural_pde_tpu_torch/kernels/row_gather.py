"""K20 ``row_gather``: per-edge copies of node rows.

``out[e] = table[row[e]]`` over the valid prefix ``[0, rowptr[-1])`` of a
row-sorted edge list; ``out[e] = 0`` for the slots after it.

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``make_traced_scatter_add._gather_call`` (P6's gather, the VJP of the
per-shard stripe scatter) and the row gather of ``_gather_kernel`` (P2's
body) it runs, without the one-hot matrix product: the CSR row pointer
takes the stripe plan's place (see the source note in
``csrc/row_gather.cu``). On a CUDA tensor the wrapper launches the
hand-written kernel or raises; on a CPU tensor it runs
:func:`row_gather_plain`.

The table is float32; the output float32 or bfloat16 (``out_dtype``, the
VJP of the bf16 payload's scatter: each row rounded to nearest even).
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.csr_spmm import TABLE_DTYPES


def row_gather_plain(rowptr: torch.Tensor, row: torch.Tensor,
                     table: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version: ``index_select`` of the valid edges' rows, cast to
    ``out_dtype`` (None: the table's)."""
    n_valid = int(rowptr[-1])
    out = torch.zeros((row.shape[0], table.shape[1]),
                      dtype=out_dtype or table.dtype, device=table.device)
    out[:n_valid] = torch.index_select(table, 0,
                                       row[:n_valid].long()).to(out.dtype)
    return out


def _check(rowptr, row, table, out_dtype):
    dev = table.device
    for name, t in (("rowptr", rowptr), ("row", row)):
        if t.device != dev:
            raise ValueError(f"row_gather: {name} on {t.device}, table on "
                             f"{dev}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"row_gather: {name} must be contiguous 1-D "
                            f"int32")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("row_gather: table must be a contiguous [N, D] "
                         "tensor")
    if table.dtype != torch.float32:
        raise TypeError("row_gather: table must be float32")
    if out_dtype not in (None, *TABLE_DTYPES):
        raise TypeError(f"row_gather: output {out_dtype}; float32 or "
                        f"bfloat16")
    if rowptr.shape[0] != table.shape[0] + 1:
        raise ValueError(f"row_gather: rowptr {tuple(rowptr.shape)} does "
                         f"not match {table.shape[0]} rows")


def row_gather(rowptr: torch.Tensor, row: torch.Tensor,
               table: torch.Tensor, n_valid: Optional[int] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``table[row]`` [E, D] over the row-sorted edges whose valid prefix
    ``rowptr`` [N + 1] describes; zero past it. ``row`` is only read by the
    plain version and gives the output's length. ``n_valid``, the host's
    copy of ``rowptr[-1]``, spares a CUDA call the device-to-host read.
    ``out_dtype`` float32 (None) or bfloat16: the rows rounded once."""
    _check(rowptr, row, table, out_dtype)
    if table.device.type == "cpu":
        return row_gather_plain(rowptr, row, table, out_dtype)
    if table.device.type != "cuda":
        raise NotImplementedError(f"row_gather: no kernel for {table.device}")
    n, d = table.shape
    out_dtype = out_dtype or torch.float32
    out = torch.empty((row.shape[0], d), dtype=out_dtype,
                      device=table.device)
    if n_valid is None:
        n_valid = int(rowptr[-1])
    if n_valid < row.shape[0]:
        out[n_valid:].zero_()
    build.launch("row_gather", table.device, rowptr.data_ptr(),
                 table.data_ptr(), out.data_ptr(), n, d,
                 TABLE_DTYPES[out_dtype])
    row_gather.launches += 1
    row_gather.bf16_launches += out_dtype == torch.bfloat16
    return out


row_gather.launches = 0
row_gather.bf16_launches = 0    # the launches writing bfloat16, among them
