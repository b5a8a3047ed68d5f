"""K1 ``csr_spmm``: the weighted row-sorted SpMM ``A_w x``.

``out[n] = sum_{e in [rowptr[n], rowptr[n+1])} w[e] * x[col[e]]``

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_scatter_w_kernel`` / ``_stripe_scatter_w_call`` (see the source note in
``csrc/csr_spmm.cu`` for what bounds it on the H100 and how it is laid out).
On a CUDA tensor the wrapper launches the hand-written kernel or raises; on
a CPU tensor it runs :func:`csr_spmm_plain`, the plain PyTorch version that
defines the kernel's semantics.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import build


def csr_spmm_plain(rowptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather, scale and ``index_add`` over the valid prefix
    ``[0, rowptr[-1])`` of the row-sorted edge arrays. Differentiable."""
    n_valid = int(rowptr[-1])
    r, c = row[:n_valid].long(), col[:n_valid].long()
    vals = x[c] * w[:n_valid, None]
    return torch.zeros((rowptr.shape[0] - 1, x.shape[1]), dtype=x.dtype,
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
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("csr_spmm: x and w must be float32")
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
    edges), not the [N, D] node state. Not differentiable by itself (see
    ``ops.spmm.make_spmm``)."""
    _check(rowptr, row, col, w, x, table)
    if x.device.type == "cpu":
        return csr_spmm_plain(rowptr, row, col, w, x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"csr_spmm: no kernel for {x.device}")
    n, d = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    build.launch("csr_spmm", x.device, rowptr.data_ptr(), col.data_ptr(),
                 w.data_ptr(), x.data_ptr(), out.data_ptr(), n, d)
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0
