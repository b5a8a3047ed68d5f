"""K2 ``edge_dot`` (SDDMM): per-edge dot products of two node tables.

``out[e] = sum_d a[row[e], d] * b[col[e], d]`` for the valid edges
``e < n_valid``; ``out[e] = 0`` for the padding slots after them.

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_gather_kernel`` / ``_stripe_gather_call`` together with the elementwise
dot ``graph_neural_pde_tpu/ops/spmm.py:129-133`` applies to its output (see
the source note in ``csrc/edge_dot.cu``). On a CUDA tensor the wrapper
launches the hand-written kernel or raises; on a CPU tensor it runs
:func:`edge_dot_plain`. ``b`` is float32 or bfloat16 (the bf16 x[col]
payload, whose weight gradient dots the float32 ``ct[row]`` with it); its
rows are widened to float32 before the products.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.csr_spmm import TABLE_DTYPES


def edge_dot_plain(row: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain version: two row gathers, a product and a sum over features
    (a bfloat16 ``b`` gathered, then widened to float32)."""
    out = torch.zeros(row.shape, dtype=a.dtype, device=a.device)
    r, c = row[:n_valid].long(), col[:n_valid].long()
    be = b[c]
    if be.dtype == torch.bfloat16:
        be = be.float()
    out[:n_valid] = (a[r] * be).sum(1)
    return out


def _check(row, col, a, b, n_valid):
    dev = a.device
    for name, t in (("row", row), ("col", col), ("b", b)):
        if t.device != dev:
            raise ValueError(f"edge_dot: {name} on {t.device}, a on {dev}")
    for name, t in (("row", row), ("col", col), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"edge_dot: {name} must be contiguous")
    if a.dtype != torch.float32 or b.dtype not in TABLE_DTYPES:
        raise TypeError(f"edge_dot: a must be float32 and b float32 or "
                        f"bfloat16, not {a.dtype} and {b.dtype}")
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("edge_dot: row and col must be int32")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"edge_dot: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be equal [N, D]")
    if row.shape != col.shape or row.dim() != 1:
        raise ValueError("edge_dot: row and col must be equal-length 1-D")
    if not 0 <= n_valid <= row.shape[0]:
        raise ValueError(f"edge_dot: n_valid {n_valid} outside "
                         f"[0, {row.shape[0]}]")


def edge_dot(row: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Per-edge ``a[row] . b[col]`` over the first ``n_valid`` edges."""
    _check(row, col, a, b, n_valid)
    if a.device.type == "cpu":
        return edge_dot_plain(row, col, a, b, n_valid)
    if a.device.type != "cuda":
        raise NotImplementedError(f"edge_dot: no kernel for {a.device}")
    out = torch.zeros(row.shape, dtype=torch.float32, device=a.device)
    build.launch("edge_dot", a.device, row.data_ptr(), col.data_ptr(),
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), n_valid,
                 a.shape[1], TABLE_DTYPES[b.dtype])
    edge_dot.launches += 1
    edge_dot.bf16_launches += b.dtype == torch.bfloat16
    return out


edge_dot.launches = 0
edge_dot.bf16_launches = 0      # the launches on a bfloat16 table, among them
