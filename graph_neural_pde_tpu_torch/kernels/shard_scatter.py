"""The per-rank stripe scatter and its gather (the TPU kernel pair P6).

``shard_scatter(plan, vals)`` is ``out[n] = sum_{e: row[e] = n} vals[e]``
[N, D] over one rank's row-sorted slice of an edge list, with the row
gather ``ct[row]`` as its VJP. It ports the contract of
``graph_neural_pde_tpu/ops/pallas/stripe.py`` ``make_traced_scatter_add``
(its ``_call``, P3's scatter body ``_scatter_kernel``, and its
``_gather_call``, P2's gather body ``_gather_kernel``), whose per-shard
stripe plans arrive as traced operands inside ``shard_map``. Here a rank's
plan is its CSR row pointer, built on the host (:class:`ScatterPlan`).

* The forward is K1 ``csr_spmm`` in table mode: the gathered table is the
  payload ``vals`` itself, ``col`` is the slot index ``arange(E)`` and
  ``w`` the valid mask (1 on the prefix ``[0, rowptr[-1])``). That is
  exactly P6's scatter, at the price of the 8 bytes an edge that K1 reads
  for ``col`` and ``w`` and a dedicated segment sum would not.
* The backward is K20 ``row_gather``. The index operands get no gradient.

``vals`` is float32 or bfloat16 (the bf16 payload,
``make_traced_scatter_add(vals_dtype=bf16)``): K1 reads the bfloat16 table
and sums in float32, and K20 writes the gradient in ``vals``' dtype, each
row of the float32 cotangent rounded once, as P6's one-hot product of
bf16-rounded rows gives it.

On CUDA tensors both run their kernels or raise; on CPU tensors their
plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graph_neural_pde_tpu_torch.kernels.csr_spmm import csr_spmm
from graph_neural_pde_tpu_torch.kernels.row_gather import row_gather


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """One rank's row-sorted edges, all valid: ``rowptr`` int32[N + 1],
    ``row`` int32[E], the slot index ``slots`` int32[E] and the valid mask
    ``valid`` float32[E] (ones) that K1 reads in table mode, and
    ``n_valid`` = E, the host's copy of ``rowptr[-1]``."""

    rowptr: torch.Tensor
    row: torch.Tensor
    slots: torch.Tensor
    valid: torch.Tensor
    n_valid: int

    @staticmethod
    def from_rows(row: np.ndarray, num_nodes: int, device="cpu"
                  ) -> "ScatterPlan":
        """The plan of a row-sorted array of valid edges' rows."""
        row = np.asarray(row, np.int64)
        if np.any(np.diff(row) < 0):
            raise ValueError("ScatterPlan: rows must be sorted")
        nv = row.shape[0]
        rowptr = np.zeros(num_nodes + 1, np.int64)
        rowptr[1:] = np.cumsum(np.bincount(row, minlength=num_nodes))

        def dev(a):
            return torch.from_numpy(a).to(device)

        return ScatterPlan(rowptr=dev(rowptr.astype(np.int32)),
                           row=dev(row.astype(np.int32)),
                           slots=dev(np.arange(nv, dtype=np.int32)),
                           valid=dev(np.ones(nv, np.float32)), n_valid=nv)

    @property
    def num_nodes(self) -> int:
        return self.rowptr.shape[0] - 1


class _ShardScatter(torch.autograd.Function):
    """out = K1 in table mode over the plan (float32); d vals = K20 of the
    output's cotangent in vals' dtype (zero past the valid prefix). No
    residual but the plan."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan, ctx.vals_dtype = plan, vals.dtype
        return csr_spmm(plan.rowptr, plan.row, plan.slots, plan.valid, vals,
                        table=True)

    @staticmethod
    def backward(ctx, ct):
        plan = ctx.plan
        return row_gather(plan.rowptr, plan.row, ct.contiguous(),
                          plan.n_valid, out_dtype=ctx.vals_dtype), None


def shard_scatter(plan: ScatterPlan, vals: torch.Tensor) -> torch.Tensor:
    """Per-node sums [N, D] (float32) of the per-edge payload ``vals``
    [E, D] (float32 or bfloat16) over the plan's valid prefix,
    differentiable in ``vals``."""
    if vals.shape[0] != plan.row.shape[0]:
        raise ValueError(f"shard_scatter: {vals.shape[0]} payload rows for "
                         f"a plan of {plan.row.shape[0]} slots")
    return _ShardScatter.apply(vals.contiguous(), plan)
