"""K15 ``blocked_spmm`` and K16 ``blocked_sddmm``: SpMM and SDDMM over a
blocked edge plan (``ops.plan``), and the differentiable blocked SpMM the
``spmm_impl="pallas_blocked"`` engine runs.

* K15: ``out[rb·B + row_local[s]] += w[s] · x[cb·B + col_local[s]]`` over
  the plan's valid slots; x and out are [N_pad, D] float32, w [capacity].
* K16: ``out[s] = a[rb·B + row_local[s]] · b[cb·B + col_local[s]]`` for
  every slot (padding slots read node rb·B and cb·B), [capacity] float32;
  the kernel walks the valid slots in K15's row order, each with its
  global row and column, and writes each chunk's padding value once.

They replace the TPU kernels ``graph_neural_pde_tpu/ops/pallas/
spmm_blocked.py`` ``_spmm_kernel`` / ``_spmm_call`` (P17) and
``_sddmm_kernel`` / ``_sddmm_call`` (P18); the design note is in
``csrc/blocked.cu``. On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs its plain PyTorch version.

``make_spmm`` is the port of ``make_spmm`` / ``spmm_blocked`` (the custom
VJP of ``spmm_blocked.py:194-230``): forward K15; ``dx`` K15 on the
transposed plan with ``w_t = where(t_valid, w[t_perm], 0)``; ``dw`` K16
masked by the forward plan's ``valid``. It can take its weights in another
slot order than the plan's (``edge_map``), which is how the models hand it
the row-sorted graph's frozen attention.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.lanes import lanes
from graph_neural_pde_tpu_torch.ops.plan import (BlockPlan, build_block_plan,
                                                 transpose_plan)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class BlockedLayout:
    """A BlockPlan's arrays on one device, with the rows K15 walks.

    Per slot: ``row_local``, ``col_local``, ``valid``; per chunk:
    ``chunk_rows``, ``chunk_cols`` (K16 and the plain versions read
    these) and ``chunk_valid``, its valid slots, which come first in the
    chunk (K16 computes the padding value of the slots after them once a
    chunk). K15's row walk (host-built, see :func:`blocked_layout`): a CSR
    over the plan's valid slots, ``rowptr`` [N_pad + 1]; for each padded
    node row its slots in plan order (chunk by chunk, then by slot), with
    each slot's index ``slot`` (for w), its global column ``col`` and, for
    K16's walk over the same slots, its global row ``row``."""

    block_n: int
    chunk: int
    num_nodes: int
    row_local: torch.Tensor
    col_local: torch.Tensor
    valid: torch.Tensor
    chunk_rows: torch.Tensor
    chunk_cols: torch.Tensor
    chunk_valid: torch.Tensor
    rowptr: torch.Tensor
    slot: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.row_local.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.num_nodes // self.block_n


def blocked_layout(plan: BlockPlan, device="cpu") -> BlockedLayout:
    """Move a plan to ``device`` with K15's row walk (one-off host work: a
    stable sort of the valid slots, in plan order, by global row)."""
    slots = np.nonzero(plan.valid)[0]
    slots = slots[np.argsort(plan.row[slots], kind="stable")]
    rowptr = np.zeros(plan.num_nodes + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(plan.row[slots],
                                       minlength=plan.num_nodes))
    by_chunk = plan.valid.reshape(plan.n_chunks, plan.chunk)
    chunk_valid = by_chunk.sum(1)
    # K16 takes the padding slots to be each chunk's suffix (ops/plan.py)
    assert (by_chunk == (np.arange(plan.chunk) < chunk_valid[:, None])).all()
    return BlockedLayout(
        block_n=plan.block_n, chunk=plan.chunk, num_nodes=plan.num_nodes,
        row_local=_i32(plan.row_local, device),
        col_local=_i32(plan.col_local, device),
        valid=torch.as_tensor(plan.valid, device=device),
        chunk_rows=_i32(plan.chunk_rows, device),
        chunk_cols=_i32(plan.chunk_cols, device),
        chunk_valid=_i32(chunk_valid, device), rowptr=_i32(rowptr, device),
        slot=_i32(slots, device), col=_i32(plan.col[slots], device),
        row=_i32(plan.row[slots], device))


def _global_ids(lay: BlockedLayout):
    """Per slot, the global row and column node of its chunk's blocks."""
    rb = lay.chunk_rows.long().repeat_interleave(lay.chunk)
    cb = lay.chunk_cols.long().repeat_interleave(lay.chunk)
    return (rb * lay.block_n + lay.row_local.long(),
            cb * lay.block_n + lay.col_local.long())


def blocked_spmm_plain(lay: BlockedLayout, w: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather, scale and ``index_add`` over the valid
    slots. Differentiable."""
    rows, cols = _global_ids(lay)
    v = lay.valid
    return torch.zeros_like(x).index_add(0, rows[v],
                                         x[cols[v]] * w[v, None])


def blocked_sddmm_plain(lay: BlockedLayout, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain version: two row gathers, a product and a sum over features,
    for every slot."""
    rows, cols = _global_ids(lay)
    return (a[rows] * b[cols]).sum(1)


def _check(name, lay, tensors, w=None):
    """Device, contiguity, type and shape checks; float64 is taken on the
    CPU (the plain version, for gradcheck)."""
    dev = tensors[0].device
    floats = (torch.float32,) if dev.type == "cuda" else (torch.float32,
                                                          torch.float64)
    for t in (*tensors, lay.row_local) + (() if w is None else (w,)):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.is_floating_point() and t.dtype not in floats:
            raise TypeError(f"{name}: operands must be float32")
    for t in tensors:
        if t.dim() != 2 or t.shape != tensors[0].shape \
                or t.shape[0] != lay.num_nodes:
            raise ValueError(f"{name}: node tables must be [{lay.num_nodes}, "
                             f"D], got {tuple(t.shape)}")
    if w is not None and w.shape != (lay.capacity,):
        raise ValueError(f"{name}: w must be [{lay.capacity}], got "
                         f"{tuple(w.shape)}")


def spmm_lanes(dim: int, address: int = 0):
    """K15's (lanes G, vector width V) for rows of ``dim`` floats in a
    table at ``address`` (``kernels.lanes``): V the widest of 4, 2, 1
    floats that divides dim and whose V * 4 bytes divide the address
    (16-byte loads where dim % 4 == 0), G the smallest power of two
    covering dim / V vectors, at most 32."""
    return lanes("blocked_spmm", dim, (address, torch.float32))


def blocked_spmm(lay: BlockedLayout, w: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """K15: ``A_w x`` over the plan; x [N_pad, D] float32, w [capacity].
    Not differentiable by itself (see :func:`make_spmm`)."""
    _check("blocked_spmm", lay, (x,), w)
    if x.device.type == "cpu":
        return blocked_spmm_plain(lay, w, x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"blocked_spmm: no kernel for {x.device}")
    out = torch.empty_like(x)
    group, vec = spmm_lanes(x.shape[1], x.data_ptr())
    build.launch("blocked_spmm", x.device, lay.rowptr.data_ptr(),
                 lay.slot.data_ptr(), lay.col.data_ptr(), w.data_ptr(),
                 x.data_ptr(), out.data_ptr(), lay.num_nodes, x.shape[1],
                 group, vec)
    blocked_spmm.launches += 1
    return out


def blocked_sddmm(lay: BlockedLayout, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """K16: per-slot ``a[row] . b[col]``, [capacity] float32."""
    _check("blocked_sddmm", lay, (a, b))
    if a.device.type == "cpu":
        return blocked_sddmm_plain(lay, a, b)
    if a.device.type != "cuda":
        raise NotImplementedError(f"blocked_sddmm: no kernel for {a.device}")
    # the kernel writes every slot, the padding ones included
    out = torch.empty(lay.capacity, dtype=torch.float32, device=a.device)
    # K2's lanes: a slot's dot is K2's edge dot
    group, vec = lanes("edge_dot", a.shape[1], a, b)
    build.launch("blocked_sddmm", a.device, lay.row.data_ptr(),
                 lay.col.data_ptr(), lay.slot.data_ptr(),
                 lay.chunk_rows.data_ptr(), lay.chunk_cols.data_ptr(),
                 lay.chunk_valid.data_ptr(), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), lay.slot.shape[0], lay.chunk_rows.shape[0],
                 lay.chunk, lay.block_n, a.shape[1], group, vec)
    blocked_sddmm.launches += 1
    return out


blocked_spmm.launches = 0
blocked_sddmm.launches = 0


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class PlanPair(NamedTuple):
    """Forward plan, transposed plan and the slot permutation between them
    (host numpy, as the JAX package's ``PlanPair``)."""

    fwd: BlockPlan
    bwd: BlockPlan
    t_perm: np.ndarray
    t_valid: np.ndarray


def make_plan_pair(row, col, weight=None, mask=None, *, num_nodes: int,
                   block_n: int = 1024, chunk: int = 1024) -> PlanPair:
    fwd = build_block_plan(row, col, weight, mask, num_nodes=num_nodes,
                           block_n=block_n, chunk=chunk)
    bwd, t_perm, t_valid = transpose_plan(fwd)
    return PlanPair(fwd=fwd, bwd=bwd, t_perm=t_perm, t_valid=t_valid)


@dataclasses.dataclass(frozen=True)
class EdgeMap:
    """Slot maps between a caller's edge order and the plan's, for weights
    that arrive in the caller's order: ``to_plan`` [capacity] (the caller
    slot of each plan slot, 0 on padding) and ``from_plan`` [caller
    capacity] (the plan slot of each caller slot, 0 where ``mask`` is
    False)."""

    to_plan: torch.Tensor
    from_plan: torch.Tensor
    mask: torch.Tensor


class _BlockedSpmm(torch.autograd.Function):
    """out = A_w x over the plan pair. Residuals are the inputs (x, w)."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd, t_perm, t_valid, edge_map):
        if edge_map is not None:
            w = torch.where(fwd.valid, w[edge_map.to_plan.long()],
                            torch.zeros((), dtype=w.dtype, device=w.device))
        ctx.save_for_backward(x, w)
        ctx.plans = (fwd, bwd, t_perm, t_valid, edge_map)
        return blocked_spmm(fwd, w, x)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        fwd, bwd, t_perm, t_valid, edge_map = ctx.plans
        ct = ct.contiguous()
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_t = torch.where(t_valid, w[t_perm.long()], zero)
            dx = blocked_spmm(bwd, w_t, ct)
        if ctx.needs_input_grad[1]:
            dw = torch.where(fwd.valid, blocked_sddmm(fwd, ct, x), zero)
            if edge_map is not None:
                dw = torch.where(edge_map.mask,
                                 dw[edge_map.from_plan.long()], zero)
        return dx, dw, None, None, None, None, None


def make_spmm(plans: PlanPair, device="cpu",
              edge_map: Optional[EdgeMap] = None):
    """``spmm_fn(x, w)`` over a fixed plan pair on ``device``,
    differentiable in x [N_pad, D] and w: [capacity] in plan slot order,
    or in the caller's order with ``edge_map``."""
    fwd, bwd = blocked_layout(plans.fwd, device), blocked_layout(plans.bwd,
                                                                 device)
    t_perm = _i32(plans.t_perm, device)
    t_valid = torch.as_tensor(plans.t_valid, device=device)

    def spmm_fn(x, w):
        return _BlockedSpmm.apply(x.contiguous(), w.contiguous(), fwd, bwd,
                                  t_perm, t_valid, edge_map)

    return spmm_fn


def spmm_blocked(plans: PlanPair, x: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """A @ x with per-slot weights in plan order; differentiable in (x, w)."""
    return make_spmm(plans, x.device)(x, w)
