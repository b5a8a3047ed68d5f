"""Autograd-aware collectives of a :class:`~.mesh.Mesh`.

``shard_map`` gives the JAX package the transposes of its collectives for
free; ``torch.distributed``'s collectives are not differentiable, so each
is a ``torch.autograd.Function`` here, with the transpose that ``shard_map``
would derive:

* :func:`psum_replicated`: forward all-reduce (the sum of every rank's
  partial, ``jax.lax.psum``), backward identity: the result is replicated
  and so is its cotangent, which every partial receives whole;
* :func:`enter_replicated`: forward identity, backward all-reduce: the
  transpose of an input with spec ``P()`` entering a shard body, whose
  gradient is the sum of every rank's contribution;
* :func:`ring_shift`: each rank sends its block to rank - 1 and receives
  rank + 1's (the JAX package's ``ppermute`` with
  ``perm = [(i, (i - 1) % nd)]``); the backward is the inverse shift;
* :func:`gather_rows`: forward all-gather of the ranks' row blocks into
  the whole array, replicated (what a row-sharded ``shard_map`` output is
  to its caller), backward this rank's rows of the replicated cotangent.

On a split mesh (one process running every rank) the same four are plain
tensor operations: the partials are summed in rank order, an input used by
every rank gathers its gradient through autograd, the shift rotates the
list of blocks, and the ranks' rows are already the whole array. Each
function takes and returns the values of the ranks this process runs, in
``mesh.ranks`` order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from graph_neural_pde_tpu_torch.parallel.mesh import Mesh


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


def _shift(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``t`` to group rank ``to``, return what group rank ``frm``
    sent."""
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, rank, size):
        ctx.args = (group, rank, size)
        return _shift(t, group, (rank - 1) % size, (rank + 1) % size)

    @staticmethod
    def backward(ctx, ct):
        group, rank, size = ctx.args
        return _shift(ct, group, (rank + 1) % size,
                      (rank - 1) % size), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, rank, size, n, blk):
        ctx.rows = (rank * blk, t.shape[0])
        padded = t.new_zeros((blk,) + t.shape[1:])
        padded[:t.shape[0]] = t
        parts = [torch.empty_like(padded) for _ in range(size)]
        dist.all_gather(parts, padded, group=group)
        return torch.cat(parts)[:n]

    @staticmethod
    def backward(ctx, ct):
        lo, c = ctx.rows
        return ct[lo:lo + c], None, None, None, None, None


def psum_replicated(mesh: Mesh, parts: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """The sum over every rank of the mesh of its partial, replicated:
    ``parts`` holds this process's partials in ``mesh.ranks`` order."""
    if len(parts) != len(mesh.ranks):
        raise ValueError(f"psum_replicated: {len(parts)} partials for "
                         f"{len(mesh.ranks)} ranks")
    if mesh.is_group:
        return _PsumReplicated.apply(parts[0], mesh.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def enter_replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t``, a replicated input of a shard body: its gradient is summed
    over the ranks."""
    if mesh.is_group:
        return _EnterReplicated.apply(t, mesh.group)
    return t


def ring_shift(mesh: Mesh, blocks: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Each rank's block after one hop of the ring: rank r receives rank
    r + 1's (mod size). ``blocks`` in ``mesh.ranks`` order."""
    if len(blocks) != len(mesh.ranks):
        raise ValueError(f"ring_shift: {len(blocks)} blocks for "
                         f"{len(mesh.ranks)} ranks")
    if mesh.is_group:
        return [_RingShift.apply(blocks[0], mesh.group, mesh.ranks[0],
                                 mesh.size)]
    return list(blocks[1:]) + list(blocks[:1])


def gather_rows(mesh: Mesh, rows: torch.Tensor, n: int, blk: int
                ) -> torch.Tensor:
    """The whole [n, ...] array, replicated, from the rows of the ranks
    this process runs (rank r owns rows [r·blk, (r + 1)·blk), the last
    blocks short or empty): an all-gather, whose transpose hands each rank
    its rows of the cotangent."""
    if mesh.is_group:
        return _GatherRows.apply(rows, mesh.group, mesh.ranks[0], mesh.size,
                                 n, blk)
    if rows.shape[0] != n:
        raise ValueError(f"gather_rows: {rows.shape[0]} rows on a split "
                         f"mesh of {n}")
    return rows
