"""Graph container and normalisations (PyTorch port of ``ops/graph.py``).

A graph is a padded COO edge list with a validity mask, as in the JAX
package, so the two packages hold the same arrays slot for slot. Once
sorted by row (``sort_by_row``) the valid edges form the prefix
``[0, num_valid)`` and the graph also carries

* ``rowptr`` — int32[N + 1], the CSR row pointer over that prefix, which is
  what the ``csr_spmm`` kernel walks;
* ``rev``    — int32[capacity], a reverse-edge permutation: for a valid
  slot ``e`` holding (r, c), ``rev[e]`` holds (c, r). It is a bijection over
  valid slots, also when the edge multiset has duplicate multi-edges, maps
  self-loops and padding to themselves, and is ``None`` when the valid edge
  multiset is not symmetric. The SpMM's backward uses it for ``dx``.

Both are built on the host once, when the graph is prepared.

Conventions (torch_sparse.spmm semantics): ``out[row[e]] += weight[e] *
x[col[e]]``; ``row`` indexes the output node, ``col`` the gathered node.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Fixed-capacity COO graph.

    row, col : int32[E_pad] — padding slots point at node 0
    weight   : float32[E_pad] — padding slots are 0.0
    mask     : bool[E_pad] — validity of each slot
    rowptr   : int32[N + 1] or None — CSR pointer of a row-sorted graph
    rev      : int32[E_pad] or None — reverse-edge permutation (symmetric
               row-sorted graphs)
    masked   : True when ``mask`` drops edges INSIDE the row-sorted valid
               prefix (hard attention's re-masked graph, ``with_mask``);
               ``rowptr`` and ``rev`` still describe the whole prefix, so
               every per-edge value must be zeroed on the dropped slots
    """

    row: torch.Tensor
    col: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    num_nodes: int
    rows_sorted: bool = False
    rowptr: Optional[torch.Tensor] = None
    rev: Optional[torch.Tensor] = None
    sorted_valid: Optional[int] = None   # host copy of rowptr[-1]
    masked: bool = False

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    @property
    def num_valid(self) -> int:
        """Valid edge count; for a row-sorted graph, the valid prefix."""
        if self.sorted_valid is not None:
            return self.sorted_valid
        return int(self.mask.sum())

    def with_weight(self, weight: torch.Tensor) -> "Graph":
        return dataclasses.replace(self, weight=weight)

    def with_mask(self, keep: torch.Tensor) -> "Graph":
        """The same structure with only the ``keep`` edges valid (the JAX
        package's ``with_edges(row, col, weight, keep)``)."""
        return dataclasses.replace(self, mask=keep, masked=True)

    def to(self, device) -> "Graph":
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, row=mv(self.row), col=mv(self.col), weight=mv(self.weight),
            mask=mv(self.mask), rowptr=mv(self.rowptr), rev=mv(self.rev))

    def sort_by_row(self) -> "Graph":
        """Stable-reorder edges by row with padding last (as the JAX
        package does), then build ``rowptr`` and ``rev`` on the host."""
        n = self.num_nodes
        key = torch.where(self.mask, self.row, torch.full_like(self.row, n))
        order = torch.argsort(key, stable=True)
        mask = self.mask[order]
        zero = torch.zeros((), dtype=torch.int32, device=self.row.device)
        row = torch.where(mask, self.row[order], zero)
        col = torch.where(mask, self.col[order], zero)
        weight = torch.where(mask, self.weight[order],
                             torch.zeros((), dtype=self.weight.dtype,
                                         device=self.weight.device))
        counts = torch.bincount(row[mask].long(), minlength=n)
        rowptr = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
        rowptr[1:] = torch.cumsum(counts, 0)
        rev = reverse_edges(row.cpu().numpy(), col.cpu().numpy(),
                            mask.cpu().numpy())
        return Graph(row=row, col=col, weight=weight, mask=mask, num_nodes=n,
                     rows_sorted=True, rowptr=rowptr.to(torch.int32),
                     rev=None if rev is None
                     else torch.from_numpy(rev).to(row.device),
                     sorted_valid=int(rowptr[-1]))


def reverse_edges(row: np.ndarray, col: np.ndarray,
                  mask: np.ndarray) -> Optional[np.ndarray]:
    """Pair every valid slot's (row, col) edge with a slot holding (col, row)
    — ``stripe.attach_rev_slots``'s construction. Any bijection works for
    duplicate multi-edges, since the SpMM's backward only needs the
    multiset of reverse-edge weights per row. Padding and self-loops map to
    themselves. Returns None when the valid edge multiset is not symmetric.
    """
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    rev = np.arange(row.shape[0], dtype=np.int32)
    slots = np.where(np.asarray(mask, bool))[0]
    if slots.size == 0:
        return rev
    base = int(max(row[slots].max(), col[slots].max())) + 1
    fwd_key = row[slots] * base + col[slots]
    rev_key = col[slots] * base + row[slots]
    of = np.argsort(fwd_key, kind="stable")
    orv = np.argsort(rev_key, kind="stable")
    if not np.array_equal(fwd_key[of], rev_key[orv]):
        return None
    rev[slots[of]] = slots[orv].astype(np.int32)
    return rev


def make_graph(row, col, weight=None, *, num_nodes: int,
               pad_multiple: int = 1) -> Graph:
    """Build a Graph from COO arrays, padding the edge count up to a
    multiple of ``pad_multiple``. Host-side; move it with ``Graph.to``."""
    row = torch.as_tensor(np.asarray(row), dtype=torch.int32)
    col = torch.as_tensor(np.asarray(col), dtype=torch.int32)
    e = row.shape[0]
    if weight is None:
        weight = torch.ones(e, dtype=torch.float32)
    else:
        weight = torch.as_tensor(np.asarray(weight), dtype=torch.float32)
    pad = _round_up(max(e, 1), pad_multiple) - e
    return Graph(
        row=torch.cat([row, torch.zeros(pad, dtype=torch.int32)]),
        col=torch.cat([col, torch.zeros(pad, dtype=torch.int32)]),
        weight=torch.cat([weight, torch.zeros(pad, dtype=torch.float32)]),
        mask=torch.cat([torch.ones(e, dtype=torch.bool),
                        torch.zeros(pad, dtype=torch.bool)]),
        num_nodes=int(num_nodes))


def add_remaining_self_loops(g: Graph, fill_value: float) -> Graph:
    """Add a self loop to every node, keeping existing loop weights.

    PyG ``add_remaining_self_loops`` semantics, as in the JAX package:
    existing self-loop slots are masked out and all N loops are appended,
    each carrying the pre-existing loop weight or ``fill_value``.
    """
    n = g.num_nodes
    is_loop = (g.row == g.col) & g.mask
    loop_w = torch.full((n,), fill_value, dtype=g.weight.dtype)
    idx = g.row[is_loop].long()
    loop_w[idx] = g.weight[is_loop]
    keep = g.mask & ~is_loop
    ar = torch.arange(n, dtype=torch.int32)
    return Graph(
        row=torch.cat([g.row, ar]), col=torch.cat([g.col, ar]),
        weight=torch.cat([torch.where(keep, g.weight,
                                      torch.zeros_like(g.weight)), loop_w]),
        mask=torch.cat([keep, torch.ones(n, dtype=torch.bool)]),
        num_nodes=n)


def get_rw_adj(g: Graph, *, norm_dim: int = 1,
               fill_value: float = 0.0) -> Graph:
    """Random-walk normalisation: with ``norm_dim == 1`` each weight is
    divided by the weighted degree of its ``col`` node, with ``norm_dim ==
    0`` by that of its ``row`` node. ``fill_value != 0`` first adds the
    remaining self loops with that weight."""
    if fill_value != 0.0:
        g = add_remaining_self_loops(g, fill_value)
    idx = (g.row if norm_dim == 0 else g.col).long()
    w = torch.where(g.mask, g.weight, torch.zeros_like(g.weight))
    deg = torch.zeros(g.num_nodes, dtype=w.dtype).index_add(0, idx, w)
    deg_inv = torch.where(deg > 0, 1.0 / torch.where(deg > 0, deg,
                                                     torch.ones_like(deg)),
                          torch.zeros_like(deg))
    weight = torch.where(g.mask, g.weight * deg_inv[idx],
                         torch.zeros_like(g.weight))
    return g.with_weight(weight)
