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
* the CSC view, for every row-sorted graph, directed or not: ``colptr``
  int32[N + 1], the column pointer over the valid prefix; ``col_perm``
  int32[capacity], the row-sorted slots in column order (stable, so each
  column's edges keep their row order; padding maps to itself), and the
  endpoints read in that order, ``row_by_col = row[col_perm]`` and
  ``col_by_col = col[col_perm]``. A column-side pass (dx = A^T ct, the
  column softmax, the sum of a per-edge array over columns) walks
  ``colptr`` as a row pass walks ``rowptr``. It is the port of the JAX
  package's column plan (``stripe.attach_col_plan``).
* ``col_pieces`` — the CSC view's columns cut into pieces of at most
  ``COL_PIECE`` edges (:class:`ColPieces`), which the column walk of the
  fused RHS's backward (K17) spreads over warps, so that a hub column
  costs no more than ``COL_PIECE`` edges in series.
* ``row_pieces`` — the CSR rows cut the same way (``column_pieces`` of
  ``rowptr``), which the fused RHS's row walks (K6, K9, K13, K14) spread
  over warps. On a symmetric edge multiset ``colptr`` is ``rowptr`` and
  the two are equal; on a directed graph they differ.
* ``scatter_pieces`` — the CSR rows longer than ``SCATTER_WHOLE`` edges
  cut into pieces of ``COL_PIECE``, the rest whole, which K10
  ``dual_scatter`` walks: its partial rows are H * D floats, so only rows
  longer than that are cut.
* ``row_segments`` / ``col_segments`` — the rows' and the CSC view's
  pieces that K3 / K4 (``segment_norm``) walk: ``row_pieces`` /
  ``col_pieces``, or pieces of ``SEGMENT_LONG_PIECE`` where the mean
  segment is longer than ``COL_PIECE`` (:func:`segment_piece`).

All of it is built on the host once, when the graph is prepared.

Conventions (torch_sparse.spmm semantics): ``out[row[e]] += weight[e] *
x[col[e]]``; ``row`` indexes the output node, ``col`` the gathered node.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


# edges of a column piece in K17's walk and of a row piece in the row walks:
# 32 measured faster than 64 on a kNN graph's hub columns and no slower
# elsewhere (PERF.md, section 6)
COL_PIECE = 32
# K10's walk takes rows of up to these edges whole and cuts longer ones
# into pieces of COL_PIECE: on the GDC-rewired Cora stand-in (rows of 64
# edges on average) whole rows took 0.0425 ms against 0.0508 in pieces of
# 32, while a hub row of 360 edges took 0.0891 whole, 0.0348 in pieces of
# 128 and 0.0131 in pieces of 32 (PERF.md, section 6)
SCATTER_WHOLE = 128
# K3 / K4's pieces where the mean segment is longer than COL_PIECE: on the
# GDC-rewired Cora stand-in (columns of 64 edges) pieces of 64 took 0.0091
# ms against 0.0211 in pieces of 32, every segment of two pieces merged by
# a second pass; on graphs of shorter segments they were slower (PERF.md,
# section 6)
SEGMENT_LONG_PIECE = 64


def segment_piece(n_edges: int, n_segments: int) -> int:
    """The members of a piece of K3 / K4's walk over ``n_segments``
    segments of ``n_edges`` members: ``COL_PIECE``, or
    ``SEGMENT_LONG_PIECE`` where the mean segment is longer."""
    return (SEGMENT_LONG_PIECE if n_edges > COL_PIECE * max(n_segments, 1)
            else COL_PIECE)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ColPieces:
    """The CSC view's columns cut into pieces of at most ``piece`` edges,
    in column order (see :func:`column_pieces`).

    ptr   : int32[P + 1] — piece p holds the CSC edges [ptr[p], ptr[p + 1])
    col   : int32[P] — its column (every column owns at least one piece)
    slot  : int32[P] — its row of partial sums when its column has several
            pieces (those rows are numbered in piece order), else -1
    multi_col : int32[M] — the columns of several pieces, in order
    multi_ptr : int32[M + 1] — column ``multi_col[m]``'s partial rows are
                [multi_ptr[m], multi_ptr[m + 1])
    multi_piece : int32[multi_ptr[M]] — the piece of each partial row
    and host ints: the piece length, P, M, the partial rows (multi_ptr[M]),
    the longest column's edge count and the edges (colptr[N])."""

    ptr: torch.Tensor
    col: torch.Tensor
    slot: torch.Tensor
    multi_col: torch.Tensor
    multi_ptr: torch.Tensor
    multi_piece: torch.Tensor
    piece: int
    n_multi: int
    n_slots: int
    longest: int
    n_edges: int

    @property
    def n_pieces(self) -> int:
        return self.col.shape[0]

    def to(self, device) -> "ColPieces":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def column_pieces(colptr, piece: int = COL_PIECE, device=None,
                  whole: int = 0) -> ColPieces:
    """Cut every column of a CSC view (``colptr`` [N + 1], numpy or a
    tensor) into pieces of at most ``piece`` edges: column n of degree d
    gets max(1, ceil(d / piece)) pieces (one where d <= ``whole``), in
    column order, so the pieces cover the edges [0, colptr[N]) once and in
    order. Host-built, on ``device`` (colptr's by default)."""
    if piece < 1:
        raise ValueError(f"column_pieces: piece {piece} < 1")
    if device is None:
        device = colptr.device if torch.is_tensor(colptr) else "cpu"
    if torch.is_tensor(colptr):
        colptr = colptr.cpu().numpy()
    colptr = np.asarray(colptr, np.int64)
    deg = np.diff(colptr)
    count = np.where(deg <= whole, 1, np.maximum(1, -(-deg // piece)))
    first = np.cumsum(count) - count                   # a column's 1st piece
    col = np.repeat(np.arange(deg.shape[0]), count)
    j = np.arange(col.shape[0]) - first[col]           # index in its column
    ptr = np.append(colptr[col] + j * piece, colptr[-1])
    multi = count > 1
    slot = np.full(col.shape[0], -1, np.int64)
    slot[multi[col]] = np.arange(int(count[multi].sum()))
    multi_ptr = np.append(0, np.cumsum(count[multi]))

    def dev(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return ColPieces(ptr=dev(ptr), col=dev(col), slot=dev(slot),
                     multi_col=dev(np.nonzero(multi)[0]),
                     multi_ptr=dev(multi_ptr),
                     multi_piece=dev(np.nonzero(slot >= 0)[0]), piece=piece,
                     n_multi=int(multi.sum()), n_slots=int(multi_ptr[-1]),
                     longest=int(deg.max(initial=0)),
                     n_edges=int(colptr[-1]))


@dataclasses.dataclass(frozen=True)
class Graph:
    """Fixed-capacity COO graph.

    row, col : int32[E_pad] — padding slots point at node 0
    weight   : float32[E_pad] — padding slots are 0.0
    mask     : bool[E_pad] — validity of each slot
    rowptr   : int32[N + 1] or None — CSR pointer of a row-sorted graph
    rev      : int32[E_pad] or None — reverse-edge permutation (symmetric
               row-sorted graphs)
    colptr, col_perm, row_by_col, col_by_col : the CSC view (row-sorted
               graphs; see the module docstring)
    col_pieces : the CSC view's column pieces (:class:`ColPieces`)
    row_pieces : the CSR rows' pieces (:class:`ColPieces` of ``rowptr``)
    scatter_pieces : the same, rows of up to ``SCATTER_WHOLE`` edges whole
    row_segments, col_segments : K3 / K4's pieces of the rows and of the
               CSC view (``row_pieces`` / ``col_pieces`` or pieces of
               ``segment_piece``'s length)
    masked   : True when ``mask`` drops edges INSIDE the row-sorted valid
               prefix (hard attention's re-masked graph, ``with_mask``);
               ``rowptr``, ``rev`` and the CSC view still describe the
               whole prefix, so every per-edge value must be zeroed on the
               dropped slots before it is read through them
    """

    row: torch.Tensor
    col: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    num_nodes: int
    rows_sorted: bool = False
    rowptr: Optional[torch.Tensor] = None
    rev: Optional[torch.Tensor] = None
    colptr: Optional[torch.Tensor] = None
    col_perm: Optional[torch.Tensor] = None
    row_by_col: Optional[torch.Tensor] = None
    col_by_col: Optional[torch.Tensor] = None
    col_pieces: Optional[ColPieces] = None
    row_pieces: Optional[ColPieces] = None
    scatter_pieces: Optional[ColPieces] = None
    row_segments: Optional[ColPieces] = None
    col_segments: Optional[ColPieces] = None
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
        """Every tensor field (and the column and row pieces) moved to
        ``device``: the fields are read off the dataclass, so none can be
        left behind."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, ColPieces))})

    def sort_by_row(self) -> "Graph":
        """Stable-reorder edges by row with padding last (as the JAX
        package does), then build ``rowptr``, ``rev``, the CSC view with
        its column pieces and the rows' pieces on the host."""
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
        row_np, col_np = row.cpu().numpy(), col.cpu().numpy()
        rev = reverse_edges(row_np, col_np, mask.cpu().numpy())
        nv = int(rowptr[-1])
        colptr, col_perm = column_order(col_np, nv, n)

        def dev(a):
            return torch.from_numpy(a).to(row.device)

        col_pieces = column_pieces(colptr, device=row.device)
        row_pieces = column_pieces(rowptr, device=row.device)
        seg = segment_piece(nv, n)
        if seg != COL_PIECE:
            row_segments = column_pieces(rowptr, seg, device=row.device)
            col_segments = column_pieces(colptr, seg, device=row.device)
        else:
            row_segments, col_segments = row_pieces, col_pieces
        return Graph(row=row, col=col, weight=weight, mask=mask, num_nodes=n,
                     rows_sorted=True, rowptr=rowptr.to(torch.int32),
                     rev=None if rev is None else dev(rev),
                     colptr=dev(colptr), col_perm=dev(col_perm),
                     row_by_col=dev(row_np[col_perm]),
                     col_by_col=dev(col_np[col_perm]),
                     col_pieces=col_pieces, row_pieces=row_pieces,
                     scatter_pieces=column_pieces(rowptr, device=row.device,
                                                  whole=SCATTER_WHOLE),
                     row_segments=row_segments, col_segments=col_segments,
                     sorted_valid=nv)


def column_order(col: np.ndarray, n_valid: int, num_nodes: int):
    """The CSC view of a row-sorted edge list whose valid edges are the
    prefix ``[0, n_valid)``: ``(colptr int32[N + 1], col_perm
    int32[capacity])``. ``col_perm`` lists the valid slots sorted by column,
    stably (each column keeps its edges' row order, as
    ``stripe.attach_col_plan`` orders them), then the padding slots, each
    mapped to itself."""
    col = np.asarray(col)
    order = np.argsort(col[:n_valid], kind="stable")
    col_perm = np.arange(col.shape[0], dtype=np.int32)
    col_perm[:n_valid] = order
    colptr = np.zeros(num_nodes + 1, np.int64)
    colptr[1:] = np.cumsum(np.bincount(col[:n_valid].astype(np.int64),
                                       minlength=num_nodes))
    return colptr.astype(np.int32), col_perm


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


def pad_capacity(g: Graph, multiple: int) -> Graph:
    """Grow the padded edge arrays so that ``capacity % multiple == 0``,
    with invalid slots appended at the tail (the JAX package's
    ``pad_capacity``). As there, ``rows_sorted`` is dropped, and with it
    ``rowptr``, ``rev`` and the CSC view, which describe the old capacity:
    ``sort_by_row`` (``prepare_graph``) rebuilds them."""
    cap = g.capacity
    new = _round_up(cap, multiple)
    if new == cap:
        return g
    pad = new - cap
    dev = g.row.device

    def grow(t, fill):
        return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                        device=dev)])

    return Graph(row=grow(g.row, 0), col=grow(g.col, 0),
                 weight=grow(g.weight, 0.0), mask=grow(g.mask, False),
                 num_nodes=g.num_nodes)


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


def dense_adjacency(g: Graph, device=None) -> torch.Tensor:
    """[N, N] float32 matrix with ``A[row, col] = weight`` summed over the
    valid edges (duplicate edges add up), on ``device`` (the graph's by
    default)."""
    device = g.row.device if device is None else torch.device(device)
    n = g.num_nodes
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    w = torch.where(g.mask, g.weight, torch.zeros_like(g.weight))
    a.index_put_((g.row.long().to(device), g.col.long().to(device)),
                 w.to(device=device, dtype=torch.float32), accumulate=True)
    return a
