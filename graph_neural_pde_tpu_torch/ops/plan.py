"""Blocked-bucket edge plan: the layout the blocked SpMM runs on (numpy
port of ``ops/pallas/plan.py``).

Nodes are tiled into blocks of ``block_n`` and edges bucketed by (row
block, column block):

* edges sorted stably by (row block, column block), each bucket padded to
  a multiple of ``chunk`` slots; padding slots carry row_local = col_local
  = 0, weight 0 and valid False;
* per chunk c: chunk_rows[c] is its row block, chunk_cols[c] its column
  block;
* the chunks of one row block are contiguous, and every row block owns at
  least one chunk.

The plan is built once per graph on the host. For the same ``(row, col,
weight, num_nodes, block_n, chunk)`` its arrays equal the JAX package's
slot for slot; unlike it, ``chunk`` is taken as given (no rounding up to
a multiple of 1024, which only the TPU's compiler needs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BlockPlan:
    """Host-built edge plan (numpy arrays and statics)."""

    # per padded edge slot (length capacity)
    row_local: np.ndarray    # int32, row id within its row block
    col_local: np.ndarray    # int32, col id within its col block
    weight: np.ndarray       # float32 (0 on padding)
    valid: np.ndarray        # bool
    row: np.ndarray          # int32 global row id (0 on padding)
    col: np.ndarray          # int32 global col id (0 on padding)
    # per chunk (length n_chunks)
    chunk_rows: np.ndarray   # int32 row block id
    chunk_cols: np.ndarray   # int32 col block id
    block_n: int
    chunk: int
    num_nodes: int           # padded node count (a multiple of block_n)

    @property
    def n_chunks(self) -> int:
        return self.chunk_rows.shape[0]

    @property
    def capacity(self) -> int:
        return self.row_local.shape[0]


def _build(row, col, weight, tags, num_nodes, block_n, chunk):
    """Bucket, sort and pad. ``tags`` (an int64 payload per edge) rides
    along the sort; returns (plan, tags_out), tags_out = -1 on padding."""
    n_pad = _ceil_to(max(num_nodes, 1), block_n)
    nblocks = n_pad // block_n
    rb = row // block_n
    cb = col // block_n
    order = np.lexsort((cb, rb))
    row, col, weight, rb, cb, tags = (a[order] for a in
                                      (row, col, weight, rb, cb, tags))

    # bucket boundaries over the sorted edges
    key = rb * nblocks + cb
    uniq, starts, counts = np.unique(key, return_index=True,
                                     return_counts=True)
    buckets_of_rb = {}
    for k, s, c in zip(uniq, starts, counts):
        buckets_of_rb.setdefault(int(k) // nblocks, []).append(
            (int(k) % nblocks, int(s), int(c)))

    # every row block owns at least one chunk, so that every output block
    # is written
    chunks = []           # (row block, col block, source start, n valid)
    for rbi in range(nblocks):
        for cbi, s, c in buckets_of_rb.get(rbi, [(0, 0, 0)]):
            for j in range(max(chunk, _ceil_to(c, chunk)) // chunk):
                chunks.append((rbi, cbi, s + j * chunk,
                               min(max(c - j * chunk, 0), chunk)))

    n_chunks = len(chunks)
    total = n_chunks * chunk
    row_l = np.zeros(total, np.int32)
    col_l = np.zeros(total, np.int32)
    w_out = np.zeros(total, np.float32)
    valid = np.zeros(total, bool)
    row_g = np.zeros(total, np.int32)
    col_g = np.zeros(total, np.int32)
    tags_out = np.full(total, -1, np.int64)
    chunk_rows = np.zeros(n_chunks, np.int32)
    chunk_cols = np.zeros(n_chunks, np.int32)
    for ci, (rbi, cbi, lo, nv) in enumerate(chunks):
        chunk_rows[ci] = rbi
        chunk_cols[ci] = cbi
        if nv == 0:
            continue
        dst = slice(ci * chunk, ci * chunk + nv)
        src = slice(lo, lo + nv)
        row_l[dst] = row[src] - rbi * block_n
        col_l[dst] = col[src] - cbi * block_n
        w_out[dst] = weight[src]
        valid[dst] = True
        row_g[dst] = row[src]
        col_g[dst] = col[src]
        tags_out[dst] = tags[src]

    plan = BlockPlan(row_local=row_l, col_local=col_l, weight=w_out,
                     valid=valid, row=row_g, col=col_g,
                     chunk_rows=chunk_rows, chunk_cols=chunk_cols,
                     block_n=block_n, chunk=chunk, num_nodes=n_pad)
    return plan, tags_out


def build_block_plan(row, col, weight=None, mask=None, *, num_nodes: int,
                     block_n: int = 1024, chunk: int = 1024,
                     return_tags: bool = False):
    """Bucket, sort and pad the edge list. With ``return_tags`` also
    returns, per plan slot, the index of its edge among the kept input
    edges (-1 on padding)."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    weight = (np.ones(row.shape[0], np.float32) if weight is None
              else np.asarray(weight, np.float32))
    if mask is not None:
        keep = np.asarray(mask, bool)
        row, col, weight = row[keep], col[keep], weight[keep]
    plan, tags = _build(row, col, weight, np.arange(row.shape[0]),
                        num_nodes, block_n, chunk)
    return (plan, tags) if return_tags else plan


def transpose_plan(plan: BlockPlan):
    """Plan of the transposed graph plus the slot permutation.

    Returns (plan_t, t_perm, t_valid): transposed slot i holds forward slot
    t_perm[i] (0, with t_valid[i] False, on padding). The SpMM's backward
    dx = Aᵀ·ct takes the forward weights in transposed order,
    w_t = where(t_valid, w[t_perm], 0).
    """
    keep = plan.valid
    slots = np.where(keep)[0].astype(np.int64)
    plan_t, tags = _build(plan.col[keep].astype(np.int64),
                          plan.row[keep].astype(np.int64),
                          plan.weight[keep], slots, plan.num_nodes,
                          plan.block_n, plan.chunk)
    t_valid = tags >= 0
    t_perm = np.where(t_valid, tags, 0).astype(np.int32)
    return plan_t, t_perm, t_valid
