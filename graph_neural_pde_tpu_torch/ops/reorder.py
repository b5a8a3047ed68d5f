"""Node-reordering passes that lay block locality out for the blocked SpMM
(PyTorch port of ``ops/reorder.py``).

The blocked engine (``kernels.blocked`` over ``ops.plan``) tiles nodes into
blocks of ``block_n`` and buckets edges by (row block, column block); its
work grows with the padded chunk count, so it pays only where edges
concentrate in few buckets. A community-structured graph shows that
structure only after a bandwidth-reducing relabelling: under an arbitrary
labelling a community's edges spray across all block pairs.

The relabelling is computed on the host once (numpy) and applied at the
dataset level, permuting features, labels and masks together with the
graph, so the model's semantics are untouched: node classification is
invariant under a consistent relabelling.

Orders (``order[new_id] = old_id``, scipy's convention):

* ``rcm`` — reverse Cuthill-McKee: BFS from a minimum-degree seed, visiting
  neighbours in increasing-degree order, reversed. Fast path: scipy's
  ``reverse_cuthill_mckee``; :func:`_rcm_numpy` is the fallback and the
  test oracle.
* ``degree`` — descending degree: hubs in the leading blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graph_neural_pde_tpu_torch.ops.graph import Graph


def _symmetric_csr(row, col, num_nodes: int):
    """Undirected CSR (both edge directions kept; duplicates are harmless
    for BFS). Returns (indptr int64[N+1], indices int64[sum deg])."""
    r = np.concatenate([row, col]).astype(np.int64)
    c = np.concatenate([col, row]).astype(np.int64)
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=num_nodes))
    return indptr, c


def _rcm_numpy(indptr, indices, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee as a numpy BFS; every component is seeded at
    its minimum-degree unvisited node."""
    deg = np.diff(indptr)
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        visited[s] = True
        order[pos] = s
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nb = indices[indptr[u]:indptr[u + 1]]
            nb = np.unique(nb[~visited[nb]])       # dedupe multi-edges
            if nb.size:
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                order[pos:pos + nb.size] = nb
                pos += nb.size
    return order[::-1].copy()


def rcm_order(row, col, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node order; order[new_id] = old_id."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        indptr, idx = _symmetric_csr(row, col, num_nodes)
        return _rcm_numpy(indptr, idx, num_nodes)
    r = np.concatenate([row, col])
    c = np.concatenate([col, row])
    m = csr_matrix((np.ones(r.shape[0], np.float32), (r, c)),
                   shape=(num_nodes, num_nodes))
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      np.int64)


def degree_order(row, col, num_nodes: int) -> np.ndarray:
    """Descending-degree node order; order[new_id] = old_id."""
    indptr, _ = _symmetric_csr(np.asarray(row, np.int64),
                               np.asarray(col, np.int64), num_nodes)
    return np.argsort(-np.diff(indptr), kind="stable").astype(np.int64)


def node_order(method: str, row, col, num_nodes: int) -> np.ndarray:
    if method == "rcm":
        return rcm_order(row, col, num_nodes)
    if method == "degree":
        return degree_order(row, col, num_nodes)
    raise ValueError(f"unknown node_reorder '{method}' "
                     "(expected 'none', 'rcm' or 'degree')")


def invert_order(order: np.ndarray) -> np.ndarray:
    """new_of_old[old_id] = new_id."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    return inv


def relabel_graph(g: Graph, order: np.ndarray) -> Graph:
    """Relabel node ids through ``order``. Edge slots stay in place; only
    their endpoints change, so the graph is no longer row-sorted."""
    new_of_old = torch.from_numpy(invert_order(np.asarray(order, np.int64)))
    zero = torch.zeros((), dtype=torch.int32)

    def relabel(ids):
        return torch.where(g.mask, new_of_old[ids.long()].to(torch.int32),
                           zero)

    return Graph(row=relabel(g.row), col=relabel(g.col), weight=g.weight,
                 mask=g.mask, num_nodes=g.num_nodes)


def reorder_dataset(ds, method: str):
    """Apply a node order to a NodeDataset; returns (dataset, order). x, y
    and the masks are permuted with the relabelled graph, and the order is
    kept as ``ds.reorder`` for node payloads indexed from outside."""
    g = ds.graph
    if g.num_nodes != ds.y.shape[0]:
        raise ValueError(f"reorder_dataset: graph of {g.num_nodes} nodes, "
                         f"{ds.y.shape[0]} labels")
    m = g.mask.numpy()
    order = node_order(method, g.row.numpy()[m], g.col.numpy()[m],
                       g.num_nodes)
    idx = torch.from_numpy(order)
    d2 = dataclasses.replace(
        ds, graph=relabel_graph(g, order), x=ds.x[idx], y=ds.y[idx],
        train_mask=ds.train_mask[idx], val_mask=ds.val_mask[idx],
        test_mask=ds.test_mask[idx], reorder=order)
    return d2, order


def plan_occupancy(plan) -> dict:
    """Block-plan fill statistics: the quantity a reorder improves."""
    valid = int(np.asarray(plan.valid).sum())
    buckets = np.unique(
        np.asarray(plan.chunk_rows, np.int64) * (2 ** 32)
        + np.asarray(plan.chunk_cols, np.int64)).shape[0]
    return {
        "capacity": int(plan.capacity),
        "valid_edges": valid,
        "fill": valid / max(plan.capacity, 1),
        "n_chunks": int(plan.n_chunks),
        "buckets": int(buckets),
    }


def bandwidth(row, col, order: Optional[np.ndarray] = None) -> int:
    """Max |row - col| under an optional relabelling: RCM's objective."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    if order is not None:
        inv = invert_order(np.asarray(order, np.int64))
        row, col = inv[row], inv[col]
    return int(np.abs(row - col).max()) if row.size else 0
