"""Sparse adjacency x dense feature products (PyTorch port of ``ops/spmm.py``).

``out[row[e]] += weight[e] * x[col[e]]`` over valid edges — the hottest op
of the framework, run once per ODE right-hand-side evaluation.

* :func:`spmm` is the plain version: the ``csr_spmm`` kernel's plain
  PyTorch version (gather + ``index_add``), differentiated by autograd.
* :func:`make_spmm` returns the engine the models run: a
  ``torch.autograd.Function`` whose forward and backward are the
  hand-written kernels (``kernels.csr_spmm``, ``kernels.edge_dot``), with
  the whole-matvec symmetric VJP of the JAX package's
  ``_make_stripe_spmm_sym``.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import csr_spmm, edge_dot
from graph_neural_pde_tpu_torch.kernels.csr_spmm import csr_spmm_plain
from graph_neural_pde_tpu_torch.ops.graph import Graph


def spmm(g: Graph, x: torch.Tensor, weight: torch.Tensor = None
         ) -> torch.Tensor:
    """A @ x with A given by a row-sorted graph (``weight`` overrides its
    weights); padding slots are never read."""
    _check_sorted(g)
    w = g.weight if weight is None else weight
    return csr_spmm_plain(g.rowptr, g.row, g.col, w, x)


def _check_sorted(g: Graph):
    if not g.rows_sorted or g.rowptr is None:
        raise ValueError("spmm needs a row-sorted graph (sort_by_row)")


class _SymSpmm(torch.autograd.Function):
    """out = A_w x on a symmetric row-sorted graph.

    For an undirected edge multiset the transpose matvec is a forward
    matvec with the weights permuted to the reverse edges:

        dx[n] = sum_{e: col[e]=n} w[e] ct[row[e]]
              = sum_{e': row[e']=n} w[rev(e')] ct[col[e']]

    so ``dx`` is one more ``csr_spmm`` launch, and ``dw[e] = ct[row[e]] .
    x[col[e]]`` is one ``edge_dot`` launch, zero on padding slots. The
    weights are asymmetric (w[e] != w[rev(e)]: column normalisation and
    attention), which is why ``dx`` must use ``w[rev]``. Residuals are the
    inputs (x, w) only.
    """

    @staticmethod
    def forward(ctx, x, w, rowptr, row, col, rev, n_valid):
        ctx.save_for_backward(x, w, rowptr, row, col, rev)
        ctx.n_valid = n_valid
        return csr_spmm(rowptr, row, col, w, x)

    @staticmethod
    def backward(ctx, ct):
        x, w, rowptr, row, col, rev = ctx.saved_tensors
        ct = ct.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = csr_spmm(rowptr, row, col, w[rev.long()], ct)
        if ctx.needs_input_grad[1]:
            dw = edge_dot(row, col, ct, x, ctx.n_valid)
        return dx, dw, None, None, None, None, None


def make_spmm(g: Graph):
    """``spmm_fn(x, w)`` over a prepared graph, running the CUDA kernels on
    CUDA tensors (their plain versions on CPU tensors), differentiable in
    both x and w. Valid edges must be the row-sorted prefix that
    ``Graph.sort_by_row`` leaves; padding weights are never read."""
    _check_sorted(g)
    if g.rev is None:
        raise NotImplementedError(
            "make_spmm: directed (non-symmetric) edge multisets need the "
            "column-side transpose kernel, ROADMAP Queue 2 K5 "
            "(make_col_gather)")
    n_valid = g.num_valid

    def spmm_fn(x, w):
        return _SymSpmm.apply(x.contiguous(), w.contiguous(), g.rowptr,
                              g.row, g.col, g.rev, n_valid)

    return spmm_fn
