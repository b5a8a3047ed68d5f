"""Sparse adjacency x dense feature products (PyTorch port of ``ops/spmm.py``).

``out[row[e]] += weight[e] * x[col[e]]`` over valid edges — the hottest op
of the framework, run once per ODE right-hand-side evaluation.

* :func:`spmm` is the plain version: the ``csr_spmm`` kernel's plain
  PyTorch version (gather + ``index_add``), differentiated by autograd.
* :func:`make_spmm` returns the engine the models run: a
  ``torch.autograd.Function`` whose forward and backward are the
  hand-written kernels (``kernels.csr_spmm``, ``kernels.edge_dot``), with
  the whole-matvec symmetric VJP of the JAX package's
  ``_make_stripe_spmm_sym`` on a symmetric edge multiset and, on a directed
  one, dx = A^T ct as ``csr_spmm`` walked over the CSC view (the JAX
  package's stripe scatter over its column plan).
  With ``payload_dtype=torch.bfloat16`` (the JAX package's
  ``rhs_payload_dtype="bfloat16"``, ``make_stripe_spmm(g, plan,
  payload_dtype)``) each matvec reads the x table in bfloat16 and its dx
  the cotangent in bfloat16, both with float32 weights and sums.
* :func:`spmm_multihead` and :func:`spmm_mean_heads` are the per-head and
  head-mean aggregations of ``mix_features``, on the same engine.
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


def transpose_matvec(g: Graph, w: torch.Tensor,
                     ct: torch.Tensor) -> torch.Tensor:
    """``A_w^T ct``: ``out[n] = sum_{e: col[e]=n} w[e] ct[row[e]]``, one
    ``csr_spmm`` launch. On a symmetric edge multiset it is a forward matvec
    with the weights permuted to the reverse edges,

        sum_{e: col[e]=n} w[e] ct[row[e]] = sum_{e': row[e']=n} w[rev(e')] ct[col[e']],

    so the row walk serves; on a directed one the kernel walks the CSC view
    (``colptr``, gathering ``ct[row_by_col]`` with the weights ``w[col_perm]``).
    The weights are asymmetric (column normalisation, attention), which is
    why both routes permute them. ``w`` must be 0 on dropped slots."""
    if g.rev is not None:
        return csr_spmm(g.rowptr, g.row, g.col, w[g.rev.long()], ct,
                        n_edges=g.num_valid)
    return csr_spmm(g.colptr, g.col_by_col, g.row_by_col,
                    w[g.col_perm.long()], ct, n_edges=g.num_valid)


class _Spmm(torch.autograd.Function):
    """out = A_w x on a row-sorted graph: the forward is ``csr_spmm``; the
    backward ``dx = A_w^T ct`` is one more ``csr_spmm`` launch
    (:func:`transpose_matvec`), and ``dw[e] = ct[row[e]] . x[col[e]]`` one
    ``edge_dot`` launch, zero on padding slots. Residuals are the inputs
    (x, w) only.

    With a ``payload`` dtype the gathered tables are cast to it once a
    matvec, as the JAX package's ``_make_stripe_spmm_sym`` gathers
    ``x.astype(payload)[col]`` and ``ct.astype(payload)[col]``: the
    forward reads x in it, dx the cotangent, dw x again (beside the float32
    ``ct[row]``). Weights, sums and the output stay float32, and dx comes
    back in x's dtype."""

    @staticmethod
    def forward(ctx, x, w, g, n_valid, payload):
        ctx.save_for_backward(x, w)
        ctx.g, ctx.n_valid, ctx.payload = g, n_valid, payload
        return csr_spmm(g.rowptr, g.row, g.col, w, _cast(x, payload),
                        n_edges=n_valid)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        g, payload = ctx.g, ctx.payload
        ct = ct.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = transpose_matvec(g, w, _cast(ct, payload)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = edge_dot(g.row, g.col, ct, _cast(x, payload), ctx.n_valid)
        return dx, dw, None, None, None


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).contiguous()


def make_spmm(g: Graph, payload_dtype: torch.dtype = None):
    """``spmm_fn(x, w)`` over a prepared graph, directed or not, running
    the CUDA kernels on CUDA tensors (their plain versions on CPU tensors),
    differentiable in both x and w. Valid edges must be the row-sorted
    prefix that ``Graph.sort_by_row`` leaves; padding weights are never
    read. ``payload_dtype`` (None or ``torch.bfloat16``) is the dtype the
    x and cotangent tables are read in (see ``_Spmm``); x itself may be
    float32 or bfloat16, and the output is float32."""
    _check_sorted(g)
    n_valid = g.num_valid

    def spmm_fn(x, w):
        return _Spmm.apply(x.contiguous(), w.contiguous(), g, n_valid,
                           payload_dtype)

    return spmm_fn


def spmm_multihead(g: Graph, att: torch.Tensor, v: torch.Tensor,
                   spmm_fn=None) -> torch.Tensor:
    """Per-head spmm: att [E, H], v [N, H, Dk] -> [N, H, Dk], one
    ``spmm_fn`` (K1, its gradient K1/K2) per head: each output element is
    summed in edge order, so two calls agree bit for bit (the JAX package
    takes one XLA ``segment_sum`` over [E, H, Dk])."""
    if spmm_fn is None:
        spmm_fn = make_spmm(g)
    att = torch.where(g.mask[:, None], att, torch.zeros_like(att))
    return torch.stack([spmm_fn(v[:, h, :], att[:, h])
                        for h in range(att.shape[1])], dim=1)


def spmm_mean_heads(g: Graph, att: torch.Tensor, x: torch.Tensor,
                    spmm_fn=None) -> torch.Tensor:
    """spmm with the head mean of att [E, H] as edge weights: [N, D]."""
    if spmm_fn is None:
        spmm_fn = make_spmm(g)
    return spmm_fn(x, torch.mean(att, dim=1))
