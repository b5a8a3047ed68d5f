"""Per-node normalisations of per-edge values (PyTorch port of
``ops/scatter.py``) over a row-sorted graph, on the K3/K4 kernels.

A segment is a node's edges: its row (``norm_idx=0``) or its column
(``norm_idx=1``): on a symmetric edge multiset read through the reverse-edge
map ``Graph.rev`` in row order, on a directed one over the CSC view
(``colptr`` and ``col_perm``). Values are [E] or [E, H] over the graph's
padded slots;
padding slots never contribute and come out 0. Every function here is
differentiable: the gradient is K4 (``kernels.segment_norm_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_neural_pde_tpu_torch.kernels import segment_norm, segment_norm_bwd
from graph_neural_pde_tpu_torch.ops.graph import Graph


class _SegmentNorm(torch.autograd.Function):
    """out = segment_norm(s) with K4 as its backward. Residuals: out, den."""

    @staticmethod
    def forward(ctx, s, segptr, seg, perm, mode, pieces):
        out, den = segment_norm(segptr, seg, perm, s, mode, pieces)
        ctx.save_for_backward(out, den, segptr, seg, perm)
        ctx.mode, ctx.pieces = mode, pieces
        return out

    @staticmethod
    def backward(ctx, g):
        out, den, segptr, seg, perm = ctx.saved_tensors
        ds = segment_norm_bwd(segptr, seg, perm, out, g.contiguous(), den,
                              ctx.mode, ctx.pieces)
        return ds, None, None, None, None, None


def segments(g: Graph, norm_idx: int):
    """``(segptr, seg, perm)`` of K3/K4 for the rows (``norm_idx=0``) or
    columns (``1``) of a row-sorted graph: the column segments through the
    reverse edges where ``rev`` exists, over the CSC view otherwise."""
    if not g.rows_sorted or g.rowptr is None:
        raise ValueError("segment normalisation needs a row-sorted graph")
    if norm_idx == 0:
        return g.rowptr, g.row, None
    if norm_idx != 1:
        raise ValueError(f"attention_norm_idx {norm_idx} is not 0 or 1")
    if g.rev is not None:
        return g.rowptr, g.row, g.rev
    return g.colptr, g.col_by_col, g.col_perm


def segment_pieces(g: Graph, norm_idx: int):
    """The pieces K3/K4 walk ``segments(g, norm_idx)``'s segments in: the
    rows' (``Graph.row_segments``, over ``rowptr``) for the rows and for
    the columns through ``rev``, the CSC view's (``Graph.col_segments``)
    otherwise."""
    return (g.col_segments if norm_idx == 1 and g.rev is None
            else g.row_segments)


def segment_normalize(values: torch.Tensor, g: Graph, norm_idx: int,
                      mode: str) -> torch.Tensor:
    """K3 over the rows (``norm_idx=0``) or columns (``1``) of ``g``:
    ``mode`` is ``"softmax"`` or ``"normalise"`` (see
    ``kernels.segment_norm``)."""
    segptr, seg, perm = segments(g, norm_idx)
    s = values.reshape(values.shape[0], -1).float().contiguous()
    out = _SegmentNorm.apply(s, segptr, seg, perm, mode,
                             segment_pieces(g, norm_idx))
    return out.reshape(values.shape)


def _bmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def global_max(scores: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max over every valid score (all heads); 0 when there is none."""
    if mask is not None:
        scores = torch.where(_bmask(mask, scores), scores,
                             torch.full_like(scores, -torch.inf))
    # amax splits the cotangent evenly over ties, as jnp.max does
    gmax = torch.amax(scores)
    return torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))


def segment_softmax(scores: torch.Tensor, g: Graph,
                    norm_idx: int) -> torch.Tensor:
    """Per-segment softmax with the exact segment max (PyG
    ``softmax(src, index)``). On a re-masked graph the dropped edges score
    -inf: they come out 0 and take no gradient."""
    if g.masked:
        scores = torch.where(_bmask(g.mask, scores), scores,
                             torch.full_like(scores, -torch.inf))
    return segment_normalize(scores, g, norm_idx, "softmax")


def segment_squareplus(scores: torch.Tensor, g: Graph,
                       norm_idx: int) -> torch.Tensor:
    """Squareplus-normalised attention (reference utils.py:179-208):
    ``u = (s - max + sqrt((s - max)^2 + 4)) / 2`` normalised per segment.
    The max is GLOBAL over all valid edges and heads, as in the reference,
    and is differentiated through."""
    sm = scores - global_max(scores, g.mask)
    u = (sm + torch.sqrt(sm * sm + 4.0)) / 2.0
    if g.masked:
        u = torch.where(_bmask(g.mask, u), u, torch.zeros_like(u))
    return segment_normalize(u, g, norm_idx, "normalise")


def normalize_attention(att: torch.Tensor, g: Graph, norm_idx: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``att / (segment_sum(att) + 1e-16)`` with the slots outside ``mask``
    zeroed first: the renormalisation after hard-attention edge subsampling
    (reference block_transformer_hard_attention.py:43-46)."""
    if mask is not None:
        att = torch.where(_bmask(mask, att), att, torch.zeros_like(att))
    return segment_normalize(att, g, norm_idx, "normalise")
