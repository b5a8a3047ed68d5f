"""Segment (per-node) reductions over padded edge arrays (PyTorch port of
``ops/scatter.py``).

Every function takes an optional validity ``mask`` so padding slots never
contribute. ``values`` is [E] or [E, H]; the reduction is over all edges
sharing ``index[e]``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        values = torch.where(_bmask(mask, values), values,
                             torch.zeros_like(values))
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, index.long(), values)


def segment_max(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment max; empty segments are -inf."""
    if mask is not None:
        values = torch.where(_bmask(mask, values), values,
                             torch.full_like(values, -torch.inf))
    out = torch.full((num_segments,) + values.shape[1:], -torch.inf,
                     dtype=values.dtype, device=values.device)
    idx = index.long().reshape(index.shape + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=True)


def segment_softmax(scores: torch.Tensor, index: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable per-segment softmax (PyG ``softmax(src, index)``);
    padding slots get probability 0."""
    if mask is not None:
        scores = torch.where(_bmask(mask, scores), scores,
                             torch.full_like(scores, -torch.inf))
    smax = segment_max(scores, index, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - smax[index.long()])
    if mask is not None:
        ex = torch.where(_bmask(mask, ex), ex, torch.zeros_like(ex))
    denom = segment_sum(ex, index, num_segments)
    return ex / (denom[index.long()] + 1e-16)


def segment_squareplus(scores: torch.Tensor, index: torch.Tensor,
                       num_segments: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squareplus-normalised attention (reference utils.py:179-208):
    ``u = (s - max + sqrt((s - max)^2 + 4)) / 2`` normalised per segment.
    The max is GLOBAL over all valid edges and heads, as in the reference."""
    gmax = global_max(scores, mask)
    out = scores - gmax
    out = (out + torch.sqrt(out * out + 4.0)) / 2.0
    if mask is not None:
        out = torch.where(_bmask(mask, out), out, torch.zeros_like(out))
    denom = segment_sum(out, index, num_segments)
    return out / (denom[index.long()] + 1e-16)


def global_max(scores: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max over every valid score (all heads); 0 when there is none."""
    if mask is not None:
        scores = torch.where(_bmask(mask, scores), scores,
                             torch.full_like(scores, -torch.inf))
    gmax = torch.max(scores)
    return torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
