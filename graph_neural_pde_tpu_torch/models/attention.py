"""Graph attention over padded edge arrays (PyTorch port of the
``models/attention.py`` pieces on the GRAND-l path).

Ported: the transformer attention layer's parameters (Q/K/V/Wout, weights
constant 1e-5 as in the reference), its scaled-dot scores, and the
composition branch of ``frozen_mean_attention`` — the head-mean attention
the attention block freezes once per forward, normalised over rows
(``attention_norm_idx=0``) or columns (``=1``) by softmax or squareplus.
The JAX package has no Pallas kernel for the column-normalised freeze; the
port computes it with torch ops. Other score families and GAT attention
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.layers import Linear
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.scatter import (segment_softmax,
                                                    segment_squareplus)


class TransformerAttention(nn.Module):
    """Parameters of SpGraphTransAttentionLayer: Q, K, V [in, att_dim] and
    Wout [d_k, in]. Only Q and K feed the frozen GRAND-l attention; V and
    Wout are kept so that parameters round-trip with the JAX package."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, att_dim = cfg.heads, cfg.attention_dim
        if att_dim % h:
            raise ValueError(f"Number of heads ({h}) must be a factor of the "
                             f"dimension size ({att_dim})")
        if cfg.beltrami or cfg.attention_type != "scaled_dot":
            raise NotImplementedError(
                f"attention_type {cfg.attention_type!r}"
                f"{' (beltrami)' if cfg.beltrami else ''}: ROADMAP Queue 1 "
                "slice 2 item 10 (remaining score families)")
        d_k = att_dim // h
        self.Q = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.V = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.K = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.Wout = Linear(d_k, in_dim, "const1e-5", generator=generator)


def transformer_scores(att: TransformerAttention, cfg: Config,
                       x: torch.Tensor, g: Graph,
                       edge_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Raw per-edge, per-head scaled-dot scores [E, H]: q and k are
    projected on nodes, gathered per edge and reduced per head."""
    h = cfg.heads
    d_k = cfg.attention_dim // h
    q = att.Q(x)
    k = att.K(x)
    src = q[g.row.long()].reshape(-1, h, d_k)
    dst = k[g.col.long()].reshape(-1, h, d_k)
    prods = torch.sum(src * dst, dim=-1) / math.sqrt(d_k)
    if cfg.reweight_attention and edge_weight is not None:
        prods = prods * edge_weight[:, None]
    return prods


def frozen_mean_attention(att: TransformerAttention, cfg: Config,
                          x: torch.Tensor, g: Graph,
                          edge_weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Head-MEAN normalised attention as one [E] float32 array.

    Softmax uses the exact per-segment max; squareplus uses the GLOBAL max
    over all valid scores and heads (reference utils.py:196). Padding slots
    are 0. All heads are normalised at once ([E, H]) and then averaged.
    """
    norm_index = g.row if cfg.attention_norm_idx == 0 else g.col
    prods = transformer_scores(att, cfg, x, g, edge_weight).float()
    normalise = segment_squareplus if cfg.square_plus else segment_softmax
    w = normalise(prods, norm_index, g.num_nodes, g.mask)
    return w.sum(dim=1) / prods.shape[1]
