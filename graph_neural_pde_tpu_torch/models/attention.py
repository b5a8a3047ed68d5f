"""Graph attention over padded edge arrays (PyTorch port of the
``models/attention.py`` pieces on the GRAND-l path and on GRAND-nl's
composition branch; the scores themselves are ``kernels.fused_rhs.
edge_scores``, shared with the fused RHS's plain versions).

Ported: the transformer attention layer's parameters (Q/K/V/Wout, weights
constant 1e-5 as in the reference, and ``output_var``/``lengthscale`` for
``exp_kernel``), its four score families (scaled_dot, cosine_sim, pearson,
exp_kernel), ``apply_transformer_attention`` (per-head normalised attention
[E, H]) and the composition branch of ``frozen_mean_attention`` — its head
mean, which the attention block freezes once per forward. Normalisation is
over rows (``attention_norm_idx=0``) or columns (``=1``), by softmax or
squareplus, on the K3/K4 kernels (``ops.scatter``). ``GATAttention`` and
``apply_gat_attention`` are the GAT function's layer (W, Wout, a; LeakyReLU
scores, always softmax). The Beltrami split-space scores raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels.fused_rhs import edge_scores
from graph_neural_pde_tpu_torch.models.layers import Linear
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.scatter import (segment_softmax,
                                                    segment_squareplus)

ATTENTION_TYPES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")


class TransformerAttention(nn.Module):
    """Parameters of SpGraphTransAttentionLayer: Q, K, V [in, att_dim],
    Wout [d_k, in], and the exp_kernel's ``output_var`` and ``lengthscale``
    (one element each). Only Q, K and the exp_kernel scalars feed the
    GRAND-l attention; V and Wout are kept so that parameters round-trip
    with the JAX package."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, att_dim = cfg.heads, cfg.attention_dim
        if att_dim % h:
            raise ValueError(f"Number of heads ({h}) must be a factor of the "
                             f"dimension size ({att_dim})")
        if cfg.beltrami:
            raise NotImplementedError(
                "beltrami attention: ROADMAP Queue 1 slice 4 item 15")
        if cfg.attention_type not in ATTENTION_TYPES:
            raise ValueError(
                f"unknown attention_type '{cfg.attention_type}'")
        d_k = att_dim // h
        if cfg.attention_type == "exp_kernel":
            self.output_var = nn.Parameter(torch.ones(1))
            self.lengthscale = nn.Parameter(torch.ones(1))
        self.Q = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.V = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.K = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.Wout = Linear(d_k, in_dim, "const1e-5", generator=generator)


def _scores(att: TransformerAttention, cfg: Config, src: torch.Tensor,
            dst: torch.Tensor) -> torch.Tensor:
    """Per-edge, per-head raw scores [E, H] from gathered q/k [E, H, d_k]
    (JAX ``attention._scores``)."""
    return edge_scores(src, dst, cfg.attention_type,
                       getattr(att, "output_var", None),
                       getattr(att, "lengthscale", None))


def transformer_scores(att: TransformerAttention, cfg: Config,
                       x: torch.Tensor, g: Graph,
                       edge_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Raw per-edge, per-head scores [E, H]: q and k are projected on
    nodes, gathered per edge (q[row], k[col]) and reduced per head."""
    h = cfg.heads
    d_k = cfg.attention_dim // h
    # by the leaves: ``att`` may be a plain namespace of tensors (the
    # continuous adjoint's ``FuncParams``)
    q = x @ att.Q.w + att.Q.b
    k = x @ att.K.w + att.K.b
    src = q[g.row.long()].reshape(-1, h, d_k)
    dst = k[g.col.long()].reshape(-1, h, d_k)
    prods = _scores(att, cfg, src, dst)
    if cfg.reweight_attention and edge_weight is not None:
        prods = prods * edge_weight[:, None]
    return prods


def apply_transformer_attention(att: TransformerAttention, cfg: Config,
                                x: torch.Tensor, g: Graph,
                                edge_weight: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Per-head normalised attention [E, H] float32: softmax with the exact
    per-segment max, or squareplus with the GLOBAL max over all valid scores
    and heads (reference utils.py:196). Padding slots are 0."""
    prods = transformer_scores(att, cfg, x, g, edge_weight).float()
    normalise = segment_squareplus if cfg.square_plus else segment_softmax
    return normalise(prods, g, cfg.attention_norm_idx)


def frozen_mean_attention(att: TransformerAttention, cfg: Config,
                          x: torch.Tensor, g: Graph,
                          edge_weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Head-MEAN normalised attention as one [E] float32 array, the weights
    the attention block freezes into the laplacian RHS."""
    w = apply_transformer_attention(att, cfg, x, g, edge_weight)
    return w.sum(dim=1) / w.shape[1]


class GATAttention(nn.Module):
    """Parameters of SpGraphAttentionLayer: W [in, att_dim], Wout
    [att_dim, in] and a [2 d_k, 1], each normal with the reference's
    ``xavier_normal_(gain=1.414)`` deviation ``1.414 sqrt(2 / (fan_in +
    fan_out))``, drawn from ``generator``."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, att_dim = cfg.heads, cfg.attention_dim
        if att_dim % h:
            raise ValueError(f"Number of heads ({h}) must be a factor of the "
                             f"dimension size ({att_dim})")
        d_k = att_dim // h

        def normal(rows, cols):
            std = 1.414 * math.sqrt(2.0 / (rows + cols))
            return nn.Parameter(std * torch.randn(rows, cols,
                                                  generator=generator))

        self.W = normal(in_dim, att_dim)
        self.Wout = normal(att_dim, in_dim)
        self.a = normal(2 * d_k, 1)


def gat_scores(att, cfg: Config, x: torch.Tensor, g: Graph
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LeakyReLU scores [E, H], wx [N, att_dim]). The GAT score
    ``a . [Wx_row | Wx_col]`` is separable: ``s_src[row] + s_dst[col]``
    with both terms projected on the nodes, so each edge gathers two [H]
    rows (the JAX package's ``_gat_rhs_fused``)."""
    h = cfg.heads
    d_k = cfg.attention_dim // h
    wx = x @ att.W                                          # [N, att_dim]
    hh = wx.reshape(-1, h, d_k)
    a_vec = att.a[:, 0]
    s_src = torch.einsum("nhd,d->nh", hh, a_vec[:d_k])
    s_dst = torch.einsum("nhd,d->nh", hh, a_vec[d_k:])
    scores = torch.nn.functional.leaky_relu(
        s_src[g.row.long()] + s_dst[g.col.long()], cfg.leaky_relu_slope)
    return scores, wx


def apply_gat_attention(att, cfg: Config, x: torch.Tensor, g: Graph
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attention [E, H], wx [N, att_dim]): GAT scores, LeakyReLU and the
    per-segment softmax (reference function_GAT_attention.py:105-115; GAT
    never takes squareplus)."""
    scores, wx = gat_scores(att, cfg, x, g)
    return segment_softmax(scores.float(), g, cfg.attention_norm_idx), wx
