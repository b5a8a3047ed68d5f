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
scores, always softmax).

BLEND (``cfg.beltrami`` with ``attention_type="exp_kernel"``): the layer
splits its input into features ‖ positions ‖ labels (``beltrami_split``),
projects the features and labels by Qx / Kx / Vx and the positions by
Qp / Kp / Vp, and scores with the split-space product kernel
``exp_kernel_beltrami`` (``output_var_x``, ``lengthscale_x``,
``output_var_p``, ``lengthscale_p``).

A bfloat16 state is projected in float32, as JAX's type promotion widens
it against the float32 weights. Under the bfloat16 payload
(``payload`` of :func:`transformer_scores` and :func:`gat_scores`, the
JAX package's ``pay_dt``) the column side is projected from the bf16 table
and rounded as the JAX package rounds it; every rounding is the identity
in the gradient, as the kernels' backward takes it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (bf16_k_table,
                                                          bf16_round,
                                                          bf16_round_st,
                                                          edge_scores,
                                                          head_slices,
                                                          score_scalars)
from graph_neural_pde_tpu_torch.models.layers import Linear
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.scatter import (segment_softmax,
                                                    segment_squareplus)

ATTENTION_TYPES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")
BELTRAMI_SCALARS = ("output_var_x", "lengthscale_x", "output_var_p",
                    "lengthscale_p")


def is_beltrami(cfg: Config) -> bool:
    """True when the transformer attention is BLEND's split-space kernel
    (the JAX package's ``cfg.beltrami and attention_type == "exp_kernel"``;
    other families score the whole state under ``beltrami`` too)."""
    return cfg.beltrami and cfg.attention_type == "exp_kernel"


def score_family(cfg: Config) -> str:
    """The attention's score family as the kernels name it."""
    return "exp_kernel_beltrami" if is_beltrami(cfg) else cfg.attention_type


class TransformerAttention(nn.Module):
    """Parameters of SpGraphTransAttentionLayer: Q, K, V [in, att_dim],
    Wout [d_k, in], and the exp_kernel's ``output_var`` and ``lengthscale``
    (one element each). Only Q, K and the exp_kernel scalars feed the
    GRAND-l attention; V and Wout are kept so that parameters round-trip
    with the JAX package. BLEND's split-space layer (``is_beltrami``) holds
    Qx, Vx, Kx [in - pos_enc_hidden_dim, att_dim] over the features and
    labels, Qp, Vp, Kp [pos_enc_hidden_dim, att_dim] over the positions,
    Wout, and ``BELTRAMI_SCALARS``."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, att_dim = cfg.heads, cfg.attention_dim
        if att_dim % h:
            raise ValueError(f"Number of heads ({h}) must be a factor of the "
                             f"dimension size ({att_dim})")
        if cfg.attention_type not in ATTENTION_TYPES:
            raise ValueError(
                f"unknown attention_type '{cfg.attention_type}'")
        d_k = att_dim // h
        if is_beltrami(cfg):
            for name in BELTRAMI_SCALARS:
                setattr(self, name, nn.Parameter(torch.ones(1)))
            dims = {"x": in_dim - cfg.pos_enc_hidden_dim,
                    "p": cfg.pos_enc_hidden_dim}
            for side in ("x", "p"):
                for m in ("Q", "V", "K"):
                    setattr(self, m + side,
                            Linear(dims[side], att_dim, "const1e-5",
                                   generator=generator))
        else:
            if cfg.attention_type == "exp_kernel":
                self.output_var = nn.Parameter(torch.ones(1))
                self.lengthscale = nn.Parameter(torch.ones(1))
            self.Q = Linear(in_dim, att_dim, "const1e-5", generator=generator)
            self.V = Linear(in_dim, att_dim, "const1e-5", generator=generator)
            self.K = Linear(in_dim, att_dim, "const1e-5", generator=generator)
        self.Wout = Linear(d_k, in_dim, "const1e-5", generator=generator)


def beltrami_split(cfg: Config, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features ‖ labels, positions) of a BLEND state laid out as
    [features | positions | labels] (reference
    function_transformer_attention.py:128-171)."""
    fh = cfg.feat_hidden_dim
    li = fh + cfg.pos_enc_hidden_dim
    return torch.cat([x[:, :fh], x[:, li:]], dim=1), x[:, fh:li]


def _project(lin, x: torch.Tensor) -> torch.Tensor:
    # by the leaves: ``att`` may be a plain namespace of tensors (the
    # continuous adjoint's ``FuncParams``)
    return x @ lin.w + lin.b


def query_key(att, cfg: Config, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The node projections q, k [N, att_dim]; for BLEND the packed
    (Qx ‖ Qp), (Kx ‖ Kp) [N, 2 att_dim]."""
    if is_beltrami(cfg):
        feat, pos = beltrami_split(cfg, x)
        return (torch.cat([_project(att.Qx, feat), _project(att.Qp, pos)], 1),
                torch.cat([_project(att.Kx, feat), _project(att.Kp, pos)], 1))
    return _project(att.Q, x), _project(att.K, x)


def score_params(att, cfg: Config) -> Tuple:
    """The score family's learnable scalars, as the fused kernels take
    them: exp_kernel's (output_var, lengthscale), BLEND's four, or ()."""
    if is_beltrami(cfg):
        return tuple(getattr(att, n) for n in BELTRAMI_SCALARS)
    if cfg.attention_type == "exp_kernel":
        return att.output_var, att.lengthscale
    return ()


def widen_state(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 state in float32 (JAX's promotion against the float32
    weights); any other x as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _st(a: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` in value, ``a`` in the gradient."""
    return a + (value - a).detach()


def transformer_scores(att: TransformerAttention, cfg: Config,
                       x: torch.Tensor, g: Graph,
                       edge_weight: Optional[torch.Tensor] = None,
                       payload: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Raw per-edge, per-head scores [E, H]: q and k are projected on
    nodes, gathered per edge (q[row], k[col]) and reduced per head.

    With ``payload`` (``torch.bfloat16``: the composed fused RHS under the
    bf16 payload or state) the four in-kernel families take k as the JAX
    package's ``_transformer_rhs_fused`` forms it from the bf16 table,
    ``x_b[col] @ Kw_b + kb_b`` rounded twice (``bf16_k_table``; its
    gradient that of ``x_b Kw_b + kb_b``, each cast the identity), and q in
    float32; BLEND's split-space score is computed unrounded, as the JAX
    package computes it there."""
    score = score_family(cfg)
    slices = head_slices(score, cfg.heads)
    xw = widen_state(x)
    q, k = query_key(att, cfg, xw)
    if payload is not None and not is_beltrami(cfg):
        kw, kb = att.K.w, att.K.b
        lin = bf16_round_st(xw) @ bf16_round_st(kw) + bf16_round_st(kb)
        k = _st(lin, bf16_k_table(x.to(payload), kw, kb))
    src = q[g.row.long()].reshape(g.row.shape[0], slices, -1)
    dst = k[g.col.long()].reshape(g.col.shape[0], slices, -1)
    prods = edge_scores(src, dst, score,
                        *score_scalars(score, score_params(att, cfg)))
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


def gat_scores(att, cfg: Config, x: torch.Tensor, g: Graph,
               payload: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LeakyReLU scores [E, H], wx [N, att_dim]). The GAT score
    ``a . [Wx_row | Wx_col]`` is separable: ``s_src[row] + s_dst[col]``
    with both terms projected on the nodes, so each edge gathers two [H]
    rows (the JAX package's ``_gat_rhs_fused``).

    With ``payload`` (``torch.bfloat16``) ``s_dst`` is the JAX package's
    ``x_b[col] @ w_dst_b``, W folded with ``a_dst`` per head and the
    product of the bf16 table with it rounded once (summed in float64,
    exact for these products, as ``bf16_k_table`` sums k); its gradient is
    that of ``x_b w_dst_b``, each cast the identity."""
    h = cfg.heads
    d_k = cfg.attention_dim // h
    xw = widen_state(x)
    wx = xw @ att.W                                         # [N, att_dim]
    hh = wx.reshape(-1, h, d_k)
    a_vec = att.a[:, 0]
    s_src = torch.einsum("nhd,d->nh", hh, a_vec[:d_k])
    if payload is None:
        s_dst = torch.einsum("nhd,d->nh", hh, a_vec[d_k:])
    else:
        w_dst = torch.einsum("dhf,f->dh",
                             att.W.reshape(xw.shape[1], h, d_k), a_vec[d_k:])
        prod = (x.to(payload).double() @ bf16_round(w_dst).double()).float()
        s_dst = _st(bf16_round_st(xw) @ bf16_round_st(w_dst),
                    bf16_round(prod).to(w_dst.dtype))
    scores = torch.nn.functional.leaky_relu(
        s_src[g.row.long()] + s_dst[g.col.long()], cfg.leaky_relu_slope)
    return scores, wx


def apply_gat_attention(att, cfg: Config, x: torch.Tensor, g: Graph
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attention [E, H], wx [N, att_dim]): GAT scores, LeakyReLU and the
    per-segment softmax (reference function_GAT_attention.py:105-115; GAT
    never takes squareplus). A bfloat16 x is projected in float32."""
    scores, wx = gat_scores(att, cfg, x, g)
    return segment_softmax(scores.float(), g, cfg.attention_norm_idx), wx
