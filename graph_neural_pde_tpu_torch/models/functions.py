"""ODE right-hand sides dx/dt = f(x(t), G) (PyTorch port of the laplacian
and transformer functions of ``models/functions.py``).

``make_rhs`` returns ``rhs(func, aux, t, x)`` where ``func`` holds the
learnable parameters and ``aux`` the per-solve constants. Ported: the
laplacian function (every tuned GRAND-l config) and the transformer
function (GRAND-nl: attention recomputed at every evaluation) without
``mix_features``. The GAT function, and squareplus or reweighted attention
inside the fused transformer RHS, raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (den_guard,
                                                          fused_rhs_ax,
                                                          fused_rhs_f,
                                                          fused_rowmax,
                                                          make_fused_ax_sym)
from graph_neural_pde_tpu_torch.models.attention import (
    TransformerAttention, apply_transformer_attention)
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm


class FuncAux(NamedTuple):
    """Per-solve constants.

    attention  : [E] head-mean frozen attention (attention block), the
                 renormalised sampled attention (hard_attention block) or
                 None
    x0         : source-term state, detached (the reference's set_x0 clones
                 and detaches, base_classes.py:52-54)
    edge_weight: normalised adjacency weights
    """

    attention: Optional[torch.Tensor]
    x0: torch.Tensor
    edge_weight: torch.Tensor


class FuncParams(NamedTuple):
    """An ODE function's parameters as plain tensors, where a solver passes
    them explicitly (the continuous adjoint); the RHS reads them from this
    or from an ``ODEFunc`` alike. ``att`` mirrors ``ODEFunc.att`` (``Q.w``,
    ``K.b``, ``output_var`` ...) for the transformer function."""

    alpha_train: torch.Tensor
    beta_train: torch.Tensor
    att: Optional[SimpleNamespace] = None


class ODEFunc(nn.Module):
    """alpha_train / beta_train scalars, initialised to 0 (reference
    base_classes.py:87-88), plus the attention layer ``att`` of the
    transformer function, which recomputes attention at every evaluation
    (the JAX package's ``init_func_params``)."""

    def __init__(self, cfg: Config, in_dim: int = 0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_function(cfg)
        self.alpha_train = nn.Parameter(torch.zeros(()))
        self.beta_train = nn.Parameter(torch.zeros(()))
        if cfg.function == "transformer":
            self.att = TransformerAttention(cfg, in_dim, generator=generator)


# the attention layer's tensors in the JAX package's leaf order (a dict
# pytree flattens by sorted key), without the exp_kernel scalars
_ATT_LEAVES = tuple((m, leaf) for m in ("K", "Q", "V", "Wout")
                    for leaf in ("b", "w"))


def func_tensors(func: ODEFunc, inert: torch.Tensor) -> List[torch.Tensor]:
    """Every tensor of the function's parameters in the JAX package's leaf
    order: the inert probe scalar (``inert`` stands in for it), alpha, the
    attention layer's leaves, beta. :func:`func_from_tensors` inverts it."""
    out = [inert, func.alpha_train]
    att = getattr(func, "att", None)
    if att is not None:
        out += [getattr(getattr(att, m), leaf) for m, leaf in _ATT_LEAVES]
        if hasattr(att, "lengthscale"):
            out += [att.lengthscale, att.output_var]
    return out + [func.beta_train]


def func_from_tensors(func: ODEFunc, tensors) -> FuncParams:
    """The ``FuncParams`` over ``tensors``, laid out as :func:`func_tensors`
    lays out ``func``."""
    att = None
    if getattr(func, "att", None) is not None:
        rest = list(tensors[2:-1])
        att = SimpleNamespace(**{m: SimpleNamespace() for m in
                                 ("K", "Q", "V", "Wout")})
        for (m, leaf), t in zip(_ATT_LEAVES, rest):
            setattr(getattr(att, m), leaf, t)
        if len(rest) > len(_ATT_LEAVES):
            att.lengthscale, att.output_var = rest[len(_ATT_LEAVES):]
    return FuncParams(tensors[1], tensors[-1], att)


def _alpha(cfg: Config, func) -> torch.Tensor:
    a = func.alpha_train
    return a if cfg.no_alpha_sigmoid else torch.sigmoid(a)


def _source(cfg: Config, func, f: torch.Tensor, aux: FuncAux):
    if cfg.add_source:
        return f + func.beta_train * aux.x0
    return f


def fused_transformer(cfg: Config) -> bool:
    """True when the transformer RHS folds the row softmax into the
    aggregation (K6-K9) rather than composing attention and SpMM."""
    return (cfg.function == "transformer" and cfg.fused_attention_agg
            and not cfg.mix_features and cfg.attention_norm_idx == 0)


def check_function(cfg: Config) -> None:
    """Raise for the ODE functions and attention variants still to port."""
    if cfg.function == "GAT":
        raise NotImplementedError(
            "function 'GAT': ROADMAP Queue 1 slice 3 item 14 (GAT RHS, TPU "
            "kernels P4/P5)")
    if cfg.function not in ("laplacian", "transformer"):
        raise ValueError(f"unknown function '{cfg.function}'")
    if cfg.function != "transformer":
        return
    if cfg.mix_features:
        raise NotImplementedError(
            "mix_features: ROADMAP Queue 1 slice 3 item 14 (spmm_multihead)")
    if cfg.block == "hard_attention":
        raise NotImplementedError(
            "hard_attention block over the transformer function: ROADMAP "
            "Queue 1 slice 3 item 14")
    if fused_transformer(cfg):
        for field in ("square_plus", "reweight_attention"):
            if getattr(cfg, field):
                raise NotImplementedError(
                    f"{field} with the fused transformer RHS: ROADMAP Queue "
                    "1 slice 3 item 14 (the dual scatter/gather, TPU "
                    "kernels P4/P5); fused_attention_agg=False composes "
                    "attention and SpMM instead")


def _transformer_rhs_fused(func, aux: FuncAux, x: torch.Tensor, cfg: Config,
                           g: Graph, exact_softmax: bool, eval_fold: bool):
    """GRAND-nl RHS with the row softmax folded into the aggregation: one
    K6 launch per evaluation, K9 (symmetric) or K8 for its gradient.

    Softmax is shift-invariant, so exp runs unshifted (``gmax = 0``), exact
    while the scores stay within float32's exp range. Both failure modes, a
    whole row underflowing to 0 or a score overflowing to inf, poison the
    output with NaN; ``block_forward`` then re-solves once with
    ``exact_softmax``, which shifts every edge by its row's true score max
    (K7) so that no exp can leave the range."""
    att = func.att
    h, score = cfg.heads, cfg.attention_type
    sp = (att.output_var, att.lengthscale) if score == "exp_kernel" else ()
    qw, qb, kw, kb = att.Q.w, att.Q.b, att.K.w, att.K.b
    if eval_fold and not exact_softmax:
        f = fused_rhs_f(g, h, score, qw, qb, kw, kb, x, _alpha(cfg, func), sp)
        return _source(cfg, func, f, aux)
    gmax = torch.zeros((1,), dtype=torch.float32, device=x.device)
    use_sym = cfg.sym_backward if cfg.sym_backward is not None else True
    if use_sym and g.rev is not None and not exact_softmax:
        ax, den = make_fused_ax_sym(g, h, False, score)(qw, qb, kw, kb, x,
                                                        gmax, sp)
    else:
        shifts = None
        if exact_softmax:
            with torch.no_grad():
                smax = fused_rowmax(g.rowptr, g.row, g.col, x.contiguous(),
                                    qw, qb, kw, kb, heads=h)
                shifts = smax[g.row.long()]
        ax, den = fused_rhs_ax(g, h, False, score, qw, qb, kw, kb, x, gmax,
                               shifts, sp)
    if not exact_softmax:
        bad = den_guard(den, g.rowptr, per_row=False)
        ax = torch.where(bad, torch.full_like(ax, torch.nan), ax)
    f = _alpha(cfg, func) * (ax - x)
    return _source(cfg, func, f, aux)


def rhs_may_poison(cfg: Config) -> bool:
    """True when make_rhs's default path can NaN-poison its output on
    softmax under- or overflow, so that the caller must re-solve with
    ``make_rhs(..., exact_softmax=True)`` if the solved state is not
    finite."""
    return fused_transformer(cfg) and not cfg.square_plus


def make_rhs(cfg: Config, g: Graph, spmm_fn: Optional[Callable] = None,
             exact_softmax: bool = False,
             eval_fold: bool = False) -> Callable:
    """Build rhs(func, aux, t, x) for cfg.function over the prepared graph.

    * laplacian: alpha·(A_w x − x) [+ beta·x0] with A_w the frozen attention
      (or the normalised adjacency).
    * transformer: A_w is the head-mean attention recomputed from x. With
      row normalisation it is the fused RHS (K6-K9, see
      ``_transformer_rhs_fused``); otherwise (column normalisation, or
      ``fused_attention_agg=False``) attention (K3/K4) and SpMM (K1/K2)
      are composed.

    ``spmm_fn(x, w)`` is the aggregation engine, by default
    ``ops.spmm.make_spmm(g)``: the CUDA kernels on a CUDA graph, their plain
    versions on a CPU one. ``exact_softmax`` normalises with the exact
    per-row softmax instead of the unshifted fast path (see
    ``rhs_may_poison``); for the bounded score families (all but
    scaled_dot) that is the composition. ``eval_fold`` folds alpha·(ax − x)
    and a per-row guard into K6's final write on no-grad solves."""
    check_function(cfg)
    if spmm_fn is None:
        spmm_fn = make_spmm(g)

    if cfg.function == "laplacian":

        def rhs(func, aux: FuncAux, t, x):
            w = aux.attention if aux.attention is not None else aux.edge_weight
            ax = spmm_fn(x, w)
            f = _alpha(cfg, func) * (ax - x)
            return _source(cfg, func, f, aux)

        return rhs

    use_fused = fused_transformer(cfg) and not (
        exact_softmax and cfg.attention_type != "scaled_dot")

    def rhs(func, aux: FuncAux, t, x):
        if use_fused:
            return _transformer_rhs_fused(func, aux, x, cfg, g,
                                          exact_softmax, eval_fold)
        attention = apply_transformer_attention(
            func.att, cfg, x, g, edge_weight=aux.edge_weight)
        ax = spmm_fn(x, torch.mean(attention, dim=1))
        f = _alpha(cfg, func) * (ax - x)
        return _source(cfg, func, f, aux)

    return rhs
