"""ODE blocks: an ODE function, its graph preparation and its solve
(PyTorch port of the ``constant``, ``attention`` and ``hard_attention``
blocks of ``models/blocks.py``, with its poison-and-re-solve discipline
for the fused transformer function).

* constant       — fixed normalised adjacency weights;
* attention      — multihead attention computed once per forward at t=0 and
  frozen into the laplacian RHS as its head mean (GRAND-l);
* hard_attention — in training, the head-mean attention computed without
  gradient, its edges below the ``1 − att_samp_pct`` quantile dropped and
  the kept weights renormalised per node; at eval, the full head mean.

The solve takes ``cfg.method``; in training with ``cfg.adjoint`` its
gradient is the continuous adjoint with the ``adjoint_method`` backward.
The mixed and rewire_attention blocks raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.attention import (
    TransformerAttention, apply_transformer_attention, frozen_mean_attention)
from graph_neural_pde_tpu_torch.models.functions import (FuncAux, ODEFunc,
                                                         func_from_tensors,
                                                         func_tensors,
                                                         make_rhs,
                                                         rhs_may_poison)
from graph_neural_pde_tpu_torch.ops.graph import Graph, get_rw_adj
from graph_neural_pde_tpu_torch.ops.scatter import normalize_attention
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.solvers.api import (SolverOptions, odeint,
                                                    odeint_adjoint)

BLOCK_NAMES = ("constant", "attention", "hard_attention")


def check_block(cfg: Config) -> None:
    if cfg.block == "mixed":
        raise NotImplementedError(
            "block 'mixed': ROADMAP Queue 1 slice 2 item 11")
    if cfg.block == "rewire_attention":
        raise NotImplementedError(
            "block 'rewire_attention': ROADMAP Queue 1 slice 4 item 16")
    if cfg.block not in BLOCK_NAMES:
        raise ValueError(f"unknown block '{cfg.block}'")


def prepare_graph(cfg: Config, g: Graph) -> Graph:
    """The block's one-off adjacency normalisation: random-walk norm over
    columns (norm_dim=1) with self-loop fill, then a row sort, which also
    builds the CSR ``rowptr`` and the reverse-edge map ``rev``. The GCN norm
    of the constant block (data_norm != 'rw') is not ported yet."""
    if cfg.block == "constant" and cfg.data_norm != "rw":
        raise NotImplementedError(
            "constant block with data_norm='gcn': ROADMAP Queue 1 slice 1 "
            "item 4 (gcn_norm_fill_val)")
    g = get_rw_adj(g, norm_dim=1, fill_value=cfg.self_loop_weight)
    return g.sort_by_row()


class ODEBlock(nn.Module):
    """Learnable block parameters: the ODE function's, plus the block's
    attention layer for the attention and hard_attention blocks."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_block(cfg)
        self.func = ODEFunc(cfg, in_dim, generator=generator)
        if cfg.block in ("attention", "hard_attention"):
            self.att = TransformerAttention(cfg, in_dim, generator=generator)


def masked_quantile(values: torch.Tensor, mask: torch.Tensor,
                    q: float) -> torch.Tensor:
    """Linear-interpolated quantile over the masked entries, as
    ``torch.quantile`` over the valid edges (reference
    block_transformer_hard_attention.py:60), in the JAX package's float32
    arithmetic."""
    big = torch.finfo(values.dtype).max
    sorted_vals = torch.sort(torch.where(mask, values,
                                         torch.full_like(values, big))).values
    n = torch.sum(mask.to(torch.int32))
    rank = q * (n.to(values.dtype) - 1.0)
    last = values.shape[0] - 1
    lo = torch.clamp(torch.floor(rank).to(torch.int64), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = rank - lo.to(values.dtype)
    v_lo = sorted_vals[lo]
    v_hi = torch.where(hi < n, sorted_vals[hi], v_lo)
    return v_lo + frac * (v_hi - v_lo)


def build_aux(block: ODEBlock, cfg: Config, g: Graph, x: torch.Tensor,
              training: bool) -> Tuple[FuncAux, Optional[torch.Tensor]]:
    """Per-forward constants of the solve: the frozen attention and the
    detached source state x0. Returns (aux, keep): ``keep`` is the
    hard-attention training mask of kept edges (the solve runs on the graph
    re-masked to them), else None."""
    x0 = x.detach()   # set_x0 detaches (base_classes.py:52-54)
    if cfg.block == "constant":
        return FuncAux(attention=None, x0=x0, edge_weight=g.weight), None
    if cfg.block == "attention":
        att = frozen_mean_attention(block.att, cfg, x, g,
                                    edge_weight=g.weight)
        return FuncAux(attention=att, x0=x0, edge_weight=g.weight), None
    # hard_attention: the reference computes the attention and the
    # subsampled weights under no_grad
    # (block_transformer_hard_attention.py:52-65)
    with torch.no_grad():
        mean_att = apply_transformer_attention(
            block.att, cfg, x, g, edge_weight=g.weight).mean(dim=1)
        if not training:
            return FuncAux(attention=mean_att, x0=x0,
                           edge_weight=g.weight), None
        if cfg.use_flux:
            row, col = g.row.long(), g.col.long()
            mean_att = mean_att * torch.linalg.vector_norm(x[row] - x[col],
                                                           dim=1)
        thresh = masked_quantile(mean_att, g.mask, 1.0 - cfg.att_samp_pct)
        keep = (mean_att > thresh) & g.mask
        sampled = normalize_attention(mean_att, g, cfg.attention_norm_idx,
                                      mask=keep)
    return FuncAux(attention=sampled, x0=x0, edge_weight=g.weight), keep


def _masked_spmm(spmm_fn: Callable, keep: torch.Tensor) -> Callable:
    """The aggregation on the graph re-masked to ``keep``: dropped edges
    weigh 0 and get no weight gradient (the JAX package's masked spmm)."""
    def fn(x, w):
        return spmm_fn(x, torch.where(keep, w, torch.zeros_like(w)))
    return fn


def solved_badly(z: torch.Tensor, stats: dict) -> bool:
    """One host sync per solve: the state is not finite, or the adaptive
    controller ran into its step cap (NaN error estimates reject every
    step)."""
    return bool(stats["hit_max_steps"]) or not bool(torch.isfinite(z).all())


def block_forward(block: ODEBlock, cfg: Config, g: Graph, x: torch.Tensor,
                  training: bool, spmm_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Solve the IVP over [0, T] with cfg.method. Returns (z, stats).

    Differentiable when autograd is enabled: in training with
    ``cfg.adjoint`` through the continuous adjoint (whose backward adds
    ``bwd_nfe`` to stats), otherwise through the solver's steps (the
    discrete adjoint).

    The fused transformer RHS runs its softmax unshifted and poisons its
    output with NaN when an exp left float32's range
    (``functions.rhs_may_poison``). That is detected once, after the solve,
    and the solve is then repeated with the exact per-row softmax."""
    aux, keep = build_aux(block, cfg, g, x, training)
    if keep is not None:
        spmm_fn = _masked_spmm(spmm_fn or make_spmm(g), keep)

    def solve(exact_softmax: bool):
        rhs = make_rhs(cfg, g, spmm_fn=spmm_fn, exact_softmax=exact_softmax,
                       eval_fold=cfg.fold_epilogue and not training)
        return _solve(block, cfg, aux, rhs, x, training)

    z, stats = solve(False)
    if rhs_may_poison(cfg) and solved_badly(z, stats):
        z, stats = solve(True)
    return z, stats


def _solve(block: ODEBlock, cfg: Config, aux: FuncAux, rhs: Callable,
           x: torch.Tensor, training: bool) -> Tuple[torch.Tensor, dict]:
    opts = SolverOptions.from_config(cfg)

    if not (cfg.adjoint and training):
        def func(t, y):
            return rhs(block.func, aux, t, y)

        return odeint(func, x, 0.0, cfg.time, opts)

    # The continuous adjoint integrates a cotangent for every parameter
    # tensor of the RHS, in the JAX package's leaf order: attention, x0,
    # edge weights, then the function's parameters (its scalars and, for
    # the transformer function, its attention layer). The JAX parameters
    # hold one more scalar, an inert probe that carries the backward NFE
    # out of its solve; its cotangent is 0 but counts in the backward error
    # norm, so a zero scalar stands in for it.
    inert = torch.zeros((), device=x.device)
    params = [aux.x0, aux.edge_weight, *func_tensors(block.func, inert)]
    has_att = aux.attention is not None
    if has_att:
        params.insert(0, aux.attention)

    def func_p(t, y, p):
        att, p = (p[0], p[1:]) if has_att else (None, p)
        return rhs(func_from_tensors(block.func, p[2:]),
                   FuncAux(att, p[0], p[1]), t, y)

    return odeint_adjoint(func_p, x, params, 0.0, cfg.time, opts,
                          SolverOptions.from_config(cfg, adjoint=True))
