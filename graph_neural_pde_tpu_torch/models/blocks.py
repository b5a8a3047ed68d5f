"""ODE blocks: an ODE function, its graph preparation and its solve
(PyTorch port of the ``constant``, ``attention``, ``mixed`` and
``hard_attention`` blocks of ``models/blocks.py``, with its
poison-and-re-solve discipline for the fused attention functions).

* constant       — fixed normalised adjacency weights;
* attention      — multihead attention computed once per forward at t=0 and
  frozen into the laplacian RHS as its head mean (GRAND-l);
* mixed          — a learnable convex combination ``mean_h(att)·(1 − σ(γ))
  + weight·σ(γ)`` of that frozen attention and the normalised adjacency;
* hard_attention — in training, the head-mean attention computed without
  gradient, its edges below the ``1 − att_samp_pct`` quantile dropped and
  the kept weights renormalised per node; at eval, the full head mean. Over
  a transformer or GAT function the block has no attention layer of its
  own: the function's layer scores the edges, and the solve recomputes its
  attention on the graph re-masked to the kept edges.

The solve takes ``cfg.method``; in training with ``cfg.adjoint`` its
gradient is the continuous adjoint with the ``adjoint_method`` backward.
The rewire_attention block raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels.blocked import EdgeMap, PlanPair
from graph_neural_pde_tpu_torch.kernels.blocked import \
    make_spmm as make_blocked_spmm
from graph_neural_pde_tpu_torch.models.attention import (
    TransformerAttention, apply_gat_attention, apply_transformer_attention,
    frozen_mean_attention, widen_state)
from graph_neural_pde_tpu_torch.models.functions import (FuncAux, ODEFunc,
                                                         func_from_tensors,
                                                         func_tensors,
                                                         laplacian_payload,
                                                         make_rhs,
                                                         rhs_may_poison)
from graph_neural_pde_tpu_torch.ops.graph import Graph, get_rw_adj
from graph_neural_pde_tpu_torch.ops.plan import (build_block_plan,
                                                 transpose_plan)
from graph_neural_pde_tpu_torch.ops.scatter import normalize_attention
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.solvers.api import (FIXED_METHODS,
                                                    SolverOptions, odeint,
                                                    odeint_adjoint)

BLOCK_NAMES = ("constant", "attention", "mixed", "hard_attention")


def check_block(cfg: Config) -> None:
    if cfg.block == "rewire_attention":
        raise NotImplementedError(
            "block 'rewire_attention': ROADMAP Queue 1 slice 4 item 16")
    if cfg.block not in BLOCK_NAMES:
        raise ValueError(f"unknown block '{cfg.block}'")


SPMM_IMPLS = ("xla", "pallas_blocked")


def build_spmm_engine(cfg: Config, g: Graph) -> Tuple[Callable, int]:
    """The laplacian aggregation engine of a prepared graph, and the node
    count the ODE state is padded to.

    * ``xla``: ``ops.spmm.make_spmm`` over the row-sorted graph (K1/K2),
      reading x in the bfloat16 payload where the laplacian asks for it.
    * ``pallas_blocked``: the blocked plan pair of the graph's valid edges
      (``kernels.blocked``: K15, its dx on the transposed plan, K16 for dw),
      for the laplacian function only, as in the JAX package. The plan pads
      the node count to a multiple of ``spmm_block_n``. The graph itself
      stays row-sorted for everything else (the attention freeze walks its
      ``rowptr``); the engine takes the per-edge weights in the graph's slot
      order and reaches plan order with one gather through a host-built
      slot map, and returns dw in the graph's order. It takes no payload,
      and it widens a bfloat16 state to float32 before K15/K16 (x's
      gradient comes back in bfloat16): that is the JAX package's own
      semantics there, not a fallback, since its blocked kernels cast
      every table they read to float32 and its ``make_rhs`` hands the
      payload only to the default engine.
    """
    pay = laplacian_payload(cfg)
    if cfg.spmm_impl != "pallas_blocked" or cfg.function != "laplacian":
        return make_spmm(g, pay), g.num_nodes
    if cfg.rewire_KNN or cfg.edge_sampling or cfg.fa_layer:
        print("[spmm] pallas_blocked disabled: runtime rewiring would stale "
              "the static block plan", file=sys.stderr)
        return make_spmm(g, pay), g.num_nodes
    mask = g.mask.cpu().numpy()
    slots = np.nonzero(mask)[0]
    plan, tags = build_block_plan(
        g.row.cpu().numpy()[slots], g.col.cpu().numpy()[slots],
        num_nodes=g.num_nodes, block_n=cfg.spmm_block_n,
        chunk=cfg.spmm_chunk, return_tags=True)
    bwd, t_perm, t_valid = transpose_plan(plan)
    # graph slot of each plan slot, and plan slot of each valid graph slot
    valid = tags >= 0
    to_plan = np.where(valid, slots[np.maximum(tags, 0)], 0)
    from_plan = np.zeros(g.capacity, np.int64)
    from_plan[to_plan[valid]] = np.nonzero(valid)[0]
    dev = g.row.device
    edge_map = EdgeMap(
        to_plan=torch.as_tensor(to_plan.astype(np.int32), device=dev),
        from_plan=torch.as_tensor(from_plan.astype(np.int32), device=dev),
        mask=g.mask)
    blocked = make_blocked_spmm(PlanPair(plan, bwd, t_perm, t_valid), dev,
                                edge_map=edge_map)

    def spmm_fn(x, w):
        return blocked(widen_state(x), w)

    return spmm_fn, plan.num_nodes


def prepare_graph(cfg: Config, g: Graph) -> Graph:
    """The block's one-off adjacency normalisation: random-walk norm over
    columns (norm_dim=1) with self-loop fill, then a row sort, which also
    builds the CSR ``rowptr``, the reverse-edge map ``rev`` (symmetric edge
    multisets) and the CSC view (every graph). The GCN norm
    of the constant block (data_norm != 'rw') is not ported yet."""
    if cfg.block == "constant" and cfg.data_norm != "rw":
        raise NotImplementedError(
            "constant block with data_norm='gcn': ROADMAP Queue 1 item 22 "
            "(gcn_norm_fill_val)")
    g = get_rw_adj(g, norm_dim=1, fill_value=cfg.self_loop_weight)
    return g.sort_by_row()


class ODEBlock(nn.Module):
    """Learnable block parameters: the ODE function's, plus the block's
    attention layer where the reference has one (the attention and mixed
    blocks, and hard_attention over the laplacian function) and the mixed
    block's ``gamma`` (one element, 0: an even mix)."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_block(cfg)
        self.func = ODEFunc(cfg, in_dim, generator=generator)
        own_attention = cfg.block in ("attention", "mixed") or (
            cfg.block == "hard_attention"
            and cfg.function not in ("GAT", "transformer"))
        if own_attention:
            self.att = TransformerAttention(cfg, in_dim, generator=generator)
        if cfg.block == "mixed":
            self.gamma = nn.Parameter(torch.zeros(1))


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


def _block_attention(block: ODEBlock, cfg: Config, g: Graph,
                     x: torch.Tensor) -> torch.Tensor:
    """The per-head attention [E, H] a block computes at t=0: from its own
    layer, or (hard_attention over a GAT or transformer function) from the
    function's (block_transformer_hard_attention.py:36-41)."""
    if hasattr(block, "att"):
        return apply_transformer_attention(block.att, cfg, x, g,
                                           edge_weight=g.weight)
    if cfg.function == "GAT":
        return apply_gat_attention(block.func.att, cfg, x, g)[0]
    return apply_transformer_attention(block.func.att, cfg, x, g,
                                       edge_weight=g.weight)


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
    if cfg.block == "mixed":
        att = _block_attention(block, cfg, g, x)
        gamma = torch.sigmoid(block.gamma[0])
        mixed = torch.mean(att, dim=1) * (1.0 - gamma) + g.weight * gamma
        return FuncAux(attention=mixed, x0=x0, edge_weight=g.weight), None
    # hard_attention: the reference computes the attention and the
    # subsampled weights under no_grad
    # (block_transformer_hard_attention.py:52-65)
    with torch.no_grad():
        mean_att = _block_attention(block, cfg, g, x).mean(dim=1)
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

    The fused attention RHS runs its softmax with one global shift (none
    in the one-kernel path) and poisons its output with NaN when an exp
    left float32's range
    (``functions.rhs_may_poison``). That is detected once, after the solve,
    and the solve is then repeated with the exact per-row softmax."""
    aux, keep = build_aux(block, cfg, g, x, training)
    if keep is not None:
        spmm_fn = _masked_spmm(spmm_fn or make_spmm(g, laplacian_payload(cfg)),
                               keep)
        g = g.with_mask(keep)

    def solve(exact_softmax: bool):
        rhs = make_rhs(cfg, g, spmm_fn=spmm_fn, exact_softmax=exact_softmax,
                       eval_fold=cfg.fold_epilogue and not training)
        return _solve(block, cfg, aux, rhs, x, training)

    z, stats = solve(False)
    if rhs_may_poison(cfg) and solved_badly(z, stats):
        z, stats = solve(True)
    return z, stats


def low_precision_state(cfg: Config) -> bool:
    """True when the solve carries a bfloat16 state: ``dtype="bfloat16"``
    on a fixed grid (an adaptive controller's error estimate in bfloat16
    would thrash its step size, so adaptive methods keep float32, as in
    the JAX package)."""
    return cfg.dtype == "bfloat16" and cfg.method in FIXED_METHODS


def _solve(block: ODEBlock, cfg: Config, aux: FuncAux, rhs: Callable,
           x: torch.Tensor, training: bool) -> Tuple[torch.Tensor, dict]:
    """The solve of ``block_forward``. Under the bfloat16 state
    (:func:`low_precision_state`) the state starts as x cast to bfloat16,
    each RHS output is cast to the state's dtype, every stage sum rounds
    back to bfloat16 (``solvers.rk.axpy``), and z comes back in float32,
    as the JAX package's ``block_forward`` runs its fixed-grid solves."""
    opts = SolverOptions.from_config(cfg)
    lowp = low_precision_state(cfg)
    state0 = x.to(torch.bfloat16) if lowp else x

    def as_state(out, y):
        return out.to(y.dtype) if lowp else out

    if not (cfg.adjoint and training):
        def func(t, y):
            return as_state(rhs(block.func, aux, t, y), y)

        z, stats = odeint(func, state0, 0.0, cfg.time, opts)
        return (z.float() if lowp else z), stats

    # The continuous adjoint integrates a cotangent for every parameter
    # tensor of the RHS, in the JAX package's leaf order: attention, x0,
    # edge weights, then the function's parameters (its scalars and, for
    # the transformer and GAT functions, its attention layer). The JAX
    # parameters hold one more scalar, an inert probe that carries the
    # backward NFE out of its solve; its cotangent is 0 but counts in the
    # backward error norm, so a zero scalar stands in for it.
    inert = torch.zeros((), device=x.device)
    params = [aux.x0, aux.edge_weight, *func_tensors(block.func, inert)]
    has_att = aux.attention is not None
    if has_att:
        params.insert(0, aux.attention)

    def func_p(t, y, p):
        att, p = (p[0], p[1:]) if has_att else (None, p)
        return as_state(rhs(func_from_tensors(block.func, p[2:]),
                            FuncAux(att, p[0], p[1]), t, y), y)

    z, stats = odeint_adjoint(func_p, state0, params, 0.0, cfg.time, opts,
                              SolverOptions.from_config(cfg, adjoint=True))
    return (z.float() if lowp else z), stats
