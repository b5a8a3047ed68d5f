"""ODE blocks: an ODE function, its graph preparation and its solve
(PyTorch port of the ``constant`` and ``attention`` blocks of
``models/blocks.py``).

* constant  — fixed normalised adjacency weights;
* attention — multihead attention computed once per forward at t=0 and
  frozen into the laplacian RHS as its head mean (GRAND-l, every tuned
  config).

The mixed, hard_attention and rewire_attention blocks raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.attention import (TransformerAttention,
                                                         frozen_mean_attention)
from graph_neural_pde_tpu_torch.models.functions import (FuncAux, ODEFunc,
                                                         make_rhs)
from graph_neural_pde_tpu_torch.ops.graph import Graph, get_rw_adj
from graph_neural_pde_tpu_torch.solvers.api import SolverOptions, odeint

BLOCK_NAMES = ("constant", "attention")


def check_block(cfg: Config) -> None:
    if cfg.block in ("mixed", "hard_attention"):
        raise NotImplementedError(
            f"block {cfg.block!r}: ROADMAP Queue 1 slice 2 item 11")
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
    attention layer for the attention block."""

    def __init__(self, cfg: Config, in_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_block(cfg)
        self.func = ODEFunc(cfg)
        if cfg.block == "attention":
            self.att = TransformerAttention(cfg, in_dim, generator=generator)


def build_aux(block: ODEBlock, cfg: Config, g: Graph,
              x: torch.Tensor) -> FuncAux:
    """Per-forward constants: the frozen head-mean attention (attention
    block) and the detached source state x0."""
    x0 = x.detach()   # set_x0 detaches (base_classes.py:52-54)
    if cfg.block == "constant":
        return FuncAux(attention=None, x0=x0, edge_weight=g.weight)
    att = frozen_mean_attention(block.att, cfg, x, g, edge_weight=g.weight)
    return FuncAux(attention=att, x0=x0, edge_weight=g.weight)


def block_forward(block: ODEBlock, cfg: Config, g: Graph, x: torch.Tensor,
                  spmm_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Solve the IVP over [0, T] with cfg.method. Returns (z, stats).
    Differentiable (discrete adjoint) when autograd is enabled."""
    aux = build_aux(block, cfg, g, x)
    rhs = make_rhs(cfg, g, spmm_fn=spmm_fn)

    def func(t, y):
        return rhs(block.func, aux, t, y)

    return odeint(func, x, 0.0, cfg.time, SolverOptions.from_config(cfg),
                  adjoint=cfg.adjoint)
