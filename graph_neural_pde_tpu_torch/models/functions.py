"""ODE right-hand sides dx/dt = f(x(t), G) (PyTorch port of the laplacian
function of ``models/functions.py``).

``make_rhs`` returns ``rhs(func, aux, t, x)`` where ``func`` holds the
learnable scalars and ``aux`` the per-solve constants. Only the laplacian
function (every tuned GRAND-l config) is ported; the transformer and GAT
functions raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
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
    """An ODE function's scalars as plain tensors, where a solver passes
    them explicitly (the continuous adjoint); the RHS reads them from this
    or from an ``ODEFunc`` alike."""

    alpha_train: torch.Tensor
    beta_train: torch.Tensor


class ODEFunc(nn.Module):
    """alpha_train / beta_train scalars, initialised to 0 (reference
    base_classes.py:87-88)."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.function in ("transformer", "GAT"):
            raise NotImplementedError(
                f"function {cfg.function!r}: ROADMAP Queue 1 slice 3 item 14 "
                "(transformer and GAT RHS)")
        if cfg.function != "laplacian":
            raise ValueError(f"unknown function '{cfg.function}'")
        self.alpha_train = nn.Parameter(torch.zeros(()))
        self.beta_train = nn.Parameter(torch.zeros(()))


def _alpha(cfg: Config, func: ODEFunc) -> torch.Tensor:
    a = func.alpha_train
    return a if cfg.no_alpha_sigmoid else torch.sigmoid(a)


def _source(cfg: Config, func: ODEFunc, f: torch.Tensor, aux: FuncAux):
    if cfg.add_source:
        return f + func.beta_train * aux.x0
    return f


def make_rhs(cfg: Config, g: Graph,
             spmm_fn: Optional[Callable] = None) -> Callable:
    """rhs(func, aux, t, x) = alpha·(A_w x − x) [+ beta·x0] with A_w the
    frozen attention (or the normalised adjacency). ``spmm_fn(x, w)`` is
    the aggregation engine, by default ``ops.spmm.make_spmm(g)``: the CUDA
    kernels on a CUDA graph, their plain versions on a CPU one."""
    if cfg.function != "laplacian":
        raise NotImplementedError(
            f"function {cfg.function!r}: ROADMAP Queue 1 slice 3 item 14")
    if spmm_fn is None:
        spmm_fn = make_spmm(g)

    def rhs(func: ODEFunc, aux: FuncAux, t, x):
        w = aux.attention if aux.attention is not None else aux.edge_weight
        ax = spmm_fn(x, w)
        f = _alpha(cfg, func) * (ax - x)
        return _source(cfg, func, f, aux)

    return rhs
