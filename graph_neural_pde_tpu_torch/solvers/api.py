"""Public ODE solve API (PyTorch port of ``solvers/api.py``, adaptive
methods only).

Fixed-grid methods, the Adams multistep pair and the continuous adjoint
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from graph_neural_pde_tpu_torch.solvers.adaptive import odeint_adaptive
from graph_neural_pde_tpu_torch.solvers.tableaus import TABLEAUS, Tableau

FIXED_METHODS = ("euler", "midpoint", "heun2", "rk4")
ADAPTIVE_METHODS = ("dopri5", "adaptive_heun", "bosh3")


@dataclass(frozen=True)
class SolverOptions:
    method: str = "dopri5"
    rtol: float = 1e-9          # reference convention: atol > rtol
    atol: float = 1e-7
    max_steps: int = 1000       # adaptive trip bound (≈ max_nfe / evals_per_step)

    @property
    def tableau(self) -> Tableau:
        return TABLEAUS[self.method]

    @staticmethod
    def from_config(cfg) -> "SolverOptions":
        """Build from a Config, applying the reference's max_nfe → trip
        bound."""
        evals = (TABLEAUS[cfg.method].evals_per_step
                 if cfg.method in TABLEAUS else 2)
        return SolverOptions(method=cfg.method, rtol=cfg.rtol, atol=cfg.atol,
                             max_steps=max(cfg.max_nfe // max(evals, 1), 4))


def check_method(method: str) -> None:
    """Raise for the solver methods the port does not have yet."""
    if method in ADAPTIVE_METHODS:
        return
    if method in FIXED_METHODS:
        raise NotImplementedError(
            f"method {method!r}: fixed-grid solvers, ROADMAP Queue 1 slice 1 "
            "item 6 (solvers/fixed.py)")
    if method == "cheby":
        raise NotImplementedError(
            "method 'cheby': ROADMAP Queue 1 slice 5 item 17 "
            "(solvers/chebyshev.py)")
    if method in ("explicit_adams", "implicit_adams"):
        raise NotImplementedError(
            f"method {method!r}: ROADMAP Queue 1 slice 5 item 17 "
            "(solvers/multistep.py)")
    raise ValueError(f"unknown solver method '{method}'")


def odeint(func: Callable, y0: torch.Tensor, t0: float, t1: float,
           opts: SolverOptions, *, adjoint: bool = False):
    """Integrate dy/dt = func(t, y) from t0 to t1. Returns (y(t1), stats)
    with stats = {nfe, accepted, rejected, hit_max_steps, t_final}."""
    if adjoint:
        raise NotImplementedError(
            "continuous adjoint: ROADMAP Queue 1 slice 2 item 12")
    check_method(opts.method)
    return odeint_adaptive(func, opts.tableau, float(t0), float(t1),
                           opts.rtol, opts.atol, opts.max_steps, y0)
