"""Public ODE solve API (PyTorch port of ``solvers/api.py``): method
dispatch and the continuous-adjoint gradient.

* :func:`odeint` solves with the fixed-grid (euler, midpoint, heun2, rk4)
  or adaptive (dopri5, adaptive_heun, bosh3) methods; its gradient is
  autograd through the fixed steps, or the adaptive solver's discrete
  adjoint.
* :func:`odeint_adjoint` is the continuous adjoint (the reference's
  ``odeint_adjoint``): the forward solve keeps no graph, and the backward
  integrates the augmented state (y, a, p̄) back from t1 with its own
  method, step size and tolerances.

The Adams multistep pair and the Chebyshev solve raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from graph_neural_pde_tpu_torch.solvers.adaptive import odeint_adaptive
from graph_neural_pde_tpu_torch.solvers.fixed import odeint_fixed
from graph_neural_pde_tpu_torch.solvers.tableaus import TABLEAUS, Tableau

FIXED_METHODS = ("euler", "midpoint", "heun2", "rk4")
ADAPTIVE_METHODS = ("dopri5", "adaptive_heun", "bosh3")


@dataclass(frozen=True)
class SolverOptions:
    method: str = "dopri5"
    rtol: float = 1e-9          # reference convention: atol > rtol
    atol: float = 1e-7
    step_size: float = 1.0      # fixed-grid methods
    max_steps: int = 1000       # adaptive trip bound (≈ max_nfe / evals_per_step)
    remat: bool = False         # checkpoint fixed-grid steps in backprop

    @property
    def tableau(self) -> Tableau:
        return TABLEAUS[self.method]

    @staticmethod
    def from_config(cfg, adjoint: bool = False) -> "SolverOptions":
        """Build from a Config, applying the reference's max_nfe → trip
        bound; ``adjoint`` gives the continuous adjoint's backward solve
        (adjoint_method, adjoint_step_size, tol_scale_adjoint), which never
        checkpoints its steps."""
        method = cfg.adjoint_method if adjoint else cfg.method
        evals = (TABLEAUS[method].evals_per_step
                 if method in TABLEAUS else 2)
        return SolverOptions(
            method=method,
            rtol=cfg.rtol_adjoint if adjoint else cfg.rtol,
            atol=cfg.atol_adjoint if adjoint else cfg.atol,
            step_size=cfg.adjoint_step_size if adjoint else cfg.step_size,
            max_steps=max(cfg.max_nfe // max(evals, 1), 4),
            remat=cfg.remat and not adjoint)


def check_method(method: str) -> None:
    """Raise for the solver methods the port does not have yet."""
    if method in ADAPTIVE_METHODS or method in FIXED_METHODS:
        return
    if method == "cheby":
        raise NotImplementedError(
            "method 'cheby': ROADMAP Queue 1 slice 5 item 17 "
            "(solvers/chebyshev.py)")
    if method in ("explicit_adams", "implicit_adams"):
        raise NotImplementedError(
            f"method {method!r}: ROADMAP Queue 1 slice 5 item 17 "
            "(solvers/multistep.py)")
    raise ValueError(f"unknown solver method '{method}'")


def odeint(func: Callable, y0, t0: float, t1: float, opts: SolverOptions):
    """Integrate dy/dt = func(t, y) from t0 to t1; ``y0`` is a tensor or a
    tuple of tensors. Returns (y(t1), stats) with stats = {nfe, accepted,
    rejected, hit_max_steps, t_final}."""
    check_method(opts.method)
    if opts.method in FIXED_METHODS:
        return odeint_fixed(func, opts.tableau, float(t0), float(t1),
                            opts.step_size, y0, remat=opts.remat)
    return odeint_adaptive(func, opts.tableau, float(t0), float(t1),
                           opts.rtol, opts.atol, opts.max_steps, y0)


@dataclass
class _AdjointRun:
    """What the adjoint's forward hands its backward, besides tensors.
    ``stats`` is the dict the caller gets back; the backward adds
    ``bwd_nfe``, ``bwd_accepted`` and ``bwd_rejected`` to it."""
    func: Callable
    opts: SolverOptions
    adjoint_opts: SolverOptions
    t0: float
    t1: float
    stats: dict = field(default_factory=dict)


class _Adjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, run: _AdjointRun, y0, *params):
        y1, stats = odeint(lambda t, y: run.func(t, y, params), y0, run.t0,
                           run.t1, run.opts)
        run.stats.update(stats)
        ctx.run = run
        ctx.save_for_backward(y1, *params)
        return y1

    @staticmethod
    def backward(ctx, ct):
        """Solve the augmented adjoint ODE from t1 back to t0: with
        t = t1 − s for s in [0, t1 − t0],

            dy/ds = −f(t, y),   da/ds = aᵀ ∂f/∂y,   dp̄/ds = aᵀ ∂f/∂p

        from (y(t1), ct, 0). Every parameter tensor carries its p̄, also one
        the RHS does not read (its p̄ stays 0), since the error norm counts
        every element of the state."""
        run = ctx.run
        y1, *params = ctx.saved_tensors
        t1 = torch.tensor(run.t1, dtype=torch.float32, device=y1.device)

        def aug_func(s, state):
            y, a = state[0], state[1]
            with torch.enable_grad():
                y_ = y.detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(True) for p in params]
                f = run.func(t1 - s, y_, ps)
                grads = torch.autograd.grad(f, [y_, *ps], a,
                                            allow_unused=True)
            p_dots = tuple(torch.zeros_like(p) if gp is None else gp
                           for p, gp in zip(params, grads[1:]))
            return (-f.detach(), grads[0]) + p_dots

        state0 = (y1, ct.contiguous()) + tuple(torch.zeros_like(p)
                                               for p in params)
        state, bstats = odeint(aug_func, state0, 0.0, run.t1 - run.t0,
                               run.adjoint_opts)
        run.stats.update(bwd_nfe=bstats["nfe"],
                         bwd_accepted=bstats["accepted"],
                         bwd_rejected=bstats["rejected"])
        return (None, state[1]) + tuple(state[2:])


def odeint_adjoint(func: Callable, y0: torch.Tensor,
                   params: Sequence[torch.Tensor], t0: float, t1: float,
                   opts: SolverOptions, adjoint_opts: SolverOptions):
    """Integrate dy/dt = func(t, y, params) from t0 to t1 with the
    continuous-adjoint gradient (the JAX package's ``_odeint_adjoint``,
    ``api.py:103-151``). ``params`` are the tensors the RHS reads that
    gradients flow to. Returns (y(t1), stats); after ``backward`` the stats
    dict also holds the backward solve's ``bwd_nfe``, ``bwd_accepted`` and
    ``bwd_rejected``."""
    check_method(adjoint_opts.method)
    run = _AdjointRun(func, opts, adjoint_opts, float(t0), float(t1))
    y1 = _Adjoint.apply(run, y0, *params)
    return y1, run.stats
