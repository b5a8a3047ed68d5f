"""Fixed-grid ODE integration (PyTorch port of ``solvers/fixed.py``):
euler, midpoint, heun2 and rk4 on torchdiffeq's grid.

The grid is t0 + k·step for k = 0..ceil((t1 - t0)/step), with the last
point set to t1, so the last step is shortened and the step count and NFE
match torchdiffeq's (and the JAX package's). Grid points are float32 and
each step's dt is the float32 difference of two of them, as in the JAX
scan. Gradients flow by autograd through the steps; the state may be a
tuple of tensors (the continuous adjoint's augmented state).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from graph_neural_pde_tpu_torch.solvers.rk import leaves, rk_stages
from graph_neural_pde_tpu_torch.solvers.tableaus import Tableau


def time_grid(t0: float, t1: float, step_size: float):
    """torchdiffeq-compatible fixed grid (python floats)."""
    niters = int(math.ceil((t1 - t0) / step_size + 1.0 - 1e-12))
    niters = max(niters, 2)
    ts = [t0 + i * step_size for i in range(niters)]
    ts[-1] = t1
    return ts


def odeint_fixed(func: Callable, tab: Tableau, t0: float, t1: float,
                 step_size: float, y0):
    """Integrate y' = func(t, y) from t0 to t1 on the fixed grid. Returns
    (y1, stats) with the adaptive solver's stats keys."""
    ts = time_grid(t0, t1, step_size)
    t_arr = torch.tensor(ts, dtype=torch.float32,
                         device=leaves(y0)[0].device)
    dt_arr = t_arr[1:] - t_arr[:-1]
    n_steps = len(ts) - 1
    y = y0
    for i in range(n_steps):
        t, dt = t_arr[i], dt_arr[i]
        y, _ks = rk_stages(func, t, y, func(t, y), dt, tab)
    stats = {"nfe": n_steps * tab.num_stages, "accepted": n_steps,
             "rejected": 0, "hit_max_steps": False, "t_final": float(t1)}
    return y, stats
