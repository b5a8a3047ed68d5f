"""Early-stop test integrator (PyTorch port of the adaptive branch of
``solvers/early_stop.py``).

At test time the IVP is integrated to ``earlystopxT · T``; after every
accepted step the state is decoded and scored, and the snapshot with the
best validation accuracy, with its diffusion time t*, is kept. Inference
only: the whole solve runs under ``torch.no_grad``. Fixed-grid methods
evaluate after every step of their grid (the reference's EarlyStopRK4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from graph_neural_pde_tpu_torch.solvers.adaptive import (final_interp,
                                                         optimal_step_size,
                                                         select_initial_step)
from graph_neural_pde_tpu_torch.solvers.api import (FIXED_METHODS,
                                                    SolverOptions,
                                                    check_method)
from graph_neural_pde_tpu_torch.solvers.fixed import time_grid
from graph_neural_pde_tpu_torch.solvers.rk import (error_ratio, rk_stages,
                                                   rk_step)


class BestSnapshot(NamedTuple):
    train: float
    val: float
    test: float
    time: float


@torch.no_grad()
def odeint_early_stop(func: Callable, y0: torch.Tensor, t0: float, t1: float,
                      opts: SolverOptions, evaluate: Callable,
                      max_test_steps: int = 100):
    """Integrate to t1 evaluating each accepted step.

    ``evaluate(y) -> (train_acc, val_acc, test_acc)`` as 0-d tensors.
    Returns (y(t1), best: BestSnapshot, stats).
    """
    check_method(opts.method)
    tab = opts.tableau
    rtol, atol = opts.rtol, opts.atol
    dev = y0.device
    zero = torch.zeros((), device=dev)
    best = [zero, zero, zero, zero]        # train, val, test, time

    def update_best(best, y, t):
        tr, va, te = evaluate(y)
        better = va > best[1]
        return [torch.where(better, new, old)
                for new, old in zip((tr, va, te, t), best)]

    if opts.method in FIXED_METHODS:
        ts = torch.tensor(time_grid(t0, t1, opts.step_size),
                          dtype=torch.float32, device=dev)
        y = y0
        for t, dt in zip(ts[:-1], ts[1:] - ts[:-1]):
            y, _ks = rk_stages(func, t, y, func(t, y), dt, tab)
            best = update_best(best, y, t + dt)
        n = ts.shape[0] - 1
        stats = {"nfe": n * tab.num_stages, "accepted": n, "rejected": 0,
                 "hit_max_steps": False, "t_final": float(t1)}
        return y, BestSnapshot(*(float(v) for v in best)), stats

    t0_ = torch.tensor(t0, dtype=torch.float32, device=dev)
    t1_ = torch.tensor(t1, dtype=torch.float32, device=dev)
    f = func(t0_, y0)
    h = select_initial_step(func, t0_, y0, f, tab.order - 1, rtol, atol)
    nfe = 2                    # f(t0) and the initial-step probe
    t, y = t0_, y0
    steps = acc = 0
    last = (t0_, torch.ones((), device=dev), y0)
    more = bool(t < t1_)
    while more and steps < max_test_steps:
        y1, f1, err, _ks = rk_step(func, t, y, f, h, tab)
        ratio = error_ratio(err, y, y1, rtol, atol)
        accept_t = ratio <= 1.0
        t_new = torch.where(accept_t, t + h, t)
        accept, more = torch.stack([accept_t, t_new < t1_]).tolist()
        if accept:
            best = update_best(best, y1, t + h)
            last = (t, h, y)
            t, y, f = t_new, y1, f1
            acc += 1
        h = optimal_step_size(h, ratio, tab.order)
        steps += 1
        nfe += tab.evals_per_step

    if acc == 0:
        y_t1 = y0
    else:
        t_la, h_la, y_la = last
        y_t1 = final_interp(func, tab, t_la, torch.clamp_min(h_la, 1e-30),
                            y_la, t1_)
    # if max_test_steps stopped the loop before t1, report the state reached
    y_out = y if more else y_t1
    stats = {"nfe": nfe, "accepted": acc, "rejected": steps - acc,
             "hit_max_steps": bool(more), "t_final": float(t)}
    snap = BestSnapshot(*(float(v) for v in best))
    return y_out, snap, stats
