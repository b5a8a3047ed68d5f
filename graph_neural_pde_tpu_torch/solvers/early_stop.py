"""Early-stop test integrator (PyTorch port of the adaptive branch of
``solvers/early_stop.py``).

At test time the IVP is integrated to ``earlystopxT · T``; after every
accepted step the state is decoded and scored, and the snapshot with the
best validation accuracy, with its diffusion time t*, is kept. Inference
only: the whole solve runs under ``torch.no_grad``. The fixed-grid branch
raises ``NotImplementedError`` (ROADMAP Queue 1 slice 1 item 6).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from graph_neural_pde_tpu_torch.solvers.adaptive import (final_interp,
                                                         optimal_step_size,
                                                         select_initial_step)
from graph_neural_pde_tpu_torch.solvers.api import SolverOptions, check_method
from graph_neural_pde_tpu_torch.solvers.rk import error_ratio, rk_step


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
    t0_ = torch.tensor(t0, dtype=torch.float32, device=dev)
    t1_ = torch.tensor(t1, dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    best = [zero, zero, zero, zero]        # train, val, test, time
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
            tr, va, te = evaluate(y1)
            better = va > best[1]
            best = [torch.where(better, new, old)
                    for new, old in zip((tr, va, te, t + h), best)]
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
