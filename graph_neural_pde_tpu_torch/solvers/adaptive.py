"""Adaptive embedded Runge-Kutta integration with the discrete-adjoint
gradient (PyTorch port of ``solvers/adaptive.py``).

* Hairer initial-step selection (torchdiffeq ``_select_initial_step``);
* accept when rms(err / (atol + rtol·max|y|)) <= 1;
* controller h' = h · clip(0.9/ratio^(1/order), dfactor, 10) with
  dfactor = 0.2 on rejected and 1 on accepted steps;
* overshoot past t1, then the quartic dense-output fit of the last accepted
  step is evaluated at t1;
* at most ``max_steps`` trial steps, with a ``hit_max_steps`` flag.

The controller runs on the host, one trial step at a time, under
``torch.no_grad``: each trial step costs one host sync to read its accept
decision. ``t``, ``h`` and the error ratio stay float32 0-d tensors on the
state's device, as in the JAX loop, so both packages take the same
accept/reject sequence.

Gradients follow the JAX package's discrete adjoint: they flow through the
accepted steps and the final dense-output interpolation, not through
step-size selection or the accept/reject decisions. When autograd is on, the
solver records (t_i, h_i) of every accepted step and replays those steps
with autograd, from y0, after the controller has finished. The kernels are
deterministic, so the replay reproduces the recorded states.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.solvers.rk import (axpy, error_ratio,
                                                   hermite_mid, interp_eval,
                                                   interp_fit, leaves, rk_step,
                                                   rms, tmap,
                                                   y_mid_from_stages)
from graph_neural_pde_tpu_torch.solvers.tableaus import Tableau


def optimal_step_size(h, ratio, order: int):
    """torchdiffeq ``_optimal_step_size`` on float32 0-d tensors."""
    safety, ifactor, dfactor = 0.9, 10.0, 0.2
    one = torch.ones_like(ratio)
    dfac = torch.where(ratio < 1.0, one, one * dfactor)
    ratio_c = torch.clamp_min(ratio, 1e-10)
    factor = torch.minimum(one * ifactor, torch.maximum(
        safety * ratio_c ** (-1.0 / order), dfac))
    factor = torch.where(ratio == 0.0, one * ifactor, factor)
    return h * factor


def select_initial_step(func, t0, y0, f0, order: int, rtol: float,
                        atol: float):
    """Hairer II.4 starting-step heuristic (one extra RHS evaluation)."""
    def scaled_rms(x, ref):
        return rms(tmap(lambda xi, ri: xi / (atol + rtol * torch.abs(ri)),
                        x, ref))

    d0 = scaled_rms(y0, y0)
    d1 = scaled_rms(f0, y0)
    one = torch.ones_like(d0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), one * 1e-6,
                     0.01 * d0 / torch.clamp_min(d1, 1e-30))
    y1 = axpy(h0, f0, y0)
    f1 = func(t0 + h0, y1)
    d2 = scaled_rms(tmap(torch.sub, f1, f0), y0) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1)


def final_interp(func, tab: Tableau, t_start, h, y_start, t1, f0=None):
    """Redo the last accepted step and evaluate its dense output at t1
    (torchdiffeq's overshoot-and-interpolate). ``f0`` may pass
    f(t_start, y_start) when the caller already has it."""
    if f0 is None:
        f0 = func(t_start, y_start)
    y1, f1, _err, ks = rk_step(func, t_start, y_start, f0, h, tab,
                               with_err=False)
    if tab.c_mid is not None:
        y_mid = y_mid_from_stages(y_start, ks, h, tab)
    else:
        y_mid = hermite_mid(y_start, y1, f0, f1, h)
    coeffs = interp_fit(y_start, y1, y_mid, f0, f1, h)
    x = torch.clamp((t1 - t_start) / h, 0.0, 1.0)
    return interp_eval(y_start, f0, coeffs, h, x)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def odeint_adaptive(func, tab: Tableau, t0: float, t1: float, rtol: float,
                    atol: float, max_steps: int, y0: torch.Tensor):
    """Adaptive solve of dy/dt = func(t, y) from t0 to t1.

    Returns (y(t1), stats) with stats = {nfe, accepted, rejected,
    hit_max_steps, t_final} as host numbers. ``y0`` is a tensor or a tuple
    of tensors. Differentiable in y0 and in whatever ``func`` closes over
    when autograd is enabled.
    """
    dev = leaves(y0)[0].device
    record = torch.is_grad_enabled()
    t0_, t1_ = _f32(t0, dev), _f32(t1, dev)
    with torch.no_grad():
        f = func(t0_, y0)
        h = select_initial_step(func, t0_, y0, f, tab.order - 1, rtol, atol)
        nfe = 2                    # f(t0) and the initial-step probe
        t, y = t0_, y0
        n_acc = n_rej = 0
        t_la, h_la, y_la = t0_, _f32(1.0, dev), y0
        plan = []                       # (t_i, h_i) of accepted steps
        more = bool(t < t1_)
        while more and n_acc + n_rej < max_steps:
            y1, f1, err, _ks = rk_step(func, t, y, f, h, tab)
            ratio = error_ratio(err, y, y1, rtol, atol)
            accept_t = ratio <= 1.0
            t_new = torch.where(accept_t, t + h, t)
            accept, more = torch.stack([accept_t, t_new < t1_]).tolist()
            if accept:
                if record:
                    plan.append((t, h))
                t_la, h_la, y_la = t, h, y
                t, y, f = t_new, y1, f1
                n_acc += 1
            else:
                n_rej += 1
            h = optimal_step_size(h, ratio, tab.order)
            nfe += tab.evals_per_step
        stats = {"nfe": nfe, "accepted": n_acc, "rejected": n_rej,
                 "hit_max_steps": bool(more), "t_final": float(t)}
        if n_acc == 0:
            return y0, stats
        if not record:
            return final_interp(func, tab, t_la, torch.clamp_min(h_la, 1e-30),
                                y_la, t1_), stats

    # discrete adjoint: replay the accepted steps with autograd on
    y = y0
    f = func(plan[0][0], y0)
    for t_i, h_i in plan[:-1]:
        y, f, _err, _ks = rk_step(func, t_i, y, f, h_i, tab, with_err=False)
    t_l, h_l = plan[-1]
    return final_interp(func, tab, t_l, torch.clamp_min(h_l, 1e-30), y, t1_,
                        f0=f), stats
