"""One explicit Runge-Kutta step and the quartic dense-output fit (PyTorch
port of ``solvers/rk.py`` and the array helpers of ``tree_math.py``).

A state is a tensor or a tuple of tensors (the continuous adjoint's
augmented state); every helper maps over the tuple. The arithmetic is
written in the JAX package's order (``y + (h·b)·k`` per stage, the same
quartic coefficients), with ``t`` and ``h`` as float32 0-d tensors, so that
both packages round alike.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_neural_pde_tpu_torch.solvers.tableaus import Tableau


def tmap(fn: Callable, *states):
    """``fn`` over the leaves of one or more states of the same structure."""
    if isinstance(states[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*states))
    return fn(*states)


def leaves(state) -> tuple:
    return state if isinstance(state, tuple) else (state,)


def axpy(s, x, y):
    """y + s * x"""
    return tmap(lambda xi, yi: yi + s * xi, x, y)


def lincomb(coeffs, xs):
    """sum_i coeffs[i] * xs[i], accumulated left to right."""
    out = tmap(lambda x: coeffs[0] * x, xs[0])
    for c, x in zip(coeffs[1:], xs[1:]):
        out = axpy(c, x, out)
    return out


def rms(x) -> torch.Tensor:
    """Root-mean-square over every element of the state, all leaves
    flattened and concatenated (torchdiffeq's state norm)."""
    ls = [leaf.float() for leaf in leaves(x)]
    sq = sum(torch.sum(leaf * leaf) for leaf in ls)
    return torch.sqrt(sq / sum(leaf.numel() for leaf in ls))


def error_ratio(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    """rms(err / (atol + rtol * max(|y0|, |y1|))) — the accept metric."""
    return rms(tmap(lambda e, a, b: e / (atol + rtol * torch.maximum(
        torch.abs(a), torch.abs(b))), err, y0, y1))


def rk_stages(func: Callable, t0, y0, f0, h, tab: Tableau):
    """The stages of one explicit RK step. Returns (y1, ks) with ``f0`` as
    stage 1."""
    ks = [f0]
    for a, brow in zip(tab.alpha, tab.beta):
        ti = t0 + a * h
        yi = y0
        for bj, kj in zip(brow, ks):
            if bj != 0.0:
                yi = axpy(h * bj, kj, yi)
        ks.append(func(ti, yi))

    y1 = y0
    for cj, kj in zip(tab.c_sol, ks):
        if cj != 0.0:
            y1 = axpy(h * cj, kj, y1)
    return y1, ks


def rk_step(func: Callable, t0, y0, f0, h, tab: Tableau, with_err: bool = True):
    """One explicit RK step. Returns (y1, f1, err, ks).

    ``f0`` is stage 1 (FSAL reuse); ``f1`` is f(t1, y1), the last stage for
    FSAL tableaus. ``err`` is None for non-embedded tableaus or when
    ``with_err`` is False.
    """
    y1, ks = rk_stages(func, t0, y0, f0, h, tab)
    f1 = ks[-1] if tab.fsal else func(t0 + h, y1)

    err = None
    if with_err and tab.c_err is not None:
        nz = [(c, k) for c, k in zip(tab.c_err, ks) if c != 0.0]
        err = lincomb([h * c for c, _ in nz], [k for _, k in nz])
    return y1, f1, err, ks


def interp_fit(y0, y1, y_mid, f0, f1, h):
    """Coefficients (c2, c3, c4) of p(x) = y0 + h f0 x + c2 x² + c3 x³ + c4 x⁴
    with p(0)=y0, p(1)=y1, p(1/2)=y_mid, p'(0)=h f0, p'(1)=h f1."""
    def fit(y0, y1, y_mid, f0, f1):
        A = y1 - y0 - h * f0
        B = h * (f1 - f0)
        C = 16.0 * y_mid - 16.0 * y0 - 8.0 * h * f0
        return (-5.0 * A + B + C, 14.0 * A - 3.0 * B - 2.0 * C,
                C - 8.0 * A + 2.0 * B)

    if isinstance(y0, tuple):
        per_leaf = [fit(*a) for a in zip(y0, y1, y_mid, f0, f1)]
        return tuple(tuple(c[i] for c in per_leaf) for i in range(3))
    return fit(y0, y1, y_mid, f0, f1)


def interp_eval(y0, f0, coeffs, h, x):
    """Evaluate the fitted quartic at relative position x in [0, 1]."""
    c2, c3, c4 = coeffs
    return tmap(lambda y0, f0, c2, c3, c4:
                y0 + x * (h * f0 + x * (c2 + x * (c3 + x * c4))),
                y0, f0, c2, c3, c4)


def y_mid_from_stages(y0, ks, h, tab: Tableau):
    """Dense-output midpoint y(t0 + h/2) from the stage derivatives."""
    nz = [(c, k) for c, k in zip(tab.c_mid, ks) if c != 0.0]
    return axpy(1.0, lincomb([h * c for c, _ in nz], [k for _, k in nz]), y0)


def hermite_mid(y0, y1, f0, f1, h):
    """Cubic-Hermite midpoint for tableaus without c_mid."""
    return tmap(lambda y0, y1, f0, f1: 0.5 * (y0 + y1) + 0.125 * h * (f0 - f1),
                y0, y1, f0, f1)
