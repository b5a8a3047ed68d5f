"""Butcher tableaus for the Runge-Kutta solvers (PyTorch port of
``solvers/tableaus.py``, the same published constants: Dormand & Prince
1980; Bogacki & Shampine 1989; the 3/8-rule rk4 torchdiffeq runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Tableau:
    """Explicit (embedded) Runge-Kutta tableau.

    alpha : stage times c_2..c_s (s-1 entries; stage 1 is at t0)
    beta  : lower-triangular stage coefficient rows (row i has i entries)
    c_sol : solution weights b (s entries)
    c_err : b - b_hat error weights (s entries); None => fixed-grid only
    c_mid : dense-output midpoint weights (s entries) or None
    order : convergence order of the solution (controller uses it)
    fsal  : last stage equals f(t1, y1) and can seed the next step
    """

    name: str
    alpha: Tuple[float, ...]
    beta: Tuple[Tuple[float, ...], ...]
    c_sol: Tuple[float, ...]
    order: int
    c_err: Optional[Tuple[float, ...]] = None
    c_mid: Optional[Tuple[float, ...]] = None
    fsal: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.c_sol)

    @property
    def evals_per_step(self) -> int:
        """RHS evaluations per accepted step (FSAL reuses the last stage)."""
        return self.num_stages - 1 if self.fsal else self.num_stages


EULER = Tableau(name="euler", alpha=(), beta=(), c_sol=(1.0,), order=1)

MIDPOINT = Tableau(
    name="midpoint", alpha=(0.5,), beta=((0.5,),), c_sol=(0.0, 1.0), order=2)

# classic Heun / explicit trapezoid (used as a fixed-grid method)
HEUN2 = Tableau(
    name="heun2", alpha=(1.0,), beta=((1.0,),), c_sol=(0.5, 0.5), order=2)

# fourth-order 3/8 rule — the variant torchdiffeq's 'rk4' actually runs
# (rk4_alt_step_func, relied on at the reference's early_stop_solver.py:150-155)
RK4 = Tableau(
    name="rk4",
    alpha=(1.0 / 3.0, 2.0 / 3.0, 1.0),
    beta=((1.0 / 3.0,),
          (-1.0 / 3.0, 1.0),
          (1.0, -1.0, 1.0)),
    c_sol=(1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0),
    order=4)

# adaptive Heun 2(1): embedded euler error estimate
ADAPTIVE_HEUN = Tableau(
    name="adaptive_heun",
    alpha=(1.0,),
    beta=((1.0,),),
    c_sol=(0.5, 0.5),
    c_err=(-0.5, 0.5),   # b - b_hat vs embedded euler: y1 - y_euler = h*(k2 - k1)/2
    order=2)

# Bogacki–Shampine 3(2)
BOSH3 = Tableau(
    name="bosh3",
    alpha=(0.5, 0.75, 1.0),
    beta=((0.5,),
          (0.0, 0.75),
          (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0)),
    c_sol=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    c_err=(2.0 / 9.0 - 7.0 / 24.0, 1.0 / 3.0 - 0.25, 4.0 / 9.0 - 1.0 / 3.0, -0.125),
    fsal=True,
    order=3)

# Dormand–Prince 5(4) with Shampine's dense-output midpoint coefficients
_DP_C_MID = (
    6025192743.0 / 30085553152.0 / 2.0,
    0.0,
    51252292925.0 / 65400821598.0 / 2.0,
    -2691868925.0 / 45128329728.0 / 2.0,
    187940372067.0 / 1594534317056.0 / 2.0,
    -1776094331.0 / 19743644256.0 / 2.0,
    11237099.0 / 235043384.0 / 2.0,
)

DOPRI5 = Tableau(
    name="dopri5",
    alpha=(1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    beta=(
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
         -5103.0 / 18656.0),
        (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
         11.0 / 84.0),
    ),
    c_sol=(35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
           11.0 / 84.0, 0.0),
    c_err=(35.0 / 384.0 - 1951.0 / 21600.0,
           0.0,
           500.0 / 1113.0 - 22642.0 / 50085.0,
           125.0 / 192.0 - 451.0 / 720.0,
           -2187.0 / 6784.0 - -12231.0 / 42400.0,
           11.0 / 84.0 - 649.0 / 6300.0,
           -1.0 / 60.0),
    c_mid=_DP_C_MID,
    fsal=True,
    order=5)


TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "heun2": HEUN2,
    "rk4": RK4,
    "adaptive_heun": ADAPTIVE_HEUN,
    "bosh3": BOSH3,
    "dopri5": DOPRI5,
}
