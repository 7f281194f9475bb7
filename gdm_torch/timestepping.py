"""Explicit Runge-Kutta time stepping + DiscreteTime.

Port of gdm/timestepping.py.  Replicates the semantics of
dealii::TimeStepping::ExplicitRungeKutta (RK_CLASSIC_FOURTH_ORDER etc.)
and dealii::DiscreteTime used by the reference time loops: the step size
is the requested delta_t except for the final step, which is shortened
to land exactly on end_t.

The state ``y`` is a tensor or a tuple of tensors (gdm's pytree, in the
two forms gdm's callers use), and ``f(t, y)`` returns the same
structure.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    a: tuple  # lower-triangular rows, a[i] has i entries
    b: tuple
    c: tuple


# dealii::TimeStepping tableaux (time_stepping.templates.h)
FORWARD_EULER = ButcherTableau(a=(), b=(1.0,), c=(0.0,))
RK_THIRD_ORDER = ButcherTableau(
    a=((0.5,), (-1.0, 2.0)),
    b=(1 / 6, 2 / 3, 1 / 6),
    c=(0.0, 0.5, 1.0),
)
RK_CLASSIC_FOURTH_ORDER = ButcherTableau(
    a=((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
    c=(0.0, 0.5, 0.5, 1.0),
)

TABLEAUX = {
    "FORWARD_EULER": FORWARD_EULER,
    "RK_THIRD_ORDER": RK_THIRD_ORDER,
    "RK_CLASSIC_FOURTH_ORDER": RK_CLASSIC_FOURTH_ORDER,
}


def rk_step(f, t, dt, y, tableau: ButcherTableau = RK_CLASSIC_FOURTH_ORDER):
    """One explicit RK step: returns y_{n+1} (new tensors; y is not
    modified), a tensor for a tensor ``y`` and a tuple for a tuple."""
    if isinstance(y, torch.Tensor):
        return rk_step(lambda t, yy: (f(t, yy[0]),), t, dt, (y,),
                       tableau)[0]
    ks = []
    for i, ci in enumerate(tableau.c):
        yi = y
        for j, aij in enumerate(tableau.a[i - 1] if i > 0 else ()):
            if aij != 0.0:
                yi = tuple(yy + dt * aij * kk for yy, kk in zip(yi, ks[j]))
        ks.append(f(t + ci * dt, yi))
    out = y
    for bi, ki in zip(tableau.b, ks):
        if bi != 0.0:
            out = tuple(yy + dt * bi * kk for yy, kk in zip(out, ki))
    return out


class DiscreteTime:
    """Replica of dealii::DiscreteTime for fixed desired step size."""

    def __init__(self, start: float, end: float, desired_step: float):
        self.start = float(start)
        self.end = float(end)
        self.desired = float(desired_step)
        self.t = float(start)

    def is_at_end(self) -> bool:
        return self.t >= self.end - 1e-12 * max(1.0, abs(self.end))

    def get_current_time(self) -> float:
        return self.t

    def get_next_step_size(self) -> float:
        step = min(self.desired, self.end - self.t)
        # snap to end if the leftover after a full step would be negligible
        if self.end - (self.t + step) < 1e-12 * max(1.0, abs(self.end)):
            step = self.end - self.t
        return step

    def advance_time(self):
        self.t = self.t + self.get_next_step_size()
        if abs(self.t - self.end) < 1e-12 * max(1.0, abs(self.end)):
            self.t = self.end


def time_loop(f, y0, start, end, desired_step, tableau=RK_CLASSIC_FOURTH_ORDER,
              callback=None, post_step=None):
    """Run the reference-style explicit time loop.

    callback(time, y) is invoked at t=start and after every step
    (matching the postprocess cadence of the reference problem drivers).
    post_step(y) (e.g. constraints.distribute) is applied after each step.
    """
    time = DiscreteTime(start, end, desired_step)
    y = y0
    if callback is not None:
        callback(time.get_current_time(), y)
    while not time.is_at_end():
        t, dt = time.get_current_time(), time.get_next_step_size()
        y = rk_step(f, t, dt, y, tableau)
        if post_step is not None:
            y = post_step(y)
        if callback is not None:
            callback(t + dt, y)
        time.advance_time()
    return y
