"""Time integration.

Counterpart of the single-member core of :mod:`jaxstream.stepping`.
PyTorch runs eagerly, so :func:`integrate` is a Python loop with the
same operation order as the JAX package's ``fori_loop`` (one step, then
one sequential ``t + dt`` add).  Schemes work on dicts of tensors.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["ssprk3_step", "make_stepper", "integrate", "SCHEMES"]


def _map(fn, *trees):
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _axpy(y, dt, k):
    return _map(lambda a, b: a + dt * b, y, k)


def ssprk3_step(rhs: Callable, y, t, dt):
    """Shu-Osher strong-stability-preserving RK3."""
    y1 = _axpy(y, dt, rhs(y, t))
    y2 = _map(lambda a, b: 0.75 * a + 0.25 * b, y,
              _axpy(y1, dt, rhs(y1, t + dt)))
    y3 = _axpy(y2, dt, rhs(y2, t + 0.5 * dt))
    return _map(lambda a, b: (a + 2.0 * b) / 3.0, y, y3)


SCHEMES = {"ssprk3": ssprk3_step}


def make_stepper(rhs: Callable, dt: float, scheme: str = "ssprk3") -> Callable:
    """``step(y, t) -> y_next``."""
    if scheme not in SCHEMES:
        raise NotImplementedError(
            f"scheme {scheme!r} is not ported yet (ROADMAP queue A item 1, "
            "stepping.py); available: " + ", ".join(SCHEMES))
    stepper = SCHEMES[scheme]

    def step(y, t):
        return stepper(rhs, y, t, dt)

    return step


def integrate(step: Callable, y0, t0: float, nsteps: int, dt: float):
    """Run ``nsteps`` of ``step``; returns ``(y_final, t_final)``."""
    y, t = y0, float(t0)
    for _ in range(int(nsteps)):
        y = step(y, t)
        t = t + dt
    return y, t
