"""Time integration.

Counterpart of the single-member core of :mod:`jaxstream.stepping`.
PyTorch runs eagerly, so :func:`integrate` is a Python loop that steps
the state as the JAX package's ``fori_loop`` does and carries time as
its compiled loop carries it (:func:`time_carry`).  Schemes work on
dicts of tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["ssprk3_step", "make_stepper", "time_carry", "integrate",
           "SCHEMES", "UNROLL"]


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


def time_carry(t):
    """The time-scalar carry: a numpy scalar of the default float type.

    The JAX package carries ``jnp.asarray(t, dtype=float)``: float32,
    or float64 under ``jax_enable_x64``.  The port's counterpart of that
    switch is ``torch.get_default_dtype()`` (float32 unless the caller
    sets float64).  The carry stays on the host, so the loop adds no
    device operation per step.
    """
    if torch.get_default_dtype() == torch.float64:
        return np.float64(t)
    return np.float32(t)


#: Steps per iteration of the JAX package's compiled ``integrate`` loop
#: (its default ``unroll``), which sets how it carries time.
UNROLL = 4


def integrate(step: Callable, y0, t0: float, nsteps: int, dt: float):
    """Run ``nsteps`` of ``step``; returns ``(y_final, t_final)``.

    Time is carried as the JAX package's compiled ``integrate`` carries
    it, bit for bit.  That loop runs :data:`UNROLL` steps per iteration,
    and XLA folds the iteration's constant ``+ dt`` adds into one add of
    their running sum: the k-th step of an iteration sees ``t + s_k``
    with ``s_k = dt + ... + dt`` (k terms, rounded in the carry's type),
    and the iteration ends at ``t + s_UNROLL``.  The ``nsteps % UNROLL``
    remaining steps add ``dt`` one at a time.
    """
    t = time_carry(t0)
    d = t.dtype.type(dt)
    sums = [t.dtype.type(0.0)]
    for _ in range(UNROLL):
        sums.append(sums[-1] + d)
    y = y0
    for _ in range(int(nsteps) // UNROLL):
        for k in range(UNROLL):
            y = step(y, t + sums[k] if k else t)
        t = t + sums[UNROLL]
    for _ in range(int(nsteps) % UNROLL):
        y = step(y, t)
        t = t + d
    return y, t
