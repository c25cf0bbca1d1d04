"""Time integration.

Counterpart of :mod:`jaxstream.stepping`.  PyTorch runs
eagerly, so every loop here is a Python loop that steps the state as the
JAX package's compiled loop does and carries time as that loop carries
it (:func:`time_carry`).  Schemes work on dicts of tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["ssprk3_step", "rk4_step", "euler_step", "make_stepper",
           "blocked", "time_carry", "integrate", "integrate_with_history",
           "integrate_with_metrics", "integrate_masked", "vmap_ensemble",
           "jit_integrate",
           "jit_integrate_with_history", "SCHEMES", "UNROLL"]


def _map(fn, *trees):
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _axpy(y, dt, k):
    return _map(lambda a, b: a + dt * b, y, k)


def euler_step(rhs: Callable, y, t, dt):
    return _axpy(y, dt, rhs(y, t))


def ssprk3_step(rhs: Callable, y, t, dt):
    """Shu-Osher strong-stability-preserving RK3."""
    y1 = _axpy(y, dt, rhs(y, t))
    y2 = _map(lambda a, b: 0.75 * a + 0.25 * b, y,
              _axpy(y1, dt, rhs(y1, t + dt)))
    y3 = _axpy(y2, dt, rhs(y2, t + 0.5 * dt))
    return _map(lambda a, b: (a + 2.0 * b) / 3.0, y, y3)


def rk4_step(rhs: Callable, y, t, dt):
    k1 = rhs(y, t)
    k2 = rhs(_axpy(y, 0.5 * dt, k1), t + 0.5 * dt)
    k3 = rhs(_axpy(y, 0.5 * dt, k2), t + 0.5 * dt)
    k4 = rhs(_axpy(y, dt, k3), t + dt)
    return _map(
        lambda a, b1, b2, b3, b4: a + (dt / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4),
        y, k1, k2, k3, k4)


SCHEMES = {"euler": euler_step, "ssprk3": ssprk3_step, "rk4": rk4_step}


def make_stepper(rhs: Callable, dt: float, scheme: str = "ssprk3") -> Callable:
    """``step(y, t) -> y_next``; ``scheme`` one of :data:`SCHEMES`."""
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


def integrate(step: Callable, y0, t0: float, nsteps: int, dt: float,
              unroll: int = UNROLL):
    """Run ``nsteps`` of ``step``; returns ``(y_final, t_final)``.

    Time is carried as the JAX package's compiled ``integrate(...,
    unroll=unroll)`` carries it, bit for bit.  That loop runs ``unroll``
    steps per iteration, and XLA folds the iteration's constant ``+ dt``
    adds into one add of their running sum: the k-th step of an
    iteration sees ``t + s_k`` with ``s_k = dt + ... + dt`` (k terms,
    rounded in the carry's type), and the iteration ends at
    ``t + s_unroll``.  The ``nsteps % unroll`` remaining steps add ``dt``
    one at a time (``unroll=1``: every step does).  Measured bitwise
    against the JAX package for unroll 1-6; from 7 on XLA reassociates
    the chain of adds otherwise, and the times differ in the last place.
    """
    if unroll < 1:
        raise ValueError(f"integrate: unroll must be >= 1, got {unroll}")
    t = time_carry(t0)
    d = t.dtype.type(dt)
    sums = [t.dtype.type(0.0)]
    for _ in range(unroll):
        sums.append(sums[-1] + d)
    y = y0
    for _ in range(int(nsteps) // unroll):
        for k in range(unroll):
            y = step(y, t + sums[k] if k else t)
        t = t + sums[unroll]
    for _ in range(int(nsteps) % unroll):
        y = step(y, t)
        t = t + d
    return y, t


def _add(t, dt):
    """``t + dt`` in the type of a numpy time carry (a plain float
    otherwise)."""
    return t + t.dtype.type(dt) if isinstance(t, np.generic) else t + dt


def blocked(step: Callable, k: int, dt: float) -> Callable:
    """Fuse ``k`` steps into one ``block(y, t) -> y`` (temporal blocking).

    The block advances ``k * dt`` of model time per call with sequential
    ``t + dt`` sub-step times: the same operations in the same order as
    k separate calls, so bitwise the same.  Drive it with
    ``integrate(block, y, t, nblocks, k*dt)``.
    """
    if k < 1:
        raise ValueError(f"blocked: k must be >= 1, got {k}")

    def block(y, t):
        for _ in range(k):
            y = step(y, t)
            t = _add(t, dt)
        return y

    return block


def vmap_ensemble(step: Callable, axes) -> Callable:
    """``vstep(y, t) -> y``: ``step`` over the member axis of a batched
    carry.

    ``axes`` maps each key of the carry to its member axis (e.g.
    ``{"h": 0, "u": 1}`` for the interior state, whose ``u`` component
    axis precedes the member axis).  Each member is stepped on its own
    (contiguous) slice and the results are stacked on the same axes, so
    the batch is bitwise B separate calls: the semantics oracle of
    batched paths, as the JAX package's ``vmap_ensemble``.  The CUDA
    steppers cannot run under ``torch.func.vmap``, so this is a loop.
    ``steps_per_call`` carries over.
    """
    def vstep(y, t):
        sizes = {y[k].shape[axes[k]] for k in y}
        if len(sizes) != 1:
            raise ValueError(f"vmap_ensemble: member axes disagree: "
                             f"{ {k: tuple(v.shape) for k, v in y.items()} }")
        outs = [step({k: v.select(axes[k], b).contiguous()
                      for k, v in y.items()}, t)
                for b in range(sizes.pop())]
        return {k: torch.stack([o[k] for o in outs], dim=axes[k])
                for k in outs[0]}

    spc = getattr(step, "steps_per_call", 1)
    if spc != 1:
        vstep.steps_per_call = spc
    return vstep


def integrate_masked(step: Callable, y0, t0: float, rem0, nsteps: int,
                     dt: float, axes):
    """:func:`integrate` over a member-batched carry with per-member
    run-length masking: the continuous-batching server's segment.

    ``rem0`` is a ``(B,)`` integer tensor of *remaining* stepper calls
    per member, on the carry's device; ``axes`` maps each key of ``y0``
    to its member axis (the :func:`vmap_ensemble` convention).  Every
    iteration steps the WHOLE batch, then ``torch.where`` on each key's
    member axis keeps the new value only for members whose remaining
    count is still positive: a finished member's state is frozen bit for
    bit at its own final step while the rest of the batch drains.  A
    member with ``rem0[i] >= nsteps`` gets ``where(True, new, old)``,
    bitwise the unmasked loop.  ``rem`` decrements on the device, so the
    segment reads nothing back to the host.  Time is one batch-wide
    carry advanced by one ``+ dt`` per iteration (the JAX loop is not
    unrolled).  The segment runs inside a ``torch.profiler``
    ``record_function("serve.segment")`` region, the request span name
    of :mod:`jaxstream_torch.obs.trace`, so a profile lines up with the
    sink's spans.  Returns ``(y, t, rem)``.

    The JAX package's ``sharding=`` argument (GSPMD layout constraints)
    has no counterpart: the port has no GSPMD.
    """
    y = y0
    t = time_carry(t0)
    rem = rem0
    with torch.profiler.record_function("serve.segment"):
        for _ in range(int(nsteps)):
            y2 = step(y, t)
            active = rem > 0
            out = {}
            for k, new in y2.items():
                shape = [1] * new.dim()
                shape[axes[k]] = active.shape[0]
                out[k] = torch.where(active.view(shape), new, y[k])
            y = out
            t = _add(t, dt)
            rem = rem - active.to(rem.dtype)
    return y, t, rem


def _stack(snaps, like):
    """Stack a list of snapshots (tensors, or dicts / tuples / lists of
    them) along a new leading axis; ``like`` gives the structure of an
    empty history."""
    if isinstance(like, torch.Tensor):
        return (torch.stack(snaps) if snaps
                else like.new_empty((0,) + tuple(like.shape)))
    if isinstance(like, dict):
        return {k: _stack([s[k] for s in snaps], v) for k, v in like.items()}
    return type(like)(_stack([s[i] for s in snaps], v)
                      for i, v in enumerate(like))


def integrate_with_history(step: Callable, y0, t0: float, nsteps: int,
                           dt: float, stride: int, snapshot: Callable):
    """As :func:`integrate`, also stacking ``snapshot(y)`` after every
    ``stride`` steps; returns ``(y, t, hist)``, ``hist`` on the
    snapshots' device with a leading axis of ``nsteps // stride``.

    The trailing ``nsteps % stride`` steps run too.  Time advances by one
    ``+ dt`` per step: the JAX package's history loop (a ``fori_loop``
    inside a ``scan``) is not unrolled, and measured in float32 it adds
    sequentially (dt = 0.1 s x 1 000 steps, stride 7: 99.99905).
    """
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    t = time_carry(t0)
    nchunks, rem = divmod(int(nsteps), stride)
    y, snaps = y0, []
    for _ in range(nchunks):
        for _ in range(stride):
            y = step(y, t)
            t = _add(t, dt)
        snaps.append(snapshot(y))
    hist = _stack(snaps, snaps[0] if snaps else snapshot(y0))
    for _ in range(rem):
        y = step(y, t)
        t = _add(t, dt)
    return y, t, hist


def integrate_with_metrics(step: Callable, y0, t0: float, ncalls: int,
                           dt: float, metric_fn: Callable, every: int,
                           n_samples: int, step0,
                           steps_per_call: int = 1,
                           fault_step: int = -1):
    """:func:`integrate` plus a metric stream kept on the device.

    Runs ``ncalls`` stepper calls with one ``+ dt`` per call (the JAX
    package's loop is not unrolled; measured in float32 it adds
    sequentially), the carry untouched by the metrics, and evaluates
    ``metric_fn(y, t) -> (k,)`` after every ``every``-th call, writing it
    into column ``j`` of a ``(k, n_samples)`` buffer preallocated with
    NaN on the metric's device.  Sample ``j`` is taken after call
    ``(j+1) * every``, at global step ``step0 + (j+1) * every *
    steps_per_call``; trailing calls past the last sample still run.
    No write reads a value back to the host: fetch ``buf`` once at the
    end.  Returns ``(y, t, buf)``.

    The buffer takes the first sample's shape, dtype and device; a loop
    too short for any sample evaluates ``metric_fn`` on ``y0`` for them
    (the JAX package traces it abstractly).  ``step0`` is an int or a
    device scalar.  ``fault_step >= 0`` is the testing hook: the sample
    whose global step equals it is overwritten with NaN in the stream
    only, the state untouched.
    """
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    t = time_carry(t0)
    buf = None

    def empty(vec):
        return torch.full((vec.shape[0], n_samples), float("nan"),
                          dtype=vec.dtype, device=vec.device)

    y = y0
    for i in range(int(ncalls)):
        y = step(y, t)
        t = _add(t, dt)
        if (i + 1) % every or (i + 1) // every > n_samples:
            continue
        vec = metric_fn(y, t)
        if fault_step >= 0:
            g = step0 + (i + 1) * steps_per_call
            if isinstance(g, torch.Tensor):
                vec = torch.where(g == fault_step,
                                  torch.full_like(vec, float("nan")), vec)
            elif g == fault_step:
                vec = torch.full_like(vec, float("nan"))
        if buf is None:
            buf = empty(vec)
        buf[:, (i + 1) // every - 1] = vec.to(buf.dtype)
    if buf is None:
        buf = empty(metric_fn(y0, time_carry(t0)))
    return y, t, buf


def jit_integrate(step: Callable, dt: float, unroll: int = UNROLL,
                  donate: bool = True) -> Callable:
    """``run(y0, t0, nsteps) -> (y, t)`` over :func:`integrate`.

    A plain closure: PyTorch runs eagerly, so nothing is compiled, and
    ``donate`` is accepted for the JAX package's signature and ignored
    (the loop keeps no reference to the input state, whose memory is
    freed once the caller drops it).
    """
    del donate

    def run(y0, t0, nsteps):
        return integrate(step, y0, t0, nsteps, dt, unroll=unroll)

    return run


def jit_integrate_with_history(step: Callable, dt: float, stride: int,
                               snapshot: Callable,
                               donate: bool = True) -> Callable:
    """``run(y0, t0, nsteps) -> (y, t, hist)`` over
    :func:`integrate_with_history`; a plain closure, nothing compiled,
    ``donate`` ignored, as :func:`jit_integrate`."""
    del donate

    def run(y0, t0, nsteps):
        return integrate_with_history(step, y0, t0, nsteps, dt, stride,
                                      snapshot)

    return run
