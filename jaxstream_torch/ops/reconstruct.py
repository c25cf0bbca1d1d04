"""Slope-limited piecewise-linear (PLR) face states.

Counterpart of :mod:`jaxstream.ops.reconstruct` (PPM comes later),
axis-agnostic over halo-extended tensors so one code path serves the
x- and y-direction fluxes.  Same operations in the same order as the
JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["slope", "plr_face_states", "LIMITERS"]


def _pos(x):
    return torch.clamp(x, min=0.0)


def _neg(x):
    return torch.clamp(x, max=0.0)


def _slope_none(dqm, dqp):
    return 0.5 * (dqm + dqp)


def _slope_minmod(dqm, dqp):
    return _pos(torch.minimum(dqm, dqp)) + _neg(torch.maximum(dqm, dqp))


def _slope_mc(dqm, dqp):
    # Monotonized-central, sign-free form: minmod((dqm+dqp)/2, 2 dqm,
    # 2 dqp) = max(0, min3) + min(0, max3).
    a = 0.5 * (dqm + dqp)
    b = 2.0 * dqm
    c = 2.0 * dqp
    return (_pos(torch.minimum(torch.minimum(a, b), c))
            + _neg(torch.maximum(torch.maximum(a, b), c)))


LIMITERS = {
    "none": _slope_none,
    "minmod": _slope_minmod,
    "mc": _slope_mc,
}


def _sl(arr, lo, hi, axis):
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(lo, hi)
    return arr[tuple(idx)]


def slope(q, axis: int, limiter: str = "mc"):
    """Limited slope for cells 1..len-2 along ``axis`` (shrinks by 2)."""
    lim = LIMITERS[limiter]
    qm = _sl(q, 0, -2, axis)
    qc = _sl(q, 1, -1, axis)
    qp = _sl(q, 2, None, axis)
    return lim(qc - qm, qp - qc)


def plr_face_states(q, axis: int, h: int, n: int, limiter: str = "mc"):
    """Left/right states at the n+1 interior-bounding faces along ``axis``.

    ``q`` is extended along ``axis`` (length n + 2h, h >= 2).  Face i
    (i = h..h+n) separates cells i-1 and i; returns ``(qL, qR)``, each
    of length n+1 along ``axis``.
    """
    if h < 2:
        raise ValueError(f"PLR fluxes need halo >= 2, got halo={h}")
    c1 = _sl(q, h - 1, h + n + 1, axis)
    half = 0.5 * slope(_sl(q, h - 2, h + n + 2, axis), axis, limiter)
    qL = _sl(c1 + half, 0, n + 1, axis)
    qR = _sl(c1 - half, 1, n + 2, axis)
    return qL, qR
