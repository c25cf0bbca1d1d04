"""Slope-limited piecewise-linear (PLR) and piecewise-parabolic (PPM)
face states.

Counterpart of :mod:`jaxstream.ops.reconstruct` and of the kernels'
``pick_recon`` (``jaxstream/ops/pallas/swe_rhs.py``), axis-agnostic over
halo-extended tensors so one code path serves the x- and y-direction
fluxes.  Same operations in the same order as the JAX package.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["slope", "plr_face_states", "ppm_face_states", "face_states",
           "pick_recon", "LIMITERS", "SCHEMES"]

#: The reconstructions: PLR (with a limiter of :data:`LIMITERS`) and PPM.
SCHEMES = ("plr", "ppm")


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


def _slope_vanleer(dqm, dqp):
    # 1e-300 rounds to 0 in float32 (as in the JAX package): the add
    # stays, so the signed zeros agree with it.
    prod = dqm * dqp
    return torch.where(prod > 0, 2.0 * prod / (dqm + dqp + 1e-300), 0.0)


def _slope_mc_sign(dqm, dqp):
    # The sign() form of MC (equal to _slope_mc).
    sgn = 0.5 * (torch.sign(dqm) + torch.sign(dqp))
    mag = torch.minimum(
        0.5 * torch.abs(dqm + dqp),
        2.0 * torch.minimum(torch.abs(dqm), torch.abs(dqp)))
    return sgn * mag


LIMITERS = {
    "none": _slope_none,
    "minmod": _slope_minmod,
    "mc": _slope_mc,
    "mc_sign": _slope_mc_sign,
    "vanleer": _slope_vanleer,
}


def _sl(arr, lo, hi, axis):
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(lo, hi)
    return arr[tuple(idx)]


def slope(q, axis: int, limiter: str = "mc", slope_dtype=None):
    """Limited slope for cells 1..len-2 along ``axis`` (shrinks by 2).

    ``slope_dtype`` (the stage precision policy, e.g. ``torch.bfloat16``):
    the cell differences are formed in ``q``'s dtype and cast to it, so
    the limiter algebra runs in that dtype.  ``None`` is the plain
    path."""
    lim = LIMITERS[limiter]
    qm = _sl(q, 0, -2, axis)
    qc = _sl(q, 1, -1, axis)
    qp = _sl(q, 2, None, axis)
    if slope_dtype is None:
        return lim(qc - qm, qp - qc)
    return lim((qc - qm).to(slope_dtype), (qp - qc).to(slope_dtype))


def plr_face_states(q, axis: int, h: int, n: int, limiter: str = "mc",
                    slope_dtype=None):
    """Left/right states at the n+1 interior-bounding faces along ``axis``.

    ``q`` is extended along ``axis`` (length n + 2h, h >= 2).  Face i
    (i = h..h+n) separates cells i-1 and i; returns ``(qL, qR)``, each
    of length n+1 along ``axis``.  ``slope_dtype``: the limiter algebra
    and the half-slope in that dtype, widened back to ``q``'s before it
    is added to the cell value (see :func:`slope`).
    """
    if h < 2:
        raise ValueError(f"PLR fluxes need halo >= 2, got halo={h}")
    c1 = _sl(q, h - 1, h + n + 1, axis)
    half = 0.5 * slope(_sl(q, h - 2, h + n + 2, axis), axis, limiter,
                       slope_dtype)
    if slope_dtype is not None:
        half = half.to(q.dtype)
    qL = _sl(c1 + half, 0, n + 1, axis)
    qR = _sl(c1 - half, 1, n + 2, axis)
    return qL, qR


def ppm_face_states(q, axis: int, h: int, n: int):
    """PPM (Colella-Woodward) face states at the n+1 faces along ``axis``.

    Needs h >= 3: the edge value of face i reads cells i-2 .. i+1, and
    face i's states the parabolas of cells i-1 and i.  The parabola of
    each upwind cell is limited as CW84 eq. 1.10: flattened at a local
    extremum, clipped where it overshoots.  Returns ``(qL, qR)``.
    """
    if h < 3:
        raise ValueError(f"PPM needs halo >= 3, got {h}")

    # Edge value at face i: 7/12 (q_{i-1}+q_i) - 1/12 (q_{i-2}+q_{i+1}),
    # for faces h-1 .. h+n+1 (n+3 faces): cells h-1..h+n get both edges.
    qm2 = _sl(q, h - 3, h + n, axis)
    qm1 = _sl(q, h - 2, h + n + 1, axis)
    qp0 = _sl(q, h - 1, h + n + 2, axis)
    qp1 = _sl(q, h, h + n + 3, axis)
    edge = (7.0 / 12.0) * (qm1 + qp0) - (1.0 / 12.0) * (qm2 + qp1)

    ql_c = _sl(edge, 0, n + 2, axis)
    qr_c = _sl(edge, 1, n + 3, axis)
    qc = _sl(q, h - 1, h + n + 1, axis)

    # 1) A cell at a local extremum w.r.t. its edges is flattened.
    extremum = (qr_c - qc) * (qc - ql_c) <= 0
    ql_c = torch.where(extremum, qc, ql_c)
    qr_c = torch.where(extremum, qc, qr_c)
    # 2) Overshooting parabolas are clipped (the second clip reads the
    # first's result).
    dq = qr_c - ql_c
    q6 = 6.0 * (qc - 0.5 * (ql_c + qr_c))
    ql_c = torch.where(dq * q6 > dq * dq, 3.0 * qc - 2.0 * qr_c, ql_c)
    qr_c = torch.where(-(dq * dq) > dq * q6, 3.0 * qc - 2.0 * ql_c, qr_c)

    # Face i: the right edge of cell i-1 (qL), the left edge of cell i.
    qL = _sl(qr_c, 0, n + 1, axis)
    qR = _sl(ql_c, 1, n + 2, axis)
    return qL, qR


def face_states(q, axis: int, h: int, n: int, scheme: str = "plr",
                limiter: str = "mc"):
    """``(qL, qR)`` of ``scheme``: :func:`ppm_face_states` for ``"ppm"``,
    else :func:`plr_face_states` with ``limiter`` (the JAX package's
    rule)."""
    if scheme == "ppm":
        return ppm_face_states(q, axis, h, n)
    return plr_face_states(q, axis, h, n, limiter)


def pick_recon(scheme: str, halo: int, n: int, limiter: str):
    """The kernels' face-state reconstruction ``recon(q, axis) -> (qL,
    qR)`` (``jaxstream/ops/pallas/swe_rhs.py``'s ``pick_recon``): PLR
    with ``limiter`` by default, PPM for ``scheme="ppm"``."""
    return functools.partial(face_states, h=halo, n=n, scheme=scheme,
                             limiter=limiter)
