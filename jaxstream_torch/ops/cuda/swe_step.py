"""The Cartesian fused SSPRK3 stages, their strip router and steppers.

Counterpart of :mod:`jaxstream.ops.pallas.swe_step`.  State is carried
extended (ghosts included, ``h (6, M, M)``, ``v (3, 6, M, M)``) across the
integration, and each SSPRK3 stage

    y_out = a * y0 + b * y_c + (b * dt) * f(y_c)

is one kernel launch that reads the ghost-filled stage state, computes
the whole Cartesian RHS (:func:`~jaxstream_torch.ops.cuda.swe_rhs.
rhs_core_fast`, or :func:`rhs_core` with ``fast=False``) and writes the
combined next-stage state, ghost ring included (``a*y0 + b*y_c`` there).

* :class:`SweStage` (:func:`make_swe_stage_pallas`): CUDA tensors launch
  ``csrc/swe_stage.cu`` (the port of the Pallas kernel
  ``make_swe_stage_pallas``), CPU tensors run :func:`swe_stage_reference`;
  :func:`make_fused_ssprk3_step` steps with three of them and a
  concat-layout halo exchange of h and v before each.
* The in-kernel exchange: :func:`raw_strips` (the strip carry),
  :func:`route_strips` / :func:`make_strip_router` (raw strips -> placed
  ghost blocks, one static gather) and :class:`SweStageInkernel`
  (:func:`make_swe_stage_inkernel`), which fills its ghosts from the
  routed strips and emits the raw strips of its new interior; CUDA
  tensors launch ``csrc/swe_stage_inkernel.cu`` (the port of
  ``make_swe_stage_inkernel``), CPU tensors run
  :func:`swe_stage_inkernel_reference`.
  :func:`make_fused_ssprk3_step_inkernel` steps with three of them.

Shu-Osher coefficients: stage 1 (a=0, b=1), stage 2 (3/4, 1/4), stage 3
(1/3, 2/3); stage 1 takes no y0.  Strip layouts are the JAX package's:
``sn (..., 6, 2, h, n)`` the S/N interior rows, ``we (..., 6, 2, n, h)``
the W/E interior columns; routed ``gsn``/``gwe`` the same shapes, holding
the ghost blocks as placed.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import prod

import torch

from ...geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                      build_connectivity)
from ...parallel.halo import canonicalize_strip, place_strip
from ._launch import _P, _check_tensors, _entry, _ptr
from .swe_rhs import _f32, _SweBase

__all__ = [
    "SSPRK3_COEFFS",
    "SweStage",
    "make_swe_stage_pallas",
    "swe_stage_reference",
    "make_fused_ssprk3_step",
    "raw_strips",
    "route_strips",
    "make_strip_router",
    "SweStageInkernel",
    "make_swe_stage_inkernel",
    "swe_stage_inkernel_reference",
    "make_fused_ssprk3_step_inkernel",
]

#: Shu-Osher SSPRK3 stage coefficients ``(a, b)``: stage k computes
#: ``a*y0 + b*yc + b*dt*L(yc)``.
SSPRK3_COEFFS = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))


class _SweStageBase(_SweBase):
    """Coefficients of one Cartesian SSPRK3 stage ``a*y0 + b*yc +
    b*dt*L(yc)`` and the core it runs (``fast``: :func:`rhs_core_fast`,
    else :func:`rhs_core`)."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, a: float, b: float,
                 scheme: str = "plr", limiter: str = "mc",
                 interpret: bool = False, fast: bool = True, device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, interpret=interpret,
                         device=device)
        self.a, self.b, self.dt = float(a), float(b), float(dt)
        if self.a == 0.0 and self.b != 1.0:
            raise NotImplementedError(
                f"a stage with a == 0 must have b == 1 (SSPRK3 stage 1); "
                f"got b={b!r}")
        self.with_y0 = self.a != 0.0
        self.fast = bool(fast)
        self.fa, self.fb = _f32(self.a), _f32(self.b)
        self.fg = _f32(self.b * self.dt)
        self._kconsts = self._rhs_consts + (self.fa, self.fb, self.fg)

    def _split_args(self, args, n_mid: int, sig: str):
        """``(h0, v0, *rest)``, with ``None`` for stage 1's y0."""
        want = n_mid + (2 if self.with_y0 else 0)
        if len(args) != want:
            raise TypeError(f"stage({sig}) takes {want} arguments, got "
                            f"{len(args)}")
        return tuple(args) if self.with_y0 else (None, None) + tuple(args)

    def _combined(self, frame, y0):
        """``a*y0 + b*frame`` over the whole block (stage 1: the frame)."""
        if y0 is None:
            return frame.clone()
        return self.fa * y0 + self.fb * frame


def swe_stage_reference(stage, *args):
    """The plain PyTorch version of one fused Cartesian stage.

    ``stage`` is a :class:`SweStage`; ``args`` as for calling it.  The
    whole block becomes ``a*y0 + b*yc`` (stage 1: ``yc``), its interior
    that value ``+ b*dt*L(yc)``, as the JAX kernel writes it.  Returns
    ``(h (6, M, M), v (3, 6, M, M))``.
    """
    h0, v0, hc, vc, b_ext = stage._unpack(args)
    n, h = stage.n, stage.halo
    i0, i1 = h, h + n
    dh, dv = stage._core(hc, vc, b_ext, stage.fast)
    out_h = stage._combined(hc, h0)
    out_v = stage._combined(vc, v0)
    out_h[:, i0:i1, i0:i1] = out_h[:, i0:i1, i0:i1] + stage.fg * dh
    out_v[:, :, i0:i1, i0:i1] = (out_v[:, :, i0:i1, i0:i1]
                                 + stage.fg * torch.stack(dv))
    return out_h, out_v


def _stage_kernel():
    """The fused stage kernel: 10 tensor pointers; n, halo, with_y0, fast;
    9 float constants; the stream."""
    return _entry("swe_stage", "swe_stage_f32",
                  [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 9
                  + [_P])


class SweStage(_SweStageBase):
    """One fused Cartesian SSPRK3 stage over extended, ghost-filled state.

    ``a == 0``: ``stage(hc, vc, b_ext)``; else ``stage(h0, v0, hc, vc,
    b_ext)``, all extended (``(6, M, M)`` / ``(3, 6, M, M)``).  Returns
    ``(h, v)`` (see :func:`swe_stage_reference`).  CUDA tensors launch
    ``csrc/swe_stage.cu``; CPU tensors, or ``interpret=True``, run the
    plain version.  There is no other path: a kernel that fails to build
    or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def _unpack(self, args):
        return self._split_args(args, 3, "h0, v0, hc, vc, b_ext"
                                if self.with_y0 else "hc, vc, b_ext")

    def _check(self, h0, v0, hc, vc, b_ext):
        m = self.m
        want = {"hc": (hc, (6, m, m)), "vc": (vc, (3, 6, m, m)),
                "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (6, m, m))
            want["v0"] = (v0, (3, 6, m, m))
        _check_tensors(want, self.device)

    def __call__(self, *args):
        h0, v0, hc, vc, b_ext = self._unpack(args)
        self._check(h0, v0, hc, vc, b_ext)
        if self._plain(hc):
            return swe_stage_reference(self, *args)
        ho = torch.empty_like(hc)
        vo = torch.empty_like(vc)
        rc = _stage_kernel()(
            _ptr(h0), _ptr(v0), hc.data_ptr(), vc.data_ptr(),
            b_ext.data_ptr(), self._xc.data_ptr(), self._xf.data_ptr(),
            self.frames.data_ptr(), ho.data_ptr(), vo.data_ptr(), self.n,
            self.halo, int(self.with_y0), int(self.fast), *self._kconsts,
            self._stream())
        if rc != 0:
            raise RuntimeError(f"swe_stage kernel launch failed: cudaError "
                               f"{rc} (n={self.n}, halo={self.halo})")
        SweStage.launches += 1
        return ho, vo

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return swe_stage_reference(self, *args)


def make_swe_stage_pallas(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                          scheme="plr", limiter="mc", interpret=False,
                          fast=True, device="cuda"):
    """One fused stage with static coefficients ``(a, b)`` (see
    :class:`SweStage`)."""
    return SweStage(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                    scheme=scheme, limiter=limiter, interpret=interpret,
                    fast=fast, device=device)


def make_fused_ssprk3_step(n, halo, dalpha, radius, gravity, omega, dt,
                           exchange, b_ext, scheme="plr", limiter="mc",
                           interpret=False, fast=True):
    """``step(y, t) -> y`` over ``y = {"h": (6, M, M), "v": (3, 6, M, M)}``.

    Per stage ``exchange`` (a halo exchanger over extended tensors,
    leading axes carried) fills h and v, then one fused stage runs; the
    ghosts may be stale on entry.  ``step.exchange`` is the exchanger,
    ``step.stages`` the three :class:`SweStage`.
    """
    stages = [make_swe_stage_pallas(
        n, halo, dalpha, radius, gravity, omega, dt, a, b, scheme=scheme,
        limiter=limiter, interpret=interpret, fast=fast,
        device=b_ext.device) for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

    def step(y, t):
        del t  # the SWE RHS is autonomous
        h0 = exchange(y["h"])
        v0 = exchange(y["v"])
        h1, v1 = stage1(h0, v0, b_ext)
        h2, v2 = stage2(h0, v0, exchange(h1), exchange(v1), b_ext)
        h3, v3 = stage3(h0, v0, exchange(h2), exchange(v2), b_ext)
        return {"h": h3, "v": v3}

    step.exchange = exchange
    step.stages = stages
    return step


# ---------------------------------------------------------------------------
# In-kernel exchange: the strip carry and its router
# ---------------------------------------------------------------------------


def raw_strips(field, n: int, halo: int):
    """Raw boundary strips of an extended field, the stage's output
    layout: ``sn (..., 6, 2, halo, n)`` the S/N interior rows, ``we (...,
    6, 2, n, halo)`` the W/E interior columns."""
    i0, i1 = halo, halo + n
    sn = torch.stack([field[..., i0:i0 + halo, i0:i1],
                      field[..., i1 - halo:i1, i0:i1]], dim=-3)
    we = torch.stack([field[..., i0:i1, i0:i0 + halo],
                      field[..., i0:i1, i1 - halo:i1]], dim=-3)
    return sn, we


def _route_walk(sn, we):
    """Raw strips -> placed ghost blocks, the JAX package's
    ``route_strips`` walk: per face edge, the neighbour's raw strip in
    canonical frame, reversed along the edge where the pair is, placed.
    Works on any tensors (the router runs it once on indices)."""
    adj = build_connectivity()

    def ghost(f, e):
        link = adj[f][e]
        ne = link.nbr_edge
        if ne in (EDGE_S, EDGE_N):
            raw = sn[..., link.nbr_face, 0 if ne == EDGE_S else 1, :, :]
        else:
            raw = we[..., link.nbr_face, 0 if ne == EDGE_W else 1, :, :]
        s = canonicalize_strip(ne, raw)
        if link.reversed_:
            s = torch.flip(s, dims=[-1])
        return place_strip(e, s)

    gsn = torch.stack([torch.stack([ghost(f, EDGE_S), ghost(f, EDGE_N)],
                                   dim=-3) for f in range(6)], dim=-4)
    gwe = torch.stack([torch.stack([ghost(f, EDGE_W), ghost(f, EDGE_E)],
                                   dim=-3) for f in range(6)], dim=-4)
    return gsn, gwe


@lru_cache(maxsize=None)
def _route_index(n: int, halo: int, leads: tuple) -> torch.Tensor:
    """Source position of every routed ghost value, one ``(sn, we)`` pair
    per entry of ``leads`` (its leading size), sources and outputs each
    laid end to end: ``[sn_0, we_0, sn_1, we_1, ...]`` ->
    ``[gsn_0, gwe_0, gsn_1, gwe_1, ...]``."""
    k = 12 * halo * n
    parts, off = [], 0
    for lead in leads:
        sn = torch.arange(off, off + lead * k).reshape(lead, 6, 2, halo, n)
        we = torch.arange(off + lead * k, off + 2 * lead * k).reshape(
            lead, 6, 2, n, halo)
        gsn, gwe = _route_walk(sn, we)
        parts += [gsn.reshape(-1), gwe.reshape(-1)]
        off += 2 * lead * k
    return torch.cat(parts)


def route_strips(sn, we):
    """Raw strips (:func:`raw_strips`, any leading axes) -> the placed
    ghost tensors ``(gsn, gwe)``: ``gsn[..., f, 0]`` the ``(halo, n)``
    rows of face f's S ghost ``[0:halo, halo:halo+n]``, ``gsn[..., f, 1]``
    the N ghost rows, ``gwe[..., f, 0/1]`` the ``(n, halo)`` W/E ghost
    columns.  One static gather, bitwise the JAX package's walk."""
    halo, n = sn.shape[-2:]
    idx = _route_index(n, halo, (prod(sn.shape[:-4]),)).to(sn.device)
    out = torch.cat([sn.reshape(-1), we.reshape(-1)]).index_select(0, idx)
    gsn, gwe = torch.split(out, (sn.numel(), we.numel()))
    return gsn.view(sn.shape), gwe.view(we.shape)


def make_strip_router(n: int, halo: int, device):
    """``route(sn, we, vsn, vwe) -> (gsn, gwe, vgsn, vgwe)``:
    :func:`route_strips` of the h strips and of the v strips (leading
    component axis 3) in one concatenation and one gather, contiguous
    views out."""
    idx = _route_index(n, halo, (1, 3)).to(device)
    k = 12 * halo * n
    shapes = ((6, 2, halo, n), (6, 2, n, halo), (3, 6, 2, halo, n),
              (3, 6, 2, n, halo))

    def route(sn, we, vsn, vwe):
        flat = torch.cat([sn.reshape(-1), we.reshape(-1), vsn.reshape(-1),
                          vwe.reshape(-1)])
        parts = torch.split(flat.index_select(0, idx), (k, k, 3 * k, 3 * k))
        return tuple(p.view(s) for p, s in zip(parts, shapes))

    return route


# ---------------------------------------------------------------------------
# The in-kernel-exchange stage
# ---------------------------------------------------------------------------


def _fill_ghosts(q, gsn, gwe, n, halo):
    """The stage's frame: the whole input block (its corners too) with the
    four edge ghosts replaced by the routed blocks, as the JAX kernel's
    ``fill_ghosts``; leading axes carried."""
    h = halo
    i0, i1 = h, h + n
    ext = q.clone()
    ext[..., 0:h, i0:i1] = gsn[..., 0, :, :]
    ext[..., i1:i1 + h, i0:i1] = gsn[..., 1, :, :]
    ext[..., i0:i1, 0:h] = gwe[..., 0, :, :]
    ext[..., i0:i1, i1:i1 + h] = gwe[..., 1, :, :]
    return ext


def swe_stage_inkernel_reference(stage, *args):
    """The plain PyTorch version of one in-kernel-exchange stage.

    ``stage`` is a :class:`SweStageInkernel`; ``args`` as for calling it.
    Each field's frame is its input block with the routed edge ghosts
    (:func:`_fill_ghosts`); the whole block becomes ``a*y0 + b*frame``
    (stage 1: the frame), its interior that value ``+ b*dt*L``, so the
    corners carry ``a*y0 + b*(input corner)``.  Returns ``(h, v, sn, we,
    vsn, vwe)``: the new blocks and the raw strips of the new interiors.
    """
    h0, v0, hc, vc, ghosts, b_ext = stage._unpack(args)
    gsn, gwe, vgsn, vgwe = ghosts
    n, h = stage.n, stage.halo
    i0, i1 = h, h + n
    hf = _fill_ghosts(hc, gsn, gwe, n, h)
    vf = _fill_ghosts(vc, vgsn, vgwe, n, h)
    dh, dv = stage._core(hf, vf, b_ext, stage.fast)
    out_h = stage._combined(hf, h0)
    out_v = stage._combined(vf, v0)
    out_h[:, i0:i1, i0:i1] = out_h[:, i0:i1, i0:i1] + stage.fg * dh
    out_v[:, :, i0:i1, i0:i1] = (out_v[:, :, i0:i1, i0:i1]
                                 + stage.fg * torch.stack(dv))
    return (out_h, out_v) + raw_strips(out_h, n, h) + raw_strips(out_v, n, h)


def _inkernel_kernel():
    """The in-kernel-exchange stage kernel: 18 tensor pointers; n, halo,
    with_y0, fast; 9 float constants; the stream."""
    return _entry("swe_stage_inkernel", "swe_stage_inkernel_f32",
                  [_P] * 18 + [ctypes.c_int] * 4 + [ctypes.c_float] * 9
                  + [_P])


class SweStageInkernel(_SweStageBase):
    """One fused Cartesian SSPRK3 stage with the halo fill in the kernel.

    ``a == 0``: ``stage(hc, vc, ghosts, b_ext)``; else ``stage(h0, v0,
    hc, vc, ghosts, b_ext)``; ``ghosts`` is the routed 4-tuple ``(gsn,
    gwe, vgsn, vgwe)`` of :func:`make_strip_router`.  Returns ``(h, v,
    sn, we, vsn, vwe)`` (see :func:`swe_stage_inkernel_reference`).  CUDA
    tensors launch ``csrc/swe_stage_inkernel.cu``; CPU tensors, or
    ``interpret=True``, run the plain version.  There is no other path: a
    kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def _unpack(self, args):
        return self._split_args(args, 4, "h0, v0, hc, vc, ghosts, b_ext"
                                if self.with_y0 else "hc, vc, ghosts, b_ext")

    def _check(self, h0, v0, hc, vc, ghosts, b_ext):
        n, h, m = self.n, self.halo, self.m
        if len(ghosts) != 4:
            raise TypeError("ghosts must be (gsn, gwe, vgsn, vgwe)")
        gsn, gwe, vgsn, vgwe = ghosts
        want = {"hc": (hc, (6, m, m)), "vc": (vc, (3, 6, m, m)),
                "gsn": (gsn, (6, 2, h, n)), "gwe": (gwe, (6, 2, n, h)),
                "vgsn": (vgsn, (3, 6, 2, h, n)),
                "vgwe": (vgwe, (3, 6, 2, n, h)),
                "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (6, m, m))
            want["v0"] = (v0, (3, 6, m, m))
        _check_tensors(want, self.device)

    def __call__(self, *args):
        h0, v0, hc, vc, ghosts, b_ext = self._unpack(args)
        self._check(h0, v0, hc, vc, ghosts, b_ext)
        if self._plain(hc):
            return swe_stage_inkernel_reference(self, *args)
        n, h = self.n, self.halo
        ho = torch.empty_like(hc)
        vo = torch.empty_like(vc)
        sn = hc.new_empty((6, 2, h, n))
        we = hc.new_empty((6, 2, n, h))
        vsn = hc.new_empty((3, 6, 2, h, n))
        vwe = hc.new_empty((3, 6, 2, n, h))
        rc = _inkernel_kernel()(
            _ptr(h0), _ptr(v0), hc.data_ptr(), vc.data_ptr(),
            *[g.data_ptr() for g in ghosts], b_ext.data_ptr(),
            self._xc.data_ptr(), self._xf.data_ptr(), self.frames.data_ptr(),
            ho.data_ptr(), vo.data_ptr(), sn.data_ptr(), we.data_ptr(),
            vsn.data_ptr(), vwe.data_ptr(), n, h, int(self.with_y0),
            int(self.fast), *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"swe_stage_inkernel kernel launch failed: cudaError {rc} "
                f"(n={n}, halo={h})")
        SweStageInkernel.launches += 1
        return ho, vo, sn, we, vsn, vwe

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return swe_stage_inkernel_reference(self, *args)


def make_swe_stage_inkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme="plr", limiter="mc", interpret=False,
                            fast=True, device="cuda"):
    """One in-kernel-exchange stage (see :class:`SweStageInkernel`)."""
    return SweStageInkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme=scheme, limiter=limiter,
                            interpret=interpret, fast=fast, device=device)


def make_fused_ssprk3_step_inkernel(n, halo, dalpha, radius, gravity, omega,
                                    dt, b_ext, scheme="plr", limiter="mc",
                                    interpret=False, fast=True):
    """``step(y, t) -> y``, ``y = {h, v, sh_sn, sh_we, sv_sn, sv_we}``.

    Per stage one strip route (:func:`make_strip_router`) and one
    :class:`SweStageInkernel` launch; initialise the strip carry with
    :func:`raw_strips` (``ShallowWater.extend_state(state,
    with_strips=True)``).  The ghost corners stay stale: the stencils
    never read them.  ``step.route`` is the router, ``step.stages`` the
    three stages.
    """
    route = make_strip_router(n, halo, b_ext.device)
    stages = [make_swe_stage_inkernel(
        n, halo, dalpha, radius, gravity, omega, dt, a, b, scheme=scheme,
        limiter=limiter, interpret=interpret, fast=fast,
        device=b_ext.device) for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

    def step(y, t):
        del t
        h0, v0 = y["h"], y["v"]
        g0 = route(y["sh_sn"], y["sh_we"], y["sv_sn"], y["sv_we"])
        h1, v1, *s1 = stage1(h0, v0, g0, b_ext)
        h2, v2, *s2 = stage2(h0, v0, h1, v1, route(*s1), b_ext)
        h3, v3, *s3 = stage3(h0, v0, h2, v2, route(*s2), b_ext)
        return {"h": h3, "v": v3, "sh_sn": s3[0], "sh_we": s3[1],
                "sv_sn": s3[2], "sv_we": s3[3]}

    step.route = route
    step.stages = stages
    return step
