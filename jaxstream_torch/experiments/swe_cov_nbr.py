"""The neighbour-read covariant stage: ghosts from the neighbour faces.

Counterpart of :mod:`jaxstream.experiments.swe_cov_nbr`.  Each SSPRK3
stage takes the whole extended state ``{h (6, M, M), u (2, 6, M, M)}``
and fills every face's ghost ring from its neighbours' interior cells
itself: no strip carry, no router, three launches per step.  The
symmetrized edge normals are computed in the stage too, from both
panels' edge-adjacent rows, so both faces of an edge evaluate the same
expression and their edge fluxes agree bit for bit.

* :func:`_edge_metric_rows`, :func:`_nbr_tables`: the closed-form
  edge-face inverse-metric rows and the placed rotation tables;
* :func:`cov_stage_nbr_reference`: the plain PyTorch version of one
  stage, the JAX kernel's operations in its order;
* :class:`CovStageNbr` (:func:`make_cov_stage_nbr`): CUDA tensors launch
  ``csrc/cov_stage_nbr.cu`` (the port of the Pallas kernel
  ``make_cov_stage_nbr``), CPU tensors run the plain version;
* :func:`make_fused_ssprk3_cov_nbr`: three stages, nothing else.

The edge normals use the closed-form metric at X, Y = +-1, not the
stored face metric of the routers, so the stepper agrees with the
compact and classic ones to float32 roundoff of the metric, not bit for
bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                     build_connectivity, edge_pairs)
from ..ops.cuda._launch import _P, _check_tensors, _entry, _entry_name, _ptr
from ..ops.cuda.swe_cov import (SSPRK3_COEFFS, _EORDER, _OUT_SIGN, _SLOT,
                                _StageBase, _rotation_tables)
from ..ops.cuda.swe_rhs import _fast_frame

__all__ = ["CovStageNbr", "make_cov_stage_nbr", "cov_stage_nbr_reference",
           "make_fused_ssprk3_cov_nbr"]


def _edge_metric_rows(xr, yc, n, halo, radius):
    """``{edge: (m0, m1)}``: closed-form inverse-metric rows at each
    edge's boundary faces, (1, n) in canonical along-edge order.

    Face-independent (the equiangular metric depends only on |X|, |Y|);
    the across-edge coordinate is exactly +-1 and the along-edge one the
    RHS's coordinate row.  (inv_aa, inv_ab) for W/E, (inv_ab, inv_bb) for
    S/N, as the edge-normal velocity takes them.
    """
    h0, h1 = halo, halo + n
    out = {}
    for edge, xe in ((EDGE_W, -1.0), (EDGE_E, 1.0)):
        F = _fast_frame(yc.new_full((1, 1), xe), yc[h0:h1], radius)
        out[edge] = (F["inv_aa"].transpose(0, 1), F["inv_ab"].transpose(0, 1))
    for edge, ye in ((EDGE_S, -1.0), (EDGE_N, 1.0)):
        F = _fast_frame(xr[:, h0:h1], xr.new_full((1, 1), ye), radius)
        out[edge] = (F["inv_ab"], F["inv_bb"])
    return out


def _nbr_tables(grid):
    """``(T_sn, T_we)``: the rotation tables at the ghost slots in placed
    layout, (4, 6, 2, h, n) for the S/N ghost blocks and (4, 6, 2, n, h)
    for W/E, from :func:`_rotation_tables`.  (The JAX package adds the
    anti-identity it reverses with on the MXU; here a reversal is an
    index.)"""
    Tc = _rotation_tables(grid)                     # (4, 6, 4, h, n)
    t_sn = torch.stack([torch.flip(Tc[:, :, EDGE_S], dims=[-2]),
                        Tc[:, :, EDGE_N]], dim=2)
    t_we = torch.stack([
        torch.flip(Tc[:, :, EDGE_W], dims=[-2]).transpose(-1, -2),
        Tc[:, :, EDGE_E].transpose(-1, -2)], dim=2)
    return t_sn.contiguous(), t_we.contiguous()


# ---------------------------------------------------------------------------
# The stage: plain version
# ---------------------------------------------------------------------------


def _depth_flip(strip):
    return torch.flip(strip, dims=[0])


def _raw_block(q, face, edge, n, h):
    """Face ``face``'s interior boundary block at ``edge`` of ``q``
    (6, M, M)."""
    i0, i1 = h, h + n
    if edge == EDGE_S:
        return q[face, i0:i0 + h, i0:i1]
    if edge == EDGE_N:
        return q[face, i1 - h:i1, i0:i1]
    if edge == EDGE_W:
        return q[face, i0:i1, i0:i0 + h]
    return q[face, i0:i1, i1 - h:i1]


def _canon_block(blk, edge):
    """Raw boundary block -> canonical (h, n), depth 0 nearest the edge."""
    if edge == EDGE_S:
        return blk
    if edge == EDGE_N:
        return _depth_flip(blk)
    t = blk.transpose(0, 1)
    return t if edge == EDGE_W else _depth_flip(t)


def _place_block(strip, edge):
    """Canonical (h, n) -> the ghost block's layout at ``edge``."""
    if edge == EDGE_S:
        return _depth_flip(strip)
    if edge == EDGE_N:
        return strip
    if edge == EDGE_W:
        return _depth_flip(strip).transpose(0, 1)
    return strip.transpose(0, 1)


def _store_ghost(frame, edge, placed, n, h):
    i0, i1 = h, h + n
    if edge == EDGE_S:
        frame[0:h, i0:i1] = placed
    elif edge == EDGE_N:
        frame[i1:i1 + h, i0:i1] = placed
    elif edge == EDGE_W:
        frame[i0:i1, 0:h] = placed
    else:
        frame[i0:i1, i1:i1 + h] = placed


def _int_adj_row(q, face, edge, n, h):
    """(n,) interior edge-adjacent row of ``face``, canonical order."""
    i0, i1 = h, h + n
    if edge == EDGE_S:
        return q[face, i0, i0:i1]
    if edge == EDGE_N:
        return q[face, i1 - 1, i0:i1]
    if edge == EDGE_W:
        return q[face, i0:i1, i0]
    return q[face, i0:i1, i1 - 1]


def cov_stage_nbr_reference(stage, *args):
    """The plain PyTorch version of one neighbour-read stage.

    ``stage`` is a :class:`CovStageNbr`; ``args`` as for calling it.  Per
    face: the frame is the whole input block with its edge ghosts taken
    from the neighbours' interiors (canonicalized, reversed where the
    pair is, placed; u rotated by the ghost slot's T entries); the sym
    rows are the pair average of both panels' local edge normals, from
    the edge-adjacent rows and :func:`_edge_metric_rows`, not prescaled.
    The whole block becomes ``a*y0 + b*frame`` (stage 1: the frame), its
    interior that plus ``b*dt*L``: the ghost ring carries ``a*y0 +
    b*ghost`` and the corners the input's, stale, as the JAX kernel
    writes them.  Returns ``(h (6, M, M), u (2, 6, M, M))``.
    """
    h0, u0, hc, uc, b_ext = stage._unpack(args)
    n, h = stage.n, stage.halo
    i0, i1 = h, h + n
    adj = stage.adj
    T_sn, T_we = stage.tables
    met = stage.met

    def ghost_canonical(q, f, e):
        link = adj[f][e]
        c = _canon_block(_raw_block(q, link.nbr_face, link.nbr_edge, n, h),
                         link.nbr_edge)
        return torch.flip(c, dims=[-1]) if link.reversed_ else c

    def t_adj(f, e, j):
        if e == EDGE_S:
            return T_sn[j, f, 0, h - 1]
        if e == EDGE_N:
            return T_sn[j, f, 1, 0]
        if e == EDGE_W:
            return T_we[j, f, 0, :, h - 1]
        return T_we[j, f, 1, :, 0]

    def local_normal(f, e):
        """Face f's own edge-normal velocity at edge e, canonical order."""
        link = adj[f][e]
        raws = []
        for c in range(2):
            row = _int_adj_row(uc[c], link.nbr_face, link.nbr_edge, n, h)
            raws.append(torch.flip(row, dims=[-1]) if link.reversed_ else row)
        gi = [t_adj(f, e, 0) * raws[0] + t_adj(f, e, 1) * raws[1],
              t_adj(f, e, 2) * raws[0] + t_adj(f, e, 3) * raws[1]]
        ii = [_int_adj_row(uc[c], f, e, n, h) for c in range(2)]
        ub0 = 0.5 * (gi[0] + ii[0])
        ub1 = 0.5 * (gi[1] + ii[1])
        m0, m1 = met[e]
        return m0[0] * ub0 + m1[0] * ub1

    frames = [hc.clone(), uc[0].clone(), uc[1].clone()]
    sym_sn = hc.new_empty((6, 2, n))
    sym_we = hc.new_empty((6, n, 2))
    for f in range(6):
        for e in range(4):
            _store_ghost(frames[0][f], e,
                         _place_block(ghost_canonical(hc, f, e), e), n, h)
            raw = [ghost_canonical(uc[c], f, e) for c in range(2)]
            # The full-depth T entries at this face's ghost slots, back
            # in canonical (h, n) layout.
            if e == EDGE_S:
                Ts = [_depth_flip(T_sn[j, f, 0]) for j in range(4)]
            elif e == EDGE_N:
                Ts = [T_sn[j, f, 1] for j in range(4)]
            elif e == EDGE_W:
                Ts = [_depth_flip(T_we[j, f, 0].transpose(0, 1))
                      for j in range(4)]
            else:
                Ts = [T_we[j, f, 1].transpose(0, 1) for j in range(4)]
            ca = Ts[0] * raw[0] + Ts[1] * raw[1]
            cb = Ts[2] * raw[0] + Ts[3] * raw[1]
            _store_ghost(frames[1][f], e, _place_block(ca, e), n, h)
            _store_ghost(frames[2][f], e, _place_block(cb, e), n, h)
        for e in range(4):
            link, back, is_link = stage.pair_of[(f, e)]
            nl = local_normal(link.face, link.edge)
            nb = local_normal(back.face, back.edge)
            if link.reversed_:
                nb = torch.flip(nb, dims=[-1])
            avg = 0.5 * (_OUT_SIGN[link.edge] * nl - _OUT_SIGN[back.edge] * nb)
            if is_link:
                mine = _OUT_SIGN[link.edge] * avg
            else:
                mine = _OUT_SIGN[back.edge] * (-avg)
                if link.reversed_:
                    mine = torch.flip(mine, dims=[-1])
            if e in (EDGE_S, EDGE_N):
                sym_sn[f, 0 if e == EDGE_S else 1] = mine
            else:
                sym_we[f, :, 0 if e == EDGE_W else 1] = mine

    tends = stage._rhs(stage.fz, *frames, b_ext, sym_sn, sym_we,
                       sym_prescaled=False)
    bases = (None, None, None) if h0 is None else (h0, u0[0], u0[1])
    outs = []
    for frame, tend, y0 in zip(frames, tends, bases):
        val = frame if y0 is None else stage.fa * y0 + stage.fb * frame
        val[:, i0:i1, i0:i1] = val[:, i0:i1, i0:i1] + stage.fg * tend
        outs.append(val)
    return outs[0], torch.stack(outs[1:])


# ---------------------------------------------------------------------------
# The stage: kernel wrapper
# ---------------------------------------------------------------------------


def _nbr_kernel(mode: str = "mc"):
    """The neighbour-read stage kernel of reconstruction ``mode``: 13
    tensor pointers, 2 host pointers to the int tables; n, halo, with_y0;
    8 float constants; the stream."""
    return _entry("cov_stage_nbr", _entry_name("cov_stage_nbr", mode),
                  [_P] * 15 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8
                  + [_P])


class CovStageNbr(_StageBase):
    """One neighbour-read covariant SSPRK3 stage over extended fields.

    ``a == 0``: ``stage(hc, uc, b_ext)``; else ``stage(h0, u0, hc, uc,
    b_ext)``, with ``h*``, ``b_ext`` (6, M, M) and ``u*`` (2, 6, M, M).
    Returns ``(h, u)``, the whole new blocks (see
    :func:`cov_stage_nbr_reference`).  Every reconstruction (PLR with each
    limiter; PPM at halo >= 3): CUDA tensors launch the mode's instance
    of ``csrc/cov_stage_nbr.cu``; CPU tensors, or any tensors with
    ``interpret=True``, run the plain version.  There is no other path:
    a kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, grid, gravity: float, omega: float, dt: float,
                 a: float, b: float, scheme: str = "plr",
                 limiter: str = "mc", interpret: bool = False, tables=None):
        super().__init__(grid.n, grid.halo, grid.dalpha, grid.radius,
                         gravity, omega, dt, a, b, scheme=scheme,
                         limiter=limiter, device=grid.device)
        self.interpret = bool(interpret)
        n, h = self.n, self.halo
        self.tables = _nbr_tables(grid) if tables is None else tables
        x_row, _, x_col, _ = self.coords
        self.met = _edge_metric_rows(x_row, x_col, n, h, self.radius)
        self.adj = build_connectivity()
        self.pair_of = {}
        for link, back in edge_pairs(self.adj):
            self.pair_of[(link.face, link.edge)] = (link, back, True)
            self.pair_of[(back.face, back.edge)] = (link, back, False)
        # The kernel's tables, in slot order S, N, W, E: the edge-metric
        # rows (2, 4, n); per (face, slot) the neighbour (face, slot,
        # reversed) and the edge pair (link face, link slot, back face,
        # back slot, is_link).
        self._met = torch.stack([torch.stack([self.met[e][c].reshape(n)
                                              for e in _EORDER])
                                 for c in range(2)]).contiguous()
        conn = np.empty((6, 4, 3), np.int32)
        pair = np.empty((6, 4, 5), np.int32)
        for f in range(6):
            for s, e in enumerate(_EORDER):
                lk = self.adj[f][e]
                conn[f, s] = (lk.nbr_face, _SLOT[lk.nbr_edge], lk.reversed_)
                link, back, is_link = self.pair_of[(f, e)]
                pair[f, s] = (link.face, _SLOT[link.edge], back.face,
                              _SLOT[back.edge], is_link)
        self._conn, self._pair = conn, pair

    def _unpack(self, args):
        if self.with_y0:
            if len(args) != 5:
                raise TypeError("stage(h0, u0, hc, uc, b_ext) takes 5 "
                                f"tensors, got {len(args)}")
            return args
        if len(args) != 3:
            raise TypeError("stage(hc, uc, b_ext) takes 3 tensors, got "
                            f"{len(args)}")
        return (None, None) + tuple(args)

    def _check(self, h0, u0, hc, uc, b_ext):
        m = self.m
        want = {"hc": (hc, (6, m, m)), "uc": (uc, (2, 6, m, m)),
                "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (6, m, m))
            want["u0"] = (u0, (2, 6, m, m))
        _check_tensors(want, self.device)

    def __call__(self, *args):
        h0, u0, hc, uc, b_ext = self._unpack(args)
        self._check(h0, u0, hc, uc, b_ext)
        if self.interpret or not self._on_cuda(hc):
            return cov_stage_nbr_reference(self, *args)
        ho = torch.empty_like(hc)
        uo = torch.empty_like(uc)
        T_sn, T_we = self.tables
        rc = _nbr_kernel(self.mode)(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
            b_ext.data_ptr(), T_sn.data_ptr(), T_we.data_ptr(),
            self._met.data_ptr(), self._xc.data_ptr(), self._xf.data_ptr(),
            self.fz.data_ptr(), ho.data_ptr(), uo.data_ptr(),
            self._conn.ctypes.data, self._pair.ctypes.data, self.n,
            self.halo, int(self.with_y0), *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage_nbr kernel launch failed: cudaError {rc} "
                f"(n={self.n}, halo={self.halo}, mode={self.mode})")
        CovStageNbr.launches += 1
        return ho, uo

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_nbr_reference(self, *args)


def make_cov_stage_nbr(grid, gravity: float, omega: float, dt: float,
                       a: float, b: float, scheme: str = "plr",
                       limiter: str = "mc", interpret: bool = False,
                       tables=None):
    """One neighbour-read stage (see :class:`CovStageNbr`).  ``tables``:
    the optional :func:`_nbr_tables` pair, so that a stepper builds the
    rotation tables once for its three stages."""
    return CovStageNbr(grid, gravity, omega, dt, a, b, scheme=scheme,
                       limiter=limiter, interpret=interpret, tables=tables)


def make_fused_ssprk3_cov_nbr(grid, gravity: float, omega: float, dt: float,
                              b_ext, scheme: str = "plr",
                              limiter: str = "mc", interpret: bool = False):
    """``step(y, t) -> y`` over the plain extended state ``y = {h (6, M,
    M), u (2, 6, M, M)}`` (``CovariantShallowWater.extend_state(state)``;
    read it back with ``restrict_state``).

    Three neighbour-read stages and nothing else: no strip carry, no
    router.  ``step.stages`` holds the three :class:`CovStageNbr`.
    """
    tables = _nbr_tables(grid)
    stages = [make_cov_stage_nbr(grid, gravity, omega, dt, a, b,
                                 scheme=scheme, limiter=limiter,
                                 interpret=interpret, tables=tables)
              for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

    def step(y, t):
        del t
        h0, u0 = y["h"], y["u"]
        h1, u1 = stage1(h0, u0, b_ext)
        h2, u2 = stage2(h0, u0, h1, u1, b_ext)
        h3, u3 = stage3(h0, u0, h2, u2, b_ext)
        return {"h": h3, "u": u3}

    step.stages = stages
    return step
