"""The whole-step covariant stepper: SSPRK3 in one kernel launch.

Counterpart of :mod:`jaxstream.experiments.swe_mega`.  The compact
stepper launches three strip routes (torch ops) and three stage kernels
per step; here the step, routes included, is one launch of
``csrc/cov_step_mega.cu``, over the same carry ``{h, u, strips_sn,
strips_we}`` (``CovariantShallowWater.compact_state``).

* :func:`cov_mega_step_reference`: the plain PyTorch version, three
  times the split router's gather, rotations and pair average
  (:class:`~jaxstream_torch.ops.cuda.swe_cov._SplitRoute`, its sym rows
  not prescaled) and the compact stage's arithmetic, with the combine
  ``(A y0 + B cur) + C tend`` of the float32 table ``AB``;
* :class:`CovMegaStep`: CUDA tensors launch the kernel (the port of the
  Pallas kernel ``make_fused_ssprk3_cov_mega``), CPU tensors run the
  plain version;
* :func:`make_fused_ssprk3_cov_mega`: ``step(y, t) -> y``.

The stage multiplies the un-prescaled sym rows by the edge sqrtg
(``rhs_core_cov(..., sym_prescaled=False)``), the same product the
compact stepper's router forms, so both steppers compute the same
numbers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.cuda._launch import _P, _check_tensors, _entry
from ..ops.cuda.swe_cov import (SSPRK3_COEFFS, _RhsBase, _SplitRoute, _fill,
                                pack_strips_cov_split)
from ..ops.cuda.swe_rhs import _f32

__all__ = ["CovMegaStep", "cov_mega_step_reference",
           "make_fused_ssprk3_cov_mega"]


def cov_mega_step_reference(mega, h, u, strips_sn, strips_we, b_ext):
    """The plain PyTorch version of one whole step.

    ``mega`` is a :class:`CovMegaStep`; the operands as for calling it.
    Returns ``(h, u, strips_sn, strips_we)`` after the step.
    """
    n, hh = mega.n, mega.halo
    cur_h, cur_u, sn, we = h, u, strips_sn, strips_we
    for A, B, C in mega.AB:
        gsn, gwe = mega.route(sn, we)
        frames = tuple(_fill(q, gsn, gwe, fi, n, hh)
                       for fi, q in enumerate((cur_h, cur_u[0], cur_u[1])))
        dh, dua, dub = mega._rhs(mega.fz, *frames, b_ext,
                                 gsn[:, 6 * hh:6 * hh + 2],
                                 gwe[:, :, 6 * hh:6 * hh + 2],
                                 sym_prescaled=False)
        cur_h = (A * h + B * cur_h) + C * dh
        cur_u = torch.stack([(A * u[0] + B * cur_u[0]) + C * dua,
                             (A * u[1] + B * cur_u[1]) + C * dub])
        sn, we = pack_strips_cov_split(cur_h, cur_u, n, hh)
    return cur_h, cur_u, sn, we


def _mega_kernel():
    """The whole-step kernel: 20 tensor pointers, 2 host table pointers;
    n, halo, n_sn, n_we; 5 float constants; the block-count out-pointer;
    the stream."""
    return _entry("cov_step_mega", "cov_step_mega_f32",
                  [_P] * 22 + [ctypes.c_int] * 4 + [ctypes.c_float] * 5
                  + [_P, _P])


class CovMegaStep(_RhsBase):
    """One whole SSPRK3 step of the covariant model over the compact
    carry.

    ``step(h, u, strips_sn, strips_we, b_ext) -> (h, u, strips_sn,
    strips_we)`` with ``h`` (6, n, n), ``u`` (2, 6, n, n), the strips
    (6, 6h, n) / (6, n, 6h) and ``b_ext`` (6, M, M).  CUDA tensors launch
    ``csrc/cov_step_mega.cu``, one cooperative launch per step on as many
    blocks as the card holds at once; CPU tensors, or any tensors with ``interpret=True``, run
    :func:`cov_mega_step_reference`.  There is no other path: a kernel
    that fails to build or launch raises.  ``blocks`` is the last
    launch's grid.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, grid, gravity: float, omega: float, dt: float,
                 scheme: str = "plr", limiter: str = "mc",
                 interpret: bool = False):
        super().__init__(grid.n, grid.halo, grid.dalpha, grid.radius,
                         gravity, omega, scheme=scheme, limiter=limiter,
                         device=grid.device)
        self.dt = float(dt)
        self.interpret = bool(interpret)
        self.blocks = None
        # The JAX kernel's float32 table: per stage (A, B, C) of
        # (A y0 + B cur) + C tend.
        self.AB = tuple((_f32(a), _f32(b), _f32(b * self.dt))
                        for a, b in SSPRK3_COEFFS)
        self.route = _SplitRoute(grid)
        r = self.route
        M0, M1, link_rows, back_rows, rev, _, _, sym_src = r.sym_tables
        self._idx = r.idx.to(torch.int32)
        self._met = torch.stack([M0[0], M1[0]]).contiguous()
        self._tab = np.concatenate([
            t.cpu().numpy().reshape(-1).astype(np.int32)
            for t in (link_rows, back_rows, rev, sym_src)])
        self._ab = np.asarray(self.AB, np.float32)

    def _check(self, h, u, strips_sn, strips_we, b_ext):
        n, hh, m = self.n, self.halo, self.m
        _check_tensors({"h": (h, (6, n, n)), "u": (u, (2, 6, n, n)),
                        "strips_sn": (strips_sn, (6, 6 * hh, n)),
                        "strips_we": (strips_we, (6, n, 6 * hh)),
                        "b_ext": (b_ext, (6, m, m))}, self.device)

    def __call__(self, h, u, strips_sn, strips_we, b_ext):
        args = (h, u, strips_sn, strips_we, b_ext)
        self._check(*args)
        if self.interpret or not self._on_cuda(h):
            return cov_mega_step_reference(self, *args)
        n, hh = self.n, self.halo
        ho, uo = torch.empty_like(h), torch.empty_like(u)
        sno, weo = torch.empty_like(strips_sn), torch.empty_like(strips_we)
        bh, bu = torch.empty_like(h), torch.empty_like(u)
        gsn = h.new_empty((6, 6 * hh + 2, n))
        gwe = h.new_empty((6, n, 6 * hh + 2))
        r = self.route
        blocks = ctypes.c_int(0)
        rc = _mega_kernel()(
            *[t.data_ptr() for t in args], self._xc.data_ptr(),
            self._xf.data_ptr(), self.fz.data_ptr(), self._idx.data_ptr(),
            r.T_sn.data_ptr(), r.T_we.data_ptr(), self._met.data_ptr(),
            ho.data_ptr(), uo.data_ptr(), sno.data_ptr(), weo.data_ptr(),
            bh.data_ptr(), bu.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
            self._tab.ctypes.data, self._ab.ctypes.data, n, hh, r.n_sn,
            r.n_we, *self._rhs_consts, ctypes.addressof(blocks),
            self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_step_mega kernel launch failed: cudaError {rc} "
                f"(n={n}, halo={hh}, blocks={blocks.value})")
        self.blocks = blocks.value
        CovMegaStep.launches += 1
        return ho, uo, sno, weo

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_mega_step_reference(self, *args)


def make_fused_ssprk3_cov_mega(grid, gravity: float, omega: float,
                               dt: float, b_ext, scheme: str = "plr",
                               limiter: str = "mc", interpret: bool = False):
    """``step(y, t) -> y`` over the compact carry ``y = {h, u, strips_sn,
    strips_we}`` (``CovariantShallowWater.compact_state``), one
    :class:`CovMegaStep` call per step (``step.kernel``)."""
    kern = CovMegaStep(grid, gravity, omega, dt, scheme=scheme,
                       limiter=limiter, interpret=interpret)

    def step(y, t):
        del t
        h, u, sn, we = kern(y["h"], y["u"], y["strips_sn"], y["strips_we"],
                            b_ext)
        return {"h": h, "u": u, "strips_sn": sn, "strips_we": we}

    step.kernel = kern
    return step
