"""The covariant shallow-water kernels' wrappers, routers and steppers.

Counterpart of the single-device paths of
:mod:`jaxstream.ops.pallas.swe_cov`:

* :func:`pack_strips_cov_split` and :func:`make_cov_strip_router_split`
  (the JAX router's ``prescale_sym=True`` form): the boundary-strip
  carry and the static row-gather + 2x2 covariant rotation + seam
  symmetrization that turn one stage's strips into the next stage's
  ghost blocks.  Plain torch index
  ops, as the JAX package runs them as XLA ops.  Its core,
  :class:`_SplitRoute`, also serves the whole-step stepper of
  :mod:`jaxstream_torch.experiments.swe_mega`, without the prescale.
* :class:`CovStageCompact`: one SSPRK3 stage over interior-only state.
  On CUDA tensors it launches the hand-written Hopper kernel
  ``csrc/cov_stage.cu`` (the port of the Pallas kernel
  ``make_cov_stage_compact``); on CPU tensors it runs the plain PyTorch
  version :func:`cov_stage_compact_reference`, which
  :func:`rhs_core_cov` implements op for op after the JAX package.
* :func:`make_fused_ssprk3_cov_compact`: route + stage, three times.
* :class:`CovNu4Filter`: the once-per-step del^4 filter
  ``q -= dt nu4 lap(lap q)`` on h, u_a, u_b.  On CUDA tensors it
  launches ``csrc/cov_nu4_filter.cu`` (the port of the Pallas kernel
  ``make_cov_nu4_filter``); on CPU tensors it runs
  :func:`cov_nu4_filter_reference` (:func:`lap_core`,
  :func:`_nu4_filtered_value`, :func:`_fill` with corners).
* :func:`make_fused_ssprk3_cov_split_nu4`: the three stages, then route
  + filter (the JAX package's ``nu4_mode='split'``).
* :class:`CovStageRefusedNu4`: stage 1 with the filter fused in front of
  it; CUDA tensors launch ``csrc/cov_stage_refused_nu4.cu`` (the port of
  ``make_cov_stage_refused_nu4``), CPU tensors run
  :func:`cov_stage_refused_nu4_reference`.
  :func:`make_fused_ssprk3_cov_refused_nu4` steps with it and two
  compact stages (``nu4_mode='refused'``).
* :class:`CovStageNu4`: the in-stage del^4 kernel pair A / B; CUDA
  tensors launch ``csrc/cov_stage_nu4.cu`` (the port of
  ``make_cov_stage_nu4``), CPU tensors run
  :func:`cov_stage_nu4_a_reference` / :func:`cov_stage_nu4_b_reference`.
  :func:`make_fused_ssprk3_cov_nu4` steps with three of them
  (``nu4_mode='stage'``).
* :class:`CovRhs`: the unfused RHS of ghost-filled extended faces, the
  classic path's ``backend='pallas'``; CUDA tensors launch
  ``csrc/cov_rhs.cu`` (the port of ``make_cov_rhs_pallas``), CPU tensors
  run :func:`cov_rhs_reference`.  :func:`make_cov_rhs_pallas` wraps it
  with :func:`make_sym_edge_normals`, the vectorized twin of
  :func:`sym_edge_normals`.
* The sharded tiers' local forms: :class:`CovRhsInterior`, the RHS of a
  block's ghost-free core (CUDA tensors launch
  ``csrc/cov_rhs_interior.cu``, the port of
  ``make_cov_rhs_interior_local``; CPU tensors run
  :func:`cov_rhs_interior_reference`), the torch boundary band
  :func:`make_cov_rhs_band_local`, and :class:`CovRhsLocal`, the RHS of
  one extended block with its coordinates as operands
  (``csrc/cov_rhs_local.cu``, the port of ``make_cov_rhs_pallas_local``;
  :func:`cov_rhs_local_reference`).
* The extended carry: :func:`pack_strips_cov`, the loop router
  :func:`make_cov_strip_router` and its linear twin
  :func:`make_cov_strip_router_linear`, and :class:`CovStageInkernel`,
  one stage with the ghost fill in the kernel; CUDA tensors launch
  ``csrc/cov_stage_inkernel.cu`` (the port of
  ``make_cov_stage_inkernel``), CPU tensors run
  :func:`cov_stage_inkernel_reference`.
  :func:`make_fused_ssprk3_cov_inkernel` steps with three of them
  (``compact=False``).

The kernels share their device code through ``csrc/cov_common.cuh``.

Layouts are the JAX package's: state ``h (6, n, n)``, ``u (2, 6, n, n)``;
compact strips ``strips_sn (6, 6h, n)`` / ``strips_we (6, n, 6h)``;
routed ghosts ``gsn (6, 6h+2, n)`` / ``gwe (6, n, 6h+2)`` whose last two
rows/columns are the sqrtg-prescaled symmetrized edge normals (S, N /
W, E).  The extended carry holds ``h (6, M, M)``, ``u (2, 6, M, M)`` and
``strips (6, 12h, n)``; its routed ghosts ``(6, 12h+4, n)`` end in the
four un-prescaled sym rows S, N, W, E.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..._device import resolve_device
from ...geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                      build_connectivity, edge_pairs)
from ...parallel.halo import _fill_corners
from ..reconstruct import pick_recon, plr_face_states
from ._launch import (KernelBase, _P, _check_tensors, _entry, _entry_name,
                      _ptr, _recon_mode)
from .precision import resolve_stage_precision
from .swe_rhs import _f32, _fast_frame, coord_rows
from .tables import table

__all__ = [
    "pack_strips_cov_split",
    "make_cov_strip_router_split",
    "rhs_core_cov",
    "CovStageCompact",
    "make_cov_stage_compact",
    "cov_stage_compact_reference",
    "make_fused_ssprk3_cov_compact",
    "make_fused_ssprk3_cov_multistep",
    "pick_recon_precision",
    "lap_core",
    "CovNu4Filter",
    "make_cov_nu4_filter",
    "cov_nu4_filter_reference",
    "make_fused_ssprk3_cov_split_nu4",
    "CovStageRefusedNu4",
    "make_cov_stage_refused_nu4",
    "cov_stage_refused_nu4_reference",
    "make_fused_ssprk3_cov_refused_nu4",
    "CovStageNu4",
    "make_cov_stage_nu4",
    "cov_stage_nu4_a_reference",
    "cov_stage_nu4_b_reference",
    "make_fused_ssprk3_cov_nu4",
    "sym_edge_normals",
    "make_sym_edge_normals",
    "CovRhs",
    "make_cov_rhs_pallas",
    "cov_rhs_reference",
    "RankGroups",
    "CovRhsInterior",
    "make_cov_rhs_interior_local",
    "cov_rhs_interior_reference",
    "cov_rhs_interior_stacked_reference",
    "make_cov_rhs_band_local",
    "CovRhsLocal",
    "make_cov_rhs_pallas_local",
    "cov_rhs_local_reference",
    "cov_rhs_local_stacked_reference",
    "pack_strips_cov",
    "make_cov_strip_router",
    "make_cov_strip_router_linear",
    "CovStageInkernel",
    "make_cov_stage_inkernel",
    "cov_stage_inkernel_reference",
    "make_fused_ssprk3_cov_inkernel",
    "SSPRK3_COEFFS",
]

#: Shu-Osher SSPRK3 stage coefficients ``(a, b)``: stage k computes
#: ``a*y0 + b*yc + b*dt*L(yc)``.
SSPRK3_COEFFS = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))

_OUT_SIGN = {EDGE_S: -1.0, EDGE_W: -1.0, EDGE_N: 1.0, EDGE_E: 1.0}
# Slot order of the routers' per-face edge tables.
_EORDER = (EDGE_S, EDGE_N, EDGE_W, EDGE_E)
_SLOT = {e: s for s, e in enumerate(_EORDER)}


# ---------------------------------------------------------------------------
# Router tables
# ---------------------------------------------------------------------------


def _pair_sym_tables(grid):
    """Static tables of the seam symmetrization.

    Returns ``(M0, M1, link_rows, back_rows, rev, sga, sgb, sym_src)``:
    the (1, 4, n) edge-face inverse-metric rows per slot (face-independent
    on the equiangular grid), the 12 physical edges' row selections into
    the (24, n) local-normal table, reversal/sign columns, and the scatter
    order back to (face*4 + slot) rows.
    """
    n, halo = grid.n, grid.halo
    i0, i1 = halo, halo + n
    dev = grid.device
    adj = build_connectivity()
    met = {
        EDGE_W: (grid.ginv_aa_xf[0, i0:i1, i0], grid.ginv_ab_xf[0, i0:i1, i0]),
        EDGE_E: (grid.ginv_aa_xf[0, i0:i1, i1], grid.ginv_ab_xf[0, i0:i1, i1]),
        EDGE_S: (grid.ginv_ab_yf[0, i0, i0:i1], grid.ginv_bb_yf[0, i0, i0:i1]),
        EDGE_N: (grid.ginv_ab_yf[0, i1, i0:i1], grid.ginv_bb_yf[0, i1, i0:i1]),
    }
    M0 = torch.stack([met[e][0] for e in _EORDER])[None]
    M1 = torch.stack([met[e][1] for e in _EORDER])[None]

    pairs = edge_pairs(adj)
    links = [lk for lk, _ in pairs]
    backs = [bk for _, bk in pairs]

    def T(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)

    link_rows = T([lk.face * 4 + _SLOT[lk.edge] for lk in links], torch.long)
    back_rows = T([bk.face * 4 + _SLOT[bk.edge] for bk in backs], torch.long)
    rev = T([[lk.reversed_] for lk in links], torch.bool)
    sga = T([[_OUT_SIGN[lk.edge]] for lk in links], torch.float32)
    sgb = T([[_OUT_SIGN[bk.edge]] for bk in backs], torch.float32)
    sym_src = np.empty(24, np.int64)
    for i, (lk, bk) in enumerate(zip(links, backs)):
        sym_src[lk.face * 4 + _SLOT[lk.edge]] = i
        sym_src[bk.face * 4 + _SLOT[bk.edge]] = 12 + i
    return (M0, M1, link_rows, back_rows, rev, sga, sgb,
            torch.from_numpy(sym_src).to(dev))


def _pair_symmetrize(I_u, gadj_a, gadj_b, tables):
    """Seam-symmetrized edge normals, (6, 4, n) in slot order.

    ``I_u``: (2, 6, 4, n) interior boundary-adjacent covariant rows (or
    the pair of its two components); ``gadj_*``: (6, 4, n) edge-adjacent
    rotated ghost rows (each with leading member axes in the batched
    router).  One average per physical edge, distributed to both faces
    by exact permutation.
    """
    M0, M1 = tables[:2]
    ubar0 = 0.5 * (I_u[0] + gadj_a)
    ubar1 = 0.5 * (I_u[1] + gadj_b)
    L = M0 * ubar0 + M1 * ubar1
    return _pair_average(L.reshape(L.shape[:-3] + (24, L.shape[-1])),
                         tables)


def _pair_average(L, tables):
    """The pair algebra of :func:`_pair_symmetrize` on the (24, n) local
    edge normals ``L`` in (face*4 + slot) order: (6, 4, n) out.  Leading
    (member) axes of ``L`` carry through."""
    _, _, link_rows, back_rows, rev, sga, sgb, sym_src = tables
    la = L.index_select(-2, link_rows)
    lb = L.index_select(-2, back_rows)
    lb = torch.where(rev, torch.flip(lb, dims=[-1]), lb)
    avg = 0.5 * (sga * la - sgb * lb)
    na = sga * avg
    nb = sgb * (-avg)
    nb = torch.where(rev, torch.flip(nb, dims=[-1]), nb)
    out = torch.cat([na, nb], dim=-2).index_select(-2, sym_src)
    return out.reshape(L.shape[:-2] + (6, 4, L.shape[-1]))


def _local_edge_normal(grid, u_ext, face: int, edge: int):
    """This panel's own normal velocity at one edge's boundary faces.

    The stored +alpha (W/E) or +beta (S/N) face value as a canonical
    along-edge ``(n,)`` strip, with the operands and their order of
    :func:`jaxstream_torch.ops.fv.covariant_face_normal_velocity`
    restricted to that edge and the face's own stored face metric.
    """
    h, n = grid.halo, grid.n
    i0, i1 = h, h + n
    if edge in (EDGE_W, EDGE_E):
        fi = i0 if edge == EDGE_W else i1
        ub_a = 0.5 * (u_ext[0, face, i0:i1, fi - 1] + u_ext[0, face, i0:i1, fi])
        ub_b = 0.5 * (u_ext[1, face, i0:i1, fi - 1] + u_ext[1, face, i0:i1, fi])
        return (grid.ginv_aa_xf[face, i0:i1, fi] * ub_a
                + grid.ginv_ab_xf[face, i0:i1, fi] * ub_b)
    fi = i0 if edge == EDGE_S else i1
    ub_a = 0.5 * (u_ext[0, face, fi - 1, i0:i1] + u_ext[0, face, fi, i0:i1])
    ub_b = 0.5 * (u_ext[1, face, fi - 1, i0:i1] + u_ext[1, face, fi, i0:i1])
    return (grid.ginv_ab_yf[face, fi, i0:i1] * ub_a
            + grid.ginv_bb_yf[face, fi, i0:i1] * ub_b)


def _symmetrized_strips(local_normal):
    """Average the two panels' edge normals and give both the result.

    ``local_normal(face, edge) -> (n,)``: each panel's own edge-face
    value in canonical along-edge order.  Once per physical edge, the
    outward-sign and reversal algebra of the JAX package's loop form, so
    both faces receive the same values.  Returns ``(sym_sn (6, 2, n),
    sym_we (6, n, 2))``.
    """
    sn = [[None, None] for _ in range(6)]
    we = [[None, None] for _ in range(6)]
    slot = {EDGE_S: (sn, 0), EDGE_N: (sn, 1), EDGE_W: (we, 0),
            EDGE_E: (we, 1)}
    for link, back in edge_pairs(build_connectivity()):
        s_a = local_normal(link.face, link.edge)
        s_b = local_normal(back.face, back.edge)
        if link.reversed_:
            s_b = torch.flip(s_b, dims=[-1])
        avg = 0.5 * (_OUT_SIGN[link.edge] * s_a - _OUT_SIGN[back.edge] * s_b)
        new_a = _OUT_SIGN[link.edge] * avg
        new_b = _OUT_SIGN[back.edge] * (-avg)
        if link.reversed_:
            new_b = torch.flip(new_b, dims=[-1])
        for lk, val in ((link, new_a), (back, new_b)):
            table, k = slot[lk.edge]
            table[lk.face][k] = val
    return (torch.stack([torch.stack(rows) for rows in sn]),
            torch.stack([torch.stack(cols, dim=-1) for cols in we]))


def sym_edge_normals(grid, u_ext):
    """Symmetrized panel-edge normal velocities for the unfused RHS.

    ``u_ext``: (2, 6, M, M) covariant components, ghosts filled.  Returns
    ``(sym_sn (6, 2, n), sym_we (6, n, 2))``, not prescaled, from each
    panel's stored face metric (:func:`_local_edge_normal`), so they equal
    the classic path's seam values bit for bit.
    """
    return _symmetrized_strips(
        lambda f, e: _local_edge_normal(grid, u_ext, f, e))


def make_sym_edge_normals(grid):
    """``sym(u_ext) -> (sym_sn, sym_we)``: :func:`sym_edge_normals` as a
    few tensor ops.

    One gather of the two cells straddling every boundary face, the
    face-normal metric product with each face's own stored metric rows,
    and :func:`_pair_average`, each element in the loop form's operand
    order (bitwise equal to it).  The tables are built once here.
    """
    n, h, m = grid.n, grid.halo, grid.m
    i0, i1 = h, h + n
    k = np.arange(i0, i1)
    # Flat (face, row, col) index of the cell before (A) and at (B) each
    # boundary face, the operands of 0.5 * (A + B); per slot S, N, W, E.
    idx = np.empty((2, 6, 4, n), np.int64)
    met0, met1 = [], []
    for s, e in enumerate(_EORDER):
        fi = i0 if e in (EDGE_S, EDGE_W) else i1
        if e in (EDGE_S, EDGE_N):
            cells = ((fi - 1) * m + k, fi * m + k)
            met0.append(grid.ginv_ab_yf[:, fi, i0:i1])
            met1.append(grid.ginv_bb_yf[:, fi, i0:i1])
        else:
            cells = (k * m + fi - 1, k * m + fi)
            met0.append(grid.ginv_aa_xf[:, i0:i1, fi])
            met1.append(grid.ginv_ab_xf[:, i0:i1, fi])
        for f in range(6):
            idx[:, f, s] = np.stack(cells) + f * m * m
    idx = torch.from_numpy(idx.reshape(-1)).to(grid.device)
    M0 = torch.stack(met0, dim=1)                  # (6, 4, n)
    M1 = torch.stack(met1, dim=1)
    tables = _pair_sym_tables(grid)

    def sym(u_ext):
        A, B = u_ext.reshape(2, -1).index_select(1, idx).reshape(
            2, 2, 6, 4, n).unbind(1)
        ub = 0.5 * (A + B)
        out = _pair_average((M0 * ub[0] + M1 * ub[1]).reshape(24, n),
                            tables)
        return (out[:, 0:2].contiguous(),
                out[:, 2:4].transpose(1, 2).contiguous())

    return sym


def _rotation_tables(grid) -> torch.Tensor:
    """Per-ghost-slot covariant rotations in canonical strip layout.

    ``T[i*2+j][f, e] = e_i^local(ghost cell) . a_j^src(source cell)``,
    indexed by the receiving (face, edge) in canonical (depth, along)
    order with the pair's reversal folded into the source side.  Float64
    numpy from the grid's stored bases, exactly as the JAX package; a
    float32 ``(4, 6, 4, halo, n)`` tensor on the grid's device.
    """
    from ...parallel.vector_halo import _strip_indices

    n, halo, m = grid.n, grid.halo, grid.m
    adj = build_connectivity()
    src_idx, dst_idx = _strip_indices(n, halo)

    def f64(t):
        return np.moveaxis(t.cpu().numpy().astype(np.float64), 0, -1)

    ef = np.stack([f64(grid.e_a), f64(grid.e_b)]).reshape(2, 6 * m * m, 3)
    af = np.stack([f64(grid.a_a), f64(grid.a_b)]).reshape(2, 6 * m * m, 3)

    out = np.zeros((4, 6, 4, halo, n), np.float32)
    for f in range(6):
        for e in range(4):
            link = adj[f][e]
            src = src_idx[link.nbr_edge].reshape(halo, n)
            if link.reversed_:
                src = src[:, ::-1]
            src = src.reshape(-1) + link.nbr_face * m * m
            dst = dst_idx[e] + f * m * m
            for i in range(2):
                for j in range(2):
                    out[i * 2 + j, f, e] = np.einsum(
                        "...k,...k->...", ef[i][dst], af[j][src]
                    ).reshape(halo, n)
    return torch.from_numpy(out).to(grid.device)


# ---------------------------------------------------------------------------
# Strip carry and router
# ---------------------------------------------------------------------------


def pack_strips_cov_split(h_int, u_int, n: int, halo: int):
    """Boundary strips of interior fields, split by orientation.

    Returns ``(strips_sn (6, 6h, n), strips_we (6, n, 6h))``: per field in
    (h, u_a, u_b), the raw S rows then N rows / W columns then E columns
    in storage order.
    """
    h = halo
    fields = (h_int, u_int[0], u_int[1])
    sn = torch.cat([blk for q in fields
                    for blk in (q[:, 0:h, :], q[:, n - h:n, :])], dim=1)
    we = torch.cat([blk for q in fields
                    for blk in (q[:, :, 0:h], q[:, :, n - h:n])], dim=2)
    return sn, we


class _SplitRoute:
    """The split router without its last step: ``route(strips_sn,
    strips_we, sym_scale=None) -> (gsn, gwe)`` with the sym rows as the
    pair average leaves them, times ``sym_scale`` where one is given.

    :func:`make_cov_strip_router_split` (sqrtg-prescaled sym rows) and
    the whole-step stepper of :mod:`jaxstream_torch.experiments.swe_mega`
    (un-prescaled) share it, and its static tables: ``idx`` the flat
    source row of every routed row in ``[sn ; weT ; their lane flips]``
    order (``n_sn`` S/N ghost rows (3, 6, 2, h), ``n_we`` W/E ghost rows,
    then the (2, 6, 4) interior edge-adjacent u rows), ``T_sn``/``T_we``
    the placed rotation tables (4, 6, 2, h, n) and ``sym_tables`` those
    of :func:`_pair_sym_tables`.
    """

    def __init__(self, grid, precision=None):
        n, h = grid.n, grid.halo
        self.n, self.halo = n, h
        self.idx, self.T_sn, self.T_we, self.sym_tables = table(
            f"split_route/{n}/{h}", lambda: self._tables(grid))
        self.n_sn = self.n_we = 3 * 6 * 2 * h
        # The stage precision policy: strips (and routed ghosts) in sdt;
        # the rotation tables in bf16 only when both compute and strips
        # are (against f32 strips they would only round the
        # coefficients), as the JAX package's router.
        pol = resolve_stage_precision(precision)
        self.sdt = torch.float32 if pol is None else pol.strips_dtype
        if pol is not None and pol.compute == "bf16" and pol.strips == "bf16":
            self.T_sn = self.T_sn.to(torch.bfloat16)
            self.T_we = self.T_we.to(torch.bfloat16)

    @staticmethod
    def _tables(grid):
        """``(idx, T_sn, T_we, sym_tables)`` of ``grid``: built on the host
        from the connectivity and the grid's bases."""
        n, h = grid.n, grid.halo
        adj = build_connectivity()
        F = 2 * 6 * 6 * h          # sn section + weT section row count

        def src_row(fi: int, g: int, e: int, depth: int) -> int:
            """Flat source row of face g / edge e / field fi at canonical
            ``depth`` (0 = nearest the edge), in [sn ; weT] order."""
            kr = depth if e in (EDGE_S, EDGE_W) else h - 1 - depth
            sec = 0 if e in (EDGE_S, EDGE_N) else 6 * 6 * h
            pair = 0 if e in (EDGE_S, EDGE_W) else h
            return sec + g * 6 * h + fi * 2 * h + pair + kr

        def ghost_idx(edges):
            out = np.empty((3, 6, 2, h), np.int64)
            for fi in range(3):
                for f in range(6):
                    for p, e in enumerate(edges):
                        link = adj[f][e]
                        for k in range(h):
                            dep = (h - 1 - k) if e in (EDGE_S, EDGE_W) else k
                            r = src_row(fi, link.nbr_face, link.nbr_edge, dep)
                            out[fi, f, p, k] = r + (F if link.reversed_ else 0)
            return out

        idx_sn = ghost_idx((EDGE_S, EDGE_N))
        idx_we = ghost_idx((EDGE_W, EDGE_E))
        idx_int = np.empty((2, 6, 4), np.int64)
        for c in range(2):
            for f in range(6):
                for s, e in enumerate(_EORDER):
                    idx_int[c, f, s] = src_row(1 + c, f, e, 0)
        idx = torch.from_numpy(np.concatenate(
            [idx_sn.reshape(-1), idx_we.reshape(-1), idx_int.reshape(-1)]
        )).to(grid.device)

        # Placed rotation tables, split by orientation: (4, 6, 2, h, n).
        Tc = _rotation_tables(grid)
        T_sn = torch.stack([torch.flip(Tc[:, :, EDGE_S], dims=[-2]),
                            Tc[:, :, EDGE_N]], dim=2)
        T_we = torch.stack([torch.flip(Tc[:, :, EDGE_W], dims=[-2]),
                            Tc[:, :, EDGE_E]], dim=2)
        return idx, T_sn, T_we, _pair_sym_tables(grid)

    def __call__(self, strips_sn, strips_we, sym_scale=None):
        """``strips_sn (..., 6, 6h, n)``, ``strips_we (..., 6, n, 6h)``:
        leading member axes batch the route (one set of torch ops for the
        whole ensemble; the gathers index the last two axes and the
        tables broadcast, so each member's values are its own route's)."""
        if strips_sn.dim() == 3 and self.sdt == torch.float32:
            return self._route(strips_sn, strips_we, sym_scale)
        return self._route_batched(strips_sn, strips_we, sym_scale)

    def _route(self, strips_sn, strips_we, sym_scale):
        """One member with f32 strips: the fewest torch ops (the router is
        bound by their host dispatch on the main path)."""
        n, h = self.n, self.halo
        n_sn, n_we = self.n_sn, self.n_we
        T_sn, T_we = self.T_sn, self.T_we
        s_src = torch.cat([strips_sn.reshape(6 * 6 * h, n),
                           strips_we.transpose(1, 2).reshape(6 * 6 * h, n)],
                          dim=0)
        s_all = torch.cat([s_src, torch.flip(s_src, dims=[-1])], dim=0)
        rows = s_all.index_select(0, self.idx)
        C_sn = rows[:n_sn].reshape(3, 6, 2, h, n)
        C_we = rows[n_sn:n_sn + n_we].reshape(3, 6, 2, h, n)
        I_u = rows[n_sn + n_we:].reshape(2, 6, 4, n)

        G_sn = [C_sn[0],
                T_sn[0] * C_sn[1] + T_sn[1] * C_sn[2],
                T_sn[2] * C_sn[1] + T_sn[3] * C_sn[2]]
        G_we = [C_we[0],
                T_we[0] * C_we[1] + T_we[1] * C_we[2],
                T_we[2] * C_we[1] + T_we[3] * C_we[2]]

        # The placed edge-adjacent row: h-1 in the depth-flipped S/W
        # blocks, 0 in N/E.
        ka, kb = h - 1, 0
        gadj_a = torch.stack([G_sn[1][:, 0, ka], G_sn[1][:, 1, kb],
                              G_we[1][:, 0, ka], G_we[1][:, 1, kb]], dim=1)
        gadj_b = torch.stack([G_sn[2][:, 0, ka], G_sn[2][:, 1, kb],
                              G_we[2][:, 0, ka], G_we[2][:, 1, kb]], dim=1)
        sym = _pair_symmetrize(I_u, gadj_a, gadj_b, self.sym_tables)
        if sym_scale is not None:
            sym = sym * sym_scale

        gsn = torch.cat([g.reshape(6, 2 * h, n) for g in G_sn]
                        + [sym[:, 0:2]], dim=1)
        gwe_rows = torch.cat([g.reshape(6, 2 * h, n) for g in G_we]
                             + [sym[:, 2:4]], dim=1)
        return gsn, gwe_rows.transpose(1, 2).contiguous()

    def _route_batched(self, strips_sn, strips_we, sym_scale):
        """:meth:`_route`'s algebra over leading member axes and the 16-bit
        strips policy (the same values per member: every op is
        elementwise or indexes the last two axes)."""
        n, h = self.n, self.halo
        n_sn, n_we = self.n_sn, self.n_we
        T_sn, T_we = self.T_sn, self.T_we
        lead = tuple(strips_sn.shape[:-3])
        sdt = self.sdt
        # 16-bit strips: the inputs narrowed (an f32 initial carry; no-ops
        # after), the sym inputs widened to f32 (the seam symmetrization
        # stays full precision), the outputs narrowed.
        s16 = sdt != torch.float32
        if s16:
            strips_sn, strips_we = strips_sn.to(sdt), strips_we.to(sdt)
        s_src = torch.cat(
            [strips_sn.reshape(lead + (6 * 6 * h, n)),
             strips_we.transpose(-1, -2).reshape(lead + (6 * 6 * h, n))],
            dim=-2)
        s_all = torch.cat([s_src, torch.flip(s_src, dims=[-1])], dim=-2)
        rows = s_all.index_select(-2, self.idx)
        C_sn = rows[..., :n_sn, :].reshape(lead + (3, 6, 2, h, n)).unbind(-5)
        C_we = rows[..., n_sn:n_sn + n_we, :].reshape(
            lead + (3, 6, 2, h, n)).unbind(-5)
        I_u = rows[..., n_sn + n_we:, :].reshape(
            lead + (2, 6, 4, n)).unbind(-4)

        G_sn = [C_sn[0],
                T_sn[0] * C_sn[1] + T_sn[1] * C_sn[2],
                T_sn[2] * C_sn[1] + T_sn[3] * C_sn[2]]
        G_we = [C_we[0],
                T_we[0] * C_we[1] + T_we[1] * C_we[2],
                T_we[2] * C_we[1] + T_we[3] * C_we[2]]

        ka, kb = h - 1, 0
        gadj_a = torch.stack([G_sn[1][..., 0, ka, :], G_sn[1][..., 1, kb, :],
                              G_we[1][..., 0, ka, :], G_we[1][..., 1, kb, :]],
                             dim=-2)
        gadj_b = torch.stack([G_sn[2][..., 0, ka, :], G_sn[2][..., 1, kb, :],
                              G_we[2][..., 0, ka, :], G_we[2][..., 1, kb, :]],
                             dim=-2)
        if s16:
            I_u = tuple(x.float() for x in I_u)
            gadj_a, gadj_b = gadj_a.float(), gadj_b.float()
        sym = _pair_symmetrize(I_u, gadj_a, gadj_b, self.sym_tables)
        if sym_scale is not None:
            sym = sym * sym_scale
        if s16:
            # Rounded once per physical edge, then distributed: both faces
            # get the identical value.
            sym = sym.to(sdt)
            G_sn = [g.to(sdt) for g in G_sn]
            G_we = [g.to(sdt) for g in G_we]

        gsn = torch.cat([g.reshape(lead + (6, 2 * h, n)) for g in G_sn]
                        + [sym[..., 0:2, :]], dim=-2)
        gwe_rows = torch.cat([g.reshape(lead + (6, 2 * h, n)) for g in G_we]
                             + [sym[..., 2:4, :]], dim=-2)
        return gsn, gwe_rows.transpose(-1, -2).contiguous()


def make_cov_strip_router_split(grid, precision=None,
                                prescale_sym: bool = True):
    """``route(strips_sn, strips_we) -> (gsn, gwe)``.

    ``gsn`` ``(6, 6h+2, n)``: placed S/N ghost blocks per field plus the
    two symmetrized S/N edge-normal rows; ``gwe`` ``(6, n, 6h+2)``: placed
    W/E ghost columns plus the W/E sym columns.  Same algebra and operand
    order as the JAX package's router with ``prescale_sym=True``: the sym
    rows are multiplied by the static edge sqrtg, so the stage imposes
    them as they are.  Leading member axes batch it (the JAX package's
    ``jax.vmap(route)``).

    ``precision``: with 16-bit strips the ghosts and sym rows are taken
    and emitted in bfloat16; with bf16 compute too the 2x2 rotations run
    in bfloat16.  The sym rows are computed in f32 and rounded once.
    ``prescale_sym=False``: the sym rows as the pair average leaves them
    (the stages then take ``sym_prescaled=False``).
    """
    n, h = grid.n, grid.halo
    core = _SplitRoute(grid, precision)
    if not prescale_sym:
        return core

    # Static edge sqrtg rows in [S, N, W, E] order, identical for all
    # faces, from the same closed forms the stage would evaluate.
    def edge_sqrtg():
        x_row, xf_row, x_col, xf_col, _ = coord_rows(n, h, grid.device)
        h0, h1 = h, h + n
        r = float(grid.radius)
        sgS = _fast_frame(x_row[:, h0:h1], xf_col[h0:h0 + 1], r)["sqrtg"]
        sgN = _fast_frame(x_row[:, h0:h1], xf_col[h1:h1 + 1], r)["sqrtg"]
        sgW = _fast_frame(xf_row[:, h0:h0 + 1], x_col[h0:h1], r)["sqrtg"]
        sgE = _fast_frame(xf_row[:, h1:h1 + 1], x_col[h0:h1], r)["sqrtg"]
        return torch.stack([sgS.reshape(n), sgN.reshape(n),
                            sgW.reshape(n), sgE.reshape(n)])[None]

    sym_scale = table(f"edge_sqrtg/{n}/{h}/{float(grid.radius)!r}",
                      edge_sqrtg)

    def route(strips_sn, strips_we):
        return core(strips_sn, strips_we, sym_scale)

    return route


# ---------------------------------------------------------------------------
# The stage: plain version
# ---------------------------------------------------------------------------


def _center(v):
    """Interior slice of a band-frame entry (row, column or full)."""
    if v.shape[-2] == 1:
        return v[..., :, 1:-1]
    if v.shape[-1] == 1:
        return v[..., 1:-1, :]
    return v[..., 1:-1, 1:-1]


def pick_recon_precision(scheme: str, halo: int, n: int, limiter: str,
                         precision=None):
    """The stage kernels' reconstruction under a precision policy.

    Policy off (or f32 compute): :func:`pick_recon`.  ``compute='bf16'``
    with PLR: the cell differences in f32, the limiter algebra in
    bfloat16, the face state ``f32 cell value +- f32(bf16 half-slope)``
    (:func:`~jaxstream_torch.ops.reconstruct.plr_face_states` with
    ``slope_dtype``).  PPM has no bf16 form: ``ValueError``, the JAX
    package's message.
    """
    if precision is None or precision.compute != "bf16":
        return pick_recon(scheme, halo, n, limiter)
    if scheme == "ppm":
        raise ValueError(
            "the bf16 stage policy is defined for the PLR "
            "reconstruction (its op split and mixed-roof accounting "
            "assume the limiter algebra); PPM has no bf16 form — drop "
            "the precision policy or use scheme='plr'")
    return functools.partial(plr_face_states, h=halo, n=n, limiter=limiter,
                             slope_dtype=torch.bfloat16)


def rhs_core_cov(fz, xr, xfr, yc, yfc, hf, ua, ub, bf, sym_sn, sym_we, *,
                 n, halo, d, radius, gravity, omega, scheme="plr",
                 limiter="mc", sym_prescaled=True,
                 seam_edges=(True, True, True, True), precision=None):
    """Covariant-SWE right-hand side of all faces at once (plain torch).

    ``fz = (c0z, cxz, cyz)``: the face frames' z-components, each
    broadcastable against ``(F, 1, 1)``; ``xr``/``xfr`` (1, Mx) and
    ``yc``/``yfc`` (My, 1) coordinate rows/columns, or ``(F, 1, Mx)`` /
    ``(F, My, 1)`` where each face or block has its own; ``hf``, ``ua``,
    ``ub``, ``bf`` (F, My, Mx) with edge ghosts filled (corners are never
    read by a kept output).  ``sym_sn`` (F, 2, nx) / ``sym_we`` (F, ny, 2):
    the symmetrized edge normals imposed on the boundary faces, as they
    are (``sym_prescaled=True``, the compact stages' routed rows) or times
    the edge sqrtg of the closed-form frame (``False``: ``sg * sym``, the
    unfused RHS and the extended-carry stage).  h's face states are
    :func:`~jaxstream_torch.ops.reconstruct.pick_recon`'s for ``scheme``
    and ``limiter`` (PPM needs halo >= 3).  Returns interior ``(dh, dua,
    dub)``.  The operations and their order follow the JAX package's
    ``rhs_core_cov``.

    Rectangular windows, as the JAX package's: ``n=(ny, nx)`` with
    operand windows ``halo`` wider on every side; ``seam_edges = (S, N,
    W, E)`` gates each seam imposition (a window edge that is not a seam
    keeps its local flux; ``sym_sn`` or ``sym_we`` may be ``None`` where
    both of its edges are off).

    ``precision`` (a resolved :class:`~.precision.StagePrecision` or
    None): with ``compute='bf16'`` the flux face-average velocities are
    formed in bfloat16 (promoted back to f32 by the f32 metric) and h's
    PLR face states by :func:`pick_recon_precision`; every accumulator
    and metric term stays f32.
    """
    ny, nx = (n, n) if isinstance(n, int) else n
    eS, eN, eW, eE = seam_edges
    h0y, h1y = halo, halo + ny
    h0x, h1x = halo, halo + nx
    inv2d = _f32(1.0 / (2.0 * d))
    g = _f32(gravity)
    two_omega = _f32(2.0 * omega)

    def sg(xr_, yc_):
        return _fast_frame(xr_, yc_, radius)["sqrtg"]

    def seam(sym, row, x_, y_, on):
        if not on:
            return None
        return sym[row] if sym_prescaled else sg(x_, y_) * sym[row]

    sn_rows = (slice(None), slice(0, 1), slice(None))
    uS = seam(sym_sn, sn_rows, xr[..., h0x:h1x], yfc[..., h0y:h0y + 1, :], eS)
    uN = seam(sym_sn, (slice(None), slice(1, 2), slice(None)),
              xr[..., h0x:h1x], yfc[..., h1y:h1y + 1, :], eN)
    uW = seam(sym_we, (slice(None), slice(None), slice(0, 1)),
              xfr[..., h0x:h0x + 1], yc[..., h0y:h1y, :], eW)
    uE = seam(sym_we, (slice(None), slice(None), slice(1, 2)),
              xfr[..., h1x:h1x + 1], yc[..., h0y:h1y, :], eE)

    if precision is not None and precision.compute == "bf16":
        def lo(x):
            return x.to(torch.bfloat16)
    else:
        def lo(x):
            return x

    # ---- continuity: upwind flux with the sqrtg-folded metric ----------
    Fx = _fast_frame(xfr[..., h0x:h1x + 1], yc[..., h0y:h1y, :], radius)
    uba = 0.5 * (lo(ua[..., h0y:h1y, h0x - 1:h1x])
                 + lo(ua[..., h0y:h1y, h0x:h1x + 1]))
    ubb = 0.5 * (lo(ub[..., h0y:h1y, h0x - 1:h1x])
                 + lo(ub[..., h0y:h1y, h0x:h1x + 1]))
    ux = Fx["fg_aa"] * uba + Fx["fg_ab"] * ubb          # sqrtg u^a
    if eW or eE:
        ux = torch.cat([uW if eW else ux[..., 0:1], ux[..., 1:nx],
                        uE if eE else ux[..., nx:nx + 1]], dim=-1)
    qL, qR = pick_recon_precision(scheme, halo, nx, limiter, precision)(
        hf[..., h0y:h1y, :], -1)
    fx = torch.clamp(ux, min=0.0) * qL + torch.clamp(ux, max=0.0) * qR

    Fy = _fast_frame(xr[..., h0x:h1x], yfc[..., h0y:h1y + 1, :], radius)
    vba = 0.5 * (lo(ua[..., h0y - 1:h1y, h0x:h1x])
                 + lo(ua[..., h0y:h1y + 1, h0x:h1x]))
    vbb = 0.5 * (lo(ub[..., h0y - 1:h1y, h0x:h1x])
                 + lo(ub[..., h0y:h1y + 1, h0x:h1x]))
    uy = Fy["fg_ab"] * vba + Fy["fg_bb"] * vbb          # sqrtg u^b
    if eS or eN:
        uy = torch.cat([uS if eS else uy[..., 0:1, :], uy[..., 1:ny, :],
                        uN if eN else uy[..., ny:ny + 1, :]], dim=-2)
    qL, qR = pick_recon_precision(scheme, halo, ny, limiter, precision)(
        hf[..., :, h0x:h1x], -2)
    fy = torch.clamp(uy, min=0.0) * qL + torch.clamp(uy, max=0.0) * qR

    # ---- momentum, vector-invariant in covariant components ------------
    b0y, b1y = h0y - 1, h1y + 1
    b0x, b1x = h0x - 1, h1x + 1
    Fb = _fast_frame(xr[..., b0x:b1x], yc[..., b0y:b1y, :], radius)
    Fc = {k: _center(v) for k, v in Fb.items()}
    inv_sg_d = Fc["inv_sqrtg"] * _f32(1.0 / d)
    dh = -((fx[..., 1:] - fx[..., :-1])
           + (fy[..., 1:, :] - fy[..., :-1, :])) * inv_sg_d
    uab = ua[..., b0y:b1y, b0x:b1x]
    ubb_ = ub[..., b0y:b1y, b0x:b1x]
    uca = Fb["inv_aa"] * uab + Fb["inv_ab"] * ubb_       # u^alpha, band
    ucb = Fb["inv_ab"] * uab + Fb["inv_bb"] * ubb_       # u^beta, band
    ke = 0.5 * (uca * uab + ucb * ubb_)
    bern = g * (hf[..., b0y:b1y, b0x:b1x] + bf[..., b0y:b1y, b0x:b1x]) + ke
    dba = (bern[..., 1:-1, 2:] - bern[..., 1:-1, :-2]) * inv2d
    dbb = (bern[..., 2:, 1:-1] - bern[..., :-2, 1:-1]) * inv2d

    dub_da = (ub[..., h0y:h1y, h0x + 1:h1x + 1]
              - ub[..., h0y:h1y, h0x - 1:h1x - 1]) * inv2d
    dua_db = (ua[..., h0y + 1:h1y + 1, h0x:h1x]
              - ua[..., h0y - 1:h1y - 1, h0x:h1x]) * inv2d

    # (zeta + f) sqrtg = covariant curl + 2 Omega rhat_z sqrtg.
    rz = (fz[0] + Fc["x"] * fz[1] + Fc["y"] * fz[2]) * Fc["inv_rho"]
    absv = (dub_da - dua_db) + (two_omega * rz) * Fc["sqrtg"]

    dua = absv * ucb[..., 1:-1, 1:-1] - dba
    dub = -absv * uca[..., 1:-1, 1:-1] - dbb
    return dh, dua, dub


def _fill(q_int, gsn, gwe, fi, n, halo, corners=False):
    """Extended (6, M, M) field ``fi`` from the interior and the routed
    ghosts, in the placement of the JAX package's ``_make_fill``.

    ``corners=False`` leaves the h x h ghost corners zero: the stage's
    dimension-split stencils never read them.  ``corners=True`` fills
    them by edge-ghost averaging (``_make_fill(corners=True)``, the same
    formula as the halo exchanger's): the del^4 filter needs them, since
    its Laplacians' cross-derivative terms read the corners.  Faces may be
    6 B deep (an ensemble's folded member axis); 16-bit ghosts are
    widened by the assignment (exact).
    """
    h = halo
    i0, i1 = h, h + n
    ext = q_int.new_zeros((q_int.shape[0], n + 2 * h, n + 2 * h))
    ext[:, i0:i1, i0:i1] = q_int
    ext[:, 0:h, i0:i1] = gsn[:, fi * 2 * h:fi * 2 * h + h]
    ext[:, i1:i1 + h, i0:i1] = gsn[:, fi * 2 * h + h:(fi + 1) * 2 * h]
    ext[:, i0:i1, 0:h] = gwe[:, :, fi * 2 * h:fi * 2 * h + h]
    ext[:, i0:i1, i1:i1 + h] = gwe[:, :, fi * 2 * h + h:(fi + 1) * 2 * h]
    if corners:
        _fill_corners(ext, h, n)
    return ext


def _stage_rhs(stage, hf, ua, ub, b_ext, gsn, gwe):
    """:func:`rhs_core_cov` on ghost-filled frames with ``stage``'s
    constants, coordinate rows and precision policy and the routed
    (prescaled) sym rows, widened to f32.  Frames 6 B deep (a folded
    ensemble) read the static fz and b_ext of face ``f % 6``."""
    h = stage.halo
    reps = hf.shape[0] // 6
    fz = stage.fz if reps == 1 else stage.fz.repeat(reps, 1)
    b = b_ext if reps == 1 else b_ext.repeat(reps, 1, 1)
    return stage._rhs(fz, hf, ua, ub, b, gsn[:, 6 * h:6 * h + 2].float(),
                      gwe[:, :, 6 * h:6 * h + 2].float(),
                      sym_prescaled=stage.sym_prescaled)


def _widen(x):
    return x if x.dtype == torch.float32 else x.float()


def _stage_advance(stage, args, corners=False):
    """Fill, right-hand side and RK combine of one stage: the plain
    version's core, shared by the compact stage and the in-stage del^4
    kernel A.  Returns ``(h_new, u_new, (hf, ua, ub))``, the last the
    ghost-filled stage input (``corners``: see :func:`_fill`).

    With a carry encoding (:class:`CovStageCompact`'s ``carry_dtype``,
    ``h_offset``, ``h_scale``, ``u_scale``) the frames hold the decoded
    (absolute) values and the combine runs in stored space on the
    widened stored values, with the tendency constants ``g_dt / scale``:
    ``h_new`` / ``u_new`` are then the float32 stored-space values,
    before the storage rounding."""
    h0, u0, hc, uc, gsn, gwe, b_ext = stage._unpack(args)
    n, h = stage.n, stage.halo
    frames = tuple(_fill(stage._decode(q, fi == 0), gsn, gwe, fi, n, h,
                         corners=corners)
                   for fi, q in enumerate((hc, uc[0], uc[1])))
    dh, dua, dub = _stage_rhs(stage, *frames, b_ext, gsn, gwe)

    fa, fb = stage.fa, stage.fb

    def combine(yc, y0, tend, fg):
        if stage.with_y0:
            return (fa * _widen(y0) + fb * _widen(yc)) + fg * tend
        return _widen(yc) + fg * tend

    h_new = combine(hc, h0, dh, stage.fg_h)
    u_new = torch.stack([
        combine(uc[0], None if u0 is None else u0[0], dua, stage.fg_u),
        combine(uc[1], None if u0 is None else u0[1], dub, stage.fg_u)])
    return h_new, u_new, frames


def _store(x, dtype):
    """A float32 stored-space value in its storage ``dtype``: rounded to
    nearest even (an integer carrier also saturated), as the JAX kernel's
    ``store``."""
    if dtype == torch.float32:
        return x
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return torch.round(x).clamp(info.min, info.max).to(dtype)
    return x.to(dtype)


def cov_stage_compact_reference(stage, *args):
    """The plain PyTorch version of one compact stage.

    ``stage`` is a :class:`CovStageCompact` (its coefficients, constants,
    coordinate rows, carry encoding and precision policy); ``args`` as for
    calling it.  Used on CPU tensors by the stage itself, and by the tests
    and ``chip_smoke.py`` to hold the CUDA kernels against it.  Returns
    ``(h, u, strips_sn, strips_we)``: h and u in their storage dtypes, the
    strips in absolute units in the policy's strips dtype.
    """
    h_new, u_new, _ = _stage_advance(stage, args)
    h_abs, u_abs = h_new, u_new
    if stage.h_scale != 1.0:
        h_abs = h_abs * _f32(stage.h_scale)
    if stage.h_offset != 0.0:
        h_abs = h_abs + _f32(stage.h_offset)
    if stage.u_scale != 1.0:
        u_abs = u_abs * _f32(stage.u_scale)
    sn, we = pack_strips_cov_split(h_abs, u_abs, stage.n, stage.halo)
    return (_store(h_new, stage.cdt_h), _store(u_new, stage.cdt_u),
            sn.to(stage.sdt), we.to(stage.sdt))


# ---------------------------------------------------------------------------
# The stage: kernel wrapper
# ---------------------------------------------------------------------------


def _kernel(mode: str = "mc"):
    """The stage kernel of reconstruction ``mode``: 14 tensor pointers; n,
    halo, with_y0; 8 float constants; the stream."""
    return _entry("cov_stage", _entry_name("cov_stage_compact", mode),
                  [_P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8
                  + [_P])


class _ConstsBase(KernelBase):
    """Float32 constants of the covariant right-hand side: what every
    kernel wrapper of this module shares.

    ``scheme`` and ``limiter`` pick the reconstruction, ``mode`` names it
    (``"ppm"``, or the PLR limiter): every kernel takes every mode, one
    instance each."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", device="cuda"):
        self.mode = _recon_mode(scheme, limiter, halo)
        self.n, self.halo, self.m = n, halo, n + 2 * halo
        self.dalpha, self.radius = float(dalpha), float(radius)
        self.gravity, self.omega = float(gravity), float(omega)
        self.scheme, self.limiter = scheme, limiter
        # The kernels' float32 constants of the RHS, rounded as
        # rhs_core_cov and _fast_frame round them.
        self._rhs_consts = (
            _f32(_f32(self.radius) ** 2), _f32(self.gravity),
            _f32(2.0 * self.omega), _f32(1.0 / (2.0 * self.dalpha)),
            _f32(1.0 / self.dalpha))
        self.device = torch.device(device)
        #: The stage precision policy (a resolved StagePrecision, None =
        #: f32); the stage wrappers that take one set it.
        self.precision = None


class _RhsBase(_ConstsBase):
    """The constants, coordinate rows and face frames of whole faces."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, device=device)
        def rows():
            x_row, xf_row, x_col, xf_col, frames = coord_rows(n, halo,
                                                              self.device)
            return (x_row, xf_row, x_col, xf_col,
                    frames[:, :, 2].contiguous())   # (6, 3) frame z

        *coords, self.fz = table(f"stage_rows/{n}/{halo}/{self.device}",
                                 rows)
        self.coords = tuple(coords)
        self._xc = coords[0].reshape(-1).contiguous()
        self._xf = coords[1].reshape(-1).contiguous()

    def _rhs(self, fz, hf, ua, ub, b_ext, sym_sn, sym_we, sym_prescaled):
        """:func:`rhs_core_cov` with these constants and coordinate rows;
        ``fz`` (F, 3) gives the faces' frame z-components."""
        x_row, xf_row, x_col, xf_col = self.coords
        fzs = tuple(fz[:, k].reshape(-1, 1, 1) for k in range(3))
        return rhs_core_cov(
            fzs, x_row, xf_row, x_col, xf_col, hf, ua, ub, b_ext, sym_sn,
            sym_we, n=self.n, halo=self.halo, d=self.dalpha,
            radius=self.radius, gravity=self.gravity, omega=self.omega,
            scheme=self.scheme, limiter=self.limiter,
            sym_prescaled=sym_prescaled, precision=self.precision)


#: The carry storage dtypes of the compact stage and their codes in the
#: policy kernel (``csrc/cov_half.cuh``'s ``Carry``).
_CARRY_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int16: 3}


class _StageBase(_RhsBase):
    """Coefficients and constants of one covariant SSPRK3 stage
    ``a*y0 + b*yc + b*dt*L(yc)``, and the checks of its arguments: what
    the stage kernels' wrappers share."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, a: float, b: float,
                 scheme: str = "plr", limiter: str = "mc", device="cuda",
                 precision=None):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, device=device)
        self.precision = resolve_stage_precision(precision)
        self.sdt = (torch.float32 if self.precision is None
                    else self.precision.strips_dtype)
        # PPM under a bf16 compute policy raises here, as in the JAX
        # package's stage factories.
        pick_recon_precision(scheme, halo, n, limiter, self.precision)
        self.a, self.b, self.dt = float(a), float(b), float(dt)
        if self.a == 0.0 and self.b != 1.0:
            raise NotImplementedError(
                f"a stage with a == 0 must have b == 1 (SSPRK3 stage 1); "
                f"got b={b!r}")
        # Stage 1 computes yc + g*L; stages 2-3 (a*y0 + b*yc) + g*L.
        self.with_y0 = self.a != 0.0
        self.fa, self.fb = _f32(self.a), _f32(self.b)
        self.fg = _f32(self.b * self.dt)
        self._kconsts = self._rhs_consts + (self.fa, self.fb, self.fg)
        # The carry encoding and the sym rows' form (CovStageCompact sets
        # them): float32, as is; prescaled.
        self.sym_prescaled = True
        self.cdt_h = self.cdt_u = torch.float32
        self.h_offset, self.h_scale, self.u_scale = 0.0, 1.0, 1.0
        self.fg_h = self.fg_u = self.fg

    def _decode(self, q, is_h):
        """A carried field's absolute float32 values: widened, times the
        scale where it is not 1, plus h's offset where it is not 0."""
        q = _widen(q)
        scale = self.h_scale if is_h else self.u_scale
        if scale != 1.0:
            q = q * _f32(scale)
        if is_h and self.h_offset != 0.0:
            q = q + _f32(self.h_offset)
        return q

    def _unpack(self, args):
        if self.with_y0:
            if len(args) != 7:
                raise TypeError("stage(h0, u0, hc, uc, gsn, gwe, b_ext) "
                                f"takes 7 tensors, got {len(args)}")
            return args
        if len(args) != 5:
            raise TypeError("stage(hc, uc, gsn, gwe, b_ext) takes 5 "
                            f"tensors, got {len(args)}")
        return (None, None) + tuple(args)

    def _check(self, h0, u0, hc, uc, gsn, gwe, b_ext):
        n, h, m = self.n, self.halo, self.m
        want = {"hc": (hc, (6, n, n)), "uc": (uc, (2, 6, n, n)),
                "gsn": (gsn, (6, 6 * h + 2, n)),
                "gwe": (gwe, (6, n, 6 * h + 2)), "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (6, n, n))
            want["u0"] = (u0, (2, 6, n, n))
        _check_tensors(want, self.device)


class CovStageCompact(_StageBase):
    """One fused covariant SSPRK3 stage over interior-only state.

    ``a == 0``: ``stage(hc, uc, gsn, gwe, b_ext)``; else
    ``stage(h0, u0, hc, uc, gsn, gwe, b_ext)``.  Computes
    ``a*y0 + b*yc + b*dt*L(yc)`` with the combine association of the JAX
    kernel, and returns ``(h, u, strips_sn, strips_we)``.

    The JAX kernel's knobs:

    * ``groups = 6 B``: the carry holds B ensemble members with the member
      axis folded into the face axis (``h (6B, n, n)``, ``u (2, 6B, n,
      n)``, routed ghosts ``(6B, ...)``); ``b_ext`` stays ``(6, M, M)``.
    * ``carry_dtype`` (one dtype or ``(h_dtype, u_dtype)``, each float32,
      bfloat16, float16 or int16), ``h_offset``, ``h_scale``, ``u_scale``:
      h stored as ``(h - h_offset) / h_scale``, u as ``u / u_scale``; the
      combine runs in stored space (``h_offset`` needs coefficients
      summing to 1), integer storage rounds to nearest even, the strips
      come out in absolute units.
    * ``precision``: the stage policy (:mod:`.precision`): bf16 limiter
      algebra and face-average velocities, bf16 strips in and out.
    * ``sym_prescaled=False``: the routed sym rows come un-prescaled and
      the stage multiplies them by the edge sqrtg (the JAX split del^4
      stepper's form).

    Every reconstruction (PLR with each limiter; PPM at halo >= 3, not
    under bf16 compute).  CUDA tensors launch the mode's instance of
    ``csrc/cov_stage.cu`` for one member, a float32 carry and no policy,
    else of ``csrc/cov_stage_policy.cu`` (``cov_stage_policy_bf16.cu``
    under bf16 compute, ``cov_stage_members.cu`` for more members with
    a float32 carry and no policy); CPU tensors run
    :func:`cov_stage_compact_reference`.  There is no other path: a kernel
    that fails to build or launch raises.
    """

    #: Launches of the CUDA kernels, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, a: float, b: float,
                 scheme: str = "plr", limiter: str = "mc", device="cuda",
                 carry_dtype=None, h_offset: float = 0.0,
                 h_scale: float = 1.0, u_scale: float = 1.0,
                 groups: int = 6, precision=None,
                 sym_prescaled: bool = True):
        super().__init__(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                         scheme=scheme, limiter=limiter, device=device,
                         precision=precision)
        self.sym_prescaled = bool(sym_prescaled)
        if carry_dtype is None:
            carry_dtype = torch.float32
        self.cdt_h, self.cdt_u = (
            tuple(carry_dtype) if isinstance(carry_dtype, (tuple, list))
            else (carry_dtype,) * 2)
        for dt_ in (self.cdt_h, self.cdt_u):
            if dt_ not in _CARRY_CODES:
                raise ValueError(
                    f"carry_dtype {dt_} is not a carry storage type; valid: "
                    + ", ".join(str(d) for d in _CARRY_CODES))
        self.h_offset = float(h_offset)
        self.h_scale, self.u_scale = float(h_scale), float(u_scale)
        a_, b_ = self.a, self.b
        if self.h_offset != 0.0 and ((self.with_y0 and abs(a_ + b_ - 1.0)
                                      > 1e-9)
                                     or (not self.with_y0 and b_ != 1.0)):
            raise ValueError("h_offset needs stage coefficients summing to "
                             "1 (anomaly combine is only exact then); got "
                             f"a={a_}, b={b_}")
        if groups < 6 or groups % 6:
            raise ValueError(
                f"groups must be a positive multiple of 6 (6 * ensemble "
                f"members), got {groups}")
        self.groups, self.members = groups, groups // 6
        g_dt = self.b * self.dt
        self.fg_h = self.fg if self.h_scale == 1.0 else _f32(g_dt
                                                             / self.h_scale)
        self.fg_u = self.fg if self.u_scale == 1.0 else _f32(g_dt
                                                             / self.u_scale)
        self.encoded = not (self.cdt_h == self.cdt_u == torch.float32
                            and self.h_offset == 0.0 and self.h_scale == 1.0
                            and self.u_scale == 1.0)
        #: cov_stage.cu's instance (else cov_stage_policy.cu's).
        self.plain = (self.members == 1 and not self.encoded
                      and self.precision is None and self.sym_prescaled)
        self._pconsts = self._rhs_consts + (
            self.fa, self.fb, self.fg_h, self.fg_u, _f32(self.h_scale),
            _f32(self.h_offset), _f32(self.u_scale))

    def _check(self, h0, u0, hc, uc, gsn, gwe, b_ext):
        n, h, m, G = self.n, self.halo, self.m, self.groups
        ch, cu, sd = self.cdt_h, self.cdt_u, self.sdt
        want = {"hc": (hc, (G, n, n), ch), "uc": (uc, (2, G, n, n), cu),
                "gsn": (gsn, (G, 6 * h + 2, n), sd),
                "gwe": (gwe, (G, n, 6 * h + 2), sd),
                "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (G, n, n), ch)
            want["u0"] = (u0, (2, G, n, n), cu)
        _check_tensors(want, self.device)

    def __call__(self, *args):
        h0, u0, hc, uc, gsn, gwe, b_ext = self._unpack(args)
        self._check(h0, u0, hc, uc, gsn, gwe, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_compact_reference(self, *args)
        return self._launch(h0, u0, hc, uc, gsn, gwe, b_ext)

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_compact_reference(self, *args)

    @property
    def kernel_name(self) -> str:
        """The C entry point a launch takes."""
        if self.plain:
            return _entry_name("cov_stage_compact", self.mode)
        if not self.encoded and self.precision is None \
                and self.sym_prescaled:
            return f"cov_stage_members_{self.mode}_f32"
        compute = ("bf16" if self.precision is not None
                   and self.precision.compute == "bf16" else "f32")
        return f"cov_stage_policy_{self.mode}_{compute}"

    def _launch(self, h0, u0, hc, uc, gsn, gwe, b_ext):
        n, h, G = self.n, self.halo, self.groups
        ho = torch.empty_like(hc)
        uo = torch.empty_like(uc)
        ssn = gsn.new_empty((G, 6 * h, n))
        swe = gsn.new_empty((G, n, 6 * h))
        if self.plain:
            rc = _kernel(self.mode)(
                _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
                gsn.data_ptr(), gwe.data_ptr(), b_ext.data_ptr(),
                self._xc.data_ptr(), self._xf.data_ptr(), self.fz.data_ptr(),
                ho.data_ptr(), uo.data_ptr(), ssn.data_ptr(), swe.data_ptr(),
                n, h, int(self.with_y0), *self._kconsts, self._stream())
        else:
            rc = _policy_kernel(self.kernel_name)(
                _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
                gsn.data_ptr(), gwe.data_ptr(), b_ext.data_ptr(),
                self._xc.data_ptr(), self._xf.data_ptr(), self.fz.data_ptr(),
                ho.data_ptr(), uo.data_ptr(), ssn.data_ptr(), swe.data_ptr(),
                n, h, int(self.with_y0), self.members,
                _CARRY_CODES[self.cdt_h], _CARRY_CODES[self.cdt_u],
                int(self.sdt == torch.bfloat16), int(not self.sym_prescaled),
                *self._pconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"{self.kernel_name} kernel launch failed: cudaError {rc} "
                f"(n={n}, halo={h}, mode={self.mode}, groups={G})")
        CovStageCompact.launches += 1
        return ho, uo, ssn, swe


def _policy_kernel(name: str):
    """cov_stage_policy.cu's entry ``name``: 14 tensor pointers; n, halo,
    with_y0, members, the h and u carry codes, s16, frame; 12 float
    constants; the stream."""
    lib = ("cov_stage_members" if name.startswith("cov_stage_members")
           else "cov_stage_policy_bf16" if name.endswith("_bf16")
           else "cov_stage_policy")
    return _entry(lib, name, [_P] * 14 + [ctypes.c_int] * 8
                  + [ctypes.c_float] * 12 + [_P])


def make_cov_stage_compact(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                           scheme="plr", limiter="mc", device="cuda",
                           carry_dtype=None, h_offset=0.0, h_scale=1.0,
                           u_scale=1.0, groups=6, precision=None,
                           sym_prescaled=True):
    """One compact stage (see :class:`CovStageCompact`)."""
    return CovStageCompact(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                           scheme=scheme, limiter=limiter, device=device,
                           carry_dtype=carry_dtype, h_offset=h_offset,
                           h_scale=h_scale, u_scale=u_scale, groups=groups,
                           precision=precision, sym_prescaled=sym_prescaled)


def make_fused_ssprk3_cov_compact(grid, gravity: float, omega: float,
                                  dt: float, b_ext, scheme: str = "plr",
                                  limiter: str = "mc", carry_dtype=None,
                                  h_offset: float = 0.0,
                                  h_scale: float = 1.0, u_scale: float = 1.0,
                                  ensemble: int = 0, precision=None,
                                  prescale_sym: bool = True):
    """``step(y, t) -> y`` over ``y = {h, u, strips_sn, strips_we}``.

    Three stages, each one strip route and one stage launch; initialise
    the carry with ``CovariantShallowWater.compact_state`` (encoded per
    ``carry_dtype`` / ``h_offset`` / ``h_scale`` / ``u_scale`` with
    ``encode_carry``).  ``precision``: the stage policy; a 16-bit strips
    policy takes an f32 initial strip carry (the first route narrows it).

    ``ensemble = B > 0``: the carry gains a leading member axis (``h (B, 6,
    n, n)``, ``u (2, B, 6, n, n)``, ``strips_* (B, 6, ...)``; initialise
    with ``ensemble_compact_state``); each stage is one launch over the
    ``6 B`` folded faces and each route one batched route over the
    members.  Per member the arithmetic is the unbatched step's, so
    member i is bitwise its own run.  ``prescale_sym=False``: the route
    leaves the sym rows un-prescaled and the stages scale them.
    """
    B = int(ensemble)
    precision = resolve_stage_precision(precision)
    route = make_cov_strip_router_split(grid, precision=precision,
                                        prescale_sym=prescale_sym)
    stages = [make_cov_stage_compact(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device,
        carry_dtype=carry_dtype, h_offset=h_offset, h_scale=h_scale,
        u_scale=u_scale, groups=6 * max(B, 1), precision=precision,
        sym_prescaled=prescale_sym)
        for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

    if not B:
        def step(y, t):
            del t
            h0, u0 = y["h"], y["u"]
            gsn, gwe = route(y["strips_sn"], y["strips_we"])
            h1, u1, sn1, we1 = stage1(h0, u0, gsn, gwe, b_ext)
            gsn, gwe = route(sn1, we1)
            h2, u2, sn2, we2 = stage2(h0, u0, h1, u1, gsn, gwe, b_ext)
            gsn, gwe = route(sn2, we2)
            h3, u3, sn3, we3 = stage3(h0, u0, h2, u2, gsn, gwe, b_ext)
            return {"h": h3, "u": u3, "strips_sn": sn3, "strips_we": we3}
    else:
        # (B, 6) <-> 6B around the stage launches: views of contiguous
        # tensors.
        def fold(x, lead=0):
            s_ = x.shape
            return x.reshape(s_[:lead] + (B * 6,) + s_[lead + 2:])

        def unfold(x, lead=0):
            s_ = x.shape
            return x.reshape(s_[:lead] + (B, 6) + s_[lead + 1:])

        def step(y, t):
            del t
            h0, u0 = fold(y["h"]), fold(y["u"], 1)
            gsn, gwe = route(y["strips_sn"], y["strips_we"])
            h1, u1, sn1, we1 = stage1(h0, u0, fold(gsn), fold(gwe), b_ext)
            gsn, gwe = route(unfold(sn1), unfold(we1))
            h2, u2, sn2, we2 = stage2(h0, u0, h1, u1, fold(gsn), fold(gwe),
                                      b_ext)
            gsn, gwe = route(unfold(sn2), unfold(we2))
            h3, u3, sn3, we3 = stage3(h0, u0, h2, u2, fold(gsn), fold(gwe),
                                      b_ext)
            return {"h": unfold(h3), "u": unfold(u3, 1),
                    "strips_sn": unfold(sn3), "strips_we": unfold(we3)}

        step.ensemble = B

    step.route = route
    step.stages = stages
    return step


def make_fused_ssprk3_cov_multistep(grid, gravity: float, omega: float,
                                    dt: float, b_ext, temporal_block: int,
                                    scheme: str = "plr", limiter: str = "mc",
                                    carry_dtype=None, h_offset: float = 0.0,
                                    h_scale: float = 1.0,
                                    u_scale: float = 1.0, ensemble: int = 0,
                                    precision=None):
    """``block(y, t) -> y``: ``temporal_block`` compact steps per call
    (:func:`~jaxstream_torch.stepping.blocked`, exact: bitwise k separate
    calls), with ``steps_per_call`` set; k = 1 is
    :func:`make_fused_ssprk3_cov_compact`."""
    if temporal_block < 1:
        raise ValueError(
            f"temporal_block must be >= 1, got {temporal_block}")
    step1 = make_fused_ssprk3_cov_compact(
        grid, gravity, omega, dt, b_ext, scheme=scheme, limiter=limiter,
        carry_dtype=carry_dtype, h_offset=h_offset, h_scale=h_scale,
        u_scale=u_scale, ensemble=ensemble, precision=precision)
    if temporal_block == 1:
        return step1
    from ...stepping import blocked

    block = blocked(step1, temporal_block, dt)
    block.steps_per_call = temporal_block
    if ensemble:
        block.ensemble = int(ensemble)
    return block


# ---------------------------------------------------------------------------
# The del^4 filter: plain version
# ---------------------------------------------------------------------------


def lap_core(xr, xfr, yc, yfc, psi, *, n, halo, d, radius, ring=0):
    """Laplace-Beltrami of ghost-filled ``(..., M, M)`` faces.

    The plain twin of the JAX package's ``lap_core``: the conservative
    flux form of :func:`jaxstream_torch.ops.fv.laplacian` with face
    metrics from the closed forms of :func:`_fast_frame`.  ``ring``: how
    many ghost rings the output includes — 0 gives the interior
    ``(n, n)``, ``ring=g`` gives ``(n+2g, n+2g)``, the operator evaluated
    face-locally on the innermost ``g`` ghost rings too.  Those stencils
    read ghosts to depth ``g+1`` and the filled corners, so
    ``0 <= ring <= halo-1``.
    """
    if not 0 <= ring <= halo - 1:
        raise ValueError(f"lap_core: ring={ring} needs 0 <= ring <= "
                         f"halo-1 (halo={halo}; the ring stencil reads "
                         "ghosts to depth ring+1)")
    h0, h1 = halo - ring, halo + n + ring
    invd = _f32(1.0 / d)
    inv2d = _f32(0.5 / d)

    pr = psi[..., h0:h1, :]
    dpa = (pr[..., h0:h1 + 1] - pr[..., h0 - 1:h1]) * invd
    dpb_c = (psi[..., h0 + 1:h1 + 1, :] - psi[..., h0 - 1:h1 - 1, :]) * inv2d
    dpb_f = 0.5 * (dpb_c[..., h0 - 1:h1] + dpb_c[..., h0:h1 + 1])
    Fx = _fast_frame(xfr[:, h0:h1 + 1], yc[h0:h1], radius)
    fx = Fx["fg_aa"] * dpa + Fx["fg_ab"] * dpb_f

    pc = psi[..., :, h0:h1]
    dpb = (pc[..., h0:h1 + 1, :] - pc[..., h0 - 1:h1, :]) * invd
    dpa_c = (psi[..., :, h0 + 1:h1 + 1] - psi[..., :, h0 - 1:h1 - 1]) * inv2d
    dpa_f = 0.5 * (dpa_c[..., h0 - 1:h1, :] + dpa_c[..., h0:h1 + 1, :])
    Fy = _fast_frame(xr[:, h0:h1], yfc[h0:h1 + 1], radius)
    fy = Fy["fg_bb"] * dpb + Fy["fg_ab"] * dpa_f

    Fc = _fast_frame(xr[:, h0:h1], yc[h0:h1], radius)
    return ((fx[..., 1:] - fx[..., :-1]) + (fy[..., 1:, :] - fy[..., :-1, :])
            ) * (Fc["inv_sqrtg"] * invd)


def _nu4_filtered_value(xr, xfr, yc, yfc, psi, iv, *, n, halo, d, radius,
                        damp):
    """``q - damp * lap(lap q)``: the one definition of the filter's
    arithmetic.  The first Laplacian runs on ring 1 of the halo-deep
    frame ``psi``, so the second needs no ghost exchange; the second runs
    on l1's ``(n+2)^2`` window, whose coordinate windows are
    ``[h-1 : m-h+1]`` (centers) and ``[h-1 : m-h+2]`` (faces).  ``iv``:
    the unfiltered interior values."""
    m = n + 2 * halo
    h = halo
    l1 = lap_core(xr, xfr, yc, yfc, psi, n=n, halo=halo, d=d,
                  radius=radius, ring=1)
    l2 = lap_core(xr[:, h - 1:m - h + 1], xfr[:, h - 1:m - h + 2],
                  yc[h - 1:m - h + 1, :], yfc[h - 1:m - h + 2, :],
                  l1, n=n, halo=1, d=d, radius=radius)
    return iv - damp * l2


def cov_nu4_filter_reference(filt, hc, uc, gsn, gwe):
    """The plain PyTorch version of the whole filter.

    ``filt`` is a :class:`CovNu4Filter` (its constants and coordinate
    rows).  Each of h, u_a, u_b gets its ghosts and averaged corners
    from the routed blocks ``gsn``/``gwe`` (their sym rows are not read)
    and becomes ``q - damp * lap(lap q)``.  Used on CPU tensors by the
    filter itself and by the tests and ``chip_smoke.py`` to hold the CUDA
    kernel against it; it also runs in float64.  Returns
    ``(h, u, strips_sn, strips_we)``, the strips in the filter's strips
    dtype (16-bit ghosts are widened by the fill).
    """
    n, h = filt.n, filt.halo
    x_row, xf_row, x_col, xf_col = filt.coords
    out = [_nu4_filtered_value(
        x_row, xf_row, x_col, xf_col,
        _fill(q, gsn, gwe, fi, n, h, corners=True), q,
        n=n, halo=h, d=filt.dalpha, radius=filt.radius, damp=filt.damp)
        for fi, q in enumerate((hc, uc[0], uc[1]))]
    h_new, u_new = out[0], torch.stack(out[1:])
    sn, we = pack_strips_cov_split(h_new, u_new, n, h)
    sdt = getattr(filt, "sdt", torch.float32)
    return h_new, u_new, sn.to(sdt), we.to(sdt)


# ---------------------------------------------------------------------------
# The del^4 filter: kernel wrapper
# ---------------------------------------------------------------------------


def _filter_kernel(strips: str = "f32"):
    """The filter kernel of strips dtype ``strips`` (``"f32"``, or
    ``"bf16"``: ``csrc/cov_nu4_filter_bf16.cu``): 10 tensor pointers; n,
    halo; R^2, 1/d, 0.5/d, damp; the stream."""
    lib, name = (("cov_nu4_filter", "cov_nu4_filter_f32") if strips == "f32"
                 else ("cov_nu4_filter_bf16", "cov_nu4_filter_bf16"))
    return _entry(lib, name, [_P] * 10 + [ctypes.c_int] * 2
                  + [ctypes.c_float] * 4 + [_P])


class CovNu4Filter:
    """The once-per-step del^4 filter ``q -= dt_eff nu4 lap(lap q)``.

    ``filt(hc, uc, gsn, gwe) -> (h, u, strips_sn, strips_we)`` on h,
    u_a, u_b, with ghosts from the routed blocks of the state's strips.
    CUDA tensors launch ``csrc/cov_nu4_filter.cu`` (the port of the
    Pallas kernel ``make_cov_nu4_filter``); CPU tensors run
    :func:`cov_nu4_filter_reference`.  There is no other path: a kernel
    that fails to build or launch raises.

    ``precision``: under a 16-bit strips policy the routed ghosts arrive
    and the strips leave in bfloat16 (``csrc/cov_nu4_filter_bf16.cu``);
    the filter arithmetic stays float32.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 nu4: float, dt_eff: float, device="cuda", precision=None):
        if halo < 2:
            raise ValueError(f"split nu4 filter needs halo >= 2 (ring-1 "
                             f"first Laplacian), got halo={halo}")
        self.n, self.halo = n, halo
        self.dalpha, self.radius = float(dalpha), float(radius)
        self.nu4, self.dt_eff = float(nu4), float(dt_eff)
        # Rounded once from float64, as the JAX kernel rounds it.
        self.damp = _f32(self.dt_eff * self.nu4)
        # The kernel's float32 constants, rounded as lap_core and
        # _fast_frame round them.
        self._kconsts = (_f32(_f32(self.radius) ** 2),
                         _f32(1.0 / self.dalpha), _f32(0.5 / self.dalpha),
                         self.damp)
        self.device = torch.device(device)
        x_row, xf_row, x_col, xf_col, _ = coord_rows(n, halo, self.device)
        self.coords = (x_row, xf_row, x_col, xf_col)
        self._xc = x_row.reshape(-1).contiguous()
        self._xf = xf_row.reshape(-1).contiguous()
        pol = resolve_stage_precision(precision)
        self.sdt = torch.float32 if pol is None else pol.strips_dtype

    def _check(self, hc, uc, gsn, gwe):
        n, h, sd = self.n, self.halo, self.sdt
        _check_tensors({"hc": (hc, (6, n, n)), "uc": (uc, (2, 6, n, n)),
                        "gsn": (gsn, (6, 6 * h + 2, n), sd),
                        "gwe": (gwe, (6, n, 6 * h + 2), sd)}, self.device)

    def __call__(self, hc, uc, gsn, gwe):
        self._check(hc, uc, gsn, gwe)
        if hc.device.type == "cpu":
            return cov_nu4_filter_reference(self, hc, uc, gsn, gwe)
        if hc.device.type != "cuda":
            raise ValueError(f"unsupported device {hc.device}")
        return self._launch(hc, uc, gsn, gwe)

    def reference(self, hc, uc, gsn, gwe):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_nu4_filter_reference(self, hc, uc, gsn, gwe)

    def _launch(self, hc, uc, gsn, gwe):
        n, h = self.n, self.halo
        ho = torch.empty_like(hc)
        uo = torch.empty_like(uc)
        ssn = gsn.new_empty((6, 6 * h, n))
        swe = gsn.new_empty((6, n, 6 * h))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        strips = "bf16" if self.sdt == torch.bfloat16 else "f32"
        rc = _filter_kernel(strips)(
            hc.data_ptr(), uc.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
            self._xc.data_ptr(), self._xf.data_ptr(), ho.data_ptr(),
            uo.data_ptr(), ssn.data_ptr(), swe.data_ptr(),
            n, h, *self._kconsts, stream)
        if rc != 0:
            raise RuntimeError(
                f"cov_nu4_filter kernel launch failed: cudaError {rc} "
                f"(n={n}, halo={h})")
        CovNu4Filter.launches += 1
        return ho, uo, ssn, swe


def make_cov_nu4_filter(grid, nu4: float, dt_eff: float, device=None,
                        precision=None):
    """The del^4 filter on ``grid`` (see :class:`CovNu4Filter`); ``device``
    defaults to the grid's."""
    return CovNu4Filter(grid.n, grid.halo, grid.dalpha, grid.radius, nu4,
                        dt_eff, device=grid.device if device is None
                        else device, precision=precision)


def make_fused_ssprk3_cov_split_nu4(grid, gravity: float, omega: float,
                                    dt: float, b_ext, nu4: float,
                                    interval: int = 1, scheme: str = "plr",
                                    limiter: str = "mc", precision=None):
    """``step(y, t) -> y``: the three compact stages of
    :func:`make_fused_ssprk3_cov_compact`, then one route and one del^4
    filter launch — the JAX package's ``nu4_mode='split'`` stepper.

    The split is first order in time in the filter term, the standard
    operator-split treatment of hyperdiffusion.  The stages and the
    filter share the prescaled router: the filter reads only the ghost
    blocks, never the sym rows.

    ``interval``: filter every ``interval``-th step with an
    ``interval x`` coefficient.  For ``interval > 1`` the carry needs an
    integer step counter ``"filter_k"`` (a Python int, so the branch
    costs no device sync): seed it as
    ``dict(model.compact_state(state), filter_k=0)``.  It is never
    reconstructed as ``round(t/dt)``, which an accumulated ``t`` can make
    skip or repeat an index.

    ``precision``: the stage policy for the stages and the router; the
    filter takes its strips half (its arithmetic stays f32).  The JAX
    package's split stepper routes the sym rows un-prescaled and scales
    them in the stages; in float32 that is bitwise the prescaled form
    this stepper takes, under 16-bit strips it is not (the rounding lands
    on the unscaled row), so 16-bit strips take the JAX form.
    """
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    precision = resolve_stage_precision(precision)
    advance = make_fused_ssprk3_cov_compact(
        grid, gravity, omega, dt, b_ext, scheme=scheme, limiter=limiter,
        precision=precision,
        prescale_sym=precision is None or precision.strips != "bf16")
    route = advance.route
    filt = make_cov_nu4_filter(grid, nu4, dt * interval,
                               precision=precision)

    def filtered(y):
        gsn, gwe = route(y["strips_sn"], y["strips_we"])
        hf, uf, snf, wef = filt(y["h"], y["u"], gsn, gwe)
        return {"h": hf, "u": uf, "strips_sn": snf, "strips_we": wef}

    def step(y, t):
        y3 = advance(y, t)
        if interval == 1:
            return filtered(y3)
        if "filter_k" not in y:
            raise ValueError(
                "the interval > 1 filter-cycling carry needs an integer "
                "'filter_k' step counter; seed it as "
                "dict(model.compact_state(state), filter_k=0)")
        k = y["filter_k"]
        if not isinstance(k, int):
            raise TypeError(f"filter_k must be a Python int, got {type(k)}")
        out = filtered(y3) if k % interval == interval - 1 else y3
        return dict(out, filter_k=(k + 1) % interval)

    step.route = route
    step.stages = advance.stages
    step.filter = filt
    return step


# ---------------------------------------------------------------------------
# Re-fused del^4: the filter folded into the stage-1 kernel
# ---------------------------------------------------------------------------


def cov_stage_refused_nu4_reference(stage, hc, uc, gsn, gwe, b_ext):
    """The plain PyTorch version of the re-fused stage 1.

    ``stage`` is a :class:`CovStageRefusedNu4`.  Each of h, u_a, u_b gets
    its ghosts and averaged corners from the routed blocks and is filtered
    on the interior, ``fv = q - damp lap(lap q)``
    (:func:`_nu4_filtered_value`); ``fv`` replaces the frame's interior
    and the ghosts stay unfiltered (the JAX design's O(damp) seam
    inconsistency: filtered ghosts would need deeper strips).  The
    right-hand side runs on those frames with the prescaled sym rows.
    Returns ``(h1, u1, h0f, u0f, strips_sn, strips_we)``: ``h1 = fv +
    f32(dt) L``, the filtered base ``(h0f, u0f)`` for stages 2 and 3, and
    the strips of ``(h1, u1)``.  It also runs in float64.
    """
    n, h = stage.n, stage.halo
    i0, i1 = h, h + n
    x_row, xf_row, x_col, xf_col = stage.coords
    frames, filt = [], []
    for fi, q in enumerate((hc, uc[0], uc[1])):
        ext = _fill(q, gsn, gwe, fi, n, h, corners=True)
        fv = _nu4_filtered_value(
            x_row, xf_row, x_col, xf_col, ext, q, n=n, halo=h,
            d=stage.dalpha, radius=stage.radius, damp=stage.damp)
        ext[:, i0:i1, i0:i1] = fv
        frames.append(ext)
        filt.append(fv)
    tends = _stage_rhs(stage, *frames, b_ext, gsn, gwe)
    h1, ua1, ub1 = (fv + stage.fg * tend for fv, tend in zip(filt, tends))
    u1 = torch.stack([ua1, ub1])
    sn, we = pack_strips_cov_split(h1, u1, n, h)
    return (h1, u1, filt[0], torch.stack(filt[1:]), sn.to(stage.sdt),
            we.to(stage.sdt))


def _refused_kernel(mode: str = "mc"):
    """The re-fused stage-1 kernel of reconstruction ``mode``: 14 tensor
    pointers; n, halo; 7 float constants; the stream."""
    return _entry("cov_stage_refused_nu4",
                  _entry_name("cov_stage_refused_nu4", mode),
                  [_P] * 14 + [ctypes.c_int] * 2 + [ctypes.c_float] * 7
                  + [_P])


def _refused_policy_kernel(mode: str, compute: str):
    """The re-fused stage-1 kernel under the stage precision policy
    (``csrc/cov_stage_refused_nu4_policy.cu``, the bf16 compute instances
    ``..._policy_bf16.cu``): 14 tensor pointers; n, halo, s16; 7 float
    constants; the stream."""
    lib = "cov_stage_refused_nu4_policy" + (
        "_bf16" if compute == "bf16" else "")
    return _entry(lib, f"cov_stage_refused_nu4_policy_{mode}_{compute}",
                  [_P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] * 7
                  + [_P])


class CovStageRefusedNu4(_StageBase):
    """Stage 1 with the del^4 filter fused in front of the RHS.

    ``stage1f(hc, uc, gsn, gwe, b_ext) -> (h1, u1, h0f, u0f, strips_sn,
    strips_we)``: the filter ``q -= dt nu4 lap(lap q)`` on the interiors
    of h, u_a, u_b (the split filter's arithmetic, ring-1 first
    Laplacian), then the plain stage-1 RHS and combine on the filtered
    interior with the unfiltered routed ghosts.  Every reconstruction
    (PLR with each limiter; PPM at halo >= 3): CUDA tensors launch the
    mode's instance of ``csrc/cov_stage_refused_nu4.cu`` (the port of the
    Pallas kernel ``make_cov_stage_refused_nu4``); CPU tensors run
    :func:`cov_stage_refused_nu4_reference`.  There is no other path: a
    kernel that fails to build or launch raises.  ``precision``: the
    stage policy, compute and strips (``csrc/cov_stage_refused_nu4_policy
    .cu`` and ``..._policy_bf16.cu``); the filter arithmetic stays f32.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, nu4: float,
                 scheme: str = "plr", limiter: str = "mc", device="cuda",
                 precision=None):
        super().__init__(n, halo, dalpha, radius, gravity, omega, dt, 0.0,
                         1.0, scheme=scheme, limiter=limiter, device=device,
                         precision=precision)
        self.nu4 = float(nu4)
        # Rounded once from float64, as the JAX kernel rounds it.
        self.damp = _f32(self.dt * self.nu4)
        self._rconsts = self._kconsts[:5] + (self.fg, self.damp)

    def _check(self, h0, u0, hc, uc, gsn, gwe, b_ext):
        n, h, m, sd = self.n, self.halo, self.m, self.sdt
        _check_tensors({"hc": (hc, (6, n, n)), "uc": (uc, (2, 6, n, n)),
                        "gsn": (gsn, (6, 6 * h + 2, n), sd),
                        "gwe": (gwe, (6, n, 6 * h + 2), sd),
                        "b_ext": (b_ext, (6, m, m))}, self.device)

    def __call__(self, hc, uc, gsn, gwe, b_ext):
        self._check(None, None, hc, uc, gsn, gwe, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_refused_nu4_reference(self, hc, uc, gsn, gwe,
                                                   b_ext)
        n, h = self.n, self.halo
        outs = (torch.empty_like(hc), torch.empty_like(uc),
                torch.empty_like(hc), torch.empty_like(uc),
                gsn.new_empty((6, 6 * h, n)), gsn.new_empty((6, n, 6 * h)))
        ptrs = (hc.data_ptr(), uc.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
                b_ext.data_ptr(), self._xc.data_ptr(), self._xf.data_ptr(),
                self.fz.data_ptr(), *[t.data_ptr() for t in outs])
        if self.precision is None:
            rc = _refused_kernel(self.mode)(
                *ptrs, n, h, *self._rconsts, self._stream())
        else:
            rc = _refused_policy_kernel(self.mode, self.precision.compute)(
                *ptrs, n, h, int(self.sdt == torch.bfloat16),
                *self._rconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage_refused_nu4 kernel launch failed: cudaError "
                f"{rc} (n={n}, halo={h}, mode={self.mode})")
        CovStageRefusedNu4.launches += 1
        return outs

    def reference(self, hc, uc, gsn, gwe, b_ext):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_refused_nu4_reference(self, hc, uc, gsn, gwe, b_ext)


def make_cov_stage_refused_nu4(grid, gravity: float, omega: float,
                               dt: float, nu4: float, scheme: str = "plr",
                               limiter: str = "mc", device=None,
                               precision=None):
    """The re-fused stage 1 on ``grid`` (see :class:`CovStageRefusedNu4`);
    ``device`` defaults to the grid's."""
    return CovStageRefusedNu4(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt, nu4,
        scheme=scheme, limiter=limiter,
        device=grid.device if device is None else device,
        precision=precision)


def make_fused_ssprk3_cov_refused_nu4(grid, gravity: float, omega: float,
                                      dt: float, b_ext, nu4: float,
                                      scheme: str = "plr",
                                      limiter: str = "mc", precision=None):
    """``step(y, t) -> y``: the re-fused del^4 stepper (the JAX package's
    ``nu4_mode='refused'``), 3 kernels and 3 routes per step.

    The split stepper's last operation (filter ``y`` with the routed
    ghosts of ``y``'s strips) and the next step's first (stage 1 with the
    same routed ghosts) are commuted into one kernel: route, the re-fused
    stage 1 (:class:`CovStageRefusedNu4`), route, stage 2 against the
    filtered base ``(h0f, u0f)``, route, stage 3 against it.  The two
    trajectories differ by one filter application at the endpoints
    (O(damp)); the Galewsky day-6 gate is the equivalence standard.  Same
    carry and prescaled router as :func:`make_fused_ssprk3_cov_compact`.
    No ``interval``: filter-cycling stays on the split stepper, as in the
    JAX package.  ``step.stage1f`` is the re-fused kernel, ``step.stages``
    the two compact stages.  ``precision``: the stage policy for all
    three stages and the router.
    """
    precision = resolve_stage_precision(precision)
    route = make_cov_strip_router_split(grid, precision=precision)
    stage1f = make_cov_stage_refused_nu4(grid, gravity, omega, dt, nu4,
                                         scheme=scheme, limiter=limiter,
                                         precision=precision)
    stage2, stage3 = [make_cov_stage_compact(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device,
        precision=precision)
        for a, b in SSPRK3_COEFFS[1:]]

    def step(y, t):
        del t
        gsn, gwe = route(y["strips_sn"], y["strips_we"])
        h1, u1, h0f, u0f, sn1, we1 = stage1f(y["h"], y["u"], gsn, gwe, b_ext)
        gsn, gwe = route(sn1, we1)
        h2, u2, sn2, we2 = stage2(h0f, u0f, h1, u1, gsn, gwe, b_ext)
        gsn, gwe = route(sn2, we2)
        h3, u3, sn3, we3 = stage3(h0f, u0f, h2, u2, gsn, gwe, b_ext)
        return {"h": h3, "u": u3, "strips_sn": sn3, "strips_we": we3}

    step.route = route
    step.stage1f = stage1f
    step.stages = [stage2, stage3]
    return step


# ---------------------------------------------------------------------------
# In-stage del^4: the kernel pair A / B per RK stage
# ---------------------------------------------------------------------------


def cov_stage_nu4_a_reference(stage, *args):
    """The plain PyTorch version of kernel A of the in-stage pair.

    ``stage`` is a :class:`CovStageNu4`; ``args`` as for
    ``stage.call_a``.  The compact stage's fill, RHS and combine (with
    averaged ghost corners, which no advective output reads), and the
    ring-0 Laplacian of the ghost-filled stage input.  Returns ``(h_adv,
    u_adv, l1h, l1u, strips_sn, strips_we)``, the strips those of l1.
    """
    h_adv, u_adv, frames = _stage_advance(stage, args, corners=True)
    x_row, xf_row, x_col, xf_col = stage.coords
    l1h, l1a, l1b = (lap_core(x_row, xf_row, x_col, xf_col, psi, n=stage.n,
                              halo=stage.halo, d=stage.dalpha,
                              radius=stage.radius) for psi in frames)
    l1u = torch.stack([l1a, l1b])
    sn, we = pack_strips_cov_split(l1h, l1u, stage.n, stage.halo)
    return h_adv, u_adv, l1h, l1u, sn, we


def cov_stage_nu4_b_reference(stage, h_adv, u_adv, l1h, l1u, gsn, gwe):
    """The plain PyTorch version of kernel B of the in-stage pair.

    ``stage`` is a :class:`CovStageNu4`.  l1 gets its ghosts and averaged
    corners from the routed l1 blocks ``gsn``/``gwe`` (their sym rows are
    not read); the output is ``adv - damp lap(l1)``, ``damp = f32(b dt
    nu4)``.  Returns ``(h, u, strips_sn, strips_we)``.
    """
    n, h = stage.n, stage.halo
    x_row, xf_row, x_col, xf_col = stage.coords
    out = [adv - stage.damp * lap_core(
        x_row, xf_row, x_col, xf_col,
        _fill(l1, gsn, gwe, fi, n, h, corners=True),
        n=n, halo=h, d=stage.dalpha, radius=stage.radius)
        for fi, (adv, l1) in enumerate(((h_adv, l1h), (u_adv[0], l1u[0]),
                                        (u_adv[1], l1u[1])))]
    h_new, u_new = out[0], torch.stack(out[1:])
    sn, we = pack_strips_cov_split(h_new, u_new, n, h)
    return h_new, u_new, sn, we


def _nu4_a_kernel(mode: str = "mc"):
    """Kernel A of reconstruction ``mode``: 16 tensor pointers; n, halo,
    with_y0; 8 float constants; the stream."""
    return _entry("cov_stage_nu4", _entry_name("cov_stage_nu4_a", mode),
                  [_P] * 16 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8
                  + [_P])


def _nu4_b_kernel():
    """Kernel B: 12 tensor pointers; n, halo; R^2, 1/d, 0.5/d, damp; the
    stream."""
    return _entry("cov_stage_nu4", "cov_stage_nu4_b_f32",
                  [_P] * 12 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
                  + [_P])


class CovStageNu4(_StageBase):
    """One RK stage with in-stage del^4 filtering, as a kernel pair (the
    JAX package's ``nu4_mode='stage'``, its parity oracle).

    * ``call_a(*args) -> (h_adv, u_adv, l1h, l1u, sn_l1, we_l1)``, args
      as for :class:`CovStageCompact`: the advective stage
      ``a*y0 + b*yc + b*dt*L(yc)`` and ``l1 = lap(yc)``;
    * ``call_b(h_adv, u_adv, l1h, l1u, gsn, gwe) -> (h, u, sn, we)``,
      ``gsn``/``gwe`` the routed l1 strips: ``adv - b dt nu4 lap(l1)``.

    CUDA tensors launch ``csrc/cov_stage_nu4.cu``'s two kernels (the port
    of the Pallas pair of ``make_cov_stage_nu4``; A in the instance of
    the reconstruction, PLR with each limiter or PPM at halo >= 3, B
    reconstructs nothing), each with its own launch counter; CPU tensors
    run :func:`cov_stage_nu4_a_reference` /
    :func:`cov_stage_nu4_b_reference`.  There is no other path.

    The JAX pair routes with the unprescaled router and multiplies the
    sym rows by the edge sqrtg in kernel A (``sym_prescaled=False``); the
    port has the prescaled router only, and A imposes its sym rows as
    they are.  The two differ in the sym rows by the rounding of the
    prescale (``tests/test_torch_nu4_modes.py`` measures it).  B never
    reads the sym rows.
    """

    #: Launches of kernel A and of kernel B, all instances together (the
    #: plain versions do not count).
    launches_a = 0
    launches_b = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, a: float, b: float,
                 nu4: float, scheme: str = "plr", limiter: str = "mc",
                 device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                         scheme=scheme, limiter=limiter, device=device)
        self.nu4 = float(nu4)
        # f32(b dt nu4), rounded once from float64 as the JAX kernel B.
        self.damp = _f32(self.b * self.dt * self.nu4)
        # Kernel B's constants, rounded as lap_core rounds them.
        self._bconsts = (self._kconsts[0], _f32(1.0 / self.dalpha),
                         _f32(0.5 / self.dalpha), self.damp)

    def call_a(self, *args):
        h0, u0, hc, uc, gsn, gwe, b_ext = self._unpack(args)
        self._check(h0, u0, hc, uc, gsn, gwe, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_nu4_a_reference(self, *args)
        n, h = self.n, self.halo
        outs = (torch.empty_like(hc), torch.empty_like(uc),
                torch.empty_like(hc), torch.empty_like(uc),
                hc.new_empty((6, 6 * h, n)), hc.new_empty((6, n, 6 * h)))
        rc = _nu4_a_kernel(self.mode)(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
            gsn.data_ptr(), gwe.data_ptr(), b_ext.data_ptr(),
            self._xc.data_ptr(), self._xf.data_ptr(), self.fz.data_ptr(),
            *[t.data_ptr() for t in outs], n, h, int(self.with_y0),
            *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(f"cov_stage_nu4 kernel A launch failed: "
                               f"cudaError {rc} (n={n}, halo={h}, "
                               f"mode={self.mode})")
        CovStageNu4.launches_a += 1
        return outs

    def call_b(self, h_adv, u_adv, l1h, l1u, gsn, gwe):
        n, h = self.n, self.halo
        _check_tensors({"h_adv": (h_adv, (6, n, n)),
                        "u_adv": (u_adv, (2, 6, n, n)),
                        "l1h": (l1h, (6, n, n)), "l1u": (l1u, (2, 6, n, n)),
                        "gsn": (gsn, (6, 6 * h + 2, n)),
                        "gwe": (gwe, (6, n, 6 * h + 2))}, self.device)
        if not self._on_cuda(h_adv):
            return cov_stage_nu4_b_reference(self, h_adv, u_adv, l1h, l1u,
                                             gsn, gwe)
        outs = (torch.empty_like(h_adv), torch.empty_like(u_adv),
                h_adv.new_empty((6, 6 * h, n)),
                h_adv.new_empty((6, n, 6 * h)))
        rc = _nu4_b_kernel()(
            h_adv.data_ptr(), u_adv.data_ptr(), l1h.data_ptr(),
            l1u.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
            self._xc.data_ptr(), self._xf.data_ptr(),
            *[t.data_ptr() for t in outs], n, h, *self._bconsts,
            self._stream())
        if rc != 0:
            raise RuntimeError(f"cov_stage_nu4 kernel B launch failed: "
                               f"cudaError {rc} (n={n}, halo={h})")
        CovStageNu4.launches_b += 1
        return outs

    def reference_a(self, *args):
        """Kernel A's plain version on the same arguments."""
        return cov_stage_nu4_a_reference(self, *args)

    def reference_b(self, h_adv, u_adv, l1h, l1u, gsn, gwe):
        """Kernel B's plain version on the same arguments."""
        return cov_stage_nu4_b_reference(self, h_adv, u_adv, l1h, l1u, gsn,
                                         gwe)


def make_cov_stage_nu4(grid, gravity: float, omega: float, dt: float,
                       a: float, b: float, nu4: float, scheme: str = "plr",
                       limiter: str = "mc", device=None):
    """``(stage_a, stage_b)``: the two halves of one :class:`CovStageNu4`
    on ``grid`` (its bound ``call_a`` / ``call_b``), as the JAX package's
    ``make_cov_stage_nu4`` returns them; ``device`` defaults to the
    grid's."""
    st = CovStageNu4(grid.n, grid.halo, grid.dalpha, grid.radius, gravity,
                     omega, dt, a, b, nu4, scheme=scheme, limiter=limiter,
                     device=grid.device if device is None else device)
    return st.call_a, st.call_b


def make_fused_ssprk3_cov_nu4(grid, gravity: float, omega: float, dt: float,
                              b_ext, nu4: float, scheme: str = "plr",
                              limiter: str = "mc"):
    """``step(y, t) -> y``: the in-stage del^4 stepper (the JAX package's
    ``nu4_mode='stage'``), 6 kernels and 6 routes per step.

    Each RK stage is kernel A, a route of A's l1 strips, kernel B
    (:class:`CovStageNu4`).  Same carry and prescaled router as
    :func:`make_fused_ssprk3_cov_compact`; ``step.stages`` are the three
    :class:`CovStageNu4`.
    """
    route = make_cov_strip_router_split(grid)
    stages = [CovStageNu4(grid.n, grid.halo, grid.dalpha, grid.radius,
                          gravity, omega, dt, a, b, nu4, scheme=scheme,
                          limiter=limiter, device=grid.device)
              for a, b in SSPRK3_COEFFS]
    s1, s2, s3 = stages

    def half_stage(st, *args):
        ha, uadv, l1h, l1u, sn1, we1 = st.call_a(*args)
        gsn, gwe = route(sn1, we1)
        return st.call_b(ha, uadv, l1h, l1u, gsn, gwe)

    def step(y, t):
        del t
        h0, u0 = y["h"], y["u"]
        gsn, gwe = route(y["strips_sn"], y["strips_we"])
        h1, u1, sn, we = half_stage(s1, h0, u0, gsn, gwe, b_ext)
        gsn, gwe = route(sn, we)
        h2, u2, sn, we = half_stage(s2, h0, u0, h1, u1, gsn, gwe, b_ext)
        gsn, gwe = route(sn, we)
        h3, u3, sn, we = half_stage(s3, h0, u0, h2, u2, gsn, gwe, b_ext)
        return {"h": h3, "u": u3, "strips_sn": sn, "strips_we": we}

    step.route = route
    step.stages = stages
    return step


# ---------------------------------------------------------------------------
# The unfused RHS of the classic path (backend='pallas')
# ---------------------------------------------------------------------------


def cov_rhs_reference(rhs, fz, h_ext, u_ext, b_ext, sym_sn, sym_we):
    """The plain PyTorch version of the unfused covariant RHS.

    ``rhs`` is a :class:`CovRhs` (its constants and coordinate rows);
    the operands as for calling it.  :func:`rhs_core_cov` over the given
    faces with the un-prescaled sym rows (``sg * sym``).  Used on CPU
    tensors by the wrapper, and by the tests and ``chip_smoke.py`` to hold
    the CUDA kernel against it; it also runs in float64.  Returns ``(dh
    (F, n, n), du (2, F, n, n))``.
    """
    dh, dua, dub = rhs._rhs(fz[:, 0], h_ext, u_ext[0], u_ext[1], b_ext,
                            sym_sn, sym_we, sym_prescaled=False)
    return dh, torch.stack([dua, dub])


def _rhs_kernel(mode: str = "mc"):
    """The RHS kernel of reconstruction ``mode``: 13 pointers (fz, the
    groups' rows, the group table, h, u, b, sym_sn, sym_we, dh, du); the
    rank strides of h, u, the component stride of u, the rank stride of
    b, the rank strides of dh, du and the component stride of du; n,
    halo, the group count; 5 float constants; the stream."""
    return _entry("cov_rhs", _entry_name("cov_rhs", mode),
                  [_P] * 13 + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 5 + [_P])


class CovRhs(_RhsBase):
    """The covariant right-hand side of ghost-filled extended faces.

    ``rhs(fz, h_ext, u_ext, b_ext, sym_sn, sym_we) -> (dh, du)`` over F =
    ``n_faces`` faces in the classic layout: ``fz`` (F, 1, 3) the faces'
    frame z-components, ``h_ext``, ``b_ext`` (F, M, M), ``u_ext`` (2, F,
    M, M), the un-prescaled symmetrized edge normals ``sym_sn`` (F, 2, n)
    and ``sym_we`` (F, n, 2); interior tendencies ``dh`` (F, n, n) and
    ``du`` (2, F, n, n) out.  ``n_faces=1`` is the JAX package's one-face
    form.

    ``rhs.stacked(fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we) -> (dh,
    du)``: the face tier's form, every face a process holds in one launch.
    ``groups`` a :class:`RankGroups` of the R faces with their full-face
    rows (G, 1, M) and columns (G, M, 1); ``fz`` (R, 1, 3); ``h_ext``,
    ``b_ext`` (R, 1, M, M) and ``u_ext`` (R, 2, 1, M, M), each face's block
    contiguous (views of the tier's stacked ``q`` go as they are);
    ``sym_sn`` (R, 1, 2, n), ``sym_we`` (R, 1, n, 2); out ``dh`` (R, 1, n,
    n), ``du`` (R, 2, 1, n, n).

    CUDA tensors launch ``csrc/cov_rhs.cu`` (the port of the Pallas kernel
    ``make_cov_rhs_pallas``), one launch per call in either form, the
    instance of the reconstruction's mode; CPU
    tensors, or any tensors with ``interpret=True``, run
    :func:`cov_rhs_reference`, or for the stacked form the block RHS's
    stacked plain version :func:`cov_rhs_local_stacked_reference` (whole
    faces are blocks with the full-face rows; bitwise one
    :func:`cov_rhs_reference` call per face).  There is no other path: a
    kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, n_faces: int = 6,
                 scheme: str = "plr", limiter: str = "mc",
                 interpret: bool = False, device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, device=device)
        self.n_faces = int(n_faces)
        self.interpret = bool(interpret)
        # The classic layout's groups: its faces at one block position,
        # each with the full-face rows.
        nf = self.n_faces
        self._groups = RankGroups([0] * nf, *(
            t.expand((nf,) + tuple(t.shape)) for t in self.coords))

    def _check(self, fz, h_ext, u_ext, b_ext, sym_sn, sym_we):
        nf, n, m = self.n_faces, self.n, self.m
        _check_tensors({"fz": (fz, (nf, 1, 3)), "h_ext": (h_ext, (nf, m, m)),
                        "u_ext": (u_ext, (2, nf, m, m)),
                        "b_ext": (b_ext, (nf, m, m)),
                        "sym_sn": (sym_sn, (nf, 2, n)),
                        "sym_we": (sym_we, (nf, n, 2))}, self.device)

    def _launch(self, fz, groups, h, ua, ub, b, sym, dh, dua, dub):
        """One launch over every face of ``groups``: ``ua``/``ub`` and
        ``dua``/``dub`` are the first and second components of ``u`` and
        ``du`` (views), whose offset is the component stride."""
        comp = lambda a, b: (b.data_ptr() - a.data_ptr()) // a.element_size()
        rc = _rhs_kernel(self.mode)(
            fz.data_ptr(), groups.xr.data_ptr(), groups.xfr.data_ptr(),
            groups.yc.data_ptr(), groups.yfc.data_ptr(),
            groups.table.data_ptr(), h.data_ptr(), ua.data_ptr(),
            b.data_ptr(), sym[0].data_ptr(), sym[1].data_ptr(),
            dh.data_ptr(), dua.data_ptr(), h.stride(0), ua.stride(0),
            comp(ua, ub), b.stride(0), dh.stride(0), dua.stride(0),
            comp(dua, dub), self.n, self.halo, groups.count,
            *self._rhs_consts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_rhs kernel launch failed: cudaError {rc} (n={self.n}, "
                f"halo={self.halo}, mode={self.mode}, {groups.n_ranks} "
                f"faces in {groups.count} groups)")
        CovRhs.launches += 1

    def __call__(self, fz, h_ext, u_ext, b_ext, sym_sn, sym_we):
        args = (fz, h_ext, u_ext, b_ext, sym_sn, sym_we)
        self._check(*args)
        if self.interpret or not self._on_cuda(h_ext):
            return cov_rhs_reference(self, *args)
        n, nf = self.n, self.n_faces
        dh = h_ext.new_empty((nf, n, n))
        du = h_ext.new_empty((2, nf, n, n))
        self._launch(fz, self._groups, h_ext, u_ext[0], u_ext[1], b_ext,
                     (sym_sn, sym_we), dh, du[0], du[1])
        return dh, du

    def stacked(self, fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we):
        n, m = self.n, self.m
        r = _RanksRhsBase._check_groups(self, fz, groups, m)
        _check_ranked({"h_ext": (h_ext, (1, m, m)),
                       "u_ext": (u_ext, (2, 1, m, m)),
                       "b_ext": (b_ext, (1, m, m))}, r, self.device)
        _check_tensors({"sym_sn": (sym_sn, (r, 1, 2, n)),
                        "sym_we": (sym_we, (r, 1, n, 2))}, self.device)
        if self.interpret or not self._on_cuda(h_ext):
            return cov_rhs_local_stacked_reference(
                self, fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we)
        dh = h_ext.new_empty((r, 1, n, n))
        du = h_ext.new_empty((r, 2, 1, n, n))
        self._launch(fz, groups, h_ext, u_ext[:, 0], u_ext[:, 1], b_ext,
                     (sym_sn, sym_we), dh, du[:, 0], du[:, 1])
        return dh, du

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_rhs_reference(self, *args)

    def stacked_reference(self, *args):
        """The plain version of the stacked form on the same arguments."""
        return cov_rhs_local_stacked_reference(self, *args)


def make_cov_rhs_pallas(grid, gravity: float, omega: float,
                        scheme: str = "plr", limiter: str = "mc",
                        interpret: bool = False, n_faces: int = 6,
                        external_sym: bool = False, device=None):
    """``rhs(h_ext, u_ext, b_ext) -> (dh, du)``: the unfused RHS kernel.

    The stencil section of the classic
    :meth:`CovariantShallowWater.rhs`: extended, ghost-filled inputs
    (6, M, M) / (2, 6, M, M), interior tendencies out.  The symmetrized
    edge normals are computed outside the kernel from the same ``u_ext``
    (:func:`make_sym_edge_normals`, bitwise :func:`sym_edge_normals`).
    ``rhs.kernel`` is the :class:`CovRhs`, ``rhs.sym`` the sym rows'
    function.

    ``n_faces=1, external_sym=True`` is the face tier's form: the
    :class:`CovRhs` itself, called as ``rhs(fz, h_ext, u_ext, b_ext,
    sym_sn, sym_we)`` with the faces' frame z-components (F, 1, 3) and
    sym rows supplied by the caller.  ``interpret=True`` runs the plain
    version on any device.  ``device`` defaults to the grid's.
    """
    kern = CovRhs(grid.n, grid.halo, grid.dalpha, grid.radius, gravity,
                  omega, n_faces=n_faces, scheme=scheme, limiter=limiter,
                  interpret=interpret,
                  device=grid.device if device is None else device)
    if external_sym:
        return kern
    if n_faces != 6:
        raise ValueError(f"the six-face form needs n_faces=6, got {n_faces}"
                         " (the one-face form is external_sym=True)")
    frames_z = kern.fz[:, None, :]
    sym = make_sym_edge_normals(grid)

    def rhs(h_ext, u_ext, b_ext):
        return kern(frames_z, h_ext, u_ext, b_ext, *sym(u_ext))

    rhs.kernel = kern
    rhs.sym = sym
    return rhs


# ---------------------------------------------------------------------------
# The sharded tiers' local right-hand sides: the interior pass (B5), the
# boundary band, and one extended block with runtime coordinates (B6)
#
# A halo of depth h is the stencil radius of one RHS evaluation, so the
# tendency of a cell at distance >= h from its block's boundary reads no
# ghost: the ghost-free (n-2h)^2 core can be computed before the exchange
# completes.  The overlapped tiers run the interior kernel between the
# exchange's two phases and finish with the band, four rectangular
# rhs_core_cov windows that tile the depth-h ring (plain torch, as the JAX
# package keeps it jnp).  Interior + band take the same operand windows
# in the same op order as the whole block, so they reproduce it bitwise.
# ---------------------------------------------------------------------------


def _fz3(fz):
    """(F, 1, 3) frame z-components -> three (F, 1, 1) columns."""
    return tuple(fz[:, 0, k].reshape(-1, 1, 1) for k in range(3))


class RankGroups:
    """The stacked ranks of a sharded tier, grouped for the RHS kernels B5
    and B6 (one launch over all of them).

    ``RankGroups(keys, xr, xfr, yc, yfc)``: ``keys[r]`` is the block
    position of stacked rank ``r`` (its ``(iy, ix)`` on the tier's mesh);
    ``xr``/``xfr`` (R, 1, m) and ``yc``/``yfc`` (R, m, 1) are the ranks'
    coordinate rows and columns.  On the equiangular cube the ranks at one
    block position of different panels have the same rows, so a kernel
    block computes its tile's metric terms once for all of them: the ranks
    of each position, in stack order, form groups of at most :attr:`SIZE`.
    ``table`` (G, SIZE) int32 lists each group's ranks (-1 past its last);
    ``xr``, ``xfr`` (G, 1, m) and ``yc``, ``yfc`` (G, m, 1) are each
    group's rows.  A tier builds its groups once, at construction; the
    rows of a group's ranks are checked bitwise equal then, and a
    ``ValueError`` refuses a group whose ranks' rows differ.
    """

    #: Ranks per group: a kernel block's double-buffered rank loop.
    SIZE = 3

    def __init__(self, keys, xr, xfr, yc, yfc):
        names = ("xr", "xfr", "yc", "yfc")
        rows = (xr, xfr, yc, yfc)
        r, m = len(keys), xr.shape[-1]
        for name, t, shape in zip(names, rows, ((r, 1, m), (r, 1, m),
                                                (r, m, 1), (r, m, 1))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected shape {shape} for {r} "
                                 f"ranks, got {tuple(t.shape)}")
        members = {}
        for i, key in enumerate(keys):
            members.setdefault(key, []).append(i)
        self.ranks = [ranks[k:k + self.SIZE] for ranks in members.values()
                      for k in range(0, len(ranks), self.SIZE)]
        for group in self.ranks:
            for i in group[1:]:
                for name, t in zip(names, rows):
                    if not torch.equal(t[i], t[group[0]]):
                        raise ValueError(
                            f"ranks {group[0]} and {i} share block position "
                            f"{keys[i]!r} but not their {name}: a group of "
                            "the RHS kernels takes one position's rows")
        dev = xr.device
        self.table = torch.tensor(
            [g + [-1] * (self.SIZE - len(g)) for g in self.ranks],
            dtype=torch.int32, device=dev)
        first = torch.tensor([g[0] for g in self.ranks], device=dev)
        self.xr, self.xfr, self.yc, self.yfc = (
            t.index_select(0, first).contiguous() for t in rows)
        of = [0] * r
        for gi, group in enumerate(self.ranks):
            for i in group:
                of[i] = gi
        self.group_of = torch.tensor(of, device=dev)

    @property
    def count(self) -> int:
        """The number of groups G: the launch grid's third axis."""
        return len(self.ranks)

    @property
    def n_ranks(self) -> int:
        return len(self.group_of)

    def rank_rows(self):
        """Each rank's rows, taken from its group's: ``(xr, xfr, yc, yfc)``
        as (R, 1, m) / (R, m, 1)."""
        return tuple(t.index_select(0, self.group_of)
                     for t in (self.xr, self.xfr, self.yc, self.yfc))


def _check_ranked(want, n_ranks, device):
    """:func:`_check_tensors` for the stacked forms' operands ``{name:
    (tensor, per-rank shape)}``: a leading axis of ``n_ranks``, float32, on
    ``device``, each rank's block contiguous.  The rank stride is free, so
    views of a tier's stacked blocks go to the kernel as they are."""
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if tuple(t.shape) != (n_ranks,) + shape:
            raise ValueError(f"{name}: expected shape {(n_ranks,) + shape}, "
                             f"got {tuple(t.shape)}")
        _check_tensors({name: (t[0], shape)}, device)


class _RanksRhsBase(_ConstsBase):
    """What the wrappers of B5 and B6 share: the checks of a stacked call
    and its launch (one per call, whatever the rank count)."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", interpret: bool = False,
                 device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, device=device)
        self.interpret = bool(interpret)

    def _check_groups(self, fz, groups, w):
        """The rank count of a stacked call; raises where ``groups`` does
        not fit ``fz`` or the row width ``w``."""
        if not isinstance(groups, RankGroups):
            raise TypeError(f"groups must be a RankGroups, got {type(groups)}")
        r, g = groups.n_ranks, groups.count
        _check_tensors({"fz": (fz, (r, 1, 3)),
                        "groups.xr": (groups.xr, (g, 1, w)),
                        "groups.xfr": (groups.xfr, (g, 1, w)),
                        "groups.yc": (groups.yc, (g, w, 1)),
                        "groups.yfc": (groups.yfc, (g, w, 1))}, self.device)
        if groups.table.device != self.device:
            raise ValueError(f"groups.table is on {groups.table.device}; "
                             f"this kernel was built for {self.device}")
        return r

    def _launch(self, entry, fz, groups, h, u, b, sym, nout):
        """One launch of ``entry`` over every rank of ``groups``; returns
        ``(dh (R, 1, nout, nout), du (R, 2, 1, nout, nout))``."""
        r = groups.n_ranks
        dh = h.new_empty((r, 1, nout, nout))
        du = h.new_empty((r, 2, 1, nout, nout))
        rc = entry(
            fz.data_ptr(), groups.xr.data_ptr(), groups.xfr.data_ptr(),
            groups.yc.data_ptr(), groups.yfc.data_ptr(),
            groups.table.data_ptr(), h.data_ptr(), u.data_ptr(),
            b.data_ptr(), *[t.data_ptr() for t in sym], dh.data_ptr(),
            du.data_ptr(), h.stride(0), u.stride(0), b.stride(0), nout,
            self.halo, groups.count, *self._rhs_consts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"{type(self).__name__} kernel launch failed: cudaError {rc}"
                f" (n={self.n}, halo={self.halo}, mode={self.mode}, {r} "
                f"ranks in {groups.count} groups)")
        type(self).launches += 1
        return dh, du


def _one_rank(xr, xfr, yc, yfc):
    """The per-block form's group: one rank with its own rows."""
    return RankGroups([0], xr[None], xfr[None], yc[None], yfc[None])


def cov_rhs_interior_reference(rhs, fz, xr, xfr, yc, yfc, h_int, u_int,
                               b_int):
    """The plain PyTorch version of the interior pass: :func:`rhs_core_cov`
    on the interior fields with no seams, the block's own outer ``halo``
    ring as the stencil halo of the ``ni x ni`` output.  ``rhs`` is a
    :class:`CovRhsInterior`.  Returns ``(dh (1, ni, ni), du (2, 1, ni,
    ni))``."""
    dh, dua, dub = rhs_core_cov(
        _fz3(fz), xr, xfr, yc, yfc, h_int, u_int[0], u_int[1], b_int, None,
        None, n=rhs.ni, halo=rhs.halo, d=rhs.dalpha, radius=rhs.radius,
        gravity=rhs.gravity, omega=rhs.omega, scheme=rhs.scheme,
        limiter=rhs.limiter, seam_edges=(False, False, False, False))
    return dh, torch.stack([dua, dub])


def cov_rhs_interior_stacked_reference(rhs, fz, groups, h_int, u_int,
                                       b_int):
    """The plain version of the stacked interior pass: the per-block one
    on every rank at once (:func:`rhs_core_cov` takes a leading rank
    axis), each rank with its group's rows.  Returns ``(dh (R, 1, ni, ni),
    du (R, 2, 1, ni, ni))``."""
    xr, xfr, yc, yfc = groups.rank_rows()
    dh, dua, dub = rhs_core_cov(
        _fz3(fz), xr, xfr, yc, yfc, h_int[:, 0], u_int[:, 0, 0],
        u_int[:, 1, 0], b_int[:, 0], None, None, n=rhs.ni, halo=rhs.halo,
        d=rhs.dalpha, radius=rhs.radius, gravity=rhs.gravity,
        omega=rhs.omega, scheme=rhs.scheme, limiter=rhs.limiter,
        seam_edges=(False, False, False, False))
    return dh[:, None], torch.stack([dua, dub], dim=1)[:, :, None]


def _interior_kernel(mode: str = "mc"):
    """The interior pass's kernel of reconstruction ``mode``: 11 pointers
    (fz, the groups' rows, the group table, h, u, b, dh, du); the rank
    strides of h, u, b; ni, halo, the group count; 5 float constants; the
    stream."""
    return _entry("cov_rhs_interior", _entry_name("cov_rhs_interior", mode),
                  [_P] * 11 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 5 + [_P])


class CovRhsInterior(_RanksRhsBase):
    """The covariant RHS of the ghost-free cores of blocks (B5).

    ``rhs.stacked(fz, groups, h_int, u_int, b_int) -> (dh, du)``: every
    rank a tier's process holds in one launch.  ``groups`` a
    :class:`RankGroups` of the R ranks with the interior coordinate
    windows (G, 1, n) / (G, n, 1); the ranks' frame z-components ``fz``
    (R, 1, 3), interior fields ``h_int`` (R, 1, n, n), ``u_int`` (R, 2, 1,
    n, n) and orography windows ``b_int`` (R, 1, n, n), each rank's block
    contiguous; out ``dh`` (R, 1, ni, ni) and ``du`` (R, 2, 1, ni, ni),
    ``ni = n - 2*halo``.

    ``rhs(fz, xr, xfr, yc, yfc, h_int, u_int, b_int) -> (dh, du)``: one
    block, the JAX package's form: its interior fields ``h_int`` (1, n,
    n), ``u_int`` (2, 1, n, n), ``b_int`` (1, n, n), the interior windows
    ``xr``/``xfr`` (1, n) and ``yc``/``yfc`` (n, 1), ``fz`` (1, 1, 3); out
    ``dh`` (1, ni, ni), ``du`` (2, 1, ni, ni): the same kernel over one
    rank.

    CUDA tensors launch ``csrc/cov_rhs_interior.cu`` (the port of the
    Pallas kernel ``make_cov_rhs_interior_local``), the instance of the
    reconstruction's mode (PPM at halo >= 3); CPU tensors, or any
    tensors with ``interpret=True``, run the plain versions
    :func:`cov_rhs_interior_stacked_reference` /
    :func:`cov_rhs_interior_reference`.
    """

    #: Launches of the CUDA kernel, all instances together: one per call.
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", interpret: bool = False,
                 device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, interpret=interpret,
                         device=device)
        self.ni = n - 2 * halo
        if self.ni <= 0:
            raise ValueError(
                f"interior split needs n > 2*halo (got n={n}, halo={halo}): "
                "with no ghost-free core the serialized exchange is the "
                "whole kernel")

    def stacked(self, fz, groups, h_int, u_int, b_int):
        n = self.n
        r = self._check_groups(fz, groups, n)
        _check_ranked({"h_int": (h_int, (1, n, n)),
                       "u_int": (u_int, (2, 1, n, n)),
                       "b_int": (b_int, (1, n, n))}, r, self.device)
        if self.interpret or not self._on_cuda(h_int):
            return cov_rhs_interior_stacked_reference(self, fz, groups,
                                                      h_int, u_int, b_int)
        return self._launch(_interior_kernel(self.mode), fz, groups, h_int, u_int,
                            b_int, (), self.ni)

    def __call__(self, fz, xr, xfr, yc, yfc, h_int, u_int, b_int):
        args = (fz, xr, xfr, yc, yfc, h_int, u_int, b_int)
        n = self.n
        _check_tensors({"fz": (fz, (1, 1, 3)), "xr": (xr, (1, n)),
                        "xfr": (xfr, (1, n)), "yc": (yc, (n, 1)),
                        "yfc": (yfc, (n, 1)), "h_int": (h_int, (1, n, n)),
                        "u_int": (u_int, (2, 1, n, n)),
                        "b_int": (b_int, (1, n, n))}, self.device)
        if self.interpret or not self._on_cuda(h_int):
            return cov_rhs_interior_reference(self, *args)
        dh, du = self.stacked(fz, _one_rank(xr, xfr, yc, yfc), h_int[None],
                              u_int[None], b_int[None])
        return dh[0], du[0]

    def reference(self, *args):
        """The plain version of the per-block form on the same arguments
        (tests and smoke)."""
        return cov_rhs_interior_reference(self, *args)

    def stacked_reference(self, *args):
        """The plain version of the stacked form on the same arguments."""
        return cov_rhs_interior_stacked_reference(self, *args)


def make_cov_rhs_interior_local(n: int, halo: int, dalpha: float,
                                radius: float, gravity: float, omega: float,
                                scheme: str = "plr", limiter: str = "mc",
                                interpret: bool = False, device=None):
    """The interior-pass RHS of blocks: a :class:`CovRhsInterior`
    (``device`` defaults to the GPU)."""
    return CovRhsInterior(n, halo, dalpha, radius, gravity, omega,
                          scheme=scheme, limiter=limiter, interpret=interpret,
                          device=resolve_device(device))


def make_cov_rhs_band_local(n: int, halo: int, dalpha: float, radius: float,
                            gravity: float, omega: float, scheme: str = "plr",
                            limiter: str = "mc"):
    """The boundary-band RHS and stitch of F blocks (plain torch).

    ``band(fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext, sym_sn, sym_we,
    dh_core, du_core) -> (dh (F, n, n), du (2, F, n, n))``: ``fz`` (F, 1,
    3); coordinate rows ``xr``/``xfr`` (1, m) or (F, 1, m) and columns
    ``yc``/``yfc`` (m, 1) or (F, m, 1); extended blocks ``h_ext``,
    ``b_ext`` (F, m, m) and ``u_ext`` (2, F, m, m) with ghosts filled; the
    sym strips of all four edges ``sym_sn`` (F, 2, n), ``sym_we`` (F, n,
    2), not prescaled; the interior pass's ``dh_core`` (F, ni, ni) and
    ``du_core`` (2, F, ni, ni).  F = 1 is the JAX package's form.  S/N
    rows cover the full width (they own the corners), W/E the remaining
    ``ni`` rows; each window imposes exactly the sym rows the whole block
    imposes there.
    """
    h = halo
    ni = n - 2 * h
    if ni <= 0:
        raise ValueError(
            f"band split needs n > 2*halo (got n={n}, halo={halo})")
    m = n + 2 * h
    kw = dict(halo=h, d=float(dalpha), radius=float(radius),
              gravity=float(gravity), omega=float(omega), scheme=scheme,
              limiter=limiter, sym_prescaled=False)

    def band(fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext, sym_sn, sym_we,
             dh_core, du_core):
        fz3 = _fz3(fz)

        def win(r0, r1, c0, c1):
            return (xr[..., c0:c1], xfr[..., c0:c1], yc[..., r0:r1, :],
                    yfc[..., r0:r1, :], h_ext[..., r0:r1, c0:c1],
                    u_ext[0, ..., r0:r1, c0:c1], u_ext[1, ..., r0:r1, c0:c1],
                    b_ext[..., r0:r1, c0:c1])

        dS = rhs_core_cov(fz3, *win(0, 3 * h, 0, m), sym_sn,
                          sym_we[:, 0:h], n=(h, n),
                          seam_edges=(True, False, True, True), **kw)
        dN = rhs_core_cov(fz3, *win(m - 3 * h, m, 0, m), sym_sn,
                          sym_we[:, n - h:n], n=(h, n),
                          seam_edges=(False, True, True, True), **kw)
        dW = rhs_core_cov(fz3, *win(h, n + h, 0, 3 * h), None,
                          sym_we[:, h:n - h], n=(ni, h),
                          seam_edges=(False, False, True, False), **kw)
        dE = rhs_core_cov(fz3, *win(h, n + h, m - 3 * h, m), None,
                          sym_we[:, h:n - h], n=(ni, h),
                          seam_edges=(False, False, False, True), **kw)

        def stitch(i, core):
            mid = torch.cat([dW[i], core, dE[i]], dim=-1)
            return torch.cat([dS[i], mid, dN[i]], dim=-2)

        return (stitch(0, dh_core),
                torch.stack([stitch(1, du_core[0]), stitch(2, du_core[1])]))

    return band


def cov_rhs_local_reference(rhs, fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext,
                            sym_sn, sym_we):
    """The plain PyTorch version of one block's RHS with runtime
    coordinates: :func:`rhs_core_cov` with the block's rows and columns and
    the un-prescaled sym rows of all four block edges.  ``rhs`` is a
    :class:`CovRhsLocal`.  Returns ``(dh (1, n, n), du (2, 1, n, n))``."""
    dh, dua, dub = rhs_core_cov(
        _fz3(fz), xr, xfr, yc, yfc, h_ext, u_ext[0], u_ext[1], b_ext, sym_sn,
        sym_we, n=rhs.n, halo=rhs.halo, d=rhs.dalpha, radius=rhs.radius,
        gravity=rhs.gravity, omega=rhs.omega, scheme=rhs.scheme,
        limiter=rhs.limiter, sym_prescaled=False)
    return dh, torch.stack([dua, dub])


def cov_rhs_local_stacked_reference(rhs, fz, groups, h_ext, u_ext, b_ext,
                                    sym_sn, sym_we):
    """The plain version of the stacked block RHS: the per-block one on
    every rank at once, each rank with its group's rows and its own sym
    strips.  Returns ``(dh (R, 1, n, n), du (R, 2, 1, n, n))``."""
    xr, xfr, yc, yfc = groups.rank_rows()
    dh, dua, dub = rhs_core_cov(
        _fz3(fz), xr, xfr, yc, yfc, h_ext[:, 0], u_ext[:, 0, 0],
        u_ext[:, 1, 0], b_ext[:, 0], sym_sn[:, 0], sym_we[:, 0], n=rhs.n,
        halo=rhs.halo, d=rhs.dalpha, radius=rhs.radius, gravity=rhs.gravity,
        omega=rhs.omega, scheme=rhs.scheme, limiter=rhs.limiter,
        sym_prescaled=False)
    return dh[:, None], torch.stack([dua, dub], dim=1)[:, :, None]


def _local_kernel(mode: str = "mc"):
    """The block RHS kernel of reconstruction ``mode``: 13 pointers (fz,
    the groups' rows, the group table, h, u, b, sym_sn, sym_we, dh, du);
    the rank strides of h, u, b; n, halo, the group count; 5 float
    constants; the stream."""
    return _entry("cov_rhs_local", _entry_name("cov_rhs_local", mode),
                  [_P] * 13 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 5 + [_P])


class CovRhsLocal(_RanksRhsBase):
    """The covariant RHS of extended blocks with runtime coordinates (B6).

    ``rhs.stacked(fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we) -> (dh,
    du)``: every rank a tier's process holds in one launch.  ``groups`` a
    :class:`RankGroups` of the R ranks with their blocks' rows (G, 1, m)
    and columns (G, m, 1); ``fz`` (R, 1, 3); the extended blocks ``h_ext``,
    ``b_ext`` (R, 1, m, m) and ``u_ext`` (R, 2, 1, m, m) with ghosts
    filled, each rank's block contiguous (views of the tier's stacked
    blocks go as they are); the un-prescaled sym strips imposed at all
    four block edges ``sym_sn`` (R, 1, 2, n), ``sym_we`` (R, 1, n, 2); out
    ``dh`` (R, 1, n, n), ``du`` (R, 2, 1, n, n).

    ``rhs(fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext, sym_sn, sym_we) ->
    (dh, du)``: one block, the JAX package's form: ``xr``/``xfr`` (1, m),
    ``yc``/``yfc`` (m, 1), ``fz`` (1, 1, 3), ``h_ext``, ``b_ext`` (1, m,
    m), ``u_ext`` (2, 1, m, m), ``sym_sn`` (1, 2, n), ``sym_we`` (1, n,
    2); out ``dh`` (1, n, n), ``du`` (2, 1, n, n): the same kernel over
    one rank.

    CUDA tensors launch ``csrc/cov_rhs_local.cu`` (the port of the Pallas
    kernel ``make_cov_rhs_pallas_local``), the instance of the
    reconstruction's mode (PPM at halo >= 3); CPU tensors, or any tensors
    with ``interpret=True``, run the plain versions
    :func:`cov_rhs_local_stacked_reference` /
    :func:`cov_rhs_local_reference`.
    """

    #: Launches of the CUDA kernel, all instances together: one per call.
    launches = 0

    def stacked(self, fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we):
        n, m = self.n, self.m
        r = self._check_groups(fz, groups, m)
        _check_ranked({"h_ext": (h_ext, (1, m, m)),
                       "u_ext": (u_ext, (2, 1, m, m)),
                       "b_ext": (b_ext, (1, m, m))}, r, self.device)
        _check_tensors({"sym_sn": (sym_sn, (r, 1, 2, n)),
                        "sym_we": (sym_we, (r, 1, n, 2))}, self.device)
        if self.interpret or not self._on_cuda(h_ext):
            return cov_rhs_local_stacked_reference(
                self, fz, groups, h_ext, u_ext, b_ext, sym_sn, sym_we)
        return self._launch(_local_kernel(self.mode), fz, groups, h_ext, u_ext, b_ext,
                            (sym_sn, sym_we), n)

    def __call__(self, fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext, sym_sn,
                 sym_we):
        args = (fz, xr, xfr, yc, yfc, h_ext, u_ext, b_ext, sym_sn, sym_we)
        n, m = self.n, self.m
        _check_tensors({"fz": (fz, (1, 1, 3)), "xr": (xr, (1, m)),
                        "xfr": (xfr, (1, m)), "yc": (yc, (m, 1)),
                        "yfc": (yfc, (m, 1)), "h_ext": (h_ext, (1, m, m)),
                        "u_ext": (u_ext, (2, 1, m, m)),
                        "b_ext": (b_ext, (1, m, m)),
                        "sym_sn": (sym_sn, (1, 2, n)),
                        "sym_we": (sym_we, (1, n, 2))}, self.device)
        if self.interpret or not self._on_cuda(h_ext):
            return cov_rhs_local_reference(self, *args)
        dh, du = self.stacked(fz, _one_rank(xr, xfr, yc, yfc), h_ext[None],
                              u_ext[None], b_ext[None], sym_sn[None],
                              sym_we[None])
        return dh[0], du[0]

    def reference(self, *args):
        """The plain version of the per-block form on the same arguments
        (tests and smoke)."""
        return cov_rhs_local_reference(self, *args)

    def stacked_reference(self, *args):
        """The plain version of the stacked form on the same arguments."""
        return cov_rhs_local_stacked_reference(self, *args)


def make_cov_rhs_pallas_local(n: int, halo: int, dalpha: float,
                              radius: float, gravity: float, omega: float,
                              scheme: str = "plr", limiter: str = "mc",
                              interpret: bool = False, device=None):
    """The RHS of extended blocks with runtime coordinates: a
    :class:`CovRhsLocal` (``device`` defaults to the GPU)."""
    return CovRhsLocal(n, halo, dalpha, radius, gravity, omega,
                       scheme=scheme, limiter=limiter, interpret=interpret,
                       device=resolve_device(device))


# ---------------------------------------------------------------------------
# The extended carry: packed strips, routers, the in-kernel-fill stage
# ---------------------------------------------------------------------------


def _strip_base(fi: int, halo: int) -> int:
    """First row of field ``fi`` (h, u_a, u_b) in the packed strips."""
    return fi * 4 * halo


def pack_strips_cov(h_ext, u_ext, n: int, halo: int):
    """Boundary strips of extended (h, u) as one ``(6, 12*halo, n)``: per
    field, the interior's S rows, N rows, W columns transposed, E columns
    transposed."""
    i0, i1 = halo, halo + n
    rows = []
    for q in (h_ext, u_ext[0], u_ext[1]):
        rows += [q[:, i0:i0 + halo, i0:i1], q[:, i1 - halo:i1, i0:i1],
                 q[:, i0:i1, i0:i0 + halo].transpose(1, 2),
                 q[:, i0:i1, i1 - halo:i1].transpose(1, 2)]
    return torch.cat(rows, dim=1)


def make_cov_strip_router(grid):
    """``route(strips) -> ghosts``, the loop form: the readable oracle of
    :func:`make_cov_strip_router_linear`.

    ``strips``: (6, 12h, n) per :func:`pack_strips_cov`, raw covariant
    components in each source panel's basis.  Returns (6, 12h+4, n): the
    same row layout holding the placed ghost blocks (u rotated into the
    receiving panel's basis), then the four symmetrized edge-normal rows
    S, N, W, E (not prescaled), one average per physical edge.
    """
    n, h = grid.n, grid.halo
    i0, i1 = h, h + n
    Tc = _rotation_tables(grid)                     # (4, 6, 4, h, n)
    adj = build_connectivity()
    # Edge-face metric rows (the equiangular metric is face-independent).
    met = {EDGE_W: (grid.ginv_aa_xf[0, i0:i1, i0], grid.ginv_ab_xf[0, i0:i1, i0]),
           EDGE_E: (grid.ginv_aa_xf[0, i0:i1, i1], grid.ginv_ab_xf[0, i0:i1, i1]),
           EDGE_S: (grid.ginv_ab_yf[0, i0, i0:i1], grid.ginv_bb_yf[0, i0, i0:i1]),
           EDGE_N: (grid.ginv_ab_yf[0, i1, i0:i1], grid.ginv_bb_yf[0, i1, i0:i1])}
    off = {EDGE_S: 0, EDGE_N: h, EDGE_W: 2 * h, EDGE_E: 3 * h}

    def raw_block(strips, fi, f, e):
        b = _strip_base(fi, h) + off[e]
        return strips[f, b:b + h, :]

    def canonical(strips, fi, f, e):
        """Face f / edge e's canonical ghost source (depth 0 nearest)."""
        link = adj[f][e]
        c = raw_block(strips, fi, link.nbr_face, link.nbr_edge)
        if link.nbr_edge in (EDGE_N, EDGE_E):
            c = torch.flip(c, dims=[-2])
        if link.reversed_:
            c = torch.flip(c, dims=[-1])
        return c

    def place(c, e):
        """Canonical ghost strip -> the slot layout the stage reads."""
        return torch.flip(c, dims=[-2]) if e in (EDGE_S, EDGE_W) else c

    def route(strips):
        ghost_rows = [[None] * 12 for _ in range(6)]
        g_adj = {}
        for f in range(6):
            for e in range(4):
                cu = [canonical(strips, 1 + c, f, e) for c in range(2)]
                ru = [place(Tc[0, f, e] * cu[0] + Tc[1, f, e] * cu[1], e),
                      place(Tc[2, f, e] * cu[0] + Tc[3, f, e] * cu[1], e)]
                s = _SLOT[e]
                ghost_rows[f][s] = place(canonical(strips, 0, f, e), e)
                ghost_rows[f][4 + s] = ru[0]
                ghost_rows[f][8 + s] = ru[1]
                # The edge-adjacent ghost row: h-1 in the depth-flipped
                # S/W blocks, 0 in N/E.
                k = h - 1 if e in (EDGE_S, EDGE_W) else 0
                g_adj[(f, e)] = torch.stack([ru[0][k], ru[1][k]])

        def local_normal(f, e):
            ui = torch.stack([raw_block(strips, 1 + c, f, e)[
                h - 1 if e in (EDGE_N, EDGE_E) else 0] for c in range(2)])
            ubar = 0.5 * (ui + g_adj[(f, e)])
            m0, m1 = met[e]
            return m0 * ubar[0] + m1 * ubar[1]

        sym_sn, sym_we = _symmetrized_strips(local_normal)
        return torch.stack([torch.cat(
            ghost_rows[f] + [sym_sn[f], sym_we[f].transpose(0, 1)], dim=0)
            for f in range(6)])

    return route


def make_cov_strip_router_linear(grid):
    """``route(strips) -> ghosts``: :func:`make_cov_strip_router`'s output
    from a handful of tensor-sized ops.

    Every output row is a linear function of the packed strip rows: one
    lane flip, one static row gather (placement and orientation), two
    multiply-adds (the 2x2 covariant rotations, tables in placed layout)
    and the vectorized pair average of the edge normals, each element in
    the loop router's operand order (bitwise equal to it).  Torch index
    ops, as the JAX package runs it as XLA ops.
    """
    n, h = grid.n, grid.halo
    R = 12 * h
    adj = build_connectivity()
    off = {EDGE_S: 0, EDGE_N: h, EDGE_W: 2 * h, EDGE_E: 3 * h}

    # Rotation tables in placed layout, slot-ordered (4, 6, 4, h, n):
    # place() depth-flips the S and W blocks and commutes with the
    # elementwise rotation.
    Tc = _rotation_tables(grid).cpu().numpy()
    Tp = np.stack([Tc[:, :, e] for e in _EORDER], axis=2)
    for s, e in enumerate(_EORDER):
        if e in (EDGE_S, EDGE_W):
            Tp[:, :, s] = Tp[:, :, s, ::-1]
    Tp = torch.from_numpy(np.ascontiguousarray(Tp)).to(grid.device)

    # Row gather: output row (fi, f, slot, k) <- packed strip row, offset
    # by 6R where the pair is lane-reversed (the flipped copy).
    idx = np.empty((3, 6, 4, h), np.int64)
    for f in range(6):
        for s, e in enumerate(_EORDER):
            link = adj[f][e]
            for k in range(h):
                kc = (h - 1 - k) if e in (EDGE_S, EDGE_W) else k
                kr = ((h - 1 - kc)
                      if link.nbr_edge in (EDGE_N, EDGE_E) else kc)
                row = link.nbr_face * R + off[link.nbr_edge] + kr
                for fi in range(3):
                    idx[fi, f, s, k] = (row + fi * 4 * h
                                        + (6 * R if link.reversed_ else 0))
    # Each face/edge's own interior boundary-adjacent (u_a, u_b) row for
    # the edge normals: depth h-1 in N/E blocks, 0 in S/W.
    idx_int = np.empty((2, 6, 4), np.int64)
    for f in range(6):
        for s, e in enumerate(_EORDER):
            k = h - 1 if e in (EDGE_N, EDGE_E) else 0
            for c in range(2):
                idx_int[c, f, s] = f * R + (1 + c) * 4 * h + off[e] + k
    idx_all = torch.from_numpy(np.concatenate(
        [idx.reshape(-1), idx_int.reshape(-1)])).to(grid.device)

    sym_tables = _pair_sym_tables(grid)
    adj_k = [h - 1, 0, h - 1, 0]     # placed edge-adjacent row per slot

    def route(strips):
        s_flat = strips.reshape(6 * R, n)
        s_all = torch.cat([s_flat, torch.flip(s_flat, dims=[-1])], dim=0)
        rows = s_all.index_select(0, idx_all)
        C = rows[:3 * 24 * h].reshape(3, 6, 4, h, n)
        I_u = rows[3 * 24 * h:].reshape(2, 6, 4, n)
        G_ua = Tp[0] * C[1] + Tp[1] * C[2]
        G_ub = Tp[2] * C[1] + Tp[3] * C[2]
        gadj_a = torch.stack([G_ua[:, s, adj_k[s]] for s in range(4)], dim=1)
        gadj_b = torch.stack([G_ub[:, s, adj_k[s]] for s in range(4)], dim=1)
        sym = _pair_symmetrize(I_u, gadj_a, gadj_b, sym_tables)
        return torch.cat([C[0].reshape(6, 4 * h, n),
                          G_ua.reshape(6, 4 * h, n),
                          G_ub.reshape(6, 4 * h, n), sym], dim=1)

    return route


def _fill_ghosts(q_ext, ghosts, fi, n, halo):
    """The stage's frame of field ``fi``: the whole input block (its old
    ghost ring and corners too), its edge ghosts replaced by the routed
    blocks (W/E arrive transposed), as the JAX kernel's ``fill_ghosts``."""
    h = halo
    i0, i1 = h, h + n
    base = _strip_base(fi, h)
    ext = q_ext.clone()
    ext[:, 0:h, i0:i1] = ghosts[:, base:base + h]
    ext[:, i1:i1 + h, i0:i1] = ghosts[:, base + h:base + 2 * h]
    ext[:, i0:i1, 0:h] = ghosts[:, base + 2 * h:base + 3 * h].transpose(1, 2)
    ext[:, i0:i1, i1:i1 + h] = ghosts[:, base + 3 * h:base + 4 * h
                                      ].transpose(1, 2)
    return ext


def cov_stage_inkernel_reference(stage, *args):
    """The plain PyTorch version of one extended-carry stage.

    ``stage`` is a :class:`CovStageInkernel`; ``args`` as for calling it.
    Each field's frame is the input block with the routed edge ghosts
    (:func:`_fill_ghosts`); the RHS imposes the routed sym rows times the
    edge sqrtg.  The whole block becomes ``val = a*y0 + b*frame`` (stage
    1: the frame), its interior ``val + b*dt*L``: the ghost ring keeps
    ``a*y0 + b*routed ghost`` and the corners ``a*y0 + b*input corner``,
    as the JAX kernel writes them.  Returns ``(h (6, M, M), u (2, 6, M,
    M), strips (6, 12h, n))``.
    """
    h0, u0, hc, uc, ghosts, b_ext = stage._unpack(args)
    n, h = stage.n, stage.halo
    i0, i1 = h, h + n
    R = 12 * h
    frames = [_fill_ghosts(q, ghosts, fi, n, h)
              for fi, q in enumerate((hc, uc[0], uc[1]))]
    tends = stage._rhs(stage.fz, *frames, b_ext, ghosts[:, R:R + 2],
                       ghosts[:, R + 2:R + 4].transpose(1, 2),
                       sym_prescaled=False)
    bases = (None, None, None) if u0 is None else (h0, u0[0], u0[1])
    outs = []
    for frame, tend, y0 in zip(frames, tends, bases):
        val = frame if y0 is None else stage.fa * y0 + stage.fb * frame
        val[:, i0:i1, i0:i1] = val[:, i0:i1, i0:i1] + stage.fg * tend
        outs.append(val)
    h_new, u_new = outs[0], torch.stack(outs[1:])
    return h_new, u_new, pack_strips_cov(h_new, u_new, n, h)


def _inkernel_kernel(mode: str = "mc", compute: str = "f32"):
    """The extended-carry stage kernel of reconstruction ``mode`` (the bf16
    compute policy's from ``csrc/cov_stage_inkernel_bf16.cu``): 12 tensor
    pointers; n, halo, with_y0; 8 float constants; the stream."""
    if compute == "bf16":
        lib, name = ("cov_stage_inkernel_bf16",
                     f"cov_stage_inkernel_{mode}_bf16")
    else:
        lib, name = ("cov_stage_inkernel",
                     _entry_name("cov_stage_inkernel", mode))
    return _entry(lib, name, [_P] * 12 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 8 + [_P])


class CovStageInkernel(_StageBase):
    """One covariant SSPRK3 stage over the extended carry, with the ghost
    fill in the kernel.

    ``a == 0``: ``stage(hc, uc, ghosts, b_ext)``; else ``stage(h0, u0,
    hc, uc, ghosts, b_ext)``, with ``h*`` (6, M, M), ``u*`` (2, 6, M, M)
    and ``ghosts`` (6, 12h+4, n) from :func:`make_cov_strip_router_linear`.
    Returns ``(h, u, strips)``: the whole new blocks (see
    :func:`cov_stage_inkernel_reference`) and their packed strips.  Every
    reconstruction (PLR with each limiter; PPM at halo >= 3): CUDA tensors
    launch the mode's instance of ``csrc/cov_stage_inkernel.cu`` (the
    port of the Pallas kernel ``make_cov_stage_inkernel``); CPU tensors
    run the plain version.  There is no other path: a kernel that fails
    to build or launch raises.  ``precision``: its compute half only (the
    bf16 instances of ``csrc/cov_stage_inkernel_bf16.cu``); 16-bit strips
    raise ``ValueError``, as in the JAX package.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, *args, precision=None, **kw):
        pol = resolve_stage_precision(precision)
        if pol is not None and pol.strips == "bf16":
            raise ValueError(
                "the extended-carry (in-kernel exchange) stepper keeps f32 "
                "strips; 16-bit strip storage needs the compact carry "
                "(make_cov_stage_compact / make_fused_ssprk3_cov_compact)")
        super().__init__(*args, precision=pol, **kw)

    def _unpack(self, args):
        if self.with_y0:
            if len(args) != 6:
                raise TypeError("stage(h0, u0, hc, uc, ghosts, b_ext) "
                                f"takes 6 tensors, got {len(args)}")
            return args
        if len(args) != 4:
            raise TypeError("stage(hc, uc, ghosts, b_ext) takes 4 tensors, "
                            f"got {len(args)}")
        return (None, None) + tuple(args)

    def _check(self, h0, u0, hc, uc, ghosts, b_ext):
        n, h, m = self.n, self.halo, self.m
        want = {"hc": (hc, (6, m, m)), "uc": (uc, (2, 6, m, m)),
                "ghosts": (ghosts, (6, 12 * h + 4, n)),
                "b_ext": (b_ext, (6, m, m))}
        if self.with_y0:
            want["h0"] = (h0, (6, m, m))
            want["u0"] = (u0, (2, 6, m, m))
        _check_tensors(want, self.device)

    def __call__(self, *args):
        h0, u0, hc, uc, ghosts, b_ext = self._unpack(args)
        self._check(h0, u0, hc, uc, ghosts, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_inkernel_reference(self, *args)
        ho = torch.empty_like(hc)
        uo = torch.empty_like(uc)
        so = hc.new_empty((6, 12 * self.halo, self.n))
        compute = "f32" if self.precision is None else self.precision.compute
        rc = _inkernel_kernel(self.mode, compute)(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
            ghosts.data_ptr(), b_ext.data_ptr(), self._xc.data_ptr(),
            self._xf.data_ptr(), self.fz.data_ptr(), ho.data_ptr(),
            uo.data_ptr(), so.data_ptr(), self.n, self.halo,
            int(self.with_y0), *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage_inkernel kernel launch failed: cudaError {rc} "
                f"(n={self.n}, halo={self.halo}, mode={self.mode})")
        CovStageInkernel.launches += 1
        return ho, uo, so

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_inkernel_reference(self, *args)


def make_cov_stage_inkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme="plr", limiter="mc", device="cuda",
                            precision=None):
    """One extended-carry stage (see :class:`CovStageInkernel`)."""
    return CovStageInkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme=scheme, limiter=limiter, device=device,
                            precision=precision)


def make_fused_ssprk3_cov_inkernel(grid, gravity: float, omega: float,
                                   dt: float, b_ext, scheme: str = "plr",
                                   limiter: str = "mc", precision=None):
    """``step(y, t) -> y`` over the extended carry ``y = {h, u, strips}``.

    Three stages, each one linear strip route and one stage launch;
    initialise the carry with ``CovariantShallowWater.extend_state(state,
    with_strips=True)``.  ``step.route`` is the router, ``step.stages``
    the three :class:`CovStageInkernel`.
    """
    route = make_cov_strip_router_linear(grid)
    stages = [make_cov_stage_inkernel(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device,
        precision=precision)
        for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

    def step(y, t):
        del t
        h0, u0 = y["h"], y["u"]
        h1, u1, s1 = stage1(h0, u0, route(y["strips"]), b_ext)
        h2, u2, s2 = stage2(h0, u0, h1, u1, route(s1), b_ext)
        h3, u3, s3 = stage3(h0, u0, h2, u2, route(s2), b_ext)
        return {"h": h3, "u": u3, "strips": s3}

    step.route = route
    step.stages = stages
    return step
