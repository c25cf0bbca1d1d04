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

import numpy as np
import torch

from ...geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                      build_connectivity, edge_pairs)
from ...parallel.halo import _fill_corners
from ..reconstruct import plr_face_states
from ._launch import KernelBase, _P, _check_tensors, _entry, _ptr
from .swe_rhs import _f32, _fast_frame, coord_rows

__all__ = [
    "pack_strips_cov_split",
    "make_cov_strip_router_split",
    "rhs_core_cov",
    "CovStageCompact",
    "make_cov_stage_compact",
    "cov_stage_compact_reference",
    "make_fused_ssprk3_cov_compact",
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

    ``I_u``: (2, 6, 4, n) interior boundary-adjacent covariant rows;
    ``gadj_*``: (6, 4, n) edge-adjacent rotated ghost rows.  One average
    per physical edge, distributed to both faces by exact permutation.
    """
    M0, M1 = tables[:2]
    ubar0 = 0.5 * (I_u[0] + gadj_a)
    ubar1 = 0.5 * (I_u[1] + gadj_b)
    return _pair_average((M0 * ubar0 + M1 * ubar1).reshape(24, -1), tables)


def _pair_average(L, tables):
    """The pair algebra of :func:`_pair_symmetrize` on the (24, n) local
    edge normals ``L`` in (face*4 + slot) order: (6, 4, n) out."""
    _, _, link_rows, back_rows, rev, sga, sgb, sym_src = tables
    la = L.index_select(0, link_rows)
    lb = L.index_select(0, back_rows)
    lb = torch.where(rev, torch.flip(lb, dims=[-1]), lb)
    avg = 0.5 * (sga * la - sgb * lb)
    na = sga * avg
    nb = sgb * (-avg)
    nb = torch.where(rev, torch.flip(nb, dims=[-1]), nb)
    return torch.cat([na, nb], dim=0).index_select(0, sym_src).reshape(6, 4, -1)


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

    def __init__(self, grid):
        n, h = grid.n, grid.halo
        self.n, self.halo = n, h
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
        self.idx = torch.from_numpy(np.concatenate(
            [idx_sn.reshape(-1), idx_we.reshape(-1), idx_int.reshape(-1)]
        )).to(grid.device)
        self.n_sn = idx_sn.size
        self.n_we = idx_we.size

        # Placed rotation tables, split by orientation: (4, 6, 2, h, n).
        Tc = _rotation_tables(grid)
        self.T_sn = torch.stack([torch.flip(Tc[:, :, EDGE_S], dims=[-2]),
                                 Tc[:, :, EDGE_N]], dim=2)
        self.T_we = torch.stack([torch.flip(Tc[:, :, EDGE_W], dims=[-2]),
                                 Tc[:, :, EDGE_E]], dim=2)
        self.sym_tables = _pair_sym_tables(grid)

    def __call__(self, strips_sn, strips_we, sym_scale=None):
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


def make_cov_strip_router_split(grid):
    """``route(strips_sn, strips_we) -> (gsn, gwe)``.

    ``gsn`` ``(6, 6h+2, n)``: placed S/N ghost blocks per field plus the
    two symmetrized S/N edge-normal rows; ``gwe`` ``(6, n, 6h+2)``: placed
    W/E ghost columns plus the W/E sym columns.  Same algebra and operand
    order as the JAX package's router with ``prescale_sym=True``: the sym
    rows are multiplied by the static edge sqrtg, so the stage imposes
    them as they are.
    """
    n, h = grid.n, grid.halo
    core = _SplitRoute(grid)

    # Static edge sqrtg rows in [S, N, W, E] order, identical for all
    # faces, from the same closed forms the stage would evaluate.
    x_row, xf_row, x_col, xf_col, _ = coord_rows(n, h, grid.device)
    h0, h1 = h, h + n
    r = float(grid.radius)
    sgS = _fast_frame(x_row[:, h0:h1], xf_col[h0:h0 + 1], r)["sqrtg"]
    sgN = _fast_frame(x_row[:, h0:h1], xf_col[h1:h1 + 1], r)["sqrtg"]
    sgW = _fast_frame(xf_row[:, h0:h0 + 1], x_col[h0:h1], r)["sqrtg"]
    sgE = _fast_frame(xf_row[:, h1:h1 + 1], x_col[h0:h1], r)["sqrtg"]
    sym_scale = torch.stack([sgS.reshape(n), sgN.reshape(n),
                             sgW.reshape(n), sgE.reshape(n)])[None]

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


def rhs_core_cov(fz, xr, xfr, yc, yfc, hf, ua, ub, bf, sym_sn, sym_we, *,
                 n, halo, d, radius, gravity, omega, limiter="mc",
                 sym_prescaled=True):
    """Covariant-SWE right-hand side of all faces at once (plain torch).

    ``fz = (c0z, cxz, cyz)``: the face frames' z-components, each
    broadcastable against ``(F, 1, 1)``; ``xr``/``xfr`` (1, M) and
    ``yc``/``yfc`` (M, 1) coordinate rows/columns; ``hf``, ``ua``, ``ub``,
    ``bf`` (F, M, M) with edge ghosts filled (corners are never read by a
    kept output).  ``sym_sn`` (F, 2, n) / ``sym_we`` (F, n, 2): the
    symmetrized edge normals imposed on the boundary faces, as they are
    (``sym_prescaled=True``, the compact stages' routed rows) or times the
    edge sqrtg of the closed-form frame (``False``: ``sg * sym``, the
    unfused RHS and the extended-carry stage).  Returns interior ``(dh,
    dua, dub)``.  The operations and their order follow the JAX package's
    ``rhs_core_cov``.
    """
    h0, h1 = halo, halo + n
    inv2d = _f32(1.0 / (2.0 * d))
    g = _f32(gravity)
    two_omega = _f32(2.0 * omega)
    if sym_prescaled:
        uS, uN = sym_sn[:, 0:1, :], sym_sn[:, 1:2, :]
        uW, uE = sym_we[:, :, 0:1], sym_we[:, :, 1:2]
    else:
        def sg(xr_, yc_):
            return _fast_frame(xr_, yc_, radius)["sqrtg"]

        uS = sg(xr[:, h0:h1], yfc[h0:h0 + 1]) * sym_sn[:, 0:1, :]
        uN = sg(xr[:, h0:h1], yfc[h1:h1 + 1]) * sym_sn[:, 1:2, :]
        uW = sg(xfr[:, h0:h0 + 1], yc[h0:h1]) * sym_we[:, :, 0:1]
        uE = sg(xfr[:, h1:h1 + 1], yc[h0:h1]) * sym_we[:, :, 1:2]

    # ---- continuity: upwind PLR flux with the sqrtg-folded metric ------
    Fx = _fast_frame(xfr[:, h0:h1 + 1], yc[h0:h1], radius)
    uba = 0.5 * (ua[:, h0:h1, h0 - 1:h1] + ua[:, h0:h1, h0:h1 + 1])
    ubb = 0.5 * (ub[:, h0:h1, h0 - 1:h1] + ub[:, h0:h1, h0:h1 + 1])
    ux = Fx["fg_aa"] * uba + Fx["fg_ab"] * ubb          # sqrtg u^a
    ux = torch.cat([uW, ux[:, :, 1:n], uE], dim=-1)
    qL, qR = plr_face_states(hf[:, h0:h1, :], -1, halo, n, limiter)
    fx = torch.clamp(ux, min=0.0) * qL + torch.clamp(ux, max=0.0) * qR

    Fy = _fast_frame(xr[:, h0:h1], yfc[h0:h1 + 1], radius)
    vba = 0.5 * (ua[:, h0 - 1:h1, h0:h1] + ua[:, h0:h1 + 1, h0:h1])
    vbb = 0.5 * (ub[:, h0 - 1:h1, h0:h1] + ub[:, h0:h1 + 1, h0:h1])
    uy = Fy["fg_ab"] * vba + Fy["fg_bb"] * vbb          # sqrtg u^b
    uy = torch.cat([uS, uy[:, 1:n, :], uN], dim=-2)
    qL, qR = plr_face_states(hf[:, :, h0:h1], -2, halo, n, limiter)
    fy = torch.clamp(uy, min=0.0) * qL + torch.clamp(uy, max=0.0) * qR

    # ---- momentum, vector-invariant in covariant components ------------
    b0, b1 = h0 - 1, h1 + 1
    Fb = _fast_frame(xr[:, b0:b1], yc[b0:b1], radius)
    Fc = {k: _center(v) for k, v in Fb.items()}
    inv_sg_d = Fc["inv_sqrtg"] * _f32(1.0 / d)
    dh = -((fx[..., 1:] - fx[..., :-1])
           + (fy[..., 1:, :] - fy[..., :-1, :])) * inv_sg_d
    uab = ua[:, b0:b1, b0:b1]
    ubb_ = ub[:, b0:b1, b0:b1]
    uca = Fb["inv_aa"] * uab + Fb["inv_ab"] * ubb_       # u^alpha, band
    ucb = Fb["inv_ab"] * uab + Fb["inv_bb"] * ubb_       # u^beta, band
    ke = 0.5 * (uca * uab + ucb * ubb_)
    bern = g * (hf[:, b0:b1, b0:b1] + bf[:, b0:b1, b0:b1]) + ke
    dba = (bern[:, 1:-1, 2:] - bern[:, 1:-1, :-2]) * inv2d
    dbb = (bern[:, 2:, 1:-1] - bern[:, :-2, 1:-1]) * inv2d

    dub_da = (ub[:, h0:h1, h0 + 1:h1 + 1] - ub[:, h0:h1, h0 - 1:h1 - 1]) * inv2d
    dua_db = (ua[:, h0 + 1:h1 + 1, h0:h1] - ua[:, h0 - 1:h1 - 1, h0:h1]) * inv2d

    # (zeta + f) sqrtg = covariant curl + 2 Omega rhat_z sqrtg.
    rz = (fz[0] + Fc["x"] * fz[1] + Fc["y"] * fz[2]) * Fc["inv_rho"]
    absv = (dub_da - dua_db) + (two_omega * rz) * Fc["sqrtg"]

    dua = absv * ucb[:, 1:-1, 1:-1] - dba
    dub = -absv * uca[:, 1:-1, 1:-1] - dbb
    return dh, dua, dub


def _fill(q_int, gsn, gwe, fi, n, halo, corners=False):
    """Extended (6, M, M) field ``fi`` from the interior and the routed
    ghosts, in the placement of the JAX package's ``_make_fill``.

    ``corners=False`` leaves the h x h ghost corners zero: the stage's
    dimension-split stencils never read them.  ``corners=True`` fills
    them by edge-ghost averaging (``_make_fill(corners=True)``, the same
    formula as the halo exchanger's): the del^4 filter needs them, since
    its Laplacians' cross-derivative terms read the corners.
    """
    h = halo
    i0, i1 = h, h + n
    ext = q_int.new_zeros((6, n + 2 * h, n + 2 * h))
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
    constants and coordinate rows and the routed (prescaled) sym rows."""
    h = stage.halo
    return stage._rhs(stage.fz, hf, ua, ub, b_ext, gsn[:, 6 * h:6 * h + 2],
                      gwe[:, :, 6 * h:6 * h + 2], sym_prescaled=True)


def _stage_advance(stage, args, corners=False):
    """Fill, right-hand side and RK combine of one stage: the plain
    version's core, shared by the compact stage and the in-stage del^4
    kernel A.  Returns ``(h_new, u_new, (hf, ua, ub))``, the last the
    ghost-filled stage input (``corners``: see :func:`_fill`)."""
    h0, u0, hc, uc, gsn, gwe, b_ext = stage._unpack(args)
    n, h = stage.n, stage.halo
    frames = tuple(_fill(q, gsn, gwe, fi, n, h, corners=corners)
                   for fi, q in enumerate((hc, uc[0], uc[1])))
    dh, dua, dub = _stage_rhs(stage, *frames, b_ext, gsn, gwe)

    fa, fb, fg = stage.fa, stage.fb, stage.fg

    def combine(yc, y0, tend):
        if stage.with_y0:
            return (fa * y0 + fb * yc) + fg * tend
        return yc + fg * tend

    h_new = combine(hc, h0, dh)
    u_new = torch.stack([
        combine(uc[0], None if u0 is None else u0[0], dua),
        combine(uc[1], None if u0 is None else u0[1], dub)])
    return h_new, u_new, frames


def cov_stage_compact_reference(stage, *args):
    """The plain PyTorch version of one compact stage.

    ``stage`` is a :class:`CovStageCompact` (its coefficients, constants
    and coordinate rows); ``args`` as for calling it.  Used on CPU tensors
    by the stage itself, and by the tests and ``chip_smoke.py`` to hold
    the CUDA kernel against it.  Returns ``(h, u, strips_sn, strips_we)``.
    """
    h_new, u_new, _ = _stage_advance(stage, args)
    sn, we = pack_strips_cov_split(h_new, u_new, stage.n, stage.halo)
    return h_new, u_new, sn, we


# ---------------------------------------------------------------------------
# The stage: kernel wrapper
# ---------------------------------------------------------------------------


def _kernel():
    """The stage kernel: 14 tensor pointers; n, halo, with_y0; 8 float
    constants; the stream."""
    return _entry("cov_stage", "cov_stage_compact_f32",
                  [_P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8
                  + [_P])


class _RhsBase(KernelBase):
    """Float32 constants, coordinate rows and face frames of the covariant
    right-hand side: what every kernel wrapper of this module shares."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", device="cuda"):
        if scheme != "plr" or limiter != "mc":
            raise NotImplementedError(
                f"the stage kernel implements PLR with the MC limiter; got "
                f"scheme={scheme!r}, limiter={limiter!r} (other "
                "reconstructions: ROADMAP queue A item 1 and queue B item 1)")
        if halo < 2:
            raise ValueError(f"PLR needs halo >= 2, got {halo}")
        self.n, self.halo, self.m = n, halo, n + 2 * halo
        self.dalpha, self.radius = float(dalpha), float(radius)
        self.gravity, self.omega = float(gravity), float(omega)
        self.limiter = limiter
        # The kernels' float32 constants of the RHS, rounded as
        # rhs_core_cov and _fast_frame round them.
        self._rhs_consts = (
            _f32(_f32(self.radius) ** 2), _f32(self.gravity),
            _f32(2.0 * self.omega), _f32(1.0 / (2.0 * self.dalpha)),
            _f32(1.0 / self.dalpha))
        self.device = torch.device(device)
        x_row, xf_row, x_col, xf_col, frames = coord_rows(n, halo, self.device)
        self.coords = (x_row, xf_row, x_col, xf_col)
        self.fz = frames[:, :, 2].contiguous()            # (6, 3) frame z
        self._xc = x_row.reshape(-1).contiguous()
        self._xf = xf_row.reshape(-1).contiguous()

    def _rhs(self, fz, hf, ua, ub, b_ext, sym_sn, sym_we, sym_prescaled):
        """:func:`rhs_core_cov` with these constants and coordinate rows;
        ``fz`` (F, 3) gives the faces' frame z-components."""
        x_row, xf_row, x_col, xf_col = self.coords
        fzs = tuple(fz[:, k].reshape(-1, 1, 1) for k in range(3))
        return rhs_core_cov(
            fzs, x_row, xf_row, x_col, xf_col, hf, ua, ub, b_ext, sym_sn,
            sym_we, n=self.n, halo=self.halo, d=self.dalpha,
            radius=self.radius, gravity=self.gravity, omega=self.omega,
            limiter=self.limiter, sym_prescaled=sym_prescaled)


class _StageBase(_RhsBase):
    """Coefficients and constants of one covariant SSPRK3 stage
    ``a*y0 + b*yc + b*dt*L(yc)``, and the checks of its arguments: what
    the stage kernels' wrappers share."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, a: float, b: float,
                 scheme: str = "plr", limiter: str = "mc", device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega,
                         scheme=scheme, limiter=limiter, device=device)
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

    CUDA tensors launch ``csrc/cov_stage.cu``; CPU tensors run
    :func:`cov_stage_compact_reference`.  There is no other path: a
    kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __call__(self, *args):
        h0, u0, hc, uc, gsn, gwe, b_ext = self._unpack(args)
        self._check(h0, u0, hc, uc, gsn, gwe, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_compact_reference(self, *args)
        return self._launch(h0, u0, hc, uc, gsn, gwe, b_ext)

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_compact_reference(self, *args)

    def _launch(self, h0, u0, hc, uc, gsn, gwe, b_ext):
        n, h = self.n, self.halo
        ho = torch.empty_like(hc)
        uo = torch.empty_like(uc)
        ssn = hc.new_empty((6, 6 * h, n))
        swe = hc.new_empty((6, n, 6 * h))
        rc = _kernel()(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(), gsn.data_ptr(),
            gwe.data_ptr(), b_ext.data_ptr(), self._xc.data_ptr(),
            self._xf.data_ptr(), self.fz.data_ptr(), ho.data_ptr(),
            uo.data_ptr(), ssn.data_ptr(), swe.data_ptr(),
            n, h, int(self.with_y0), *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage kernel launch failed: cudaError {rc} "
                f"(n={n}, halo={h})")
        CovStageCompact.launches += 1
        return ho, uo, ssn, swe


def make_cov_stage_compact(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                           scheme="plr", limiter="mc", device="cuda"):
    """One compact stage (see :class:`CovStageCompact`)."""
    return CovStageCompact(n, halo, dalpha, radius, gravity, omega, dt, a, b,
                           scheme=scheme, limiter=limiter, device=device)


def make_fused_ssprk3_cov_compact(grid, gravity: float, omega: float,
                                  dt: float, b_ext, scheme: str = "plr",
                                  limiter: str = "mc"):
    """``step(y, t) -> y`` over ``y = {h, u, strips_sn, strips_we}``.

    Three stages, each one strip route and one stage launch; initialise
    the carry with ``CovariantShallowWater.compact_state``.
    """
    route = make_cov_strip_router_split(grid)
    stages = [make_cov_stage_compact(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device)
        for a, b in SSPRK3_COEFFS]
    stage1, stage2, stage3 = stages

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

    step.route = route
    step.stages = stages
    return step


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
    ``(h, u, strips_sn, strips_we)``.
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
    return h_new, u_new, sn, we


# ---------------------------------------------------------------------------
# The del^4 filter: kernel wrapper
# ---------------------------------------------------------------------------


def _filter_kernel():
    """The filter kernel: 10 tensor pointers; n, halo; R^2, 1/d, 0.5/d,
    damp; the stream."""
    return _entry("cov_nu4_filter", "cov_nu4_filter_f32",
                  [_P] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
                  + [_P])


class CovNu4Filter:
    """The once-per-step del^4 filter ``q -= dt_eff nu4 lap(lap q)``.

    ``filt(hc, uc, gsn, gwe) -> (h, u, strips_sn, strips_we)`` on h,
    u_a, u_b, with ghosts from the routed blocks of the state's strips.
    CUDA tensors launch ``csrc/cov_nu4_filter.cu`` (the port of the
    Pallas kernel ``make_cov_nu4_filter``); CPU tensors run
    :func:`cov_nu4_filter_reference`.  There is no other path: a kernel
    that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 nu4: float, dt_eff: float, device="cuda"):
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

    def _check(self, hc, uc, gsn, gwe):
        n, h = self.n, self.halo
        _check_tensors({"hc": (hc, (6, n, n)), "uc": (uc, (2, 6, n, n)),
                        "gsn": (gsn, (6, 6 * h + 2, n)),
                        "gwe": (gwe, (6, n, 6 * h + 2))}, self.device)

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
        ssn = hc.new_empty((6, 6 * h, n))
        swe = hc.new_empty((6, n, 6 * h))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _filter_kernel()(
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


def make_cov_nu4_filter(grid, nu4: float, dt_eff: float, device=None):
    """The del^4 filter on ``grid`` (see :class:`CovNu4Filter`); ``device``
    defaults to the grid's."""
    return CovNu4Filter(grid.n, grid.halo, grid.dalpha, grid.radius, nu4,
                        dt_eff, device=grid.device if device is None
                        else device)


def make_fused_ssprk3_cov_split_nu4(grid, gravity: float, omega: float,
                                    dt: float, b_ext, nu4: float,
                                    interval: int = 1, scheme: str = "plr",
                                    limiter: str = "mc"):
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
    """
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    advance = make_fused_ssprk3_cov_compact(grid, gravity, omega, dt, b_ext,
                                            scheme=scheme, limiter=limiter)
    route = advance.route
    filt = make_cov_nu4_filter(grid, nu4, dt * interval)

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
    return h1, u1, filt[0], torch.stack(filt[1:]), sn, we


def _refused_kernel():
    """The re-fused stage-1 kernel: 14 tensor pointers; n, halo; 7 float
    constants; the stream."""
    return _entry("cov_stage_refused_nu4", "cov_stage_refused_nu4_f32",
                  [_P] * 14 + [ctypes.c_int] * 2 + [ctypes.c_float] * 7
                  + [_P])


class CovStageRefusedNu4(_StageBase):
    """Stage 1 with the del^4 filter fused in front of the RHS.

    ``stage1f(hc, uc, gsn, gwe, b_ext) -> (h1, u1, h0f, u0f, strips_sn,
    strips_we)``: the filter ``q -= dt nu4 lap(lap q)`` on the interiors
    of h, u_a, u_b (the split filter's arithmetic, ring-1 first
    Laplacian), then the plain stage-1 RHS and combine on the filtered
    interior with the unfiltered routed ghosts.  CUDA tensors launch
    ``csrc/cov_stage_refused_nu4.cu`` (the port of the Pallas kernel
    ``make_cov_stage_refused_nu4``); CPU tensors run
    :func:`cov_stage_refused_nu4_reference`.  There is no other path: a
    kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, dt: float, nu4: float,
                 scheme: str = "plr", limiter: str = "mc", device="cuda"):
        super().__init__(n, halo, dalpha, radius, gravity, omega, dt, 0.0,
                         1.0, scheme=scheme, limiter=limiter, device=device)
        self.nu4 = float(nu4)
        # Rounded once from float64, as the JAX kernel rounds it.
        self.damp = _f32(self.dt * self.nu4)
        self._rconsts = self._kconsts[:5] + (self.fg, self.damp)

    def __call__(self, hc, uc, gsn, gwe, b_ext):
        self._check(None, None, hc, uc, gsn, gwe, b_ext)
        if not self._on_cuda(hc):
            return cov_stage_refused_nu4_reference(self, hc, uc, gsn, gwe,
                                                   b_ext)
        n, h = self.n, self.halo
        outs = (torch.empty_like(hc), torch.empty_like(uc),
                torch.empty_like(hc), torch.empty_like(uc),
                hc.new_empty((6, 6 * h, n)), hc.new_empty((6, n, 6 * h)))
        rc = _refused_kernel()(
            hc.data_ptr(), uc.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
            b_ext.data_ptr(), self._xc.data_ptr(), self._xf.data_ptr(),
            self.fz.data_ptr(), *[t.data_ptr() for t in outs],
            n, h, *self._rconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage_refused_nu4 kernel launch failed: cudaError "
                f"{rc} (n={n}, halo={h})")
        CovStageRefusedNu4.launches += 1
        return outs

    def reference(self, hc, uc, gsn, gwe, b_ext):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_refused_nu4_reference(self, hc, uc, gsn, gwe, b_ext)


def make_cov_stage_refused_nu4(grid, gravity: float, omega: float,
                               dt: float, nu4: float, scheme: str = "plr",
                               limiter: str = "mc", device=None):
    """The re-fused stage 1 on ``grid`` (see :class:`CovStageRefusedNu4`);
    ``device`` defaults to the grid's."""
    return CovStageRefusedNu4(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt, nu4,
        scheme=scheme, limiter=limiter,
        device=grid.device if device is None else device)


def make_fused_ssprk3_cov_refused_nu4(grid, gravity: float, omega: float,
                                      dt: float, b_ext, nu4: float,
                                      scheme: str = "plr",
                                      limiter: str = "mc"):
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
    the two compact stages.
    """
    route = make_cov_strip_router_split(grid)
    stage1f = make_cov_stage_refused_nu4(grid, gravity, omega, dt, nu4,
                                         scheme=scheme, limiter=limiter)
    stage2, stage3 = [make_cov_stage_compact(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device)
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


def _nu4_a_kernel():
    """Kernel A: 16 tensor pointers; n, halo, with_y0; 8 float constants;
    the stream."""
    return _entry("cov_stage_nu4", "cov_stage_nu4_a_f32",
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
    of the Pallas pair of ``make_cov_stage_nu4``), each with its own
    launch counter; CPU tensors run :func:`cov_stage_nu4_a_reference` /
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
        rc = _nu4_a_kernel()(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
            gsn.data_ptr(), gwe.data_ptr(), b_ext.data_ptr(),
            self._xc.data_ptr(), self._xf.data_ptr(), self.fz.data_ptr(),
            *[t.data_ptr() for t in outs], n, h, int(self.with_y0),
            *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(f"cov_stage_nu4 kernel A launch failed: "
                               f"cudaError {rc} (n={n}, halo={h})")
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


def _rhs_kernel():
    """The unfused RHS kernel: 10 tensor pointers; n_faces, n, halo; 5
    float constants; the stream."""
    return _entry("cov_rhs", "cov_rhs_f32",
                  [_P] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                  + [_P])


class CovRhs(_RhsBase):
    """The covariant right-hand side of ghost-filled extended faces.

    ``rhs(fz, h_ext, u_ext, b_ext, sym_sn, sym_we) -> (dh, du)`` over F =
    ``n_faces`` faces: ``fz`` (F, 1, 3) the faces' frame z-components,
    ``h_ext``, ``b_ext`` (F, M, M), ``u_ext`` (2, F, M, M), the
    un-prescaled symmetrized edge normals ``sym_sn`` (F, 2, n) and
    ``sym_we`` (F, n, 2); interior tendencies ``dh`` (F, n, n) and ``du``
    (2, F, n, n) out.  CUDA tensors launch ``csrc/cov_rhs.cu`` (the port
    of the Pallas kernel ``make_cov_rhs_pallas``); CPU tensors, or any
    tensors with ``interpret=True``, run :func:`cov_rhs_reference`.
    There is no other path: a kernel that fails to build or launch raises.
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

    def _check(self, fz, h_ext, u_ext, b_ext, sym_sn, sym_we):
        nf, n, m = self.n_faces, self.n, self.m
        _check_tensors({"fz": (fz, (nf, 1, 3)), "h_ext": (h_ext, (nf, m, m)),
                        "u_ext": (u_ext, (2, nf, m, m)),
                        "b_ext": (b_ext, (nf, m, m)),
                        "sym_sn": (sym_sn, (nf, 2, n)),
                        "sym_we": (sym_we, (nf, n, 2))}, self.device)

    def __call__(self, fz, h_ext, u_ext, b_ext, sym_sn, sym_we):
        args = (fz, h_ext, u_ext, b_ext, sym_sn, sym_we)
        self._check(*args)
        if self.interpret or not self._on_cuda(h_ext):
            return cov_rhs_reference(self, *args)
        n, nf = self.n, self.n_faces
        dh = h_ext.new_empty((nf, n, n))
        du = h_ext.new_empty((2, nf, n, n))
        rc = _rhs_kernel()(
            *[t.data_ptr() for t in args], self._xc.data_ptr(),
            self._xf.data_ptr(), dh.data_ptr(), du.data_ptr(), nf, n,
            self.halo, *self._rhs_consts, self._stream())
        if rc != 0:
            raise RuntimeError(f"cov_rhs kernel launch failed: cudaError "
                               f"{rc} (n={n}, halo={self.halo})")
        CovRhs.launches += 1
        return dh, du

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_rhs_reference(self, *args)


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


def _inkernel_kernel():
    """The extended-carry stage kernel: 12 tensor pointers; n, halo,
    with_y0; 8 float constants; the stream."""
    return _entry("cov_stage_inkernel", "cov_stage_inkernel_f32",
                  [_P] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 8
                  + [_P])


class CovStageInkernel(_StageBase):
    """One covariant SSPRK3 stage over the extended carry, with the ghost
    fill in the kernel.

    ``a == 0``: ``stage(hc, uc, ghosts, b_ext)``; else ``stage(h0, u0,
    hc, uc, ghosts, b_ext)``, with ``h*`` (6, M, M), ``u*`` (2, 6, M, M)
    and ``ghosts`` (6, 12h+4, n) from :func:`make_cov_strip_router_linear`.
    Returns ``(h, u, strips)``: the whole new blocks (see
    :func:`cov_stage_inkernel_reference`) and their packed strips.  CUDA
    tensors launch ``csrc/cov_stage_inkernel.cu`` (the port of the Pallas
    kernel ``make_cov_stage_inkernel``); CPU tensors run the plain
    version.  There is no other path: a kernel that fails to build or
    launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

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
        rc = _inkernel_kernel()(
            _ptr(h0), _ptr(u0), hc.data_ptr(), uc.data_ptr(),
            ghosts.data_ptr(), b_ext.data_ptr(), self._xc.data_ptr(),
            self._xf.data_ptr(), self.fz.data_ptr(), ho.data_ptr(),
            uo.data_ptr(), so.data_ptr(), self.n, self.halo,
            int(self.with_y0), *self._kconsts, self._stream())
        if rc != 0:
            raise RuntimeError(
                f"cov_stage_inkernel kernel launch failed: cudaError {rc} "
                f"(n={self.n}, halo={self.halo})")
        CovStageInkernel.launches += 1
        return ho, uo, so

    def reference(self, *args):
        """The plain version on the same arguments (tests and smoke)."""
        return cov_stage_inkernel_reference(self, *args)


def make_cov_stage_inkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme="plr", limiter="mc", device="cuda"):
    """One extended-carry stage (see :class:`CovStageInkernel`)."""
    return CovStageInkernel(n, halo, dalpha, radius, gravity, omega, dt, a,
                            b, scheme=scheme, limiter=limiter, device=device)


def make_fused_ssprk3_cov_inkernel(grid, gravity: float, omega: float,
                                   dt: float, b_ext, scheme: str = "plr",
                                   limiter: str = "mc"):
    """``step(y, t) -> y`` over the extended carry ``y = {h, u, strips}``.

    Three stages, each one linear strip route and one stage launch;
    initialise the carry with ``CovariantShallowWater.extend_state(state,
    with_strips=True)``.  ``step.route`` is the router, ``step.stages``
    the three :class:`CovStageInkernel`.
    """
    route = make_cov_strip_router_linear(grid)
    stages = [make_cov_stage_inkernel(
        grid.n, grid.halo, grid.dalpha, grid.radius, gravity, omega, dt,
        a, b, scheme=scheme, limiter=limiter, device=grid.device)
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
