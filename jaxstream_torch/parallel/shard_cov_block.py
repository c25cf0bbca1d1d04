"""The explicit sharded covariant tier on the ``(6, s, s)`` block mesh.

Counterpart of :mod:`jaxstream.parallel.shard_cov_block` (its
``nu4 = 0`` form): each rank holds one ``n/s x n/s`` block of a face.
Per SSPRK3 stage and rank:

* **Intra-panel ghosts**: 4 neighbour permutations carrying one ``(3,
  halo, n_loc)`` payload (h + both covariant components; same basis on
  both sides, no rotation).
* **Cube edges**: the 4 race-free stages as permutations over all ranks
  (only face-boundary blocks take part); receivers rotate the velocity
  strips through their slices of the face-level rotation tables and run
  the shared seam algebra (:func:`.shard_cov.apply_cov_cube_recv`).
* **Seam normals**: every block edge gets an imposed edge-normal strip —
  the pair-symmetrized one on panel seams, ``0.5 * (mine + theirs)``
  times the stored metric on intra-panel seams (bitwise the same on both
  sides), so cross-rank flux telescoping is exact.

The serialized form runs the block RHS kernel with the blocks' own
coordinate rows as operands (``make_cov_rhs_pallas_local``, B6), one
launch per RK stage over all the process's ranks; the overlapped form the
interior kernel (B5), likewise one launch, between the exchange's phases
and the torch band after them.  Both take the ranks in groups at one
block position (:func:`.shard_cov.rank_groups`).  Layouts as in
:mod:`.shard_cov`: the stacked local state ``{"h": (R, 1, n_loc,
n_loc), "u": (R, 2, 1, n_loc, n_loc)}`` and the stacked extended blocks
``q`` (R, 3, m_loc, m_loc).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                     build_connectivity, build_schedule)
from ..geometry.cubed_sphere import FACE_AXES, extended_coords
from .shard_cov import (_OUT_SIGN, CUBE_ROW_NAMES, _band_outputs, _embed,
                        _local_rows, _maybe_flip, _read_strips, _set_sym,
                        _sym_strips, _write_ghosts, apply_cov_cube_recv,
                        not_ported, rank_groups, ssprk3_sharded_body)
from .shard_halo import _block_coords

__all__ = ["CovBlockProgram", "make_cov_block_exchange_phases",
           "make_cov_block_exchange", "make_sharded_cov_block_stepper"]


class CovBlockProgram:
    """Static schedule + per-rank tables for the covariant block mesh.

    All tables lead with ``(6, s, s)``, the JAX package's bit for bit;
    rank ``(f * s + iy) * s + ix`` reads row ``[f, iy, ix]``.
    ``intra_perms``: ``(pairs, e_send, e_recv)`` for the four neighbour
    shifts (E->W, W->E, N->S, S->N ghost fills), the pairs over all
    ranks; ``cube_perms``: the four schedule stages' pairs.
    """

    def __init__(self, grid, s: int):
        from ..ops.cuda.swe_cov import _rotation_tables

        n, halo = grid.n, grid.halo
        if n % s:
            raise ValueError(f"n={n} not divisible by blocks-per-edge {s}")
        n_loc = n // s
        if n_loc < halo:
            raise ValueError(f"local block {n_loc} smaller than halo {halo}")
        self.s = s
        self.n_loc = n_loc
        self.halo = halo
        schedule = build_schedule(build_connectivity())
        nst = len(schedule)
        i0f = halo                          # face-extended interior start

        def lin(f, iy, ix):
            return (f * s + iy) * s + ix

        # ---- intra-panel neighbour shifts, over all ranks ---------------
        self.intra_perms = []
        for axis, (a, b), e_send, e_recv in (
                ("x", (0, 1), EDGE_E, EDGE_W), ("x", (1, 0), EDGE_W, EDGE_E),
                ("y", (0, 1), EDGE_N, EDGE_S), ("y", (1, 0), EDGE_S, EDGE_N)):
            pairs = []
            for f in range(6):
                for k in range(s):
                    for i in range(s - 1):
                        src, dst = (i + a, i + b)
                        if axis == "x":
                            pairs.append((lin(f, k, src), lin(f, k, dst)))
                        else:
                            pairs.append((lin(f, src, k), lin(f, dst, k)))
            if pairs:
                self.intra_perms.append((pairs, e_send, e_recv))

        # ---- cube-edge stages (joint permutes over boundary blocks) -----
        stage_of = {}
        self.cube_perms = []
        for t, stage in enumerate(schedule):
            perm = []
            for link, back in stage:
                for lk, other, isl in ((link, back, True),
                                       (back, link, False)):
                    for k in range(s):
                        kk = s - 1 - k if lk.reversed_ else k
                        src = lin(lk.face, *_block_coords(lk.edge, k, s))
                        dst = lin(lk.nbr_face,
                                  *_block_coords(lk.nbr_edge, kk, s))
                        perm.append((src, dst))
                        iy, ix = _block_coords(lk.edge, k, s)
                        stage_of[(lk.face, iy, ix, lk.edge)] = (
                            t, link, back, isl, k, kk)
            if len(set(d for _, d in perm)) != len(perm):
                raise RuntimeError(f"cube stage {t} sends twice to a rank")
            self.cube_perms.append(perm)

        # ---- per-rank tables --------------------------------------------
        T_all = _rotation_tables(grid).cpu().numpy()    # (4, 6, 4, halo, n)
        gaa_xf = grid.ginv_aa_xf.cpu().numpy()
        gab_xf = grid.ginv_ab_xf.cpu().numpy()
        gab_yf = grid.ginv_ab_yf.cpu().numpy()
        gbb_yf = grid.ginv_bb_yf.cpu().numpy()

        def met_seg(face, edge, iy, ix):
            """(2, n_loc) metric rows of block (iy, ix)'s ``edge``."""
            if edge in (EDGE_W, EDGE_E):
                fi = i0f + (ix if edge == EDGE_W else ix + 1) * n_loc
                r0, r1 = i0f + iy * n_loc, i0f + (iy + 1) * n_loc
                return np.stack([gaa_xf[face, r0:r1, fi],
                                 gab_xf[face, r0:r1, fi]])
            fi = i0f + (iy if edge == EDGE_S else iy + 1) * n_loc
            c0, c1 = i0f + ix * n_loc, i0f + (ix + 1) * n_loc
            return np.stack([gab_yf[face, fi, c0:c1],
                             gbb_yf[face, fi, c0:c1]])

        edge_sel = np.zeros((6, s, s, nst), np.int32)
        active = np.zeros((6, s, s, nst), np.float32)
        rev_sel = np.zeros((6, s, s, nst), np.float32)
        is_link = np.zeros((6, s, s, nst), np.float32)
        s_link = np.zeros((6, s, s, nst), np.float32)
        s_back = np.zeros((6, s, s, nst), np.float32)
        T_mine = np.zeros((6, s, s, nst, 4, halo, n_loc), np.float32)
        T_oadj = np.zeros((6, s, s, nst, 4, n_loc), np.float32)
        met_mine = np.zeros((6, s, s, nst, 2, n_loc), np.float32)
        met_oth = np.zeros((6, s, s, nst, 2, n_loc), np.float32)
        met_edge = np.zeros((6, s, s, 4, 2, n_loc), np.float32)

        for f in range(6):
            for iy in range(s):
                for ix in range(s):
                    for e in range(4):
                        met_edge[f, iy, ix, e] = met_seg(f, e, iy, ix)

        for (f, iy, ix, e), (t, link, back, isl, k, kk) in stage_of.items():
            other = back if isl else link
            seg = slice(k * n_loc, (k + 1) * n_loc)
            oseg = slice(kk * n_loc, (kk + 1) * n_loc)
            edge_sel[f, iy, ix, t] = e
            active[f, iy, ix, t] = 1.0
            rev_sel[f, iy, ix, t] = float(link.reversed_)
            is_link[f, iy, ix, t] = float(isl)
            s_link[f, iy, ix, t] = _OUT_SIGN[link.edge]
            s_back[f, iy, ix, t] = _OUT_SIGN[back.edge]
            T_mine[f, iy, ix, t] = T_all[:, f, e][:, :, seg]
            T_oadj[f, iy, ix, t] = T_all[:, other.face, other.edge][
                :, 0, oseg]
            met_mine[f, iy, ix, t] = met_edge[f, iy, ix, e]
            oy, ox = _block_coords(other.edge, kk, s)
            met_oth[f, iy, ix, t] = met_seg(other.face, other.edge, oy, ox)

        # ---- corner-ghost routing (the del^4 Laplacians' corners) -------
        # One-hot source masks per corner in [SW, SE, NW, NE] order: the
        # x-neighbour's strip end, else the y-neighbour's, else the
        # face-local average at a true cube corner.
        use_x = np.zeros((6, s, s, 4), np.float32)
        use_y = np.zeros((6, s, s, 4), np.float32)
        use_avg = np.zeros((6, s, s, 4), np.float32)
        for iy in range(s):
            for ix in range(s):
                for c, (xdir, ydir) in enumerate(
                        [(-1, -1), (+1, -1), (-1, +1), (+1, +1)]):
                    has_x = (ix > 0) if xdir < 0 else (ix < s - 1)
                    has_y = (iy > 0) if ydir < 0 else (iy < s - 1)
                    if has_x:
                        use_x[:, iy, ix, c] = 1.0
                    elif has_y:
                        use_y[:, iy, ix, c] = 1.0
                    else:
                        use_avg[:, iy, ix, c] = 1.0

        # ---- per-rank coordinates and frames ----------------------------
        ac, af, _ = extended_coords(n, halo)
        xr = np.zeros((6, s, s, 1, n_loc + 2 * halo), np.float32)
        xfr = np.zeros_like(xr)
        yc = np.zeros((6, s, s, n_loc + 2 * halo, 1), np.float32)
        yfc = np.zeros_like(yc)
        for iy in range(s):
            for ix in range(s):
                cseg = slice(ix * n_loc, ix * n_loc + n_loc + 2 * halo)
                rseg = slice(iy * n_loc, iy * n_loc + n_loc + 2 * halo)
                xr[:, iy, ix, 0, :] = np.tan(ac[cseg])
                xfr[:, iy, ix, 0, :] = np.tan(af[cseg])
                yc[:, iy, ix, :, 0] = np.tan(ac[rseg])
                yfc[:, iy, ix, :, 0] = np.tan(af[rseg])
        fz = np.broadcast_to(
            np.asarray(FACE_AXES, np.float32)[:, None, None, None, :, 2],
            (6, s, s, 1, 3)).copy()

        self.tables = {k: torch.from_numpy(v).to(grid.device) for k, v in (
            ("edge_sel", edge_sel), ("active", active), ("rev_sel", rev_sel),
            ("is_link", is_link), ("s_link", s_link), ("s_back", s_back),
            ("T_mine", T_mine), ("T_oadj", T_oadj), ("met_mine", met_mine),
            ("met_oth", met_oth), ("met_edge", met_edge), ("xr", xr),
            ("xfr", xfr), ("yc", yc), ("yfc", yfc), ("fz", fz),
            ("corner_use_x", use_x), ("corner_use_y", use_y),
            ("corner_use_avg", use_avg))}

    def rank_tables(self, local_ranks, device):
        """The tables' rows of ``local_ranks``, the ``(6, s, s)`` lead
        flattened to a rank axis."""
        flat = {k: v.reshape((-1,) + tuple(v.shape[3:]))
                for k, v in self.tables.items()}
        return _local_rows(flat, local_ranks, device)


def make_cov_block_exchange_phases(program: CovBlockProgram, ranks,
                                   local_ranks):
    """``(start, finish)`` — the block exchange split at the wire.

    Every payload (intra-panel shifts AND cube-edge stages) is a function
    of the blocks' pre-exchange boundary strips, read once: ``start(q)``
    issues all of them; ``finish(q, phase) -> (q, sym_sn, sym_we)``
    writes the ghosts (in place) and computes both seam-normal algebras.
    As in the JAX package, a rank that a shift does not send to receives
    zeros into that ghost edge and seam row; the cube stages that come
    after overwrite both wherever the edge is a panel seam.
    """
    n, halo = program.n_loc, program.halo
    dev = program.tables["edge_sel"].device
    t = program.rank_tables(local_ranks, dev)
    met_edge = t["met_edge"]                                 # (R, 4, 2, n)
    r = len(local_ranks)
    rank_idx = torch.arange(r, device=dev)
    intra = [(pairs, e_send, e_recv,
              torch.full((r,), e_recv, dtype=torch.long, device=dev))
             for pairs, e_send, e_recv in program.intra_perms]
    cube = []
    for st, perm in enumerate(program.cube_perms):
        rows = tuple(t[name][:, st] for name in CUBE_ROW_NAMES)
        e_s = rows[0].long()
        # The edge each rank writes and symmetrizes; 4 (none) where the
        # rank takes no part in this stage.
        active = torch.where(t["active"][:, st] > 0.5, e_s, 4)
        cube.append((perm, rows, e_s, active))

    def start(q):
        strips = _read_strips(q, halo, n)             # (R, 4, 3, halo, n)
        shifts = [(ranks.ppermute(strips[:, e_send], pairs), e, e_idx)
                  for pairs, e_send, e, e_idx in intra]
        stages = []
        for perm, rows, e_s, active in cube:
            sent = strips[rank_idx, e_s]              # (R, 3, halo, n)
            stages.append((ranks.ppermute(_maybe_flip(sent, rows[1]), perm),
                           sent[:, 1:3], rows, active))
        return strips, shifts, stages

    def finish(q, phase):
        strips, shifts, stages = phase
        sym = q.new_zeros((q.shape[0], 4, n))
        # ---- intra-panel neighbours (same basis; no rotation) ----------
        for recv, e, e_recv in shifts:
            _write_ghosts(q, recv, e_recv, halo, n)
            # Shared seam normal: 0.5*(mine + theirs) is commutative, so
            # both sides compute the identical value with identical
            # metric rows.
            ubar = 0.5 * (strips[:, e, 1:3, 0, :] + recv[:, 1:3, 0, :])
            n_seam = (met_edge[:, e, 0] * ubar[:, 0]
                      + met_edge[:, e, 1] * ubar[:, 1])
            sym = _set_sym(sym, e_recv, n_seam)
        # ---- cube-edge stages (shared seam algebra, shard_cov.py) -------
        for recv, u_send, rows, active in stages:
            mine = apply_cov_cube_recv(q, u_send, recv, rows, active)
            sym = _set_sym(sym, active, mine)
        return (q,) + _sym_strips(sym)

    return start, finish


def make_cov_block_exchange(program: CovBlockProgram, ranks, local_ranks):
    """``exchange(q) -> (q, sym_sn, sym_we)``, the serialized schedule of
    :func:`make_cov_block_exchange_phases`."""
    start, finish = make_cov_block_exchange_phases(program, ranks,
                                                   local_ranks)

    def exchange(q):
        return finish(q, start(q))

    return exchange


def make_sharded_cov_block_stepper(model, setup, dt: float, overlap=None,
                                   temporal_block: int = 1):
    """``step(state, t) -> state`` for the covariant model on (6, s, s).

    ``state`` is :func:`~.mesh.shard_state`'s stacked local state.
    Per RK stage: the exchange, then one launch of the block RHS kernel
    over every local block.  ``overlap`` (default: the setup's
    ``overlap_exchange``): issue every neighbour and cube-edge
    permutation first, run the interior kernel on every block's
    ghost-free ``(n_loc-2h)^2`` core in one launch, then finish the
    exchange and the torch band; needs ``n_loc > 2*halo``.
    ``temporal_block = k``: k steps per call (``steps_per_call``), the
    same operations per step as k calls.  ``nu4 != 0`` is not ported.
    """
    from ..ops.cuda.swe_cov import (make_cov_rhs_band_local,
                                    make_cov_rhs_interior_local,
                                    make_cov_rhs_pallas_local)

    if temporal_block < 1:
        raise ValueError(
            f"temporal_block must be >= 1, got {temporal_block}")
    grid = model.grid
    s = setup.sy
    if setup.ranks is None or setup.panel != 6 or setup.sy != setup.sx \
            or s < 2:
        raise ValueError(
            f"covariant block path needs a (panel=6, s, s) mesh with "
            f"s >= 2; got panel={setup.panel}, y={setup.sy}, x={setup.sx}"
        )
    if float(getattr(model, "nu4", 0.0)) != 0.0:
        not_ported("nu4 != 0 on the block tier (make_block_corner_fill)")
    if grid.device != setup.device:
        raise ValueError(f"the model's grid is on {grid.device}, the "
                         f"ranks on {setup.device}")
    if overlap is None:
        overlap = setup.overlap_exchange
    halo = grid.halo
    dev = setup.device
    program = CovBlockProgram(grid, s)
    n_loc = program.n_loc
    m_loc = n_loc + 2 * halo
    local = setup.local_ranks
    start, finish = make_cov_block_exchange_phases(program, setup.ranks,
                                                   local)
    t = program.rank_tables(local, dev)
    fz, xr, xfr, yc, yfc = (t[k].contiguous() for k in
                            ("fz", "xr", "xfr", "yc", "yfc"))
    # Static per-block orography: the overlapping extended blocks cut
    # from the face-extended field once.
    b_ext = model.b_ext.to(dev)
    b_loc = torch.stack([
        b_ext[f, iy * n_loc:iy * n_loc + m_loc, ix * n_loc:ix * n_loc + m_loc]
        for f, iy, ix in map(setup.coords, local)]).contiguous()
    b_blk = b_loc[:, None]
    kw = dict(scheme=model.scheme, limiter=model.limiter)
    consts = (n_loc, halo, grid.dalpha, grid.radius, model.gravity,
              model.omega)
    rhs_local = make_cov_rhs_pallas_local(*consts, device=dev, **kw)
    groups = rank_groups(setup, local, xr, xfr, yc, yfc)
    if overlap:
        rhs_interior = make_cov_rhs_interior_local(*consts, device=dev, **kw)
        rhs_band = make_cov_rhs_band_local(*consts, **kw)
        sl = slice(halo, halo + n_loc)
        groups_int = rank_groups(setup, local, xr[:, :, sl], xfr[:, :, sl],
                                 yc[:, sl], yfc[:, sl])
        b_int = b_loc[:, None, sl, sl].contiguous()

    def f(h_int, u_int):
        q = _embed(h_int, u_int, halo)
        if overlap:
            # Wire first: every payload is a function of the
            # pre-exchange strips, so the interior kernel needs none of
            # them; the band consumes the received strips.
            phase = start(q)
            dh_c, du_c = rhs_interior.stacked(fz, groups_int, h_int, u_int,
                                              b_int)
            q, ssn, swe = finish(q, phase)
            dh, du = rhs_band(
                fz, xr, xfr, yc, yfc, q[:, 0], q[:, 1:3].transpose(0, 1),
                b_loc, ssn[:, 0], swe[:, 0], dh_c[:, 0],
                du_c[:, :, 0].transpose(0, 1))
            return _band_outputs(dh, du)
        q, ssn, swe = finish(q, start(q))
        return rhs_local.stacked(fz, groups, q[:, 0:1], q[:, 1:3].unsqueeze(2),
                                 b_blk, ssn, swe)

    def step(state, t_now):
        del t_now
        for _ in range(temporal_block):
            state = ssprk3_sharded_body(f, state, dt)
        return state

    if temporal_block > 1:
        step.steps_per_call = temporal_block
    return step
