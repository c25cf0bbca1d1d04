"""The explicit sharded covariant tier: one cube face per rank.

Counterpart of :mod:`jaxstream.parallel.shard_cov` (its one-step-per-call
form, with ``nu4``).  Each SSPRK3 stage is the reference's four
race-free exchange stages (:func:`~..geometry.connectivity.build_schedule`),
each ONE :meth:`ppermute` of a ``(3, halo, n)`` payload per rank — the h
strip and both covariant velocity components together — then the
covariant RHS of the rank's face and the RK combine.

The receiver rotates the incoming velocity strips through per-ghost-slot
2x2 entries (``T[i][j] = e_i^local . a_j^nbr``, the same tables as the
single-device routers) and reconstructs BOTH panels' edge normals from
the same exchanged strips, applying the canonical (link, back)
symmetrization: both sides of an edge compute identical expressions on
identical operands, so their edge fluxes agree bitwise and mass is
conserved across ranks.  Per-rank variation is data
(:class:`CovShardProgram`'s tables), the program uniform.

Layout.  A tier's program works on the stacked blocks of the ranks this
process holds (:attr:`ShardingSetup.local_ranks`, R of them): the state
``{"h": (R, 1, n, n), "u": (R, 2, 1, n, n)}`` (each rank's slice is the
JAX package's per-device block), and inside a stage the extended block
``q`` (R, 3, M, M) holding h, u_a, u_b — the JAX package's ``blk3``.
The exchange is split at the wire as in the JAX package: ``start``
reads the boundary strips and issues every permutation; ``finish``
writes the ghosts and computes the seam normals.  The serialized form
then runs the RHS kernel of whole faces (B4, ``CovRhs.stacked``) once
over all local faces; the overlapped form runs the interior kernel (B5)
between the phases, one launch over all local faces, and the torch band
after them (both grouped by :func:`rank_groups`).  With ``nu4 != 0``
each stage then subtracts ``nu4 * lap(lap(.))`` of the exchanged state,
the Laplacians the plain :func:`~..ops.cuda.swe_cov.lap_core` on corner-
filled blocks with one more exchange between them, as the JAX tier
computes it (in jnp, so no kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                     build_connectivity, build_schedule)
from ..geometry.cubed_sphere import FACE_AXES
from .halo import _fill_corners, canonicalize_strip, place_strip

__all__ = ["CovShardProgram", "CUBE_ROW_NAMES", "apply_cov_cube_recv",
           "ssprk3_sharded_body", "make_cov_shard_exchange_phases",
           "make_cov_shard_exchange", "make_sharded_cov_stepper",
           "not_ported", "rank_groups"]

_OUT_SIGN = {EDGE_S: -1.0, EDGE_W: -1.0, EDGE_N: 1.0, EDGE_E: 1.0}


def not_ported(what: str):
    """Refuse a sharded-tier option this port does not run yet."""
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A item 4 (A8)")


class CovShardProgram:
    """Static schedule + per-rank parameter tables of the face tier.

    ``perms``: the four stages' ``(src_face, dst_face)`` pairs.  Tables
    (nstages = 4; leading axis = face), the JAX package's bit for bit:

      edge_sel (6, 4) i32      — my edge exchanging in stage s
      rev_sel  (6, 4) f32 0/1  — pair reverses along-edge order
      is_link  (6, 4) f32 0/1  — am I the pair's canonical 'link' side
      s_link / s_back (6, 4)   — OUT_SIGN of the link / back edge
      T_mine   (6, 4, 4, halo, n) — ghost rotation entries (i*2+j),
                 canonical layout, input = received (my-order) raw comps
      T_oadj   (6, 4, 4, n)    — the OTHER face's adjacent-slot entries
      met_mine / met_oth (6, 4, 2, n) — (m0, m1) edge-face inverse-metric
                 rows of my / the other edge, from the grid's stored metric
    """

    def __init__(self, grid):
        from ..ops.cuda.swe_cov import _rotation_tables

        n, halo = grid.n, grid.halo
        i0, i1 = halo, halo + n
        schedule = build_schedule(build_connectivity())
        self.n, self.halo = n, halo

        self.perms = []
        stage_of = {}
        for s, stage in enumerate(schedule):
            perm = []
            for link, back in stage:
                perm.append((link.face, link.nbr_face))
                perm.append((back.face, back.nbr_face))
                stage_of[(link.face, link.edge)] = (s, link, back, True)
                stage_of[(back.face, back.edge)] = (s, link, back, False)
            self.perms.append(perm)

        T_all = _rotation_tables(grid).cpu().numpy()    # (4, 6, 4, halo, n)
        gaa_xf = grid.ginv_aa_xf.cpu().numpy()
        gab_xf = grid.ginv_ab_xf.cpu().numpy()
        gab_yf = grid.ginv_ab_yf.cpu().numpy()
        gbb_yf = grid.ginv_bb_yf.cpu().numpy()

        def met_of(face, edge):
            if edge in (EDGE_W, EDGE_E):
                fi = i0 if edge == EDGE_W else i1
                return np.stack([gaa_xf[face, i0:i1, fi],
                                 gab_xf[face, i0:i1, fi]])
            fi = i0 if edge == EDGE_S else i1
            return np.stack([gab_yf[face, fi, i0:i1],
                             gbb_yf[face, fi, i0:i1]])

        nst = len(schedule)
        edge_sel = np.zeros((6, nst), np.int32)
        rev_sel = np.zeros((6, nst), np.float32)
        is_link = np.zeros((6, nst), np.float32)
        s_link = np.zeros((6, nst), np.float32)
        s_back = np.zeros((6, nst), np.float32)
        T_mine = np.zeros((6, nst, 4, halo, n), np.float32)
        T_oadj = np.zeros((6, nst, 4, n), np.float32)
        met_mine = np.zeros((6, nst, 2, n), np.float32)
        met_oth = np.zeros((6, nst, 2, n), np.float32)

        for (f, e), (s, link, back, mine_is_link) in stage_of.items():
            other = back if mine_is_link else link
            edge_sel[f, s] = e
            rev_sel[f, s] = float(link.reversed_)
            is_link[f, s] = float(mine_is_link)
            s_link[f, s] = _OUT_SIGN[link.edge]
            s_back[f, s] = _OUT_SIGN[back.edge]
            T_mine[f, s] = T_all[:, f, e]
            T_oadj[f, s] = T_all[:, other.face, other.edge][:, 0, :]
            met_mine[f, s] = met_of(f, e)
            met_oth[f, s] = met_of(other.face, other.edge)

        self.tables = {k: torch.from_numpy(v).to(grid.device) for k, v in (
            ("edge_sel", edge_sel), ("rev_sel", rev_sel),
            ("is_link", is_link), ("s_link", s_link), ("s_back", s_back),
            ("T_mine", T_mine), ("T_oadj", T_oadj),
            ("met_mine", met_mine), ("met_oth", met_oth))}


#: Table-row order expected by :func:`apply_cov_cube_recv`.
CUBE_ROW_NAMES = ("edge_sel", "rev_sel", "is_link", "s_link", "s_back",
                  "T_mine", "T_oadj", "met_mine", "met_oth")


def _rank_view(mask, like):
    """A per-rank (R,) mask or factor shaped to broadcast against
    ``like`` (R, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _maybe_flip(row, rev):
    """Each rank's ``row`` reversed along its last axis where its
    ``rev`` (R,) flag is set."""
    return torch.where(_rank_view(rev > 0.5, row), torch.flip(row, [-1]),
                       row)


def _read_strips(q, halo: int, n: int):
    """The canonical interior boundary strips of every edge of the
    stacked blocks ``q`` (R, 3, M, M): (R, 4, 3, halo, n), edges in S,
    E, N, W order (the JAX package's ``read_strip``)."""
    h, hn = halo, halo + n
    raw = {EDGE_S: q[..., h:2 * h, h:hn], EDGE_N: q[..., hn - h:hn, h:hn],
           EDGE_W: q[..., h:hn, h:2 * h], EDGE_E: q[..., h:hn, hn - h:hn]}
    return torch.stack([canonicalize_strip(e, raw[e]) for e in range(4)],
                       dim=1)


def _ghost_region(q, edge: int, halo: int, n: int):
    """The ghost-ring block of ``edge`` of the stacked blocks (a view)."""
    h, hn = halo, halo + n
    if edge == EDGE_S:
        return q[..., 0:h, h:hn]
    if edge == EDGE_N:
        return q[..., hn:hn + h, h:hn]
    if edge == EDGE_W:
        return q[..., h:hn, 0:h]
    return q[..., h:hn, hn:hn + h]


def _write_ghosts(q, strip, write_idx, halo: int, n: int):
    """Write each rank's canonical strip (R, 3, halo, n) into its edge
    ``write_idx`` (R,) of ``q`` in place (the JAX package's
    ``write_strip`` under ``lax.switch``; 4 = no write)."""
    for e in range(4):
        region = _ghost_region(q, e, halo, n)
        placed = place_strip(e, strip)
        region.copy_(torch.where(_rank_view(write_idx == e, placed), placed,
                                 region))


def apply_cov_cube_recv(q, u_send, recv, rows, write_idx):
    """Shared cube-edge receive: rotate, write ghosts, symmetrize.

    The bitwise-critical half of a cube-edge exchange stage, common to
    the face and block tiers, batched over the stacked ranks: ``q`` (R,
    3, M, M) the extended blocks (ghosts written in place), ``u_send``
    (R, 2, halo, n) the velocity strips each rank sent (its own order),
    ``recv`` (R, 3, halo, n) what it received, ``rows`` the ranks' table
    rows for this stage in :data:`CUBE_ROW_NAMES` order, ``write_idx``
    (R,) the ghost edge each rank writes (4 = none).  Returns ``mine``
    (R, n), the symmetrized edge normal of each rank's edge this stage —
    both sides of the physical edge compute it bitwise-equal.
    """
    _, rev, isl, sl, sb, Tm, To, mm, mo = rows
    halo, n = recv.shape[-2], recv.shape[-1]

    gu0 = Tm[:, 0] * recv[:, 1] + Tm[:, 1] * recv[:, 2]
    gu1 = Tm[:, 2] * recv[:, 1] + Tm[:, 3] * recv[:, 2]
    _write_ghosts(q, torch.stack([recv[:, 0], gu0, gu1], dim=1), write_idx,
                  halo, n)

    # --- symmetrized edge normal (bitwise on both sides) ----------------
    int_adj = u_send[:, :, 0, :]             # my adjacent row, my order
    ghost_adj = torch.stack([gu0[:, 0], gu1[:, 0]], dim=1)
    ubar = 0.5 * (int_adj + ghost_adj)
    n_mine = mm[:, 0] * ubar[:, 0] + mm[:, 1] * ubar[:, 1]

    # The other panel's own normal, in ITS canonical order.
    oth_int = _maybe_flip(recv[:, 1:3, 0, :], rev)   # back to its order
    my_adj_f = _maybe_flip(int_adj, rev)              # as it received
    oth_ghost = torch.stack([
        To[:, 0] * my_adj_f[:, 0] + To[:, 1] * my_adj_f[:, 1],
        To[:, 2] * my_adj_f[:, 0] + To[:, 3] * my_adj_f[:, 1],
    ], dim=1)
    obar = 0.5 * (oth_int + oth_ghost)
    n_oth = mo[:, 0] * obar[:, 0] + mo[:, 1] * obar[:, 1]

    link = _rank_view(isl > 0.5, n_mine)
    n_link = torch.where(link, n_mine, n_oth)
    n_back_lo = torch.where(link, _maybe_flip(n_oth, rev),
                            _maybe_flip(n_mine, rev))
    sl, sb = _rank_view(sl, n_mine), _rank_view(sb, n_mine)
    avg = 0.5 * (sl * n_link - sb * n_back_lo)
    return torch.where(link, sl * avg, _maybe_flip(sb * (-avg), rev))


def _sym_strips(sym):
    """(R, 4, n) edge normals -> the RHS's ``sym_sn`` (R, 1, 2, n) and
    ``sym_we`` (R, 1, n, 2), contiguous per rank."""
    sym_sn = torch.stack([sym[:, EDGE_S], sym[:, EDGE_N]], dim=1)[:, None]
    sym_we = torch.stack([sym[:, EDGE_W], sym[:, EDGE_E]], dim=-1)[:, None]
    return sym_sn, sym_we


def _set_sym(sym, edge_idx, mine):
    """``sym`` (R, 4, n) with row ``edge_idx`` (R,) of each rank set to
    its ``mine`` (R, n); 4 sets nothing."""
    sel = torch.arange(4, device=sym.device)[None, :] == edge_idx[:, None]
    return torch.where(sel[:, :, None], mine[:, None], sym)


def ssprk3_sharded_body(f, state, dt):
    """The explicit paths' shared SSPRK3 stage combination."""
    from ..ops.cuda.swe_cov import SSPRK3_COEFFS

    (_, _), (a2, b2), (a3, b3) = SSPRK3_COEFFS
    h0, u0 = state["h"], state["u"]
    dh, du = f(h0, u0)
    h1 = h0 + dt * dh
    u1 = u0 + dt * du
    dh, du = f(h1, u1)
    h2 = a2 * h0 + b2 * (h1 + dt * dh)
    u2 = a2 * u0 + b2 * (u1 + dt * du)
    dh, du = f(h2, u2)
    return {"h": a3 * h0 + b3 * (h2 + dt * dh),
            "u": a3 * u0 + b3 * (u2 + dt * du)}


def rank_groups(setup, local_ranks, xr, xfr, yc, yfc):
    """The group table of a tier's stacked RHS launches (B5, B6): the
    stacked ranks ``local_ranks`` keyed by their block position ``(iy,
    ix)`` on the setup's mesh, with their coordinate rows ``xr``/``xfr``
    (R, 1, m) and columns ``yc``/``yfc`` (R, m, 1), which must be bitwise
    equal within a position (:class:`~..ops.cuda.swe_cov.RankGroups`
    raises ``ValueError`` where not)."""
    from ..ops.cuda.swe_cov import RankGroups

    keys = [tuple(setup.coords(r)[1:]) for r in local_ranks]
    return RankGroups(keys, xr, xfr, yc, yfc)


def _local_rows(tables, local_ranks, device):
    """The tables' rows of this process's ranks, in stack order."""
    idx = torch.tensor(local_ranks, dtype=torch.long)
    return {k: v.index_select(0, idx.to(v.device)).to(device)
            for k, v in tables.items()}


def make_cov_shard_exchange_phases(program: CovShardProgram, ranks,
                                   local_ranks):
    """``(start, finish)`` — the cube-edge exchange split at the wire.

    ``start(q)`` reads the canonical boundary strips of the stacked
    blocks ``q`` (R, 3, M, M) ONCE (the stages write only the ghost
    ring, so every payload is a function of the pre-exchange state) and
    issues all four stage permutations through ``ranks``;
    ``finish(q, recvs) -> (q, sym_sn, sym_we)`` rotates the received
    strips into the ghosts (in place) and runs the seam symmetrization.
    Nothing between them depends on the exchange, so the overlapped
    stepper runs the interior RHS kernel there.  ``local_ranks`` are the
    faces whose blocks ``q`` stacks.
    """
    n, halo = program.n, program.halo
    dev = program.tables["edge_sel"].device
    t = _local_rows(program.tables, local_ranks, dev)
    stages = []
    for s, perm in enumerate(program.perms):
        rows = tuple(t[name][:, s] for name in CUBE_ROW_NAMES)
        stages.append((perm, rows, rows[0].long()))
    rank_idx = torch.arange(len(local_ranks), device=dev)

    def start(q):
        strips = _read_strips(q, halo, n)             # (R, 4, 3, halo, n)
        recvs = []
        for perm, rows, e_s in stages:
            sent = strips[rank_idx, e_s]              # (R, 3, halo, n)
            payload = _maybe_flip(sent, rows[1])
            recvs.append((ranks.ppermute(payload, perm), sent[:, 1:3],
                          rows, e_s))
        return recvs

    def finish(q, recvs):
        sym = q.new_zeros((q.shape[0], 4, n))
        for recv, u_send, rows, e_s in recvs:
            mine = apply_cov_cube_recv(q, u_send, recv, rows, e_s)
            sym = _set_sym(sym, e_s, mine)
        return (q,) + _sym_strips(sym)

    return start, finish


def make_cov_shard_exchange(program: CovShardProgram, ranks, local_ranks):
    """``exchange(q) -> (q, sym_sn, sym_we)``: ``finish(start(q))``, the
    serialized schedule of :func:`make_cov_shard_exchange_phases`."""
    start, finish = make_cov_shard_exchange_phases(program, ranks,
                                                   local_ranks)

    def exchange(q):
        return finish(q, start(q))

    return exchange


def _embed(h_int, u_int, halo: int):
    """Local state (R, 1, n, n) / (R, 2, 1, n, n) -> the stacked extended
    blocks (R, 3, M, M), ghosts zero."""
    r, n = h_int.shape[0], h_int.shape[-1]
    m = n + 2 * halo
    q = h_int.new_zeros((r, 3, m, m))
    q[:, 0:1, halo:halo + n, halo:halo + n] = h_int
    q[:, 1:3, halo:halo + n, halo:halo + n] = u_int[:, :, 0]
    return q


def _embed3(x, halo: int):
    """Interior stacked fields (R, 3, n, n) -> extended blocks (R, 3, M,
    M), ghosts zero."""
    r, c, n = x.shape[0], x.shape[1], x.shape[-1]
    m = n + 2 * halo
    q = x.new_zeros((r, c, m, m))
    q[..., halo:halo + n, halo:halo + n] = x
    return q


def _band_outputs(dh, du):
    """The band's ``(F, n, n)``, ``(2, F, n, n)`` -> the local layout
    (contiguous: the next stage hands each rank's block to a kernel)."""
    return dh[:, None], du.transpose(0, 1)[:, :, None].contiguous()


def _make_cov_face_rhs(model, program: CovShardProgram, setup, overlap):
    """Per-rank RHS closure of the face tier: ``f(h_int, u_int) -> (dh,
    du)`` over the stacked local state — embed, the 4-stage exchange
    (phase-split under ``overlap``), the covariant RHS of every local
    face, and with ``model.nu4 != 0`` the del^4 term: lap, exchange,
    lap of the corner-filled blocks (the JAX tier's ``lap3`` twice)."""
    from ..ops.cuda.swe_cov import (make_cov_rhs_band_local,
                                    make_cov_rhs_interior_local,
                                    make_cov_rhs_pallas, lap_core)
    from ..ops.cuda.swe_rhs import coord_rows

    grid = model.grid
    n, halo = grid.n, grid.halo
    dev = setup.device
    faces = setup.local_ranks
    ranks = setup.ranks
    fz_all = torch.from_numpy(
        np.asarray(FACE_AXES)[:, None, :, 2].astype(np.float32)).to(dev)
    fz_loc = fz_all[faces]                                   # (R, 1, 3)
    b_ext = model.b_ext.to(dev)
    b_loc = b_ext[faces].contiguous()                        # (R, M, M)
    kw = dict(scheme=model.scheme, limiter=model.limiter)
    start, finish = make_cov_shard_exchange_phases(program, ranks, faces)
    xr_f, xfr_f, yc_f, yfc_f, _ = coord_rows(n, halo, dev)
    r = len(faces)
    if not overlap:
        rhs_faces = make_cov_rhs_pallas(grid, model.gravity, model.omega,
                                        n_faces=1, external_sym=True,
                                        device=dev, **kw)
        groups = rank_groups(setup, faces, *(
            t.expand(r, -1, -1) for t in (xr_f, xfr_f, yc_f, yfc_f)))
        b_fr = b_loc[:, None]                                # (R, 1, M, M)
    else:
        rhs_interior = make_cov_rhs_interior_local(
            n, halo, grid.dalpha, grid.radius, model.gravity, model.omega,
            device=dev, **kw)
        rhs_band = make_cov_rhs_band_local(
            n, halo, grid.dalpha, grid.radius, model.gravity, model.omega,
            **kw)
        sl = slice(halo, halo + n)
        groups = rank_groups(setup, faces, *(
            t.expand(r, -1, -1) for t in (xr_f[:, sl], xfr_f[:, sl],
                                          yc_f[sl], yfc_f[sl])))
        b_int = b_loc[:, None, sl, sl].contiguous()
    nu4 = float(getattr(model, "nu4", 0.0))
    lap1 = functools.partial(lap_core, xr_f, xfr_f, yc_f, yfc_f, n=n,
                             halo=halo, d=grid.dalpha, radius=grid.radius)

    def lap3(q):
        # The Laplace-Beltrami cross terms read the ghost corners
        # (face-local averaging, in place: q is this stage's own).
        return lap1(_fill_corners(q, halo, n))

    def with_nu4(dh, du, q):
        """``(dh, du) - nu4 * lap(lap(q))``: the lap of a covariant pair
        is a covariant pair, so the state's exchange refills l1."""
        if nu4 == 0.0:
            return dh, du
        l1 = _embed3(lap3(q), halo)
        l1, _, _ = finish(l1, start(l1))
        l2 = lap3(l1)
        return dh - nu4 * l2[:, 0:1], du - nu4 * l2[:, 1:3, None]

    def f(h_int, u_int):
        q = _embed(h_int, u_int, halo)
        if overlap:
            # Wire first: every stage's payload is a function of the
            # pre-exchange strips; the interior kernel depends on none
            # of them, and the band consumes the received strips.
            recvs = start(q)
            dh_c, du_c = rhs_interior.stacked(fz_loc, groups, h_int, u_int,
                                              b_int)
            q, ssn, swe = finish(q, recvs)
            dh, du = rhs_band(
                fz_loc, xr_f, xfr_f, yc_f, yfc_f, q[:, 0],
                q[:, 1:3].transpose(0, 1), b_loc, ssn[:, 0], swe[:, 0],
                dh_c[:, 0], du_c[:, :, 0].transpose(0, 1))
            return with_nu4(*_band_outputs(dh, du), q)
        q, ssn, swe = finish(q, start(q))
        dh, du = rhs_faces.stacked(fz_loc, groups, q[:, 0:1],
                                   q[:, 1:3].unsqueeze(2), b_fr, ssn, swe)
        return with_nu4(dh, du, q)

    return f


def make_sharded_cov_stepper(model, setup, dt: float, overlap=None,
                             temporal_block: int = 1):
    """``step(state, t) -> state`` for the covariant model on the face
    tier.

    Requires a ``(panel=6, 1, 1)`` mesh (one face per rank); ``state``
    is :func:`~.mesh.shard_state`'s stacked local state.  Each SSPRK3
    stage: one explicit 4-stage exchange, one launch of the RHS kernel
    over the local faces (its plain version on CPU tensors), the combine.
    ``overlap`` (default: the setup's ``overlap_exchange``): issue the
    four stages first, run the interior kernel on every face's
    ghost-free ``(n-2h)^2`` core in one launch, then finish the exchange
    and the torch band — the same arithmetic, tiled.  ``model.nu4 != 0``
    adds the del^4 term to every stage (exchange, lap, exchange, lap).
    ``temporal_block > 1`` (the JAX package's deep-halo stepper) is not
    ported.
    """
    if temporal_block > 1:
        not_ported(f"temporal_block={temporal_block} on the face tier (the "
                   "deep-halo stepper)")
    if setup.ranks is None or setup.panel != 6 or setup.sy * setup.sx != 1:
        raise ValueError(
            f"explicit covariant shard path needs a (panel=6, 1, 1) mesh; "
            f"got panel={setup.panel}, y={setup.sy}, x={setup.sx}. Use the "
            f"GSPMD path (use_shard_map: false) for other layouts."
        )
    if model.grid.device != setup.device:
        raise ValueError(f"the model's grid is on {model.grid.device}, the "
                         f"ranks on {setup.device}")
    if overlap is None:
        overlap = setup.overlap_exchange
    program = CovShardProgram(model.grid)
    f_loc = _make_cov_face_rhs(model, program, setup, overlap)

    def step(state, t):
        del t
        return ssprk3_sharded_body(f_loc, state, dt)

    return step
