"""Port parity: the sharded covariant tiers' schedule, tables and local
right-hand sides, and the face tier, against the JAX package.

The same inputs (TC5 built by the JAX package, handed across as numpy)
go through the JAX functions and their counterparts in the port, whose
kernel wrappers run their plain versions on CPU tensors.  Budgets:

* the stage schedule, its pairs and fingerprint, and every table of
  ``CovShardProgram`` (C16) and ``CovBlockProgram(grid, 2)`` (C16):
  equal, bit for bit;
* the interior pass (B5), the band and the block RHS (B6) against the
  JAX kernels in interpret mode and its jnp band, on one face at C16 and
  (B6) on every block of the 2 x 2 split: 1e-4 of the face's tendency
  max, and each no farther from a float64 evaluation than 1e-4.  The
  tendency is ill-conditioned in float32 (its flux differences cancel):
  the JAX package's own interior kernel and the core of its block kernel
  differ by up to 5.5e-5 of the core's max on this state, and the
  port's plain versions and the JAX kernels sit 1e-6-4e-5 of the face's
  max from float64 alike, so no two float32 evaluations agree to 1e-6;
* the interior pass + band against the port's own one-face form of the
  RHS kernel (B4, ``n_faces=1, external_sym=True``): bitwise, on all six
  faces (the same operands in the same op order, tiled);
* the stacked forms of B5 and B6 (one launch over a tier's ranks, their
  plain versions here): bitwise equal to the per-block plain forms on
  every rank of the 2 x 2 split and of the face tier, and against the
  JAX per-block kernels in interpret mode to the budget above; the group
  table of the tiers' stacked launches, and its refusal of a group whose
  ranks' coordinate rows differ;
* the face tier's serialized RHS, one stacked call of B4 over its six
  faces (``CovRhs.stacked``, its plain version here): bitwise equal to
  one one-face plain call per rank on the tier's own exchanged operands;
* the face tier on six virtual ranks (``device="cpu"``) against the JAX
  package's ``make_sharded_cov_stepper`` on six virtual CPU devices, 3
  steps at C8, serialized and overlapped: 1e-6 of each field's max
  (``tests/test_overlap_exchange.py:157``'s budget); mass drift < 2e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry import connectivity as jconn
from jaxstream.geometry.cubed_sphere import FACE_AXES
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.fv import embed_interior as jax_embed
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.ops.pallas.swe_rhs import coord_rows as jax_coord_rows
from jaxstream.parallel import mesh as jmesh
from jaxstream.parallel.shard_cov import (CovShardProgram as JaxShardProgram,
                                          make_sharded_cov_stepper as jstepper)
from jaxstream.parallel.shard_cov_block import (
    CovBlockProgram as JaxBlockProgram)
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.geometry import connectivity as tconn
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.parallel.mesh import (setup_sharding, shard_state,
                                           unshard_state)
from jaxstream_torch.parallel.shard_cov import CovShardProgram, rank_groups
from jaxstream_torch.parallel.shard_cov_block import CovBlockProgram
from jaxstream_torch.parallel.sharded_model import make_stepper_for
from jaxstream_torch.physics.initial_conditions import williamson_tc5

G, OM = EARTH_GRAVITY, EARTH_OMEGA
TENDENCY_TOL = 1e-4
TIER_TOL = 1e-6
MASS_TOL = 2e-6


def _rel(a, b, scale=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    s = a if scale is None else np.asarray(scale, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(s)) + 1e-300))


def _T(a):
    return to_torch(a, device="cpu")


def test_schedule_matches_jax():
    jst, tst = jconn.build_schedule(), tconn.build_schedule()
    key = lambda lk: (lk.face, lk.edge, lk.nbr_face, lk.nbr_edge,
                      lk.reversed_)
    assert [[(key(a), key(b)) for a, b in s] for s in tst] == \
        [[(key(a), key(b)) for a, b in s] for s in jst]
    assert tconn.schedule_perms() == jconn.schedule_perms()
    assert tconn.schedule_fingerprint() == jconn.schedule_fingerprint()
    assert tconn.schedule_fingerprint([[(1, 0)]]) == \
        jconn.schedule_fingerprint([[(1, 0)]])


@pytest.fixture(scope="module")
def grids_c16():
    jg = jax_build_grid(16, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(16, halo=2, radius=EARTH_RADIUS, device="cpu")
    return jg, tg


def _equal_tables(jt, tt):
    assert sorted(jt) == sorted(tt)
    for k in jt:
        a, b = np.asarray(jt[k]), to_numpy(tt[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_shard_program_tables_match_jax(grids_c16):
    jg, tg = grids_c16
    jp, tp = JaxShardProgram(jg), CovShardProgram(tg)
    assert tp.perms == jp.perms
    _equal_tables(jp.tables, tp.tables)


def test_block_program_tables_match_jax(grids_c16):
    jg, tg = grids_c16
    s = 2
    jp, tp = JaxBlockProgram(jg, s), CovBlockProgram(tg, s)
    assert tp.cube_perms == jp.cube_perms
    # The JAX package's neighbour shifts name a mesh axis; the port's
    # carry the same shifts as pairs over all ranks.
    lin = lambda f, iy, ix: (f * s + iy) * s + ix
    want = []
    for axis, perm, e_send, e_recv in jp.intra_perms:
        pairs = [(lin(f, k, a), lin(f, k, b)) if axis == "x" else
                 (lin(f, a, k), lin(f, b, k))
                 for f in range(6) for k in range(s) for a, b in perm]
        want.append((sorted(pairs), e_send, e_recv))
    assert [(sorted(p), a, b) for p, a, b in tp.intra_perms] == want
    _equal_tables(jp.tables, tp.tables)


@pytest.fixture(scope="module")
def tc5_c16_after_a_step():
    """The C16 TC5 state after one JAX classic step (TC5's initial wind
    has a zero component in places), its filled frames and sym rows, as
    JAX arrays."""
    jg = jax_build_grid(16, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    he, ve, be = jax_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=be)
    st = jax.jit(jm.make_step(600.0))(jm.initial_state(he, ve), 0.0)
    h_e = jm.exchange(jax_embed(jg, st["h"]))
    u_e = jm.exchange_u(jax_embed(jg, st["u"]))
    ssn, swe = jsc.sym_edge_normals(jg, u_e)
    return jg, jm, st, h_e, u_e, ssn, swe


def _kernels(jg, n):
    """The JAX and port local RHS forms of an n-wide block."""
    consts = (n, jg.halo, float(jg.dalpha), float(jg.radius), G, OM)
    return (jsc.make_cov_rhs_interior_local(*consts, interpret=True),
            jsc.make_cov_rhs_pallas_local(*consts, interpret=True),
            jsc.make_cov_rhs_band_local(*consts),
            tsc.make_cov_rhs_interior_local(*consts, device="cpu"),
            tsc.make_cov_rhs_pallas_local(*consts, device="cpu"),
            tsc.make_cov_rhs_band_local(*consts))


def _face_args(jg, jm, h_e, u_e, ssn, swe, f):
    n, h = jg.n, jg.halo
    xr, xfr, yc, yfc, _ = jax_coord_rows(n, h)
    fz = jnp.asarray(np.asarray(FACE_AXES)[f:f + 1, None, :, 2],
                     jnp.float32)
    I = slice(h, h + n)
    a_int = (fz, xr[:, I], xfr[:, I], yc[I], yfc[I], h_e[f:f + 1, I, I],
             u_e[:, f:f + 1, I, I], jm.b_ext[f:f + 1, I, I])
    a_ext = (fz, xr, xfr, yc, yfc, h_e[f:f + 1], u_e[:, f:f + 1],
             jm.b_ext[f:f + 1], ssn[f:f + 1], swe[f:f + 1])
    return a_int, a_ext


@pytest.mark.parametrize("face", [0, 4])
def test_local_rhs_forms_match_jax(tc5_c16_after_a_step, face):
    jg, jm, st, h_e, u_e, ssn, swe = tc5_c16_after_a_step
    ji, jl, jb, ti, tl, tb = _kernels(jg, jg.n)
    a_int, a_ext = _face_args(jg, jm, h_e, u_e, ssn, swe, face)
    t_int = [_T(a) for a in a_int]
    t_ext = [_T(a) for a in a_ext]
    core_j, core_t = ji(*a_int), ti(*t_int)
    full_j, full_t = jl(*a_ext), tl(*t_ext)
    band_j, band_t = jb(*a_ext, *core_j), tb(*t_ext, *core_t)
    f64 = tl.reference(*[t.double() for t in t_ext])
    core64 = ti.reference(*[t.double() for t in t_int])
    for k in range(2):
        scale = to_numpy(f64[k])
        assert _rel(core_j[k], to_numpy(core_t[k]), scale) <= TENDENCY_TOL
        assert _rel(core64[k], to_numpy(core_t[k]), scale) <= TENDENCY_TOL
        for j, t in ((full_j, full_t), (band_j, band_t)):
            assert _rel(j[k], to_numpy(t[k]), scale) <= TENDENCY_TOL
            assert _rel(f64[k], to_numpy(t[k])) <= TENDENCY_TOL


def test_block_rhs_matches_jax_on_a_2x2_split(tc5_c16_after_a_step):
    """B6 on every block of the (6, 2, 2) split, with the block's own
    coordinate rows and columns from the JAX package's block program and
    seeded sym strips."""
    jg, jm, st, h_e, u_e, ssn, swe = tc5_c16_after_a_step
    s, h = 2, jg.halo
    nl = jg.n // s
    _, jl, _, _, tl, _ = _kernels(jg, nl)
    tab = JaxBlockProgram(jg, s).tables
    rng = np.random.default_rng(3)
    for f in range(6):
        for iy in range(s):
            for ix in range(s):
                ry = slice(iy * nl, iy * nl + nl + 2 * h)
                rx = slice(ix * nl, ix * nl + nl + 2 * h)
                args = (tab["fz"][f, iy, ix].reshape(1, 1, 3),
                        tab["xr"][f, iy, ix], tab["xfr"][f, iy, ix],
                        tab["yc"][f, iy, ix], tab["yfc"][f, iy, ix],
                        h_e[f:f + 1, ry, rx], u_e[:, f:f + 1, ry, rx],
                        jm.b_ext[f:f + 1, ry, rx],
                        rng.standard_normal((1, 2, nl)).astype(np.float32),
                        rng.standard_normal((1, nl, 2)).astype(np.float32))
                out_j, out_t = jl(*args), tl(*[_T(a) for a in args])
                f64 = tl.reference(*[_T(a).double() for a in args])
                for k in range(2):
                    assert _rel(f64[k], out_j[k]) <= TENDENCY_TOL
                    assert _rel(f64[k], to_numpy(out_t[k])) <= TENDENCY_TOL
                    assert _rel(out_j[k], to_numpy(out_t[k]),
                                f64[k]) <= TENDENCY_TOL


def test_interior_plus_band_equals_one_face_form():
    """The port's split tiles its own one-face RHS bitwise on every face
    (the twin of tests/test_overlap_exchange.py:55)."""
    n, h = 16, 2
    g = build_grid(n, halo=h, radius=EARTH_RADIUS, device="cpu")
    he, ve, be = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=be)
    st = m.make_step(600.0)(m.initial_state(he, ve), 0.0)
    h_e, u_e = m.fill(st["h"]), m._fill_u(st["u"])
    ssn, swe = tsc.sym_edge_normals(g, u_e)
    one = tsc.make_cov_rhs_pallas(g, G, OM, n_faces=1, external_sym=True)
    consts = (n, h, g.dalpha, g.radius, G, OM)
    core = tsc.make_cov_rhs_interior_local(*consts, device="cpu")
    band = tsc.make_cov_rhs_band_local(*consts)
    xr, xfr, yc, yfc = one.coords
    I = slice(h, h + n)
    xi, xfi = xr[:, I].contiguous(), xfr[:, I].contiguous()
    for f in range(6):
        fz = one.fz[f:f + 1, None]
        args = (h_e[f:f + 1], u_e[:, f:f + 1].contiguous(),
                m.b_ext[f:f + 1], ssn[f:f + 1], swe[f:f + 1])
        dh0, du0 = one(fz, *args)
        c = core(fz, xi, xfi, yc[I], yfc[I], st["h"][f:f + 1],
                 st["u"][:, f:f + 1].contiguous(),
                 m.b_ext[f:f + 1, I, I].contiguous())
        dh1, du1 = band(fz, xr, xfr, yc, yfc, *args, *c)
        assert torch.equal(dh0, dh1) and torch.equal(du0, du1), f


# ---- the stacked forms of B5 and B6 ----------------------------------------


def _tier_blocks(jg, jm, h_e, u_e, ssn, swe, s):
    """Every rank's per-block B5 and B6 operands (JAX arrays) of the
    (6, s, s) split in the tiers' rank order, the rows and frames from
    the JAX package's block program (s = 1: the whole faces, the face's
    own sym rows); B6's sym strips seeded inside a face."""
    h = jg.halo
    nl = jg.n // s
    if s == 1:
        xr, xfr, yc, yfc, _ = jax_coord_rows(jg.n, h)
        tab = {"xr": xr[None, None, None], "xfr": xfr[None, None, None],
               "yc": yc[None, None, None], "yfc": yfc[None, None, None]}
        tab = {k: jnp.broadcast_to(v, (6, 1, 1) + v.shape[3:])
               for k, v in tab.items()}
        tab["fz"] = jnp.asarray(np.asarray(FACE_AXES)[:, None, None, None,
                                                      :, 2], jnp.float32)
    else:
        tab = JaxBlockProgram(jg, s).tables
    rng = np.random.default_rng(11)
    I = slice(h, h + nl)
    b5, b6 = [], []
    for f in range(6):
        for iy in range(s):
            for ix in range(s):
                ry = slice(iy * nl, iy * nl + nl + 2 * h)
                rx = slice(ix * nl, ix * nl + nl + 2 * h)
                rows = [tab[k][f, iy, ix] for k in ("xr", "xfr", "yc", "yfc")]
                fz = tab["fz"][f, iy, ix].reshape(1, 1, 3)
                he, ue = h_e[f:f + 1, ry, rx], u_e[:, f:f + 1, ry, rx]
                be = jm.b_ext[f:f + 1, ry, rx]
                b5.append((fz, rows[0][:, I], rows[1][:, I], rows[2][I],
                           rows[3][I], he[:, I, I], ue[:, :, I, I],
                           be[:, I, I]))
                sym = ((ssn[f:f + 1], swe[f:f + 1]) if s == 1 else tuple(
                    rng.standard_normal(sh).astype(np.float32)
                    for sh in ((1, 2, nl), (1, nl, 2))))
                b6.append((fz, *rows, he, ue, be) + sym)
    return b5, b6


def _stack(setup, per, interior):
    """The stacked operands of per-block torch operands ``per``: (fz,
    groups, fields...) as the tiers pass them."""
    col = lambda k: [a[k] for a in per]
    rows = [torch.stack(col(k)) for k in (1, 2, 3, 4)]
    groups = rank_groups(setup, list(range(len(per))), *rows)
    out = (torch.cat(col(0)), groups, torch.stack(col(5)),
           torch.stack(col(6)), torch.stack(col(7)))
    if not interior:
        out += (torch.stack(col(8)), torch.stack(col(9)))
    return out


@pytest.fixture(scope="module")
def stacked_cases(tc5_c16_after_a_step):
    """For the face tier (s = 1) and the 2 x 2 split (s = 2): the port's
    B5 and B6, their stacked operands and per-block operands (torch), and
    the JAX per-block kernels' outputs in interpret mode."""
    jg, jm, st, h_e, u_e, ssn, swe = tc5_c16_after_a_step
    cases = {}
    for s in (1, 2):
        ji, jl, _, ti, tl, _ = _kernels(jg, jg.n // s)
        setup = setup_sharding({"parallelization": {
            "tiles_per_edge": s, "num_devices": 6 * s * s,
            "use_shard_map": True}}, device="cpu")
        b5, b6 = _tier_blocks(jg, jm, h_e, u_e, ssn, swe, s)
        for name, kern, jkern, per in (("B5", ti, ji, b5),
                                       ("B6", tl, jl, b6)):
            tper = [[_T(a) for a in args] for args in per]
            cases[(name, s)] = (kern, _stack(setup, tper, name == "B5"),
                                tper, [jkern(*args) for args in per])
    return cases


@pytest.mark.parametrize("name", ["B5", "B6"])
@pytest.mark.parametrize("s", [1, 2], ids=["face-tier", "2x2-split"])
def test_stacked_plain_forms_equal_per_rank(stacked_cases, name, s):
    kern, args, per, _ = stacked_cases[(name, s)]
    dh, du = kern.stacked(*args)
    assert dh.shape[0] == du.shape[0] == 6 * s * s
    for r, a in enumerate(per):
        want = kern.reference(*a)
        assert torch.equal(dh[r], want[0]), r
        assert torch.equal(du[r], want[1]), r


@pytest.mark.parametrize("name", ["B5", "B6"])
@pytest.mark.parametrize("s", [1, 2], ids=["face-tier", "2x2-split"])
def test_stacked_plain_forms_match_jax(stacked_cases, name, s):
    """The stacked plain form against the JAX per-block kernel on every
    rank (interpret mode) and against its own float64 evaluation, in
    units of the tendency's float64 max as the per-block tests above take
    it: B6's own block's; for B5's core, the whole face's (the core's own
    max is small where the flow is near balance)."""
    kern, args, per, jax_out = stacked_cases[(name, s)]
    face_kern, _, face_args, _ = stacked_cases[("B6", 1)]
    dh, du = kern.stacked(*args)
    for r, (a, out_j) in enumerate(zip(per, jax_out)):
        f64 = kern.reference(*[t.double() for t in a])
        scale = f64 if name == "B6" else face_kern.reference(
            *[t.double() for t in face_args[r // (s * s)]])
        for k, x in enumerate((dh[r], du[r])):
            assert _rel(out_j[k], to_numpy(x), scale[k]) <= TENDENCY_TOL, \
                (r, k)
            assert _rel(f64[k], to_numpy(x), scale[k]) <= TENDENCY_TOL, \
                (r, k)


def _rows(r, m, s=2, n=None):
    """Seeded per-rank rows (R, 1, m) / (R, m, 1), equal at equal block
    positions of the (6, s, s) mesh."""
    rng = np.random.default_rng(5)
    per_pos = {p: rng.standard_normal((4, m)).astype(np.float32)
               for p in range(s * s)}
    rows = np.stack([per_pos[i % (s * s)] for i in range(r)])
    return (torch.from_numpy(rows[:, 0, None, :]),
            torch.from_numpy(rows[:, 1, None, :]),
            torch.from_numpy(rows[:, 2, :, None]),
            torch.from_numpy(rows[:, 3, :, None]))


@pytest.mark.parametrize("devices, local, want", [
    (24, list(range(24)), [[0, 4, 8], [12, 16, 20], [1, 5, 9],
                           [13, 17, 21], [2, 6, 10], [14, 18, 22],
                           [3, 7, 11], [15, 19, 23]]),
    (24, [5, 1, 9, 2], [[5, 1, 9], [2]]),
    (6, list(range(6)), [[0, 1, 2], [3, 4, 5]]),
    (24, [7], [[7]])],
    ids=["block-tier", "block-subset", "face-tier", "one-rank"])
def test_rank_groups_of_the_tiers(devices, local, want):
    """Which stacked ranks share a group: those at one block position, in
    stack order, at most three; the table lists them (stack indices) and
    pads with -1, and each group's rows are its ranks'."""
    s = 2 if devices == 24 else 1
    setup = setup_sharding({"parallelization": {
        "tiles_per_edge": s, "num_devices": devices,
        "use_shard_map": True}}, device="cpu")
    full = _rows(devices, 10, s)
    rows = [t[local] for t in full]
    groups = rank_groups(setup, local, *rows)
    idx = {r: i for i, r in enumerate(local)}
    want_idx = [[idx[r] for r in grp] for grp in want]
    assert groups.ranks == want_idx
    assert groups.count == len(want)
    assert groups.table.dtype == torch.int32
    assert groups.table.tolist() == [g + [-1] * (3 - len(g))
                                     for g in want_idx]
    for gi, grp in enumerate(want_idx):
        for k, t in enumerate(rows):
            assert torch.equal(
                (groups.xr, groups.xfr, groups.yc, groups.yfc)[k][gi],
                t[grp[0]])
    for a, b in zip(groups.rank_rows(), rows):
        assert torch.equal(a, b)


@pytest.mark.parametrize("row", [0, 1, 2, 3],
                         ids=["xr", "xfr", "yc", "yfc"])
def test_rank_groups_refuse_unequal_rows(row):
    """A group whose ranks' rows differ (here by one ulp) is refused."""
    setup = setup_sharding({"parallelization": {
        "tiles_per_edge": 2, "num_devices": 24, "use_shard_map": True}},
        device="cpu")
    rows = [t.clone() for t in _rows(24, 10)]
    flat = rows[row].view(-1)
    k = 8 * 10 + 3                       # rank 8, position (0, 0)'s group
    flat[k] = torch.nextafter(flat[k], torch.tensor(np.inf))
    with pytest.raises(ValueError, match="share block position"):
        rank_groups(setup, list(range(24)), *rows)
    rank_groups(setup, list(range(24)), *_rows(24, 10))


def test_face_tier_serialized_rhs_equals_per_rank_calls():
    """The face tier's serialized RHS, one stacked B4 call over its six
    faces (on CPU tensors its plain version, ``CovRhs.stacked_reference``),
    bitwise equal to one one-face plain call per rank on the tier's own
    exchanged operands (the per-rank form it replaced), at C16 after a
    classic step."""
    from jaxstream_torch.geometry.cubed_sphere import FACE_AXES as T_AXES
    from jaxstream_torch.parallel import shard_cov

    n, h = 16, 2
    g = build_grid(n, halo=h, radius=EARTH_RADIUS, device="cpu")
    he, ve, be = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=be)
    st = m.make_step(600.0)(m.initial_state(he, ve), 0.0)
    setup = setup_sharding({"parallelization": {
        "num_devices": 6, "use_shard_map": True}}, device="cpu")
    program = CovShardProgram(g)
    local = shard_state(setup, st)
    before = tsc.CovRhs.launches
    dh, du = shard_cov._make_cov_face_rhs(m, program, setup, False)(
        local["h"], local["u"])
    assert tsc.CovRhs.launches == before          # the plain version ran
    q = shard_cov._embed(local["h"], local["u"], h)
    q, ssn, swe = shard_cov.make_cov_shard_exchange(
        program, setup.ranks, setup.local_ranks)(q)
    one = tsc.make_cov_rhs_pallas(g, G, OM, n_faces=1, external_sym=True)
    fz = torch.from_numpy(np.asarray(T_AXES)[:, None, :, 2].astype(
        np.float32))
    assert dh.shape == (6, 1, n, n) and du.shape == (6, 2, 1, n, n)
    for r, face in enumerate(setup.local_ranks):
        want = one.reference(fz[face:face + 1], q[r, 0:1],
                             q[r, 1:3].unsqueeze(1), m.b_ext[face:face + 1],
                             ssn[r], swe[r])
        assert torch.equal(dh[r], want[0]) and torch.equal(du[r], want[1]), r


@pytest.fixture(scope="module")
def tc5_c8():
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    he, ve, be = jax_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=be)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=_T(be))
    return jg, jm, jm.initial_state(he, ve), tg, tm


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serialized", "overlapped"])
def test_face_tier_matches_jax(tc5_c8, overlap):
    if len(jax.devices("cpu")) < 6:
        pytest.skip("needs 6 virtual CPU devices")
    jg, jm, s0, tg, tm = tc5_c8
    dt, nsteps = 600.0, 3
    jset = jmesh.setup_sharding({"parallelization": {
        "num_devices": 6, "device_type": "cpu", "use_shard_map": True}})
    jstep = jstepper(jm, jset, dt, overlap=overlap)
    jy = jmesh.shard_state(jset, s0)
    tset = setup_sharding({"parallelization": {
        "num_devices": 6, "use_shard_map": True,
        "overlap_exchange": overlap}}, device="cpu")
    tstep = make_stepper_for(tm, tset, None, dt)
    ty = shard_state(tset, {k: np.asarray(v) for k, v in s0.items()})
    for _ in range(nsteps):
        jy = jstep(jy, 0.0)
        ty = tstep(ty, 0.0)
    out = unshard_state(tset, ty)
    for k in ("h", "u"):
        assert _rel(jy[k], to_numpy(out[k])) <= TIER_TOL, k
    area = to_numpy(tg.interior(tg.area)).astype(np.float64)
    m0 = float(np.sum(area * np.asarray(s0["h"], np.float64)))
    m1 = float(np.sum(area * to_numpy(out["h"]).astype(np.float64)))
    assert abs(m1 - m0) / m0 < MASS_TOL
