"""Port parity: the step-budget bisection's ablated kernel B (B14) and its
harness.

The JAX harness's ``variant_b`` is a closure inside
``experiments/nu4_bisect.py::main``, so each mode's plain version is held
to the JAX package's own pieces on the same inputs (the Galewsky jet at
C8, kernel A's outputs on the initial carry and their routed ghosts):

* ``full``: kernel B of ``make_cov_stage_nu4(..., interpret=True)``, whose
  body the harness's ``full`` is;
* ``nolap``: ``adv - f32(dt nu4) l1`` in jnp;
* ``nofill``: the JAX ``lap_core`` of l1 padded with zeros (the port
  defines the ablated ghosts as 0; the JAX kernel leaves them as whatever
  its scratch held);

the strips in every mode the JAX ``pack_strips_cov_split`` of the
outputs.  Budgets: 1e-6 of each output's max at the harness's constants
(dt = 60 s, nu4 = 1e14; f32 roundoff), and PROBE_TOL with nu4 scaled
until the filter term is 1e3 x the state (its outputs are then the
filter term, whose float32 evaluation cancels).  Then ``run`` on the CPU
returns every chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.ops.pallas.swe_rhs import coord_rows as jax_coord_rows

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.experiments import nu4_bisect as nb
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics.initial_conditions import galewsky

N = 8
G, OM = EARTH_GRAVITY, EARTH_OMEGA
TOL = 1e-6
PROBE_TOL = 1e-4
PROBE_MARGIN = 1e3
KEYS = ("h", "u", "strips_sn", "strips_we")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _J(t):
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def c8():
    """The port's C8 Galewsky grid, the stage (a = 0, b = 1) of the
    harness and B's inputs: kernel A's outputs on the initial carry and
    the routed ghosts of its l1 strips; the JAX grid."""
    tg = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, nu4=nb.NU4)
    y0 = tm.compact_state(tm.initial_state(*galewsky(tg, G, OM)))
    route = tsc.make_cov_strip_router_split(tg)
    sa, _ = tsc.make_cov_stage_nu4(tg, G, OM, nb.DT, 0.0, 1.0, nb.NU4,
                                   device="cpu")
    bz = torch.zeros((6, tg.m, tg.m))
    ha, ua, l1h, l1u, sn, we = sa(y0["h"], y0["u"],
                                  *route(y0["strips_sn"], y0["strips_we"]),
                                  bz)
    jg = jax_build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    return tg, sa.__self__, (ha, ua, l1h, l1u) + route(sn, we), jg


def _jax_mode(jg, mode, nu4, args):
    """The JAX package's pieces for ``mode`` on ``args`` (numpy in,
    numpy out)."""
    ha, ua, l1h, l1u, gsn, gwe = [_J(a) for a in args]
    n, h = jg.n, jg.halo
    if mode == "full":
        _, jb = jsc.make_cov_stage_nu4(jg, G, OM, nb.DT, 0.0, 1.0, nu4,
                                       interpret=True)
        return [np.asarray(x) for x in jb(ha, ua, l1h, l1u, gsn, gwe)]
    damp = jnp.float32(1.0 * nb.DT * nu4)
    if mode == "nolap":
        l2 = (l1h, l1u[0], l1u[1])
    else:
        xr, xfr, yc, yfc, _ = jax_coord_rows(n, h)
        pad = lambda q: jnp.pad(q, ((0, 0), (h, h), (h, h)))
        lap = jax.vmap(lambda psi: jsc.lap_core(
            xr, xfr, yc, yfc, psi, n=n, halo=h, d=float(jg.dalpha),
            radius=float(jg.radius)))
        l2 = tuple(lap(pad(q)) for q in (l1h, l1u[0], l1u[1]))
    ho = ha - damp * l2[0]
    uo = jnp.stack([ua[0] - damp * l2[1], ua[1] - damp * l2[2]])
    sn, we = jsc.pack_strips_cov_split(ho, uo, n, h)
    return [np.asarray(x) for x in (ho, uo, sn, we)]


def _probe_nu4(stage, mode, args):
    """nu4 scaled until the filter term is PROBE_MARGIN x the state for
    the field where it is weakest, from a float64 evaluation."""
    exact = nb.nu4_bisect_b_reference(stage, mode,
                                      *[a.double() for a in args])
    q = (args[0], args[1][0], args[1][1])
    out = (exact[0], exact[1][0], exact[1][1])
    incr = min(float((a.double() - b).abs().max() / a.double().abs().max())
               for a, b in zip(q, out))
    return stage.nu4 * PROBE_MARGIN / incr


@pytest.mark.parametrize("mode", nb.MODES)
def test_plain_modes_match_jax_pieces(c8, mode):
    tg, stage, args, jg = c8
    b = nb.Nu4BisectB(stage, mode)
    before = nb.Nu4BisectB.launches
    out = b(*args)
    assert nb.Nu4BisectB.launches == before             # plain: no launch
    for name, x, y in zip(KEYS, _jax_mode(jg, mode, stage.nu4, args), out):
        assert x.shape == tuple(y.shape), name
        assert _rel(x, y.numpy()) <= TOL, (mode, name, _rel(x, y.numpy()))
    if mode == "full":
        ref = stage.reference_b(*args)
        assert all(torch.equal(x, r) for x, r in zip(out, ref))


@pytest.mark.parametrize("mode", ["full", "nofill"])
def test_plain_mode_probes_match_jax_pieces(c8, mode):
    """The Laplacian modes with the filter term dominating the output."""
    tg, stage, args, jg = c8
    nu4_p = _probe_nu4(stage, mode, args)
    probe = tsc.CovStageNu4(tg.n, tg.halo, tg.dalpha, tg.radius, G, OM,
                            nb.DT, 0.0, 1.0, nu4_p, device="cpu")
    out = nb.Nu4BisectB(probe, mode)(*args)
    assert float(out[0].abs().max()) > 100.0 * float(args[0].abs().max())
    exact = nb.nu4_bisect_b_reference(probe, mode,
                                      *[a.double() for a in args])
    for name, x, y, r in zip(KEYS, _jax_mode(jg, mode, nu4_p, args), out,
                             exact):
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()))
        assert max(errs) <= PROBE_TOL, (mode, name, errs)


def test_modes_differ_where_ablated(c8):
    """Each ablation changes the output (with the filter term dominant):
    nofill on the face's rim (where the stencil reads ghosts) only,
    nolap everywhere."""
    tg, stage, args, jg = c8
    probe = tsc.CovStageNu4(tg.n, tg.halo, tg.dalpha, tg.radius, G, OM,
                            nb.DT, 0.0, 1.0, _probe_nu4(stage, "full", args),
                            device="cpu")
    full, nofill, nolap = (nb.Nu4BisectB(probe, m)(*args)[0]
                           for m in nb.MODES)
    rim = torch.ones(N, N, dtype=torch.bool)
    rim[1:-1, 1:-1] = False
    assert torch.equal(full[:, 1:-1, 1:-1], nofill[:, 1:-1, 1:-1])
    assert not torch.equal(full[:, rim], nofill[:, rim])
    assert not torch.equal(full, nolap)


def test_mode_refused():
    with pytest.raises(ValueError, match="mode"):
        nb.Nu4BisectB(None, "nolaplacian")


def test_run_returns_every_chain_on_cpu():
    res = nb.run(n=N, iters=8, device="cpu")
    assert res["n"] == N and res["iters"] == 8 and res["device"] == "cpu"
    assert list(res["chains"]) == [
        "step", "stage A+r+B+r", "A + route", "B", "route", "B[full]",
        "B[nofill]", "B[nolap]"]
    for name, c in res["chains"].items():
        assert np.isfinite(c["wall_us"]), name
        assert c["device_us"] is None                 # no GPU: not measured
        assert c["launches"] == {"A": 0, "B": 0, "B14": 0}, name
