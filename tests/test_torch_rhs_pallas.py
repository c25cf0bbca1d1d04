"""Port parity: the unfused covariant RHS of the classic path
(``backend='pallas'``).

The same extended states (TC5 and TC2 at C8, built by the JAX package
and handed across as numpy) go through the JAX package's
``make_cov_rhs_pallas(interpret=True)``, as its own tests run it, and the
port's plain version ``cov_rhs_reference`` (the CUDA kernel's CPU form).
Budgets:

* ``sym_edge_normals``: bitwise, or 2 float32 ulp of the rows' scale
  (XLA on the CPU may contract ``a*b + c*d`` into a fused multiply-add);
  its vectorized twin ``make_sym_edge_normals``: bitwise;
* the RHS, six-face and one-face forms: 1e-4 of each tendency's max,
  against the JAX kernel and against a float64 evaluation of the plain
  version.  The tendency is ill-conditioned in float32 (its flux
  differences cancel): two f32 evaluations differ by ~1e-5 of its max;
* the port's kernel-backed classic ``rhs`` against its torch one: 5e-5
  of max, the JAX package's budget (``tests/test_cov_swe.py:172``), also
  with nu4 > 0 on the Galewsky jet.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.physics import initial_conditions as jic

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics import initial_conditions as tic

G, OM = EARTH_GRAVITY, EARTH_OMEGA
EPS32 = float(np.finfo(np.float32).eps)
TENDENCY_TOL = 1e-4
CLASSIC_TOL = 5e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _T(a):
    return to_torch(a, device="cpu")


@pytest.fixture(scope="module", params=["tc5", "tc2"])
def c8(request):
    """One IC at C8: both grids, the JAX model's filled extended state
    ``(h_ext, u_ext, b_ext)`` as JAX arrays and as tensors."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    if request.param == "tc5":
        h, v, b = jic.williamson_tc5(jg, G, OM)
    else:
        (h, v), b = jic.williamson_tc2(jg, G, OM), None
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=b)
    s = jm.initial_state(h, v)
    jargs = (jm.fill(s["h"]), jm._fill_u(s["u"]), jm.b_ext)
    return jg, tg, jargs, tuple(_T(a) for a in jargs)


def test_sym_edge_normals_match_jax(c8):
    jg, tg, jargs, targs = c8
    jsn, jwe = jsc.sym_edge_normals(jg, jargs[1])
    tsn, twe = tsc.sym_edge_normals(tg, targs[1])
    for x, y in ((jsn, tsn), (jwe, twe)):
        x = np.asarray(x)
        assert x.shape == tuple(y.shape)
        err = float(np.max(np.abs(x - y.numpy())))
        assert err <= 2 * EPS32 * float(np.max(np.abs(x))), err


@pytest.mark.parametrize("n", [8, 12])
def test_vectorized_sym_matches_loop(n):
    """``make_sym_edge_normals`` (what the kernel-backed rhs calls) is
    the loop form bit for bit, on random components."""
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    rng = np.random.default_rng(n)
    u_ext = torch.from_numpy(
        rng.standard_normal((2, 6, tg.m, tg.m)).astype(np.float32))
    for x, y in zip(tsc.make_sym_edge_normals(tg)(u_ext),
                    tsc.sym_edge_normals(tg, u_ext)):
        assert x.is_contiguous() and torch.equal(x, y)


def _check_rhs(jout, out, exact):
    for name, x, y, r in zip(("dh", "du"), jout, out, exact):
        assert tuple(y.shape) == np.asarray(x).shape, name
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= TENDENCY_TOL, (name, errs)


def test_six_face_rhs_matches_jax_interpret(c8):
    jg, tg, jargs, targs = c8
    rhs = tsc.make_cov_rhs_pallas(tg, G, OM)
    kern = rhs.kernel
    before = tsc.CovRhs.launches
    out = rhs(*targs)
    assert tsc.CovRhs.launches == before          # plain: no launch
    jout = jsc.make_cov_rhs_pallas(jg, G, OM, interpret=True)(*jargs)
    sym = tsc.sym_edge_normals(tg, targs[1])
    exact = kern.reference(kern.fz[:, None].double(),
                           *[a.double() for a in targs + sym])
    _check_rhs(jout, out, exact)


def test_one_face_rhs_matches_jax_interpret(c8):
    """The face tier's ``n_faces=1, external_sym=True`` form, on two
    faces, with the JAX package's sym rows fed to both."""
    jg, tg, jargs, targs = c8
    rhs = tsc.make_cov_rhs_pallas(tg, G, OM, n_faces=1, external_sym=True)
    assert isinstance(rhs, tsc.CovRhs)
    jrhs = jsc.make_cov_rhs_pallas(jg, G, OM, interpret=True, n_faces=1,
                                   external_sym=True)
    jsn, jwe = jsc.sym_edge_normals(jg, jargs[1])
    fz = rhs.fz[:, None]
    for f in (0, 4):
        jf = (jnp.asarray(fz[f:f + 1].numpy()), jargs[0][f:f + 1],
              jargs[1][:, f:f + 1], jargs[2][f:f + 1], jsn[f:f + 1],
              jwe[f:f + 1])
        args = tuple(_T(a) for a in jf)
        exact = rhs.reference(*[a.double() for a in args])
        _check_rhs(jrhs(*jf), rhs(*args), exact)


def _models(ic, **kw):
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    if ic == "tc5":
        h, v, b = tic.williamson_tc5(tg, G, OM)
    elif ic == "tc2":
        (h, v), b = tic.williamson_tc2(tg, G, OM), None
    else:
        (h, v), b = tic.galewsky(tg, G, OM), None
    ref = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=b, **kw)
    pal = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=b,
                                backend="pallas", **kw)
    return ref, pal, ref.initial_state(h, v)


@pytest.mark.parametrize("ic, nu4", [("tc5", 0.0), ("tc2", 0.0),
                                     ("galewsky", 1.0e15)])
def test_pallas_backend_rhs_matches_jnp(ic, nu4):
    ref, pal, s = _models(ic, nu4=nu4)
    d_ref, d_pal = ref.rhs(s, 0.0), pal.rhs(s, 0.0)
    for k in ("h", "u"):
        assert _rel(d_ref[k], d_pal[k]) <= CLASSIC_TOL, (k, _rel(d_ref[k],
                                                                d_pal[k]))
    if nu4:
        # The del^4 term is added after the kernel: it moves the result.
        d0 = _models(ic)[1].rhs(s, 0.0)
        assert not torch.equal(d0["h"], d_pal["h"])


def test_pallas_backend_step_conserves_mass():
    ref, pal, s = _models("tc5")
    area = pal.grid.interior(pal.grid.area).double()
    m0 = float(torch.sum(area * s["h"].double()))
    out, _ = pal.run(s, 5, 600.0)
    assert bool(torch.isfinite(out["h"]).all())
    m1 = float(torch.sum(area * out["h"].double()))
    assert abs(m1 - m0) / m0 < 2e-6, (m1 - m0) / m0


def test_backends():
    ref, pal, s = _models("tc5")
    interp = CovariantShallowWater(ref.grid, gravity=G, omega=OM,
                                   b_ext=ref.b_ext,
                                   backend="pallas_interpret")
    assert (ref.backend, pal.backend) == ("jnp", "pallas")
    assert ref._pallas_rhs is None
    assert interp._pallas_rhs.kernel.interpret
    d_pal, d_int = pal.rhs(s, 0.0), interp.rhs(s, 0.0)
    for k in ("h", "u"):
        assert torch.equal(d_pal[k], d_int[k]), k
    with pytest.raises(ValueError, match="unknown backend"):
        CovariantShallowWater(ref.grid, gravity=G, omega=OM, backend="xla")
    g64 = build_grid(8, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        CovariantShallowWater(g64, gravity=G, omega=OM, backend="pallas")
    with pytest.raises(ValueError, match="n_faces=6"):
        tsc.make_cov_rhs_pallas(ref.grid, G, OM, n_faces=1)
