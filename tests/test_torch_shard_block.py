"""The port's sharded covariant tiers on virtual ranks (``device="cpu"``):
the block tier against the face tier, the overlapped forms against the
serialized ones, the rank mesh and its transport, and the refusals.

Budgets:

* block tier (24 ranks, the (6, 2, 2) mesh) against the face tier (6
  ranks), 3 steps at C16: 2e-4 of each field's max
  (``tests/cov_block_worker.py:70``'s budget: the intra-panel seams
  impose the shared normal where the face tier's kernel computes it);
* overlapped against serialized, on each tier: 1e-6 of max
  (``tests/test_overlap_exchange.py:157``); the same arithmetic tiled,
  so bitwise is what the plain versions give;
* two block-tier steps per call (``temporal_block=2``) against two
  calls: bitwise (the same operations);
* mass drift over the 3 steps: < 2e-6 on both tiers;
* ``shard_state`` / ``unshard_state``: a bitwise round trip;
* every reconstruction (PLR with each limiter at halo 2, PPM at halo 3)
  on both tiers, serialized and overlapped, against the model's classic
  step, 3 steps at C16: 2e-4 of max, mass < 2e-6;
* face-tier del^4 against the classic del^4 path, 3 steps at C8: 5e-4
  of max (``tests/test_shard_cov.py``'s budget), at a nu4 whose term
  moves the fields by ~1e-2 of max there.
"""

import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.parallel.comm import VirtualRanks
from jaxstream_torch.parallel.mesh import (_factor_mesh, setup_sharding,
                                           shard_state, unshard_state)
from jaxstream_torch.parallel.shard_cov_block import (
    make_sharded_cov_block_stepper)
from jaxstream_torch.parallel.sharded_model import make_stepper_for
from jaxstream_torch.physics.initial_conditions import williamson_tc5

G, OM = EARTH_GRAVITY, EARTH_OMEGA
BLOCK_VS_FACE_TOL = 2e-4
OVERLAP_TOL = 1e-6
MASS_TOL = 2e-6
# Face-tier del^4 against the classic del^4 path, of max after 3 steps:
# the JAX package's budget (tests/test_shard_cov.py).
NU4_TOL = 5e-4
DT = 600.0


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (a.abs().max() + 1e-300))


def _setup(tiles, devices, overlap=False, **extra):
    return setup_sharding({"parallelization": dict(
        tiles_per_edge=tiles, num_devices=devices, use_shard_map=True,
        overlap_exchange=overlap, **extra)}, device="cpu")


@pytest.fixture(scope="module")
def tc5_c16():
    g = build_grid(16, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    return g, m, m.initial_state(h, v)


def _run(model, setup, s0, nsteps=3):
    step = make_stepper_for(model, setup, None, DT)
    y = shard_state(setup, s0)
    for _ in range(nsteps):
        y = step(y, 0.0)
    return unshard_state(setup, y)


@pytest.fixture(scope="module")
def tier_runs(tc5_c16):
    g, m, s0 = tc5_c16
    return {(tiles, overlap): _run(m, _setup(tiles, 6 * tiles * tiles,
                                             overlap), s0)
            for tiles in (1, 2) for overlap in (False, True)}


def test_block_tier_matches_face_tier(tier_runs):
    face, block = tier_runs[(1, False)], tier_runs[(2, False)]
    for k in ("h", "u"):
        assert _rel(face[k], block[k]) <= BLOCK_VS_FACE_TOL, k


@pytest.mark.parametrize("tiles", [1, 2], ids=["face", "block"])
def test_overlapped_matches_serialized(tier_runs, tiles):
    ser, ovl = tier_runs[(tiles, False)], tier_runs[(tiles, True)]
    for k in ("h", "u"):
        assert _rel(ser[k], ovl[k]) <= OVERLAP_TOL, k


@pytest.mark.parametrize("key", [(1, False), (1, True), (2, False),
                                 (2, True)],
                         ids=["face", "face-overlap", "block",
                              "block-overlap"])
def test_tiers_conserve_mass(tc5_c16, tier_runs, key):
    g, m, s0 = tc5_c16
    area = g.interior(g.area).double()
    m0 = float((area * s0["h"].double()).sum())
    m1 = float((area * tier_runs[key]["h"].double()).sum())
    assert torch.isfinite(tier_runs[key]["h"]).all()
    assert abs(m1 - m0) / m0 < MASS_TOL


#: Every reconstruction: (scheme, limiter).
MODES = [("plr", lim) for lim in ("none", "minmod", "mc", "mc_sign",
                                  "vanleer")] + [("ppm", "mc")]


@pytest.mark.parametrize("scheme, limiter", MODES,
                         ids=[lim if sc == "plr" else sc
                              for sc, lim in MODES])
def test_every_mode_on_both_tiers_matches_classic(scheme, limiter):
    """Both tiers, serialized and overlapped, in each mode (their kernels
    B4's stacked form, B5 and B6 take every one): 3 steps against the
    model's classic step, and mass."""
    g = build_grid(16, halo=3 if scheme == "ppm" else 2,
                   radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b,
                              scheme=scheme, limiter=limiter)
    s0 = m.initial_state(h, v)
    ref = s0
    for _ in range(3):
        ref = m.make_step(DT)(ref, 0.0)
    area = g.interior(g.area).double()
    m0 = float(torch.sum(area * s0["h"].double()))
    for tiles in (1, 2):
        for overlap in (False, True):
            out = _run(m, _setup(tiles, 6 * tiles * tiles, overlap), s0)
            for k in ("h", "u"):
                assert _rel(ref[k], out[k]) <= BLOCK_VS_FACE_TOL, (
                    tiles, overlap, k, _rel(ref[k], out[k]))
            m1 = float(torch.sum(area * out["h"].double()))
            assert abs(m1 - m0) / m0 < MASS_TOL, (tiles, overlap)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serialized", "overlapped"])
def test_face_tier_nu4_matches_classic(overlap):
    """Face-tier del^4 (exchange, lap, exchange, lap per stage) against
    the classic del^4 path after 3 steps at C8, at nu4 = 1e19 m^4/s."""
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b, nu4=1.0e19)
    s0 = m.initial_state(h, v)
    ref = s0
    for _ in range(3):
        ref = m.make_step(DT)(ref, 0.0)
    out = _run(m, _setup(1, 6, overlap), s0)
    for k in ("h", "u"):
        assert _rel(ref[k], out[k]) <= NU4_TOL, (k, _rel(ref[k], out[k]))


def test_block_tier_temporal_block_is_exact(tc5_c16):
    g, m, s0 = tc5_c16
    setup = _setup(2, 24, temporal_block=2)
    step2 = make_stepper_for(m, setup, None, DT)
    assert step2.steps_per_call == 2
    step1 = make_sharded_cov_block_stepper(m, setup, DT)
    y = shard_state(setup, s0)
    a, b = step2(y, 0.0), step1(step1(y, 0.0), 0.0)
    for k in ("h", "u"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("tiles, devices", [(1, 6), (2, 24), (2, 12),
                                            (1, 2), (1, 3)])
def test_shard_state_round_trip(tc5_c16, tiles, devices):
    g, m, s0 = tc5_c16
    setup = _setup(tiles, devices)
    p, sy, sx = _factor_mesh(devices, tiles)
    assert (setup.panel, setup.sy, setup.sx) == (p, sy, sx)
    local = shard_state(setup, {k: v.numpy() for k, v in s0.items()})
    assert local["h"].shape == (devices, 6 // p, 16 // sy, 16 // sx)
    assert local["u"].shape == (devices, 2, 6 // p, 16 // sy, 16 // sx)
    back = unshard_state(setup, local)
    for k in ("h", "u"):
        assert torch.equal(back[k], s0[k]), k


def test_setup_sharding_errors():
    with pytest.raises(ValueError, match="exceeds num_tiles"):
        _setup(1, 12)
    with pytest.raises(ValueError, match="not divisible by num_devices"):
        _setup(2, 5)
    with pytest.raises(ValueError, match="raise tiles_per_edge"):
        _factor_mesh(24, 1)
    with pytest.raises(ValueError, match="tiles_per_edge must be >= 1"):
        _setup(0, 6)
    with pytest.raises(ValueError, match="unknown device_type"):
        _setup(1, 6, device_type="fpga")
    one = _setup(1, 1)
    assert one.ranks is None and one.local_ranks == [0]


def test_setup_sharding_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is valid here")
    with pytest.raises(RuntimeError, match="GPU"):
        setup_sharding({"parallelization": {"num_devices": 6}})


def test_virtual_ranks_ppermute():
    ranks = VirtualRanks(4, "cpu")
    x = torch.arange(8.0).reshape(4, 2)
    out = ranks.ppermute(x, [(0, 1), (1, 2), (3, 0)])
    # Rank 3 receives nothing: zeros, as lax.ppermute gives.
    assert torch.equal(out, torch.tensor([[6.0, 7.0], [0.0, 1.0],
                                          [2.0, 3.0], [0.0, 0.0]]))
    with pytest.raises(ValueError, match="permutation"):
        ranks.ppermute(x, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="outside"):
        ranks.ppermute(x, [(0, 4)])


@pytest.fixture(scope="module")
def c8_models():
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    return (CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b),
            CovariantShallowWater(g, gravity=G, omega=OM, nu4=1e15),
            ShallowWater(g, gravity=G, omega=OM))


@pytest.mark.parametrize("case", [
    "ensemble", "deep-halo", "face-nu4", "block-nu4", "gspmd", "single",
    "cartesian", "bf16", "vanleer"])
def test_unported_options_name_a8(c8_models, case):
    cov, cov_nu4, cart = c8_models
    face, block = _setup(1, 6), _setup(2, 24)
    van = CovariantShallowWater(cov.grid, gravity=G, omega=OM,
                                limiter="vanleer")
    calls = {
        "ensemble": lambda: make_stepper_for(cov, face, None, DT,
                                             ensemble=4),
        "deep-halo": lambda: make_stepper_for(cov, face, None, DT,
                                              temporal_block=2),
        "face-nu4": lambda: make_stepper_for(cov_nu4, face, None, DT),
        "block-nu4": lambda: make_sharded_cov_block_stepper(cov_nu4, block,
                                                            DT),
        "gspmd": lambda: make_stepper_for(cov, setup_sharding(
            {"parallelization": {"num_devices": 6}}, device="cpu"), None,
            DT),
        "single": lambda: make_stepper_for(cov, None, None, DT),
        "cartesian": lambda: make_stepper_for(cart, face, None, DT),
        "bf16": lambda: make_stepper_for(cov, face, None, DT,
                                         precision="bf16"),
        "vanleer": lambda: make_stepper_for(van, face, None, DT),
    }
    if case == "single":
        # The single-device branch is ported: the model's classic step.
        s = {"h": torch.full((6, 8, 8), 1000.0, dtype=torch.float32),
             "u": torch.zeros((2, 6, 8, 8), dtype=torch.float32)}
        y, ref = calls[case]()(s, 0.0), cov.make_step(DT)(s, 0.0)
        assert all(torch.equal(y[k], ref[k]) for k in s)
        return
    if case in ("face-nu4", "vanleer"):
        # Ported: face-tier del^4 and every mode on the tiers; one step
        # against the model's classic step (the budgets of
        # tests/test_torch_shard_cov.py's tier parity).
        model = {"face-nu4": cov_nu4, "vanleer": van}[case]
        s = model.initial_state(*williamson_tc5(cov.grid, G, OM)[:2])
        y = unshard_state(face, calls[case]()(shard_state(face, s), 0.0))
        ref = model.make_step(DT)(s, 0.0)
        tol = NU4_TOL if case == "face-nu4" else BLOCK_VS_FACE_TOL
        assert all(_rel(ref[k], y[k]) <= tol for k in s), case
        return
    with pytest.raises(NotImplementedError, match=r"queue A item 4 \(A8\)"):
        calls[case]()


def test_scheme_refusal_is_the_jax_packages(c8_models):
    with pytest.raises(ValueError, match="ssprk3 only"):
        make_stepper_for(c8_models[0], _setup(1, 6), None, DT, scheme="rk4")
