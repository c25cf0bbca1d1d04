"""The kernels of the ensemble, carry and precision knobs against their
plain versions, on the CPU.

The libraries of ``_build.POLICY_KERNELS`` are compiled here by g++ through
the stand-in ``cuda_runtime.h`` of ``test_torch_kernels_emulated.py`` (see
its docstring: blocks as 256 host threads, cp.async as plain copies), with
each ``#include``d kernel source written into the text first, and their
bfloat16 / float16 / int16 conversions are ``csrc/cov_half.cuh``'s plain
C++ ones (round to nearest even, as PyTorch rounds).  Every case is held
to bitwise equality (``torch.equal``) with the plain version: B1's member
fold (two members, the float32 ensemble's own instance), its carry
encodings (int16 / bfloat16 with an h anomaly in 1/16 m quanta; bfloat16
/ float16 with a u scale) and the bf16 stage policy (compute and strips,
also over two members, and with the split del^4 stepper's un-prescaled
sym rows) over the three stages; B1 under bf16 compute in each PLR limiter and PPM with bf16 strips; B2 with bf16
strips; B3 under the policy; B8 under bf16 compute.  Each family has a
mutation that must disagree.  The operands come from the plain path (TC5
at C40 after one plain step).  Skips where there is no g++.
"""

import ctypes
import itertools
import re
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream_torch import _build
from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import _launch
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics.initial_conditions import (galewsky,
                                                        williamson_tc5)
from test_torch_kernels_emulated import _CG_SHIM, _SHIM, _emulate

N = 40
G, OM = EARTH_GRAVITY, EARTH_OMEGA
DT = 75.0 * 384 / N


def _expand(src: str, headers: bool = False) -> str:
    """``src`` with each ``#include "x.cu"`` written out (and, for a
    mutant, ``cov_faces.cuh`` and ``cov_common.cuh`` too)."""
    src = re.sub(r'#include "(\w+\.cu)"\n',
                 lambda m: (_build.CSRC_DIR / m.group(1)).read_text(), src)
    if headers:
        common = (_build.CSRC_DIR / "cov_common.cuh").read_text()
        faces = (_build.CSRC_DIR / "cov_faces.cuh").read_text().replace(
            '#include "cov_common.cuh"\n', common)
        src = src.replace('#include "cov_faces.cuh"\n',
                          faces.replace("#pragma once\n", ""))
    return src


_MUTANTS = itertools.count()


@pytest.fixture(scope="module")
def emulated_policy(tmp_path_factory):
    """``{library name: host library}`` for the policy libraries, compiled
    in parallel; ``"_mutant"`` maps ``(name, old, new)`` to a library of
    ``name`` with the one occurrence of ``old`` (in it or the headers it
    includes) replaced by ``new``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu_policy")
    (out / "cuda_runtime.h").write_text(_SHIM)
    (out / "cooperative_groups.h").write_text(_CG_SHIM)

    def src_of(name):
        return (_build.CSRC_DIR / _build.KERNELS[name]).read_text()

    def build(name):
        return name, _emulate(_expand(src_of(name)), name, out, gxx)

    with ThreadPoolExecutor(len(_build.POLICY_KERNELS)) as pool:
        libs = dict(pool.map(build, _build.POLICY_KERNELS))

    def mutant(name, old, new):
        src = _expand(src_of(name), headers=True)
        assert src.count(old) == 1, old
        return _emulate(src.replace(old, new),
                        f"{name}_mut{next(_MUTANTS)}", out, gxx, "-O1")

    libs["_mutant"] = mutant
    return libs


@pytest.fixture
def launch_on_cpu(emulated_policy, monkeypatch):
    """Route the wrappers' launch path to the host libraries."""
    monkeypatch.setattr(_build, "load",
                        lambda name: ctypes.CDLL(str(emulated_policy[name])))
    monkeypatch.setattr(_launch.KernelBase, "_on_cuda",
                        staticmethod(lambda t: True))
    monkeypatch.setattr(_launch.KernelBase, "_stream", lambda self: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))


def _equal(out, ref):
    for k, (x, r) in enumerate(zip(out, ref)):
        assert x.shape == r.shape and x.dtype == r.dtype, k
        assert torch.equal(x, r), k


def _plain_step(step, y, b_ext):
    """One compact step of ``step`` through its stages' plain versions
    (never a launch)."""
    route, (st1, st2, st3) = step.route, step.stages
    h0, u0 = y["h"], y["u"]
    k = st1.reference(h0, u0, *route(y["strips_sn"], y["strips_we"]), b_ext)
    k = st2.reference(h0, u0, k[0], k[1], *route(k[2], k[3]), b_ext)
    k = st3.reference(h0, u0, k[0], k[1], *route(k[2], k[3]), b_ext)
    return {"h": k[0], "u": k[1], "strips_sn": k[2], "strips_we": k[3]}


def _tc5(scheme="plr", limiter="mc"):
    """C40 TC5 (halo 3 for PPM): the model and its state after one plain
    compact step (TC5's initial wind has exactly zero components that
    hide some operation orders)."""
    g = build_grid(N, halo=3 if scheme == "ppm" else 2, radius=EARTH_RADIUS,
                   device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b, scheme=scheme,
                              limiter=limiter)
    y = _plain_step(m.make_fused_step(DT),
                    m.compact_state(m.initial_state(h, v)), m.b_ext)
    return g, m, m.restrict_state(y)


@pytest.fixture(scope="module")
def tc5_mc():
    return _tc5()


def _stage_cases(g, m, state, members=1, **kw):
    """The three stages of a compact stepper built with ``kw`` and their
    operands on ``state`` (``members`` > 1: the batched carry of member 0
    and a perturbed member 1), each from the plain stages."""
    carry = {k: kw[k] for k in ("carry_dtype", "h_offset", "h_scale",
                                "u_scale") if k in kw}
    step = tsc.make_fused_ssprk3_cov_compact(
        g, G, OM, DT, m.b_ext, scheme=m.scheme, limiter=m.limiter,
        ensemble=members if members > 1 else 0, **kw)
    if members > 1:
        states = [state, {"h": state["h"] * 1.0005, "u": state["u"]}]
        y = m.ensemble_compact_state(m.stack_ensemble(states))
        fold = lambda x, lead=0: x.reshape(  # noqa: E731
            x.shape[:lead] + (-1,) + x.shape[lead + 2:])
        h0, u0 = fold(y["h"]), fold(y["u"], 1)
        routed = tuple(fold(r) for r in step.route(y["strips_sn"],
                                                    y["strips_we"]))
    else:
        y = m.encode_carry(m.compact_state(state), **carry)
        h0, u0 = y["h"], y["u"]
        routed = step.route(y["strips_sn"], y["strips_we"])
    st1, st2, st3 = step.stages
    k1 = st1.reference(h0, u0, *routed, m.b_ext)
    return [(st1, (h0, u0) + routed + (m.b_ext,)),
            (st2, (h0, u0, k1[0], k1[1]) + routed + (m.b_ext,)),
            (st3, (h0, u0, k1[0], k1[1]) + routed + (m.b_ext,))]


_B1_CONFIGS = {
    "members2": dict(members=2),
    "members2-bf16": dict(members=2, precision="bf16"),
    "bf16": dict(precision="bf16"),
    "mixed16": dict(carry_dtype=(torch.int16, torch.bfloat16),
                    h_offset=5150.0, h_scale=0.0625),
    "bf16-f16-uscale": dict(carry_dtype=(torch.bfloat16, torch.float16),
                            h_offset=5150.0, u_scale=EARTH_RADIUS,
                            precision={"stage": "bf16", "strips": "f32"}),
    "bf16-frame": dict(precision="bf16", prescale_sym=False),
}


@pytest.mark.parametrize("config", list(_B1_CONFIGS))
def test_b1_policy_kernel_source(launch_on_cpu, tc5_mc, config):
    """B1's policy instances over the three stages, bitwise."""
    g, m, state = tc5_mc
    kw = dict(_B1_CONFIGS[config])
    before = tsc.CovStageCompact.launches
    cases = _stage_cases(g, m, state, **kw)
    for st, args in cases:
        assert not st.plain
        # Only the float32 ensemble takes the members library.
        assert (st.kernel_name.startswith("cov_stage_members")
                == (config == "members2")), st.kernel_name
        _equal(st(*args), st.reference(*args))
    assert tsc.CovStageCompact.launches == before + len(cases)


@pytest.mark.parametrize("scheme, limiter, precision", [
    ("plr", "none", "bf16"), ("plr", "minmod", "bf16"),
    ("plr", "mc_sign", "bf16"), ("plr", "vanleer", "bf16"),
    ("ppm", "mc", {"stage": "f32", "strips": "bf16"})],
    ids=["none", "minmod", "mc_sign", "vanleer", "ppm-strips"])
def test_b1_policy_modes(launch_on_cpu, scheme, limiter, precision):
    """Each reconstruction's policy instance of B1 on stage 2."""
    g, m, state = _tc5(scheme, limiter)
    st, args = _stage_cases(g, m, state, precision=precision)[1]
    _equal(st(*args), st.reference(*args))


@pytest.fixture(scope="module")
def galewsky_c40_bf16():
    """C40 Galewsky (nu4 = 1e14) after one bf16 split step: the filter's
    and the re-fused stage's operands with bf16 routed ghosts."""
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    dt = 60.0 * 384 / N
    step = m.make_fused_step(dt, precision="bf16")
    y = _plain_step(step, m.compact_state(m.initial_state(
        *galewsky(g, G, OM))), m.b_ext)
    args = (y["h"], y["u"]) + step.route(y["strips_sn"], y["strips_we"])
    y = dict(zip(("h", "u", "strips_sn", "strips_we"),
                 step.filter.reference(*args)))
    return g, m, dt, (y["h"], y["u"]) + step.route(y["strips_sn"],
                                                   y["strips_we"])


def test_b2_bf16_strips_kernel_source(launch_on_cpu, galewsky_c40_bf16):
    """B2 with bf16 ghosts in and strips out: the real filter and a probe
    whose increment is 1e3 x the state."""
    g, m, dt, args = galewsky_c40_bf16
    assert args[2].dtype == torch.bfloat16
    before = tsc.CovNu4Filter.launches
    for nu4 in (1.0e14, 1.0e21):
        filt = tsc.make_cov_nu4_filter(g, nu4, dt, precision="bf16")
        _equal(filt._launch(*args), filt.reference(*args))
    assert tsc.CovNu4Filter.launches == before + 2


@pytest.mark.parametrize("limiter, precision", [
    ("mc", "bf16"), ("vanleer", "bf16"),
    ("mc", {"stage": "f32", "strips": "bf16"}),
    ("mc", {"stage": "bf16", "strips": "f32"})],
    ids=["mc-bf16", "vanleer-bf16", "mc-strips", "mc-compute"])
def test_b3_policy_kernel_source(launch_on_cpu, galewsky_c40_bf16, limiter,
                                 precision):
    """B3's policy instances; f32-strips cases take the f32 ghosts of the
    same state."""
    g, m, dt, args = galewsky_c40_bf16
    st = tsc.make_cov_stage_refused_nu4(g, G, OM, dt, 1.0e14,
                                        limiter=limiter, precision=precision)
    if st.sdt == torch.float32:
        route = tsc.make_cov_strip_router_split(g)
        sn, we = tsc.pack_strips_cov_split(args[0], args[1], g.n, g.halo)
        args = args[:2] + route(sn, we)
    before = tsc.CovStageRefusedNu4.launches
    _equal(st(*args, m.b_ext), st.reference(*args, m.b_ext))
    assert tsc.CovStageRefusedNu4.launches == before + 1


def test_b3_policy_ppm_kernel_source(launch_on_cpu):
    """B3's PPM body (halo 3) with bf16 strips and f32 arithmetic."""
    g = build_grid(N, halo=3, radius=EARTH_RADIUS, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14,
                              scheme="ppm")
    pol = {"stage": "f32", "strips": "bf16"}
    dt = 60.0 * 384 / N
    y = m.compact_state(m.initial_state(*galewsky(g, G, OM)))
    route = tsc.make_cov_strip_router_split(g, precision=pol)
    args = (y["h"], y["u"]) + route(y["strips_sn"], y["strips_we"])
    st = tsc.make_cov_stage_refused_nu4(g, G, OM, dt, 1.0e14, scheme="ppm",
                                        precision=pol)
    _equal(st(*args, m.b_ext), st.reference(*args, m.b_ext))


@pytest.mark.parametrize("limiter", ["mc", "minmod"])
def test_b8_bf16_kernel_source(launch_on_cpu, tc5_mc, limiter):
    """B8's bf16 compute instances over the three stages of the extended
    carry."""
    g, m, state = tc5_mc
    step = tsc.make_fused_ssprk3_cov_inkernel(
        g, G, OM, DT, m.b_ext, limiter=limiter,
        precision={"stage": "bf16", "strips": "f32"})
    y = m.extend_state(state, with_strips=True)
    ghosts = step.route(y["strips"])
    st1, st2, st3 = step.stages
    k1 = st1.reference(y["h"], y["u"], ghosts, m.b_ext)
    before = tsc.CovStageInkernel.launches
    for st, args in ((st1, (y["h"], y["u"], ghosts, m.b_ext)),
                     (st2, (y["h"], y["u"], k1[0], k1[1], ghosts, m.b_ext))):
        _equal(st(*args), st.reference(*args))
    assert tsc.CovStageInkernel.launches == before + 2


#: One mutation per kernel family: B1's float32 ensemble instance reading
#: the static per-face data of the folded face of member 0 for every
#: member, B1 dropping h's offset
#: from the strips, B2 and B3 reading bfloat16 ghosts as float32, B8 (and
#: every bf16 compute instance) averaging the face velocities in float32.
_MUTATIONS = {
    "b1-member-fold": ("cov_stage_members", "const int fs0 = f0 % 6;",
                       "const int fs0 = f0 % 6 * 0;"),
    "b1-strip-offset": ("cov_stage_policy",
                        "if (st.h_off != 0.0f) v[0] = v[0] + st.h_off;",
                        "if (st.h_off != 0.0f) v[0] = v[0];"),
    "b2-ghost-width": ("cov_nu4_filter_bf16",
                       "*dst = strip_load(src, g, 1);",
                       "*dst = strip_load(src, g, 0);"),
    "b3-sym-rows": ("cov_stage_refused_nu4_policy_bf16",
                    "ghosts_at(p.gwe, gf, 1), 1, 0, p.xc, p.xf, p.R2,",
                    "ghosts_at(p.gsn, gf, 1), 1, 0, p.xc, p.xf, p.R2,"),
    "b8-face-average": ("cov_stage_inkernel_bf16",
                        "return bf16_round(0.5f * bf16_round(bf16_round(a) "
                        "+ bf16_round(b)));",
                        "return 0.5f * (a + b);"),
}


@pytest.mark.parametrize("case", list(_MUTATIONS))
def test_policy_mutation_is_caught(emulated_policy, launch_on_cpu,
                                   monkeypatch, tc5_mc, galewsky_c40_bf16,
                                   case):
    name, old, new = _MUTATIONS[case]
    lib = emulated_policy["_mutant"](name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated_policy[nm])))
    g, m, state = tc5_mc
    if case == "b1-member-fold":
        st, args = _stage_cases(g, m, state, members=2)[1]
        out, ref = st(*args), st.reference(*args)
    elif case == "b1-strip-offset":
        st, args = _stage_cases(g, m, state, **_B1_CONFIGS["mixed16"])[1]
        out, ref = st(*args), st.reference(*args)
    elif case == "b2-ghost-width":
        gg, mm, dt, args = galewsky_c40_bf16
        filt = tsc.make_cov_nu4_filter(gg, 1.0e21, dt, precision="bf16")
        out, ref = filt._launch(*args), filt.reference(*args)
    elif case == "b3-sym-rows":
        gg, mm, dt, args = galewsky_c40_bf16
        st = tsc.make_cov_stage_refused_nu4(gg, G, OM, dt, 1.0e14,
                                            precision="bf16")
        out, ref = st(*args, mm.b_ext), st.reference(*args, mm.b_ext)
    else:
        step = tsc.make_fused_ssprk3_cov_inkernel(
            g, G, OM, DT, m.b_ext,
            precision={"stage": "bf16", "strips": "f32"})
        y = m.extend_state(state, with_strips=True)
        args = (y["h"], y["u"], step.route(y["strips"]), m.b_ext)
        out, ref = step.stages[0](*args), step.stages[0].reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))
