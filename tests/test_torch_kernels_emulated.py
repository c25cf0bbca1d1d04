"""The CUDA kernel sources against their plain versions, on the CPU.

The kernels under ``jaxstream_torch/csrc/`` are compiled here by the host
C++ compiler (g++) instead of nvcc, through a small stand-in for
``cuda_runtime.h``: ``__shared__`` arrays become statics, each block runs
as 256 host threads with a real barrier for ``__syncthreads`` and its own
arena for the dynamic shared memory, and blocks run one after another;
the asynchronous copies (cp.async) copy at once, and their commit and
wait do nothing.  A cooperative launch (the whole-step
kernel's, ``cudaLaunchCooperativeKernel``) runs all its blocks' threads at once
instead, each block with its own barrier and its own arena for the
dynamic shared memory, and ``this_grid().sync()`` waits on a grid-wide
barrier; the stand-in occupancy API gives a grid of 8 blocks.  The
wrappers' launch path then runs unchanged on CPU tensors.  This checks
what the sources compute (indexing, aprons, tile seams, ragged edges, op
order) at C40, where a face has 2 x 3 tiles with ragged last ones; it
says nothing of how they run on a GPU, which the ``gpu``-marked tests and
``chip_smoke.py`` check on the card.

With ``-ffp-contract=off`` the host rounds every multiply and add
separately, as the kernels' ``-fmad=false`` builds do, so the outputs are
bitwise equal to the plain versions' (the stand-in ``rsqrtf`` is
``1/sqrtf``, as PyTorch's CPU ``rsqrt`` is).  Skips where there is no g++.
"""

import ctypes
import itertools
import re
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from jaxstream_torch import _build
from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.experiments import nu4_bisect as nb
from jaxstream_torch.experiments import swe_cov_nbr as nbr
from jaxstream_torch.experiments import swe_mega as mega
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import _launch
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.ops.cuda import swe_rhs as tsr
from jaxstream_torch.ops.cuda import swe_step as tss
from jaxstream_torch.physics.initial_conditions import galewsky, williamson_tc5

N = 40
G, OM = EARTH_GRAVITY, EARTH_OMEGA

# The stand-in for cuda_runtime.h.
_SHIM = r"""
#pragma once
#include <cmath>
#include <pthread.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_idx { unsigned x, y, z; };
inline thread_local emu_idx threadIdx, blockIdx;
inline thread_local emu_idx blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 8;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* nb, F, int, size_t) {
  *nb = 1;
  return 0;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __ldcg(const float* p) { return *p; }
// cp.async: the copy happens at once; commit and wait have nothing to do.
inline void async_copy4(float* d, const float* s) { *d = *s; }
inline void async_copy16_cg(float* d, const float* s) {
  for (int k = 0; k < 4; ++k) d[k] = s[k];
}
inline void async_commit() {}
template <int N>
inline void async_wait() {}
inline thread_local pthread_barrier_t* emu_block_barrier;
inline thread_local void* emu_dyn_smem;
inline pthread_barrier_t emu_grid_barrier;
inline void __syncthreads() { pthread_barrier_wait(emu_block_barrier); }
template <class K, class P>
void emu_launch(K kernel, dim3 grid, dim3 block, const P& p, size_t smem) {
  const unsigned nt = block.x * block.y * block.z;
  pthread_barrier_t bar;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        pthread_barrier_init(&bar, nullptr, nt);
        std::vector<double> arena(smem / 8 + 1);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([=, &p, &bar, &arena]() {
            threadIdx = {t % block.x, (t / block.x) % block.y,
                         t / (block.x * block.y)};
            blockIdx = {bx, by, bz};
            blockDim = {block.x, block.y, block.z};
            gridDim = {grid.x, grid.y, grid.z};
            emu_block_barrier = &bar;
            emu_dyn_smem = arena.data();
            kernel(p);
          });
        for (auto& th : ts) th.join();
        pthread_barrier_destroy(&bar);
      }
}
// A cooperative launch: every block's threads at once (a 1-D grid).
template <class P>
int cudaLaunchCooperativeKernel(void (*kernel)(P), dim3 grid, dim3 block,
                                void** args, size_t smem, cudaStream_t) {
  const P& p = *static_cast<const P*>(args[0]);
  const unsigned nt = block.x * block.y * block.z;
  std::vector<pthread_barrier_t> bars(grid.x);
  std::vector<std::vector<double>> arenas(grid.x,
                                          std::vector<double>(smem / 8 + 1));
  for (auto& b : bars) pthread_barrier_init(&b, nullptr, nt);
  pthread_barrier_init(&emu_grid_barrier, nullptr, nt * grid.x);
  std::vector<std::thread> ts;
  for (unsigned bx = 0; bx < grid.x; ++bx)
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([=, &p, &bars, &arenas]() {
        threadIdx = {t % block.x, (t / block.x) % block.y,
                     t / (block.x * block.y)};
        blockIdx = {bx, 0, 0};
        blockDim = {block.x, block.y, block.z};
        gridDim = {grid.x, 1, 1};
        emu_block_barrier = &bars[bx];
        emu_dyn_smem = arenas[bx].data();
        kernel(p);
      });
  for (auto& th : ts) th.join();
  for (auto& b : bars) pthread_barrier_destroy(&b);
  pthread_barrier_destroy(&emu_grid_barrier);
  return 0;
}
"""

# The stand-in for cooperative_groups.h: the grid barrier.
_CG_SHIM = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() const { pthread_barrier_wait(&emu_grid_barrier); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
"""


def _mutated_lib(emulated, name: str, old: str, new: str):
    """Kernel ``name`` compiled for the host with the one occurrence of
    ``old`` replaced by ``new``: in its source, or in the header it
    includes (``cov_faces.cuh`` or ``swe_faces.cuh``), which is then
    inlined into the source.  Each mutation gets a library
    of its own: a path the process has loaded once is not loaded again."""
    src = (_build.CSRC_DIR / _build.KERNELS[name]).read_text()
    if old in src:
        assert src.count(old) == 1
        src = src.replace(old, new)
    else:
        header = next(h for h in ("cov_faces.cuh", "swe_faces.cuh")
                      if old in (_build.CSRC_DIR / h).read_text())
        hdr = (_build.CSRC_DIR / header).read_text()
        assert hdr.count(old) == 1
        hdr = hdr.replace(old, new).replace("#pragma once\n", "")
        assert f'#include "{header}"\n' in src
        src = src.replace(f'#include "{header}"\n', hdr)
    return emulated["_compile"](src, f"{name}_mut{next(_MUTANTS)}")


_MUTANTS = itertools.count()


def _emulate(src: str, name: str, out, gxx: str):
    """Compile CUDA source text ``src`` for the host as ``lib{name}.so``
    in ``out`` (which holds the stand-in headers)."""
    src = re.sub(r"(\w+)<<<\s*(\w+),\s*(\w+),\s*(\w+),.*?>>>\((\w+)\)",
                 r"emu_launch(\1, \2, \3, \5, \4)", src, flags=re.S)
    # Dynamic shared memory: the block's arena.
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = static_cast<\1*>(emu_dyn_smem);", src)
    cpp, lib = out / f"{name}.cpp", out / f"lib{name}.so"
    cpp.write_text(src)
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
         "-fPIC", "-pthread", f"-I{out}", f"-I{_build.CSRC_DIR}",
         "-o", str(lib), str(cpp)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{kernel name: host library}``, every kernel of ``_build.KERNELS``
    compiled by g++ in parallel; ``"_compile"`` maps to a function that
    compiles a mutated source the same way."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_runtime.h").write_text(_SHIM)
    (out / "cooperative_groups.h").write_text(_CG_SHIM)

    def build(name):
        src = (_build.CSRC_DIR / _build.KERNELS[name]).read_text()
        return name, _emulate(src, name, out, gxx)

    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        libs = dict(pool.map(build, _build.KERNELS))
    libs["_compile"] = lambda src, name: _emulate(src, name, out, gxx)
    return libs


@pytest.fixture
def launch_on_cpu(emulated, monkeypatch):
    """Route the wrappers' launch path to the host libraries for CPU
    tensors."""
    monkeypatch.setattr(_build, "load",
                        lambda name: ctypes.CDLL(str(emulated[name])))
    monkeypatch.setattr(_launch.KernelBase, "_on_cuda",
                        staticmethod(lambda t: True))
    monkeypatch.setattr(_launch.KernelBase, "_stream", lambda self: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))


def _equal(out, ref):
    for k, (x, r) in enumerate(zip(out, ref)):
        assert x.shape == r.shape and torch.equal(x, r), k


@pytest.fixture(scope="module")
def galewsky_c40():
    """The C40 Galewsky model (nu4 = 1e14), dt at the C384 CFL, and the
    carry after one split step with its routed ghosts."""
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    dt = 60.0 * 384 / N
    step = m.make_fused_step(dt)
    y = step(m.compact_state(m.initial_state(*galewsky(g, G, OM))), 0.0)
    return g, m, dt, step, (y["h"], y["u"]) + step.route(y["strips_sn"],
                                                        y["strips_we"])


def test_stage_kernel_source(launch_on_cpu):
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s0 = m.initial_state(h, v)
    y = m.compact_state(s0)
    gsn, gwe = tsc.make_cov_strip_router_split(g)(y["strips_sn"],
                                                   y["strips_we"])
    for a, bb in tsc.SSPRK3_COEFFS:
        st = tsc.make_cov_stage_compact(g.n, g.halo, g.dalpha, g.radius, G,
                                        OM, 75.0, a, bb, device="cpu")
        args = (s0["h"], s0["u"], gsn, gwe, m.b_ext)
        if a != 0.0:
            args = (s0["h"], s0["u"]) + args
        before = tsc.CovStageCompact.launches
        _equal(st(*args), st.reference(*args))
        assert tsc.CovStageCompact.launches == before + 1


def test_filter_kernel_source(launch_on_cpu, galewsky_c40):
    g, m, dt, step, args = galewsky_c40
    for nu4 in (1.0e14, 1.0e21):            # the real filter, a probe
        filt = tsc.make_cov_nu4_filter(g, nu4, dt)
        _equal(filt._launch(*args), filt.reference(*args))


# ---- the faces-in-block kernels (B1, B2) on larger grids ------------------
#
# At C40 every 32 x 24 tile of B1 and B2 touches a face edge.  At C72 a
# face has 3 x 3 tile positions, the middle one's window inside the face
# (no ghost read), and ragged last columns; at C74 the last row and column
# of tiles are ragged by 2 and 10 cells.

#: The window a face's tile computes from: the double buffer's index; the
#: mutations read the other buffer (the next face's window).
_FACES_WINDOW = {"cov_stage": "= sm.w[cur];",
                 "cov_nu4_filter": "= sm.psi[cur];"}
#: B1's prefetch of the next face's window; the mutation stages the
#: current face again, which a field symmetric across faces would hide.
_STAGE_PREFETCH = "stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);"


def _faces_operands(n):
    """C``n`` TC5: the compact stages, the filter at nu4 = 1e14 and a probe
    (1e21), and their operands on the carry after one step of the plain
    stages (TC5's initial wind has a zero component in places, which
    hides some operation orders): stages 1-3 and stage 3 with y0 = -2*yc
    (the outputs g*L alone)."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    step = m.make_fused_step(75.0 * 384 / n)
    route, (st1, st2, st3) = step.route, step.stages
    y = m.compact_state(m.initial_state(h, v))
    h0, u0 = y["h"], y["u"]
    k = st1.reference(h0, u0, *route(y["strips_sn"], y["strips_we"]), b)
    k = st2.reference(h0, u0, k[0], k[1], *route(k[2], k[3]), b)
    k = st3.reference(h0, u0, k[0], k[1], *route(k[2], k[3]), b)
    h1, u1 = k[0], k[1]
    gsn, gwe = route(k[2], k[3])
    stages = [(st1, (h1, u1, gsn, gwe, b)),
              (st2, (h0, u0, h1, u1, gsn, gwe, b)),
              (st3, (h0, u0, h1, u1, gsn, gwe, b)),
              (st3, (-2.0 * h1, -2.0 * u1, h1, u1, gsn, gwe, b))]
    filters = [tsc.make_cov_nu4_filter(g, nu4, 60.0 * 384 / n)
               for nu4 in (1.0e14, 1.0e21)]
    return stages, filters, (h1, u1, gsn, gwe)


@pytest.fixture(scope="module")
def faces_cases():
    return {n: _faces_operands(n) for n in (72, 74)}


@pytest.mark.parametrize("n", [72, 74], ids=["c72", "c74"])
def test_stage_kernel_larger_grids(launch_on_cpu, faces_cases, n):
    stages, _, _ = faces_cases[n]
    before = tsc.CovStageCompact.launches
    for st, args in stages:
        _equal(st(*args), st.reference(*args))
    assert tsc.CovStageCompact.launches == before + len(stages)


@pytest.mark.parametrize("n", [72, 74], ids=["c72", "c74"])
def test_filter_kernel_larger_grids(launch_on_cpu, faces_cases, n):
    _, filters, args = faces_cases[n]
    before = tsc.CovNu4Filter.launches
    for filt in filters:
        _equal(filt._launch(*args), filt.reference(*args))
    assert tsc.CovNu4Filter.launches == before + len(filters)


@pytest.mark.parametrize("name, old, new", [
    ("cov_stage", _FACES_WINDOW["cov_stage"], "= sm.w[cur ^ 1];"),
    ("cov_nu4_filter", _FACES_WINDOW["cov_nu4_filter"],
     "= sm.psi[cur ^ 1];"),
    ("cov_stage", _STAGE_PREFETCH, _STAGE_PREFETCH.replace("f + 1", "f"))],
    ids=["stage-next-window", "filter-next-window", "stage-prefetch-face"])
def test_faces_kernel_mutation_is_caught(emulated, launch_on_cpu,
                                         monkeypatch, faces_cases, name, old,
                                         new):
    """The mutation checks of B1 and B2: a face computed from the other
    buffer's window, and B1 prefetching the current face's window instead
    of the next one's, must disagree with the plain versions at C72."""
    lib = _mutated_lib(emulated, name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    stages, filters, args = faces_cases[72]
    if name == "cov_stage":
        st, args = stages[1]
        out, ref = st(*args), st.reference(*args)
    else:
        out, ref = filters[1]._launch(*args), filters[1].reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


def test_refused_kernel_source(launch_on_cpu, galewsky_c40):
    g, m, dt, step, args = galewsky_c40
    for nu4 in (1.0e14, 1.0e21):
        st = tsc.make_cov_stage_refused_nu4(g, G, OM, dt, nu4)
        before = tsc.CovStageRefusedNu4.launches
        _equal(st(*args, m.b_ext), st.reference(*args, m.b_ext))
        assert tsc.CovStageRefusedNu4.launches == before + 1


@pytest.mark.parametrize("stage", [0, 1], ids=["stage1", "stage2"])
def test_stage_nu4_kernel_sources(launch_on_cpu, galewsky_c40, stage):
    g, m, dt, step, args = galewsky_c40
    a, b = tsc.SSPRK3_COEFFS[stage]
    st = tsc.CovStageNu4(g.n, g.halo, g.dalpha, g.radius, G, OM, dt, a, b,
                         1.0e14, device="cpu")
    h, u, gsn, gwe = args
    a_args = (h, u, gsn, gwe, m.b_ext) if a == 0.0 else (h, u) + args + (
        m.b_ext,)
    before = (tsc.CovStageNu4.launches_a, tsc.CovStageNu4.launches_b)
    out_a = st.call_a(*a_args)
    _equal(out_a, st.reference_a(*a_args))
    b_args = tuple(out_a[:4]) + step.route(out_a[4], out_a[5])
    _equal(st.call_b(*b_args), st.reference_b(*b_args))
    assert (tsc.CovStageNu4.launches_a,
            tsc.CovStageNu4.launches_b) == (before[0] + 1, before[1] + 1)


def _b14_args(g, m, dt, step, args, nu4):
    """A stage-1 in-stage pair at ``nu4``, and kernel B's operands at C40:
    kernel A's outputs on the carry after one split step, and the routed
    ghosts of their strips."""
    st = tsc.CovStageNu4(g.n, g.halo, g.dalpha, g.radius, G, OM, dt, 0.0,
                         1.0, nu4, device="cpu")
    out_a = st.reference_a(*args, m.b_ext)
    return st, tuple(out_a[:4]) + step.route(out_a[4], out_a[5])


@pytest.mark.parametrize("nu4", [1.0e14, 1.0e21], ids=["nu4", "probe"])
@pytest.mark.parametrize("mode", nb.MODES)
def test_stage_nu4_b_ablated_kernel_source(launch_on_cpu, galewsky_c40,
                                           mode, nu4):
    """B14 in each mode, at the harness's nu4 and at a probe's (the
    filter term dominant), bitwise vs its plain version; ``full`` also
    bitwise vs B7's own kernel B."""
    g, m, dt, step, args = galewsky_c40
    st, b_args = _b14_args(g, m, dt, step, args, nu4)
    b = nb.Nu4BisectB(st, mode)
    before = nb.Nu4BisectB.launches
    out = b(*b_args)
    assert nb.Nu4BisectB.launches == before + 1
    _equal(out, b.reference(*b_args))
    if mode == "full":
        _equal(out, st.call_b(*b_args))


def test_stage_nu4_b_ablated_mutation_is_caught(emulated, launch_on_cpu,
                                                 monkeypatch, galewsky_c40):
    """The mutation check of B14: NoFill staging the routed ghosts
    instead of its zero apron must disagree with its plain version."""
    name = "cov_stage_nu4"
    zero = "const int hh = M == BMode::NoFill ? 0 : p.halo;"
    lib = _mutated_lib(emulated, name, zero, "const int hh = p.halo;")
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    g, m, dt, step, args = galewsky_c40
    st, b_args = _b14_args(g, m, dt, step, args, 1.0e21)
    b = nb.Nu4BisectB(st, "nofill")
    out, ref = b(*b_args), b.reference(*b_args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


@pytest.fixture(scope="module")
def tc5_c40():
    """The C40 TC5 model, its state and the state's filled frames."""
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s0 = m.initial_state(h, v)
    return g, m, s0, m.fill(s0["h"]), m._fill_u(s0["u"])


def _rhs_forms(g, m, state):
    """B4's three forms on one state (filled frames, sym rows): the
    six-face classic layout, each face alone (the JAX one-face form), and
    the face tier's stacked form over views of a stacked ``q`` (R, 3, M,
    M) in groups of three.  Returns ``(six, ones, stacked)``, each a list
    of ``(kernel, call, reference, args)``."""
    _, he, ue, ssn, swe = state
    six = tsc.make_cov_rhs_pallas(g, G, OM).kernel
    one = tsc.make_cov_rhs_pallas(g, G, OM, n_faces=1, external_sym=True)
    fz = six.fz[:, None]
    args6 = (fz, he, ue, m.b_ext, ssn, swe)
    ones = [(one, one, one.reference,
             (fz[f:f + 1], he[f:f + 1], ue[:, f:f + 1].contiguous(),
              m.b_ext[f:f + 1], ssn[f:f + 1], swe[f:f + 1]))
            for f in (1, 5)]
    q = torch.cat([he[:, None], ue.transpose(0, 1)], dim=1)
    groups = tsc.RankGroups([(0, 0)] * 6, *(
        t.expand((6,) + tuple(t.shape)) for t in six.coords))
    st_args = (fz, groups, q[:, 0:1], q[:, 1:3].unsqueeze(2),
               m.b_ext[:, None], ssn[:, None], swe[:, None])
    return ([(six, six, six.reference, args6)], ones,
            [(one, one.stacked, one.stacked_reference, st_args)])


@pytest.mark.parametrize("grid", ["c40", "c72"])
def test_rhs_kernel_source(launch_on_cpu, tc5_c40_states, c72_states, grid):
    """B4 in its three forms, from the TC5 state and after a step: the six
    faces, one face, and the stacked form over views of the face tier's
    ``q`` (one launch each), bitwise equal to their plain versions, and
    the stacked form to the six-face form and to each face's one-face
    plain version."""
    g, m, states = tc5_c40_states if grid == "c40" else c72_states
    before = tsc.CovRhs.launches
    for state in states:
        six, ones, stacked = _rhs_forms(g, m, state)
        outs = {}
        for form, cases in (("six", six), ("one", ones),
                            ("stacked", stacked)):
            for kern, call, ref, args in cases:
                out = outs[form] = call(*args)
                _equal(out, ref(*args))
        dh, du = outs["stacked"]
        assert torch.equal(dh[:, 0], outs["six"][0])
        assert torch.equal(du[:, :, 0].transpose(0, 1), outs["six"][1])
        for f, (kern, _, _, args) in zip((1, 5), ones):
            _equal((dh[f], du[f]), kern.reference(*args))
    assert tsc.CovRhs.launches == before + 4 * len(states)


#: B4's operands of one face in its launch (cov_rhs.cu): the mutation swaps
#: the rank stride and the component stride of u, which the six-face
#: layout (M^2, F M^2) and the stacked one (3 M^2, M^2) both tell apart.
_RHS_STRIDES = ("  const float* ua = p.u + r * p.su;\n"
                "  const float* ub = ua + p.cu;\n")
_RHS_STRIDES_SWAPPED = ("  const float* ua = p.u + r * p.cu;\n"
                        "  const float* ub = ua + p.su;\n")


def test_rhs_kernel_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                       tc5_c40_states):
    """B4 with the rank and component strides of u swapped must disagree
    with the plain version in the six-face and the stacked form."""
    lib = _mutated_lib(emulated, "cov_rhs", _RHS_STRIDES,
                       _RHS_STRIDES_SWAPPED)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == "cov_rhs" else emulated[nm])))
    g, m, states = tc5_c40_states
    six, _, stacked = _rhs_forms(g, m, states[1])
    for _, call, ref, args in six + stacked:
        out, expect = call(*args), ref(*args)
        assert not all(torch.equal(x, r) for x, r in zip(out, expect))


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2",
                                                   "stage3"])
def test_stage_inkernel_kernel_source(launch_on_cpu, tc5_c40, stage):
    g, m, s0, h_ext, u_ext = tc5_c40
    step = m.make_fused_step(75.0 * 384 / N, compact=False)
    y0 = m.extend_state(s0, with_strips=True)
    y1 = step(y0, 0.0)
    # Ghost corners the stage must carry through: the halo exchangers'.
    hc = y1["h"].clone()
    uc = y1["u"].clone()
    for q, full in ((hc, h_ext), (uc, u_ext)):
        for c in ((slice(0, 2), slice(0, 2)), (slice(-2, None),) * 2):
            q[(...,) + c] = full[(...,) + c]
    st = step.stages[stage]
    args = (hc, uc, step.route(y1["strips"]), m.b_ext)
    if st.with_y0:
        args = (h_ext, u_ext) + args
    before = tsc.CovStageInkernel.launches
    _equal(st(*args), st.reference(*args))
    assert tsc.CovStageInkernel.launches == before + 1


@pytest.mark.parametrize("stage", [0, 1, 2, 3], ids=[
    "stage1", "stage2", "stage3", "stage3-probe"])
def test_stage_nbr_kernel_source(launch_on_cpu, tc5_c40, stage):
    g, m, s0, h_ext, u_ext = tc5_c40
    step = nbr.make_fused_ssprk3_cov_nbr(g, G, OM, 75.0 * 384 / N, m.b_ext)
    st1, st2, st3 = step.stages
    # The state after a step, by the plain versions: TC5's initial wind
    # has a zero component in places, which hides some operation orders.
    ye = m.extend_state(s0)
    k1 = st1.reference(ye["h"], ye["u"], m.b_ext)
    k2 = st2.reference(ye["h"], ye["u"], *k1, m.b_ext)
    hc, uc = st3.reference(ye["h"], ye["u"], *k2, m.b_ext)
    # Ghost corners the stage must carry through: the halo exchangers'.
    for q, full in ((hc, h_ext), (uc, u_ext)):
        for c in ((slice(0, 2), slice(0, 2)), (slice(-2, None),) * 2):
            q[(...,) + c] = full[(...,) + c]
    st = step.stages[min(stage, 2)]
    args = (hc, uc, m.b_ext)
    if stage == 3:
        # y0 = -2*yc: the interiors are g*L(yc) alone.
        args = (-2.0 * hc, -2.0 * uc) + args
    elif st.with_y0:
        args = (h_ext, u_ext) + args
    before = nbr.CovStageNbr.launches
    _equal(st(*args), st.reference(*args))
    assert nbr.CovStageNbr.launches == before + 1


def _mega_args(kern, m, s0, after):
    """The carry of the C40 TC5 state after ``after`` steps of the plain
    version, with ``b_ext``: TC5's initial wind has a zero component in
    places, which hides some operation orders."""
    y = m.compact_state(s0)
    args = (y["h"], y["u"], y["strips_sn"], y["strips_we"])
    for _ in range(after):
        args = kern.reference(*args, m.b_ext)
    return tuple(args) + (m.b_ext,)


@pytest.mark.parametrize("after", [0, 1], ids=["tc5", "after-a-step"])
def test_step_mega_kernel_source(launch_on_cpu, tc5_c40, after):
    g, m, s0, h_ext, u_ext = tc5_c40
    kern = mega.CovMegaStep(g, G, OM, 75.0 * 384 / N)
    args = _mega_args(kern, m, s0, after)
    before = mega.CovMegaStep.launches
    _equal(kern(*args), kern.reference(*args))
    assert mega.CovMegaStep.launches == before + 1
    # The stand-in occupancy API: 1 block per SM on 8 SMs, a block per
    # work item (2 x 2 tile positions x 2 face groups): the metric terms
    # once per launch; the routed rows fall unevenly on the blocks.
    assert kern.blocks == 8


@pytest.mark.parametrize("after", [0, 2], ids=["tc5", "after-two-steps"])
def test_step_mega_kernel_small_grid(launch_on_cpu, tc5_c40, after):
    """B12 on a grid of fewer blocks than work items (5 for 8): blocks
    take two items in turn and recompute the metric terms per item."""
    g, m, s0, h_ext, u_ext = tc5_c40
    kern = mega.CovMegaStep(g, G, OM, 75.0 * 384 / N, max_blocks=5)
    args = _mega_args(kern, m, s0, after)
    _equal(kern(*args), kern.reference(*args))
    assert kern.blocks == 5


#: Mutations of B12 (cov_step_mega.cu): stage 2 reading stage 1's input
#: (the carry) instead of stage 1's result; a block keeping the metric
#: terms of its first work item for the others.
_MEGA_MUTATIONS = {
    "stage2-reads-stage1-input": (
        "const float* ch = st == 0 ? p.y0h : st == 1 ? p.ho : p.bh;",
        "const float* ch = st == 0 ? p.y0h : st == 1 ? p.y0h : p.bh;"),
    "metric-of-another-item": ("if (mt_item != t) {", "if (mt_item < 0) {"),
}


@pytest.mark.parametrize("mutation", sorted(_MEGA_MUTATIONS))
def test_step_mega_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                      tc5_c40, mutation):
    lib = _mutated_lib(emulated, "cov_step_mega", *_MEGA_MUTATIONS[mutation])
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == "cov_step_mega" else emulated[nm])))
    g, m, s0, h_ext, u_ext = tc5_c40
    kern = mega.CovMegaStep(g, G, OM, 75.0 * 384 / N, max_blocks=5)
    args = _mega_args(kern, m, s0, 1)
    out, ref = kern(*args), kern.reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


@pytest.fixture(scope="module")
def cart_c40():
    """The C40 Cartesian TC5 model (backend 'pallas'), its state, the
    state's filled frames, and the in-kernel carry after one step."""
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = ShallowWater(g, gravity=G, omega=OM, b_ext=b, backend="pallas")
    s0 = m.initial_state(h, v)
    step = m.make_fused_step(75.0 * 384 / N)
    y1 = step(m.extend_state(s0, with_strips=True), 0.0)
    return g, m, s0, m.fill(s0["h"]), m.fill(s0["v"]), step, y1


def test_swe_rhs_kernel_source(launch_on_cpu, cart_c40):
    g, m, s0, h_ext, v_ext, step, y1 = cart_c40
    kern = m._pallas_rhs
    # The state after a step: TC5's initial wind has a zero z-component.
    s1 = m.restrict_state(y1)
    h1, v1 = m.fill(s1["h"]), m.fill(s1["v"])
    before = tsr.SweRhs.launches
    _equal(kern(h1, v1, m.b_ext), kern.reference(h1, v1, m.b_ext))
    # The kernel-backed classic rhs launches it once per call.
    m.rhs(s1, 0.0)
    assert tsr.SweRhs.launches == before + 2


@pytest.mark.parametrize("stage, fast", [(0, True), (1, True), (2, True),
                                         (1, False)],
                         ids=["stage1", "stage2", "stage3", "stage2-general"])
def test_swe_stage_kernel_source(launch_on_cpu, cart_c40, stage, fast):
    g, m, s0, h_ext, v_ext, step, y1 = cart_c40
    a, b = tss.SSPRK3_COEFFS[stage]
    st = tss.make_swe_stage_pallas(g.n, g.halo, g.dalpha, g.radius, G, OM,
                                   75.0 * 384 / N, a, b, fast=fast,
                                   device="cpu")
    ex = m.fill
    hc, vc = ex(m.restrict_state(y1)["h"]), ex(m.restrict_state(y1)["v"])
    args = (hc, vc, m.b_ext) if a == 0.0 else (h_ext, v_ext, hc, vc, m.b_ext)
    before = tss.SweStage.launches
    _equal(st(*args), st.reference(*args))
    assert tss.SweStage.launches == before + 1


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2",
                                                   "stage3"])
def test_swe_stage_inkernel_kernel_source(launch_on_cpu, cart_c40, stage):
    g, m, s0, h_ext, v_ext, step, y1 = cart_c40
    # Ghost corners the stage must carry through: the halo exchanger's.
    hc, vc = y1["h"].clone(), y1["v"].clone()
    for q, full in ((hc, h_ext), (vc, v_ext)):
        for c in ((slice(0, 2), slice(0, 2)), (slice(-2, None),) * 2):
            q[(...,) + c] = full[(...,) + c]
    st = step.stages[stage]
    ghosts = step.route(y1["sh_sn"], y1["sh_we"], y1["sv_sn"], y1["sv_we"])
    args = (hc, vc, ghosts, m.b_ext)
    if st.with_y0:
        args = (h_ext, v_ext) + args
    before = tss.SweStageInkernel.launches
    _equal(st(*args), st.reference(*args))
    assert tss.SweStageInkernel.launches == before + 1



# ---- the faces-in-block redesigns of B11 and B7 A on larger grids ---------
#
# At C72 a face has 3 x 3 tile positions of 32 x 24 (ragged last columns,
# a middle tile whose window reads no ghost); at C74 the last row and
# column of tiles are ragged by 2 and 10 cells.  Edge tiles own B11's ghost
# ring cells and build B7 A's ghost corners.

def _cart_operands(n):
    """The C``n`` Cartesian TC5 model (backend 'pallas'), the in-kernel
    stepper, and the operands of its three stages from the carry after
    one step (TC5's initial wind has an exactly zero z-component): the
    stage-1 frames, and stages 2 and 3 on the plain stage 1's output;
    and B9's and B10's operands from the same carry."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = ShallowWater(g, gravity=G, omega=OM, b_ext=b, backend="pallas")
    step = m.make_fused_step(75.0 * 384 / n)
    y1 = step(m.extend_state(m.initial_state(h, v), with_strips=True), 0.0)
    st1, st2, st3 = step.stages
    a1 = (y1["h"], y1["v"], step.route(y1["sh_sn"], y1["sh_we"],
                                       y1["sv_sn"], y1["sv_we"]), m.b_ext)
    k1 = st1.reference(*a1)
    a2 = (y1["h"], y1["v"], k1[0], k1[1], step.route(*k1[2:]), m.b_ext)
    # B9 and B10 on the same carry's exchanged frames: the RHS, and the
    # concat stages 1-3 (stages 2 and 3 on the plain stage 1's exchanged
    # output) and stage 3 with y0 = -2*yc (the interiors g*L alone).
    step_c = m.make_fused_step(step.stages[0].dt, in_kernel_exchange=False)
    ex = step_c.exchange
    c1, c2, c3 = step_c.stages
    b1 = (ex(y1["h"]), ex(y1["v"]), m.b_ext)
    j1 = c1.reference(*b1)
    b2 = b1[:2] + (ex(j1[0]), ex(j1[1]), m.b_ext)
    b3p = (-2.0 * b2[2], -2.0 * b2[3]) + b2[2:]
    return g, [(st1, a1), (st2, a2), (st3, a2)], (
        (m._pallas_rhs, b1), [(c1, b1), (c2, b2), (c3, b2), (c3, b3p)])


def _tc5_nu4_operands(n):
    """Kernel A's operands, stages 1 and 2, on the C``n`` TC5 state (its
    mountain orography) after one in-stage step at nu4 = 1e14."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b, nu4=1.0e14)
    step = m.make_fused_step(75.0 * 384 / n, nu4_mode="stage")
    y = step(m.compact_state(m.initial_state(h, v)), 0.0)
    gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
    st1, st2 = step.stages[:2]
    a1 = (y["h"], y["u"], gsn, gwe, m.b_ext)
    return [(st1, a1), (st2, (y["h"], y["u"]) + a1)]


@pytest.fixture(scope="module")
def redesign_cases():
    """B11's stages at C72 and C74 (and C24, a tile wider than its face:
    more ghost ring cells than a pass of the block takes), B9's and B10's
    on the same carries, kernel A's on TC5 at C40 and C72."""
    cart = {n: _cart_operands(n) for n in (24, 72, 74)}
    return {"cart": {n: c[:2] for n, c in cart.items()},
            "concat": {n: c[2] for n, c in cart.items()},
            "tc5": {n: _tc5_nu4_operands(n) for n in (40, 72)}}


@pytest.mark.parametrize("n, fast", [(72, True), (74, True), (72, False),
                                     (24, True)],
                         ids=["c72", "c74", "c72-general", "c24"])
def test_swe_stage_inkernel_larger_grids(launch_on_cpu, redesign_cases, n,
                                         fast):
    g, stages = redesign_cases["cart"][n]
    if not fast:   # the general core (rhs_core), stage 2
        st, args = stages[1]
        stages = [(tss.make_swe_stage_inkernel(
            g.n, g.halo, g.dalpha, g.radius, G, OM, st.dt, st.a, st.b,
            fast=False, device="cpu"), args)]
    before = tss.SweStageInkernel.launches
    for st, args in stages:
        _equal(st(*args), st.reference(*args))
    assert tss.SweStageInkernel.launches == before + len(stages)


@pytest.mark.parametrize("n", [40, 72], ids=["c40", "c72"])
def test_stage_nu4_a_kernel_tc5_orography(launch_on_cpu, redesign_cases, n):
    """Kernel A on TC5 (the mountain's orography; the Galewsky jet's is
    zero), stages 1 and 2: bitwise."""
    stages = redesign_cases["tc5"][n]
    before = tsc.CovStageNu4.launches_a
    for st, args in stages:
        _equal(st.call_a(*args), st.reference_a(*args))
    assert tsc.CovStageNu4.launches_a == before + len(stages)


_INK_WINDOW = "const SweWindow& w = sm.w[cur];"
_INK_PREFETCH = "stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);"
_A_CORNERS = "    if (edge) {\n      fill_corners<2>"
_A_XFACES = "return CellMetric{mt.xa[ly][lx],     mt.xb[ly][lx],"


@pytest.mark.parametrize("name, old, new", [
    ("swe_stage_inkernel", _INK_WINDOW, _INK_WINDOW.replace("cur", "cur ^ 1")),
    ("swe_stage_inkernel", _INK_PREFETCH, _INK_PREFETCH.replace("f + 1", "f")),
    ("cov_stage_nu4", _A_CORNERS, _A_CORNERS.replace("edge", "false")),
    ("cov_stage_nu4", _A_XFACES,
     "return CellMetric{mt.xa[ly][lx + 1], mt.xb[ly][lx + 1],")],
    ids=["inkernel-next-window", "inkernel-prefetch-face",
         "nu4a-no-corners", "nu4a-right-xface"])
def test_redesign_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                     redesign_cases, name, old, new):
    """The mutation checks of B11 and B7 A at C72: a face computed from the
    other buffer's window, B11 prefetching the current face's window
    instead of the next one's, A without its ghost-corner average, and A's
    Laplacian taking the right x-face's metric for the left one's: each
    must disagree with the plain version."""
    lib = _mutated_lib(emulated, name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    if name == "swe_stage_inkernel":
        st, args = redesign_cases["cart"][72][1][1]
        out, ref = st(*args), st.reference(*args)
    else:
        st, args = redesign_cases["tc5"][72][1]
        out, ref = st.call_a(*args), st.reference_a(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


# ---- the faces-in-block redesigns of B3 and B7 B (with B14's modes) -------
#
# At C24 one tile is wider than its face; at C72 a face has 3 x 3 tile
# positions of 32 x 24 (ragged last columns; B7 B's middle tile reads no
# ghost, B3's psi window, 4 cells past the tile, reaches the ghosts from
# every tile); at C74 the last row and column of tiles are ragged by 2 and
# 10 cells.  The probe's nu4 (1e21) makes the filter term dominate the
# outputs at these grids (damp max|lap(lap q)| is 30-1 000 x max|q|).

_PROBE_NU4 = 1.0e21


def _refused_operands(n, tc5):
    """The re-fused stage 1 at C``n`` at nu4 = 1e14 and at the probe's, on
    the carry after one re-fused step: the Galewsky jet (its orography
    zero) or TC5 (the mountain's: the Bernoulli band's b)."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    if tc5:
        h, v, b = williamson_tc5(g, G, OM)
        m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b,
                                  nu4=1.0e14)
        dt = 75.0 * 384 / n
    else:
        h, v = galewsky(g, G, OM)
        m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
        dt = 60.0 * 384 / n
    step = m.make_fused_step(dt, nu4_mode="refused")
    y = step(m.compact_state(m.initial_state(h, v)), 0.0)
    args = (y["h"], y["u"]) + step.route(y["strips_sn"],
                                         y["strips_we"]) + (m.b_ext,)
    probe = tsc.make_cov_stage_refused_nu4(g, G, OM, dt, _PROBE_NU4)
    return [(step.stage1f, args), (probe, args)]


def _nu4_b_operands(n):
    """Kernel B's operands at C``n`` on the Galewsky carry after one
    in-stage step, as stages 1 and 2: kernel A's plain outputs and the
    routed ghosts of their l1 strips; each stage at nu4 = 1e14 and at the
    probe's.  Returns ``[(pair, args), ...]``."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    step = m.make_fused_step(60.0 * 384 / n, nu4_mode="stage")
    y = step(m.compact_state(m.initial_state(*galewsky(g, G, OM))), 0.0)
    gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
    cases = []
    for st in step.stages[:2]:
        args = (y["h"], y["u"], gsn, gwe, m.b_ext)
        if st.with_y0:
            args = (y["h"], y["u"]) + args
        out_a = st.reference_a(*args)
        bargs = tuple(out_a[:4]) + step.route(out_a[4], out_a[5])
        probe = tsc.CovStageNu4(g.n, g.halo, g.dalpha, g.radius, G, OM,
                                st.dt, st.a, st.b, _PROBE_NU4, device="cpu")
        cases += [(st, bargs), (probe, bargs)]
    return cases


@pytest.fixture(scope="module")
def nu4_faces_cases():
    """B3's operands on the Galewsky jet and on TC5, and B's, at C24, C72
    and C74."""
    return {n: {"galewsky": _refused_operands(n, False),
                "tc5": _refused_operands(n, True),
                "b": _nu4_b_operands(n)} for n in (24, 72, 74)}


@pytest.mark.parametrize("case", ["galewsky", "tc5"])
@pytest.mark.parametrize("n", [24, 74], ids=["c24", "c74"])
def test_refused_kernel_larger_grids(launch_on_cpu, nu4_faces_cases, n,
                                     case):
    """B3 at nu4 = 1e14 and at the probe's, on the Galewsky jet and on
    TC5's orography: bitwise, strips included."""
    cases = nu4_faces_cases[n][case]
    before = tsc.CovStageRefusedNu4.launches
    for st, args in cases:
        _equal(st(*args), st.reference(*args))
    assert tsc.CovStageRefusedNu4.launches == before + len(cases)


@pytest.mark.parametrize("n", [24, 72, 74], ids=["c24", "c72", "c74"])
def test_stage_nu4_b_larger_grids(launch_on_cpu, nu4_faces_cases, n):
    """B as stages 1 and 2, at nu4 = 1e14 and at the probe's, and B14's
    three modes as stage 2 at the probe's: bitwise equal to their plain
    versions, B14's full mode to B."""
    before = (tsc.CovStageNu4.launches_b, nb.Nu4BisectB.launches)
    cases = nu4_faces_cases[n]["b"]
    for st, args in cases:
        out = st.call_b(*args)
        _equal(out, st.reference_b(*args))
    for mode in nb.MODES:
        b = nb.Nu4BisectB(st, mode)
        got = b(*args)
        _equal(got, b.reference(*args))
        if mode == "full":
            _equal(got, out)
    assert (tsc.CovStageNu4.launches_b, nb.Nu4BisectB.launches) == (
        before[0] + len(cases), before[1] + len(nb.MODES))


#: Mutations of B3 (cov_stage_refused_nu4.cu) and of B (cov_stage_nu4.cu):
#: B3 filtering the ring-1 ghosts too (E then holds filtered values past
#: the face edge); B3 staging the group's first face for every face; B3's
#: stage reading u_b's E as u_a's; B without its ghost-corner average; B
#: computing each face from the other buffer's window.
_B3B_MUTATIONS = {
    "b3-filtered-ghosts": (
        "cov_stage_refused_nu4",
        "if (j < 0 || j >= n || i < 0 || i >= n) return;",
        "if (j < -1 || j > n || i < -1 || i > n) return;"),
    "b3-first-face-psi": (
        "cov_stage_refused_nu4",
        "stage_psi(p, sm.w, f, j0, i0);",
        "stage_psi(p, sm.w, f0, j0, i0);"),
    "b3-wrong-field": (
        "cov_stage_refused_nu4",
        "rows_at<PX>(&psi[1][AP - 1][AP - WOFF]),",
        "rows_at<PX>(&psi[2][AP - 1][AP - WOFF]),"),
    "b-no-corners": (
        "cov_stage_nu4", "if (M != BMode::NoFill && edge) {",
        "if (false) {"),
    "b-next-window": (
        "cov_stage_nu4", "float(*l1)[FTY + 2][WS] = sm.l1[cur];",
        "float(*l1)[FTY + 2][WS] = sm.l1[cur ^ 1];"),
}


@pytest.mark.parametrize("mutation", sorted(_B3B_MUTATIONS))
def test_b3_b_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                 nu4_faces_cases, mutation):
    """Each mutation of B3 or B must disagree with the plain version (B3
    at C74 on TC5 at the probe's nu4, B at C72 as stage 2 at the
    probe's)."""
    name, old, new = _B3B_MUTATIONS[mutation]
    lib = _mutated_lib(emulated, name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    if name == "cov_stage_refused_nu4":
        st, args = nu4_faces_cases[74]["tc5"][1]
        out, ref = st(*args), st.reference(*args)
    else:
        st, args = nu4_faces_cases[72]["b"][3]
        out, ref = st.call_b(*args), st.reference_b(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


# ---- the faces-in-block redesigns of B9 and B10 ----------------------------
#
# The same grids as B11's: at C24 one tile is wider than its face and owns
# more of its faces' ghost ring cells than one pass of the block takes
# (B10); at C72 a middle tile reads no ghost; at C74 the last tiles are
# ragged by 2 and 10 cells.

@pytest.mark.parametrize("n", [24, 72, 74], ids=["c24", "c72", "c74"])
def test_swe_rhs_larger_grids(launch_on_cpu, redesign_cases, n):
    """B9 (the general core, its divisions from the tile's table) on the
    carry after one step: bitwise."""
    (kern, args), _ = redesign_cases["concat"][n]
    before = tsr.SweRhs.launches
    _equal(kern(*args), kern.reference(*args))
    assert tsr.SweRhs.launches == before + 1


@pytest.mark.parametrize("n, fast", [(24, True), (72, True), (74, True),
                                     (24, False), (72, False), (74, False)],
                         ids=["c24", "c72", "c74", "c24-general",
                              "c72-general", "c74-general"])
def test_swe_concat_stage_larger_grids(launch_on_cpu, redesign_cases, n,
                                       fast):
    """B10 in both cores: stages 1-3 and stage 3 with y0 = -2*yc, bitwise,
    the ghost ring included."""
    _, stages = redesign_cases["concat"][n]
    if not fast:   # the general core (rhs_core)
        stages = [(tss.make_swe_stage_pallas(
            st.n, st.halo, st.dalpha, st.radius, G, OM, st.dt, st.a, st.b,
            fast=False, device="cpu"), args) for st, args in stages]
    before = tss.SweStage.launches
    for st, args in stages:
        _equal(st(*args), st.reference(*args))
    assert tss.SweStage.launches == before + len(stages)


_RHS_WINDOW = "sm.w[cur], sm.bt, sm.s,"
_RHS_PREFETCH = "stage_frame_window(sm.w[cur ^ 1], p.h, p.v, p.b, f + 1,"
_RHS_TABLE = "if constexpr (table) return mt.idet_x[ly][lf];"
_CAT_WINDOW = "const SweWindow& w = sm.w[cur];"
_CAT_PREFETCH = "stage_frame_window(sm.w[cur ^ 1], p.hc, p.vc, p.b, f + 1,"
_CAT_RING = "p.a * (fi == 0 ? p.h0 : p.v0)[c] + p.bcoef * rc.yc[fi]"


@pytest.mark.parametrize("name, old, new", [
    ("swe_rhs", _RHS_WINDOW, _RHS_WINDOW.replace("cur", "cur ^ 1")),
    ("swe_rhs", _RHS_PREFETCH, _RHS_PREFETCH.replace("f + 1", "f")),
    ("swe_rhs", _RHS_TABLE, _RHS_TABLE.replace("[lf]", "[lf + 1]")),
    ("swe_stage", _CAT_WINDOW, _CAT_WINDOW.replace("cur", "cur ^ 1")),
    ("swe_stage", _CAT_PREFETCH, _CAT_PREFETCH.replace("f + 1", "f")),
    ("swe_stage", _CAT_RING, "p.bcoef * rc.yc[fi]")],
    ids=["rhs-next-window", "rhs-prefetch-face", "rhs-table-next-xface",
         "concat-next-window", "concat-prefetch-face", "concat-ring-no-y0"])
def test_b9_b10_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                   redesign_cases, name, old, new):
    """The mutation checks of B9 and B10 at C72: a face computed from the
    other buffer's window; the current face's window prefetched instead
    of the next one's; B9's x-face division read from the next x-face's
    table entry; B10's ghost ring stored without its a*y0 term (stage 2).
    Each must disagree with the plain version."""
    lib = _mutated_lib(emulated, name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    (kern, rargs), stages = redesign_cases["concat"][72]
    call, args = (kern, rargs) if name == "swe_rhs" else stages[1]
    out, ref = call(*args), call.reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


# ---- the faces-in-block redesigns of B8 and B13 ----------------------------
#
# At C72 a face has 3 x 3 tile positions of 32 x 24 (ragged last columns, a
# middle tile whose window reads no ghost); at C74 the last row and column
# of tiles are ragged by 2 and 10 cells; at C65 the last column of tiles is
# one cell wide, so B8's E strips fall on two tiles; at C24 one tile is
# wider than its face and owns all of its faces' ghost ring cells, more
# than one pass of the block takes.  Edge tiles own the ring cells and, in
# B13, compute the sym rows and rotate the u ghosts.


def _exchanged_corners(m, y):
    """The whole blocks of carry ``y`` with their four ghost corners from
    the halo exchangers' frames of its interiors: corners the stages must
    carry through, not the zeros or copies a stepper may leave."""
    s = m.restrict_state(y)
    out = []
    for q, full in ((y["h"], m.fill(s["h"])), (y["u"], m._fill_u(s["u"]))):
        q = q.clone()
        for c in itertools.product((slice(0, 2), slice(-2, None)), repeat=2):
            q[(...,) + c] = full[(...,) + c]
        out.append(q)
    return out


def _whole_block_operands(n):
    """B8's and B13's steppers at C``n`` TC5 and the operands of their
    stages 1-3 and of stage 3 with y0 = -2*yc (the interiors g*L alone),
    on the carry after one step of the plain stages (TC5's initial wind
    has a zero component in places, which hides some operation orders):
    ``{"B8": [(stage, args), ...], "B13": [...]}``."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s0 = m.initial_state(h, v)
    dt = 75.0 * 384 / n
    ext = m.make_fused_step(dt, compact=False)
    y1 = ext(m.extend_state(s0, with_strips=True), 0.0)
    hc, uc = _exchanged_corners(m, y1)
    st1, st2, st3 = ext.stages
    a1 = (hc, uc, ext.route(y1["strips"]), b)
    k1 = st1.reference(*a1)
    rest = (k1[0], k1[1], ext.route(k1[2]), b)
    cases = {"B8": [(st1, a1), (st2, (hc, uc) + rest), (st3, (hc, uc) + rest),
                    (st3, (-2.0 * k1[0], -2.0 * k1[1]) + rest)]}
    step = nbr.make_fused_ssprk3_cov_nbr(g, G, OM, dt, b)
    hc, uc = _exchanged_corners(m, step(m.extend_state(s0), 0.0))
    st1, st2, st3 = step.stages
    k1 = st1.reference(hc, uc, b)
    rest = tuple(k1) + (b,)
    cases["B13"] = [(st1, (hc, uc, b)), (st2, (hc, uc) + rest),
                    (st3, (hc, uc) + rest),
                    (st3, (-2.0 * k1[0], -2.0 * k1[1]) + rest)]
    return cases


@pytest.fixture(scope="module")
def whole_block_cases():
    return {n: _whole_block_operands(n) for n in (24, 65, 72, 74)}


_WHOLE_BLOCK = {"B8": ("cov_stage_inkernel", tsc.CovStageInkernel),
                "B13": ("cov_stage_nbr", nbr.CovStageNbr)}


@pytest.mark.parametrize("n", [24, 65, 72, 74],
                         ids=["c24", "c65", "c72", "c74"])
@pytest.mark.parametrize("kernel", ["B8", "B13"])
def test_whole_block_stage_kernels_larger_grids(launch_on_cpu,
                                                 whole_block_cases, kernel,
                                                 n):
    """B8 and B13, stages 1-3 and the stage-3 probe, one launch each:
    bitwise equal to their plain versions."""
    cls = _WHOLE_BLOCK[kernel][1]
    stages = whole_block_cases[n][kernel]
    before = cls.launches
    for st, args in stages:
        _equal(st(*args), st.reference(*args))
    assert cls.launches == before + len(stages)


_WB_WINDOW = "const StageWindow& w = sm.w[cur];"
_WB_PREFETCH = "stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);"
_NBR_GHOSTS = "ghost_load(p, gu, f + 1, j0, i0, gq);"
_NBR_T = "g.ta = t_at(p, 2 * comp, f, a.s, 0, a.k);"
_NBR_SYM = ("const SymRows rows{&sm.sym[q][0][0] - i0, "
            "&sm.sym[q][1][0] - i0,")


@pytest.mark.parametrize("kernel, old, new", [
    ("B8", _WB_WINDOW, _WB_WINDOW.replace("cur", "cur ^ 1")),
    ("B8", _WB_PREFETCH, _WB_PREFETCH.replace("f + 1", "f")),
    ("B13", _WB_WINDOW, _WB_WINDOW.replace("cur", "cur ^ 1")),
    ("B13", _WB_PREFETCH, _WB_PREFETCH.replace("f + 1", "f")),
    ("B13", _NBR_GHOSTS, _NBR_GHOSTS.replace("f + 1", "f")),
    ("B13", _NBR_T, _NBR_T.replace("2 * comp,", "2 * comp + 1,")),
    ("B13", _NBR_SYM, _NBR_SYM.replace("[0][0]", "[9][0]")
     .replace("[1][0]", "[0][0]").replace("[9][0]", "[1][0]"))],
    ids=["b8-next-window", "b8-prefetch-face", "b13-next-window",
         "b13-prefetch-face", "b13-ghost-prefetch-face", "b13-wrong-t",
         "b13-sym-s-n-swapped"])
def test_whole_block_mutation_is_caught(emulated, launch_on_cpu, monkeypatch,
                                        whole_block_cases, kernel, old, new):
    """The mutation checks of B8 and B13 at C72, stage 2: a face computed
    from the other buffer's window; the next face's window (or B13's u
    ghosts) prefetched for the current face; B13's u ghosts rotated with
    the wrong T entry; B13's S and N sym rows swapped.  Each must disagree
    with the plain version."""
    name = _WHOLE_BLOCK[kernel][0]
    lib = _mutated_lib(emulated, name, old, new)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    st, args = whole_block_cases[72][kernel][1]
    out, ref = st(*args), st.reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


# ---- the sharded tiers' block kernels: B5 and B6 --------------------------

#: The group's coordinate operands of the two block kernels (cov_faces.cuh's
#: rhs_group, which both include); the mutation hands the tile the block's
#: columns as its rows and the rows as its columns, which only a sub-face
#: block can tell apart.
_BLOCK_COORDS = ("  const float* xr = p.xr + rows;\n"
                 "  const float* xfr = p.xfr + rows;\n"
                 "  const float* yc = p.yc + rows;\n"
                 "  const float* yfc = p.yfc + rows;\n")
_BLOCK_COORDS_SWAPPED = ("  const float* xr = p.yc + rows;\n"
                         "  const float* xfr = p.yfc + rows;\n"
                         "  const float* yc = p.xr + rows;\n"
                         "  const float* yfc = p.xfr + rows;\n")


@pytest.fixture(scope="module")
def tc5_c40_states(tc5_c40):
    """The C40 TC5 state and the state after one classic step, each with
    its filled frames and sym rows: TC5's initial wind has a zero
    component in places, which hides some operation orders."""
    g, m, s0, h_ext, u_ext = tc5_c40
    s1 = m.make_step(75.0 * 384 / N)(s0, 0.0)
    out = []
    for s, he, ue in ((s0, h_ext, u_ext),
                      (s1, m.fill(s1["h"]), m._fill_u(s1["u"]))):
        out.append((s, he, ue) + tuple(tsc.sym_edge_normals(g, ue)))
    return g, m, out


def _blocks(g, m, state, s, cores=False):
    """Every (face, iy, ix) block of the s x s split of ``g``, in the
    tiers' rank order: the interior windows (``cores``) or the extended
    blocks, with the block's coordinate rows and columns, frame z and
    seeded sym strips."""
    import numpy as np

    st, he, ue, ssn, swe = state
    n, h = g.n // s, g.halo
    xr, xfr, yc, yfc, frames = tsr.coord_rows(g.n, h, "cpu")
    fz = frames[:, None, :, 2].contiguous()
    rng = np.random.default_rng(7)
    for f in range(6):
        for iy in range(s):
            for ix in range(s):
                if cores:
                    ry = slice(h + iy * n, h + (iy + 1) * n)
                    rx = slice(h + ix * n, h + (ix + 1) * n)
                    yield (fz[f:f + 1], xr[:, rx].contiguous(),
                           xfr[:, rx].contiguous(), yc[ry].contiguous(),
                           yfc[ry].contiguous(),
                           he[f:f + 1, ry, rx].contiguous(),
                           ue[:, f:f + 1, ry, rx].contiguous(),
                           m.b_ext[f:f + 1, ry, rx].contiguous())
                    continue
                ry = slice(iy * n, iy * n + n + 2 * h)
                rx = slice(ix * n, ix * n + n + 2 * h)
                sym = [torch.from_numpy(rng.standard_normal(sh).astype(
                    "float32")) for sh in ((1, 2, n), (1, n, 2))]
                if s == 1:
                    sym = [ssn[f:f + 1], swe[f:f + 1]]
                yield (fz[f:f + 1], xr[:, rx].contiguous(),
                       xfr[:, rx].contiguous(), yc[ry].contiguous(),
                       yfc[ry].contiguous(), he[f:f + 1, ry, rx].contiguous(),
                       ue[:, f:f + 1, ry, rx].contiguous(),
                       m.b_ext[f:f + 1, ry, rx].contiguous(), *sym)


@pytest.mark.parametrize("s", [1, 2], ids=["face", "2x2-block"])
def test_rhs_interior_kernel_source(launch_on_cpu, tc5_c40_states, s):
    g, m, states = tc5_c40_states
    kern = tsc.make_cov_rhs_interior_local(g.n // s, g.halo, g.dalpha,
                                           g.radius, G, OM, device="cpu")
    before = tsc.CovRhsInterior.launches
    count = 0
    for state in states:
        for args in _blocks(g, m, state, s, cores=True):
            _equal(kern(*args), kern.reference(*args))
            count += 1
    assert tsc.CovRhsInterior.launches == before + count == before + 12 * s * s


@pytest.mark.parametrize("s", [1, 2], ids=["face", "2x2-block"])
def test_rhs_local_kernel_source(launch_on_cpu, tc5_c40_states, s):
    g, m, states = tc5_c40_states
    kern = tsc.make_cov_rhs_pallas_local(g.n // s, g.halo, g.dalpha,
                                         g.radius, G, OM, device="cpu")
    one = tsc.make_cov_rhs_pallas(g, G, OM, n_faces=1, external_sym=True)
    before = tsc.CovRhsLocal.launches
    for state in states:
        for args in _blocks(g, m, state, s):
            out = kern(*args)
            _equal(out, kern.reference(*args))
            if s == 1:
                # A whole face's rows and columns: B4's one-face form.
                _equal(out, one.reference(args[0], *args[5:]))
    assert tsc.CovRhsLocal.launches == before + 12 * s * s


@pytest.mark.parametrize("name", ["cov_rhs_interior", "cov_rhs_local"])
def test_block_kernel_mutation_is_caught(emulated, launch_on_cpu,
                                         monkeypatch, tc5_c40_states, name):
    """The mutation check of both block kernels: rows and columns
    swapped in the tile's coordinates must disagree with the plain
    version on a sub-face block."""
    lib = _mutated_lib(emulated, name, _BLOCK_COORDS, _BLOCK_COORDS_SWAPPED)
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    g, m, states = tc5_c40_states
    s = 2
    cores = name == "cov_rhs_interior"
    make = (tsc.make_cov_rhs_interior_local if cores
            else tsc.make_cov_rhs_pallas_local)
    kern = make(g.n // s, g.halo, g.dalpha, g.radius, G, OM, device="cpu")
    # Block (face 0, iy 0, ix 1): its alpha rows are not its beta columns.
    args = list(_blocks(g, m, states[1], s, cores=cores))[1]
    out, ref = kern(*args), kern.reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


# ---- B5 and B6 stacked: one launch over a tier's ranks ---------------------
#
# The tiers' layout: rank (f * s + iy) * s + ix holds block (f, iy, ix);
# the ranks at one block position form groups of up to three.  At C40 and
# s = 2 a block is 20 cells wide (one ragged tile, B5's core 16); at C72 it
# is 36 (2 x 2 tiles, ragged by 4 and 12; B5's core 32 x 32, ragged along
# beta).  The subset holds five ranks at one position and one at another:
# groups of 3, 2 and 1.

#: Ranks of the 2 x 2 split in groups of 3, 2 and 1 (positions (0, 0) x 5
#: and (0, 1) x 1).
_SUBSET = [0, 4, 8, 12, 16, 1]


def _stacked_args(g, m, state, s, cores, ranks):
    """The stacked operands of ``ranks`` of the s x s split: ``(fz,
    groups, fields...)`` as the tiers pass them, with the groups built as
    the tiers build them."""
    blocks = list(_blocks(g, m, state, s, cores=cores))
    per = [blocks[r] for r in ranks]
    cat = lambda k: torch.cat([b[k] for b in per])
    keys = [((r // s) % s, r % s) for r in ranks]
    groups = tsc.RankGroups(keys, *(torch.stack([b[k] for b in per])
                                    for k in (1, 2, 3, 4)))
    fields = (cat(5)[:, None], torch.stack([b[6] for b in per]),
              cat(7)[:, None])
    if not cores:
        fields += (torch.stack([b[8] for b in per]),
                   torch.stack([b[9] for b in per]))
    return (cat(0), groups) + fields, per


@pytest.fixture(scope="module")
def c72_states():
    """C72 TC5, its state and the state after one classic step, with
    their filled frames and sym rows."""
    g = build_grid(72, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s0 = m.initial_state(h, v)
    s1 = m.make_step(75.0 * 384 / 72)(s0, 0.0)
    out = []
    for st in (s0, s1):
        he, ue = m.fill(st["h"]), m._fill_u(st["u"])
        out.append((st, he, ue) + tuple(tsc.sym_edge_normals(g, ue)))
    return g, m, out


def _stacked_kernel(g, s, cores):
    make = (tsc.make_cov_rhs_interior_local if cores
            else tsc.make_cov_rhs_pallas_local)
    return make(g.n // s, g.halo, g.dalpha, g.radius, G, OM, device="cpu")


@pytest.mark.parametrize("cores", [True, False], ids=["B5", "B6"])
@pytest.mark.parametrize("grid, s, ranks, sizes", [
    ("c40", 2, None, [3] * 8), ("c72", 2, None, [3] * 8),
    ("c40", 2, _SUBSET, [3, 2, 1]), ("c72", 2, _SUBSET, [3, 2, 1]),
    ("c40", 1, None, [3, 3])],
    ids=["c40-24", "c72-24", "c40-groups-3-2-1", "c72-groups-3-2-1",
         "c40-faces"])
def test_stacked_block_kernels_source(launch_on_cpu, tc5_c40_states,
                                      c72_states, grid, s, ranks, sizes,
                                      cores):
    """B5 and B6 over a stack of ranks, one launch per call, from the TC5
    state and after a step: the 2 x 2 split's 24 ranks, a subset of them
    in groups of 3, 2 and 1, and the six whole faces (the face tier's
    form): bitwise equal to the stacked plain version and to the
    per-block plain version of every rank."""
    g, m, states = tc5_c40_states if grid == "c40" else c72_states
    ranks = list(range(6 * s * s)) if ranks is None else ranks
    kern = _stacked_kernel(g, s, cores)
    cls = type(kern)
    for state in states:
        args, per = _stacked_args(g, m, state, s, cores, ranks)
        assert [len(grp) for grp in args[1].ranks] == sizes
        before = cls.launches
        out = kern.stacked(*args)
        assert cls.launches == before + 1
        _equal(out, kern.stacked_reference(*args))
        for i, a in enumerate(per):
            _equal((out[0][i], out[1][i]), kern.reference(*a))


#: The stacked kernels' group loop (cov_faces.cuh's rhs_group): its first
#: rank's window, the group's rows, the double buffer.  The mutations stage
#: the group's second rank's fields for its first, read every group with
#: the first group's rows (another block position's), and compute each
#: rank from the other buffer.
_GROUP_MUTATIONS = {
    "swapped-rank": ("stage_rank_window(p, sm.w[0], ranks[0], j0, i0);",
                     "stage_rank_window(p, sm.w[0], ranks[1], j0, i0);"),
    "wrong-position-rows": ("const long rows = (long)g * m;",
                            "const long rows = 0;"),
    "swapped-buffer": ("const StageWindow& w = sm.w[cur];",
                       "const StageWindow& w = sm.w[cur ^ 1];"),
}


@pytest.mark.parametrize("name", ["cov_rhs_interior", "cov_rhs_local"])
@pytest.mark.parametrize("mutation", sorted(_GROUP_MUTATIONS))
def test_stacked_kernel_mutation_is_caught(emulated, launch_on_cpu,
                                           monkeypatch, c72_states, name,
                                           mutation):
    """Each mutation of the group loop must disagree with the plain
    version over the 24 ranks of the 2 x 2 split at C72 (groups of
    three)."""
    lib = _mutated_lib(emulated, name, *_GROUP_MUTATIONS[mutation])
    monkeypatch.setattr(_build, "load", lambda nm: ctypes.CDLL(
        str(lib if nm == name else emulated[nm])))
    g, m, states = c72_states
    cores = name == "cov_rhs_interior"
    kern = _stacked_kernel(g, 2, cores)
    args, _ = _stacked_args(g, m, states[1], 2, cores, list(range(24)))
    out, ref = kern.stacked(*args), kern.stacked_reference(*args)
    assert not all(torch.equal(x, r) for x, r in zip(out, ref))


def test_whole_face_kernels_pass_rows_as_columns():
    """The faces-in-block design's stage_metric and stage_face_tile take
    separate row and column coordinates (centres and faces along i, then
    along j); every kernel of whole faces passes its one coordinate pair
    as both (the re-fused stage calls stage_face_tile alone: its metric
    terms come from lap_metric and its own band metric, which take the
    face's one pair), the group kernels their groups' own rows and
    columns: the two block kernels through cov_faces.cuh's rhs_group, B4
    through its own group loop (its wrapper hands every group the
    full-face pair as rows and columns)."""
    sources = {name: (_build.CSRC_DIR / fname).read_text()
               for name, fname in _build.KERNELS.items()}
    sources["cov_faces.cuh"] = (_build.CSRC_DIR / "cov_faces.cuh").read_text()
    calls = {}
    for name, src in sources.items():
        for mt in re.finditer(
                r"(?m)^\s+(advective_tile<|stage_metric\(|stage_face_tile<)"
                r".*?\);", src, re.S):
            args = re.sub(r"\s+", " ", mt.group(0))
            fn = mt.group(1).rstrip("<(")
            calls.setdefault(name, {}).setdefault(fn, []).append(args)
    faces_in_block = {"cov_stage": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_stage_refused_nu4": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_stage_nu4": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_stage_inkernel": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_stage_nbr": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_step_mega": "p.xc, p.xf, p.xc, p.xf,",
                      "cov_rhs": " xr, xfr, yc, yfc,",
                      "cov_faces.cuh": " xr, xfr, yc, yfc,"}
    assert sorted(calls) == sorted(faces_in_block)
    for name, fns in calls.items():
        want = (["stage_face_tile"] if name == "cov_stage_refused_nu4"
                else ["stage_face_tile", "stage_metric"])
        assert sorted(fns) == want, (name, fns)
        for fn in want:
            assert len(fns[fn]) == 1, (name, fn)
            assert faces_in_block[name] in fns[fn][0], (name, fns[fn][0])
    for name, seam in (("cov_rhs_interior", "None"),
                       ("cov_rhs_local", "Frame")):
        assert sources[name].count(f"rhs_group<Seam::{seam}>(p, sm,") == 1
    for name, seam in (("cov_rhs", "Frame"), ("cov_step_mega", "FrameCg"),
                       ("cov_stage_refused_nu4", "Prescaled"),
                       ("cov_stage_inkernel", "Frame"),
                       ("cov_stage_nbr", "Frame")):
        assert calls[name]["stage_face_tile"][0].count(
            f"stage_face_tile<Seam::{seam}>(") == 1
