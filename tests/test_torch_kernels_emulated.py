"""The CUDA kernel sources against their plain versions, on the CPU.

The kernels under ``jaxstream_torch/csrc/`` are compiled here by the host
C++ compiler (g++) instead of nvcc, through a small stand-in for
``cuda_runtime.h``: ``__shared__`` arrays become statics, each block runs
as 256 host threads with a real barrier for ``__syncthreads``, and blocks
run one after another.  A cooperative launch (the whole-step kernel's,
``cudaLaunchCooperativeKernel``) runs all its blocks' threads at once
instead, each block with its own barrier and its own arena for the
dynamic shared memory, and ``this_grid().sync()`` waits on a grid-wide
barrier; the stand-in occupancy API gives a grid of 5 blocks.  The
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
import re
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from jaxstream_torch import _build
from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 5;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* nb, F, int, size_t) {
  *nb = 1;
  return 0;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __ldcg(const float* p) { return *p; }
inline thread_local pthread_barrier_t* emu_block_barrier;
inline thread_local void* emu_dyn_smem;
inline pthread_barrier_t emu_grid_barrier;
inline void __syncthreads() { pthread_barrier_wait(emu_block_barrier); }
template <class K, class P>
void emu_launch(K kernel, dim3 grid, dim3 block, const P& p) {
  const unsigned nt = block.x * block.y * block.z;
  pthread_barrier_t bar;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        pthread_barrier_init(&bar, nullptr, nt);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([=, &p, &bar]() {
            threadIdx = {t % block.x, (t / block.x) % block.y,
                         t / (block.x * block.y)};
            blockIdx = {bx, by, bz};
            blockDim = {block.x, block.y, block.z};
            gridDim = {grid.x, grid.y, grid.z};
            emu_block_barrier = &bar;
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{kernel name: host library}``, every kernel of ``_build.KERNELS``
    compiled by g++ in parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_runtime.h").write_text(_SHIM)
    (out / "cooperative_groups.h").write_text(_CG_SHIM)

    def build(name):
        src = (_build.CSRC_DIR / _build.KERNELS[name]).read_text()
        src = re.sub(r"(\w+)<<<\s*(\w+),\s*(\w+),.*?>>>\((\w+)\)",
                     r"emu_launch(\1, \2, \3, \4)", src, flags=re.S)
        # Dynamic shared memory: the block's arena.
        src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                     r"\1* \2 = static_cast<\1*>(emu_dyn_smem);", src)
        cpp, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        cpp.write_text(src)
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", f"-I{out}", f"-I{_build.CSRC_DIR}",
             "-o", str(lib), str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return name, lib

    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        return dict(pool.map(build, _build.KERNELS))


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


@pytest.fixture(scope="module")
def tc5_c40():
    """The C40 TC5 model, its state and the state's filled frames."""
    g = build_grid(N, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s0 = m.initial_state(h, v)
    return g, m, s0, m.fill(s0["h"]), m._fill_u(s0["u"])


def test_rhs_kernel_source(launch_on_cpu, tc5_c40):
    g, m, s0, h_ext, u_ext = tc5_c40
    rhs = tsc.make_cov_rhs_pallas(g, G, OM)
    kern = rhs.kernel
    sym = tsc.sym_edge_normals(g, u_ext)
    before = tsc.CovRhs.launches
    _equal(rhs(h_ext, u_ext, m.b_ext),
           kern.reference(kern.fz[:, None], h_ext, u_ext, m.b_ext, *sym))
    one = tsc.make_cov_rhs_pallas(g, G, OM, n_faces=1, external_sym=True)
    for f in (1, 5):
        args = (kern.fz[f:f + 1, None], h_ext[f:f + 1],
                u_ext[:, f:f + 1].contiguous(), m.b_ext[f:f + 1],
                sym[0][f:f + 1], sym[1][f:f + 1])
        _equal(one(*args), one.reference(*args))
    assert tsc.CovRhs.launches == before + 3


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


@pytest.mark.parametrize("after", [0, 1], ids=["tc5", "after-a-step"])
def test_step_mega_kernel_source(launch_on_cpu, tc5_c40, after):
    g, m, s0, h_ext, u_ext = tc5_c40
    kern = mega.CovMegaStep(g, G, OM, 75.0 * 384 / N)
    y = m.compact_state(s0)
    args = (y["h"], y["u"], y["strips_sn"], y["strips_we"])
    for _ in range(after):      # the plain version's step
        args = kern.reference(*args, m.b_ext)
    args = tuple(args) + (m.b_ext,)
    before = mega.CovMegaStep.launches
    _equal(kern(*args), kern.reference(*args))
    assert mega.CovMegaStep.launches == before + 1
    # The stand-in occupancy API: 1 block per SM on 5 SMs, so the 36
    # tiles and the routed rows fall unevenly on the blocks.
    assert kern.blocks == 5


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
