"""Probe the faces-in-block kernels on one GPU: the compact stage (B1), the
split del^4 filter (B2), the whole-step kernel (B12), the RHS of
ghost-filled faces (B4), the Cartesian in-kernel stage (B11), the
in-stage del^4 kernels A and B (B7; B14, B's modes), the neighbour-read
stage (B13), the extended-carry stage (B8), the Cartesian RHS and concat
stage (B9, B10) and the re-fused del^4 stage (B3), an earlier tree's
against this tree's, in turns, with ablations of the earlier B1 and
levers of B12, B11, B7 A, B13, B8, B9, B10, B3 and B7 B.

    git archive <commit> jaxstream_torch/csrc | tar -x -C build/jaxstream_torch/parent
    python3 scripts/torch_faces_probe.py [--n N] [--mega DIR] [--parts P,...] build/jaxstream_torch/parent [OTHER ...]

``--parts`` picks what runs (default all): ``b1b2`` (B1, B2 and the
OTHER variants), ``b12``, ``b4``, ``b11b7a``, ``b13b8``, ``b9b10``,
``b3b7b``.  ``--ink DIR``,
``--nu4a DIR``, ``--nbr DIR`` and ``--ext DIR`` add variant .cu files of
this tree's ``swe_stage_inkernel.cu``, ``cov_stage_nu4.cu``,
``cov_stage_nbr.cu`` and ``cov_stage_inkernel.cu`` (built against this
tree's headers) to B11's, B7 A's, B13's and B8's turns under their file
names; they may be ablations, so their bitwise checks do not decide the
exit code.

Each OTHER is a further directory holding a ``jaxstream_torch/csrc`` (a
variant of this tree's two kernels), timed in the same turns under its
directory's name.  The earlier sources are built with this tree's nvcc flags
(``jaxstream_torch._build.NVCC_FLAGS``) into ``build/jaxstream_torch/
probe/``.  The ablations, where the earlier ``cov_stage.cu`` is of the
tile-per-block design (one 32 x 16 tile of one face per block), rewrite
it, keeping its staging of the window and its loads and stores, and
replacing the right-hand side:

* ``staging``: the window staged, then each output the staged centre
  plus y0 and b (no arithmetic of the stage);
* ``staging+metric``: as ``staging``, and the closed-form metric terms
  advective_tile computes per face (band g_aa/g_ab/g_bb, the face
  metrics, the center sqrtg / inv_sqrtg / inv_rho), folded into the
  outputs as ``0 * sum`` so nothing is dead;
* ``full``: the earlier kernel as it is.

B12's forms (all on the same carry; the variants are this tree's
``cov_step_mega.cu`` rewritten into ``build/jaxstream_torch/probe/``):

* ``parent``: the earlier tree's B12 (its tile-per-block design);
* ``shared tid``: this tree's with the thread index read as threadIdx
  (``COV_OPAQUE_TID`` not defined), which the compiler shares across the
  face phases' runs;
* ``metric per stage``: this tree's, the metric terms recomputed for
  every item of every stage;
* ``new``: this tree's (the metric once per launch);
* ``routes only``: this tree's with the face phases taken out: the three
  route phases and the grid barriers alone (timing only);
* each ``DIR/*.cu`` of ``--mega DIR``: a variant of this tree's
  ``cov_step_mega.cu`` (built against this tree's headers), under its
  file name.

B4's forms: the six-face classic layout (earlier vs this tree's), and
one RK stage of the face tier's serialized form: six one-face launches
of the earlier kernel against one stacked launch of this tree's, on
views of the tier's stacked ``q``.

B11's and B7 A's forms (``b11b7a``; the levers are this tree's sources
rewritten, ``redesign_levers``):

* ``parent``: the earlier tree's kernel;
* ``metric per face`` (B11): this tree's with fast_frame evaluated in
  place at every band cell, face and centre of every face instead of
  rebuilt from the tile's tables;
* ``lap in epilogue`` (B7 A): this tree's with the Laplacian inside the
  advective tile's epilogue instead of a pass of its own;
* ``new``: this tree's.

B11 on the Cartesian TC5 carry after 20 in-kernel steps, stages 1 and 2;
A on the Galewsky carry after one in-stage step, stages 1 and 2.  Each
step (the Cartesian in-kernel one, the in-stage one) is also timed with
the parent's and this tree's kernel in turns: device µs per step as a
CUDA graph of 20 steps, the host's issue time per step (the host clock
around 20 steps enqueued, before the synchronise), and wall steps/s over
200 steps.

B13's and B8's forms (``b13b8``; the levers are this tree's sources
rewritten, ``b13b8_levers``):

* ``parent``: the earlier tree's kernel;
* ``ring after window`` (both): the ring's loads issued after the first
  window's copies instead of ahead of them;
* ``sym after window`` (B13): the sym rows' loads issued after the first
  window's copies;
* ``ghosts unstaged`` (B13): each face's u ghosts loaded and stored into
  the window at once, before the face's arithmetic, instead of held in
  registers over it;
* ``no ring`` (both; an ablation, timing only): the ghost ring not
  written;
* ``W/E strips staged`` (B8; halo <= 4): the W/E strip values put into
  shared memory and stored as coalesced strip rows after each face's
  closing barrier, instead of at once from the epilogue, strided;
* ``no W/E strips`` (B8; an ablation, timing only): the W/E strip stores
  left out;
* ``new``: this tree's.

B13 on the nbr TC5 carry after 20 steps, B8 on the extended carry after
20 steps, stages 1-3.  The nbr and extended steps are also timed with the
parent's and this tree's kernel in turns: device µs per step as a CUDA
graph of 20 steps, and for nbr the host's issue time per step and wall
steps/s over 200 steps.  The SASS counts of the kernels ``SASS_KEPT``
names are printed beside the earlier tree's.

B9's and B10's forms (``b9b10``; the levers are this tree's sources
rewritten, ``b9b10_levers``):

* ``parent``: the earlier tree's kernel;
* ``basis per face`` (B9): the general basis's divisions computed at
  every face and centre of every face instead of once per tile
  (``SweBasis``);
* ``ring loads ahead`` (B10): the ring's first pass loaded ahead of the
  first window's copies and stored after them (B11's order) instead of
  loaded and stored after the copies;
* ``no ring`` (B10; an ablation, timing only): the ghost ring not
  written;
* ``new``: this tree's.

Both on the Cartesian TC5 state after 20 in-kernel steps, exchanged: B9
once, B10 stages 1-3 and the general core's stage 2.  The classic
(``backend: pallas``) and concat steps are also timed with the parent's
and this tree's kernel in turns: device µs per step as a CUDA graph of 20
steps, and wall steps/s over 100 steps.  The SASS counts of the kernels
``SASS_KEPT`` names are printed beside the earlier tree's.

B3's, B7 B's and B14's forms (``b3b7b``; the levers are this tree's
sources rewritten, ``b3b7b_levers``):

* ``parent``: the earlier tree's kernel;
* ``psi double-buffered, 2/SM`` (B3): the next face's psi (and band b)
  staged into a second buffer during this face's work (88 KB of shared
  memory, ``__launch_bounds__(256, 2)``) instead of after its stage;
* ``u on tile + 2`` (B3): u_a and u_b filtered on tile + 2 and their l1
  computed on tile + 3, as h's (``EU = 2``), where the stage reads u on
  tile + 1 only;
* ``no filter`` (B3; an ablation, timing only): the l1 and E passes
  taken out, the stage run on psi;
* ``adv after the wait`` (B7 B): adv loaded after the window's wait
  (kernel A's order for y0) instead of while the copies are in flight;
* ``fields unrolled`` (B7 B): the loop over the three fields unrolled,
  which takes Full from 80 registers and a 20 B spill to 68 and none;
* ``new``: this tree's.

B3 on the Galewsky carry after one re-fused step (also bitwise on TC5's
carry after one, and with a probe's nu4), B7 B as stages 1 and 2 on the
Galewsky carry after one in-stage step, B14's modes as stage 1 (parent
and new).  The re-fused and in-stage steps are also timed with the
parent's and this tree's kernels in turns: device µs per step as a CUDA
graph of 20 steps, the host's issue time per step and wall steps/s over
200 steps.  The SASS counts of the kernels ``SASS_KEPT`` names are
printed beside the earlier tree's.

Every figure is device time per launch of 20 launches captured as a
CUDA graph and replayed (``profiling.device_seconds``) at C``N`` (default
384) on the state after 20 compact TC5 steps (B1, B12, B4) or one split
Galewsky step (B2); each form is timed in turns (A, B, ..., ..., B, A).
The script also checks this tree's and the earlier kernels bitwise
against the plain versions (B12 also on a grid of 132 blocks, fewer than
its work items), prints each build's ``ptxas`` lines and each kernel
function's SASS instruction count (``cuobjdump -sass``; the earlier B5 and
B6 too, which share B1's header), and ends with a JSON summary line.
Needs a CUDA GPU and nvcc; exits 1 without them.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import time
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 20          # launches per captured window
REPLAYS = 5        # graph replays per figure

# The earlier B1's right-hand side and epilogue, which the ablations
# replace (from the advective_tile call to the end of its lambda).
_RHS_CALL = re.compile(r"  advective_tile<true, TX \+ 2 \* AP, TX \+ 2>\(.*?"
                       r"\n      \}\);\n", re.S)

_METRIC = r"""
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      const bool jin = j >= 0 && j < n, iin = i >= 0 && i < n;
      if (j >= -1 && j <= n && i >= -1 && i <= n && (jin || iin)) {
        const float x = p.xc[i + hh], y = p.xc[j + hh];
        const float dxda = 1.0f + x * x;
        const float dydb = 1.0f + y * y;
        const float rho2 = dxda + y * y;
        const float inv_R2dxda = 1.0f / (p.R2 * dxda);
        const float inv_dydb = 1.0f / dydb;
        acc += rho2 * inv_R2dxda;
        acc += (rho2 * inv_R2dxda) * (dxda * inv_dydb);
        acc += rho2 * ((x * inv_R2dxda) * (y * inv_dydb));
      }
    }
  for (int ly = ty; ly < TY; ly += BY)
    for (int lf = tx; lf < TX + 1; lf += BX) {
      const int j = j0 + ly, i = i0 + lf;
      if (j < n && i <= n && i != 0 && i != n) {
        float fa, fb;
        xface_metric(p.xf[i + hh], p.xc[j + hh], fa, fb);
        acc += fa + fb;
      }
    }
  for (int lf = ty; lf < TY + 1; lf += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + lf, i = i0 + lx;
      if (j <= n && i < n && j != 0 && j != n) {
        float fa, fb;
        yface_metric(p.xc[i + hh], p.xf[j + hh], fa, fb);
        acc += fa + fb;
      }
    }
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const float x = p.xc[i + hh], y = p.xc[j + hh];
      const float dxda = 1.0f + x * x;
      const float dydb = 1.0f + y * y;
      const float rho2 = dxda + y * y;
      const float inv_rho = rsqrtf(rho2);
      const float inv_rho2 = inv_rho * inv_rho;
      const float sg_row = p.R2 * dxda;
      const float sqrtg = (sg_row * dydb) * (inv_rho2 * inv_rho);
      const float inv_sqrtg = ((1.0f / sg_row) * (1.0f / dydb))
                            * (rho2 * rho2 * inv_rho);
      acc += sqrtg + inv_sqrtg * p.inv_d + inv_rho;
    }
"""

_STORES = r"""
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const long c = f * nn + (long)j * n + i;
      float y0h = 0.0f, y0a = 0.0f, y0b = 0.0f;
      if (p.with_y0) {
        y0h = p.h0[c];
        y0a = p.u0[c];
        y0b = p.u0[6 * nn + c];
      }
      const float bb = p.b[(long)f * m * m + (long)(j + hh) * m + i + hh];
      const float vals[3] = {(s_h[ly + AP][lx + AP] + y0h) + (bb + 0.0f * acc),
                             s_ua[ly + 1][lx + 1] + y0a,
                             s_ub[ly + 1][lx + 1] + y0b};
      p.ho[c] = vals[0];
      p.uo[c] = vals[1];
      p.uo[6 * nn + c] = vals[2];
      for (int fi = 0; fi < 3; ++fi)
        put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
    }
"""


def ablated_stage(src: str, mode: str) -> str:
    """The earlier cov_stage.cu with its right-hand side replaced
    (``staging`` or ``staging+metric``)."""
    body = "  float acc = 0.0f;\n  (void)k;\n"
    if mode == "staging+metric":
        body += _METRIC
    body += _STORES
    new, count = _RHS_CALL.subn(lambda _: body, src)
    if count != 1:
        raise RuntimeError("the earlier cov_stage.cu has no advective_tile "
                           "call of the expected form")
    return new


def nvcc_build(src: Path, out: Path, include: Path) -> str:
    """``nvcc`` ``src`` into the shared library ``out`` with the port's
    flags; returns the compiler's output (the ptxas lines)."""
    from jaxstream_torch import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           f"-I{include}", "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    return proc.stdout


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln
            or "Compiling entry function" in ln]


def sass_counts(lib: Path) -> dict:
    """SASS instructions per kernel function of ``lib``."""
    from jaxstream_torch import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    counts = {}
    for sec in re.split(r"\n\s*Function : ", out)[1:]:
        name = sec.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", sec))
    return counts


def entry(lib: Path, fn_name: str, argtypes):
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def device_us(call, args) -> float:
    from jaxstream_torch.utils.profiling import device_seconds

    s = device_seconds(lambda: [call(*args) for _ in range(REPS)],
                       replays=REPLAYS)
    return float("nan") if s is None else s / REPS * 1e6


def in_turns(forms: dict, call, args) -> dict:
    """Device µs per launch of each form (name -> function to install),
    timed in turns A, B, ..., ..., B, A: {name: [first, second]}."""
    names = list(forms)
    times = {k: [] for k in names}
    for name in names + names[::-1]:
        forms[name]()
        times[name].append(device_us(call, args))
    return times


def calls_in_turns(calls: dict) -> dict:
    """Device µs per call of each of ``calls`` (name -> function of no
    arguments), timed in turns: {name: [first, second]}."""
    names = list(calls)
    times = {k: [] for k in names}
    for name in names + names[::-1]:
        times[name].append(device_us(calls[name], ()))
    return times


def mega_variants(src: str) -> dict:
    """This tree's B12 source with the thread index read as threadIdx
    (shared across the face phases' runs), with the metric recomputed
    per item and stage, and with its face phases taken out."""
    shared_tid = src.replace("#define COV_OPAQUE_TID\n", "")
    per_stage = src.replace("if (mt_item != t) {", "if (true) {")
    routes = src.replace("    face_phase(p, sm, st, mt_item);\n", "")
    if src in (shared_tid, per_stage, routes):
        raise RuntimeError("cov_step_mega.cu has no opaque thread index, "
                           "metric test or face phase of the expected form")
    return {"mega_shared_tid": shared_tid,
            "mega_metric_per_stage": per_stage, "mega_routes_only": routes}


def bitwise(call, ref, args) -> bool:
    out = call(*args)
    torch.cuda.synchronize()
    return all(torch.equal(x, r) for x, r in zip(out, ref(*args)))


def probe_mega(libs, grid, model, y, b, extra=()):
    """B12's forms on the carry ``y`` (and the ``--mega`` variants named
    ``extra``): bitwise checks and device µs per step in turns."""
    from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA
    from jaxstream_torch.experiments import swe_mega

    types = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 2)
    parent_types = types[:26] + types[28:]
    fns = {k: entry(libs[k], "cov_step_mega_f32", types)
           for k in ["cov_step_mega", "mega_shared_tid",
                     "mega_metric_per_stage", "mega_routes_only"]
           + [f"mega_{e}" for e in extra]}
    parent_fn = entry(libs["parent_mega"], "cov_step_mega_f32", parent_types)
    # The earlier entry takes no vec / max_blocks.
    fns["parent_mega"] = lambda *a: parent_fn(*a[:26], *a[28:])

    def use(key):
        return lambda: setattr(swe_mega, "_mega_kernel", lambda: fns[key])

    kern = swe_mega.CovMegaStep(grid, EARTH_GRAVITY, EARTH_OMEGA, 75.0)
    few = swe_mega.CovMegaStep(grid, EARTH_GRAVITY, EARTH_OMEGA, 75.0,
                               max_blocks=132)
    args = (y["h"], y["u"], y["strips_sn"], y["strips_we"], b)
    checks = {}
    for key, label in [("cov_step_mega", "new"), ("parent_mega", "parent"),
                       ("mega_shared_tid", "shared tid"),
                       ("mega_metric_per_stage", "metric per stage")] + [
                           (f"mega_{e}", e) for e in extra]:
        use(key)()
        checks[f"B12 {label}"] = bitwise(kern, kern.reference, args)
    use("cov_step_mega")()
    checks["B12 new, 132 blocks"] = bitwise(few, few.reference, args)
    print(f"B12 grid: {kern.blocks} blocks (132 on the second)", flush=True)
    forms = {"parent": use("parent_mega"),
             "shared tid": use("mega_shared_tid"),
             "metric per stage": use("mega_metric_per_stage"),
             "new": use("cov_step_mega"),
             "routes only": use("mega_routes_only")}
    forms.update({e: use(f"mega_{e}") for e in extra})
    times = {"B12 step": in_turns(forms, kern, args)}
    use("cov_step_mega")()
    return checks, times


def probe_rhs(libs, grid, model, y):
    """B4's forms on the filled state of the compact carry ``y``: the
    six-face layout and one RK stage of the face tier, the earlier kernel
    against this tree's; bitwise checks and device µs in turns."""
    from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA
    from jaxstream_torch.ops.cuda import swe_cov

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent_fn = entry(libs["parent_rhs"], "cov_rhs_f32",
                      [P] * 10 + [I] * 3 + [F] * 5 + [P])
    six = swe_cov.make_cov_rhs_pallas(grid, EARTH_GRAVITY,
                                      EARTH_OMEGA).kernel
    one = swe_cov.make_cov_rhs_pallas(grid, EARTH_GRAVITY, EARTH_OMEGA,
                                      n_faces=1, external_sym=True)
    state = model.restrict_state(y)
    he, ue = model.fill(state["h"]), model._fill_u(state["u"])
    ssn, swe = swe_cov.sym_edge_normals(grid, ue)
    b, fz = model.b_ext, six.fz[:, None].contiguous()
    n, hh = grid.n, grid.halo
    args6 = (fz, he, ue, b, ssn, swe)
    # The face tier's stacked operands: views of q (6, 3, M, M).
    q = torch.cat([he[:, None], ue.transpose(0, 1)], dim=1)
    groups = swe_cov.RankGroups([(0, 0)] * 6, *(
        t.expand((6,) + tuple(t.shape)) for t in six.coords))
    argst = (fz, groups, q[:, 0:1], q[:, 1:3].unsqueeze(2), b[:, None],
             ssn[:, None], swe[:, None])
    dh6, du6 = he.new_empty((6, n, n)), he.new_empty((2, 6, n, n))
    dh1, du1 = he.new_empty((6, 1, n, n)), he.new_empty((6, 2, 1, n, n))
    consts = six._rhs_consts
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def parent_six():
        rc = parent_fn(fz.data_ptr(), he.data_ptr(), ue.data_ptr(),
                       b.data_ptr(), ssn.data_ptr(), swe.data_ptr(),
                       six._xc.data_ptr(), six._xf.data_ptr(),
                       dh6.data_ptr(), du6.data_ptr(), 6, n, hh, *consts,
                       stream())
        assert rc == 0, rc
        return dh6, du6

    def parent_faces():
        for r in range(6):
            rc = parent_fn(fz[r].data_ptr(), q[r, 0].data_ptr(),
                           q[r, 1].data_ptr(), b[r].data_ptr(),
                           ssn[r].data_ptr(), swe[r].data_ptr(),
                           six._xc.data_ptr(), six._xf.data_ptr(),
                           dh1[r].data_ptr(), du1[r].data_ptr(), 1, n, hh,
                           *consts, stream())
            assert rc == 0, rc
        return dh1, du1

    def same(out, ref):
        torch.cuda.synchronize()
        return all(torch.equal(x, r) for x, r in zip(out, ref))

    ref6, reft = six.reference(*args6), one.stacked_reference(*argst)
    checks = {"B4 new six faces": same(six(*args6), ref6),
              "B4 parent six faces": same(parent_six(), ref6),
              "B4 new stacked": same(one.stacked(*argst), reft),
              "B4 parent per face": same(parent_faces(), reft)}
    times = {"B4 six faces": calls_in_turns(
                 {"parent": parent_six, "new": lambda: six(*args6)}),
             "B4 face tier, one RK stage": calls_in_turns(
                 {"parent 6 one-face launches": parent_faces,
                  "new stacked": lambda: one.stacked(*argst)})}
    return checks, times


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected one {old[:50]!r} in the source")
    return text.replace(old, new)


def redesign_levers() -> dict:
    """This tree's B11 with fast_frame evaluated in place at every band
    cell, face and centre of every face (the header's tile points
    rewritten, inlined into the source), and its B7 A with the Laplacian
    inside the advective tile's epilogue instead of its own pass."""
    from jaxstream_torch import _build

    csrc = _build.CSRC_DIR
    hdr = (csrc / "swe_faces.cuh").read_text().replace("#pragma once\n", "")
    for table in ("mt.xc, lx, mt.yc, ly, mt.irho_b[ly][lx]",
                  "mt.xf, lf, mt.yc, ly + 1, mt.irho_x[ly][lf]",
                  "mt.xc, lx + 1, mt.yf, lf, mt.irho_y[lf][lx]"):
        hdr = _sub(hdr, f"return fast_at({table});",
                   "return fast_frame(x, y, k);")
    hdr = _sub(hdr, "  const SweMetric& mt;\n",
               "  const SweMetric& mt;\n  const Consts& k;\n")
    if hdr.count("TilePoints{mt}.") != 4:
        raise RuntimeError("expected four TilePoints{mt} in swe_faces.cuh")
    hdr = hdr.replace("TilePoints{mt}.", "TilePoints{mt, k}.")
    ink = _sub((csrc / "swe_stage_inkernel.cu").read_text(),
               '#include "swe_faces.cuh"\n', hdr)
    a = (csrc / "cov_stage_nu4.cu").read_text()
    own = a[a.index("    // l1 in a pass of its own"):]
    own = own[:own.index("    __syncthreads();   // w and the scratch")]
    a = _sub(a, own, "")
    a = _sub(a, "                                     y0[r][2], ubv, dub);\n",
             "                                     y0[r][2], ubv, dub);\n"
             "          put_l1(p, w, sm.mt, f, threadIdx.y + r * BY, lx, j, "
             "i, strips);\n")
    return {"lever_metric_per_face": ink, "lever_lap_in_epilogue": a}


def probe_redesign(libs, parent, n, card, sass, ink_vars=(), a_vars=()):
    """B11 and B7 A: this tree's, the earlier tree's and the levers;
    bitwise checks, device µs per launch and per step in turns, and the
    host's issue time per step."""
    from jaxstream_torch import _build
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov, swe_step
    from jaxstream_torch.physics.initial_conditions import (galewsky,
                                                            williamson_tc5)
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.profiling import device_seconds

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ink_types = [P] * 18 + [I] * 4 + [F] * 9 + [P]
    a_types = [P] * 16 + [I] * 3 + [F] * 8 + [P]
    fns = {}
    for key, lib in (("ink new", libs["swe_stage_inkernel"]),
                     ("ink parent", libs["parent_swe_stage_inkernel"]),
                     ("ink metric per face", libs["lever_metric_per_face"])):
        fns[key] = entry(lib, "swe_stage_inkernel_f32", ink_types)
    for key, lib in (("a new", libs["cov_stage_nu4"]),
                     ("a parent", libs["parent_cov_stage_nu4"]),
                     ("a lap in epilogue", libs["lever_lap_in_epilogue"])):
        fns[key] = entry(lib, "cov_stage_nu4_a_f32", a_types)
    for v in ink_vars:
        fns[f"ink {v}"] = entry(libs[f"ink_{v}"], "swe_stage_inkernel_f32",
                                ink_types)
    for v in a_vars:
        fns[f"a {v}"] = entry(libs[f"nu4a_{v}"], "cov_stage_nu4_a_f32",
                              a_types)

    def use_ink(key):
        return lambda: setattr(swe_step, "_inkernel_kernel",
                               lambda: fns[key])

    def use_a(key):
        return lambda: setattr(swe_cov, "_nu4_a_kernel", lambda: fns[key])

    grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    cart = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                        b_ext=b, backend="pallas")
    cstep = cart.make_fused_step(75.0)
    cy, ct = integrate(cstep, cart.extend_state(cart.initial_state(h, v),
                                                with_strips=True),
                       0.0, 20, 75.0)
    st1, st2, _ = cstep.stages
    g = cstep.route(cy["sh_sn"], cy["sh_we"], cy["sv_sn"], cy["sv_we"])
    ink_args = {"stage 1": (st1, (cy["h"], cy["v"], g, cart.b_ext)),
                "stage 2": (st2, (cy["h"], cy["v"], cy["h"], cy["v"], g,
                                  cart.b_ext))}
    gmodel = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                   omega=EARTH_OMEGA, nu4=1.0e14)
    gstep = gmodel.make_fused_step(60.0, nu4_mode="stage")
    gy = gstep(gmodel.compact_state(gmodel.initial_state(
        *galewsky(grid, EARTH_GRAVITY, EARTH_OMEGA))), 0.0)
    a1, a2, _ = gstep.stages
    gg = gstep.route(gy["strips_sn"], gy["strips_we"])
    a_args = {"stage 1": (a1, (gy["h"], gy["u"]) + gg + (gmodel.b_ext,)),
              "stage 2": (a2, (gy["h"], gy["u"], gy["h"], gy["u"]) + gg
                          + (gmodel.b_ext,))}

    checks = {}
    for key in ("ink new", "ink parent", "ink metric per face"):
        use_ink(key)()
        for label, (st, a) in ink_args.items():
            checks[f"B11 {key[4:]} {label}"] = bitwise(st, st.reference, a)
    for key in ("a new", "a parent", "a lap in epilogue"):
        use_a(key)()
        for label, (st, a) in a_args.items():
            checks[f"B7 A {key[2:]} {label}"] = bitwise(st.call_a,
                                                       st.reference_a, a)
    for v in ink_vars:
        use_ink(f"ink {v}")()
        for label, (st, a) in ink_args.items():
            checks[f"var B11 {v} {label}"] = bitwise(st, st.reference, a)
    for v in a_vars:
        use_a(f"a {v}")()
        for label, (st, a) in a_args.items():
            checks[f"var B7 A {v} {label}"] = bitwise(st.call_a,
                                                      st.reference_a, a)
    times = {}
    for label, (st, a) in ink_args.items():
        forms = {"parent": use_ink("ink parent"),
                 "metric per face": use_ink("ink metric per face")}
        forms.update({v: use_ink(f"ink {v}") for v in ink_vars})
        forms["new"] = use_ink("ink new")
        times[f"B11 {label}"] = in_turns(forms, st, a)
    for label, (st, a) in a_args.items():
        forms = {"parent": use_a("a parent"),
                 "lap in epilogue": use_a("a lap in epilogue")}
        forms.update({v: use_a(f"a {v}") for v in a_vars})
        forms["new"] = use_a("a new")
        times[f"B7 A {label}"] = in_turns(forms, st.call_a, a)

    # The steps: device µs per step as a CUDA graph of 20, the host's
    # issue time per step (20 steps enqueued, before the synchronise) and
    # the wall steps/s of 200 steps, parent and new kernel in turns.
    def step_times(step, y, t, dt):
        s = device_seconds(lambda: integrate(step, y, t, 20, dt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, t, 20, dt)
        issue = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, t, 200, dt)
        torch.cuda.synchronize()
        rate = 200 / (time.perf_counter() - t0)
        return (float("nan") if s is None else s / 20 * 1e6), issue, rate

    steps = {}
    for label, use, step, y, t, dt in (
            ("Cartesian in-kernel step", use_ink, cstep, cy, ct, 75.0),
            ("in-stage step", use_a, gstep, gy, 60.0, 60.0)):
        tag = "ink" if use is use_ink else "a"
        got = {"parent": [], "new": []}
        for form in ("parent", "new", "new", "parent"):
            use(f"{tag} {form}")()
            got[form].append(step_times(step, y, t, dt))
        steps[label] = got
        print(f"C{n} {label} (parent / new kernel, in turns): "
              + "; ".join(f"{k} device " + ", ".join(
                  f"{d:.2f}" for d, _, _ in v) + " us/step, host issue "
                  + ", ".join(f"{hst:.2f}" for _, hst, _ in v)
                  + " us/step, wall " + ", ".join(
                      f"{r:.1f}" for _, _, r in v) + " steps/s"
                  for k, v in got.items()) + f"; card {card}", flush=True)
    use_ink("ink new")()
    use_a("a new")()
    return checks, times, steps


def b13b8_levers() -> dict:
    """This tree's B13 and B8 rewritten: the ring's (and B13's sym rows')
    loads after the first window's copies; B13's u ghosts loaded and
    stored at once; B8's W/E strip values staged; the ablations
    without the ring and (B8) without the W/E strip stores."""
    from jaxstream_torch import _build

    csrc = _build.CSRC_DIR
    nbr = (csrc / "cov_stage_nbr.cu").read_text()
    ext = (csrc / "cov_stage_inkernel.cu").read_text()
    window = ("  stage_window(p, sm.w[0], f0, j0, i0);\n"
              "  async_commit();\n")
    ring = "  ring_load(p, ring, f0, j0, 0, rp);\n"
    sym = "  sym_load(p, span, f0, j0, i0, 0, sp);\n"
    out = {}
    for tag, src in (("nbr", nbr), ("ext", ext)):
        late = _sub(src, ring, "")
        out[f"{tag}_ring_after_window"] = _sub(late, window, window + ring)
        out[f"{tag}_no_ring"] = src.replace("    ring_store(p, rp);\n", "") \
            .replace("  ring_store(p, rp);\n", "")
    late = _sub(nbr, sym, "")
    out["nbr_sym_after_window"] = _sub(late, window, window + sym)
    load = "      ghost_load(p, gu, f + 1, j0, i0, gq);\n"
    store = "    if (q + 1 < FPB) ghost_store(sm.w[cur ^ 1], gq);\n"
    out["nbr_ghosts_unstaged"] = _sub(
        _sub(nbr, store, ""), load,
        load + "      ghost_store(sm.w[cur ^ 1], gq);\n")
    we = ("  if (i < hh) so[(base + 2 * hh + i) * n + j] = v;\n"
          "  if (i >= n - hh) so[(base + 3 * hh + i - (n - hh)) * n + j] "
          "= v;\n")
    out["ext_no_we_strips"] = _sub(ext, we, "")
    smem = "  StageScratch s;\n};\n"
    staged = _sub(ext, smem, smem.replace("};", _WE_STAGED))
    staged = _sub(staged, "put_packed(so, fi, n, hh, j, i, vals[fi]);",
                  "put_packed_we(so, sm.we[fi], fi, n, hh, j0, j, i, "
                  "vals[fi]);")
    last = "    __syncthreads();   // w and the scratch are free for the next face\n"
    out["ext_we_staged"] = _sub(
        staged, last, last + "    if (i0 < hh || i0 + FTX > n - hh) "
        "flush_we(sm, so, n, hh, j0, i0);\n")
    for name, text in out.items():
        if text in (nbr, ext):
            raise RuntimeError(f"{name}: the source has no part of the "
                               "expected form")
    return out


#: B8's W/E strip values staged through shared memory (the lever
#: ``W/E strips staged``): the tile's values of one face in Smem::we, then,
#: after the face's closing barrier, each strip row's stretch of tile rows
#: stored as consecutive floats.
_WE_STAGED = r"""  float we[3][2][4][FTY];   // field, W/E, strip column, tile row
};

__device__ __forceinline__ void put_packed_we(float* so,
                                              float (*we)[4][FTY], int fi,
                                              int n, int hh, int j0, int j,
                                              int i, float v) {
  const int base = fi * 4 * hh;
  if (j < hh) so[(base + j) * n + i] = v;
  if (j >= n - hh) so[(base + hh + j - (n - hh)) * n + i] = v;
  if (i < hh) we[0][i][j - j0] = v;
  if (i >= n - hh) we[1][i - (n - hh)][j - j0] = v;
}

__device__ __forceinline__ void flush_we(const Smem& sm, float* so, int n,
                                         int hh, int j0, int i0) {
  const int rows = n - j0 < FTY ? n - j0 : FTY;
  for (int t = threadIdx.y * BX + threadIdx.x; t < 3 * 2 * hh * FTY;
       t += NT) {
    const int ly = t % FTY, c = t / FTY % hh, side = t / FTY / hh % 2;
    const int fi = t / (2 * hh * FTY);
    const int i = side == 0 ? c : n - hh + c;
    if (ly >= rows || i < i0 || i >= i0 + FTX) continue;
    so[(fi * 4 * hh + (side == 0 ? 2 : 3) * hh + c) * n + j0 + ly] =
        sm.we[fi][side][c][ly];
  }
}"""


#: The b13b8 forms of each kernel: label -> library name; the ablations
#: (not bitwise by design) last.
B13_FORMS = {"parent": "parent_cov_stage_nbr",
             "ring after window": "nbr_ring_after_window",
             "sym after window": "nbr_sym_after_window",
             "ghosts unstaged": "nbr_ghosts_unstaged",
             "new": "cov_stage_nbr", "no ring": "nbr_no_ring"}
B8_FORMS = {"parent": "parent_cov_stage_inkernel",
            "ring after window": "ext_ring_after_window",
            "W/E strips staged": "ext_we_staged",
            "new": "cov_stage_inkernel", "no ring": "ext_no_ring",
            "no W/E strips": "ext_no_we_strips"}
B13B8_ABLATIONS = ("no ring", "no W/E strips")


def probe_b13b8(libs, n, card, sass, nbr_vars=(), ext_vars=()):
    """B13 and B8: this tree's, the earlier tree's and the levers;
    bitwise checks, device µs per launch and per step in turns, nbr's
    host issue time and wall rate, and the SASS counts of the kernels
    that must not change."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.experiments import swe_cov_nbr
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.profiling import device_seconds

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    nbr_types = [P] * 15 + [I] * 3 + [F] * 8 + [P]
    ext_types = [P] * 12 + [I] * 3 + [F] * 8 + [P]
    nbr_forms = dict(B13_FORMS, **{v: f"nbr_{v}" for v in nbr_vars})
    ext_forms = dict(B8_FORMS, **{v: f"ext_{v}" for v in ext_vars})
    fns = {("nbr", k): entry(libs[lib], "cov_stage_nbr_f32", nbr_types)
           for k, lib in nbr_forms.items()}
    fns.update({("ext", k): entry(libs[lib], "cov_stage_inkernel_f32",
                                  ext_types)
                for k, lib in ext_forms.items()})

    def use(tag, key):
        mod, attr = ((swe_cov_nbr, "_nbr_kernel") if tag == "nbr"
                     else (swe_cov, "_inkernel_kernel"))
        return lambda: setattr(mod, attr, lambda: fns[(tag, key)])

    grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b)
    s0 = model.initial_state(h, v)
    use("nbr", "new")()
    use("ext", "new")()
    nstep = swe_cov_nbr.make_fused_ssprk3_cov_nbr(
        grid, EARTH_GRAVITY, EARTH_OMEGA, 75.0, b)
    ny, nt = integrate(nstep, model.extend_state(s0), 0.0, 20, 75.0)
    estep = model.make_fused_step(75.0, compact=False)
    ey, et = integrate(estep, model.extend_state(s0, with_strips=True), 0.0,
                       20, 75.0)
    n1, n2, n3 = nstep.stages
    e1, e2, e3 = estep.stages
    gi = estep.route(ey["strips"])
    cases = {
        "nbr": {"stage 1": (n1, (ny["h"], ny["u"], b)),
                "stage 2": (n2, (ny["h"], ny["u"], ny["h"], ny["u"], b)),
                "stage 3": (n3, (ny["h"], ny["u"], ny["h"], ny["u"], b))},
        "ext": {"stage 1": (e1, (ey["h"], ey["u"], gi, b)),
                "stage 2": (e2, (ey["h"], ey["u"], ey["h"], ey["u"], gi, b)),
                "stage 3": (e3, (ey["h"], ey["u"], ey["h"], ey["u"], gi,
                                 b))}}
    label = {"nbr": "B13", "ext": "B8"}
    checks, times = {}, {}
    for tag, forms in (("nbr", nbr_forms), ("ext", ext_forms)):
        for key in forms:
            if key in B13B8_ABLATIONS:
                continue
            use(tag, key)()
            for stage, (st, a) in cases[tag].items():
                var = "var " if key in nbr_vars + ext_vars else ""
                checks[f"{var}{label[tag]} {key} {stage}"] = bitwise(
                    st, st.reference, a)
        for stage, (st, a) in cases[tag].items():
            times[f"{label[tag]} {stage}"] = in_turns(
                {k: use(tag, k) for k in forms}, st, a)
        use(tag, "new")()

    # The steps: device µs per step as a CUDA graph of 20 (both), the
    # host's issue time per step (20 steps enqueued, before the
    # synchronise) and the wall steps/s of 200 steps (nbr), parent and new
    # kernel in turns.
    def step_times(step, y, t, wall):
        s = device_seconds(lambda: integrate(step, y, t, 20, 75.0))
        dev = float("nan") if s is None else s / 20 * 1e6
        if not wall:
            return dev, float("nan"), float("nan")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, t, 20, 75.0)
        issue = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, t, 200, 75.0)
        torch.cuda.synchronize()
        return dev, issue, 200 / (time.perf_counter() - t0)

    steps = {}
    for name, tag, step, y, t in (("nbr step", "nbr", nstep, ny, nt),
                                  ("extended step", "ext", estep, ey, et)):
        got = {"parent": [], "new": []}
        for form in ("parent", "new", "new", "parent"):
            use(tag, form)()
            got[form].append(step_times(step, y, t, tag == "nbr"))
        use(tag, "new")()
        steps[name] = got
        print(f"C{n} {name} (parent / new kernel, in turns): "
              + "; ".join(f"{k} device " + ", ".join(
                  f"{d:.2f}" for d, _, _ in v) + " us/step, host issue "
                  + ", ".join(f"{hst:.2f}" for _, hst, _ in v)
                  + " us/step, wall " + ", ".join(
                      f"{r:.1f}" for _, _, r in v) + " steps/s"
                  for k, v in got.items()) + f"; card {card}", flush=True)

    sass_kept(sass)
    return checks, times, steps


def b9b10_levers() -> dict:
    """This tree's B9 with the general basis's divisions per face (no
    SweBasis), and its B10 with the ring's first pass loaded ahead of the
    first window's copies (B11's order), and without the ring (an
    ablation)."""
    from jaxstream_torch import _build

    csrc = _build.CSRC_DIR
    rhs = (csrc / "swe_rhs.cu").read_text()
    cat = (csrc / "swe_stage.cu").read_text()
    per_face = _sub(rhs, "  SweBasis bt;\n", "")
    per_face = _sub(per_face, "struct Smem {",
                    "struct PerFace {};   // any Mt but SweBasis\n\n"
                    "struct Smem {")
    per_face = _sub(per_face,
                    "  swe_basis(sm.bt, p.xc, p.xf, p.k, n, hh, j0, i0);\n",
                    "")
    per_face = _sub(per_face, "sm.w[cur], sm.bt, sm.s,",
                    "sm.w[cur], PerFace{}, sm.s,")
    window = ("  stage_frame_window(sm.w[0], p.hc, p.vc, p.b, f0, n, hh, j0, "
              "i0);\n  async_commit();\n")
    ring = "  const FrameRing ring(n, hh, j0, i0);\n"
    first = ("  const FrameRing ring(n, hh, j0, i0);\n  RingCell rc0;\n"
             "  ring_load(p, ring, f0, j0, 0, rc0);\n")
    ahead = _sub(_sub(cat, window + ring, first + window
                      + "  ring_store(p, rc0);\n"),
                 "for (int k0 = 0; k0 < ring.count;",
                 "for (int k0 = NT; k0 < ring.count;")
    no_ring = _sub(cat, "    ring_store(p, rc);\n", "")
    return {"rhs_basis_per_face": per_face, "cat_ring_ahead": ahead,
            "cat_no_ring": no_ring}


#: The b9b10 forms of each kernel: label -> library name; the ablation
#: (not bitwise by design) last.
B9_FORMS = {"parent": "parent_swe_rhs",
            "basis per face": "rhs_basis_per_face", "new": "swe_rhs"}
B10_FORMS = {"parent": "parent_swe_stage",
             "ring loads ahead": "cat_ring_ahead",
             "new": "swe_stage", "no ring": "cat_no_ring"}


def probe_b9b10(libs, n, card, sass):
    """B9 and B10: this tree's, the earlier tree's and the levers;
    bitwise checks, device µs per launch and per step in turns, the
    steps' wall rate, and the SASS counts of the kernels that must not
    change."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.ops.cuda import swe_rhs, swe_step
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.profiling import device_seconds

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {("rhs", k): entry(libs[lib], "swe_rhs_f32",
                             [P] * 8 + [I] * 2 + [F] * 6 + [P])
           for k, lib in B9_FORMS.items()}
    fns.update({("cat", k): entry(libs[lib], "swe_stage_f32",
                                  [P] * 10 + [I] * 4 + [F] * 9 + [P])
                for k, lib in B10_FORMS.items()})

    def use(tag, key):
        mod, attr = ((swe_rhs, "_rhs_kernel") if tag == "rhs"
                     else (swe_step, "_stage_kernel"))
        return lambda: setattr(mod, attr, lambda: fns[(tag, key)])

    grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                         b_ext=b, backend="pallas")
    istep = model.make_fused_step(75.0)
    y, t = integrate(istep, model.extend_state(model.initial_state(h, v),
                                               with_strips=True),
                     0.0, 20, 75.0)
    s20 = model.restrict_state(y)
    cstep = model.make_fused_step(75.0, in_kernel_exchange=False)
    ex, bx = cstep.exchange, model.b_ext
    hk, vk = ex(y["h"]), ex(y["v"])
    c1, c2, c3 = cstep.stages
    gen = swe_step.make_swe_stage_pallas(
        grid.n, grid.halo, grid.dalpha, grid.radius, EARTH_GRAVITY,
        EARTH_OMEGA, 75.0, c2.a, c2.b, fast=False, device=grid.device)
    kern = model._pallas_rhs
    cases = {
        "rhs": {"TC5 after 20 steps": (kern, (model.fill(s20["h"]),
                                              model.fill(s20["v"]), bx))},
        "cat": {"stage 1": (c1, (hk, vk, bx)),
                "stage 2": (c2, (hk, vk, hk, vk, bx)),
                "stage 3": (c3, (hk, vk, hk, vk, bx)),
                "general stage 2": (gen, (hk, vk, hk, vk, bx))}}
    label = {"rhs": "B9", "cat": "B10"}
    checks, times = {}, {}
    for tag, forms in (("rhs", B9_FORMS), ("cat", B10_FORMS)):
        for key in forms:
            if key == "no ring":
                continue
            use(tag, key)()
            for case, (st, a) in cases[tag].items():
                checks[f"{label[tag]} {key} {case}"] = bitwise(
                    st, st.reference, a)
        for case, (st, a) in cases[tag].items():
            times[f"{label[tag]} {case}"] = in_turns(
                {k: use(tag, k) for k in forms}, st, a)
        use(tag, "new")()

    # The steps: device µs per step as a CUDA graph of 20 and the wall
    # steps/s of 100 steps, parent and new kernel in turns.
    def step_times(step, y0, t0_):
        d = device_seconds(lambda: integrate(step, y0, t0_, 20, 75.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y0, t0_, 100, 75.0)
        torch.cuda.synchronize()
        return (float("nan") if d is None else d / 20 * 1e6,
                100 / (time.perf_counter() - t0))

    steps = {}
    for name, tag, step, y0 in (
            ("classic step", "rhs", model.make_step(75.0), s20),
            ("concat step", "cat", cstep, {"h": hk, "v": vk})):
        got = {"parent": [], "new": []}
        for form in ("parent", "new", "new", "parent"):
            use(tag, form)()
            got[form].append(step_times(step, y0, t))
        use(tag, "new")()
        steps[name] = got
        print(f"C{n} {name} (parent / new kernel, in turns): "
              + "; ".join(f"{k} device " + ", ".join(
                  f"{d:.2f}" for d, _ in v) + " us/step, wall " + ", ".join(
                      f"{r:.1f}" for _, r in v) + " steps/s"
                  for k, v in got.items()) + f"; card {card}", flush=True)
    sass_kept(sass)
    return checks, times, steps


def b3b7b_levers() -> dict:
    """This tree's B3 with psi double-buffered one face ahead (two blocks
    per SM), with u filtered on tile + 2 as h is, and without its filter
    passes (an ablation: the stage on psi); its B with adv loaded after
    the window's wait (kernel A's order) and with the field loop
    unrolled (no spill)."""
    from jaxstream_torch import _build

    csrc = _build.CSRC_DIR
    b3 = (csrc / "cov_stage_refused_nu4.cu").read_text()
    b = (csrc / "cov_stage_nu4.cu").read_text()
    double = b3
    for old, new in (
            ("  FaceWindow w;\n", "  FaceWindow w[2];\n"),
            ("  stage_psi(p, sm.w, f0, j0, i0);",
             "  stage_psi(p, sm.w[0], f0, j0, i0);"),
            ("    if (q > 0) {   // E was built over the last face's psi\n"
             "      stage_psi(p, sm.w, f, j0, i0);\n"
             "      async_commit();\n    }\n    async_wait<0>();\n",
             "    if (q + 1 < FPB) {\n"
             "      stage_psi(p, sm.w[(q + 1) & 1], f + 1, j0, i0);\n"
             "      async_commit();\n      async_wait<1>();\n"
             "    } else {\n      async_wait<0>();\n    }\n"),
            ("= sm.w.psi;", "= sm.w[q & 1].psi;"),
            ("&sm.w.b[0][0]", "&sm.w[q & 1].b[0][0]"),
            ("__launch_bounds__(NT, 3)\ncov_stage_refused_nu4_kernel",
             "__launch_bounds__(NT, 2)\ncov_stage_refused_nu4_kernel")):
        double = _sub(double, old, new)
    wide_u = _sub(b3, "constexpr int EU = 1;", "constexpr int EU = 2;")
    wait = ("    if (q + 1 < FPB)\n      async_wait<1>();\n    else\n"
            "      async_wait<0>();\n")
    loads = "    // The face's adv at the thread's cells, loaded while the"
    late = _sub(_sub(b, wait, ""), loads, wait + loads)
    loop = "      for (int fi = 0; fi < 3; ++fi) {\n        float l2;"
    unrolled = _sub(b, loop, "#pragma unroll\n" + loop)
    a = b3.index("    // ---- l1 = lap(psi)")
    no_filter = b3[:a] + b3[b3.index("    // ---- the stage on E"):]
    return {"b3_psi_double": double, "b3_u_tile2": wide_u,
            "b3_no_filter": no_filter, "b_adv_after_wait": late,
            "b_fields_unrolled": unrolled}


#: The b3b7b forms of each kernel: label -> library name; the ablation
#: (not bitwise by design) last.
B3_FORMS = {"parent": "parent_cov_stage_refused_nu4",
            "psi double-buffered, 2/SM": "b3_psi_double",
            "u on tile + 2": "b3_u_tile2", "new": "cov_stage_refused_nu4",
            "no filter": "b3_no_filter"}
B7B_FORMS = {"parent": "parent_cov_stage_nu4",
             "adv after the wait": "b_adv_after_wait",
             "fields unrolled": "b_fields_unrolled", "new": "cov_stage_nu4"}


def probe_b3b7b(libs, n, card, sass):
    """B3, B7 B and B14's modes: this tree's, the earlier tree's and the
    levers; bitwise checks, device µs per launch and the re-fused and
    in-stage steps' device µs per step in turns, the steps' host issue
    time and wall rate, and the SASS counts of the kernels that must not
    change."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.experiments import nu4_bisect as nb
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import (galewsky,
                                                            williamson_tc5)
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.profiling import device_seconds

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    b3_types = [P] * 14 + [I] * 2 + [F] * 7 + [P]
    b_types = [P] * 12 + [I] * 2 + [F] * 4 + [P]
    b14_types = [P] * 12 + [I] * 3 + [F] * 4 + [P]
    fns = {("b3", k): entry(libs[lib], "cov_stage_refused_nu4_f32",
                            b3_types) for k, lib in B3_FORMS.items()}
    fns.update({("b", k): entry(libs[lib], "cov_stage_nu4_b_f32", b_types)
                for k, lib in B7B_FORMS.items()})
    fns.update({("b14", k): entry(libs[lib], "cov_stage_nu4_b_ablated_f32",
                                  b14_types)
                for k, lib in B7B_FORMS.items()})

    def use(tag, key):
        mod, attr = {"b3": (swe_cov, "_refused_kernel"),
                     "b": (swe_cov, "_nu4_b_kernel"),
                     "b14": (nb, "_ablated_kernel")}[tag]
        return lambda: setattr(mod, attr, lambda: fns[(tag, key)])

    grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    gal = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                omega=EARTH_OMEGA, nu4=1.0e14)
    tc5 = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                omega=EARTH_OMEGA, b_ext=b, nu4=1.0e14)
    rstep = gal.make_fused_step(60.0, nu4_mode="refused")
    sstep = gal.make_fused_step(60.0, nu4_mode="stage")
    y0 = gal.compact_state(gal.initial_state(
        *galewsky(grid, EARTH_GRAVITY, EARTH_OMEGA)))
    ry = rstep(y0, 0.0)
    sy = sstep(y0, 0.0)
    tstep = tc5.make_fused_step(75.0, nu4_mode="refused")
    ty = tstep(tc5.compact_state(tc5.initial_state(h, v)), 0.0)
    b3_cases = {
        "Galewsky": (rstep.stage1f, (ry["h"], ry["u"]) + rstep.route(
            ry["strips_sn"], ry["strips_we"]) + (gal.b_ext,)),
        "TC5 orography": (tstep.stage1f, (ty["h"], ty["u"]) + tstep.route(
            ty["strips_sn"], ty["strips_we"]) + (tc5.b_ext,))}
    b3_cases["Galewsky probe"] = (swe_cov.make_cov_stage_refused_nu4(
        grid, EARTH_GRAVITY, EARTH_OMEGA, 60.0, 1.0e21),
        b3_cases["Galewsky"][1])
    gsn, gwe = sstep.route(sy["strips_sn"], sy["strips_we"])
    b_cases = {}
    for label, st in zip(("stage 1", "stage 2"), sstep.stages[:2]):
        args = (sy["h"], sy["u"], gsn, gwe, gal.b_ext)
        if st.with_y0:
            args = (sy["h"], sy["u"]) + args
        out_a = st.reference_a(*args)
        b_cases[label] = (st, tuple(out_a[:4]) + sstep.route(out_a[4],
                                                            out_a[5]))
    b14 = {m: nb.Nu4BisectB(b_cases["stage 1"][0], m) for m in nb.MODES}

    checks = {}
    for key in B3_FORMS:
        if key == "no filter":
            continue
        use("b3", key)()
        for label, (st, a) in b3_cases.items():
            checks[f"B3 {key} {label}"] = bitwise(st, st.reference, a)
    for key in B7B_FORMS:
        use("b", key)()
        use("b14", key)()
        for label, (st, a) in b_cases.items():
            checks[f"B7 B {key} {label}"] = bitwise(st.call_b,
                                                   st.reference_b, a)
        a = b_cases["stage 1"][1]
        for m, kb in b14.items():
            checks[f"B14 {key} {m}"] = bitwise(kb, kb.reference, a)
    times = {}
    st, a = b3_cases["Galewsky"]
    times["B3 Galewsky"] = in_turns({k: use("b3", k) for k in B3_FORMS}, st,
                                    a)
    for label, (st, a) in b_cases.items():
        times[f"B7 B {label}"] = in_turns(
            {k: use("b", k) for k in B7B_FORMS}, st.call_b, a)
    a = b_cases["stage 1"][1]
    for m, kb in b14.items():
        times[f"B14 {m}"] = in_turns(
            {k: use("b14", k) for k in ("parent", "new")}, kb, a)
    use("b3", "new")()
    use("b", "new")()
    use("b14", "new")()

    # The steps: device µs per step as a CUDA graph of 20, the host's
    # issue time per step (20 steps enqueued, before the synchronise) and
    # the wall steps/s of 200 steps, parent and new kernels in turns.
    def step_times(step, y):
        d = device_seconds(lambda: integrate(step, y, 60.0, 20, 60.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, 60.0, 20, 60.0)
        issue = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrate(step, y, 60.0, 200, 60.0)
        torch.cuda.synchronize()
        return ((float("nan") if d is None else d / 20 * 1e6), issue,
                200 / (time.perf_counter() - t0))

    steps = {}
    for name, tags, step, y in (("re-fused step", ("b3",), rstep, ry),
                                ("in-stage step", ("b", "b14"), sstep, sy)):
        got = {"parent": [], "new": []}
        for form in ("parent", "new", "new", "parent"):
            for tag in tags:
                use(tag, form)()
            got[form].append(step_times(step, y))
        steps[name] = got
        print(f"C{n} {name} (parent / new kernels, in turns): "
              + "; ".join(f"{k} device " + ", ".join(
                  f"{d:.2f}" for d, _, _ in v) + " us/step, host issue "
                  + ", ".join(f"{hst:.2f}" for _, hst, _ in v)
                  + " us/step, wall " + ", ".join(
                      f"{r:.1f}" for _, _, r in v) + " steps/s"
                  for k, v in got.items()) + f"; card {card}", flush=True)
    for tag in ("b3", "b", "b14"):
        use(tag, "new")()
    sass_kept(sass)
    return checks, times, steps


def sass_kept(sass) -> None:
    """Print the SASS counts of the libraries (or the functions) of
    ``SASS_KEPT`` beside the earlier tree's.  The functions' names differ
    between two builds (an anonymous namespace is named after its file),
    so the counts are compared."""
    for name, which in SASS_KEPT.items():
        if f"parent_{name}" not in sass:
            continue
        keep, was = (sorted(c for k, c in sass[lib].items()
                            if which is None or which in k)
                     for lib in (name, f"parent_{name}"))
        print(f"SASS {name}" + (f" ({which})" if which else "")
              + f": {keep} (parent {was}): "
              + ("same" if keep == was else "CHANGED"), flush=True)


#: The libraries whose SASS b3b7b, b13b8 and b9b10 compare with the
#: earlier tree's, each with the kernel functions it covers (a substring
#: of their names; None for all): every kernel that shares cov_faces.cuh
#: and cov_common.cuh but B3 and B7 B / B14 (redesigned in the b3b7b
#: tree), kernel A among them.
SASS_KEPT = {"cov_stage_nu4": "nu4_a_kernel", "cov_stage": None,
             "cov_nu4_filter": None, "cov_rhs": None,
             "cov_rhs_interior": None, "cov_rhs_local": None,
             "cov_step_mega": None, "cov_stage_inkernel": None,
             "cov_stage_nbr": None, "swe_rhs": None, "swe_stage": None,
             "swe_stage_inkernel": None}


def main() -> int:
    args = sys.argv[1:]
    n = 384
    mega_dir = None
    parts = {"b1b2", "b12", "b4", "b11b7a", "b13b8", "b9b10", "b3b7b"}
    var_dirs = {}
    while args[:1] in (["--n"], ["--mega"], ["--parts"], ["--ink"],
                       ["--nu4a"], ["--nbr"], ["--ext"]):
        if args[0] == "--n":
            n = int(args[1])
        elif args[0] == "--mega":
            mega_dir = Path(args[1]).resolve()
        elif args[0] == "--parts":
            parts = set(args[1].split(","))
        else:
            var_dirs[args[0][2:]] = Path(args[1]).resolve()
        args = args[2:]
    if not torch.cuda.is_available() or not args:
        print("usage: torch_faces_probe.py [--n N] [--mega DIR] [--parts "
              "P,...] PARENT_DIR [OTHER ...] (needs a CUDA GPU)",
              file=sys.stderr)
        return 1
    from jaxstream_torch import _build
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import (galewsky,
                                                            williamson_tc5)
    from jaxstream_torch.stepping import integrate

    parent = Path(args[0]).resolve() / "jaxstream_torch" / "csrc"
    others = {Path(a).resolve().name: Path(a).resolve() / "jaxstream_torch"
              / "csrc" for a in args[1:]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- builds: this tree's and the earlier kernels, the variants -------
    # (one nvcc per source, all started together)
    probe = _build.BUILD_DIR / "probe"
    probe.mkdir(parents=True, exist_ok=True)
    ours, variants = [], {}        # this tree's libraries; name -> (text, include)
    ablations, extra = [], []
    if "b1b2" in parts:
        ours += ["cov_stage", "cov_nu4_filter"]
        src = (parent / "cov_stage.cu").read_text()
        variants["parent_stage_full"] = (src, parent)
        variants["parent_filter"] = (
            (parent / "cov_nu4_filter.cu").read_text(), parent)
        # The ablations apply to an earlier B1 of the tile-per-block design.
        ablations = [m for m in ("staging", "staging+metric")
                     if _RHS_CALL.search(src)]
        for mode in ablations:
            variants[f"parent_stage_{mode}"] = (ablated_stage(src, mode),
                                                parent)
        for other, csrc in others.items():
            for kind, fname in (("stage", "cov_stage.cu"),
                                ("filter", "cov_nu4_filter.cu")):
                variants[f"{other}_{kind}"] = ((csrc / fname).read_text(),
                                               csrc)
    if "b12" in parts:
        ours.append("cov_step_mega")
        variants["parent_mega"] = ((parent / "cov_step_mega.cu").read_text(),
                                   parent)
        for name, text in mega_variants(
                (_build.CSRC_DIR / "cov_step_mega.cu").read_text()).items():
            variants[name] = (text, _build.CSRC_DIR)
        extra = sorted(mega_dir.glob("*.cu")) if mega_dir else []
        for cu in extra:
            variants[f"mega_{cu.stem}"] = (cu.read_text(), _build.CSRC_DIR)
    if "b4" in parts:
        ours += ["cov_rhs", "cov_rhs_interior", "cov_rhs_local"]
        for name in ("cov_rhs", "cov_rhs_interior", "cov_rhs_local"):
            variants[f"parent_{name[4:]}"] = (
                (parent / f"{name}.cu").read_text(), parent)
    if "b11b7a" in parts:
        ours += ["swe_stage_inkernel", "cov_stage_nu4", "swe_rhs",
                 "swe_stage"]
        for name in ("swe_stage_inkernel", "cov_stage_nu4", "swe_rhs",
                     "swe_stage"):
            variants[f"parent_{name}"] = ((parent / f"{name}.cu").read_text(),
                                          parent)
        for name, text in redesign_levers().items():
            variants[name] = (text, _build.CSRC_DIR)
        for kind, d in var_dirs.items():
            if kind in ("ink", "nu4a"):
                for cu in sorted(d.glob("*.cu")):
                    variants[f"{kind}_{cu.stem}"] = (cu.read_text(),
                                                     _build.CSRC_DIR)
    if parts & {"b13b8", "b9b10", "b3b7b"}:
        ours += [k for k in SASS_KEPT if k not in ours]
        for name in SASS_KEPT:
            variants.setdefault(f"parent_{name}", (
                (parent / f"{name}.cu").read_text(), parent))
    if "b9b10" in parts:
        ours += ["swe_rhs", "swe_stage"]
        for name in ("swe_rhs", "swe_stage"):
            variants.setdefault(f"parent_{name}", (
                (parent / f"{name}.cu").read_text(), parent))
        for name, text in b9b10_levers().items():
            variants[name] = (text, _build.CSRC_DIR)
    if "b3b7b" in parts:
        ours += ["cov_stage_refused_nu4", "cov_stage_nu4"]
        for name in ("cov_stage_refused_nu4", "cov_stage_nu4"):
            variants.setdefault(f"parent_{name}", (
                (parent / f"{name}.cu").read_text(), parent))
        for name, text in b3b7b_levers().items():
            variants[name] = (text, _build.CSRC_DIR)
    if "b13b8" in parts:
        for name, text in b13b8_levers().items():
            variants[name] = (text, _build.CSRC_DIR)
        for kind in ("nbr", "ext"):
            if kind in var_dirs:
                for cu in sorted(var_dirs[kind].glob("*.cu")):
                    variants[f"{kind}_{cu.stem}"] = (cu.read_text(),
                                                     _build.CSRC_DIR)

    def build_variant(item):
        name, (text, include) = item
        cu = probe / f"{name}.cu"
        cu.write_text(text)
        lib = probe / f"lib{name}.so"
        return name, lib, nvcc_build(cu, lib, include)

    from concurrent.futures import ThreadPoolExecutor
    libs, logs = {}, {}
    ours = list(dict.fromkeys(ours))
    with ThreadPoolExecutor(max(1, len(ours) + len(variants))) as pool:
        for b in pool.map(_build.build, ours):
            libs[b.name], logs[b.name] = b.path, b.log or "(reused)"
        for name, lib, log in pool.map(build_variant, variants.items()):
            libs[name], logs[name] = lib, log
    sass = {}
    for name, lib in libs.items():
        sass[name] = sass_counts(lib)
        print(f"build {name}: " + "; ".join(ptxas_lines(logs[name])),
              flush=True)
        print(f"  SASS instructions: {sass[name]}", flush=True)

    checks, times = {}, {}
    summary = {}
    if parts & {"b1b2", "b12", "b4"}:
        # ---- operands at C{n} -------------------------------------------
        grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
        h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
        model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                      omega=EARTH_OMEGA, b_ext=b)
        step = model.make_fused_step(75.0)
        y, _ = integrate(step, model.compact_state(model.initial_state(h, v)),
                         0.0, 20, 75.0)
    if "b1b2" in parts:
        gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
        st1, st2, st3 = step.stages
        stage_args = {"stage 1": (st1, (y["h"], y["u"], gsn, gwe, b)),
                      "stage 2": (st2, (y["h"], y["u"], y["h"], y["u"], gsn,
                                        gwe, b)),
                      "stage 3 y0=-2yc": (st3, (-2.0 * y["h"], -2.0 * y["u"],
                                                y["h"], y["u"], gsn, gwe,
                                                b))}
        gmodel = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                       omega=EARTH_OMEGA, nu4=1.0e14)
        gstep = gmodel.make_fused_step(60.0)
        gy = gstep(gmodel.compact_state(gmodel.initial_state(
            *galewsky(grid, EARTH_GRAVITY, EARTH_OMEGA))), 0.0)
        fargs = (gy["h"], gy["u"]) + gstep.route(gy["strips_sn"],
                                                 gy["strips_we"])
        filt = gstep.filter
        probe_filt = swe_cov.make_cov_nu4_filter(grid, 1.0e21, filt.dt_eff)

        stage_types = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
        filter_types = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
                        + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        stage_keys = (["cov_stage", "parent_stage_full"]
                      + [f"parent_stage_{m}" for m in ablations]
                      + [f"{o}_stage" for o in others])
        filter_keys = ["cov_nu4_filter", "parent_filter"] + [
            f"{o}_filter" for o in others]
        stage_fns = {k: entry(libs[k], "cov_stage_compact_f32", stage_types)
                     for k in stage_keys}
        filter_fns = {k: entry(libs[k], "cov_nu4_filter_f32", filter_types)
                      for k in filter_keys}

        def use_stage(key):
            return lambda: setattr(swe_cov, "_kernel", lambda: stage_fns[key])

        def use_filter(key):
            return lambda: setattr(swe_cov, "_filter_kernel",
                                   lambda: filter_fns[key])

        # ---- bitwise against the plain versions -------------------------
        for key in ["cov_stage", "parent_stage_full"] + [f"{o}_stage"
                                                          for o in others]:
            use_stage(key)()
            for label, (st, a) in stage_args.items():
                checks[f"{key} {label}"] = bitwise(st, st.reference, a)
        for key in ["cov_nu4_filter", "parent_filter"] + [f"{o}_filter"
                                                           for o in others]:
            use_filter(key)()
            for label, f in (("filter", filt), ("probe", probe_filt)):
                checks[f"{key} {label}"] = bitwise(f, f.reference, fargs)
        print(f"bitwise vs plain at C{n}: {checks}", flush=True)

        # ---- device time per launch, in turns ---------------------------
        for label in ("stage 1", "stage 2"):
            st, a = stage_args[label]
            forms = {"parent": use_stage("parent_stage_full")}
            forms.update({m: use_stage(f"parent_stage_{m}")
                          for m in ablations})
            forms.update({o: use_stage(f"{o}_stage") for o in others})
            forms["new"] = use_stage("cov_stage")
            times[f"B1 {label}"] = in_turns(forms, st, a)
        forms = {"parent": use_filter("parent_filter")}
        forms.update({o: use_filter(f"{o}_filter") for o in others})
        forms["new"] = use_filter("cov_nu4_filter")
        times["B2 filter"] = in_turns(forms, filt, fargs)
        use_stage("cov_stage")()
        use_filter("cov_nu4_filter")()
    more = {}
    if "b12" in parts:
        mega_checks, mega_times = probe_mega(libs, grid, model, y, b,
                                             [cu.stem for cu in extra])
        more.update(mega_checks)
        times.update(mega_times)
    if "b4" in parts:
        rhs_checks, rhs_times = probe_rhs(libs, grid, model, y)
        more.update(rhs_checks)
        times.update(rhs_times)
    if "b11b7a" in parts:
        red_checks, red_times, summary["steps_us"] = probe_redesign(
            libs, parent, n, card, sass,
            [cu.stem for cu in sorted(var_dirs["ink"].glob("*.cu"))]
            if "ink" in var_dirs else [],
            [cu.stem for cu in sorted(var_dirs["nu4a"].glob("*.cu"))]
            if "nu4a" in var_dirs else [])
        more.update(red_checks)
        times.update(red_times)
    if "b13b8" in parts:
        stems = {k: [cu.stem for cu in sorted(var_dirs[k].glob("*.cu"))]
                 if k in var_dirs else [] for k in ("nbr", "ext")}
        wb_checks, wb_times, summary["b13b8_steps_us"] = probe_b13b8(
            libs, n, card, sass, stems["nbr"], stems["ext"])
        more.update(wb_checks)
        times.update(wb_times)
    if "b9b10" in parts:
        bb_checks, bb_times, summary["b9b10_steps_us"] = probe_b9b10(
            libs, n, card, sass)
        more.update(bb_checks)
        times.update(bb_times)
    if "b3b7b" in parts:
        nu4_checks, nu4_times, summary["b3b7b_steps_us"] = probe_b3b7b(
            libs, n, card, sass)
        more.update(nu4_checks)
        times.update(nu4_times)
    checks.update(more)
    print(f"bitwise vs plain at C{n} (B12, B4, B11, B7 A, B13, B8, B9, "
          f"B10, B3, B7 B, B14): {more}", flush=True)
    for label, t in times.items():
        print(f"C{n} {label}, device us per launch (CUDA graph of {REPS}, "
              "in turns): " + "; ".join(
                  f"{k} {v[0]:.2f} / {v[1]:.2f} (mean "
                  f"{sum(v) / len(v):.2f})" for k, v in t.items())
              + f"; card {card}", flush=True)
    # The variants may be ablations; this tree's and the earlier full
    # kernels, and the levers, must be bitwise.
    ok = all(v for k, v in checks.items()
             if k.split()[0] in ("cov_stage", "parent_stage_full",
                                 "cov_nu4_filter", "parent_filter",
                                 "B12", "B4", "B11", "B7", "B13",
                                 "B8", "B9", "B10", "B3", "B14"))
    print(json.dumps({"ok": ok, "n": n, "card": card, "bitwise": checks,
                      "times_us": times, "sass": sass, **summary}))
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main())
