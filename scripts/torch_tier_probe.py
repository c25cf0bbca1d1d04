"""Probe the sharded covariant tiers on one GPU: each tier step's device
time and wall rate, an earlier tree's against this tree's, in turns in
one process.

    git archive <commit> jaxstream_torch \
        | tar -x -C build/jaxstream_torch/parent
    python3 scripts/torch_tier_probe.py [--n N] [--steps S] [--turns K] \
        [--paths LABEL,...] [--no-kernels] [TREE ...]

Each TREE is a directory holding a ``jaxstream_torch`` package (an earlier
tree's, for instance); the default is this tree alone.  Each tree's
package is imported under a name of its own (the package imports itself
relatively), builds its own kernels into its own
``build/jaxstream_torch/``, and runs in this process, so the trees share
the host's state and take their windows in turns (A, B, ..., ..., B, A;
``K`` rounds of them).  The run takes TC5 at C``N`` (default 384), halo
2, dt = 75 s, and drives the four tier paths through each tree's entry
points (``setup_sharding``, ``make_stepper_for``), every rank a virtual
rank on the one card: the face tier (6 ranks) and the (6, 2, 2) block
tier (24 ranks), serialized and overlapped (``--paths`` picks some of
them by label, e.g. ``"face serialized"``).  Per path and tree:

* ``device_us``: device microseconds per step, 20 steps captured as one
  CUDA graph and replayed 5 times (``profiling.device_seconds``; the
  warm-up steps cache the ranks' permutation indices first): the least
  of ``K`` x 2 captures taken in turns (``device_us_all``: all of them).
  On the H100 a capture of these steps (~1 000-4 800 small kernels)
  replays in one of two or three modes a few hundred microseconds
  apart, the same mode on every replay of that capture;
* ``busy_us`` and ``rhs_us``: the device's busy time per step, and the
  RHS kernels' part of it, summed over the kernels ``torch.profiler``
  traced in ``TRACED`` steps;
* ``steps_s``: wall steps/s, the mean of ``K`` x 2 windows of ``S`` steps
  (default 100) taken in turns on the host clock (``steps_s_all``);
* ``rhs_launches``: the RHS kernels' launches per step (B4's, B5's and
  B6's counters).

Each path's line also reads the card's SM clock, power draw and
temperature.  For this tree the script also times B5 (both tiers) and
B6 over one RK stage's ranks as CUDA graphs, in the tiers' stacked form
and with the design taken apart (groups of 2 and of 1, a launch per
rank), each bitwise against the plain version on the TC5 state, and
prints the two libraries' SASS instruction counts (``cuobjdump -sass``;
``chip_smoke.py`` prints their ``ptxas`` lines); ``--no-kernels`` skips
that part.  The last line is a
JSON summary.  Needs a CUDA GPU and nvcc; exits 1 without them.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
DT = 75.0
WARM = 5
GRAPH_STEPS = 20
TRACED = 3
RHS_KERNELS = ("cov_rhs_kernel", "cov_rhs_interior_kernel",
               "cov_rhs_local_kernel")
PATHS = ((1, False), (1, True), (2, False), (2, True))


def _label(tiles: int, overlap: bool) -> str:
    return ("face" if tiles == 1 else "block") + (
        " overlapped" if overlap else " serialized")


def load_tree(tree: Path, alias: str):
    """``tree``'s ``jaxstream_torch`` imported as the package ``alias``;
    returns a function giving its submodules by their dotted names."""
    init = tree / "jaxstream_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return lambda name: importlib.import_module(f"{alias}.{name}")


def clocks() -> str:
    """The card's SM clock, power draw and temperature now."""
    return "nvidia-smi " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def sass_counts(lib: Path, nvcc: str) -> dict:
    """SASS instructions per kernel function of ``lib``."""
    tool = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    counts = {}
    for sec in re.split(r"\n\s*Function : ", out)[1:]:
        name = sec.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", sec))
    return counts


def traced_busy(run) -> tuple:
    """``run()`` (``TRACED`` steps) under ``torch.profiler``: the device's
    busy microseconds per step, and the RHS kernels' part of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / TRACED
    rhs = sum(e.self_device_time_total for e in rows
              if any(k in e.key for k in RHS_KERNELS)) / TRACED
    return busy, rhs


class Tree:
    """One tree's package, its TC5 model and its four tier steppers."""

    def __init__(self, path: Path, alias: str, n: int):
        self.path = path
        mod = self.mod = load_tree(path, alias)
        cfg = mod("config")
        grid = mod("geometry.cubed_sphere").build_grid(
            n, halo=2, radius=cfg.EARTH_RADIUS, dtype=torch.float32)
        h, v, b = mod("physics.initial_conditions").williamson_tc5(
            grid, cfg.EARTH_GRAVITY, cfg.EARTH_OMEGA)
        self.model = mod("models.shallow_water_cov").CovariantShallowWater(
            grid, gravity=cfg.EARTH_GRAVITY, omega=cfg.EARTH_OMEGA, b_ext=b)
        self.s0 = self.model.initial_state(h, v)
        self.integrate = mod("stepping").integrate
        self.device_seconds = mod("utils.profiling").device_seconds
        sw = mod("ops.cuda.swe_cov")
        self.counters = (sw.CovRhs, sw.CovRhsInterior, sw.CovRhsLocal)

    def stepper(self, tiles: int, overlap: bool):
        """The path's stepper and its carry after the warm-up steps."""
        mesh = self.mod("parallel.mesh")
        setup = mesh.setup_sharding({"parallelization": {
            "tiles_per_edge": tiles, "num_devices": 6 * tiles * tiles,
            "use_shard_map": True, "overlap_exchange": overlap}})
        step = self.mod("parallel.sharded_model").make_stepper_for(
            self.model, setup, None, DT)
        y, t = self.integrate(step, mesh.shard_state(setup, self.s0), 0.0,
                              WARM, DT)
        torch.cuda.synchronize()
        return step, y, t

    def window(self, step, y, t, steps: int) -> tuple:
        """Wall steps/s over ``steps`` steps, and RHS launches per step."""
        for c in self.counters:
            c.launches = 0
        t0 = time.perf_counter()
        self.integrate(step, y, t, steps, DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return steps / wall, sum(c.launches for c in self.counters) / steps

    def capture_us(self, step, y, t) -> float:
        busy = self.device_seconds(
            lambda: self.integrate(step, y, t, GRAPH_STEPS, DT), replays=5)
        return busy / GRAPH_STEPS * 1e6 if busy else float("nan")


def levers(mod, kern, args, setup, ranks) -> dict:
    """Device microseconds of one RK stage's RHS over all ``ranks`` (CUDA
    graph of 20), the stacked kernel's design taken apart: groups of 3
    (the tiers' form), of 2 and of 1 (a tile's metric and staging per
    rank, no prefetch under another rank's arithmetic), and one launch per
    rank (the grid of one rank, as the earlier design launched); each
    form's outputs bitwise those of the first."""
    RankGroups = mod("ops.cuda.swe_cov").RankGroups
    device_seconds = mod("utils.profiling").device_seconds
    fz, groups, *fields = args
    rows = groups.rank_rows()
    pos = [tuple(setup.coords(r)[1:]) for r in ranks]
    seen = {}
    nth = [seen.setdefault(p, []).append(i) or len(seen[p]) - 1
           for i, p in enumerate(pos)]
    forms = {
        "groups of 3": [args],
        "groups of 2": [(fz, RankGroups(
            [(p, k // 2) for p, k in zip(pos, nth)], *rows), *fields)],
        "groups of 1": [(fz, RankGroups(list(range(len(ranks))), *rows),
                         *fields)],
        "a launch per rank": [
            (fz[r:r + 1], RankGroups([0], *(t[r:r + 1] for t in rows)),
             *(f[r:r + 1] for f in fields)) for r in range(len(ranks))]}
    ref = kern.stacked(*args)
    out = {}
    for name, calls in forms.items():
        got = [kern.stacked(*a) for a in calls]
        if not all(torch.equal(torch.cat([g[k] for g in got]), ref[k])
                   for k in (0, 1)):
            raise RuntimeError(f"{name}: outputs differ from groups of 3")
        busy = device_seconds(
            lambda: [kern.stacked(*a) for _ in range(GRAPH_STEPS)
                     for a in calls], replays=5)
        out[name] = busy / GRAPH_STEPS * 1e6
    return out


def kernel_probe(tree: Tree) -> dict:
    """This tree's stacked B5 / B6: bitwise against plain on the TC5
    state, the device time of one RK stage's launches in each lever form,
    SASS counts."""
    mod, model = tree.mod, tree.model
    build = mod("_build")
    out = {"sass": {name: sass_counts(build.build(name).path,
                                      build.nvcc_path())
                    for name in ("cov_rhs_interior", "cov_rhs_local")}}
    sw = mod("ops.cuda.swe_cov")
    shard_cov = mod("parallel.shard_cov")
    shard_block = mod("parallel.shard_cov_block")
    mesh = mod("parallel.mesh")
    grid = model.grid
    h = grid.halo
    consts = (h, grid.dalpha, grid.radius, model.gravity, model.omega)
    times = {}
    for tiles in (1, 2):
        setup = mesh.setup_sharding({"parallelization": {
            "tiles_per_edge": tiles, "num_devices": 6 * tiles * tiles,
            "use_shard_map": True}})
        ranks = setup.local_ranks
        local = mesh.shard_state(setup, tree.s0)
        n = local["h"].shape[-1]
        q = shard_cov._embed(local["h"], local["u"], h)
        if tiles == 1:
            xr, xfr, yc, yfc, frames = mod("ops.cuda.swe_rhs").coord_rows(
                grid.n, h, grid.device)
            fz = frames[:, None, :, 2].contiguous()
            rows = [t.expand(6, -1, -1) for t in (xr, xfr, yc, yfc)]
            b = model.b_ext
        else:
            program = shard_block.CovBlockProgram(grid, tiles)
            tab = program.rank_tables(ranks, grid.device)
            fz = tab["fz"].contiguous()
            rows = [tab[k] for k in ("xr", "xfr", "yc", "yfc")]
            m = n + 2 * h
            b = torch.stack([
                model.b_ext[f, iy * n:iy * n + m, ix * n:ix * n + m]
                for f, iy, ix in map(setup.coords, ranks)])
            q, ssn, swe = shard_block.make_cov_block_exchange(
                program, setup.ranks, ranks)(q)
        I = slice(h, h + n)
        forms = {f"B5 {_label(tiles, True)}": (
            sw.make_cov_rhs_interior_local(n, *consts), (
                fz, shard_cov.rank_groups(setup, ranks, rows[0][:, :, I],
                                          rows[1][:, :, I], rows[2][:, I],
                                          rows[3][:, I]),
                local["h"], local["u"], b[:, None, I, I].contiguous()))}
        if tiles == 2:
            forms[f"B6 {_label(tiles, False)}"] = (
                sw.make_cov_rhs_pallas_local(n, *consts), (
                    fz, shard_cov.rank_groups(setup, ranks, *rows),
                    q[:, 0:1], q[:, 1:3].unsqueeze(2), b[:, None], ssn,
                    swe))
        for label, (kern, args) in forms.items():
            got = kern.stacked(*args)
            want = kern.stacked_reference(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise RuntimeError(f"{label}: not bitwise equal to plain")
            times[label] = levers(mod, kern, args, setup, ranks)
            print(f"{label}: bitwise; device us per RK stage: " + ", ".join(
                f"{k} {v:.2f}" for k, v in times[label].items()),
                flush=True)
    out["kernel_device_us"] = times
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--turns", type=int, default=2,
                    help="rounds of turns A, B, ..., ..., B, A")
    ap.add_argument("--paths", default=None,
                    help="comma-separated path labels (default: all four)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip this tree's B5/B6 kernel probe")
    a = ap.parse_args()
    labels = [_label(*pt) for pt in PATHS]
    picked = labels if a.paths is None else a.paths.split(",")
    if set(picked) - set(labels):
        ap.error(f"--paths: unknown {sorted(set(picked) - set(labels))}; "
                 f"the labels are {labels}")
    if not torch.cuda.is_available():
        print("torch_tier_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    paths = [Path(t).resolve() for t in a.trees]
    trees = [Tree(p, f"_probe_tree{i}", a.n) for i, p in enumerate(paths)]
    order = (list(range(len(trees))) + list(range(len(trees)))[::-1]) \
        * a.turns
    summary = {str(p): {} for p in paths}
    for tiles, overlap in PATHS:
        label = _label(tiles, overlap)
        if label not in picked:
            continue
        runs = [tr.stepper(tiles, overlap) for tr in trees]
        rates = [[] for _ in trees]
        devs = [[] for _ in trees]
        launches = [0.0] * len(trees)
        for i in order:
            rate, launches[i] = trees[i].window(*runs[i], a.steps)
            rates[i].append(rate)
        for i in order:
            devs[i].append(trees[i].capture_us(*runs[i]))
        for i, (tr, (step, y, t)) in enumerate(zip(trees, runs)):
            busy, rhs = traced_busy(
                lambda: tr.integrate(step, y, t, TRACED, DT))
            rec = {"device_us": min(devs[i]), "device_us_all": devs[i],
                   "busy_us": busy, "rhs_us": rhs,
                   "steps_s": sum(rates[i]) / len(rates[i]),
                   "steps_s_all": rates[i], "rhs_launches": launches[i]}
            summary[str(tr.path)][label] = rec
            print(f"{tr.path} {label}: device {rec['device_us']:.2f} "
                  f"us/step (least of {len(devs[i])} CUDA-graph captures "
                  f"of {GRAPH_STEPS} steps: "
                  + ", ".join(f"{d:.2f}" for d in devs[i])
                  + f"); profiler busy {busy:.1f} us/step, RHS kernels "
                  f"{rhs:.1f}; {rec['steps_s']:.1f} steps/s ("
                  + ", ".join(f"{r:.1f}" for r in rates[i])
                  + f" over {a.steps} steps each); {launches[i]:g} RHS "
                  f"launches/step; {clocks()}; card {card}", flush=True)
        del runs
    kernels = None
    if ROOT in paths and not a.no_kernels:
        kernels = kernel_probe(trees[paths.index(ROOT)])
    print(json.dumps({"card": card, "n": a.n, "steps": a.steps,
                      "order": [str(paths[i]) for i in order],
                      "summary": summary, "this_tree": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
