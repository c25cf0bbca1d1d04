"""SASS instruction counts and ptxas figures of kernel libraries, per tree.

    python3 scripts/torch_sass_counts.py [--libs a,b,...] TREE [TREE ...]

Builds each named library of ``jaxstream_torch._build.KERNELS`` (default:
all) from each tree's ``jaxstream_torch/csrc`` with the port's nvcc flags,
one nvcc per source, all started together, into ``build/jaxstream_torch/
sass/<tree>/``, and prints for every kernel function its SASS instruction
count (``cuobjdump -sass``) and its ptxas registers, static shared bytes
and spill-store bytes, the reconstruction-mode instances marked by their
mode.  A tree is a directory holding ``jaxstream_torch/csrc`` (this
checkout is ``.``; an earlier one, ``git archive <commit>
jaxstream_torch/csrc | tar -x -C build/jaxstream_torch/parent``).  The
functions' names carry a hash of their file, so two trees are compared
by the counts, in ptxas's order: for each library, a last line says
whether every later tree's PLR-MC functions (those without a mode) build
to the first tree's SASS counts and ptxas figures.  Needs the CUDA
toolkit (the machine with the GPU).
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import MODE_KERNEL, ptxas_usage, sass_counts  # noqa: E402
from jaxstream_torch import _build  # noqa: E402


def build(tree: Path, name: str) -> tuple:
    """Library ``name`` of ``tree``: its path and nvcc's log."""
    out = _build.BUILD_DIR / "sass" / tree.resolve().name
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(tree / "jaxstream_torch" / "csrc" / _build.KERNELS[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {name}: nvcc exit {proc.returncode}\n"
                           f"{proc.stdout}")
    return lib, proc.stdout


def main() -> int:
    args = sys.argv[1:]
    names = list(_build.KERNELS)
    if args[:1] == ["--libs"]:
        names, args = args[1].split(","), args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 1
    trees = [Path(a) for a in args]
    jobs = [(t, nm) for t in trees for nm in names]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs)))
    for nm in names:
        plain = {}
        for t in trees:
            lib, log = built[(t, nm)]
            sass = sass_counts(lib)
            rows = []
            for fn, regs, smem, spill in ptxas_usage(log):
                m = MODE_KERNEL.search(fn)
                tag = " ".join(m.groups()) if m else "mc"
                rows.append(f"{tag}: sass {sass.get(fn, -1)}, regs {regs}, "
                            f"smem {smem}, spill {spill}")
                if m is None:
                    plain.setdefault(t, []).append(
                        (sass.get(fn, -1), regs, smem, spill))
            print(f"{nm} [{t}]: " + "; ".join(rows), flush=True)
        first = plain.get(trees[0], [])
        for t in trees[1:]:
            got = plain.get(t, [])
            print(f"{nm} [{t}] PLR-MC functions (sass, regs, smem, spill) "
                  + ("as " if got == first else f"{got}, not as ")
                  + f"[{trees[0]}] {first}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
