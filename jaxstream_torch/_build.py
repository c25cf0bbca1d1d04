"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes, to build) and loaded with ``ctypes``.  Libraries go to
``build/jaxstream_torch/`` at the root of the checkout, named by a hash
of their source and flags, so a changed source is rebuilt and an
unchanged one is reused.  A build happens at first use, from the
repository's sources alone; nothing is compiled when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "jaxstream_torch"

#: Kernel library name -> its source under ``csrc/``.
KERNELS = {"cov_stage": "cov_stage.cu",
           "cov_nu4_filter": "cov_nu4_filter.cu",
           "cov_stage_refused_nu4": "cov_stage_refused_nu4.cu",
           "cov_stage_nu4": "cov_stage_nu4.cu",
           "cov_rhs": "cov_rhs.cu",
           "cov_stage_inkernel": "cov_stage_inkernel.cu",
           "cov_stage_nbr": "cov_stage_nbr.cu",
           "cov_step_mega": "cov_step_mega.cu",
           "swe_rhs": "swe_rhs.cu",
           "swe_stage": "swe_stage.cu",
           "swe_stage_inkernel": "swe_stage_inkernel.cu"}

# -fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch version rounds them; the kernels are memory-bound, so
# the fused multiply-adds would buy no time.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-lineinfo", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")


@dataclass
class Built:
    """A kernel library on disk, with what its build printed."""

    name: str
    path: Path
    seconds: float       # 0.0 when an earlier build was reused
    log: str             # nvcc's output, including the -Xptxas -v lines


_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "jaxstream_torch are compiled on the machine with the GPU")
    return found


def _target(name: str) -> Path:
    # The key covers the shared headers too: every kernel includes them.
    sources = [CSRC_DIR / KERNELS[name]] + sorted(CSRC_DIR.glob("*.cuh"))
    key = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                         + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Build kernel ``name`` with ``nvcc`` unless its library exists.
    Raises if the build fails."""
    target = _target(name)
    if target.exists():
        return Built(name, target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / KERNELS[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    return Built(name, target, time.perf_counter() - t0, proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        built = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(built.path))
    return lib
