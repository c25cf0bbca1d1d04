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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Set

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "jaxstream_torch"

#: Kernel library name -> its source under ``csrc/``.
KERNELS = {"cov_stage": "cov_stage.cu",
           "cov_nu4_filter": "cov_nu4_filter.cu",
           "cov_stage_refused_nu4": "cov_stage_refused_nu4.cu",
           "cov_stage_nu4": "cov_stage_nu4.cu",
           "cov_rhs": "cov_rhs.cu",
           "cov_rhs_interior": "cov_rhs_interior.cu",
           "cov_rhs_local": "cov_rhs_local.cu",
           "cov_stage_inkernel": "cov_stage_inkernel.cu",
           "cov_stage_nbr": "cov_stage_nbr.cu",
           "cov_step_mega": "cov_step_mega.cu",
           "swe_rhs": "swe_rhs.cu",
           "swe_stage": "swe_stage.cu",
           "swe_stage_inkernel": "swe_stage_inkernel.cu",
           "cov_stage_policy": "cov_stage_policy.cu",
           "cov_stage_policy_bf16": "cov_stage_policy_bf16.cu",
           "cov_nu4_filter_bf16": "cov_nu4_filter_bf16.cu",
           "cov_stage_refused_nu4_policy": "cov_stage_refused_nu4_policy.cu",
           "cov_stage_refused_nu4_policy_bf16":
               "cov_stage_refused_nu4_policy_bf16.cu",
           "cov_stage_inkernel_bf16": "cov_stage_inkernel_bf16.cu",
           "cov_stage_members": "cov_stage_members.cu"}

#: The libraries of the stage precision policy, the carry encodings and the
#: ensemble member axis: their sources include another kernel's source
#: with a macro that selects the policy instances, or include
#: ``cov_half.cuh``'s 16-bit conversions.
POLICY_KERNELS = ("cov_stage_policy", "cov_stage_policy_bf16",
                  "cov_nu4_filter_bf16", "cov_stage_refused_nu4_policy",
                  "cov_stage_refused_nu4_policy_bf16",
                  "cov_stage_inkernel_bf16", "cov_stage_members")

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
#: How many libraries ``nvcc`` built in this process.
nvcc_builds = 0
_count_lock = threading.Lock()
# Per thread: the set that :func:`recording` collects library names in.
_recorder = threading.local()


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


def target_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built: in
    :data:`BUILD_DIR`, named by the digest of the sources and flags."""
    # The key covers the shared headers and the other sources too: every
    # kernel includes the headers, and a policy library another source.
    sources = [CSRC_DIR / KERNELS[name]] + sorted(CSRC_DIR.glob("*.cuh")) \
        + sorted(CSRC_DIR.glob("*.cu"))
    key = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                         + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def sources_digest() -> str:
    """The digest of every source and header under ``csrc/`` and the nvcc
    flags: what every library's build depends on."""
    sources = sorted(CSRC_DIR.glob("*.cuh")) + sorted(CSRC_DIR.glob("*.cu"))
    key = hashlib.sha256(b"".join(s.name.encode() + s.read_bytes()
                                  for s in sources)
                         + " ".join(NVCC_FLAGS).encode())
    return key.hexdigest()[:16]


def set_build_dir(path) -> None:
    """Build into and load from ``path`` from now on (a shared library
    directory: the serving warm pool's ``compile_cache`` rung)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


@contextlib.contextmanager
def recording():
    """Collect, in the yielded set, the name of every library this thread
    asks :func:`load` for inside the block (a launch asks each time)."""
    prev = getattr(_recorder, "names", None)
    names: Set[str] = set()
    _recorder.names = names
    try:
        yield names
    finally:
        _recorder.names = prev


def build(name: str) -> Built:
    """Build kernel ``name`` with ``nvcc`` unless its library exists.
    Raises if the build fails."""
    global nvcc_builds
    target = target_path(name)
    if target.exists():
        return Built(name, target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / KERNELS[name])]
    t0 = time.perf_counter()
    with _count_lock:
        nvcc_builds += 1
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
    names: Optional[Set[str]] = getattr(_recorder, "names", None)
    if names is not None:
        names.add(name)
    lib = _loaded.get(name)
    if lib is None:
        built = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(built.path))
    return lib


def loaded_libraries() -> frozenset:
    """Names of the kernel libraries :func:`load` has opened in this
    process (each is built, or found built, at its first load)."""
    return frozenset(_loaded)
