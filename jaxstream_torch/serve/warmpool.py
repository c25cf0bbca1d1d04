"""Disk-backed warm pools for the serving buckets (counterpart of
:mod:`jaxstream.serve.warmpool`).

What a bucket's warm-up costs in the port.  PyTorch compiles nothing per
call, so a cold :class:`~.server.EnsembleServer` bucket pays for (1) the
``nvcc`` builds of the kernel libraries its stepper launches (seconds a
library, into ``jaxstream_torch._build.BUILD_DIR``, unless a library of
the same sources is there), (2) the tables its stepper builds on the host
before its first launch (the split router's gather indices, rotation
entries and seam tables, the edge sqrtg rows, the stage kernels'
coordinate rows and frames: :mod:`jaxstream_torch.ops.cuda.tables`), and
(3) one probe segment.  The pool persists (1) and (2), so that a
restarted or newly spawned server loads what a cold one builds.

**Cache key.**  The JAX package's schema (:func:`entry_key`): the
bucket's plan key and proof fingerprint, the rules version, the
:func:`deployment_digest` (the same fields, JSON and digest as the JAX
package's, so the same YAML gives the same hex) and the environment.
The environment names the port's toolchain instead of jax and jaxlib:
the torch version, the CUDA runtime, ``nvcc --version`` (``"none"``
where there is no nvcc), the device's name, its compute capability, the
device count, and the digest of the kernel sources and nvcc flags.  A
change in any field is another key: a miss, never a stale hit, and a
library built for another card or toolchain never reaches ``dlopen``.

**Degradation ladder** (:meth:`WarmPool.load` / :meth:`WarmPool.save`),
each rung a typed sink record (``hit``, ``miss``, ``save``, ``corrupt``,
``probe``, ``fallback``), the rung names the JAX package's:

1. ``aot`` — the entry holds the bucket's kernel libraries (the ``.so``
   files ``_build`` opened for it; the meta records each file's sha256
   and length) and its tables (``torch.save``; read back with
   ``torch.load(weights_only=True)``).  A load installs each library in
   the build directory under the name ``_build`` gives it (the digest of
   its sources and flags), where ``_build.load`` finds it, and hands the
   tables to the bucket's build: zero ``nvcc`` builds and zero table
   builds.  A library is installed only where no file of its name is, so
   a path that a process has opened is never written again (``dlopen``
   does not load a path twice).  On the CPU a bucket launches no
   library, and its entry holds the tables alone at this rung.
2. ``stablehlo`` — the tables only, where a library's file could not be
   read at save time: the libraries then come from ``_build``'s cache or
   from ``nvcc``.
3. ``compile_cache`` — ``serve.compile_cache`` names a library directory
   that ``_build`` builds into and loads from, shared by the servers
   that name it.  It is gated by :func:`probe_rung`: a child process
   builds one small library there with ``nvcc`` and a second one loads
   it.  The verdict is cached per toolchain and is a typed record, never
   a silent skip; where there is no ``nvcc`` (the CPU) it is
   "unavailable".
4. cold — the pool returns None.

No CUDA graph is persisted: a graph is not portable across processes, so
the ``aot`` rung is the libraries and the tables, and a segment runs
eagerly as it always did.

**Atomicity.**  As the JAX package's entries: every payload lands by a
temporary file and ``os.replace``; the meta, which names each payload's
sha256 and length, is written last, so a reader sees a whole entry or
none.  A meta whose payload is missing, short or of another digest is a
torn entry: detected, deleted, recorded (``corrupt``) and rebuilt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional

from ..utils.logging import get_logger

__all__ = ["WarmPool", "WarmEntry", "HeadroomRefused", "entry_key",
           "deployment_digest", "probe_rung", "SpeculativeCompiler",
           "RUNGS", "ENV_FIELDS"]

log = get_logger(__name__)

#: The degradation ladder, best rung first.  Cold is implicit: the pool
#: returning None is the cold rung.
RUNGS = ("aot", "stablehlo", "compile_cache")

#: The toolchain fields of an entry's key.
ENV_FIELDS = ("torch", "cuda", "nvcc", "device", "capability",
              "device_count", "kernels")


class HeadroomRefused(ValueError):
    """A resize or speculation target whose stamped per-chip footprint
    would breach ``serve.min_headroom_frac`` (only scale-up decisions
    enforce the advisory ``headroom_frac``)."""


# ------------------------------------------------------------- cache key
def deployment_digest(config) -> str:
    """Digest of the config fields the plan key does not carry (dt, the
    segment steps, del^4, gravity, the limiter, the precision policy,
    ...): two deployments that differ in any of them run different
    programs under one plan key.  The JAX package's fields, JSON and
    ``sha256[:16]``: the same config gives the same hex."""
    cfg = config
    ident = {
        "grid": {"n": cfg.grid.n, "halo": cfg.grid.halo,
                 "radius": cfg.grid.radius, "dtype": cfg.grid.dtype,
                 "metrics": cfg.grid.metrics},
        "time": {"dt": cfg.time.dt, "scheme": cfg.time.scheme},
        "physics": {"gravity": cfg.physics.gravity,
                    "omega": cfg.physics.omega,
                    "nu4": cfg.physics.hyperdiffusion,
                    "d2": cfg.physics.divergence_damping},
        "model": {"scheme": cfg.model.scheme,
                  "limiter": cfg.model.limiter,
                  "backend": cfg.model.backend,
                  "nu4_mode": cfg.model.nu4_mode,
                  "ic_angle": cfg.model.ic_angle},
        "precision": {"stage": cfg.precision.stage,
                      "strips": cfg.precision.strips,
                      "carry": cfg.precision.carry},
        "serve": {"segment_steps": cfg.serve.segment_steps,
                  "donate": cfg.serve.donate,
                  "group_by_orography": cfg.serve.group_by_orography},
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


_NVCC_VERSION: Dict[str, str] = {}


def _nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build), or ``"none"``."""
    from .. import _build

    try:
        path = _build.nvcc_path()
    except RuntimeError:
        return "none"
    if path not in _NVCC_VERSION:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True).stdout.strip()
        _NVCC_VERSION[path] = out.splitlines()[-1] if out else "unknown"
    return _NVCC_VERSION[path]


def _environment_fields(device=None) -> dict:
    """The toolchain identity a bucket's libraries and tables depend on,
    for a server on ``device`` (default: the first GPU where there is
    one)."""
    import torch

    from .. import _build

    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else 0
        name = torch.cuda.get_device_name(idx)
        cap = "%d.%d" % torch.cuda.get_device_capability(idx)
        count = torch.cuda.device_count()
    else:
        name, cap, count = "cpu", "none", 0
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda or "none",
            "nvcc": _nvcc_version(), "device": name, "capability": cap,
            "device_count": count, "kernels": _build.sources_digest()}


def entry_key(plan_key: str, proof_fingerprint: Optional[str],
              rules_version: int, deploy_digest: str, fn: str,
              environment: Optional[dict] = None) -> str:
    """One entry's content-addressed key (hex digest): the JAX package's
    schema, with the port's toolchain fields (:data:`ENV_FIELDS`) as its
    environment.  ``fn`` names what the entry holds (the server's
    buckets: ``"bucket"``).  ``environment`` is injectable, so that the
    tests can prove that a changed toolchain field misses."""
    env = environment if environment is not None else _environment_fields()
    ident = {
        "plan_key": plan_key,
        "proof_fingerprint": proof_fingerprint,
        "rules_version": int(rules_version),
        "deploy": deploy_digest,
        "fn": fn,
        "env": {k: env.get(k) for k in ENV_FIELDS},
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


# ------------------------------------------------------ subprocess probe
#: One probe arm in a child process.  argv: [nvcc, scratch_dir, phase]:
#: 'write' builds a one-function library with the port's nvcc flags into
#: the scratch directory; 'read' (another process) loads it and calls it.
_PROBE_SCRIPT = r"""
import ctypes, os, subprocess, sys
nvcc, scratch, phase = sys.argv[1], sys.argv[2], sys.argv[3]
flags = sys.argv[4:]
lib = os.path.join(scratch, "libprobe.so")
if phase == "write":
    src = os.path.join(scratch, "probe.cu")
    with open(src, "w") as fh:
        fh.write('extern "C" int probe_add(int a) { return a + 1; }\n')
    proc = subprocess.run([nvcc, *flags, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
else:
    fn = ctypes.CDLL(lib).probe_add
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert fn(2) == 3
"""


def probe_rung(rung: str, scratch_dir: str, timeout: float = 120.0) -> dict:
    """Cross-process probe of the ``compile_cache`` rung: a child process
    builds a one-function library with ``nvcc`` (the port's flags) in
    ``scratch_dir``, and a second child loads and calls it.  Returns the
    verdict ``{"rung", "ok", "detail"}``: a failed or timed-out child is
    ``ok: False``, and a machine without ``nvcc`` is "unavailable"
    without starting any child.  Never raises for a failed probe."""
    from .. import _build

    if rung != "compile_cache":
        raise ValueError(f"unprobed rung {rung!r}; the probe covers "
                         "('compile_cache',)")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError as e:
        return {"rung": rung, "ok": False,
                "detail": f"unavailable: {e}"}
    os.makedirs(scratch_dir, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    for phase in ("write", "read"):
        try:
            res = subprocess.run(
                [sys.executable, "-c", _PROBE_SCRIPT, nvcc, scratch_dir,
                 phase, *flags],
                capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"rung": rung, "ok": False,
                    "detail": f"{phase} probe timed out at {timeout}s"}
        if res.returncode != 0:
            tail = (res.stderr or res.stdout or "").strip()[-300:]
            return {"rung": rung, "ok": False,
                    "detail": f"{phase} probe exited {res.returncode}: "
                              f"{tail}"}
    return {"rung": rung, "ok": True,
            "detail": "cross-process build+load probes exited clean"}


# --------------------------------------------------------------- the pool
@dataclasses.dataclass
class WarmEntry:
    """A loaded entry: its rung, the bucket's tables (``{key: tensors}``
    for :class:`~jaxstream_torch.ops.cuda.tables.TableStore`) and the
    libraries it installed (or found installed)."""
    rung: str
    tables: dict
    libraries: List[str]


class WarmPool:
    """One directory of bucket entries and rung probe verdicts.

    ``sink_write`` receives the typed ``warmpool`` records;
    ``counter_inc`` is the metrics hook (``jaxstream_warmpool_*``).
    ``environment`` (default: :func:`_environment_fields` of ``device``)
    and ``probe`` (default: :func:`probe_rung`) are injectable.
    Thread-safe: the speculative compiler and the serving thread share
    one pool under ``self._lock``.
    """

    def __init__(self, path: str, compile_cache: str = "",
                 sink_write: Optional[Callable] = None,
                 counter_inc: Optional[Callable] = None,
                 environment: Optional[dict] = None,
                 probe: Optional[Callable] = None, device=None):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.compile_cache = compile_cache
        self._sink_write = sink_write
        self._counter_inc = counter_inc
        self._environment = environment
        self._device = device
        self._probe = probe if probe is not None else probe_rung
        self._lock = threading.Lock()
        self._verdicts: Dict[str, dict] = {}
        self.stats = {"hits": 0, "misses": 0, "saves": 0,
                      "corrupt": 0, "rungs": {}}
        self._cache_enabled = False

    @property
    def environment(self) -> dict:
        """The toolchain fields this pool's keys carry."""
        if self._environment is None:
            self._environment = _environment_fields(self._device)
        return self._environment

    # ------------------------------------------------------------ records
    def _record(self, event: str, rung: str, plan: Optional[str],
                **extra) -> None:
        rec = {"kind": "warmpool", "event": event, "rung": rung,
               "plan": plan}
        rec.update(extra)
        if self._sink_write is not None:
            try:
                self._sink_write(rec)
            except Exception as e:  # telemetry must never kill serving
                log.warning("warmpool sink record failed (%s: %s)",
                            type(e).__name__, e)
        if self._counter_inc is not None:
            try:
                if event == "hit":
                    self._counter_inc("jaxstream_warmpool_hits_total",
                                      1, rung=rung)
                elif event == "miss":
                    self._counter_inc(
                        "jaxstream_warmpool_misses_total", 1,
                        reason=str(extra.get("reason", "absent")))
                elif event == "save":
                    self._counter_inc("jaxstream_warmpool_saves_total",
                                      1, rung=rung)
            except Exception:
                pass

    # ------------------------------------------------------------- paths
    def _payload_path(self, key: str) -> str:
        """The entry's tables payload."""
        return os.path.join(self.path, f"{key}.tables.pt")

    def _library_path(self, key: str, name: str) -> str:
        return os.path.join(self.path, f"{key}.lib{name}.so")

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        from ..obs.flight import _atomic_write_bytes

        _atomic_write_bytes(path, data)

    # ------------------------------------------------------------ probing
    def rung_verdict(self, rung: str) -> dict:
        """The cached probe verdict of one rung: in-process per pool, and
        on disk beside the entries, keyed by the toolchain (torch, CUDA,
        nvcc), so that servers sharing a pool directory probe once.  A
        typed ``probe`` record either way."""
        if rung in self._verdicts:
            return self._verdicts[rung]
        env = self.environment
        tag = hashlib.sha256(json.dumps(
            {"rung": rung, "torch": env.get("torch"),
             "cuda": env.get("cuda"), "nvcc": env.get("nvcc")},
            sort_keys=True).encode()).hexdigest()[:16]
        vpath = os.path.join(self.path, f"probe_{rung}_{tag}.json")
        verdict = None
        if os.path.exists(vpath):
            try:
                with open(vpath) as fh:
                    verdict = json.load(fh)
                if verdict.get("rung") != rung:
                    verdict = None
            except Exception:
                verdict = None
        cached = verdict is not None
        if verdict is None:
            verdict = self._probe(
                rung, os.path.join(self.path, f"_probe_{rung}"))
            try:
                self._atomic_write(vpath, json.dumps(verdict).encode())
            except OSError as e:
                log.warning("warmpool: probe verdict not cached (%s: %s)",
                            type(e).__name__, e)
        self._verdicts[rung] = verdict
        self._record("probe", rung, None, ok=bool(verdict.get("ok")),
                     detail=str(verdict.get("detail", "")),
                     cached=cached)
        return verdict

    def enable_compile_cache(self) -> bool:
        """Point ``_build`` at ``serve.compile_cache`` iff it is configured
        and the probe found a cross-process build and load sound on this
        toolchain (else a typed ``fallback`` record).  Idempotent; returns
        whether the shared directory is on."""
        if self._cache_enabled:
            return True
        if not self.compile_cache:
            return False
        verdict = self.rung_verdict("compile_cache")
        if not verdict.get("ok"):
            self._record("fallback", "compile_cache", None,
                         reason=str(verdict.get("detail", "")))
            return False
        from .. import _build

        os.makedirs(self.compile_cache, exist_ok=True)
        _build.set_build_dir(self.compile_cache)
        self._cache_enabled = True
        return True

    # ------------------------------------------------------------ loading
    def load(self, key: str, plan_key: Optional[str] = None,
             device=None) -> Optional[WarmEntry]:
        """One entry -> a :class:`WarmEntry` (its libraries installed, its
        tables on ``device``), or None (cold).  An absent entry is a
        ``miss`` (reason 'absent'); a meta whose payloads are missing,
        short or of another digest is torn: deleted, recorded
        (``corrupt``) and reported as a miss, never a crash."""
        with self._lock:
            return self._load_locked(key, plan_key, device)

    def _entry_files(self, key: str, meta: dict) -> List[str]:
        return [self._payload_path(key)] + [
            self._library_path(key, lib["name"])
            for lib in meta.get("libraries", ())]

    def _load_locked(self, key, plan_key, device):
        import torch

        from .. import _build

        mpath = self._meta_path(key)
        if not os.path.exists(mpath):
            self.stats["misses"] += 1
            self._record("miss", "cold", plan_key, key=key,
                         reason="absent")
            return None
        meta = {}
        try:
            with open(mpath) as fh:
                meta = json.load(fh)
            blobs = {}
            for spec, path in zip([meta["tables"]] + meta["libraries"],
                                  self._entry_files(key, meta)):
                with open(path, "rb") as fh:
                    data = fh.read()
                if len(data) != int(spec["length"]):
                    raise ValueError(
                        f"{os.path.basename(path)} is {len(data)}B, meta "
                        f"says {spec['length']}B")
                if hashlib.sha256(data).hexdigest() != spec["sha256"]:
                    raise ValueError(f"{os.path.basename(path)}: sha256 "
                                     "mismatch")
                blobs[path] = data
            tables = torch.load(io.BytesIO(blobs[self._payload_path(key)]),
                                map_location=device, weights_only=True)
            rung = meta["rung"]
            if rung not in ("aot", "stablehlo"):
                raise ValueError(f"unknown entry rung {rung!r}")
            names = []
            for lib in meta["libraries"]:
                target = _build.target_path(lib["name"])
                if target.name != lib["target"]:
                    raise ValueError(
                        f"library {lib['name']} was built as "
                        f"{lib['target']}, this tree builds {target.name}")
                if not target.exists():
                    target.parent.mkdir(parents=True, exist_ok=True)
                    self._atomic_write(
                        str(target),
                        blobs[self._library_path(key, lib["name"])])
                names.append(lib["name"])
        except Exception as e:
            # Torn or corrupt: loud, deleted, rebuilt.
            self.stats["corrupt"] += 1
            self.stats["misses"] += 1
            for p in [mpath] + (self._entry_files(key, meta)
                                if "libraries" in meta
                                else [self._payload_path(key)]):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            log.warning("warmpool: entry %s is torn/corrupt (%s: %s); "
                        "deleted, rebuilding", key, type(e).__name__, e)
            self._record("corrupt", "cold", plan_key, key=key,
                         reason=f"{type(e).__name__}: {e}")
            self._record("miss", "cold", plan_key, key=key,
                         reason="corrupt")
            return None
        self.stats["hits"] += 1
        self.stats["rungs"][rung] = self.stats["rungs"].get(rung, 0) + 1
        self._record("hit", rung, plan_key, key=key)
        return WarmEntry(rung, tables, names)

    # ------------------------------------------------------------- saving
    def save(self, key: str, tables: dict, libraries=(),
             plan_key: Optional[str] = None) -> Optional[str]:
        """Persist one bucket at the best rung this machine gives:
        ``aot`` with the built files of ``libraries`` (names of
        ``_build.KERNELS``) and the ``tables``, ``stablehlo`` with the
        tables alone where a library's file cannot be read (a typed
        ``fallback`` record says which).  Returns the rung, or None (the
        entry could not be written; the compile cache is then tried)."""
        with self._lock:
            return self._save_locked(key, tables, sorted(libraries),
                                     plan_key)

    def _save_locked(self, key, tables, libraries, plan_key):
        import torch

        from .. import _build

        buf = io.BytesIO()
        torch.save(tables, buf)
        payload = buf.getvalue()
        libs, rung = [], "aot"
        for name in libraries:
            target = _build.target_path(name)
            try:
                data = target.read_bytes()
            except OSError as e:
                self._record("fallback", "aot", plan_key,
                             reason=f"library {name} unreadable "
                                    f"({type(e).__name__}: {e})")
                libs, rung = [], "stablehlo"
                break
            libs.append((name, target.name, data))
        meta = {"key": key, "rung": rung, "plan_key": plan_key,
                "tables": {"sha256": hashlib.sha256(payload).hexdigest(),
                           "length": len(payload)},
                "libraries": [{"name": name, "target": tname,
                               "sha256": hashlib.sha256(data).hexdigest(),
                               "length": len(data)}
                              for name, tname, data in libs]}
        try:
            # Payloads first, the meta that makes the entry visible last:
            # a kill between them leaves invisible payloads, not a torn
            # entry.
            self._atomic_write(self._payload_path(key), payload)
            for name, _, data in libs:
                self._atomic_write(self._library_path(key, name), data)
            self._atomic_write(self._meta_path(key),
                               json.dumps(meta).encode())
        except OSError as e:
            self._record("fallback", rung, plan_key,
                         reason=f"entry write failed "
                                f"({type(e).__name__}: {e})")
            self.enable_compile_cache()
            return None
        self.stats["saves"] += 1
        self._record("save", rung, plan_key, key=key,
                     bytes=len(payload) + sum(len(d) for *_, d in libs))
        return rung

    def summary(self) -> dict:
        """The ``/v1/stats`` payload: counters and probed verdicts."""
        return {
            "path": self.path,
            "compile_cache": (self.compile_cache
                              if self._cache_enabled else ""),
            "hits": self.stats["hits"],
            "misses": self.stats["misses"],
            "saves": self.stats["saves"],
            "corrupt": self.stats["corrupt"],
            "rungs": dict(self.stats["rungs"]),
            "probes": {r: {"ok": v.get("ok"),
                           "detail": v.get("detail")}
                       for r, v in sorted(self._verdicts.items())},
        }


# ------------------------------------------------- speculative compiler
class SpeculativeCompiler:
    """Builds the buckets adjacent to the active cap on a thread of its
    own, through the server's own bucket build (its build lock, its
    pool save), so that a later :meth:`~.server.EnsembleServer.resize`
    finds them warm.  A headroom-refused target is skipped with the
    typed record ``resize`` writes.  On the card the thread launches its
    warm-up probe on a CUDA stream of its own (the server's
    ``_bucket``), so the serving thread's stream and results are not
    touched."""

    THREAD_NAME = "jaxstream-serve-speculator"

    def __init__(self, server):
        self._server = server
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._targets: List[int] = []
        self._lock = threading.Lock()
        self.built: List[tuple] = []
        self.skipped: List[dict] = []
        self._thread = threading.Thread(
            target=self._run, name=self.THREAD_NAME, daemon=True)
        self._thread.start()

    def nudge(self, cap: int) -> None:
        """Target the configured buckets next to ``cap``."""
        buckets = list(self._server.buckets)
        try:
            i = buckets.index(int(cap))
        except ValueError:
            return
        adjacent = [buckets[j] for j in (i + 1, i - 1)
                    if 0 <= j < len(buckets)]
        with self._lock:
            self._targets = adjacent
        self._wake.set()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                targets, self._targets = self._targets, []
            for B in targets:
                if self._stop.is_set():
                    return
                try:
                    self._build(B)
                except Exception as e:
                    # A failed speculative build must never hurt serving:
                    # the bucket's first use builds it.
                    log.warning("warmpool: speculative build of B=%d "
                                "failed (%s: %s)", B, type(e).__name__, e)

    def _build(self, B: int) -> None:
        srv = self._server
        for group in srv.warm_groups():
            if (group, B) in srv._buckets:
                continue
            refusal = srv.headroom_refusal(B)
            if refusal is not None:
                self.skipped.append(refusal)
                srv.record_headroom_refusal(refusal,
                                            action="speculate_refused")
                continue
            srv._bucket(group, B, side_stream=True)
            self.built.append((group, B))
