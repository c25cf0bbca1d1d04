"""Always-on flight recorder and atomic crash-forensics bundles.

Counterpart of :mod:`jaxstream.obs.flight` (pure Python in both
packages; the port keeps its own copy).  Every process keeps a bounded
in-memory ring of typed, timestamped events per thread (segment
boundaries, checkpoints, guard events, writer failures and
backpressure) that costs one deque append in steady state and writes
nothing until a crash.  On a :class:`HealthError` or an unhandled
exception ``Simulation`` flushes the ring into an atomic crash bundle,
which ``scripts/postmortem.py`` reads.

A bundle is one directory: ``events-<commit>.jsonl`` (the merged ring,
one event a line) and ``bundle.json``, the manifest, written last by
temp file + ``os.replace`` (the commit point), naming the events file
with its sha256 and line count.  :func:`read_bundle` re-verifies them
and raises :class:`TornBundleError` on any mismatch.  The bundle format
is the JAX package's, so either package's readers take the other's
bundles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from itertools import count
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "FlightRecorder",
    "BundleWriter",
    "TornBundleError",
    "RECORDER",
    "record",
    "disabled",
    "read_bundle",
    "latest_bundle",
    "resolve_flight_dir",
    "open_request_manifest",
    "BUNDLE_MANIFEST",
    "RING_CAPACITY",
    "BUNDLE_SCHEMA_VERSION",
]

#: Per-thread ring bound.  2048 events cover minutes of segment
#: boundaries; the ring exists for the LAST moments
#: before death, not for history (sinks are history).
RING_CAPACITY = 2048

#: The manifest file name — its atomic replacement IS the bundle commit.
BUNDLE_MANIFEST = "bundle.json"

BUNDLE_SCHEMA_VERSION = 1


class TornBundleError(RuntimeError):
    """A crash bundle that failed verification: missing/unparseable
    manifest, missing events file, digest or line-count mismatch.  A
    torn bundle is evidence of a kill mid-commit (or tampering) and
    every forensic entry point must reject it nonzero."""


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-to-temp + ``os.replace`` (the zarrlite pattern): readers
    see the old bytes or the new bytes, never a torn file."""
    tmp = f"{path}.__tmp__{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _Ring:
    """One thread's sub-ring: a bounded deque plus an append counter
    (``maxlen`` drops silently; the counter makes the loss loud)."""

    __slots__ = ("thread", "events", "appended")

    def __init__(self, thread: str, capacity: int):
        self.thread = thread
        self.events: deque = deque(maxlen=capacity)
        self.appended = 0


class FlightRecorder:
    """Bounded in-memory event ring, merged across threads at dump time.

    ``record`` is the always-on hot path: one global sequence stamp,
    one wall-clock read, one deque append — no lock after a thread's
    first event, no I/O ever.  ``dump()`` merges every thread's ring
    into one sequence-ordered event list; ``disabled()`` is the
    A/B context manager the bench overhead measurement and the
    sink-byte-identity tests use.
    """

    def __init__(self, capacity: int = RING_CAPACITY):
        self.capacity = int(capacity)
        self.enabled = True
        self._seq = count()
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ record
    def record(self, etype: str, **fields) -> None:
        """Append one typed event to the calling thread's ring."""
        if not self.enabled:
            return
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(threading.current_thread().name, self.capacity)
            self._local.ring = ring
            with self._lock:
                self._rings.append(ring)
        ring.appended += 1
        ring.events.append((next(self._seq), time.time(), etype, fields))

    @contextmanager
    def disabled(self):
        """Temporarily turn the recorder off (bench A/B, byte-identity
        tests).  Not reentrancy-counted: the recorder is process-global
        and the two call sites are tests and the bench."""
        prev = self.enabled
        self.enabled = False
        try:
            yield self
        finally:
            self.enabled = prev

    # -------------------------------------------------------------- dump
    def dump(self) -> Tuple[List[dict], Dict[str, int], int]:
        """Merge the per-thread rings: ``(events, per-thread appended
        counts, total dropped)`` with events ordered by the global
        sequence stamp."""
        with self._lock:
            rings = list(self._rings)
        merged = []
        appended: Dict[str, int] = {}
        dropped = 0
        for ring in rings:
            appended[ring.thread] = (appended.get(ring.thread, 0)
                                     + ring.appended)
            events = list(ring.events)
            dropped += ring.appended - len(events)
            for seq, t, etype, fields in events:
                merged.append({"seq": seq, "t": round(t, 6),
                               "thread": ring.thread, "type": etype,
                               **fields})
        merged.sort(key=lambda e: e["seq"])
        return merged, appended, dropped

    def clear(self) -> None:
        """Drop every ring (test isolation; a live process never
        clears — the ring IS the black box)."""
        with self._lock:
            for ring in self._rings:
                ring.events.clear()
                ring.appended = 0


#: The process-global recorder every subsystem appends to.  Always on.
RECORDER = FlightRecorder()


def record(etype: str, **fields) -> None:
    """Module-level spelling of :meth:`FlightRecorder.record` on the
    process-global ring — the one-liner the wiring sites call."""
    RECORDER.record(etype, **fields)


def disabled():
    """``with flight.disabled(): ...`` — recorder off for the block."""
    return RECORDER.disabled()


# ---------------------------------------------------------------- bundles
def _config_echo(config) -> Optional[dict]:
    """A JSON-safe echo of the run's config (dataclass or dict)."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


class BundleWriter:
    """One crash bundle, atomically (re-)committable.

    A one-shot dump (Simulation on HealthError / unhandled exception)
    calls :meth:`commit` once; a long-lived owner (the JAX package's
    serving blackbox) holds one writer
    and re-commits at segment boundaries + every admit, so the bundle
    on disk always reflects the last consistent instant before a
    SIGKILL.  Each commit writes a NEW ``events-<n>.jsonl``, then
    atomically replaces ``bundle.json`` to point at it, then unlinks
    the stale events files — old-or-new, never torn.
    """

    def __init__(self, flight_dir: str, bundle_id: Optional[str] = None,
                 recorder: Optional[FlightRecorder] = None):
        if not flight_dir:
            raise ValueError("BundleWriter needs a flight_dir")
        self.bundle_id = bundle_id or (
            f"fb-{time.strftime('%Y%m%dT%H%M%S')}-{os.getpid()}")
        self.path = os.path.join(os.path.abspath(flight_dir),
                                 self.bundle_id)
        self._recorder = recorder or RECORDER
        self._commit_seq = 0
        #: Commits may come from two threads: serialize them.
        self._commit_lock = threading.Lock()

    def commit(self, reason: str, *, config=None, proofs=None,
               cost_stamps=None, device_memory=None,
               open_requests=None, checkpoint=None,
               extra: Optional[dict] = None) -> dict:
        """Flush the ring + forensic context; returns the manifest."""
        with self._commit_lock:
            return self._commit_locked(
                reason, config=config, proofs=proofs,
                cost_stamps=cost_stamps, device_memory=device_memory,
                open_requests=open_requests, checkpoint=checkpoint,
                extra=extra)

    def _commit_locked(self, reason, *, config, proofs, cost_stamps,
                       device_memory, open_requests, checkpoint,
                       extra) -> dict:
        os.makedirs(self.path, exist_ok=True)
        events, appended, dropped = self._recorder.dump()
        self._commit_seq += 1
        events_name = f"events-{self._commit_seq:06d}.jsonl"
        payload = "".join(json.dumps(e) + "\n" for e in events).encode()
        _atomic_write_bytes(os.path.join(self.path, events_name),
                            payload)
        manifest = {
            "schema_version": BUNDLE_SCHEMA_VERSION,
            "bundle_id": self.bundle_id,
            "reason": reason,
            "wall_time": round(time.time(), 6),
            "commit": self._commit_seq,
            "events_file": events_name,
            "n_events": len(events),
            "events_sha256": hashlib.sha256(payload).hexdigest(),
            "threads": appended,
            "dropped_events": dropped,
            "config": _config_echo(config),
            "proofs": proofs,
            "cost_stamps": cost_stamps,
            "device_memory": device_memory,
            "open_requests": open_requests,
            "checkpoint": checkpoint,
        }
        if extra:
            manifest.update(extra)
        _atomic_write_bytes(
            os.path.join(self.path, BUNDLE_MANIFEST),
            (json.dumps(manifest, indent=1) + "\n").encode())
        # Only after the commit point: stale events files are garbage.
        for name in os.listdir(self.path):
            if (name.startswith("events-") and name != events_name
                    and not name.endswith(f"__tmp__{os.getpid()}")):
                try:
                    os.unlink(os.path.join(self.path, name))
                except OSError:
                    pass
        return manifest


def read_bundle(bundle_dir: str) -> Tuple[dict, List[dict]]:
    """Load + verify one bundle; ``(manifest, events)``.

    Raises :class:`TornBundleError` on any inconsistency — this is the
    reader every forensic entry point (``scripts/postmortem.py``
    reimplements the same checks stdlib-only, the ``torn_bundle``
    fixture seeds a break against it) must agree with.
    """
    mpath = os.path.join(bundle_dir, BUNDLE_MANIFEST)
    if not os.path.exists(mpath):
        raise TornBundleError(
            f"{bundle_dir}: no {BUNDLE_MANIFEST} — the bundle was never "
            "committed (killed before the os.replace commit point?)")
    try:
        with open(mpath, "rb") as fh:
            manifest = json.loads(fh.read().decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise TornBundleError(
            f"{mpath}: manifest is not JSON ({e})") from e
    for key in ("bundle_id", "events_file", "n_events",
                "events_sha256"):
        if key not in manifest:
            raise TornBundleError(
                f"{mpath}: manifest is missing {key!r}")
    epath = os.path.join(bundle_dir, manifest["events_file"])
    if not os.path.exists(epath):
        raise TornBundleError(
            f"{bundle_dir}: manifest names {manifest['events_file']} "
            "but the file is gone")
    with open(epath, "rb") as fh:
        payload = fh.read()
    digest = hashlib.sha256(payload).hexdigest()
    if digest != manifest["events_sha256"]:
        raise TornBundleError(
            f"{epath}: sha256 {digest[:12]}… does not match the "
            f"manifest's {manifest['events_sha256'][:12]}… — the "
            "events file is torn or tampered")
    lines = [ln for ln in payload.decode("utf-8").split("\n") if ln]
    if len(lines) != manifest["n_events"]:
        raise TornBundleError(
            f"{epath}: {len(lines)} events on disk, manifest promises "
            f"{manifest['n_events']}")
    events = []
    for i, ln in enumerate(lines):
        try:
            events.append(json.loads(ln))
        except ValueError as e:
            raise TornBundleError(
                f"{epath}:{i + 1}: event is not JSON ({e})") from e
    return manifest, events


def latest_bundle(flight_dir: str) -> Optional[str]:
    """Path of the most recently COMMITTED bundle under ``flight_dir``,
    or None.  Uncommitted/torn directories are skipped (they are the
    debris of a kill mid-commit, not lineage); ordering is by the
    manifest's own wall_time stamp, commit count as the tiebreak."""
    if not flight_dir or not os.path.isdir(flight_dir):
        return None
    best, best_key = None, None
    for name in sorted(os.listdir(flight_dir)):
        bdir = os.path.join(flight_dir, name)
        mpath = os.path.join(bdir, BUNDLE_MANIFEST)
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath) as fh:
                m = json.load(fh)
        except (OSError, ValueError):
            continue
        key = (m.get("wall_time", 0.0), m.get("commit", 0))
        if best_key is None or key > best_key:
            best, best_key = bdir, key
    return best


def resolve_flight_dir(config) -> str:
    """Where this config's crash bundles land: the explicit
    ``observability.flight_dir``, or '' (no bundle dumping — the ring
    still records; the CLIs derive a default next to their sinks)."""
    try:
        return config.observability.flight_dir
    except AttributeError:
        return ""



def open_request_manifest(queued, in_flight) -> Dict[str, Any]:
    """The bundle's open-request section: queued + in-flight request
    ids, each with its deterministic trace id (``trace_id_for`` works
    whether or not tracing was on — the id is a pure digest)."""
    from . import trace as obs_trace

    def rows(ids):
        return [{"id": rid, "trace_id": obs_trace.trace_id_for(rid)}
                for rid in ids]

    return {"queued": rows(queued), "in_flight": rows(in_flight)}
