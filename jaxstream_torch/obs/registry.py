"""A small pure metrics registry with a Prometheus text surface.

Counterpart of :mod:`jaxstream.obs.registry`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

The serving stack's scrapeable half: counters (typed request
outcomes), gauges (queue depth, active bucket cap, per-chip
occupancy/utilization) and fixed-bucket histograms (request latency,
segment wall, host wait) that :class:`jaxstream.serve.EnsembleServer`
updates at segment boundaries and the gateway renders at
``GET /v1/metrics`` in Prometheus text exposition format.

**No locks on the hot path.**  The serving loop must never block on an
operator scrape, so updates to an *existing* series are plain dict/
list mutations — safe under the GIL, and torn reads are impossible
(floats are immutable objects; a scrape sees either the old or the new
value).  Two further rules make this correct rather than merely lucky:

* **one writer thread per metric name** — the server's counters/gauges
  are only touched from the serving thread, the latency histogram only
  from the background writer thread, the shed counters only from the
  gateway's HTTP thread.  Updates never contend, so read-modify-write
  increments cannot lose counts.
* **series creation takes the lock** — inserting a NEW label child
  mutates a dict another thread may be iterating; first-touch of a
  label set (rare: once per status value / chip index) and the scrape
  snapshot share one lock so iteration can never see a resize.

**Snapshot-on-scrape**: ``render()`` copies the registry under the
lock and formats OUTSIDE it, so even a slow text encode never holds
the creation lock.  A scrape is therefore a point-in-time snapshot
that may be mid-boundary (e.g. ``segments_total`` already incremented,
``member_steps_total`` not yet) — Prometheus semantics expect exactly
that (counters are monotone; rates are computed across scrapes), which
is why the registry snapshots instead of trying to make boundary
updates transactional (docs/DESIGN.md "Operator view").

Stdlib only; no jax, no numpy.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["MetricsRegistry", "parse_exposition",
           "LATENCY_BUCKETS_S", "WALL_BUCKETS_S", "HOST_WAIT_BUCKETS_S",
           "CONTENT_TYPE"]

#: The exposition content type (text format 0.0.4 — the version every
#: Prometheus server scrapes).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Default histogram ladders (seconds).  Request latency spans queueing
#: under bursts (tens of seconds at saturation); segment wall and host
#: wait are per-boundary and sub-second on healthy deployments.
LATENCY_BUCKETS_S = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                     30.0, 60.0, 120.0)
WALL_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                  2.5, 5.0, 10.0)
HOST_WAIT_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.5, 1.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Counters / gauges / histograms -> Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        #: name -> ("counter"|"gauge"|"histogram", help, buckets|None)
        self._meta: Dict[str, tuple] = {}
        #: name -> {label_key: float}  (counters, gauges)
        self._values: Dict[str, Dict[tuple, float]] = {}
        #: name -> {label_key: {"counts": [..], "sum": f, "count": n}}
        self._hists: Dict[str, Dict[tuple, dict]] = {}

    # ----------------------------------------------------------- declare
    def _declare(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            known = self._meta.get(name)
            if known is not None:
                if known[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{known[0]}, not {kind}")
                return
            b = tuple(sorted(float(x) for x in buckets)) \
                if buckets is not None else None
            self._meta[name] = (kind, help, b)
            if kind == "histogram":
                self._hists[name] = {}
            else:
                self._values[name] = {}

    def counter(self, name: str, help: str = "") -> str:
        self._declare(name, "counter", help)
        return name

    def gauge(self, name: str, help: str = "") -> str:
        self._declare(name, "gauge", help)
        return name

    def histogram(self, name: str, buckets: Iterable[float],
                  help: str = "") -> str:
        self._declare(name, "histogram", help, buckets)
        return name

    # ----------------------------------------------------------- updates
    def _check_kind(self, name: str, kind: str):
        """Counters and gauges share the value store; an update
        through the wrong verb must fail loudly, not silently write
        (lock-free: one tuple read on the hot path)."""
        known = self._meta.get(name)
        if known is not None and known[0] != kind:
            raise ValueError(f"metric {name!r} already declared as "
                             f"{known[0]}, not {kind}")

    def counter_inc(self, name: str, value: float = 1.0, **labels):
        """Hot path: lock-free for an existing series (one writer per
        name — see module docstring)."""
        self._check_kind(name, "counter")
        fam = self._values.get(name)
        if fam is None:
            self.counter(name)
            fam = self._values[name]
        key = _label_key(labels)
        cur = fam.get(key)
        if cur is None:
            with self._lock:
                fam[key] = fam.get(key, 0.0) + float(value)
        else:
            fam[key] = cur + float(value)

    def gauge_set(self, name: str, value: float, **labels):
        self._check_kind(name, "gauge")
        fam = self._values.get(name)
        if fam is None:
            self.gauge(name)
            fam = self._values[name]
        key = _label_key(labels)
        if key in fam:
            fam[key] = float(value)
        else:
            with self._lock:
                fam[key] = float(value)

    def observe(self, name: str, value: float,
                buckets: Iterable[float] = LATENCY_BUCKETS_S, **labels):
        fam = self._hists.get(name)
        if fam is None:
            self.histogram(name, buckets)
            fam = self._hists[name]
        key = _label_key(labels)
        child = fam.get(key)
        if child is None:
            with self._lock:
                child = fam.setdefault(key, {
                    "counts": [0] * (len(self._meta[name][2]) + 1),
                    "sum": 0.0, "count": 0})
        bounds = self._meta[name][2]
        v = float(value)
        i = 0
        while i < len(bounds) and v > bounds[i]:
            i += 1
        child["counts"][i] += 1
        child["sum"] += v
        child["count"] += 1

    # ------------------------------------------------------------ scrape
    def snapshot(self) -> dict:
        """Point-in-time copy of every series (plain dicts/lists)."""
        with self._lock:
            meta = dict(self._meta)
            values = {n: dict(f) for n, f in self._values.items()}
            hists = {n: {k: {"counts": list(c["counts"]),
                             "sum": c["sum"], "count": c["count"]}
                         for k, c in f.items()}
                     for n, f in self._hists.items()}
        return {"meta": meta, "values": values, "hists": hists}

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of a snapshot."""
        snap = self.snapshot()
        lines: List[str] = []
        for name in sorted(snap["meta"]):
            kind, help, bounds = snap["meta"][name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                for key in sorted(snap["hists"][name]):
                    child = snap["hists"][name][key]
                    cum = 0
                    for i, bound in enumerate(
                            tuple(bounds) + (math.inf,)):
                        cum += child["counts"][i]
                        lbl = _render_labels(key + (("le", _fmt(bound)),))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    base = _render_labels(key)
                    lines.append(f"{name}_sum{base} "
                                 f"{_fmt(child['sum'])}")
                    lines.append(f"{name}_count{base} "
                                 f"{child['count']}")
            else:
                for key in sorted(snap["values"][name]):
                    lines.append(f"{name}{_render_labels(key)} "
                                 f"{_fmt(snap['values'][name][key])}")
        return "\n".join(lines) + "\n"


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    parts = []
    for k, v in key:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
        v = v.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


# --------------------------------------------------------------- parsing
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r" ([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """Validate + parse Prometheus text exposition.

    Raises ``ValueError`` on any malformed line; returns
    ``{"types": {name: kind}, "samples": {name: {label_str: value}}}``
    with histogram ``_bucket``/``_sum``/``_count`` series under their
    suffixed names.  Also enforces the two structural invariants a
    scraper relies on: every histogram has a ``+Inf`` bucket, and its
    cumulative bucket counts are monotone.  This is the round-trip
    check the tests and the bench ``--smoke`` canary run against the
    live ``/v1/metrics`` payload.
    """
    types: Dict[str, str] = {}
    samples: Dict[str, Dict[str, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line "
                                 f"{line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: not a valid exposition "
                             f"sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        samples.setdefault(name, {})[labels] = float(
            value.replace("Inf", "inf").replace("NaN", "nan"))
    for name, kind in types.items():
        if kind != "histogram":
            continue
        buckets = samples.get(name + "_bucket", {})
        if not buckets:
            # A DECLARED histogram with no observations yet emits only
            # its TYPE/HELP lines — valid exposition (the registry
            # declares the whole surface up front so it is present
            # from the first scrape, before first traffic).  Only a
            # half-rendered family (counts without buckets) is a bug.
            if samples.get(name + "_count") or samples.get(
                    name + "_sum"):
                raise ValueError(
                    f"histogram {name} has _count/_sum but no "
                    f"_bucket series")
            continue
        # Group bucket samples by their non-le labels; each group must
        # end at +Inf with monotone cumulative counts.
        groups: Dict[tuple, List[Tuple[float, float]]] = {}
        for lbl, v in buckets.items():
            pairs = dict(_PAIR_RE.findall(lbl))
            le = pairs.pop("le", None)
            if le is None:
                raise ValueError(f"histogram {name} bucket without le")
            groups.setdefault(tuple(sorted(pairs.items())), []).append(
                (math.inf if le == "+Inf" else float(le), v))
        for key, series in groups.items():
            series.sort()
            if series[-1][0] != math.inf:
                raise ValueError(
                    f"histogram {name}{dict(key)} missing +Inf bucket")
            counts = [v for _, v in series]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(
                    f"histogram {name}{dict(key)} cumulative bucket "
                    f"counts are not monotone: {counts}")
    return {"types": types, "samples": samples}
