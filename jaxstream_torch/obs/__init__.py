"""Run telemetry: on-device metric streams, health guards, sinks and the
flight recorder (counterpart of :mod:`jaxstream.obs`).

:mod:`.metrics` computes the Williamson invariant ladder inside the
segment loop into a small device buffer fetched once per segment;
:mod:`.monitor` watches the fetched stream for non-finite values and CFL
breaches under a policy; :mod:`.sink` writes the run manifest and the
per-segment records as the JAX package's JSONL; :mod:`.flight` keeps the
always-on event ring and writes crash bundles.  Wired through
``Simulation`` by the ``observability:`` block (off by default; turning
it on leaves the state carry bitwise unchanged).  The serving stack's
halves: :mod:`.trace` (request-scoped span trees), :mod:`.registry` (the
scrapeable metrics registry) and :mod:`.perf` (bucket cost stamps and the
device-memory watcher).
"""

from .flight import (RECORDER, BundleWriter, FlightRecorder,
                     TornBundleError, latest_bundle, read_bundle)
from .metrics import (METRICS, MetricSet, MetricSpec, build_metric_set,
                      default_metrics, fetch_buffer)
from .monitor import GUARD_POLICIES, HealthError, HealthMonitor
from .perf import CostStamp, MemoryWatcher, build_cost, measure_cost
from .registry import MetricsRegistry, parse_exposition
from .sink import (RECORD_KINDS, TelemetrySink, read_records,
                   validate_record)
from .trace import (RequestTrace, span_coverage, span_tree,
                    trace_id_for, tree_complete)

__all__ = [
    "METRICS", "MetricSet", "MetricSpec", "build_metric_set",
    "default_metrics", "fetch_buffer",
    "RECORDER", "BundleWriter", "FlightRecorder", "TornBundleError",
    "latest_bundle", "read_bundle",
    "GUARD_POLICIES", "HealthError", "HealthMonitor",
    "CostStamp", "MemoryWatcher", "build_cost", "measure_cost",
    "MetricsRegistry", "parse_exposition",
    "RECORD_KINDS", "TelemetrySink", "read_records", "validate_record",
    "RequestTrace", "span_coverage", "span_tree", "trace_id_for",
    "tree_complete",
]
