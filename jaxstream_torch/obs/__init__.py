"""Run telemetry: on-device metric streams, health guards, sinks and the
flight recorder (counterpart of :mod:`jaxstream.obs`).

:mod:`.metrics` computes the Williamson invariant ladder inside the
segment loop into a small device buffer fetched once per segment;
:mod:`.monitor` watches the fetched stream for non-finite values and CFL
breaches under a policy; :mod:`.sink` writes the run manifest and the
per-segment records as the JAX package's JSONL; :mod:`.flight` keeps the
always-on event ring and writes crash bundles.  Wired through
``Simulation`` by the ``observability:`` block (off by default; turning
it on leaves the state carry bitwise unchanged).  The request tracing,
metrics registry and performance observatory come with the serving
stack.
"""

from .flight import (RECORDER, BundleWriter, FlightRecorder,
                     TornBundleError, latest_bundle, read_bundle)
from .metrics import (METRICS, MetricSet, MetricSpec, build_metric_set,
                      default_metrics, fetch_buffer)
from .monitor import GUARD_POLICIES, HealthError, HealthMonitor
from .sink import (RECORD_KINDS, TelemetrySink, read_records,
                   validate_record)

__all__ = [
    "METRICS", "MetricSet", "MetricSpec", "build_metric_set",
    "default_metrics", "fetch_buffer",
    "RECORDER", "BundleWriter", "FlightRecorder", "TornBundleError",
    "latest_bundle", "read_bundle",
    "GUARD_POLICIES", "HealthError", "HealthMonitor",
    "RECORD_KINDS", "TelemetrySink", "read_records", "validate_record",
]
