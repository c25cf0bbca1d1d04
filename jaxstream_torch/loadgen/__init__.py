"""Closed-loop load harness and autoscaling (counterpart of
:mod:`jaxstream.loadgen`).

:mod:`.trace` generates deterministic heavy-tailed arrival traces,
:mod:`.harness` replays them against a gateway over loopback HTTP and
measures latency percentiles, goodput and the typed-shed accounting, and
:mod:`.autoscale` holds the pure (queue depth, occupancy) -> bucket-cap
policy and the controller the serving loop ticks at segment boundaries.
"""

from .autoscale import (AutoscaleController, AutoscalePolicy,
                        AutoscaleState, decide)
from .harness import masked_records, run_load, summarize_outcomes
from .trace import generate_trace, read_trace, write_trace

__all__ = [
    "AutoscaleController", "AutoscalePolicy", "AutoscaleState",
    "decide", "generate_trace", "masked_records", "read_trace",
    "run_load", "summarize_outcomes", "write_trace",
]
