"""Continuous-batching ensemble server (counterpart of
:mod:`jaxstream.serve`).

Independent scenario requests (IC family, perturbation seed, run length,
output subset) packed into the member axis of one batched stepper, with
per-member run-length masking so that a finished member's slot is
refilled from the request queue at the next segment boundary.  Grouped
buckets under ``model.backend: pallas`` step on the CUDA stage kernels
(B1, and B1's member fold for more than one member); mixed-orography
batches run the classic SSPRK3 over each member with its own orography
(the CUDA RHS kernel B4 under ``pallas``).  :mod:`.placement` holds the
pure multi-chip planner; the server itself runs ``placement.mode: off``.
:mod:`.warmpool` persists a bucket's kernel libraries and host-built
tables (``serve.warm_pool``, ``compile_cache``, ``speculate``).
"""

from .placement import BucketPlan, plan_placement, placement_report
from .queue import (AdmissionRefused, HeadroomRefused, QueueFull,
                    RequestQueue, ServerDraining)
from .request import RequestResult, ScenarioRequest
from .server import EnsembleServer, serve_requests

__all__ = [
    "AdmissionRefused",
    "BucketPlan",
    "EnsembleServer",
    "HeadroomRefused",
    "QueueFull",
    "RequestQueue",
    "RequestResult",
    "ScenarioRequest",
    "ServerDraining",
    "placement_report",
    "plan_placement",
    "serve_requests",
]
