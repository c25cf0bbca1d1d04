"""Scenario requests and their results — the server's wire schema.

Counterpart of :mod:`jaxstream.serve.request`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

A request names WHAT to simulate (IC family, perturbation seed and
amplitude, run length) and WHICH outputs to return; everything else
(grid, dt, physics) is fixed per server deployment, which is what makes
requests packable into one batched stepper.  The families are the
Galewsky/Williamson scenario set (Galewsky et al. 2004; Williamson et
al. 1992) the repo's IC module provides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["SWE_FAMILIES", "ScenarioRequest", "RequestResult"]

#: IC families a server can pack, keyed to their batching group: tc5
#: carries orography, the rest are flat.  Since round 12 the groups
#: only matter under ``serve.group_by_orography: true`` (the parity
#: mode that bakes orography into the stepper as a compile-time
#: static); the default server threads the mountain as a traced
#: per-member field (zeros for the flat families) so EVERY family
#: packs into one batch in strict queue FIFO order.
SWE_FAMILIES: Dict[str, str] = {
    "tc2": "flat",
    "tc5": "oro",
    "tc6": "flat",
    "galewsky": "flat",
    # Round 18: raw-array initial conditions — the request carries the
    # full interior prognostic state itself (``state``: h (6, n, n), u
    # (2, 6, n, n)), byte-preserved through the gateway's b64 array
    # codec.  The restart/assimilation primitive: a checkpointed
    # member or an EnKF analysis state re-enters the serving loop as
    # an ordinary request.  Flat-bottom (no orography is implied by an
    # array; tc5 continuations ride the traced per-member mountain of
    # the mixed-batch default only if resubmitted as 'tc5').
    "array": "flat",
}

#: Fields a request may ask back (interior prognostics).
OUTPUT_FIELDS = ("h", "u")


@dataclasses.dataclass
class ScenarioRequest:
    """One user scenario: IC family + perturbation + run length.

    ``seed``/``amplitude`` perturb the family's base height field with
    the deterministic ``perturbed_ensemble`` recipe (``amplitude = 0``
    or ``seed < 0`` = the unperturbed base IC).  ``nsteps`` is the run
    length in stepper calls — requests of ANY length pack together
    (per-member masking handles the remainders).  ``outputs`` is the
    subset of interior prognostic fields returned/written.
    """
    id: str
    ic: str = "tc5"
    nsteps: int = 1
    seed: int = -1
    amplitude: float = 1.0e-3
    outputs: Tuple[str, ...] = ("h",)
    #: Raw-array initial conditions (``ic: "array"``, round 18): the
    #: interior prognostic state ``{"h": (6, n, n), "u": (2, 6, n,
    #: n)}`` as host numpy arrays.  Shape/dtype are validated against
    #: the deployment's grid at admission (:meth:`EnsembleServer.
    #: validate_request`) — a mismatched array must land as a typed
    #: 400, never mid-batch on the serving thread.
    state: Optional[Dict] = None
    #: wall-clock bookkeeping, stamped by the server
    submitted_wall: Optional[float] = None

    def __post_init__(self):
        # Numeric fields are validated HERE, not where they are first
        # used: a wrong-typed seed/amplitude that passed admission
        # would otherwise raise mid-batch on the serving thread and
        # kill the whole deployment for one bad request (round 14 —
        # the gateway maps this ValueError to a typed 400).
        for fname in ("nsteps", "seed"):
            v = getattr(self, fname)
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(
                    f"request {self.id!r}: {fname} must be an int, "
                    f"got {type(v).__name__}")
        if (isinstance(self.amplitude, bool)
                or not isinstance(self.amplitude, (int, float))):
            raise ValueError(
                f"request {self.id!r}: amplitude must be a number, "
                f"got {type(self.amplitude).__name__}")
        self.amplitude = float(self.amplitude)
        if self.ic not in SWE_FAMILIES:
            raise ValueError(
                f"request {self.id!r}: unknown ic {self.ic!r}; valid: "
                f"{sorted(SWE_FAMILIES)}")
        if self.nsteps < 1:
            raise ValueError(
                f"request {self.id!r}: nsteps must be >= 1, got "
                f"{self.nsteps}")
        self.outputs = tuple(self.outputs)
        bad = [f for f in self.outputs if f not in OUTPUT_FIELDS]
        if bad:
            raise ValueError(
                f"request {self.id!r}: unknown output fields {bad}; "
                f"valid: {list(OUTPUT_FIELDS)}")
        if self.ic == "array":
            import numpy as np

            if not isinstance(self.state, dict):
                raise ValueError(
                    f"request {self.id!r}: ic 'array' needs a 'state' "
                    "mapping with the interior prognostic arrays "
                    "{'h': (6, n, n), 'u': (2, 6, n, n)}")
            if set(self.state) != set(OUTPUT_FIELDS):
                raise ValueError(
                    f"request {self.id!r}: ic 'array' state must "
                    f"carry exactly {sorted(OUTPUT_FIELDS)}; got "
                    f"{sorted(self.state)}")
            for k, v in self.state.items():
                if not isinstance(v, np.ndarray):
                    raise ValueError(
                        f"request {self.id!r}: state[{k!r}] must be a "
                        f"numpy array, got {type(v).__name__}")
            if self.seed >= 0 and self.amplitude != 0.0:
                raise ValueError(
                    f"request {self.id!r}: seed/amplitude "
                    "perturbations apply to the named IC families; "
                    "perturb the array client-side (or set seed: -1)")
        elif self.state is not None:
            raise ValueError(
                f"request {self.id!r}: 'state' is only valid with "
                "ic 'array'")

    @property
    def group(self) -> str:
        return SWE_FAMILIES[self.ic]

    @property
    def has_orography(self) -> bool:
        """True when the family carries a bottom mountain (tc5) — the
        request's traced per-member orography field is then the TC5
        topography instead of zeros."""
        return SWE_FAMILIES[self.ic] == "oro"

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioRequest":
        """Build from a JSONL trace line (unknown keys rejected)."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"request mapping has unknown keys {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(**d)


@dataclasses.dataclass
class RequestResult:
    """Outcome of one served request.

    ``status``: ``'ok'`` or ``'evicted'`` (the member went non-finite
    and was evicted by the health guard; ``guard_event`` then carries
    the monitor's event, including the member index).  ``fields`` holds
    the requested interior output arrays (host numpy) for completed
    requests — byte-identical, for a request served alone through the
    B=1 bucket, to an unbatched ``Simulation`` run of the same
    scenario.  ``latency_s`` is submit-to-completion wall time;
    ``steps_run`` how many steps actually executed (< ``nsteps`` only
    for evictions).
    """
    id: str
    ic: str
    nsteps: int
    status: str
    t_final: float
    steps_run: int
    latency_s: float
    fields: Dict[str, "object"] = dataclasses.field(default_factory=dict)
    guard_event: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"
