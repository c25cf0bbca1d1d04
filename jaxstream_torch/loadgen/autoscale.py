"""Queue-depth / occupancy-driven autoscaling (round 14).

Counterpart of :mod:`jaxstream.loadgen.autoscale`, whose code this
module keeps as it is (pure Python in both packages; the port keeps its
own copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

The policy is a PURE function — ``decide(policy, state, queue_depth,
occupancy) -> (state', target_bucket | None)`` — over the two signals
the serving telemetry already records: request-queue depth (how
much traffic is waiting) and slot occupancy (how full the member axis
ran).  Purity is the testability contract: the hysteresis proofs in
tests/test_loadgen.py drive the function with synthetic observation
streams and assert it cannot flap, no servers involved.

Scaling acts on the ACTIVE BUCKET CAP (:meth:`EnsembleServer.resize`):
levels are an ascending subset of the server's configured bucket set,
all pre-compiled at warmup, so a resize swaps which warm executable
packs the next batch — zero recompiles by construction.  Under
``serve.placement`` the bucket cap IS the placement lever: each
bucket's :class:`BucketPlan` spans a fixed device count (a B=16 bucket
member-shards over 8 chips, B=4 over 4, B=1 runs single), so scaling
the cap up engages more chips and scaling down releases them.

Anti-flap hysteresis, three mechanisms stacked:

* **disjoint watermarks** — scale-up needs ``queue_depth >=
  queue_high``, scale-down needs ``queue_depth <= queue_low`` AND
  ``occupancy <= occ_low``, with ``queue_high > queue_low`` enforced
  at construction, so no single observation can satisfy both;
* **patience** — a direction must persist for ``patience``
  consecutive observations (a contradicting observation resets both
  streaks);
* **cooldown** — after any resize the policy ignores ``cooldown``
  observations, so consecutive resizes are at least ``cooldown +
  patience`` observations apart.

:class:`AutoscaleController` is the thin impure shell: it reads the
server's queue depth + last-segment occupancy, feeds the pure policy,
and applies resizes — the ``tick(server)`` callable
:meth:`EnsembleServer.serve_forever` evaluates at every segment
boundary (live autoscaling with no extra thread, deterministic given
the queue state; a resize ends the running batch's refill so packing
resumes at the new cap with the next batch).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["AutoscalePolicy", "AutoscaleState", "decide",
           "AutoscaleController"]


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The pure scaling rule.  ``levels`` is the ascending ladder of
    active-bucket caps the policy may select (each must be a configured
    — therefore warm — server bucket)."""
    levels: Tuple[int, ...]
    queue_high: int = 4          # scale up at queue_depth >= queue_high
    queue_low: int = 0           # scale down at queue_depth <= queue_low
    occ_low: float = 0.5         # ... AND occupancy <= occ_low
    patience: int = 2            # consecutive observations required
    cooldown: int = 2            # observations ignored after a resize

    def __post_init__(self):
        levels = tuple(int(b) for b in self.levels)
        object.__setattr__(self, "levels", levels)
        if not levels or list(levels) != sorted(set(levels)):
            raise ValueError(
                f"levels must be a strictly ascending non-empty ladder, "
                f"got {self.levels}")
        if self.queue_high <= self.queue_low:
            raise ValueError(
                f"queue_high ({self.queue_high}) must exceed queue_low "
                f"({self.queue_low}) — disjoint watermarks are the "
                "anti-flap guarantee")
        if self.patience < 1 or self.cooldown < 0:
            raise ValueError(
                f"patience >= 1 and cooldown >= 0 required, got "
                f"patience={self.patience} cooldown={self.cooldown}")


@dataclasses.dataclass(frozen=True)
class AutoscaleState:
    """Immutable policy state threaded through :func:`decide`."""
    level: int = 0               # index into policy.levels
    up_streak: int = 0
    down_streak: int = 0
    cooldown_left: int = 0


def decide(policy: AutoscalePolicy, state: AutoscaleState,
           queue_depth: int, occupancy: float,
           ) -> Tuple[AutoscaleState, Optional[int]]:
    """One observation in, (new state, resize target | None) out.

    The target, when not None, is the bucket cap ``policy.levels[
    new_level]`` — the caller applies it (``server.resize``).  Pure:
    no clocks, no servers, no mutation.
    """
    if state.cooldown_left > 0:
        return dataclasses.replace(
            state, cooldown_left=state.cooldown_left - 1,
            up_streak=0, down_streak=0), None
    want_up = (queue_depth >= policy.queue_high
               and state.level < len(policy.levels) - 1)
    want_down = (queue_depth <= policy.queue_low
                 and occupancy <= policy.occ_low
                 and state.level > 0)
    if want_up:
        up = state.up_streak + 1
        if up >= policy.patience:
            new = dataclasses.replace(
                state, level=state.level + 1, up_streak=0,
                down_streak=0, cooldown_left=policy.cooldown)
            return new, policy.levels[new.level]
        return dataclasses.replace(state, up_streak=up,
                                   down_streak=0), None
    if want_down:
        down = state.down_streak + 1
        if down >= policy.patience:
            new = dataclasses.replace(
                state, level=state.level - 1, up_streak=0,
                down_streak=0, cooldown_left=policy.cooldown)
            return new, policy.levels[new.level]
        return dataclasses.replace(state, down_streak=down,
                                   up_streak=0), None
    return dataclasses.replace(state, up_streak=0, down_streak=0), None


class AutoscaleController:
    """The impure shell around :func:`decide` — the serving loop's
    per-segment-boundary ``tick(server)``.

    ``attach(server)`` validates the level ladder against the server's
    configured buckets and applies the initial level; each tick reads
    (queue depth, last-segment occupancy), runs the pure policy, and
    applies any resize through :meth:`EnsembleServer.resize` (which
    records the ``autoscale`` sink event).  ``events`` keeps the
    applied resizes for reports; ``summary()`` is the /v1/stats
    payload.
    """

    def __init__(self, policy: AutoscalePolicy,
                 state: Optional[AutoscaleState] = None):
        self.policy = policy
        self.state = state or AutoscaleState()
        self.events: List[dict] = []
        self.observations = 0

    def attach(self, server) -> None:
        bad = [b for b in self.policy.levels if b not in server.buckets]
        if bad:
            raise ValueError(
                f"autoscale levels {bad} are not configured server "
                f"buckets {list(server.buckets)} — every level must "
                "map to a warm executable (resizes must never compile)")
        server.resize(self.policy.levels[self.state.level],
                      reason="autoscale_attach")

    def __call__(self, server) -> Optional[int]:
        from ..serve.queue import HeadroomRefused

        queue_depth = len(server.queue)
        occupancy = float(server.stats.get("last_occupancy", 0.0))
        self.observations += 1
        prev = self.state
        self.state, target = decide(self.policy, self.state,
                                    queue_depth, occupancy)
        if target is None:
            return None
        try:
            old = server.resize(target, reason="autoscale",
                                queue_depth=queue_depth,
                                occupancy=occupancy)
        except HeadroomRefused:
            # Round 21: the server refused the scale-up on stamped
            # memory headroom (it already wrote the typed record).
            # Revert the LEVEL so the ladder stays truthful, but keep
            # the fresh cooldown — without it the policy would hammer
            # the refused level every observation.
            self.state = dataclasses.replace(self.state,
                                             level=prev.level)
            self.events.append({
                "observation": self.observations,
                "from_bucket": self.policy.levels[prev.level],
                "to_bucket": target, "queue_depth": queue_depth,
                "occupancy": round(occupancy, 4), "refused": True,
            })
            return None
        self.events.append({
            "observation": self.observations, "from_bucket": old,
            "to_bucket": target, "queue_depth": queue_depth,
            "occupancy": round(occupancy, 4),
        })
        return target

    def summary(self) -> dict:
        return {
            "levels": list(self.policy.levels),
            "level": self.state.level,
            "active_bucket": self.policy.levels[self.state.level],
            "observations": self.observations,
            "resizes": len(self.events),
            "events": list(self.events),
        }
