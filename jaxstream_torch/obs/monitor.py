"""Health guards over the fetched metric stream.

Counterpart of :mod:`jaxstream.obs.monitor` (numpy on the host; the
port keeps its own copy).  :class:`HealthMonitor` scans each segment's
fetched ``(k_metrics, samples)`` buffer, on values the loop already
produced, and applies a policy when a sample is non-finite or the local
CFL number breaches its limit:

  * ``warn``: log and keep integrating;
  * ``halt``: raise :class:`HealthError` carrying the last-good
    step/time;
  * ``checkpoint_and_raise``: first call ``on_breach`` (``Simulation``
    saves a postmortem checkpoint of the current, possibly corrupt,
    state), then raise.

Fault injection: ``observability.fault_step`` makes the in-loop sampler
write NaN into the metric stream (never the state) at one global step.
Under the async pipeline a guard fires one segment later in wall-clock
terms; the breach bookkeeping is unchanged, and the run loop flushes
the background writer on any exception.
"""

from __future__ import annotations

import inspect
import re
from typing import Callable, Optional, Sequence

import numpy as np

from . import flight
from ..utils.logging import get_logger

__all__ = ["GUARD_POLICIES", "HealthError", "HealthMonitor"]

log = get_logger(__name__)

GUARD_POLICIES = ("off", "warn", "checkpoint_and_raise", "halt")

#: Buffer rows that attribute a breach to ONE ensemble member (the
#: per-member nonfinite counts of obs.metrics.member_nonfinite_specs):
#: a breach found in such a row carries ``member`` in its guard event,
#: which is what lets a serving batch evict only the failing member.
_MEMBER_ROW_RE = re.compile(r"^nonfinite_m(\d+)$")


def _call_on_breach(cb: Callable, event: dict) -> None:
    """Invoke an ``on_breach`` callback, passing the guard event when
    the callback accepts an argument (so the postmortem can record the
    offending member id); zero-arg callbacks keep working."""
    try:
        takes_arg = any(
            p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                       inspect.Parameter.POSITIONAL_OR_KEYWORD,
                       inspect.Parameter.VAR_POSITIONAL)
            for p in inspect.signature(cb).parameters.values())
    except (TypeError, ValueError):    # builtins without signatures
        takes_arg = False
    cb(event) if takes_arg else cb()


class HealthError(RuntimeError):
    """A guard tripped.  Carries the breach and the last-good sample."""

    def __init__(self, kind: str, step: int, value: float,
                 last_good_step: Optional[int],
                 last_good_t: Optional[float],
                 member: Optional[int] = None):
        self.kind = kind
        self.step = int(step)
        self.value = float(value)
        self.last_good_step = last_good_step
        self.last_good_t = last_good_t
        self.member = member
        where = (f"last good step {last_good_step} (t={last_good_t:.0f} s)"
                 if last_good_step is not None
                 else "no good sample observed")
        who = f" (member {member})" if member is not None else ""
        super().__init__(
            f"health guard tripped: {kind}{who} at step {step} "
            f"(value {value:g}); {where}")


class HealthMonitor:
    """Check each segment's fetched ``(k_metrics, samples)`` buffer.

    ``names`` fixes the buffer's row order.  A sample is *bad* when any
    of its metric values is non-finite, when the ``nonfinite_count``
    row is positive, or when the ``cfl`` row exceeds ``cfl_limit``.
    Samples are scanned in step order; good samples advance the
    last-good cursor, the first bad sample triggers the policy.
    """

    def __init__(self, names: Sequence[str], policy: str = "warn",
                 cfl_limit: float = 2.0,
                 on_breach: Optional[Callable] = None):
        if policy not in GUARD_POLICIES:
            raise ValueError(
                f"guard policy must be one of {GUARD_POLICIES}, "
                f"got {policy!r}")
        self.names = tuple(names)
        self.policy = policy
        self.cfl_limit = float(cfl_limit)
        self.on_breach = on_breach
        self.last_good_step: Optional[int] = None
        self.last_good_t: Optional[float] = None
        self.events: list = []
        self._i_nonfinite = (self.names.index("nonfinite_count")
                             if "nonfinite_count" in self.names else None)
        self._i_cfl = (self.names.index("cfl")
                       if "cfl" in self.names else None)
        #: buffer row -> member index, for the per-member count rows
        self._member_rows = {
            i: int(m.group(1)) for i, n in enumerate(self.names)
            for m in [_MEMBER_ROW_RE.match(n)] if m}

    def _classify(self, col) -> Optional[tuple]:
        """(kind, value, member) of the first breach in one sample, or
        None.  ``member`` names the offending ensemble member when the
        breach is attributable to one (a non-finite value or positive
        count in a ``nonfinite_m{i}`` row); None otherwise."""
        if not np.all(np.isfinite(col)):
            i = int(np.flatnonzero(~np.isfinite(col))[0])
            return "nan", float(col[i]), self._member_rows.get(i)
        for i, m in self._member_rows.items():
            if col[i] > 0:
                return "nan", float(col[i]), m
        if self._i_nonfinite is not None and col[self._i_nonfinite] > 0:
            return "nan", float(col[self._i_nonfinite]), None
        if self._i_cfl is not None and col[self._i_cfl] > self.cfl_limit:
            return "cfl", float(col[self._i_cfl]), None
        return None

    def check(self, steps, ts, buf) -> list:
        """Scan one segment: ``steps``/``ts`` per sample, ``buf``
        ``(k_metrics, samples)``.  Returns the guard-event dicts it
        appended (for the sink); raises per policy on a breach."""
        new_events = []
        buf = np.asarray(buf)
        for j in range(buf.shape[1]):
            breach = self._classify(buf[:, j])
            if breach is None:
                self.last_good_step = int(steps[j])
                self.last_good_t = float(ts[j])
                continue
            kind, value, member = breach
            event = {
                "kind": "guard", "event": kind, "step": int(steps[j]),
                "t": float(ts[j]), "value": value, "policy": self.policy,
                "last_good_step": self.last_good_step,
                "last_good_t": self.last_good_t,
            }
            if member is not None:
                event["member"] = member
            new_events.append(event)
            self.events.append(event)
            flight.record("guard", event=kind, step=int(steps[j]),
                          value=value, member=member)
            if self.policy == "warn":
                log.warning(
                    "health guard: %s%s at step %d (value %g; last good "
                    "step %s) — policy 'warn', continuing",
                    kind,
                    f" (member {member})" if member is not None else "",
                    steps[j], value, self.last_good_step)
                continue
            if self.policy == "checkpoint_and_raise" and self.on_breach:
                try:
                    _call_on_breach(self.on_breach, event)
                except Exception as e:  # the raise below must still fire
                    log.warning("guard breach callback failed (%s: %s)",
                                type(e).__name__, e)
            raise HealthError(kind, int(steps[j]), value,
                              self.last_good_step, self.last_good_t,
                              member=member)
        return new_events

    def check_members(self, steps, ts, counts, chips=None) -> list:
        """Per-member breach scan for a member-batched sample.

        ``counts`` is a ``(B,)`` per-member nonfinite-count vector for
        ONE sample; ``steps``/``ts`` give each member's own step count
        and model time (members in a packed batch run independent
        clocks).  Appends one guard event PER failing member — unlike
        :meth:`check`, which reports only a sample's first breach,
        because the continuous-batching server must evict every failing
        member at the boundary, not just the first.  Policy semantics:
        ``warn`` records and returns (the caller owns eviction — the
        server's ``serve.guards: evict`` mode), ``halt``/
        ``checkpoint_and_raise`` raise on the first failing member as
        :meth:`check` would.  Returns the new events.

        ``chips`` (multi-chip serving): a per-member device
        attribution — ``chips[m]`` is the member-shard index whose
        device(s) hold member ``m`` under the serving placement — and
        when given each guard event carries it as ``"chip"``, so a
        fleet operator can see WHICH chip's members keep blowing up
        (telemetry_report renders the column).
        """
        counts = np.asarray(counts)
        new_events = []
        for m in range(counts.shape[0]):
            c = counts[m]
            if np.isfinite(c) and c <= 0:
                continue
            event = {
                "kind": "guard", "event": "nan", "step": int(steps[m]),
                "t": float(ts[m]), "value": float(c),
                "policy": self.policy, "member": m,
                "last_good_step": self.last_good_step,
                "last_good_t": self.last_good_t,
            }
            if chips is not None:
                event["chip"] = int(chips[m])
            new_events.append(event)
            self.events.append(event)
            flight.record("guard", event="nan", step=int(steps[m]),
                          value=float(c), member=m)
            log.warning(
                "health guard: nonfinite state in member %d at its step "
                "%d (count %g)", m, int(steps[m]), float(c))
            if self.policy in ("halt", "checkpoint_and_raise"):
                if self.policy == "checkpoint_and_raise" and self.on_breach:
                    try:
                        _call_on_breach(self.on_breach, event)
                    except Exception as e:
                        log.warning("guard breach callback failed "
                                    "(%s: %s)", type(e).__name__, e)
                raise HealthError("nan", int(steps[m]), float(c),
                                  self.last_good_step, self.last_good_t,
                                  member=m)
        return new_events
