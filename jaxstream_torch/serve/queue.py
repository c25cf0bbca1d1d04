"""Bounded scenario-request queue with admission control.

Counterpart of :mod:`jaxstream.serve.queue`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

The queue is the server's backpressure surface: capacity is a hard
bound (``submit`` raises :class:`QueueFull` — or blocks, for callers
that want producer-side flow control) so a traffic burst shows up as
rejected admissions, never as unbounded host memory.

Since round 12 the default server packs EVERY family into one batch
(orography rides as a traced per-member field), so the common pop is
strict queue-wide FIFO.  Group-aware pops (``pop(group=...)`` /
:meth:`RequestQueue.pop_group`) remain for the
``serve.group_by_orography: true`` parity mode: FIFO *within* a
batching group, letting the server refill a batch with packable
requests only while requests of the other group keep their queue
position.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from ..obs import flight
from .request import ScenarioRequest
# The warm pool defines it (as the JAX package's); re-exported here, where
# the serving layer's other refusals live.
from .warmpool import HeadroomRefused

__all__ = ["AdmissionRefused", "HeadroomRefused", "QueueFull",
           "RequestQueue", "ServerDraining"]


class QueueFull(RuntimeError):
    """submit() on a queue at capacity (non-blocking admission)."""


class AdmissionRefused(RuntimeError):
    """The server refused the request (health-driven admission
    control: too many guard events — see ``serve.max_guard_events``)."""


class ServerDraining(AdmissionRefused):
    """submit() on a server that began its graceful drain (round 14):
    admissions are closed while in-flight members run to their final
    step.  Subclasses :class:`AdmissionRefused` so existing callers
    treating any refusal uniformly keep working; the gateway maps it
    to a typed 503 ``draining``."""


class RequestQueue:
    """FIFO of :class:`ScenarioRequest` with a hard capacity bound.

    Thread-safe: the CLI/benchmark submit from the main thread while a
    server drains, and tests hammer it from worker threads.  ``pop`` /
    ``pop_group`` are non-blocking (the serving loop polls at segment
    boundaries — its natural cadence — rather than parking a thread).
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def depth(self) -> int:
        return len(self)

    def submit(self, req: ScenarioRequest, block: bool = False,
               timeout: Optional[float] = None) -> None:
        """Enqueue; at capacity raise :class:`QueueFull` (default) or
        block until a slot frees (``block=True``)."""
        with self._not_full:
            if len(self._q) >= self.capacity:
                if not block:
                    raise QueueFull(
                        f"request queue at capacity {self.capacity}; "
                        "retry later (admission control)")
                if not self._not_full.wait_for(
                        lambda: len(self._q) < self.capacity,
                        timeout=timeout):
                    raise QueueFull(
                        f"request queue still at capacity "
                        f"{self.capacity} after {timeout}s")
            self._q.append(req)
            depth = len(self._q)
        flight.record("queue.admit", id=req.id, depth=depth)

    def pop(self, group: Optional[str] = None) -> Optional[ScenarioRequest]:
        """Oldest request, or None when empty.

        ``group`` restricts the pop to one batching group (the
        ``group_by_orography: true`` parity mode): requests of other
        groups keep their positions — group-local FIFO, which is what
        makes the refill order deterministic for a given submission
        order.  ``None`` (the mixed-orography default) is strict
        queue-wide FIFO.
        """
        with self._not_full:
            for i, req in enumerate(self._q):
                if group is None or req.group == group:
                    del self._q[i]
                    self._not_full.notify()
                    popped = req
                    break
            else:
                return None
        flight.record("queue.pop", id=popped.id)
        return popped

    def pop_group(self, group: str) -> Optional[ScenarioRequest]:
        """``pop(group=group)`` — kept as the round-11 spelling."""
        return self.pop(group)

    def remove(self, req: ScenarioRequest) -> bool:
        """Remove one request by identity; False when it is no longer
        queued (already popped for serving).  The submit/drain race
        unwind (round 14): a submitter that enqueued concurrently with
        ``begin_drain`` takes its request back out — either the removal
        succeeds and the caller refuses the submission, or the serving
        loop already owns it and will run it to completion."""
        with self._not_full:
            for i, r in enumerate(self._q):
                if r is req:
                    del self._q[i]
                    self._not_full.notify()
                    return True
            return False

    def requeue(self, reqs) -> None:
        """Push popped-but-unserved requests back to the FRONT, in
        their original order — the server's unwind path when a halting
        health guard fires after requests were speculatively popped
        for refill prep.  May exceed ``capacity`` transiently (these
        requests were already admitted once; dropping them on a guard
        trip would lose accepted traffic)."""
        reqs = list(reqs)
        with self._not_full:
            for req in reversed(reqs):
                self._q.appendleft(req)
        for req in reqs:
            flight.record("queue.requeue", id=req.id)

    def snapshot(self) -> List[str]:
        """Queued request ids in FIFO order, under the lock — the
        crash bundle's 'admitted but not yet packed' half of the
        open-request manifest (round 20)."""
        with self._lock:
            return [r.id for r in self._q]
