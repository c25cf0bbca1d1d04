"""Async host pipeline: double-buffered fetches and a background writer.

Counterpart of :mod:`jaxstream.io.async_pipeline`.  The synchronous run
loop makes every segment boundary a stall: the metric-buffer fetch,
then the history append, the checkpoint save and the telemetry record,
before the next segment is dispatched.  ``Simulation`` with
``io.async_pipeline.enabled`` uses the two pieces here instead:

* :class:`HostFetch`, the double-buffer half.  Constructing one starts
  the device-to-host copy of every tensor of a tree: each CUDA tensor is
  copied into a pinned host buffer by a ``non_blocking`` copy on a side
  CUDA stream, ordered after an event recorded on the compute stream, so
  the copy rides behind the segment just dispatched and costs the
  dispatch path nothing (the caller passes one side stream; without it
  each fetch takes one from PyTorch's pool).  The source tensors are held until the copy's
  event completes (the caching allocator must not hand their memory to
  the next segment under the copy).  ``resolve()`` waits on that event
  and is called only after the next segment is in flight.

* :class:`BackgroundWriter`, the writer half: one worker thread runs the
  boundary tasks (history appends, checkpoint saves, telemetry records)
  in FIFO order, so every written byte is the synchronous path's.  Its
  queue is bounded (``max_pending``): at the bound ``submit`` blocks,
  which keeps host snapshots at a small constant.  A failed task is
  fail-stop and re-raised on the main thread's next call.  The worker
  touches numpy arrays only, never a CUDA tensor.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

import torch

from ..obs import flight
from ..utils.logging import get_logger

__all__ = ["BackgroundWriter", "HostFetch", "WriterFailed",
           "WRITER_THREAD_NAME"]

log = get_logger(__name__)

#: Thread name (the thread-leak tests look for it).
WRITER_THREAD_NAME = "jaxstream-io-writer"

_STOP = object()


class WriterFailed(RuntimeError):
    """A queued writer task raised; carries the original as __cause__."""


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class HostFetch:
    """A tree (dicts, lists, tuples) of tensors whose device-to-host
    copies are in flight.

    Construction does not block: every CUDA tensor gets a pinned host
    buffer and a ``non_blocking`` copy on the side stream, which first
    waits on an event recorded on the current (compute) stream; CPU
    tensors are copied at once.  :meth:`resolve` waits for the copies
    and returns the tree with numpy leaves (views of the pinned
    buffers); resolving twice returns the same host tree.  Non-tensor
    leaves pass through.  Nothing may write a source tensor in place
    before :meth:`resolve`: the copy runs beside later work on the
    compute stream (``Simulation`` fetches an on-device clone).
    """

    def __init__(self, tree: Any, stream: Optional["torch.cuda.Stream"] = None):
        self._src = []            # the sources, alive until the copies end
        self._done = None
        self._host: Any = None
        cuda = []
        _map(lambda a: cuda.append(a) if isinstance(a, torch.Tensor)
             and a.is_cuda else None, tree)
        if not cuda:
            self._tree = _map(lambda a: a.detach().clone()
                              if isinstance(a, torch.Tensor) else a, tree)
            return
        dev = cuda[0].device
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        side = stream if stream is not None else torch.cuda.Stream(dev)
        self._done = torch.cuda.Event()

        def start(a):
            if not isinstance(a, torch.Tensor):
                return a
            if not a.is_cuda:
                return a.detach().clone()
            buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            buf.copy_(a, non_blocking=True)
            self._src.append(a)
            return buf

        with torch.cuda.stream(side):
            side.wait_event(ready)
            self._tree = _map(start, tree)
            self._done.record(side)

    def resolve(self) -> Any:
        if self._tree is not None:
            if self._done is not None:
                self._done.synchronize()
            self._host = _map(
                lambda a: a.detach().cpu().numpy()
                if isinstance(a, torch.Tensor) else a, self._tree)
            self._tree = None
            self._src = []        # drop the device references promptly
        return self._host


class BackgroundWriter:
    """Bounded-queue worker thread for boundary I/O tasks.

    ``max_pending`` is the backpressure bound: ``submit`` blocks while
    the queue already holds that many tasks.  All tasks run on ONE
    worker in submission order.  After a task fails, the exception is
    stored, every later queued task is *skipped* (fail-stop — a
    history store must not receive frame k+1 after frame k failed
    half-written), and the next ``submit``/``flush``/``close`` raises
    :class:`WriterFailed` from it.
    """

    def __init__(self, max_pending: int = 2,
                 name: str = WRITER_THREAD_NAME):
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._exc is None:       # fail-stop after first error
                    fn, args, kwargs = item
                    fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — must survive
                self._exc = e
                flight.record("io.writer_failed",
                              error=type(e).__name__, detail=str(e))
                log.warning("background writer task failed (%s: %s); "
                            "skipping the remaining queue",
                            type(e).__name__, e)
            finally:
                self._q.task_done()

    # -------------------------------------------------------- main thread
    def _raise_pending(self):
        if self._exc is not None:
            # Drain BEFORE clearing: every task enqueued before the
            # failure must be skipped by the worker (which still sees
            # _exc) — clearing first would let the worker run frame
            # k+1's append after frame k's failed half-written.  The
            # join is fast: the worker is only marking tasks done.
            self._q.join()
            exc, self._exc = self._exc, None
            raise WriterFailed(
                f"background writer task failed: "
                f"{type(exc).__name__}: {exc}") from exc

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._closed

    @property
    def pending(self) -> int:
        """Tasks queued but not yet picked up (snapshot, racy)."""
        return self._q.qsize()

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)``; blocks at the queue bound.

        The block IS the backpressure: the caller (the run loop) stalls
        until the worker drains below ``max_pending``, so pending host
        snapshots never exceed the bound."""
        if self._closed:
            raise RuntimeError("BackgroundWriter is closed")
        self._raise_pending()
        if self._q.full():
            # The run loop is about to stall on host I/O — exactly the
            # condition a postmortem wants on its timeline.
            flight.record("io.backpressure", pending=self._q.qsize())
        self._q.put((fn, args, kwargs))

    def flush(self) -> None:
        """Block until every queued task has run; raise on task failure."""
        self._q.join()
        self._raise_pending()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue, stop and join the worker; raise on failure.

        Idempotent.  The sentinel rides the same FIFO queue, so every
        task submitted before ``close`` completes before the thread
        exits."""
        if self._closed:
            self._raise_pending()
            return
        self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout)
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        # On an exception the queue still drains (flush-on-exception:
        # the postmortem evidence must land) but a writer failure must
        # not mask the in-flight exception.
        if exc_type is not None:
            try:
                self.close()
            except Exception as e:
                log.warning("background writer close failed during "
                            "exception unwind (%s: %s)",
                            type(e).__name__, e)
        else:
            self.close()
