"""The host-built tables of the kernels' steppers, kept per bucket build.

A stepper's construction computes tables on the host before its first
launch: the split router's gather indices, rotation entries and seam
tables (:class:`~.swe_cov._SplitRoute`), its edge sqrtg rows, and each
stage kernel's coordinate rows and face frames (``_RhsBase``).  While a
:class:`TableStore` is active on a thread (:func:`using`), :func:`table`
returns a table the store holds, and builds and keeps one it does not,
counting the build.  The serving warm pool saves a bucket's store with
``torch.save`` and hands it back to the next process's build of the same
bucket, which then builds no table.  With no store active :func:`table`
builds, as the steppers always did.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["TableStore", "table", "using"]

_active = threading.local()


class TableStore:
    """``{key: tensor or tuple of tensors}`` of one bucket's build, and
    ``builds``: how many of them were built (not found) while it was
    active."""

    def __init__(self, tables=None):
        self.tables = dict(tables or {})
        self.builds = 0


@contextlib.contextmanager
def using(store: TableStore):
    """Make ``store`` the active store of this thread for the block."""
    prev = getattr(_active, "store", None)
    _active.store = store
    try:
        yield store
    finally:
        _active.store = prev


def table(key: str, build):
    """Table ``key``: the active store's, or ``build()`` (kept in the
    active store, where there is one)."""
    store = getattr(_active, "store", None)
    if store is None:
        return build()
    if key not in store.tables:
        store.tables[key] = build()
        store.builds += 1
    return store.tables[key]
