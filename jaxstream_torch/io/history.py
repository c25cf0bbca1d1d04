"""History and geometry stores (counterpart of :mod:`jaxstream.io.history`).

``HistoryWriter`` appends prognostic-state snapshots along an unlimited
time axis; ``save_geometry`` persists the grid's arrays.  Both write the
zarr-v2 directory format through :mod:`jaxstream_torch.io.zarrlite`,
with the JAX package's layout, names and ``conventions`` attributes
(``jaxstream-history-1``, ``jaxstream-geometry-1``): for equal states the
two packages' stores are byte-equal, and each reads the other's.

Tensors are copied to the host once per write (``.cpu().numpy()``); keep
the write stride coarse.  TT-compressed snapshots (``tt_rank``) are not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.cubed_sphere import METRIC_ATTRS, CubedSphereGrid
from ..geometry.cubed_sphere import _np_dtype as _torch_np_dtype
from .zarrlite import ZarrGroup, open_group

__all__ = ["HistoryWriter", "extract_member", "geometry_matches",
           "member_axis", "save_geometry", "load_geometry_arrays",
           "to_host"]


def to_host(a) -> np.ndarray:
    """A tensor (any device) or array-like -> a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _torch_np_dtype(dtype)
    return np.dtype(dtype)


def member_axis(a) -> int:
    """Member-axis position of a member-batched cubed-sphere field:
    ``ndim - 4`` (directly before the trailing ``(6, n, n)``), for
    ``(B, 6, n, n)``, ``(c, B, 6, n, n)`` and their record-stacked forms
    alike.  Only valid on member-batched arrays."""
    ax = np.ndim(a) - 4
    if ax < 0:
        raise ValueError(
            f"array of rank {np.ndim(a)} is too small to be a "
            "member-batched panel field (needs >= (B, 6, n, n))")
    return ax


def extract_member(state: Dict, i: int) -> Dict:
    """Member ``i``'s fields out of a member-batched state dict, as
    numpy arrays with the shapes an unbatched run writes."""
    return {k: np.take(to_host(v), i, axis=member_axis(v))
            for k, v in state.items()}


def _refuse_tt(rank):
    raise NotImplementedError(
        f"TT-compressed history snapshots (tt_rank={rank!r}) are not "
        "ported yet: ROADMAP queue A item 8 (A11)")


class HistoryWriter:
    """Append state snapshots to a zarr group with a record time axis.

    Reopening an existing store appends after its last committed record.
    ``tt_rank`` (TT-compressed snapshots) raises ``NotImplementedError``,
    as does reopening a store that the JAX package wrote with one.
    """

    def __init__(self, path: str, attrs: Optional[Dict] = None,
                 tt_rank: Optional[int] = None):
        if tt_rank:
            _refuse_tt(tt_rank)
        self.tt_rank = None
        if os.path.exists(os.path.join(path, ".zgroup")):
            self.group = open_group(path)
            # The time axis is the record count (appends commit it
            # last); a store killed before its first append is empty.
            self._len = (self.group["time"].shape[0]
                         if "time" in self.group else 0)
            if self.group.attrs.get("tt_rank"):
                _refuse_tt(self.group.attrs["tt_rank"])
        else:
            self.group = ZarrGroup.create(
                path, {**(attrs or {}), "conventions": "jaxstream-history-1",
                       "tt_rank": None}
            )
            self._len = 0

    def _write(self, name: str, i: int, a: np.ndarray) -> None:
        if name not in self.group:
            self.group.create_array(
                name, shape=(0,) + a.shape, dtype=a.dtype,
                chunks=(1,) + a.shape,
            )
        self.group[name].write_index0(i, a)

    def append(self, state: Dict, t: float) -> int:
        """Write one snapshot; returns its record index.

        Crash-safe as the JAX package's: every file is written
        atomically, and the ``time`` slab is written last, so the record
        count readers trust advances only once every field of the frame
        is in place.  A run killed mid-append leaves at most a dangling
        partial frame past the time axis, which the next append
        overwrites.
        """
        i = self._len
        if "time" not in self.group:
            self.group.create_array(
                "time", shape=(0,), dtype=np.float64, chunks=(1,)
            )
        for name, arr in state.items():
            self._write(name, i, to_host(arr))
        # Commit point: the frame exists once its time slab lands.
        self.group["time"].write_index0(i, np.asarray(float(t)))
        self._len = i + 1
        return i

    def read(self, name: str) -> np.ndarray:
        """A field's full record axis, truncated to the time axis (a
        frame whose time slab did not land is a dangling tail)."""
        if name in self.group:
            return self.group[name].read()[:self._len]
        raise KeyError(name)

    def read_member(self, name: str, i: int) -> np.ndarray:
        """One ensemble member's record axis of a member-batched field
        (a store whose ``members`` attribute is >= 2)."""
        members = self.group.attrs.get("members") or 0
        if members < 2:
            raise ValueError(
                f"store {self.group.path!r} is not member-batched "
                f"(members attr {members!r}); use read()")
        a = self.read(name)
        ax = member_axis(a)
        if not 0 <= i < a.shape[ax]:
            raise IndexError(
                f"member {i} out of range for {name!r} with "
                f"{a.shape[ax]} members")
        return np.take(a, i, axis=ax)

    @property
    def times(self) -> np.ndarray:
        return self.group["time"].read() if "time" in self.group else np.array([])

    def __len__(self) -> int:
        return self._len


def _grid_arrays(grid: CubedSphereGrid):
    """The grid's metric arrays in :class:`CubedSphereGrid`'s declaration
    order, the JAX grid's arrays by the same names.  A lazy grid's are
    evaluated here, broadcast to the eager grid's shapes."""
    for name in METRIC_ATTRS:
        v = getattr(grid, name)
        if tuple(v.shape[-3:]) != (6, grid.m, grid.m):
            v = v.expand(v.shape[:-3] + (6, grid.m, grid.m))
        yield name, v


def geometry_matches(path: str, grid: CubedSphereGrid) -> bool:
    """True iff ``path`` already holds this grid's geometry store:
    the identity attributes ``save_geometry`` stamps (n, halo, radius,
    dalpha) and the stored ``xyz`` dtype.  A missing, foreign or
    mismatched store gives False."""
    try:
        g = open_group(path)
        a = g.attrs
        if a.get("conventions") != "jaxstream-geometry-1":
            return False
        if (a.get("n"), a.get("halo")) != (grid.n, grid.halo):
            return False
        if (a.get("radius"), a.get("dalpha")) != (float(grid.radius),
                                                  float(grid.dalpha)):
            return False
        return g["xyz"].dtype == _np_dtype(grid.xyz.dtype)
    except (OSError, KeyError, ValueError, json.JSONDecodeError):
        return False


def save_geometry(path: str, grid: CubedSphereGrid,
                  skip_if_match: bool = True) -> None:
    """Persist every array of the grid plus its scalar metadata; with
    ``skip_if_match`` an existing store of the same grid is left as it
    is."""
    if skip_if_match and geometry_matches(path, grid):
        return
    g = ZarrGroup.create(
        path,
        {
            "n": grid.n,
            "halo": grid.halo,
            "radius": grid.radius,
            "dalpha": grid.dalpha,
            "conventions": "jaxstream-geometry-1",
        },
    )
    for name, v in _grid_arrays(grid):
        a = to_host(v)
        g.create_array(name, a.shape, a.dtype).write_full(a)


def load_geometry_arrays(path: str) -> Dict[str, np.ndarray]:
    """Read back the geometry arrays (plus attrs under key '__attrs__')."""
    g = open_group(path)
    out: Dict[str, np.ndarray] = {k: g[k].read() for k in g.keys()}
    out["__attrs__"] = g.attrs  # type: ignore[assignment]
    return out
