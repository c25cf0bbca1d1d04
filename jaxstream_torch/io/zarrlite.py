"""Minimal zarr-v2 directory store — writer and reader, numpy only
(the port's own copy of :mod:`jaxstream.io.zarrlite`).

Implements the on-disk **zarr v2 spec** directly (``.zgroup`` /
``.zarray`` / ``.zattrs`` JSON plus C-order raw chunk files,
``compressor: null``), byte for byte as the JAX package writes it, so
that either package reads the other's stores and the real ``zarr`` /
xarray stack reads both.  Every file is written atomically (temp file +
``os.replace``), and an array's record count (its ``.zarray`` shape) is
published after the record's chunks.

Scope: C-order, little-endian dtypes, no compressor, no filters.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ZarrGroup", "ZarrArray", "open_group"]

_FILL = {"f": 0.0, "i": 0, "u": 0, "b": False}


def _atomic_write_bytes(path: str, data) -> None:
    """Write ``path`` (``data`` bytes-like: bytes or a C-contiguous
    array) via a same-directory temp file + ``os.replace``.

    Every chunk and metadata write in this store goes through here: a
    killed process can leave a stale ``.__tmp__`` orphan but never a
    torn file — readers see either the old bytes or the new bytes,
    atomically.  POSIX rename semantics; the temp name carries the pid
    so concurrent writers of *different* records cannot collide.
    """
    tmp = f"{path}.__tmp__{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _dump_json(path: str, obj: Any) -> None:
    """Serialize metadata exactly as zarr-python v2 does.

    zarr-python's ``zarr.util.json_dumps`` uses ``indent=4``,
    ``sort_keys=True``, ascii, ``(',', ': ')`` separators — matching it
    byte-for-byte means stores written here are indistinguishable from
    ones written by the real package (golden-fixture tested).
    """
    _atomic_write_bytes(path, json.dumps(
        obj, indent=4, sort_keys=True, ensure_ascii=True,
        separators=(",", ": ")).encode("ascii"))


def _dtype_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.byteorder == "=":
        return "<" + dt.str[1:] if dt.itemsize > 1 else "|" + dt.str[1:]
    return dt.str


class ZarrArray:
    """One zarr-v2 array (chunked, uncompressed)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as fh:
            self.meta = json.load(fh)
        self.shape = tuple(self.meta["shape"])
        self.chunks = tuple(self.meta["chunks"])
        self.dtype = np.dtype(self.meta["dtype"])

    # -- creation ------------------------------------------------------------
    @staticmethod
    def create(
        path: str,
        shape: Sequence[int],
        dtype,
        chunks: Optional[Sequence[int]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> "ZarrArray":
        os.makedirs(path, exist_ok=True)
        dtype = np.dtype(dtype)
        chunks = tuple(chunks) if chunks else tuple(shape)
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": _dtype_str(dtype),
            "compressor": None,
            "fill_value": _FILL.get(dtype.kind, 0),
            "order": "C",
            "filters": None,
        }
        _dump_json(os.path.join(path, ".zarray"), meta)
        if attrs:
            _dump_json(os.path.join(path, ".zattrs"), attrs)
        return ZarrArray(path)

    # -- chunk addressing ----------------------------------------------------
    def _grid(self) -> Tuple[int, ...]:
        return tuple(
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        )

    def _chunk_file(self, idx: Tuple[int, ...]) -> str:
        return os.path.join(self.path, ".".join(str(i) for i in idx))

    # -- I/O -----------------------------------------------------------------
    def write_full(self, data: np.ndarray) -> None:
        """Write the entire array (any chunking)."""
        data = np.ascontiguousarray(data, dtype=self.dtype)
        if data.shape != self.shape:
            raise ValueError(f"shape {data.shape} != array {self.shape}")
        for idx in np.ndindex(*self._grid()):
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            block = data[sel]
            # Pad partial edge chunks to full chunk shape (zarr v2 layout).
            if block.shape != self.chunks:
                full = np.full(self.chunks, self.meta["fill_value"],
                               dtype=self.dtype)
                full[tuple(slice(0, e) for e in block.shape)] = block
                block = full
            _atomic_write_bytes(self._chunk_file(idx),
                                np.ascontiguousarray(block).tobytes())

    def write_index0(self, i: int, data: np.ndarray) -> None:
        """Write one slab along axis 0 (requires chunks[0] == 1)."""
        if self.chunks[0] != 1:
            raise ValueError("write_index0 needs chunks[0] == 1")
        # NB: not ascontiguousarray — that would promote 0-d slabs to 1-d.
        data = np.asarray(data, dtype=self.dtype)
        if data.shape != self.shape[1:]:
            raise ValueError(f"slab shape {data.shape} != {self.shape[1:]}")
        grid_rest = tuple(
            -(-s // c) for s, c in zip(self.shape[1:], self.chunks[1:])
        )
        for rest in np.ndindex(*grid_rest):
            sel = tuple(
                slice(j * c, min((j + 1) * c, s))
                for j, c, s in zip(rest, self.chunks[1:], self.shape[1:])
            )
            block = data[sel]
            if block.shape != tuple(self.chunks[1:]):
                full = np.full(self.chunks[1:], self.meta["fill_value"],
                               dtype=self.dtype)
                full[tuple(slice(0, e) for e in block.shape)] = block
                block = full
            # The array's own buffer, not a bytes copy: the write then
            # runs with the interpreter lock released.
            _atomic_write_bytes(self._chunk_file((i,) + rest),
                                np.ascontiguousarray(block[None]))
        if i >= self.shape[0]:
            # Grow the record axis LAST: .zarray's shape is what readers
            # trust for the record count, so a crash between the chunk
            # writes above and this publish leaves a dangling orphan
            # chunk, never a published slab whose bytes are missing
            # (which would read as fill values).
            self.resize0(i + 1)

    def resize0(self, new_len: int) -> None:
        self.shape = (new_len,) + self.shape[1:]
        self.meta["shape"] = list(self.shape)
        _dump_json(os.path.join(self.path, ".zarray"), self.meta)

    def read(self) -> np.ndarray:
        out = np.full(self.shape, self.meta["fill_value"], dtype=self.dtype)
        cshape = self.chunks
        for idx in np.ndindex(*self._grid()):
            f = self._chunk_file(idx)
            if not os.path.exists(f):
                continue
            block = np.frombuffer(
                open(f, "rb").read(), dtype=self.dtype
            ).reshape(cshape)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, cshape, self.shape)
            )
            out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out

    @property
    def attrs(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".zattrs")
        if os.path.exists(p):
            with open(p) as fh:
                return json.load(fh)
        return {}


class ZarrGroup:
    """A zarr-v2 group: nested arrays/groups + attributes."""

    def __init__(self, path: str):
        self.path = path

    @staticmethod
    def create(path: str, attrs: Optional[Dict[str, Any]] = None) -> "ZarrGroup":
        os.makedirs(path, exist_ok=True)
        _dump_json(os.path.join(path, ".zgroup"), {"zarr_format": 2})
        if attrs:
            _dump_json(os.path.join(path, ".zattrs"), attrs)
        return ZarrGroup(path)

    def create_array(self, name: str, shape, dtype, chunks=None, attrs=None):
        return ZarrArray.create(
            os.path.join(self.path, name), shape, dtype, chunks, attrs
        )

    def create_group(self, name: str, attrs=None) -> "ZarrGroup":
        return ZarrGroup.create(os.path.join(self.path, name), attrs)

    def __getitem__(self, name: str):
        p = os.path.join(self.path, name)
        if os.path.exists(os.path.join(p, ".zarray")):
            return ZarrArray(p)
        if os.path.exists(os.path.join(p, ".zgroup")):
            return ZarrGroup(p)
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        p = os.path.join(self.path, name)
        return os.path.exists(os.path.join(p, ".zarray")) or os.path.exists(
            os.path.join(p, ".zgroup")
        )

    def keys(self):
        if not os.path.isdir(self.path):
            return
        for name in sorted(os.listdir(self.path)):
            if name.startswith("."):
                continue
            if name in self:
                yield name

    @property
    def attrs(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".zattrs")
        if os.path.exists(p):
            with open(p) as fh:
                return json.load(fh)
        return {}


def open_group(path: str) -> ZarrGroup:
    if not os.path.exists(os.path.join(path, ".zgroup")):
        raise FileNotFoundError(f"no zarr group at {path}")
    return ZarrGroup(path)
