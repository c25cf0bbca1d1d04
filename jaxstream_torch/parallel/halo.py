"""Single-device cubed-sphere halo exchange for scalar fields.

Counterpart of :func:`jaxstream.parallel.halo.make_halo_exchanger`.  On
one device every ghost cell is a copy of one interior cell of a
neighbouring face, so the 24 directed strip copies of the JAX package
collapse to one static gather: the index map is built once from the
canonical strip frame (:func:`read_strip` / :func:`write_strip`, on
numpy index arrays) and applied as ``index_select`` — the same values,
copied bit for bit.  The h-by-h ghost corners are then filled by
edge-ghost averaging (:func:`_fill_corners`), as in the JAX package.

:func:`make_concat_exchanger` is the JAX package's concat-layout
exchanger, value for value the same exchange (same strips, same corner
averaging); on one device the port builds it on the same gather.
:func:`canonicalize_strip` and :func:`place_strip` are the per-edge frame
transforms of a raw boundary slice and of a ghost block, shared with the
Cartesian fused stepper's strip router.

Field layout: ``(..., 6, M, M)``; leading axes are carried through.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                     build_connectivity)

__all__ = ["canonicalize_strip", "place_strip", "read_strip", "write_strip",
           "make_halo_exchanger", "make_concat_exchanger"]


def canonicalize_strip(edge: int, raw):
    """Raw boundary slice -> canonical ``(..., halo, n)`` strip: the
    per-edge frame of :func:`read_strip` applied to an already-sliced raw
    strip (S/N row blocks ``(..., halo, n)``, W/E column blocks ``(...,
    n, halo)``)."""
    if edge == EDGE_S:
        return raw
    if edge == EDGE_N:
        return torch.flip(raw, dims=[-2])
    if edge == EDGE_W:
        return torch.transpose(raw, -1, -2)
    if edge == EDGE_E:
        return torch.transpose(torch.flip(raw, dims=[-1]), -1, -2)
    raise ValueError(edge)


def place_strip(edge: int, strip):
    """Canonical ``(..., halo, n)`` strip -> the ghost-ring block as it is
    written: S flips depth, N is the identity, W/E transpose to ``(...,
    n, halo)`` column blocks (the inverse frame of :func:`read_strip`)."""
    if edge == EDGE_S:
        return torch.flip(strip, dims=[-2])
    if edge == EDGE_N:
        return strip
    if edge == EDGE_W:
        return torch.flip(torch.transpose(strip, -1, -2), dims=[-1])
    if edge == EDGE_E:
        return torch.transpose(strip, -1, -2)
    raise ValueError(edge)


def read_strip(field: np.ndarray, face: int, edge: int, halo: int, n: int):
    """Interior boundary strip of ``face``/``edge`` in canonical frame
    ``(..., halo, n)``: axis -2 is depth (0 = nearest the edge), axis -1
    the along-edge index (increasing alpha for S/N, beta for E/W)."""
    h, hn = halo, halo + n
    a = field[..., face, :, :]
    if edge == EDGE_S:
        return a[..., h : 2 * h, h:hn]
    if edge == EDGE_N:
        return np.flip(a[..., hn - h : hn, h:hn], axis=-2)
    if edge == EDGE_W:
        return np.swapaxes(a[..., h:hn, h : 2 * h], -1, -2)
    if edge == EDGE_E:
        return np.swapaxes(np.flip(a[..., h:hn, hn - h : hn], axis=-1),
                           -1, -2)
    raise ValueError(edge)


def write_strip(field: np.ndarray, face: int, edge: int, strip):
    """Write a canonical ``(..., halo, n)`` strip into the ghost ring of a
    copy of ``field`` (the inverse frame of :func:`read_strip`)."""
    h, n = strip.shape[-2], strip.shape[-1]
    hn = h + n
    out = np.array(field, copy=True)
    if edge == EDGE_S:
        out[..., face, 0:h, h:hn] = np.flip(strip, axis=-2)
    elif edge == EDGE_N:
        out[..., face, hn : hn + h, h:hn] = strip
    elif edge == EDGE_W:
        out[..., face, h:hn, 0:h] = np.flip(np.swapaxes(strip, -1, -2),
                                            axis=-1)
    elif edge == EDGE_E:
        out[..., face, h:hn, hn : hn + h] = np.swapaxes(strip, -1, -2)
    else:
        raise ValueError(edge)
    return out


def _fill_corners(field: torch.Tensor, halo: int, n: int) -> torch.Tensor:
    """Fill the 4 h-by-h ghost corner blocks per face by edge-ghost
    averaging (in place; dimension-split stencils never read them)."""
    h, hn = halo, halo + n
    f = field
    f[..., 0:h, 0:h] = 0.5 * (f[..., 0:h, h : h + 1] + f[..., h : h + 1, 0:h])
    f[..., 0:h, hn : hn + h] = 0.5 * (f[..., 0:h, hn - 1 : hn]
                                      + f[..., h : h + 1, hn : hn + h])
    f[..., hn : hn + h, 0:h] = 0.5 * (f[..., hn : hn + h, h : h + 1]
                                      + f[..., hn - 1 : hn, 0:h])
    f[..., hn : hn + h, hn : hn + h] = 0.5 * (
        f[..., hn : hn + h, hn - 1 : hn] + f[..., hn - 1 : hn, hn : hn + h])
    return f


def ghost_gather_index(n: int, halo: int, adj=None) -> np.ndarray:
    """Flat ``(6*M*M,)`` source index of every cell after the exchange:
    identity off the edge ghosts, the neighbour's interior cell on them."""
    adj = adj or build_connectivity()
    m = n + 2 * halo
    flat = np.arange(6 * m * m).reshape(6, m, m)
    out = flat.copy()
    for f in range(6):
        for e in range(4):
            link = adj[f][e]
            s = read_strip(flat, link.nbr_face, link.nbr_edge, halo, n)
            if link.reversed_:
                s = np.flip(s, axis=-1)
            out = write_strip(out, f, e, s)
    return out.reshape(-1)


def make_halo_exchanger(n: int, halo: int,
                        fill_corners: bool = True) -> Callable:
    """Build ``exchange(field) -> field`` for ``(..., 6, M, M)`` tensors."""
    m = n + 2 * halo
    index = torch.from_numpy(ghost_gather_index(n, halo))
    cache: dict = {}

    def exchange(field: torch.Tensor) -> torch.Tensor:
        if tuple(field.shape[-3:]) != (6, m, m):
            raise ValueError(
                f"halo exchanger built for n={n}, halo={halo} expects a "
                f"(..., 6, {m}, {m}) field, got {tuple(field.shape)}")
        idx = cache.get(field.device)
        if idx is None:
            idx = cache[field.device] = index.to(field.device)
        lead = field.shape[:-3]
        out = field.reshape(lead + (6 * m * m,)).index_select(-1, idx)
        out = out.reshape(field.shape)
        return _fill_corners(out, halo, n) if fill_corners else out

    return exchange



def make_concat_exchanger(n: int, halo: int) -> Callable:
    """The JAX package's concat-layout exchanger (each face rebuilt from
    its interior and the placed neighbour strips, corners averaged from
    the edge ghosts): value for value :func:`make_halo_exchanger`'s
    exchange, which it is."""
    return make_halo_exchanger(n, halo)
