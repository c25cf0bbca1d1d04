"""Panel-local vector halo exchange with panel-basis rotation.

Counterpart of :mod:`jaxstream.parallel.vector_halo`.  A ghost cell's
value is the neighbour's vector re-expressed in the local panel's
extended basis: for contravariant components ``(u^a, u^b)`` the rotation
is ``T[i][j] = a_i^local(ghost) . e_j^nbr(src)``, for covariant ones
``(u_a, u_b)`` the two bases swap roles, ``T[i][j] = e_i^local(ghost) .
a_j^nbr(src)``.  The 2x2 rotations are computed once, in numpy from the
grid's bases, exactly as the JAX package computes them; the exchange is
then one gather, two multiply-adds and one scatter over all 24 strips.
:func:`to_contravariant` and :func:`to_cartesian` convert between the
Cartesian ``(3, 6, M, M)`` vector and the contravariant pair.

Layout: ``(2, 6, M, M)`` — component axis leading.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..geometry.connectivity import build_connectivity
from ..geometry.cubed_sphere import CubedSphereGrid
from .halo import _fill_corners, read_strip, write_strip

__all__ = ["make_vector_halo_exchanger", "to_contravariant", "to_cartesian"]


def to_contravariant(grid: CubedSphereGrid, v: torch.Tensor) -> torch.Tensor:
    """Cartesian ``(3, 6, M, M)`` -> contravariant ``(2, 6, M, M)``."""
    return torch.stack([torch.sum(v * grid.a_a, dim=0),
                        torch.sum(v * grid.a_b, dim=0)])


def to_cartesian(grid: CubedSphereGrid, uv: torch.Tensor) -> torch.Tensor:
    """Contravariant ``(2, 6, M, M)`` -> Cartesian ``(3, 6, M, M)``."""
    return uv[0][None] * grid.e_a + uv[1][None] * grid.e_b


def _strip_indices(n: int, halo: int):
    """Index maps from the canonical strip frame to flat (M*M) positions.

    ``src_idx[edge]``: flat positions (in one face's (M, M)) of the
    interior boundary strip :func:`read_strip` returns, in canonical
    (depth, along) order; ``dst_idx[edge]``: the ghost-ring positions
    :func:`write_strip` writes for a canonical strip.
    """
    m = n + 2 * halo
    flat = np.arange(m * m).reshape(1, m, m)
    src_idx, dst_idx = [], []
    for e in range(4):
        s = read_strip(flat, 0, e, halo, n)
        src_idx.append(np.ascontiguousarray(s).reshape(halo * n))
        marker = np.arange(halo * n).reshape(halo, n)
        out = write_strip(np.full((1, m, m), -1), 0, e, marker)[0]
        pos = np.argsort(out.ravel())[m * m - halo * n:]  # where out >= 0
        order = out.ravel()[pos]
        dst = np.empty(halo * n, dtype=np.int64)
        dst[order] = pos
        dst_idx.append(dst)
    return src_idx, dst_idx


def make_vector_halo_exchanger(grid: CubedSphereGrid,
                               fill_corners: bool = True,
                               components: str = "contravariant") -> Callable:
    """Build ``exchange(uv) -> uv`` for panel-local ``(2, 6, M, M)``
    tensors of ``components`` ``'contravariant'`` (the JAX package's
    default) or ``'covariant'``."""
    if components not in ("contravariant", "covariant"):
        raise ValueError(f"unknown components {components!r}")
    n, halo, m = grid.n, grid.halo, grid.m
    adj = build_connectivity()
    src_idx, dst_idx = _strip_indices(n, halo)

    def flat_basis(t):
        return np.moveaxis(t.cpu().numpy(), 0, -1).reshape(6, m * m, 3)

    e_a, e_b = flat_basis(grid.e_a), flat_basis(grid.e_b)
    a_a, a_b = flat_basis(grid.a_a), flat_basis(grid.a_b)
    loc = (a_a, a_b) if components == "contravariant" else (e_a, e_b)
    nbr = (e_a, e_b) if components == "contravariant" else (a_a, a_b)

    # The JAX package walks the copies in its staged schedule order; the
    # scatter targets are disjoint, so any order gives the same field.
    srcs, dsts, rots = [], [], []
    for f in range(6):
        for e in range(4):
            link = adj[f][e]
            src_flat = src_idx[link.nbr_edge].reshape(halo, n)
            if link.reversed_:
                src_flat = src_flat[:, ::-1]
            src_flat = src_flat.reshape(-1)
            dst_flat = dst_idx[link.edge]
            al = np.stack([loc[0][f, dst_flat], loc[1][f, dst_flat]],
                          axis=1)                            # (h*n, 2, 3)
            en = np.stack([nbr[0][link.nbr_face, src_flat],
                           nbr[1][link.nbr_face, src_flat]], axis=2)
            rots.append(al @ en)                             # (h*n, 2, 2)
            srcs.append(link.nbr_face * m * m + src_flat)
            dsts.append(f * m * m + dst_flat)
    dev = grid.device
    src = torch.from_numpy(np.concatenate(srcs)).to(dev)
    dst = torch.from_numpy(np.concatenate(dsts)).to(dev)
    T = torch.from_numpy(np.concatenate(rots)).to(dev)      # (K, 2, 2)

    def exchange(u: torch.Tensor) -> torch.Tensor:
        if tuple(u.shape) != (2, 6, m, m):
            raise ValueError(
                f"vector halo exchanger built for n={n}, halo={halo} "
                f"expects (2, 6, {m}, {m}), got {tuple(u.shape)}")
        flat = u.reshape(2, 6 * m * m)
        comp = flat.index_select(1, src)                     # (2, K)
        rot = torch.stack([T[:, 0, 0] * comp[0] + T[:, 0, 1] * comp[1],
                           T[:, 1, 0] * comp[0] + T[:, 1, 1] * comp[1]])
        out = flat.clone()
        out[:, dst] = rot
        out = out.reshape(2, 6, m, m)
        return _fill_corners(out, halo, n) if fill_corners else out

    return exchange
