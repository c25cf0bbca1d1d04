"""Cubed-sphere panel connectivity, derived numerically.

Counterpart of :mod:`jaxstream.geometry.connectivity`: the adjacency is
found by matching 3-D edge points of the face maps, so it is correct by
construction for the face layout of :mod:`.cubed_sphere`.  The staged
exchange schedule is not needed on a single device and comes with the
multi-GPU tiers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .cubed_sphere import NUM_FACES, face_points

__all__ = ["EDGE_S", "EDGE_E", "EDGE_N", "EDGE_W", "EdgeLink",
           "build_connectivity", "edge_pairs"]

# Edge ids: S = beta min, E = alpha max, N = beta max, W = alpha min.
EDGE_S, EDGE_E, EDGE_N, EDGE_W = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class EdgeLink:
    """Face ``face``'s edge ``edge`` abuts ``nbr_face``'s edge ``nbr_edge``.

    ``reversed_`` is True when the along-edge index runs in opposite
    directions on the two faces.
    """

    face: int
    edge: int
    nbr_face: int
    nbr_edge: int
    reversed_: bool


def _edge_coords(edge: int, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(alpha, beta) along an edge at parameter t in [0, 1]; the along-edge
    parameter increases with alpha (S/N edges) or beta (E/W edges)."""
    q = np.pi / 4
    s = -q + t * (2 * q)
    if edge == EDGE_S:
        return s, np.full_like(s, -q)
    if edge == EDGE_N:
        return s, np.full_like(s, q)
    if edge == EDGE_W:
        return np.full_like(s, -q), s
    if edge == EDGE_E:
        return np.full_like(s, q), s
    raise ValueError(edge)


def build_connectivity() -> List[List[EdgeLink]]:
    """adj[face][edge] -> EdgeLink, derived by matching 3-D edge points."""
    t = np.array([0.1, 0.3, 0.5, 0.7, 0.9])
    pts = {}
    for f in range(NUM_FACES):
        for e in range(4):
            a, b = _edge_coords(e, t)
            pts[(f, e)] = face_points(f, a, b)

    adj: List[List[EdgeLink]] = [[None] * 4 for _ in range(NUM_FACES)]  # type: ignore
    for f in range(NUM_FACES):
        for e in range(4):
            found = None
            for g in range(NUM_FACES):
                if g == f:
                    continue
                for e2 in range(4):
                    p, q = pts[(f, e)], pts[(g, e2)]
                    if np.allclose(p, q, atol=1e-12):
                        found = (g, e2, False)
                    elif np.allclose(p, q[::-1], atol=1e-12):
                        found = (g, e2, True)
                    if found:
                        break
                if found:
                    break
            if found is None:
                raise RuntimeError(f"no neighbor found for face {f} edge {e}")
            adj[f][e] = EdgeLink(f, e, *found)
    for f in range(NUM_FACES):
        for e in range(4):
            link = adj[f][e]
            back = adj[link.nbr_face][link.nbr_edge]
            if (back.nbr_face, back.nbr_edge) != (f, e) \
                    or back.reversed_ != link.reversed_:
                raise RuntimeError(f"asymmetric link at face {f} edge {e}")
    return adj


def edge_pairs(adj=None) -> List[Tuple[EdgeLink, EdgeLink]]:
    """The 12 undirected cube edges as (link, backlink) pairs."""
    adj = adj or build_connectivity()
    seen = set()
    pairs = []
    for f in range(NUM_FACES):
        for e in range(4):
            link = adj[f][e]
            key = tuple(sorted([(f, e), (link.nbr_face, link.nbr_edge)]))
            if key in seen:
                continue
            seen.add(key)
            pairs.append((link, adj[link.nbr_face][link.nbr_edge]))
    if len(pairs) != 12:
        raise RuntimeError(f"expected 12 cube edges, found {len(pairs)}")
    return pairs
