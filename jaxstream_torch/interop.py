"""Carry state across the two packages.

The JAX package's states are dicts of arrays; this port's are dicts of
tensors with the same layouts (interior state ``{"h": (6, n, n),
"u": (2, 6, n, n)}``, compact carry adds ``strips_sn (6, 6h, n)`` and
``strips_we (6, n, 6h)``, the filter-cycling carry adds ``filter_k``,
the extended carry is ``{"h": (6, M, M), "u": (2, 6, M, M), "strips":
(6, 12h, n)}``, the neighbour-read stepper's carry the same without the
strips (``{"h": (6, M, M), "u": (2, 6, M, M)}``; the whole-step stepper's
is the compact carry), extended fields such as ``b_ext`` ``(6, M, M)``; the
Cartesian model's interior state ``{"h": (6, n, n), "v": (3, 6, n, n)}``,
its extended carry ``{"h": (6, M, M), "v": (3, 6, M, M)}`` and its
in-kernel-exchange carry, which adds ``"sh_sn" (6, 2, h, n)``,
``"sh_we" (6, 2, n, h)``, ``"sv_sn" (3, 6, 2, h, n)`` and ``"sv_we"
(3, 6, 2, n, h)``).  The strip carries are plain arrays and cross as
such.  The models hold no weights: the grid, ``b_ext`` and the state are
their whole input.
Arrays cross as numpy, so neither package imports the other:
:func:`to_torch` turns numpy arrays (or anything ``np.asarray`` accepts,
such as a JAX array) into tensors on a device, :func:`to_numpy` turns
tensors back.  Values and dtypes are kept bit for bit.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["to_torch", "to_numpy"]

#: The split del^4 stepper's filter-cycling counter: an integer array in
#: the JAX package's carry, a Python int in the port's (no device sync).
FILTER_K = "filter_k"


def to_torch(tree, device=None):
    """Array or dict of arrays -> tensor(s) on ``device`` (default: the
    GPU).  A carry's ``filter_k`` step counter becomes a plain int."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: int(v) if k == FILTER_K else to_torch(v, dev)
                for k, v in tree.items()}
    # np.array copies: JAX hands out read-only buffers.
    return torch.from_numpy(np.array(tree, order="C")).to(dev)


def to_numpy(tree):
    """Tensor or dict of tensors -> numpy array(s) on the host; a
    ``filter_k`` step counter stays a plain int."""
    if isinstance(tree, Mapping):
        return {k: int(v) if k == FILTER_K else to_numpy(v)
                for k, v in tree.items()}
    return tree.detach().cpu().numpy()
