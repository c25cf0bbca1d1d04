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
tensors back.  Values and dtypes are kept bit for bit.  Member-batched
carries (``h (B, 6, n, n)``, ``u (2, B, 6, n, n)``, ``strips_* (B, 6,
...)``) and the 16-bit carries (int16, float16, and bfloat16 h / u or
strips) cross the same way: numpy has no bfloat16 of its own (the JAX
package's comes from ``ml_dtypes``, which ``torch.from_numpy`` rejects and
``Tensor.numpy()`` cannot make), so a bfloat16 array crosses as its 16 bits
through an int16 view, recognised by the dtype's name; the port imports
no ``ml_dtypes``.
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
    arr = np.array(tree, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def to_numpy(tree):
    """Tensor or dict of tensors -> numpy array(s) on the host; a
    ``filter_k`` step counter stays a plain int."""
    if isinstance(tree, Mapping):
        return {k: int(v) if k == FILTER_K else to_numpy(v)
                for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy's bfloat16 where a package registered one (JAX's
        # ml_dtypes), else the raw bits as uint16.
        bits = t.view(torch.int16).numpy()
        try:
            return bits.view(np.dtype("bfloat16"))
        except TypeError:
            return bits.view(np.uint16)
    return t.numpy()
