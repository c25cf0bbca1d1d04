"""Device resolution for the port's entry points.

Every entry point defaults to the GPU.  Running on the CPU is an
explicit request (``device="cpu"``) — the tests make it, production
callers do not — so a machine that lost its GPU fails loudly instead of
silently integrating on the host.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU; raise if a CUDA device is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jaxstream_torch runs on the GPU by default, and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path "
            "on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # Tensors report an indexed device; keep comparisons exact.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
