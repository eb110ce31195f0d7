"""Device resolution for the port.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
There is no fallback: a caller who wants the CPU says so, and asking for a
card where none is visible raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (a string, a ``torch.device`` or None for the default) as a
    ``torch.device``; raises when it names CUDA and no card is visible. A
    CUDA device without an index is the current card, named by its index,
    so that devices compare equal to the ones tensors report."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is visible; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
