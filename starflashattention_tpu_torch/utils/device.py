"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
card and no explicit CPU request they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` or ``cuda`` when None; raises if that is a CUDA device and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or CPU tensors) "
            "to run the plain PyTorch versions of the kernels"
        )
    return dev
