"""Device resolution for the port's entry points, and the card facts the
kernels' wrappers size their grids by.

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


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]
