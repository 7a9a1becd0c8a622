"""Numpy <-> torch bridge for parameter trees and KV caches.

The JAX package's arrays reach the port as numpy arrays (the caller does
``np.asarray(jax_array)``), so the port never sees JAX. bf16 arrives as
``ml_dtypes.bfloat16`` and fp8 as ``ml_dtypes.float8_e4m3fn``, which
``torch.from_numpy`` refuses; both cross as same-width integer views, which
is exact. The layouts stay the JAX package's: weights are (L, H, O) and used
as ``x @ w``, so nothing is transposed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from starflashattention_tpu_torch.cache.contiguous import KVCache

# numpy dtype name -> (integer view of the same width, torch dtype)
_VIEWED = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def tensor_from_numpy(arr, device: torch.device | str = "cpu") -> torch.Tensor:
    """One numpy array (any dtype the JAX package uses) -> torch tensor."""
    arr = np.array(arr, copy=True, order="C")  # writable and contiguous
    viewed = _VIEWED.get(arr.dtype.name)
    if viewed is not None:
        int_dtype, torch_dtype = viewed
        t = torch.from_numpy(arr.view(int_dtype)).view(torch_dtype)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy. bf16 and fp8 come back as float32 (an exact
    upcast), so no numpy extension dtype is needed."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Convert a params tree of numpy arrays (dicts nested as in the JAX
    package's ``llama.init_params``) into the port's dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def cache_from_numpy(
    k, v, lengths, k_scales=None, v_scales=None,
    device: torch.device | str = "cpu",
) -> KVCache:
    """A JAX ``KVCache``'s arrays (given as numpy) -> the port's KVCache."""
    def conv(a):
        return None if a is None else tensor_from_numpy(a, device)

    return KVCache(
        k=conv(k), v=conv(v), lengths=conv(lengths).to(torch.int32),
        k_scales=conv(k_scales), v_scales=conv(v_scales),
    )
