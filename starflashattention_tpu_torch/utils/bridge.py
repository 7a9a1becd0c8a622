"""Numpy <-> torch bridge for parameter trees, KV caches and paged pools.

The JAX package's arrays reach the port as numpy arrays (the caller does
``np.asarray(jax_array)``), so the port never sees JAX. bf16 arrives as
``ml_dtypes.bfloat16`` and fp8 as ``ml_dtypes.float8_e4m3fn``, which
``torch.from_numpy`` refuses; both cross as same-width integer views, which
is exact. The layouts stay the JAX package's: weights are (L, H, O) and used
as ``x @ w``, so nothing is transposed. Int4 weights are plain int8 payloads
with fp32 (..., G, O) scales and cross like any other dict; quantized caches
and pools cross with their ``k_scales`` / ``v_scales``, both ways.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from starflashattention_tpu_torch.cache.contiguous import KVCache
from starflashattention_tpu_torch.cache.paged import PagedKVCache

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


def tensor_to_numpy(t: torch.Tensor, exact: bool = False) -> np.ndarray:
    """torch tensor -> numpy. bf16 and fp8 come back as float32 (an exact
    upcast), so no numpy extension dtype is needed; ``exact=True`` keeps
    their dtype through ``ml_dtypes`` (which the JAX package brings)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        if exact:
            import ml_dtypes

            name = "bfloat16" if t.dtype == torch.bfloat16 else "float8_e4m3fn"
            return t.view(_TORCH_VIEW[t.dtype]).numpy().view(getattr(ml_dtypes, name))
        t = t.float()
    return t.numpy()


_TORCH_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}
CACHE_FIELDS = ("k", "v", "lengths", "k_scales", "v_scales")
PAGED_FIELDS = ("k_pages", "v_pages", "page_table", "lengths", "k_scales", "v_scales")


def _fields_to_numpy(cache, names) -> dict:
    return {n: None if getattr(cache, n) is None else tensor_to_numpy(getattr(cache, n), exact=True)
            for n in names}


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


def cache_to_numpy(cache: KVCache) -> dict[str, np.ndarray | None]:
    """The port's KVCache -> numpy arrays named like the JAX fields, in
    their own dtypes (scales None when unquantized)."""
    return _fields_to_numpy(cache, CACHE_FIELDS)


def paged_cache_from_numpy(
    k_pages, v_pages, page_table, lengths, k_scales=None, v_scales=None,
    device: torch.device | str = "cpu",
) -> PagedKVCache:
    """A JAX ``PagedKVCache``'s arrays (given as numpy) -> the port's
    PagedKVCache (pools (L, Hkv, P, ps, D), table and lengths int32, (L, Hkv)
    scales of quantized pools)."""
    def conv(a):
        return None if a is None else tensor_from_numpy(a, device)

    return PagedKVCache(
        k_pages=conv(k_pages), v_pages=conv(v_pages),
        page_table=conv(page_table).to(torch.int32), lengths=conv(lengths).to(torch.int32),
        k_scales=conv(k_scales), v_scales=conv(v_scales),
    )


def paged_cache_to_numpy(cache: PagedKVCache) -> dict[str, np.ndarray | None]:
    """The port's PagedKVCache -> numpy arrays named like the JAX fields, in
    their own dtypes (scales None when unquantized)."""
    return _fields_to_numpy(cache, PAGED_FIELDS)
